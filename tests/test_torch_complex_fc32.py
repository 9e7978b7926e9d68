"""FC32 in the port against the JAX package: every operator instance of
the type through the engines on both backings, casts, ``unify`` and
Scalar (the grid of test_torch_complex_grid.py), within rel 1e-5 of
the magnitude and with the JAX package's structure exactly."""

import torch

from tests.test_torch_complex_grid import define

torch.set_num_threads(1)

define("FC32", globals())
