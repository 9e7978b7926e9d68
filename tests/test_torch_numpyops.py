"""The reference's numpyops cases against the port (the twin of
tests/test_numpyops.py), run on the CPU with the same inputs and expected
values the JAX package meets there."""

from tests.test_torch_operator_grids import twin

twin("test_numpyops", globals())
