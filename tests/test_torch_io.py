"""The reference's ``gb.io`` tests against the port (the twin of
tests/test_io.py), run on the CPU; the cases that need awkward or
pydata/sparse skip where the package is missing, as they do there."""

from tests.test_torch_operator_grids import twin

twin("test_io", globals())
