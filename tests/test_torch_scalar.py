"""The reference's Scalar cases against the port (the twin of
tests/test_scalar.py), run on the CPU.  ``test_pickle`` waits with the
twin of tests/test_pickle.py: the port has not the JAX package's pickle
format yet (Python's default pickles its Scalars)."""

from tests.test_torch_operator_grids import twin

twin("test_scalar", globals())
