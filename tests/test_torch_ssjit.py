"""The reference's engine-JIT registration tests against the port (the
twin of tests/test_ssjit.py), run on the CPU: ``<namespace>.ss.register_new``
takes a callable or Python source over tensors, and ``dtypes.ss`` a C
struct typedef (a user-defined type)."""

from tests.test_torch_operator_grids import twin

twin("test_ssjit", globals())
