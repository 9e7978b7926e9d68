"""The reference's engine-JIT registration tests against the port (the
twin of tests/test_ssjit.py), run on the CPU: ``<namespace>.ss.register_new``
takes a callable or Python source over tensors.  ``dtypes.ss`` (the
struct types) waits for the user-defined types (item 12)."""

from tests.test_torch_operator_grids import twin

twin("test_ssjit", globals(), not_ported=("test_jit_dtype_struct",))
