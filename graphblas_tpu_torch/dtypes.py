"""``graphblas_tpu_torch.dtypes``: the data types of the port, with the
user-defined types that ``register_new`` (and ``ss.register_new``) names
here."""

from .core import dtypes as _core
from .core.dtypes import (BOOL, FC32, FC64, FP32, FP64, INT8, INT16, INT32,
                          INT64, UINT8, UINT16, UINT32, UINT64, DataType,
                          lookup_dtype, register_anonymous, register_new, ss,
                          unify)

__all__ = ["DataType", "lookup_dtype", "unify", "register_new",
           "register_anonymous", "ss", "BOOL", "INT8", "INT16", "INT32",
           "INT64", "UINT8", "UINT16", "UINT32", "UINT64", "FP32", "FP64",
           "FC32", "FC64"]


def __getattr__(name):
    rv = vars(_core).get(name)
    if isinstance(rv, DataType) and rv._is_udt:
        return rv
    raise AttributeError(
        f"module 'graphblas_tpu_torch.dtypes' has no attribute {name!r}")
