"""``graphblas_tpu_torch.dtypes``: the data types of the port.  The
complex types and user-defined types (``FC32``, ``FC64``,
``register_new``, ``register_anonymous``, ``ss``) wait and raise
NotImplementedError."""

from .core.dtypes import (BOOL, FP32, FP64, INT8, INT16, INT32, INT64, UINT8,
                          UINT16, UINT32, UINT64, DataType, lookup_dtype,
                          unify)
from .core.operator.base import missing

# the names of graphblas_tpu.dtypes that the port lacks
WAITING = frozenset(("FC32", "FC64", "register_new", "register_anonymous",
                     "ss"))

__all__ = ["DataType", "lookup_dtype", "unify", "BOOL", "INT8", "INT16",
           "INT32", "INT64", "UINT8", "UINT16", "UINT32", "UINT64", "FP32",
           "FP64"]


def __getattr__(name):
    raise missing("dtypes", name, WAITING)
