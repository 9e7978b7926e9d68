"""``graphblas_tpu_torch.dtypes``: the data types of the port."""

from .core.dtypes import (BOOL, FP32, FP64, INT32, INT64, UINT32, DataType,
                          lookup_dtype)

__all__ = ["DataType", "lookup_dtype", "BOOL", "INT32", "INT64", "UINT32",
           "FP32", "FP64"]
