"""GraphBLAS data types of the PyTorch package.

Only the types the SpMV slice needs: BOOL, INT32, INT64, UINT32 and FP32,
plus FP64 as a cast target.  Each type has a numpy type (the public
boundary: ``from_coo``/``to_coo`` arrays) and a torch storage type.  UINT32
is stored as int64 holding values in [0, 2**32), because torch's uint32
has almost no kernels; the SpMV engine carries it as int32 bits.
"""

import numpy as np
import torch

__all__ = ["DataType", "BOOL", "INT32", "INT64", "UINT32", "FP32", "FP64",
           "lookup_dtype", "normalize", "to_tensor", "to_numpy"]

_U32_MASK = 0xFFFFFFFF


class DataType:
    __slots__ = ("name", "np_type", "torch_type")
    _is_udt = False

    def __init__(self, name, np_type, torch_type):
        self.name = name
        self.np_type = np.dtype(np_type)
        self.torch_type = torch_type

    @property
    def is_bool(self):
        return self.np_type.kind == "b"

    @property
    def is_float(self):
        return self.np_type.kind == "f"

    @property
    def is_int(self):
        return self.np_type.kind in "iu"

    @property
    def is_unsigned(self):
        return self.np_type.kind == "u"

    @property
    def is_complex(self):
        return False

    def __repr__(self):
        return self.name

    def __reduce__(self):
        return self.name


BOOL = DataType("BOOL", np.bool_, torch.bool)
INT32 = DataType("INT32", np.int32, torch.int32)
INT64 = DataType("INT64", np.int64, torch.int64)
UINT32 = DataType("UINT32", np.uint32, torch.int64)
FP32 = DataType("FP32", np.float32, torch.float32)
FP64 = DataType("FP64", np.float64, torch.float64)

_ALL = (BOOL, INT32, INT64, UINT32, FP32, FP64)
_BY_NAME = {dt.name: dt for dt in _ALL}
_BY_NP = {dt.np_type: dt for dt in _ALL}
_BY_TORCH = {torch.bool: BOOL, torch.int32: INT32, torch.int64: INT64,
             torch.float32: FP32, torch.float64: FP64}


def lookup_dtype(key):
    """DataType from a DataType, name, numpy type, torch dtype or Python type."""
    if isinstance(key, DataType):
        return key
    if isinstance(key, torch.dtype):
        if key in _BY_TORCH:
            return _BY_TORCH[key]
    elif isinstance(key, str) and key.upper() in _BY_NAME:
        return _BY_NAME[key.upper()]
    elif key is bool:
        return BOOL
    elif key is int:
        return INT64
    elif key is float:
        return FP64
    else:
        try:
            npt = np.dtype(key)
        except TypeError:
            npt = None
        if npt in _BY_NP:
            return _BY_NP[npt]
    raise NotImplementedError(
        f"data type {key!r} is not in the PyTorch port yet; the port has "
        f"{', '.join(_BY_NAME)} (ROADMAP.md queue 1, item 12)")


def normalize(t, dt):
    """Bring a tensor to dt's storage type, with C-cast semantics (integer
    wrap-around, float truncation toward zero, nonzero -> True)."""
    if dt is UINT32:
        if t.dtype.is_floating_point:
            t = t.to(torch.int64)
        return t.to(torch.int64) & _U32_MASK
    return t.to(dt.torch_type)


def to_tensor(array, dt, device):
    """numpy array (any numeric type) -> storage tensor of dt on device."""
    a = np.asarray(array)
    if dt is UINT32:
        a = a.astype(np.uint32).astype(np.int64)
    else:
        a = a.astype(dt.np_type, copy=False)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # a CPU tensor would share the read-only buffer
        a = a.copy()
    return torch.from_numpy(a).to(device)


def to_numpy(t, dt):
    """storage tensor -> numpy array of dt.np_type."""
    return t.detach().cpu().numpy().astype(dt.np_type, copy=False)
