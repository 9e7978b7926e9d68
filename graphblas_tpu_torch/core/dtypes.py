"""GraphBLAS data types of the PyTorch package
(graphblas_tpu/core/dtypes.py): the eleven real builtin types, BOOL,
INT8-INT64, UINT8-UINT64, FP32 and FP64, with ``lookup_dtype`` and
``unify``.  The complex types and user-defined types are not ported.

Each type has a numpy type (the public boundary: ``from_coo``/``to_coo``
arrays) and a torch storage type.  INT8, INT16 and UINT8 are stored as
torch's own types.  torch's uint16, uint32 and uint64 have almost no
kernels, so UINT16 is stored as int32 holding values in [0, 2**16),
UINT32 as int64 holding values in [0, 2**32), and UINT64 as int64 holding
the same 64 bits (a value of 2**63 and above reads as negative: the
comparisons, min/max, division, shifts and casts of core/operator/ufuncs.py
treat it as unsigned).  The SpMV pipelines carry every type of at most 32
bits as 32-bit words (core/engine/sortpipe.py).
"""

import numpy as np
import torch

__all__ = ["DataType", "BOOL", "INT8", "INT16", "INT32", "INT64", "UINT8",
           "UINT16", "UINT32", "UINT64", "FP32", "FP64", "lookup_dtype",
           "unify", "normalize", "to_tensor", "to_numpy"]

_SIGN64 = -(1 << 63)


class DataType:
    __slots__ = ("name", "gb_name", "np_type", "torch_type")
    _is_udt = False

    def __init__(self, name, gb_name, np_type, torch_type):
        self.name = name
        self.gb_name = gb_name
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
    def is_signed_int(self):
        return self.np_type.kind == "i"

    @property
    def is_unsigned(self):
        return self.np_type.kind == "u"

    is_unsigned_int = is_unsigned

    @property
    def is_complex(self):
        return False

    @property
    def bits(self):
        return 8 * self.np_type.itemsize

    def __repr__(self):
        return self.name

    def __eq__(self, other):
        if type(other) is DataType:
            return self.np_type == other.np_type
        try:
            other = lookup_dtype(other)
        except (ValueError, NotImplementedError):
            raise TypeError(f"Invalid or unknown datatype: {other}") from None
        return self.np_type == other.np_type

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash(self.np_type)

    def __lt__(self, other):
        # an arbitrary but stable order, as in the JAX package
        t = lookup_dtype(other)
        return (self.np_type.kind, self.np_type.itemsize, self.name) < (
            t.np_type.kind, t.np_type.itemsize, t.name)

    def __reduce__(self):
        return self.name


BOOL = DataType("BOOL", "GrB_BOOL", np.bool_, torch.bool)
INT8 = DataType("INT8", "GrB_INT8", np.int8, torch.int8)
INT16 = DataType("INT16", "GrB_INT16", np.int16, torch.int16)
INT32 = DataType("INT32", "GrB_INT32", np.int32, torch.int32)
INT64 = DataType("INT64", "GrB_INT64", np.int64, torch.int64)
UINT8 = DataType("UINT8", "GrB_UINT8", np.uint8, torch.uint8)
UINT16 = DataType("UINT16", "GrB_UINT16", np.uint16, torch.int32)
UINT32 = DataType("UINT32", "GrB_UINT32", np.uint32, torch.int64)
UINT64 = DataType("UINT64", "GrB_UINT64", np.uint64, torch.int64)
FP32 = DataType("FP32", "GrB_FP32", np.float32, torch.float32)
FP64 = DataType("FP64", "GrB_FP64", np.float64, torch.float64)

ALL = (BOOL, INT8, INT16, INT32, INT64, UINT8, UINT16, UINT32, UINT64, FP32,
       FP64)
# a storage type's natural DataType (what a torch function's result is)
_BY_TORCH = {torch.bool: BOOL, torch.int8: INT8, torch.int16: INT16,
             torch.int32: INT32, torch.int64: INT64, torch.uint8: UINT8,
             torch.float32: FP32, torch.float64: FP64}
# the JAX package's complex types, which wait for ROADMAP.md item 12
_COMPLEX_KEYS = {"FC32", "FC64", "GxB_FC32", "GxB_FC64", "complex64",
                 "complex128", "fc32", "fc64", "complex", complex,
                 np.dtype(np.complex64), np.dtype(np.complex128),
                 np.complex64, np.complex128}

_registry = {}
for _d in ALL:
    for _k in (_d.name, _d.name.lower(), _d.gb_name, _d.np_type,
               _d.np_type.name, _d.np_type.str, _d.np_type.type):
        _registry[_k] = _d
del _d, _k
_registry.update({bool: BOOL, int: INT64, float: FP64, "bool": BOOL,
                  "int": INT64, "float": FP64})


def _not_ported(key):
    return NotImplementedError(
        f"data type {key!r} is not in the PyTorch port yet; the port has "
        f"its eleven real types (ROADMAP.md queue 1, item 12)")


def _deserialize_udt(np_type_string, name):
    """A pickled user-defined type of the JAX package: it waits for the
    user-defined types."""
    raise _not_ported(f"user-defined type {name}")


def lookup_dtype(key, value=None):
    """DataType from a DataType, name, numpy type, torch dtype or Python
    type (graphblas_tpu/core/dtypes.py lookup_dtype).  With ``value``, a
    Python int that INT64 cannot hold is UINT64."""
    if type(key) is DataType:
        return key
    if isinstance(key, torch.dtype):
        if key in _BY_TORCH:
            return _BY_TORCH[key]
        raise _not_ported(key)
    try:
        dt = _registry[key]
    except (KeyError, TypeError):
        dt = None
    if dt is not None:
        if dt is INT64 and key is int and value is not None \
                and isinstance(value, int) and value > np.iinfo(np.int64).max:
            return UINT64
        return dt
    if value is not None and hasattr(value, "dtype"):
        try:
            return _registry[np.dtype(value.dtype)]
        except (KeyError, TypeError):
            pass
    if key is None:
        raise TypeError("Bad dtype: None.  A valid dtype must be provided.")
    try:
        hashable = key in _COMPLEX_KEYS
    except TypeError:
        hashable = False
    if hashable:
        raise _not_ported(key)
    try:
        npt = np.dtype(key)
    except (TypeError, ValueError):
        npt = None
    if npt is not None and npt in _registry:
        return _registry[npt]
    if npt is not None and (npt.kind == "c" or npt.names is not None
                            or npt.subdtype is not None):
        raise _not_ported(key)
    if isinstance(key, dict):
        raise _not_ported(key)
    raise ValueError(f"Unknown dtype: {key} of type {type(key)}")


def unify(type1, type2, *, is_left_scalar=False, is_right_scalar=False):
    """A type that holds both (graphblas_tpu/core/dtypes.py unify): numpy's
    promotion, with a scalar operand taken as a 0-d array."""
    if type1 is type2:
        return type1
    if is_left_scalar:
        if not is_right_scalar:
            return lookup_dtype(np.result_type(np.array(0, type1.np_type),
                                               type2.np_type))
    elif is_right_scalar:
        return lookup_dtype(np.result_type(type1.np_type,
                                           np.array(0, type2.np_type)))
    return lookup_dtype(np.promote_types(type1.np_type, type2.np_type))


def natural(t):
    """The DataType a torch function's result tensor stands for (its
    storage type's own: int64 is INT64, int32 INT32)."""
    return _BY_TORCH[t.dtype]


def u64_to_float(t, float_type=torch.float64):
    """UINT64 bits (int64) -> float, read as unsigned: the high and low
    32-bit halves are exact in float64, so the sum rounds once."""
    hi = ((t >> 32) & 0xFFFFFFFF).to(torch.float64)
    lo = (t & 0xFFFFFFFF).to(torch.float64)
    return (hi * 4294967296.0 + lo).to(float_type)


def float_to_int(t, dt):
    """float -> integer storage of dt, truncated toward zero and saturated
    to dt's range, NaN -> 0 (SuiteSparse's cast, and XLA's in the JAX
    package)."""
    t = torch.trunc(t.to(torch.float64))
    t = torch.where(torch.isnan(t), 0.0, t)
    if dt.bits < 64:
        info = np.iinfo(dt.np_type)
        return t.clamp(int(info.min), int(info.max)).to(torch.int64).to(
            dt.torch_type)
    if dt is INT64:
        big = t >= 9223372036854775808.0
        return torch.where(big, np.iinfo(np.int64).max, t.to(torch.int64))
    # UINT64: [2**63, 2**64) wraps into the sign bit
    t = t.clamp(min=0.0)
    big = t >= 9223372036854775808.0
    low = torch.where(big, t - 9223372036854775808.0, t)
    bits = torch.where(big, low.to(torch.int64) ^ _SIGN64, low.to(torch.int64))
    return torch.where(t >= 18446744073709551616.0, -1, bits)


def normalize(t, dt, src=None):
    """Bring a tensor to dt's storage type, with GraphBLAS's casts
    (integers wrap around, floats truncate toward zero and saturate, NaN
    -> 0, nonzero -> True).  ``src``
    is the DataType t holds when it is not t's natural one (UINT64 bits
    are read as unsigned)."""
    if src is UINT64 and dt is not UINT64:
        if dt.is_float:
            return u64_to_float(t, dt.torch_type)
        if dt.is_bool:
            return t != 0
    if t.dtype.is_floating_point and dt.is_int:
        return float_to_int(t, dt)
    if dt is UINT16:
        return (t.to(torch.int64) & 0xFFFF).to(torch.int32)
    if dt is UINT32:
        return t.to(torch.int64) & 0xFFFFFFFF
    if dt.is_int and t.dtype != dt.torch_type and not t.dtype == torch.bool:
        # wrap through int64, as a C cast does
        return t.to(torch.int64).to(dt.torch_type)
    return t.to(dt.torch_type)


def storage_scalar(value, dt):
    """A Python value of dt as the Python number its storage holds (UINT64
    as the int64 of the same bits)."""
    if dt.is_float:
        return float(value)
    if dt.is_bool:
        return bool(value)
    if dt is UINT64:
        v = int(value) & 0xFFFFFFFFFFFFFFFF
        return v - (1 << 64) if v >> 63 else v
    if dt.is_unsigned:
        return int(value) & int(np.iinfo(dt.np_type).max)
    return np.array(value).astype(dt.np_type).item()


def to_tensor(array, dt, device):
    """numpy array (any numeric type) -> storage tensor of dt on device."""
    a = np.asarray(array)
    if dt is UINT64:
        a = a.astype(np.uint64).view(np.int64)
    elif dt.is_unsigned and dt.torch_type != torch.uint8:
        a = a.astype(dt.np_type).astype(np.int64 if dt is UINT32
                                         else np.int32)
    else:
        a = a.astype(dt.np_type, copy=False)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # a CPU tensor would share the read-only buffer
        a = a.copy()
    return torch.from_numpy(a).to(device)


def to_numpy(t, dt):
    """storage tensor -> numpy array of dt.np_type."""
    a = t.detach().cpu().numpy()
    if dt is UINT64:
        return a.view(np.uint64)
    return a.astype(dt.np_type, copy=False)
