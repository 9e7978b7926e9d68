"""GraphBLAS data types of the PyTorch package
(graphblas_tpu/core/dtypes.py): the thirteen builtin types, BOOL,
INT8-INT64, UINT8-UINT64, FP32, FP64, FC32 and FC64, user-defined types
(``register_new``, ``register_anonymous``, ``ss.register_new`` from a C
struct), ``lookup_dtype`` and ``unify``.

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

import ast
import re

import numpy as np
import torch

__all__ = ["DataType", "BOOL", "INT8", "INT16", "INT32", "INT64", "UINT8",
           "UINT16", "UINT32", "UINT64", "FP32", "FP64", "FC32", "FC64",
           "lookup_dtype", "unify", "register_new", "register_anonymous",
           "ss", "normalize", "to_tensor", "to_numpy"]

_SIGN64 = -(1 << 63)


class DataType:
    __slots__ = ("name", "gb_name", "np_type", "torch_type", "_is_udt",
                 "__weakref__")

    def __init__(self, name, gb_name, np_type, torch_type, *, is_udt=False):
        self.name = name
        self.gb_name = gb_name
        self.np_type = np.dtype(np_type)
        self.torch_type = torch_type
        self._is_udt = is_udt

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
        return self.np_type.kind == "c"

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
        except ValueError:
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
        if self._is_udt:
            return (_deserialize_udt, (_dtype_to_string(self.np_type),
                                       self.name))
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
FC32 = DataType("FC32", "GxB_FC32", np.complex64, torch.complex64)
FC64 = DataType("FC64", "GxB_FC64", np.complex128, torch.complex128)

ALL = (BOOL, INT8, INT16, INT32, INT64, UINT8, UINT16, UINT32, UINT64, FP32,
       FP64)
COMPLEX = (FC32, FC64)
ALL13 = ALL + COMPLEX
# a storage type's natural DataType (what a torch function's result is)
_BY_TORCH = {torch.bool: BOOL, torch.int8: INT8, torch.int16: INT16,
             torch.int32: INT32, torch.int64: INT64, torch.uint8: UINT8,
             torch.float32: FP32, torch.float64: FP64,
             torch.complex64: FC32, torch.complex128: FC64}

_registry = {}
for _d in ALL13:
    for _k in (_d.name, _d.name.lower(), _d.gb_name, _d.np_type,
               _d.np_type.name, _d.np_type.str, _d.np_type.type):
        _registry[_k] = _d
del _d, _k
_registry.update({bool: BOOL, int: INT64, float: FP64, "bool": BOOL,
                  "int": INT64, "float": FP64, complex: FC64,
                  "complex": FC64})


def register_new(name, dtype):
    """Register a user-defined type as ``gb.dtypes.<name>`` (any numpy
    struct or subarray dtype, or what np.dtype() takes)."""
    if not name.isidentifier():
        raise ValueError(f"`name` argument must be a valid Python "
                         f"identifier; got: {name!r}")
    if name in _registry or name in globals():
        raise ValueError(f"{name!r} name for dtype is unavailable")
    rv = register_anonymous(dtype, name)
    _registry[name] = rv
    globals()[name] = rv
    return rv


def register_anonymous(dtype, name=None):
    """The user-defined type of a numpy struct or subarray dtype; a dtype
    already registered gives its type back."""
    dtype = np.dtype(dtype)
    if dtype in _registry:
        existing = _registry[dtype]
        if name is None or existing.name == name:
            return existing
    if dtype.hasobject:
        raise ValueError("dtype must not contain Python objects")
    if dtype.names is None and dtype.subdtype is None and name is None:
        raise ValueError(f"dtype must be a struct or subarray dtype; got "
                         f"{dtype}")
    rv = DataType(name if name is not None else _default_name(dtype), None,
                  dtype, None, is_udt=True)
    _registry[dtype] = rv
    return rv


def _default_name(dtype):
    dtype = np.dtype(dtype)
    if dtype in _registry and not _registry[dtype]._is_udt:
        return _registry[dtype].name
    if dtype.subdtype is not None:
        sub = _default_name(dtype.subdtype[0])
        shape = ", ".join(map(str, dtype.subdtype[1]))
        return f"{sub}[{shape}]"
    if dtype.names:
        args = ", ".join(f"{n!r}: {_default_name(dtype.fields[n][0])}"
                         for n in dtype.names)
        return f"{{{args}}}"
    return repr(dtype)


def _dtype_to_string(dtype):
    """A string that _string_to_dtype turns back into the type (the
    serialized form of the JAX package)."""
    if isinstance(dtype, np.dtype) and dtype not in _registry:
        np_type = dtype
    else:
        dt = lookup_dtype(dtype)
        if not dt._is_udt:
            return dt.name
        np_type = dt.np_type
    s = str(np_type)
    try:
        if np.dtype(ast.literal_eval(s)) == np_type:
            return s
    except Exception:  # noqa: BLE001 - not a literal: the str form below
        pass
    if np.dtype(np_type.str) != np_type:
        raise ValueError(f"Unable to reliably convert dtype to string and "
                         f"back: {dtype}")
    return repr(np_type.str)


def _safe_eval_dtype(s):
    return np.dtype(ast.literal_eval(s))


def _string_to_dtype(s):
    try:
        return lookup_dtype(s)
    except Exception:  # noqa: BLE001 - a literal dtype string
        pass
    return lookup_dtype(_safe_eval_dtype(s))


def _deserialize_udt(s, name):
    """A pickled user-defined type (the JAX package's format)."""
    np_type = _safe_eval_dtype(s) if s not in _registry else np.dtype(s)
    if np_type in _registry:
        return _registry[np_type]
    return register_anonymous(np_type, name)


def lookup_dtype(key, value=None):
    """DataType from a DataType, name, numpy type, torch dtype, Python type
    or a dict of field types (graphblas_tpu/core/dtypes.py lookup_dtype);
    a struct or subarray numpy dtype is registered as a user-defined type.
    With ``value``, a Python int that INT64 cannot hold is UINT64."""
    if type(key) is DataType:
        return key
    if isinstance(key, torch.dtype):
        if key in _BY_TORCH:
            return _BY_TORCH[key]
        raise ValueError(f"Unknown dtype: {key} of type {type(key)}")
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
    if isinstance(key, dict):
        np_rec = np.dtype([(name, lookup_dtype(field).np_type)
                           for name, field in key.items()], align=True)
        return lookup_dtype(np_rec)
    try:
        return register_anonymous(key)
    except Exception:  # noqa: BLE001 - not a numpy dtype either
        pass
    raise ValueError(f"Unknown dtype: {key} of type {type(key)}")


def unify(type1, type2, *, is_left_scalar=False, is_right_scalar=False):
    """A type that holds both (graphblas_tpu/core/dtypes.py unify): numpy's
    promotion, with a scalar operand taken as a 0-d array.  Two
    user-defined types unify only where they are one type."""
    if type1 is type2:
        return type1
    if type1._is_udt or type2._is_udt:
        if type1 == type2:
            return type1
        raise TypeError(f"Cannot unify UDTs {type1} and {type2}")
    if is_left_scalar:
        if not is_right_scalar:
            return lookup_dtype(np.result_type(np.array(0, type1.np_type),
                                               type2.np_type))
    elif is_right_scalar:
        return lookup_dtype(np.result_type(type1.np_type,
                                           np.array(0, type2.np_type)))
    return lookup_dtype(np.promote_types(type1.np_type, type2.np_type))


def host_np_type(dt):
    """The numpy type of dt's host arrays: a subarray type's element type
    (its values carry the subarray as trailing dimensions)."""
    nt = dt.np_type
    return nt.subdtype[0] if nt.subdtype is not None else nt


def value_shape(dt):
    """The trailing dimensions each value of dt has (a subarray type's)."""
    nt = dt.np_type
    return tuple(nt.subdtype[1]) if nt.subdtype is not None else ()


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
    are read as unsigned).  A user-defined type's values pass as they
    are."""
    if dt._is_udt:
        return t
    if t.is_complex() and not dt.is_complex:
        # complex to a real type: the real part's cast (1j is False)
        t = t.real.contiguous()
    if src is UINT64 and dt is not UINT64:
        if dt.is_float or dt.is_complex:
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
    if dt.is_complex:
        return complex(value)
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
    """numpy array (any numeric type) -> storage tensor of dt on device (a
    Tree for a user-defined type)."""
    if dt._is_udt:
        from .engine import store

        return store.np_values_to_device(array, dt, device)
    a = np.asarray(array)
    if a.dtype.kind == "c" and not dt.is_complex:
        a = a.real  # complex to a real type: the real part's cast
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
    """storage tensor (or a user-defined type's Tree) -> numpy array of
    dt.np_type."""
    if dt._is_udt:
        from .engine import store

        return store.device_values_to_np(t, dt)
    a = t.detach().cpu().resolve_conj().numpy()
    if dt is UINT64:
        return a.view(np.uint64)
    return a.astype(dt.np_type, copy=False)


_C_TO_NP = {
    "bool": "?", "_Bool": "?",
    "int8_t": "i1", "char": "i1", "signed char": "i1",
    "uint8_t": "u1", "unsigned char": "u1",
    "int16_t": "i2", "short": "i2",
    "uint16_t": "u2", "unsigned short": "u2",
    "int32_t": "i4", "int": "i4",
    "uint32_t": "u4", "unsigned int": "u4", "unsigned": "u4",
    "int64_t": "i8", "long": "i8", "long long": "i8",
    "uint64_t": "u8", "unsigned long": "u8", "unsigned long long": "u8",
    "float": "f4", "double": "f8",
    "float complex": "c8", "double complex": "c16",
}


def _parse_c_struct_typedef(name, source):
    """``typedef struct { double x; int64_t y[4]; } name;`` as the numpy
    struct dtype of the same layout (the JAX package's parser)."""
    m = re.search(r"typedef\s+struct\s*\{(.*)\}\s*(\w+)\s*;", source, re.S)
    if m is None:
        raise ValueError(
            "Only struct typedefs are currently allowed for JIT dtypes")
    body, tname = m.groups()
    if tname != name:
        raise ValueError("`name` argument must be same name as the typedef "
                         "in `jit_c_definition`")
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        fm = re.match(r"(.+?)\s+(\w+)\s*((?:\[\s*\d+\s*\]\s*)*)$", decl)
        if fm is None:
            raise ValueError(f"Cannot parse struct field: {decl!r}")
        ctype, fname, arr = fm.groups()
        ctype = " ".join(ctype.split())
        if ctype not in _C_TO_NP:
            raise ValueError(f"Unsupported C field type: {ctype!r}")
        dims = tuple(int(d) for d in re.findall(r"\d+", arr or ""))
        fields.append((fname, _C_TO_NP[ctype], dims) if dims
                      else (fname, _C_TO_NP[ctype]))
    return np.dtype(fields)


class _DtypeSS:
    """``gb.dtypes.ss``: ``register_new`` of a type given as a C struct
    typedef, parsed into the numpy struct dtype of the same layout (or
    given as ``np_type=``)."""

    @staticmethod
    def register_new(name, jit_c_definition, *, np_type=None):
        if not name.isidentifier():
            raise ValueError(f"`name` argument must be a valid Python "
                             f"identifier; got: {name!r}")
        if np_type is None:
            np_type = _parse_c_struct_typedef(name, jit_c_definition)
        rv = register_new(name, np_type)
        setattr(_DtypeSS, name, rv)
        return rv


ss = _DtypeSS()
