"""The coercion tables of the builtin operators
(graphblas_tpu/core/operator/coercions.py): aliases that let an
operator take a type it has no instance of, by storing the instance of
the target type under the input type, and the two renamings semirings
apply (SuiteSparse's boolean renaming of an arithmetic monoid over BOOL
products, and the unsigned input type of a bitwise ring over a signed
type).  The engine casts operands to a typed operator's input type, which
gives the JAX package's results."""

from .. import dtypes as _dt

NUMERIC10 = _dt.ALL[1:]
_SMALL = (_dt.BOOL, _dt.INT8, _dt.INT16, _dt.UINT8, _dt.UINT16)
_LARGE = (_dt.INT32, _dt.INT64, _dt.UINT32, _dt.UINT64)
# (the JAX package looks these up in its unary namespace, where erf,
# erfc, lgamma and tgamma are not: they live in unary.ss and take no alias)
_FLOAT_UNARY = (
    "acos", "acosh", "asin", "asinh",
    "atan", "atanh", "ceil", "cos", "cosh", "exp", "exp2", "expm1", "floor",
    "log", "log10", "log1p", "log2", "round", "signum", "sin", "sinh", "sqrt",
    "tan", "tanh", "trunc", "cbrt")
_FLOAT_BINARY = ("atan2", "copysign", "fmod", "hypot", "remainder")

# inside a semiring, an arithmetic monoid over BOOL products means its
# logical counterpart
BOOL_MONOID_RENAME = {"plus": "lor", "times": "land", "min": "land",
                      "max": "lor"}
# a bitwise ring over a signed type takes these inputs
_BITWISE_SIGNED = {_dt.INT8: _dt.UINT16, _dt.INT16: _dt.UINT32,
                   _dt.INT32: _dt.UINT64, _dt.INT64: _dt.UINT64}
_BITWISE = ("band", "bor", "bxor", "bxnor")


def _alias(op, inputs, target):
    typed = op._typed_ops[target]
    for dt in inputs:
        op._typed_ops.setdefault(dt, typed)


def install(unary, binary, monoid):
    """Add the aliases to the builtin tables (name -> operator dicts)."""
    for name, logical in (("max", "lor"), ("min", "land"), ("times", "land")):
        monoid[name]._typed_ops.setdefault(
            _dt.BOOL, monoid[logical]._typed_ops[_dt.BOOL])
    for name in ("lor", "land", "lxnor", "lxor"):
        _alias(monoid[name], NUMERIC10, _dt.BOOL)
    for name in _FLOAT_UNARY:
        if _dt.FP32 in unary[name]._typed_ops:
            _alias(unary[name], _SMALL, _dt.FP32)
            _alias(unary[name], _LARGE, _dt.FP64)
    for name in _FLOAT_BINARY:
        _alias(binary[name], _SMALL, _dt.FP32)
        _alias(binary[name], _LARGE, _dt.FP64)
    _alias(binary["lxnor"], NUMERIC10, _dt.BOOL)
    _alias(binary["cmplx"], _SMALL, _dt.FP32)
    _alias(binary["cmplx"], _LARGE, _dt.FP64)


def bool_monoid_substitute(mono):
    """The logical monoid standing in for an arithmetic monoid over BOOL."""
    from .monoid import BUILTINS

    name = BOOL_MONOID_RENAME.get(mono.name)
    return None if name is None else BUILTINS[name]


def bitwise_input_coercion(ring, dt):
    """The unsigned input type of a bitwise ring over a signed type."""
    if ring.monoid.name in _BITWISE and ring.binaryop.name in _BITWISE:
        return _BITWISE_SIGNED.get(dt)
    return None
