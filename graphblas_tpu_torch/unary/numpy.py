"""``graphblas_tpu_torch.unary.numpy``: the numpy ufuncs as unary
operators (graphblas_tpu/unary/numpy.py).  A ufunc that a builtin
computes exactly is that builtin (``negative`` is ``unary.ainv``, the JAX
package's default ``mapnumpy``); the others are made here from torch
functions, with the types the JAX package gives them.  A type a ufunc
refuses raises UdfParseError."""

import math

import torch

from .. import exceptions
from ..core import dtypes as _dt
from ..core.operator.binary import ALL11, ALL13
from ..core.operator.unary import UnaryOp
from ..binary.numpy import float_ret, int_ret

_NAMES = frozenset((
    "negative", "abs", "absolute", "cbrt", "fabs", "rint", "sign", "exp",
    "exp2", "log", "log2", "log10", "expm1", "log1p", "positive", "sqrt",
    "square", "reciprocal", "sin", "cos", "tan", "arcsin", "arccos", "arctan",
    "sinh", "cosh", "tanh", "arcsinh", "arccosh", "arctanh", "deg2rad",
    "rad2deg", "degrees", "radians", "bitwise_not", "invert", "logical_not",
    "isfinite", "isinf", "isnan", "signbit", "floor", "ceil", "trunc",
    "spacing"))

TO_GRAPHBLAS = {
    "abs": "abs", "absolute": "abs", "arccos": "acos", "arccosh": "acosh",
    "arcsin": "asin", "arcsinh": "asinh", "arctan": "atan", "arctanh": "atanh",
    "bitwise_not": "bnot", "cbrt": "cbrt", "ceil": "ceil", "cos": "cos",
    "cosh": "cosh", "exp": "exp", "exp2": "exp2", "expm1": "expm1",
    "floor": "floor", "invert": "bnot", "isfinite": "isfinite",
    "isinf": "isinf", "isnan": "isnan", "log": "log", "log10": "log10",
    "log1p": "log1p", "log2": "log2", "negative": "ainv",
    "positive": "identity", "reciprocal": "minv", "sign": "signum",
    "sin": "sin", "sinh": "sinh", "sqrt": "sqrt", "tan": "tan",
    "tanh": "tanh", "trunc": "trunc"}


def _in_ret(fn, ret_rule):
    def make(dt):
        ret = ret_rule(dt)
        return lambda x: fn(_dt.normalize(x, ret, dt))

    return make


def _spacing(x):
    # the distance to the next float away from zero, signed as x
    away = torch.where(torch.signbit(x), -math.inf, math.inf)
    return torch.nextafter(x, away.to(x.dtype)) - x


def _rint_ret(dt):
    return dt if dt.is_float or dt.is_complex else _dt.FP64


def _rint(x):
    """Round half to even; a complex value's parts each."""
    if x.is_complex():
        return torch.complex(torch.round(x.real), torch.round(x.imag))
    return torch.round(x)


def _signbit(dt):
    if dt.is_float:
        return torch.signbit
    if dt.is_signed_int:
        return lambda x: x < 0
    return lambda x: torch.zeros_like(x, dtype=torch.bool)


_DEG = 180.0 / math.pi
# name -> (make(dt), return rule)
_OWN = {
    "deg2rad": (_in_ret(lambda x: x / _DEG, float_ret), float_ret),
    "radians": (_in_ret(lambda x: x / _DEG, float_ret), float_ret),
    "rad2deg": (_in_ret(lambda x: x * _DEG, float_ret), float_ret),
    "degrees": (_in_ret(lambda x: x * _DEG, float_ret), float_ret),
    "fabs": (_in_ret(torch.abs, float_ret), float_ret),
    "spacing": (_in_ret(_spacing, float_ret), float_ret),
    "rint": (_in_ret(_rint, _rint_ret), _rint_ret),
    "square": (_in_ret(torch.square, int_ret), int_ret),
    "logical_not": (lambda dt: lambda x: x == 0, _dt.BOOL),
    "signbit": (_signbit, _dt.BOOL),
}


# the ufuncs the JAX package also takes over FC32 and FC64
_COMPLEX = frozenset(("deg2rad", "radians", "rad2deg", "degrees", "rint",
                      "square", "logical_not"))


def _build(name):
    op = UnaryOp._builtin(f"numpy.{name}", ALL13 if name in _COMPLEX
                          else ALL11, *_OWN[name])
    op._refusal = exceptions.UdfParseError
    return op


__all__ = sorted(_NAMES)


def __dir__():
    return sorted(set(globals()) | _NAMES)


def __getattr__(name):
    if name not in _NAMES:
        raise AttributeError(
            f"module 'graphblas_tpu_torch.unary.numpy' has no attribute "
            f"{name!r}")
    if name in TO_GRAPHBLAS:
        from .. import unary

        target = TO_GRAPHBLAS[name]
        op = getattr(unary.ss if target in unary.SS_NAMES else unary, target)
    else:
        op = _build(name)
    globals()[name] = op
    return op
