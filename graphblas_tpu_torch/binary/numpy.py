"""``graphblas_tpu_torch.binary.numpy``: the numpy ufuncs as binary
operators (graphblas_tpu/binary/numpy.py).  A ufunc that a builtin
computes exactly is that builtin (``add`` is ``binary.plus``, the JAX
package's default ``mapnumpy``); the others are made here from torch
functions, with the types the JAX package gives them: the float ones
return FP32 for the types of at most 32 bits and FP64 for the 64-bit
integers, the integer ones INT32 for BOOL.  A type a ufunc refuses raises
UdfParseError, as the JAX package's failed trace does."""

import torch

from .. import exceptions
from ..core import dtypes as _dt
from ..core.operator import ufuncs as uf
from ..core.operator.binary import ALL11, ALL13, INTS8, BinaryOp

_NAMES = frozenset((
    "add", "subtract", "multiply", "divide", "logaddexp", "logaddexp2",
    "true_divide", "floor_divide", "power", "float_power", "remainder", "mod",
    "fmod", "gcd", "lcm", "arctan2", "hypot", "bitwise_and", "bitwise_or",
    "bitwise_xor", "left_shift", "right_shift", "greater", "greater_equal",
    "less", "less_equal", "not_equal", "equal", "logical_and", "logical_or",
    "logical_xor", "maximum", "minimum", "fmax", "fmin", "copysign",
    "nextafter", "ldexp"))

TO_GRAPHBLAS = {
    "add": "plus", "bitwise_and": "band", "bitwise_or": "bor",
    "bitwise_xor": "bxor", "equal": "eq", "fmax": "max", "fmin": "min",
    "logical_and": "land", "logical_or": "lor", "logical_xor": "lxor",
    "multiply": "times", "arctan2": "atan2", "copysign": "copysign",
    "divide": "truediv", "greater": "gt", "greater_equal": "ge",
    "hypot": "hypot", "ldexp": "ldexp", "less": "lt", "less_equal": "le",
    "maximum": "max", "minimum": "min", "not_equal": "ne", "power": "pow",
    "subtract": "minus", "true_divide": "truediv"}


def float_ret(dt):
    """The float type a numpy float ufunc gives dt in the JAX package."""
    if dt.is_float or dt.is_complex:
        return dt
    return _dt.FP64 if dt.bits == 64 else _dt.FP32


def int_ret(dt):
    return _dt.INT32 if dt.is_bool else dt


def in_ret(fn, ret_rule):
    """make(dt): cast the operands to the return type, then apply fn."""
    def make(dt):
        ret = ret_rule(dt)

        def op(x, y):
            return fn(_dt.normalize(x, ret, dt), _dt.normalize(y, ret, dt))

        return op

    return make


def _floor_divide(x, y):
    # x // 0 as XLA gives it: a truncated quotient of -1, floor-corrected
    zero = y == 0
    ys = torch.where(zero, torch.ones_like(y), y)
    q = torch.where(zero, -1, torch.div(x, ys, rounding_mode="trunc"))
    r = torch.where(zero, x, x - q * ys)
    fix = (torch.sign(x) != torch.sign(y)) & (r != 0)
    return torch.where(fix, q - 1, q)


def _by_nonzero(fn):
    """fn(x, y) where y != 0, else 0."""
    def op(x, y):
        zero = y == 0
        return torch.where(zero, 0, fn(x, torch.where(zero, torch.ones_like(y),
                                                      y)))

    return op


def _shift(left):
    def op(x, y):
        ok = (y >= 0) & (y < 8 * x.element_size())
        s = torch.where(ok, y, 0)
        if left:
            return torch.where(ok, x << s, 0)
        return torch.where(ok, x >> s, torch.where(x < 0, -1, 0))

    return op


def _int_or_float(int_fn, float_fn):
    """make(dt): float_fn on floats, int_fn on the integers (BOOL as
    INT32)."""
    on_ints = in_ret(int_fn, int_ret)
    return lambda dt: float_fn if dt.is_float else on_ints(dt)


def _logaddexp2(x, y):
    if x.is_complex():  # torch has no complex logaddexp2
        return torch.logaddexp(x * _LN2, y * _LN2) / _LN2
    return torch.logaddexp2(x, y)


_LN2 = 0.6931471805599453


def _floor(x, y):
    return uf.float_divmod(x, y)[0]


def _mod(x, y):
    return uf.float_divmod(x, y)[1]


_INT_DOMAIN = (_dt.BOOL,) + INTS8
# name -> (domains, make(dt), return rule)
_OWN = {
    "float_power": (ALL13, in_ret(torch.pow, float_ret), float_ret),
    "logaddexp": (ALL13, in_ret(torch.logaddexp, float_ret), float_ret),
    "logaddexp2": (ALL13, in_ret(_logaddexp2, float_ret), float_ret),
    "nextafter": (ALL11, in_ret(torch.nextafter, float_ret), float_ret),
    "floor_divide": (ALL11, _int_or_float(_floor_divide, _floor), int_ret),
    "fmod": (ALL11, _int_or_float(_by_nonzero(torch.fmod), torch.fmod),
             int_ret),
    "mod": (ALL11, _int_or_float(_by_nonzero(torch.remainder), _mod),
            int_ret),
    "remainder": (ALL11, _int_or_float(_by_nonzero(torch.remainder), _mod),
                  int_ret),
    "left_shift": (_INT_DOMAIN, in_ret(_shift(True), int_ret), int_ret),
    "right_shift": (_INT_DOMAIN, in_ret(_shift(False), int_ret), int_ret),
    "gcd": (INTS8, lambda dt: torch.gcd, None),
    "lcm": (INTS8, lambda dt: torch.lcm, None),
}


def _build(name):
    doms, make, rule = _OWN[name]
    op = BinaryOp._builtin(f"numpy.{name}", doms, make, rule)
    op._refusal = exceptions.UdfParseError
    return op


__all__ = sorted(_NAMES)


def __dir__():
    return sorted(set(globals()) | _NAMES)


def __getattr__(name):
    if name not in _NAMES:
        raise AttributeError(
            f"module 'graphblas_tpu_torch.binary.numpy' has no attribute "
            f"{name!r}")
    if name in TO_GRAPHBLAS:
        from .. import binary

        op = getattr(binary, TO_GRAPHBLAS[name])
    else:
        op = _build(name)
    globals()[name] = op
    return op
