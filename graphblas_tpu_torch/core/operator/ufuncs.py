"""The C semantics of the builtin operators as torch functions
(graphblas_tpu/core/operator/ufuncs.py).

SuiteSparse pins down edge cases where torch's defaults differ:

- integer division truncates toward zero, and x / 0 is 0 for x = 0, else
  the type's maximum (x > 0) or minimum (x < 0);
- BOOL arithmetic: plus = lor, times = land, minus = lxor, div(x, 0) = 1,
  minv(x) = 1, ainv(x) = x, pow(x, y) = x | !y;
- ``minv`` on the integers is idiv(1, x); ``ainv`` wraps on the unsigned;
- integer ``pow`` goes through float64 and truncates;
- ``round`` rounds half away from zero (torch rounds half to even).

A complex type takes the float functions (``minv`` is 1 / x, ``div`` and
``truediv`` true division), and its own ``pow`` (:func:`_cpow`).

Every function here is made for one DataType by a ``make(dt)`` factory and
takes storage tensors of that type (core/dtypes.py): UINT64 arrives as
int64 bits, so its comparisons, min/max, division, shifts and casts to
float go through the helpers below, which read them as unsigned.
"""

import numpy as np
import torch

from .. import dtypes as _dt

_SIGN64 = -(1 << 63)


def _imax(dt):
    if dt is _dt.UINT64:
        return -1  # all bits set
    return int(np.iinfo(dt.np_type).max)


def _imin(dt):
    return int(np.iinfo(dt.np_type).min) if dt.is_signed_int else 0


def ordered(x, dt):
    """x with the order of dt kept by a signed comparison (UINT64 bits with
    the sign bit flipped)."""
    return x ^ _SIGN64 if dt is _dt.UINT64 else x


def lt(dt):
    return lambda x, y: ordered(x, dt) < ordered(y, dt)


def le(dt):
    return lambda x, y: ordered(x, dt) <= ordered(y, dt)


def gt(dt):
    return lambda x, y: ordered(x, dt) > ordered(y, dt)


def ge(dt):
    return lambda x, y: ordered(x, dt) >= ordered(y, dt)


def minimum(dt):
    """GraphBLAS ``min``: fmin on floats (a NaN operand is ignored)."""
    if dt.is_float:
        return torch.fmin
    if dt.is_bool:
        return torch.logical_and
    if dt is _dt.UINT64:
        return lambda x, y: torch.minimum(x ^ _SIGN64, y ^ _SIGN64) ^ _SIGN64
    return torch.minimum


def maximum(dt):
    if dt.is_float:
        return torch.fmax
    if dt.is_bool:
        return torch.logical_or
    if dt is _dt.UINT64:
        return lambda x, y: torch.maximum(x ^ _SIGN64, y ^ _SIGN64) ^ _SIGN64
    return torch.maximum


def _u64_divmod(x, y):
    """Unsigned 64-bit x // y and x % y on int64 bits, y != 0: halve x to
    stay below 2**63, divide, and correct the quotient by one."""
    big_y = y < 0  # y >= 2**63: the quotient is 0 or 1
    ys = torch.where(big_y, 1, y)
    q = (((x >> 1) & 0x7FFFFFFFFFFFFFFF) // ys) << 1
    r = x - q * ys
    fix = (r ^ _SIGN64) >= (ys ^ _SIGN64)
    q = torch.where(fix, q + 1, q)
    r = torch.where(fix, r - ys, r)
    ge_y = (x ^ _SIGN64) >= (y ^ _SIGN64)
    q = torch.where(big_y, ge_y.to(torch.int64), q)
    r = torch.where(big_y, torch.where(ge_y, x - y, x), r)
    return q, r


def idiv(dt):
    """C-truncated integer division with SuiteSparse's x / 0."""
    top, bottom = _imax(dt), _imin(dt)

    def fn(x, y):
        zero = y == 0
        ys = torch.where(zero, torch.ones_like(y), y)
        if dt is _dt.UINT64:
            q = _u64_divmod(x, ys)[0]
        else:
            q = torch.div(x, ys, rounding_mode="trunc")
        if dt.is_signed_int:
            by_zero = torch.where(x == 0, 0, torch.where(x > 0, top, bottom))
        else:
            by_zero = torch.where(x == 0, 0, top)
        return torch.where(zero, by_zero.to(q.dtype), q)

    return fn


def div(dt):
    """GraphBLAS ``div`` (``cdiv``): truncated for integers, x | !y on
    BOOL, true division on floats."""
    if dt.is_bool:
        return lambda x, y: torch.where(y, x, torch.ones_like(x))
    if dt.is_int:
        return idiv(dt)
    return lambda x, y: x / y


def minv(dt):
    if dt.is_bool:
        return torch.ones_like
    if dt.is_int:
        d = idiv(dt)
        return lambda x: d(torch.ones_like(x), x)
    if dt.is_complex:
        return torch.reciprocal  # 1 / 0 is inf + nan j, as numpy's
    return lambda x: 1.0 / x


def plus(dt):
    return torch.logical_or if dt.is_bool else (lambda x, y: x + y)


def minus(dt):
    return torch.logical_xor if dt.is_bool else (lambda x, y: x - y)


def times(dt):
    return torch.logical_and if dt.is_bool else (lambda x, y: x * y)


def ainv(dt):
    if dt.is_bool:
        return lambda x: x
    return lambda x: torch.zeros_like(x) - x  # wraps on the unsigned


def absolute(dt):
    if dt.is_bool or dt.is_unsigned:
        return lambda x: x
    return torch.abs


def to_float64(x, dt):
    return _dt.u64_to_float(x) if dt is _dt.UINT64 else x.to(torch.float64)


def from_float64(r, dt):
    """float64 -> dt's storage, truncated as a C cast."""
    return _dt.normalize(torch.trunc(r), dt)


def _cpow(x, y):
    """Complex x**y: torch's exp(y log x), with numpy's x**0 = 1 (0**0
    included) and x**1 = x (inf**1 is inf, not inf + nan j)."""
    out = torch.pow(x, y)
    out = torch.where(y == 1, x, out)
    return torch.where(y == 0, torch.ones_like(out), out)


def power(dt):
    if dt.is_bool:
        return lambda x, y: x | ~y
    if dt.is_int:
        return lambda x, y: from_float64(
            torch.pow(to_float64(x, dt), to_float64(y, dt)), dt)
    if dt.is_complex:
        return _cpow
    return torch.pow


def _logical(fn, dt):
    if dt.is_bool:
        return lambda x, y: fn(x, y)
    return lambda x, y: fn(x != 0, y != 0).to(x.dtype)


def lor(dt):
    return _logical(torch.logical_or, dt)


def land(dt):
    return _logical(torch.logical_and, dt)


def lxor(dt):
    return _logical(torch.logical_xor, dt)


def lxnor(dt):
    return _logical(lambda a, b: a == b, dt)


def lnot(dt):
    if dt.is_bool:
        return torch.logical_not
    return lambda x: (x == 0).to(x.dtype)


def bnot(dt):
    return lambda x: ~x  # normalize masks the unsigned carried wide


def signum(dt):
    if dt.is_bool:
        return lambda x: x
    if dt is _dt.UINT64:
        return lambda x: (x != 0).to(x.dtype)
    return torch.sign


def _shr_logical(x, s, dt):
    """x >> s with zeros shifted in, for x of dt's storage."""
    if dt is _dt.UINT64:
        mask = torch.where(s == 0, -1, (1 << (64 - s.clamp(min=1))) - 1)
        return (x >> s) & mask
    return x >> s  # the other unsigned are stored nonnegative


def bshift(dt):
    """x shifted by y bits: left for y >= 0, right (arithmetic on the
    signed) for y < 0; a shift of the type's width or more gives 0 (or -1
    for a negative signed x shifted right)."""
    nbits = dt.bits

    def fn(x, y):
        yl = y.to(torch.int64)
        mag = yl.abs()
        big = mag >= nbits
        s = torch.where(big, 0, mag).to(torch.int64)
        xw = x.to(torch.int64)
        left = _dt.normalize(xw << s, dt)
        if dt.is_signed_int:
            right = torch.where(big, torch.where(xw < 0, -1, 0), xw >> s)
        else:
            right = torch.where(big, 0, _shr_logical(xw, s, dt))
        left = torch.where(big, 0, left.to(torch.int64))
        return _dt.normalize(torch.where(yl >= 0, left, right), dt)

    return fn


def _bit(y, dt):
    """(bit position as int64, in range?): a position outside [0, bits)
    shifts everything out, as XLA's shifts do in the JAX package."""
    p = y.to(torch.int64)
    ok = (p >= 0) & (p < dt.bits)
    return torch.where(ok, p, 0), ok


def bget(dt):
    def fn(x, y):
        p, ok = _bit(y, dt)
        xw = x.to(torch.int64)
        out = torch.where(ok, (xw >> p) & 1,
                          (xw < 0).to(torch.int64) if dt.is_signed_int else 0)
        return _dt.normalize(out, dt)

    return fn


def bset(dt):
    def fn(x, y):
        p, ok = _bit(y, dt)
        return _dt.normalize(x.to(torch.int64) | torch.where(ok, 1 << p, 0), dt)

    return fn


def bclr(dt):
    def fn(x, y):
        p, ok = _bit(y, dt)
        return _dt.normalize(x.to(torch.int64) & ~torch.where(ok, 1 << p, 0),
                             dt)

    return fn


def _pow2(k, dt):
    """2**k for integer k in a float type's normal range, exactly (its
    bits)."""
    if dt is _dt.FP32:
        return ((k + 127) << 23).to(torch.int32).view(torch.float32)
    return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


def ldexp(dt):
    """x * 2**trunc(y), the exponent saturated to int32 (NaN -> 0) as the
    JAX package casts it, in three exact power-of-two steps, so that a
    huge exponent overflows to inf (or a zero x stays 0) rather than
    meeting an infinite factor."""
    step = 100 if dt is _dt.FP32 else 700

    def fn(x, y):
        e = _dt.normalize(y, _dt.INT32).clamp(-3 * step, 3 * step)
        a1 = torch.div(e, 3, rounding_mode="trunc")
        a2 = torch.div(e - a1, 2, rounding_mode="trunc")
        a3 = e - a1 - a2
        return x * _pow2(a1, dt) * _pow2(a2, dt) * _pow2(a3, dt)

    return fn


def float_divmod(x, y):
    """(floor(x / y), x mod y) on floats as jnp.floor_divide and
    jnp.remainder compute them: from C's fmod, the quotient corrected by
    one and rounded (so x // 0 is NaN)."""
    mod = torch.fmod(x, y)
    ind = (mod != 0) & (torch.sign(y) != torch.sign(mod))
    div = (x - mod) / y
    return (c_round(torch.where(ind, div - 1, div)),
            torch.where(ind, mod + y, mod))


def c_round(x):
    """Round half away from zero (C's round)."""
    return torch.where(torch.isfinite(x),
                       torch.sign(x) * torch.floor(x.abs() + 0.5), x).to(x.dtype)


def frexpx(x):
    return torch.frexp(x)[0]


def frexpe(x):
    return torch.frexp(x)[1].to(x.dtype)
