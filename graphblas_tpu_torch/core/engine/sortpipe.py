"""Scan combines and carrier types shared by the lanepipe (the parts of
graphblas_tpu/core/engine/sortpipe.py that the lanepipe uses; the
sort-pipeline engine itself is not ported yet, ROADMAP.md queue 1, item 9).

Values ride the engine as 32-bit carriers: float32 for FP32, int32 for
INT32 and BOOL (0/1), and int32 bits for UINT32, whose min/max compare
with the sign bit flipped.
"""

import torch

from .. import dtypes as _dt

_SIGN = -(1 << 31)


def _umin(a, b):
    return torch.minimum(a ^ _SIGN, b ^ _SIGN) ^ _SIGN


def _umax(a, b):
    return torch.maximum(a ^ _SIGN, b ^ _SIGN) ^ _SIGN


_SCAN_MONOIDS = {
    "plus": lambda a, b: a + b,
    "times": lambda a, b: a * b,
    "min": torch.minimum,
    "max": torch.maximum,
    # booleans carried as int32 0/1
    "lor": torch.maximum,
    "land": lambda a, b: a * b,
    "band": lambda a, b: a & b,
    "bor": lambda a, b: a | b,
}


def monoid_scan_fn(name, dt):
    """The combine of monoid `name` on dt's carrier, or None."""
    if dt.is_unsigned and name in ("min", "max"):
        return _umin if name == "min" else _umax
    return _SCAN_MONOIDS.get(name)


def eligible_dtype(dt):
    """32-bit-representable, non-UDT dtype."""
    return (not dt._is_udt and dt.np_type.kind in "biuf"
            and dt.np_type.itemsize <= 4)


def carrier_dtype(dt):
    """torch dtype values are carried as through the kernels."""
    return torch.float32 if dt.is_float else torch.int32


def kernel_dtype(dt):
    """The carrier type code of csrc/common.cuh."""
    if dt.is_float:
        return "f32"
    if dt.is_bool:
        return "bool"
    return "u32" if dt.is_unsigned else "i32"


def to_carrier(t, dt):
    """Storage tensor of dt -> carrier tensor (UINT32 wraps to int32 bits)."""
    return t.to(carrier_dtype(dt))


def from_carrier(t, dt):
    """Carrier tensor -> storage tensor of dt."""
    if dt is _dt.UINT32:
        return t.to(torch.int64) & 0xFFFFFFFF
    return _dt.normalize(t, dt)


def carrier_scalar(value, dt):
    """A Python value of dt as its carrier's Python number (UINT32 as the
    signed int32 with the same bits)."""
    if dt.is_float:
        return float(value)
    v = int(value) & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def eligible_spmv(ring, a_dt, u_dt):
    """Can the lanepipe execute this (ring, dtypes) combination?"""
    mono = ring.monoid
    mult = ring.binaryop
    if mult._positional is not None:
        return False
    if not (eligible_dtype(a_dt) and eligible_dtype(u_dt)):
        return False
    if mono.type._is_udt or not eligible_dtype(mono.type):
        return False
    if getattr(mult, "return_type", None) is None:
        return False
    if not eligible_dtype(mult.return_type):
        return False
    if monoid_scan_fn(mono.parent.name, mono.type) is None:
        return False
    if mono.identity is None:
        return False
    return True
