"""Semirings: (add monoid, multiply binary op) pairs, composed by name
(``min_plus``, ``lor_land``) as graphblas_tpu/core/operator/semiring.py
does."""

from .. import dtypes as _dt
from .base import OpBase, TypedOpBase
from .binary import BUILTINS as _BINARY
from .monoid import BUILTINS as _MONOID


class TypedSemiring(TypedOpBase):
    opclass = "Semiring"

    def __init__(self, parent, name, monoid, binaryop):
        super().__init__(parent, name, binaryop.type, monoid.return_type)
        self.monoid = monoid
        self.binaryop = binaryop


class Semiring(OpBase):
    opclass = "Semiring"

    def __init__(self, name, monoid, binaryop):
        super().__init__(name)
        self.monoid = monoid
        self.binaryop = binaryop

    def _build_typed(self, dt):
        if self.binaryop._positional is not None and \
                dt not in self.binaryop._domains:
            dt = _dt.INT64  # a positional multiply ignores the values
        try:
            bop = self.binaryop[dt]
            mono = self.monoid[bop.return_type]
        except KeyError:
            return None
        return TypedSemiring(self, self.name, mono, bop)


def from_name(name):
    """``<monoid>_<binaryop>`` -> Semiring, or None."""
    head, sep, tail = name.partition("_")
    if sep and head in _MONOID and tail in _BINARY:
        return Semiring(name, _MONOID[head], _BINARY[tail])
    return None
