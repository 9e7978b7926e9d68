"""Semirings: (add monoid, multiply binary op) pairs, composed by name
(``min_plus``, ``lor_land``) as graphblas_tpu/core/operator/semiring.py
does.

A ring whose products are BOOL takes the logical counterpart of an
arithmetic monoid (``plus_times["BOOL"]`` reduces with ``lor``), and a
logical monoid over other products takes its BOOL instance
(``lor_land["FP32"]`` casts its products to BOOL before the reduce), as
in the JAX package."""

from .. import dtypes as _dt
from .base import OpBase, TypedOpBase
from .binary import BUILTINS as _BINARY
from .monoid import BOOL_RENAME, BUILTINS as _MONOID

# multiplies whose result is true exactly when the multiply of the
# operands' truth values is: a ring of these under a logical monoid may
# cast its operands to BOOL first (``times`` may underflow or wrap to 0)
_TRUTHY_MULTS = ("land", "lor", "first", "second", "any", "pair")
_BITWISE = ("band", "bor", "bxor", "bxnor")


class TypedSemiring(TypedOpBase):
    opclass = "Semiring"

    def __init__(self, parent, name, monoid, binaryop):
        super().__init__(parent, name, binaryop.type, monoid.return_type)
        self.monoid = monoid
        self.binaryop = binaryop

    def bool_twin(self):
        """The BOOL instance of this ring when its logical monoid reduces
        products of another type that a cast of the operands to BOOL
        computes as well (``lor_land["FP32"]``: cast, then ``lor_land[BOOL]``);
        else None."""
        mult = self.binaryop
        if (self.monoid.type is _dt.BOOL and mult.return_type is not _dt.BOOL
                and mult.name in _TRUTHY_MULTS):
            return self.parent[_dt.BOOL]
        return None


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
        if self.monoid.name in _BITWISE and self.binaryop.name in _BITWISE \
                and dt in (_dt.INT32, _dt.INT64):
            raise NotImplementedError(
                f"{self.name}[{dt.name}]: the JAX package takes signed inputs "
                f"to a bitwise ring as UINT64, which is not in the PyTorch "
                f"port yet (ROADMAP.md queue 1, item 12)")
        try:
            bop = self.binaryop[dt]
        except KeyError:
            return None
        try:
            mono = self.monoid[bop.return_type]
        except KeyError:
            if bop.return_type is not _dt.BOOL or \
                    self.monoid.name not in BOOL_RENAME:
                return None
            mono = _MONOID[BOOL_RENAME[self.monoid.name]][_dt.BOOL]
        return TypedSemiring(self, self.name, mono, bop)


def from_name(name):
    """``<monoid>_<binaryop>`` -> Semiring, or None."""
    head, sep, tail = name.partition("_")
    if sep and head in _MONOID and tail in _BINARY:
        return Semiring(name, _MONOID[head], _BINARY[tail])
    return None
