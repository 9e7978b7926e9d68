"""Semirings: (add monoid, multiply binary op) pairs
(graphblas_tpu/core/operator/semiring.py), composed on demand by name
(``min_plus``, ``lor_land``) or from any monoid and binary op
(:func:`get_semiring`, :meth:`Semiring.register_new`).

A ring whose products are BOOL takes the logical counterpart of an
arithmetic monoid (``plus_times["BOOL"]`` reduces with ``lor``), a
logical monoid over other products takes its BOOL instance
(``lor_land["FP32"]`` casts its products to BOOL before the reduce), and a
bitwise ring over a signed type takes the unsigned type the JAX package
takes (``bxor_band["INT32"]`` is ``bxor_band[UINT64]``)."""

from .. import dtypes as _dt
from .base import OpBase, ParameterizedUdf, TypedOpBase
from .coercions import bitwise_input_coercion, bool_monoid_substitute

# multiplies whose result is true exactly when the multiply of the
# operands' truth values is: a ring of these under a logical monoid may
# cast its operands to BOOL first (``times`` may underflow or wrap to 0)
_TRUTHY_MULTS = ("land", "lor", "first", "second", "any", "pair")
_LOGICAL_MONOIDS = ("eq", "lor", "land", "lxor", "lxnor")


class TypedSemiring(TypedOpBase):
    opclass = "Semiring"

    def __init__(self, parent, name, type_, monoid, binaryop, type2=None):
        super().__init__(parent, name, type_, monoid.return_type, type2)
        self.monoid = monoid
        self.binaryop = binaryop
        self._positional = binaryop._positional

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
    _modname = "semiring"

    def __init__(self, name, monoid, binaryop, *, anonymous=False):
        super().__init__(name, anonymous=anonymous)
        self.monoid = monoid
        self.binaryop = binaryop
        self._positional = binaryop._positional

    def _build_typed(self, dt):
        typed = self._compose(dt)
        if typed is not None:
            return typed
        target = bitwise_input_coercion(self, dt)
        return None if target is None else self[target]

    def _compose(self, dt):
        try:
            mult = self.binaryop[dt]
        except KeyError:
            return None
        ret = mult.return_type
        try:
            add = self.monoid[ret]
        except KeyError:
            add = None
            if ret is _dt.BOOL:
                sub = bool_monoid_substitute(self.monoid)
                if sub is not None and _dt.BOOL in sub:
                    add = sub[_dt.BOOL]
            elif (self.monoid.name in _LOGICAL_MONOIDS
                  and _dt.BOOL in self.monoid._typed_ops):
                add = self.monoid._typed_ops[_dt.BOOL]
            if add is None:
                return None
        return TypedSemiring(self, self.name, dt, add, mult)

    @property
    def types(self):
        for dt in list(self.binaryop._typed_ops):
            if dt not in self._typed_ops:
                typed = self._compose(dt)
                if typed is not None:
                    self._typed_ops[dt] = typed
        return super().types

    @classmethod
    def register_anonymous(cls, monoid, binaryop, name=None):
        from .binary import ParameterizedBinaryOp
        from .monoid import Monoid, ParameterizedMonoid

        if isinstance(monoid, ParameterizedMonoid) or isinstance(
                binaryop, ParameterizedBinaryOp):
            return ParameterizedSemiring(name, monoid, binaryop,
                                         anonymous=True)
        if not isinstance(monoid, Monoid):
            raise TypeError(f"monoid must be a Monoid; got {type(monoid)}")
        return cls(name if name is not None
                   else f"{monoid.name}_{binaryop.name}", monoid, binaryop,
                   anonymous=True)

    @classmethod
    def register_new(cls, name, monoid, binaryop, *, lazy=False):
        from .utils import register_into_namespace

        ring = cls.register_anonymous(monoid, binaryop, name)
        ring._anonymous = False
        register_into_namespace("semiring", name, ring)
        return ring


class ParameterizedSemiring(ParameterizedUdf):
    def __init__(self, name, monoid, binaryop, *, anonymous=False):
        super().__init__(name if name is not None
                         else f"{monoid.name}_{binaryop.name}", anonymous)
        self.monoid = monoid
        self.binaryop = binaryop

    def __call__(self, *args, **kwargs):
        mono, bop = self.monoid, self.binaryop
        if isinstance(mono, ParameterizedUdf):
            mono = mono(*args, **kwargs)
        if isinstance(bop, ParameterizedUdf):
            bop = bop(*args, **kwargs)
        return Semiring.register_anonymous(mono, bop, self.name)


_cache = {}


def get_semiring(monoid, binaryop, name=None):
    """Compose (and cache) the Semiring of a monoid and a binary op, typed
    or not; a BinaryOp with a monoid stands for it, and a Monoid's binary
    op for the multiply (graphblas_tpu/core/operator/utils.py
    get_semiring)."""
    if isinstance(monoid, TypedOpBase):
        monoid = monoid.parent
    if isinstance(binaryop, TypedOpBase):
        binaryop = binaryop.parent
    if monoid.opclass == "BinaryOp" and monoid.monoid is not None:
        monoid = monoid.monoid
    if monoid.opclass != "Monoid":
        raise TypeError(f"monoid argument must be a Monoid; got "
                        f"{monoid.opclass} ({monoid})")
    if binaryop.opclass == "Monoid":
        binaryop = binaryop.binaryop
    if binaryop.opclass != "BinaryOp":
        raise TypeError(f"binaryop argument must be a BinaryOp; got "
                        f"{binaryop.opclass} ({binaryop})")
    key = (id(monoid), id(binaryop))
    ring = _cache.get(key)
    if ring is not None and (name is None or ring.name == name):
        return ring
    ring = Semiring(name if name is not None
                    else f"{monoid.name}_{binaryop.name}", monoid, binaryop,
                    anonymous=monoid._anonymous or binaryop._anonymous)
    if name is None:
        _cache[key] = ring
    return ring
