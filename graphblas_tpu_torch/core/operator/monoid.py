"""Monoids: an associative binary op and its identity
(graphblas_tpu/core/operator/monoid.py, same names, domains, identities
and terminals): min and max over the ten non-BOOL real types, plus and
times over those and FC32 and FC64; lor, land, lxor, lxnor and eq over
BOOL; band, bor, bxor and bxnor over the unsigned integers; any over all
thirteen types and every user-defined type.  ``any`` picks one of its
operands and has no identity; the dense engine takes the first stored
one in index order.  A monoid of a user-defined type's binary op
(``is_udt=True``) keeps its identity for every type it is typed for: a
number fills each field.

The coercions of core/operator/coercions.py add aliases: ``min``, ``max``
and ``times`` over BOOL are the logical monoids ``land``, ``lor`` and
``land`` (SuiteSparse's boolean renaming; ``plus`` is renamed only inside
a semiring), and the logical monoids over any other type are their BOOL
instances, which cast the values to BOOL."""

from collections.abc import Mapping

import numpy as np

from .. import dtypes as _dt
from .base import OpBase, ParameterizedUdf, TypedOpBase
from .binary import BUILTINS as _B

REAL10 = _dt.ALL[1:]
UINTS = (_dt.UINT8, _dt.UINT16, _dt.UINT32, _dt.UINT64)


def _imax(dt):
    return int(np.iinfo(dt.np_type).max)


def _identity_min(dt):
    return np.inf if dt.is_float else _imax(dt)


def _identity_max(dt):
    return -np.inf if dt.is_float else int(np.iinfo(dt.np_type).min)


class TypedMonoid(TypedOpBase):
    opclass = "Monoid"

    def __init__(self, parent, name, type_, binaryop, identity, *,
                 is_idempotent=False, terminal=None):
        super().__init__(parent, name, type_, binaryop.return_type)
        self.binaryop = binaryop
        self.identity = identity
        self._is_idempotent = is_idempotent
        self._terminal = terminal

    @property
    def is_idempotent(self):
        return self._is_idempotent


class Monoid(OpBase):
    opclass = "Monoid"
    _modname = "monoid"

    def __init__(self, name, binaryop, *, is_idempotent=False,
                 anonymous=False):
        super().__init__(name, anonymous=anonymous)
        self._binaryop = binaryop
        self._is_idempotent = is_idempotent
        self._udt_identity = None

    @property
    def binaryop(self):
        """The binary op (what an element-wise operation or a Kronecker
        product by this monoid applies)."""
        return self._binaryop

    @property
    def is_idempotent(self):
        return self._is_idempotent

    @property
    def identities(self):
        return {t: op.identity for t, op in self._typed_ops.items()}

    @property
    def _domains(self):
        """The types it is defined on (not the coercions' aliases)."""
        return tuple(t for t, op in self._typed_ops.items() if op.type is t)

    def _build_typed(self, dt):
        if dt._is_udt:
            # ``any``, and a monoid of a user function, with the identity
            # it was made with
            if self._binaryop._udf is None and (self._anonymous
                                                or self.name != "any"):
                return None
            try:
                bop = self._binaryop[dt]
            except (KeyError, TypeError, ValueError):
                return None
            return TypedMonoid(self, self.name, dt, bop, self._udt_identity,
                               is_idempotent=self._is_idempotent)
        # a monoid of a user (or numpy) function types it on demand, with
        # no identity, as the JAX package's does
        if self._refusal is KeyError:
            return None
        return TypedMonoid(self, self.name, dt, self._binaryop[dt], None,
                           is_idempotent=self._is_idempotent)

    @classmethod
    def _builtin(cls, name, domains, identity, *, is_idempotent=False,
                 terminal=None):
        bop = _B[name]
        mono = cls(name, bop, is_idempotent=is_idempotent)
        for dt in domains:
            ident = identity(dt) if callable(identity) else identity
            term = terminal(dt) if callable(terminal) else terminal
            mono._typed_ops[dt] = TypedMonoid(
                mono, name, dt, bop[dt], ident, is_idempotent=is_idempotent,
                terminal=term)
        return mono

    @classmethod
    def register_anonymous(cls, binaryop, identity, name=None, *,
                           is_idempotent=False):
        """A Monoid of a BinaryOp and an identity (one value, or a dict
        type -> value), over the types where the op is closed."""
        from .binary import BinaryOp, ParameterizedBinaryOp

        if isinstance(binaryop, ParameterizedBinaryOp):
            return ParameterizedMonoid(name, binaryop, identity,
                                       is_idempotent=is_idempotent,
                                       anonymous=True)
        if not isinstance(binaryop, BinaryOp):
            raise TypeError(f"binaryop must be a BinaryOp; got "
                            f"{type(binaryop)}")
        mono = cls(name if name is not None else f"{binaryop.name}_monoid",
                   binaryop, is_idempotent=is_idempotent, anonymous=True)
        mono._refusal = binaryop._refusal
        explicit = isinstance(identity, Mapping)
        if explicit:
            idents = {_dt.lookup_dtype(k): v for k, v in identity.items()}
        else:
            idents = dict.fromkeys(binaryop.types, identity)
        for dt, ident in idents.items():
            bop = binaryop._typed_ops.get(dt)
            if bop is None:
                if explicit:
                    raise ValueError(f"binaryop {binaryop.name} not defined "
                                     f"for {dt}")
                continue
            if bop.return_type != dt:
                if explicit:
                    raise ValueError(
                        f"binaryop {binaryop.name}[{dt}] is not closed "
                        f"(returns {bop.return_type}); cannot be a monoid")
                continue
            mono._typed_ops[dt] = TypedMonoid(mono, mono.name, dt, bop, ident,
                                              is_idempotent=is_idempotent)
        if binaryop._udf is not None and not explicit:
            mono._udt_identity = identity
        if not mono._typed_ops and binaryop._udf is None:
            raise ValueError(f"Unable to create monoid from binaryop "
                             f"{binaryop.name}: no closed dtypes")
        return mono

    @classmethod
    def register_new(cls, name, binaryop, identity, *, is_idempotent=False,
                     lazy=False):
        from .utils import register_into_namespace

        mono = cls.register_anonymous(binaryop, identity, name,
                                      is_idempotent=is_idempotent)
        mono._anonymous = False
        register_into_namespace("monoid", name, mono)
        return mono


class ParameterizedMonoid(ParameterizedUdf):
    def __init__(self, name, binaryop, identity, *, is_idempotent=False,
                 anonymous=False):
        super().__init__(name if name is not None
                         else f"{binaryop.name}_monoid", anonymous)
        self.binaryop = binaryop
        self.identity = identity
        self._is_idempotent = is_idempotent

    def __call__(self, *args, **kwargs):
        bop = self.binaryop(*args, **kwargs)
        ident = self.identity
        if callable(ident):
            ident = ident(*args, **kwargs)
        return Monoid.register_anonymous(bop, ident, self.name,
                                         is_idempotent=self._is_idempotent)


_BOOL = (_dt.BOOL,)
BUILTINS = {
    "min": Monoid._builtin("min", REAL10, _identity_min, is_idempotent=True,
                           terminal=_identity_max),
    "max": Monoid._builtin("max", REAL10, _identity_max, is_idempotent=True,
                           terminal=_identity_min),
    "plus": Monoid._builtin("plus", REAL10 + _dt.COMPLEX, 0),
    "times": Monoid._builtin("times", REAL10 + _dt.COMPLEX, 1,
                             terminal=lambda dt: 0 if dt.is_int else None),
    "any": Monoid._builtin("any", _dt.ALL13, None, is_idempotent=True),
    "lor": Monoid._builtin("lor", _BOOL, False, is_idempotent=True,
                           terminal=True),
    "land": Monoid._builtin("land", _BOOL, True, is_idempotent=True,
                            terminal=False),
    "lxor": Monoid._builtin("lxor", _BOOL, False),
    "lxnor": Monoid._builtin("lxnor", _BOOL, True),
    "eq": Monoid._builtin("eq", _BOOL, True),
    "band": Monoid._builtin("band", UINTS, _imax, is_idempotent=True,
                            terminal=0),
    "bor": Monoid._builtin("bor", UINTS, 0, is_idempotent=True,
                           terminal=_imax),
    "bxor": Monoid._builtin("bxor", UINTS, 0),
    "bxnor": Monoid._builtin("bxnor", UINTS, _imax),
}

from . import coercions  # noqa: E402
from .unary import BUILTINS as _UNARY  # noqa: E402

coercions.install(_UNARY, _B, BUILTINS)
