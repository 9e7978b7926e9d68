"""Builtin monoids: an associative binary op and its identity
(graphblas_tpu/core/operator/monoid.py, same identities).  ``any`` picks
one of its operands and has no identity; the dense engine takes the first
stored one in index order.

Two coercions of the JAX package (graphblas_tpu/core/operator/
coercions.py) hold here too: ``min``, ``max`` and ``times`` over BOOL are
the logical monoids ``land``, ``lor`` and ``land`` (SuiteSparse's boolean
renaming; ``plus`` is renamed only inside a semiring), and ``lor`` and
``land`` over any other type are their BOOL instances, which cast the
values to BOOL."""

import numpy as np

from .. import dtypes as _dt
from .base import OpBase, TypedOpBase
from .binary import BUILTINS as _B

_REAL = (_dt.INT32, _dt.INT64, _dt.UINT32, _dt.FP32, _dt.FP64)


def _identity_min(dt):
    return np.inf if dt.is_float else int(np.iinfo(dt.np_type).max)


def _identity_max(dt):
    return -np.inf if dt.is_float else int(np.iinfo(dt.np_type).min)


# SuiteSparse's boolean renaming: an arithmetic monoid over BOOL means
# its logical counterpart
BOOL_RENAME = {"plus": "lor", "times": "land", "min": "land", "max": "lor"}

# name -> (domains, identity or identity(dt))
_BUILTIN = {
    "plus": (_REAL, 0),
    "times": (_REAL, 1),
    "min": (_REAL, _identity_min),
    "max": (_REAL, _identity_max),
    "lor": ((_dt.BOOL,), False),
    "land": ((_dt.BOOL,), True),
    "band": ((_dt.UINT32,), lambda dt: int(np.iinfo(dt.np_type).max)),
    "bor": ((_dt.UINT32,), 0),
    "any": ((_dt.BOOL,) + _REAL, None),
}


class TypedMonoid(TypedOpBase):
    opclass = "Monoid"

    def __init__(self, parent, name, type_, binaryop, identity):
        super().__init__(parent, name, type_, type_)
        self.binaryop = binaryop
        self.identity = identity


class Monoid(OpBase):
    opclass = "Monoid"

    def __init__(self, name, domains, identity):
        super().__init__(name)
        self._domains = domains
        self._identity = identity

    @property
    def binaryop(self):
        """The binary op of the same name (what an element-wise operation
        or a Kronecker product by this monoid applies)."""
        return _B[self.name]

    def _build_typed(self, dt):
        if dt not in self._domains:
            if dt is _dt.BOOL and self.name in BOOL_RENAME and \
                    self.name != "plus":
                return BUILTINS[BOOL_RENAME[self.name]][dt]
            if self.name in ("lor", "land") and dt in _REAL:
                return self[_dt.BOOL]
            return None
        ident = self._identity(dt) if callable(self._identity) else self._identity
        return TypedMonoid(self, self.name, dt, _B[self.name][dt], ident)


BUILTINS = {name: Monoid(name, doms, ident)
            for name, (doms, ident) in _BUILTIN.items()}
