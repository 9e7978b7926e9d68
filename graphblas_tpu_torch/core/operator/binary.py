"""Builtin binary operators, as torch functions
(graphblas_tpu/core/operator/binary.py, the subset the ported paths name).

``min`` and ``max`` on floats are ``fmin``/``fmax`` as in the JAX package
(GraphBLAS ``min`` ignores a NaN operand).  The eight positional operators
(``firsti``, ``firsti1``, ... ``secondj1``) return an index of the pair
they are applied to, plus 0 or 1; the engine computes them from positions
(core/engine/dense.py ``positional_value``), so they have no function
here.  They ignore the values: on a type other than INT32 and INT64 they
are their INT64 instance, as in the JAX package.  A builtin that has a
monoid of its name reduces with it (``BinaryOp.monoid``).  ``land`` and ``lor`` take every type, as in the JAX
package: the operands' truth values, returned in their own type."""

import torch

from .. import dtypes as _dt
from .base import OpBase, TypedOpBase

_NUM = (_dt.BOOL, _dt.INT32, _dt.INT64, _dt.UINT32, _dt.FP32, _dt.FP64)
_INTS = (_dt.INT32, _dt.INT64, _dt.UINT32)


def _logical(fn):
    def op(x, y):
        if x.dtype == torch.bool:
            return fn(x, y)
        return fn(x != 0, y != 0).to(x.dtype)

    return op


# name -> (domains, torch function); every op returns its input type
_BUILTIN = {
    "first": (_NUM, lambda x, y: x),
    "second": (_NUM, lambda x, y: y),
    "pair": (_NUM, lambda x, y: torch.ones_like(x)),
    "plus": (_NUM, lambda x, y: x + y),
    "minus": (_NUM, lambda x, y: x ^ y if x.dtype == torch.bool else x - y),
    "times": (_NUM, lambda x, y: x * y),
    "any": (_NUM, lambda x, y: x),  # either operand will do: the first
    "min": (_NUM, lambda x, y: torch.fmin(x, y) if x.dtype.is_floating_point
            else torch.minimum(x, y)),
    "max": (_NUM, lambda x, y: torch.fmax(x, y) if x.dtype.is_floating_point
            else torch.maximum(x, y)),
    "land": (_NUM, _logical(torch.logical_and)),
    "lor": (_NUM, _logical(torch.logical_or)),
    "band": (_INTS, lambda x, y: x & y),
    "bor": (_INTS, lambda x, y: x | y),
}
# name -> (which index of the pair a(i,k) b(k,j), offset)
_POSITIONAL = {"firsti": ("ai", 0), "firsti1": ("ai", 1),
               "firstj": ("aj", 0), "firstj1": ("aj", 1),
               "secondi": ("bi", 0), "secondi1": ("bi", 1),
               "secondj": ("bj", 0), "secondj1": ("bj", 1)}
_POS = (_dt.INT32, _dt.INT64)


class TypedBinaryOp(TypedOpBase):
    opclass = "BinaryOp"

    def __init__(self, parent, name, type_, func):
        super().__init__(parent, name, type_, type_)
        self.func = func
        self._positional = parent._positional

    def __call__(self, x, y):
        """Apply to storage tensors of self.type; result in return_type."""
        return _dt.normalize(self.func(x, y), self.return_type)


class BinaryOp(OpBase):
    opclass = "BinaryOp"

    def __init__(self, name, domains, func, positional=None):
        super().__init__(name)
        self._domains = domains
        self._func = func
        self._positional = positional

    def _build_typed(self, dt):
        if dt not in self._domains:
            return self[_dt.INT64] if self._positional is not None else None
        return TypedBinaryOp(self, self.name, dt, self._func)

    @property
    def monoid(self):
        """The monoid of the same name, which a reduce by this op uses
        (the JAX package's ``_HAS_MONOID``); None where there is none."""
        from .monoid import BUILTINS as monoids

        return monoids.get(self.name)


BUILTINS = {name: BinaryOp(name, doms, fn)
            for name, (doms, fn) in _BUILTIN.items()}
BUILTINS["oneb"] = BUILTINS["pair"]
BUILTINS.update({name: BinaryOp(name, _POS, None, positional=pos)
                 for name, pos in _POSITIONAL.items()})
