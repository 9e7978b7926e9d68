"""Builtin binary operators of the SpMV slice, as torch functions."""

import torch

from .. import dtypes as _dt
from .base import OpBase, TypedOpBase

_NUM = (_dt.BOOL, _dt.INT32, _dt.INT64, _dt.UINT32, _dt.FP32, _dt.FP64)
_INTS = (_dt.INT32, _dt.INT64, _dt.UINT32)

# name -> (domains, torch function); every op returns its input type
_BUILTIN = {
    "first": (_NUM, lambda x, y: x),
    "second": (_NUM, lambda x, y: y),
    "pair": (_NUM, lambda x, y: torch.ones_like(x)),
    "plus": (_NUM, lambda x, y: x + y),
    "times": (_NUM, lambda x, y: x * y),
    "min": (_NUM, torch.minimum),
    "max": (_NUM, torch.maximum),
    "land": ((_dt.BOOL,), lambda x, y: x & y),
    "lor": ((_dt.BOOL,), lambda x, y: x | y),
    "band": (_INTS, lambda x, y: x & y),
    "bor": (_INTS, lambda x, y: x | y),
}


class TypedBinaryOp(TypedOpBase):
    opclass = "BinaryOp"

    def __init__(self, parent, name, type_, func):
        super().__init__(parent, name, type_, type_)
        self.func = func

    def __call__(self, x, y):
        """Apply to storage tensors of self.type; result in return_type."""
        return _dt.normalize(self.func(x, y), self.return_type)


class BinaryOp(OpBase):
    opclass = "BinaryOp"

    def __init__(self, name, domains, func):
        super().__init__(name)
        self._domains = domains
        self._func = func

    def _build_typed(self, dt):
        if dt not in self._domains:
            return None
        return TypedBinaryOp(self, self.name, dt, self._func)


BUILTINS = {name: BinaryOp(name, doms, fn)
            for name, (doms, fn) in _BUILTIN.items()}
