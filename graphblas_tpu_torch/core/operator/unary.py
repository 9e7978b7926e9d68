"""Unary operators: the builtins ``identity``, ``one``, ``abs`` and
``minv`` (graphblas_tpu/core/operator/unary.py), the positional
``positioni``, ``positioni1``, ``positionj`` and ``positionj1`` (the row
or column of each element, plus 0 or 1: the engine fills them from
positions; on a type other than INT32 and INT64 they are their INT64
instance), and user functions registered with
:meth:`UnaryOp.register_anonymous`, which take a Python callable over
tensors (the JAX package takes one over jnp arrays).

``minv`` follows SuiteSparse on the integers: C-truncated 1/x, and 1/0 is
the type's maximum."""

import numpy as np
import torch

from .. import dtypes as _dt
from .base import OpBase, TypedOpBase


class TypedUnaryOp(TypedOpBase):
    opclass = "UnaryOp"

    def __init__(self, parent, name, type_, return_type, func):
        super().__init__(parent, name, type_, return_type)
        self.func = func
        self._positional = parent._positional

    def __call__(self, x):
        out = self.func(x)
        if not isinstance(out, torch.Tensor):
            out = torch.as_tensor(out, device=x.device).expand(x.shape)
        return _dt.normalize(out, self.return_type)


class UnaryOp(OpBase):
    opclass = "UnaryOp"

    def __init__(self, name, func):
        super().__init__(name)
        self._func = func

    def _build_typed(self, dt):
        # the return type is what the function makes of one element
        probe = self._func(torch.zeros(1, dtype=dt.torch_type))
        ret = _dt.lookup_dtype(probe.dtype) if isinstance(probe, torch.Tensor) \
            else dt
        if dt is _dt.UINT32 and ret is _dt.INT64:
            ret = dt  # UINT32 is stored as int64
        return TypedUnaryOp(self, self.name, dt, ret, self._func)

    @classmethod
    def register_anonymous(cls, func, name=None):
        return cls(name if name is not None
                   else getattr(func, "__name__", "unary_op"), func)


class BuiltinUnaryOp(UnaryOp):
    """A builtin whose function depends on the operand's DataType (UINT32
    and INT64 share a storage type), returning that type."""

    def __init__(self, name, make):
        super().__init__(name, None)
        self._make = make

    def _build_typed(self, dt):
        return TypedUnaryOp(self, self.name, dt, dt, self._make(dt))


class PositionalUnaryOp(UnaryOp):
    """A positional unary: which index of the element, and an offset."""

    def __init__(self, name, positional):
        super().__init__(name, None)
        self._positional = positional

    def _build_typed(self, dt):
        if dt not in (_dt.INT32, _dt.INT64):
            return self[_dt.INT64]
        return TypedUnaryOp(self, self.name, dt, dt, None)


# name -> (which index of the element, offset)
POSITIONAL = {"positioni": ("i", 0), "positioni1": ("i", 1),
              "positionj": ("j", 0), "positionj1": ("j", 1)}


def _minv(dt):
    if dt.is_bool:
        return torch.ones_like
    if dt.is_float:
        return lambda x: 1.0 / x
    top = int(np.iinfo(dt.np_type).max)

    def minv(x):
        # 1 // x truncated toward zero: 1 for 1, -1 for -1, else 0
        q = torch.where(x == 1, 1, 0) - torch.where(x == -1, 1, 0)
        return torch.where(x == 0, top, q).to(x.dtype)

    return minv


BUILTINS = {
    "identity": UnaryOp("identity", lambda x: x),
    "one": BuiltinUnaryOp("one", lambda dt: torch.ones_like),
    "abs": BuiltinUnaryOp("abs", lambda dt: (lambda x: x) if dt.is_bool
                          or dt is _dt.UINT32 else torch.abs),
    "minv": BuiltinUnaryOp("minv", _minv),
}
BUILTINS.update({name: PositionalUnaryOp(name, pos)
                 for name, pos in POSITIONAL.items()})
