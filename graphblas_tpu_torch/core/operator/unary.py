"""Unary operators: the ``identity`` builtin and user functions registered
with :meth:`UnaryOp.register_anonymous`, which take a Python callable over
tensors (the JAX package takes one over jnp arrays)."""

import torch

from .. import dtypes as _dt
from .base import OpBase, TypedOpBase


class TypedUnaryOp(TypedOpBase):
    opclass = "UnaryOp"

    def __init__(self, parent, name, type_, return_type, func):
        super().__init__(parent, name, type_, return_type)
        self.func = func

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


BUILTINS = {"identity": UnaryOp("identity", lambda x: x)}
