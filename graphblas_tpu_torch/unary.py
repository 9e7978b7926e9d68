"""``graphblas_tpu_torch.unary``: ``identity`` and ``register_anonymous``
for user functions over tensors."""

from .core.operator.unary import BUILTINS as _B, TypedUnaryOp, UnaryOp

globals().update(_B)
register_anonymous = UnaryOp.register_anonymous

__all__ = ["UnaryOp", "TypedUnaryOp", "register_anonymous", *_B]
