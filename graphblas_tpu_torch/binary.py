"""``graphblas_tpu_torch.binary``: the builtin binary operators of the port."""

from .core.operator.binary import BUILTINS as _B, BinaryOp, TypedBinaryOp

globals().update(_B)

__all__ = ["BinaryOp", "TypedBinaryOp", *_B]
