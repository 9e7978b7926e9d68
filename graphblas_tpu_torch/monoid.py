"""``graphblas_tpu_torch.monoid``: the builtin monoids of the port."""

from .core.operator.monoid import BUILTINS as _B, Monoid, TypedMonoid

globals().update(_B)

__all__ = ["Monoid", "TypedMonoid", *_B]
