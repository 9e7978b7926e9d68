"""``graphblas_tpu_torch.monoid``: the builtin monoids of the port.  A
monoid of the JAX package that the port lacks raises
NotImplementedError."""

from .core.operator.base import missing
from .core.operator.monoid import BUILTINS as _B, Monoid, TypedMonoid

# the names of graphblas_tpu.monoid
REFERENCE_NAMES = frozenset((
    "any", "band", "bor", "bxnor", "bxor", "eq", "land", "lor", "lxnor",
    "lxor", "max", "min", "plus", "times", "numpy"))

globals().update(_B)


def __getattr__(name):
    raise missing("monoid", name, REFERENCE_NAMES)


__all__ = ["Monoid", "TypedMonoid", *_B]
