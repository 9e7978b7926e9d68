"""``graphblas_tpu_torch.unary``: ``identity`` and ``register_anonymous``
for user functions over tensors.  An operator of the JAX package that the
port lacks raises NotImplementedError."""

from .core.operator.base import missing
from .core.operator.unary import BUILTINS as _B, TypedUnaryOp, UnaryOp

# the names of graphblas_tpu.unary (its `ss` and `numpy` namespaces too)
REFERENCE_NAMES = frozenset((
    "abs", "acos", "acosh", "ainv", "asin", "asinh", "atan", "atanh", "bnot",
    "carg", "cbrt", "ceil", "cimag", "conj", "cos", "cosh", "creal", "exp",
    "exp2", "expm1", "floor", "identity", "isfinite", "isinf", "isnan",
    "lnot", "log", "log10", "log1p", "log2", "minv", "one", "round",
    "signum", "sin", "sinh", "sqrt", "tan", "tanh", "trunc", "ss", "numpy"))

globals().update(_B)
register_anonymous = UnaryOp.register_anonymous


def __getattr__(name):
    raise missing("unary", name, REFERENCE_NAMES)


__all__ = ["UnaryOp", "TypedUnaryOp", "register_anonymous", *_B]
