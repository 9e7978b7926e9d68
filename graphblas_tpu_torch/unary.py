"""``graphblas_tpu_torch.unary``: ``identity`` and ``register_anonymous``
for user functions over tensors.  The positional unaries (``positioni``,
``positioni1``, ``positionj``, ``positionj1``) live under ``unary.ss``, as
in the JAX package.  An operator of the JAX package that the port lacks
raises NotImplementedError."""

from .core.operator.base import missing
from .core.operator.unary import BUILTINS as _B, TypedUnaryOp, UnaryOp

# the names of graphblas_tpu.unary (its `ss` and `numpy` namespaces too)
REFERENCE_NAMES = frozenset((
    "abs", "acos", "acosh", "ainv", "asin", "asinh", "atan", "atanh", "bnot",
    "carg", "cbrt", "ceil", "cimag", "conj", "cos", "cosh", "creal", "exp",
    "exp2", "expm1", "floor", "identity", "isfinite", "isinf", "isnan",
    "lnot", "log", "log10", "log1p", "log2", "minv", "one", "round",
    "signum", "sin", "sinh", "sqrt", "tan", "tanh", "trunc", "numpy"))
REFERENCE_SS_NAMES = frozenset((
    "erf", "erfc", "frexpe", "frexpx", "lgamma", "tgamma", "positioni",
    "positioni1", "positionj", "positionj1", "register_new"))

_plain = {k: v for k, v in _B.items() if v._positional is None}
globals().update(_plain)
register_anonymous = UnaryOp.register_anonymous


class _SSNamespace:
    """``unary.ss``: the positional unary operators."""

    def __init__(self, ops):
        self.__dict__.update(ops)

    def __getattr__(self, name):
        raise missing("unary.ss", name, REFERENCE_SS_NAMES)


ss = _SSNamespace({k: v for k, v in _B.items() if v._positional is not None})


def __getattr__(name):
    raise missing("unary", name, REFERENCE_NAMES)


__all__ = ["UnaryOp", "TypedUnaryOp", "register_anonymous", "ss", *_plain]
