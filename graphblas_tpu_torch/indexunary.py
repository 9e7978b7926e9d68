"""``graphblas_tpu_torch.indexunary``: the builtin index-unary operators
(``rowindex``, ``tril``, ``valuegt``, ...) and the aliases ``indexle`` and
``indexgt``.  A name of the JAX package's namespace that the port lacks
raises NotImplementedError."""

from .core.operator.base import missing
from .core.operator.indexunary import INDEXUNARY as _B
from .core.operator.indexunary import IndexUnaryOp, TypedIndexUnaryOp

# the names of graphblas_tpu.indexunary
REFERENCE_NAMES = frozenset((
    *_B, "indexle", "indexgt", "from_string", "register_new",
    "register_anonymous", "ss"))

globals().update(_B)
indexle = _B["rowle"]
indexgt = _B["rowgt"]


def __getattr__(name):
    raise missing("indexunary", name, REFERENCE_NAMES)


__all__ = ["IndexUnaryOp", "TypedIndexUnaryOp", "indexle", "indexgt", *_B]
