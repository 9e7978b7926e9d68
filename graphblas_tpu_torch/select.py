"""``graphblas_tpu_torch.select``: the builtin select operators, the
index-unary operators that return BOOL (``tril``, ``triu``, ``diag``,
``offdiag``, ``rowle``/``rowgt``, ``colle``/``colgt``, ``valueeq`` ...
``valuele``), and the aliases ``indexle`` and ``indexgt``.  A name of the
JAX package's namespace that the port lacks raises NotImplementedError."""

from .core.operator.base import missing
from .core.operator.indexunary import SELECT as _B
from .core.operator.indexunary import SelectOp, TypedSelectOp

# the names of graphblas_tpu.select
REFERENCE_NAMES = frozenset((
    *_B, "indexle", "indexgt", "from_string", "register_new",
    "register_anonymous", "ss", "value", "row", "column", "index"))

globals().update(_B)
indexle = _B["rowle"]
indexgt = _B["rowgt"]


def __getattr__(name):
    raise missing("select", name, REFERENCE_NAMES)


__all__ = ["SelectOp", "TypedSelectOp", "indexle", "indexgt", *_B]
