"""``graphblas_tpu_torch.select``: the builtin select operators, the
index-unary operators that return BOOL (``tril``, ``triu``, ``diag``,
``offdiag``, ``rowle``/``rowgt``, ``colle``/``colgt``, ``valueeq`` ...
``valuele``), the aliases ``indexle`` and ``indexgt``, and user select
operators.  The expression forms ``select.value``, ``row``, ``column``
and ``index`` wait for the infix expressions and raise
NotImplementedError."""

from .core.operator import utils as _utils
from .core.operator.base import missing
from .core.operator.indexunary import SELECT as _B
from .core.operator.indexunary import SelectOp, TypedSelectOp

# the names of graphblas_tpu.select that the port lacks
WAITING = frozenset(("value", "row", "column", "index"))

register_new = SelectOp.register_new
register_anonymous = SelectOp.register_anonymous
globals().update(_B)
indexle = _B["rowle"]
indexgt = _B["rowgt"]


def from_string(string):
    return _utils.select_from_string(string)


class _SSNamespace:
    """``select.ss``: ``register_new`` for a function given as Python
    source or a callable (the JAX package's engine-JIT registration)."""

    @staticmethod
    def register_new(name, jit_definition, input_type=None, thunk_type=None):
        return _utils.jit_register("select", name, jit_definition,
                                   input_type, thunk_type)

    def __getattr__(self, name):
        raise missing("select.ss", name, ())


ss = _SSNamespace()


def __getattr__(name):
    raise missing("select", name, WAITING)


__all__ = ["SelectOp", "TypedSelectOp", "register_new", "register_anonymous",
           "from_string", "indexle", "indexgt", "ss", *_B]
