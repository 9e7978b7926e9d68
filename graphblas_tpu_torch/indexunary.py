"""``graphblas_tpu_torch.indexunary``: the builtin index-unary operators
(``rowindex``, ``tril``, ``valuegt``, ...), the aliases ``indexle`` and
``indexgt``, and user index-unary operators."""

from .core.operator import utils as _utils
from .core.operator.base import missing
from .core.operator.indexunary import INDEXUNARY as _B
from .core.operator.indexunary import IndexUnaryOp, TypedIndexUnaryOp
from .core.ss.jit import jit_register

register_new = IndexUnaryOp.register_new
register_anonymous = IndexUnaryOp.register_anonymous
globals().update(_B)
indexle = _B["rowle"]
indexgt = _B["rowgt"]


def from_string(string):
    return _utils.indexunary_from_string(string)


class _SSNamespace:
    """``indexunary.ss``: ``register_new`` for a function given as Python
    source or a callable (the JAX package's engine-JIT registration)."""

    @staticmethod
    def register_new(name, jit_definition, input_type=None, thunk_type=None,
                     ret_type=None):
        return jit_register("indexunary", name, jit_definition,
                                   input_type, thunk_type, ret_type)

    def __getattr__(self, name):
        raise missing("indexunary.ss", name)


ss = _SSNamespace()


def __getattr__(name):
    raise missing("indexunary", name)


__all__ = ["IndexUnaryOp", "TypedIndexUnaryOp", "register_new",
           "register_anonymous", "from_string", "indexle", "indexgt", "ss",
           *_B]
