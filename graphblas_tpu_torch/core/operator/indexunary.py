"""Index-unary and select operators: f(value, row, col, thunk)
(graphblas_tpu/core/operator/{indexunary,select}.py).

The structural operators (``tril``, ``triu``, ``diag``, ``offdiag``,
``rowle``/``rowgt``, ``colle``/``colgt``, and the index-valued
``rowindex``, ``colindex``, ``diagindex``) read only the position and take
the thunk as INT64; the value comparisons (``valueeq`` ... ``valuele``)
compare the value, cast to the operator's type, with the thunk.  A
SelectOp is an IndexUnaryOp that returns BOOL; the select namespace holds
those."""

from .. import dtypes as _dt
from .base import OpBase, TypedOpBase

def _index_only(fn):
    def op(x, i, j, t):
        return fn(i, j, t.to(i.dtype))

    return op


def _value_only(fn):
    def op(x, i, j, t):
        return fn(x, t)

    return op


# name -> (func, return type: a DataType, or None for INT64 index values)
_BUILTIN = {
    "rowindex": (_index_only(lambda i, j, t: i + t), None),
    "colindex": (_index_only(lambda i, j, t: j + t), None),
    "diagindex": (_index_only(lambda i, j, t: j - i + t), None),
    "tril": (_index_only(lambda i, j, t: j <= i + t), _dt.BOOL),
    "triu": (_index_only(lambda i, j, t: j >= i + t), _dt.BOOL),
    "diag": (_index_only(lambda i, j, t: j == i + t), _dt.BOOL),
    "offdiag": (_index_only(lambda i, j, t: j != i + t), _dt.BOOL),
    "colle": (_index_only(lambda i, j, t: j <= t), _dt.BOOL),
    "colgt": (_index_only(lambda i, j, t: j > t), _dt.BOOL),
    "rowle": (_index_only(lambda i, j, t: i <= t), _dt.BOOL),
    "rowgt": (_index_only(lambda i, j, t: i > t), _dt.BOOL),
    "valueeq": (_value_only(lambda v, t: v == t), _dt.BOOL),
    "valuene": (_value_only(lambda v, t: v != t), _dt.BOOL),
    "valuegt": (_value_only(lambda v, t: v > t), _dt.BOOL),
    "valuege": (_value_only(lambda v, t: v >= t), _dt.BOOL),
    "valuelt": (_value_only(lambda v, t: v < t), _dt.BOOL),
    "valuele": (_value_only(lambda v, t: v <= t), _dt.BOOL),
}
_POSITIONAL = frozenset(("rowindex", "colindex", "diagindex", "tril", "triu",
                         "diag", "offdiag", "colle", "colgt", "rowle",
                         "rowgt"))


class TypedIndexUnaryOp(TypedOpBase):
    opclass = "IndexUnaryOp"

    def __init__(self, parent, name, type_, return_type, func):
        super().__init__(parent, name, type_, return_type)
        self.func = func
        self._positional = parent._positional

    def __call__(self, x, i, j, thunk):
        """Apply to storage tensors: values of self.type, int64 rows and
        cols, a 0-d thunk; the result in return_type, shaped like x."""
        out = self.func(x, i, j, thunk)
        return _dt.normalize(out.expand(x.shape), self.return_type)


class TypedSelectOp(TypedIndexUnaryOp):
    opclass = "SelectOp"


class IndexUnaryOp(OpBase):
    opclass = "IndexUnaryOp"
    _typed_class = TypedIndexUnaryOp

    def __init__(self, name, func, return_type):
        super().__init__(name)
        self._func = func
        self._return_type = return_type
        self._positional = name if name in _POSITIONAL else None

    def _build_typed(self, dt):
        ret = _dt.INT64 if self._return_type is None else self._return_type
        return self._typed_class(self, self.name, dt, ret, self._func)


class SelectOp(IndexUnaryOp):
    opclass = "SelectOp"
    _typed_class = TypedSelectOp


INDEXUNARY = {name: IndexUnaryOp(name, fn, ret)
              for name, (fn, ret) in _BUILTIN.items()}
SELECT = {name: SelectOp(name, fn, ret)
          for name, (fn, ret) in _BUILTIN.items() if ret is _dt.BOOL}
