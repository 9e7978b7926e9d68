"""``graphblas_tpu_torch.select``: the builtin select operators, the
index-unary operators that return BOOL (``tril``, ``triu``, ``diag``,
``offdiag``, ``rowle``/``rowgt``, ``colle``/``colgt``, ``valueeq`` ...
``valuele``), the aliases ``indexle`` and ``indexgt``, user select
operators, and the expression forms (graphblas_tpu/select/__init__.py):
``select.value(A > 0.5)`` is ``A.select("valuegt", 0.5)``;
``select.row(A <= 5)``, ``select.column(A < 5)`` and ``select.index(v >=
4)`` read the comparison as one on the row, column or index (``<`` and
``>=`` by ``rowle``/``rowgt`` of the thunk less one)."""

from .core.operator import utils as _utils
from .core.operator.base import missing
from .core.operator.indexunary import SELECT as _B
from .core.operator.indexunary import SelectOp, TypedSelectOp
from .core.ss.jit import jit_register

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
        return jit_register("select", name, jit_definition,
                                   input_type, thunk_type)

    def __getattr__(self, name):
        raise missing("select.ss", name)


ss = _SSNamespace()

_COMPARE_TO_VALUE = {
    "lt": "valuelt", "gt": "valuegt", "le": "valuele", "ge": "valuege",
    "eq": "valueeq", "ne": "valuene", "iseq": "valueeq", "isne": "valuene",
    "islt": "valuelt", "isgt": "valuegt", "isle": "valuele",
    "isge": "valuege",
}
# (select op, thunk offset): x < t on an index is x <= t - 1
_COMPARE_TO_ROW = {"le": ("rowle", 0), "gt": ("rowgt", 0),
                   "lt": ("rowle", -1), "ge": ("rowgt", -1)}
_COMPARE_TO_COL = {"le": ("colle", 0), "gt": ("colgt", 0),
                   "lt": ("colle", -1), "ge": ("colgt", -1)}


def _compared(expr):
    """(parent, op name, thunk) of ``parent <cmp> thunk`` (a bound apply,
    or a Scalar's ewise_mult with a Scalar), else None."""
    from .core.base import BaseExpression

    if not isinstance(expr, BaseExpression):
        return None
    name = getattr(expr.op, "name", None)
    if expr._kind == "apply_bound" and not expr._statics[1]:
        src = expr.args[0]
        return (src.T if expr._statics[2] else src), name, expr._bound
    if expr._kind == "ewise_mult" and expr.args[0]._is_scalar:
        other = expr.args[1]
        return expr.args[0], name, other.value
    return None


def match_expr(parent, expr):
    """(select op, thunk) of ``parent <cmp> thunk``, or None."""
    found = _compared(expr)
    if found is None or found[0] is not parent and not (
            getattr(found[0], "_matrix", None) is parent):
        return None
    sel = _COMPARE_TO_VALUE.get(found[1])
    return None if sel is None else (_B[sel], found[2])


def value(expr):
    """``select.value(A < 5)``: select by a value comparison."""
    found = _compared(expr)
    sel = None if found is None else _COMPARE_TO_VALUE.get(found[1])
    if sel is None:
        raise TypeError("select.value argument must be a comparison "
                        "expression, e.g. A < 5")
    parent, _, thunk = found
    return parent.select(_B[sel], thunk)


def _positional(expr, kind):
    from .core.base import BaseExpression

    if not isinstance(expr, BaseExpression) or \
            expr._kind != "apply_bound":
        raise TypeError(f"select.{kind} argument must be a comparison "
                        f"expression")
    parent, opname, thunk = _compared(expr)
    table = _COMPARE_TO_COL if kind == "column" else _COMPARE_TO_ROW
    if opname not in table:
        raise TypeError(f"Unsupported comparison {opname!r} for "
                        f"select.{kind}")
    sel, shift = table[opname]
    if shift:
        from .core.scalar import Scalar

        if isinstance(thunk, Scalar):
            thunk = thunk.value
        thunk = thunk + shift
    return parent.select(_B[sel], thunk)


def row(expr):
    return _positional(expr, "row")


def column(expr):
    return _positional(expr, "column")


def index(expr):
    return _positional(expr, "index")


def __getattr__(name):
    raise missing("select", name)


__all__ = ["SelectOp", "TypedSelectOp", "register_new", "register_anonymous",
           "from_string", "indexle", "indexgt", "ss", "value", "row",
           "column", "index", *_B]
