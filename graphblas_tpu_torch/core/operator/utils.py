"""Operator strings (graphblas_tpu/core/operator/utils.py: the string
branch of ``get_typed_op``, ``_from_string`` and the ``*_from_string``
parsers with their symbol tables).

``"+"``, ``"plus[FP64]"``, ``"min_plus[FP64]"``, ``"min.+"``,
``"abs[int]"`` and the aggregators' ``"count"`` and ``"ss.argmin"``
resolve as in the JAX package, through the namespaces and their
``numpy`` namespaces: a bracketed type gives that typed operator,
whatever the operands' types.  An unknown name raises ValueError.  User
operators land in their namespace through
:func:`register_into_namespace`."""

import importlib
from types import ModuleType

from ..dtypes import lookup_dtype
from .base import OpBase, ParameterizedUdf, TypedOpBase, typed, unparameterized

_str_to_unary = {"-": "ainv", "~": "lnot"}
_str_to_select = {
    "<": "valuelt", ">": "valuegt", "<=": "valuele", ">=": "valuege",
    "!=": "valuene", "==": "valueeq", "col<=": "colle", "col>": "colgt",
    "row<=": "rowle", "row>": "rowgt", "index<=": "indexle",
    "index>": "indexgt",
}
_str_to_binary = {
    "<": "lt", ">": "gt", "<=": "le", ">=": "ge", "!=": "ne", "==": "eq",
    "+": "plus", "-": "minus", "*": "times", "/": "truediv",
    "//": "floordiv", "%": "numpy.mod", "**": "pow", "&": "land", "|": "lor",
    "^": "lxor",
}
_str_to_monoid = {"==": "eq", "+": "plus", "*": "times", "&": "land",
                  "|": "lor", "^": "lxor"}
_str_to_agg = {"+": "sum", "*": "prod", "&": "all", "|": "any"}

class OpPath:
    """A namespace of a dotted operator name (``binary.my.op``)."""

    def __init__(self, parent, name):
        self._parent = parent
        self._name = name


def register_into_namespace(modname, name, op):
    """Make op ``graphblas_tpu_torch.<modname>.<name>`` (a dotted name
    makes OpPath levels), and ``op.<name>`` too for a plain name of the
    unary, binary, monoid and semiring namespaces."""
    module = importlib.import_module(f"graphblas_tpu_torch.{modname}")
    *path, leaf = name.split(".")
    cur = module
    for part in path:
        nxt = vars(cur).get(part) if isinstance(cur, ModuleType) \
            else getattr(cur, part, None)
        if nxt is None:
            nxt = OpPath(cur, part)
            setattr(cur, part, nxt)
        elif not isinstance(nxt, (OpPath, ModuleType)):
            raise AttributeError(f"{part} is already taken in {modname} "
                                 f"namespace")
        cur = nxt
    existing = vars(cur).get(leaf) if isinstance(cur, ModuleType) \
        else getattr(cur, leaf, None)
    if existing is not None and not isinstance(existing,
                                               (OpPath, ModuleType)):
        raise AttributeError(f"{name} is already defined in gb.{modname}")
    setattr(cur, leaf, op)
    if modname in ("unary", "binary", "monoid", "semiring") and not path:
        opmod = importlib.import_module("graphblas_tpu_torch.op")
        if leaf not in vars(opmod):
            setattr(opmod, leaf, op)


def _from_string(string, modname, mapping, example):
    module = importlib.import_module(f"graphblas_tpu_torch.{modname}")
    s = string.lower().strip()
    base, *dtype = s.split("[")
    if len(dtype) > 1:
        raise ValueError(
            f'Bad {modname} string: {string!r}.  Contains too many "[".  '
            f"Example usage: {example!r}")
    if dtype:
        dtype = dtype[0]
        if not dtype.endswith("]"):
            raise ValueError(
                f"Bad {modname} string: {string!r}.  Datatype specification "
                f'does not end with "]".  Example usage: {example!r}')
        dtype = lookup_dtype(dtype[:-1])
    if "]" in base:
        raise ValueError(
            f'Bad {modname} string: {string!r}.  "]" not matched by "[".  '
            f"Example usage: {example!r}")
    # as the JAX package: the symbol table, the namespace, its numpy
    # namespace, then a dotted path
    numpy_ns = getattr(module, "numpy", None)
    if base in mapping:
        op = _walk(module, mapping[base])
    elif hasattr(module, base):
        op = getattr(module, base)
    elif numpy_ns is not None and hasattr(numpy_ns, base):
        op = getattr(numpy_ns, base)
    else:
        op = _walk(module, base)
    if not isinstance(op, (OpBase, TypedOpBase, ParameterizedUdf)):
        raise ValueError(
            f"Unknown {modname} string: {string!r}.  Example usage: "
            f"{example!r}")
    if dtype:
        op = op[dtype]
    return op


def _walk(module, path):
    """The object at a dotted path of a namespace, or None."""
    cur = module
    for part in path.split("."):
        if isinstance(cur, (OpBase, TypedOpBase)):
            return None  # an operator is no namespace
        try:
            cur = getattr(cur, part)
        except AttributeError:
            return None
    return cur


def unary_from_string(string):
    return _from_string(string, "unary", _str_to_unary, "abs[int]")


def indexunary_from_string(string):
    return _from_string(string, "indexunary", _str_to_select, "row_index")


def select_from_string(string):
    return _from_string(string, "select", _str_to_select, "tril")


def binary_from_string(string):
    return _from_string(string, "binary", _str_to_binary, "+[int]")


def monoid_from_string(string):
    return _from_string(string, "monoid", _str_to_monoid, "+[int]")


def semiring_from_string(string):
    split = string.split(".")
    if len(split) == 1:
        try:
            return _from_string(string, "semiring", {}, "min.+[int]")
        except (ValueError, KeyError, TypeError):
            pass
    if len(split) != 2:
        raise ValueError(
            f"Bad semiring string: {string!r}.  The monoid and binaryop "
            f'should be separated by exactly one period, ".".  Example '
            f"usage: min.+[int]")
    from .semiring import get_semiring

    return get_semiring(monoid_from_string(split[0]),
                        binary_from_string(split[1]))


def aggregator_from_string(string):
    return _from_string(string, "agg", _str_to_agg, "sum[int]")


def binary_or_aggregator_from_string(string):
    """The JAX package's ``"binary|aggregator"`` kind: a binary op if the
    string names one, else an aggregator."""
    try:
        return binary_from_string(string)
    except ValueError:
        try:
            return aggregator_from_string(string)
        except ValueError:
            raise ValueError(f"Unknown binary or aggregator string: "
                             f"{string!r}.  Example usage: '+[int]'") from None


_PARSERS = {"UnaryOp": unary_from_string, "BinaryOp": binary_from_string,
            "Monoid": monoid_from_string, "Semiring": semiring_from_string,
            "IndexUnaryOp": indexunary_from_string,
            "SelectOp": select_from_string,
            "Aggregator": aggregator_from_string}


def op_from_string(string, opclass):
    """The operator a string names, parsed as an operator of opclass."""
    return _PARSERS[opclass](string)


def reduce_op(op, dtype):
    """The typed operator a reduce over values of dtype takes: a Monoid,
    or a TypedAggregator.  A BinaryOp (typed, untyped or a string)
    reduces with its monoid, of dtype, as in the JAX package; a string
    parses as a monoid first, then as a binary op or an aggregator."""
    from .agg import Aggregator

    op = unparameterized(op)
    if isinstance(op, str):
        try:
            op = monoid_from_string(op)
        except ValueError:
            op = binary_or_aggregator_from_string(op)
    if isinstance(op, Aggregator):
        return op[dtype]
    if getattr(op, "opclass", None) == "BinaryOp":
        parent = op.parent if isinstance(op, TypedOpBase) else op
        if parent.monoid is None:
            raise TypeError(f"BinaryOp {parent.name} has no corresponding "
                            f"Monoid for reduce")
        return parent.monoid[dtype]
    if getattr(op, "opclass", None) == "Aggregator":
        return op  # a TypedAggregator
    return typed(op, dtype, "Monoid")


# --------------------------------------------------------------------- #
# an operator called on collections and infix expressions
# (graphblas_tpu/core/operator/utils.py _call_op)
def call_op(op, left, right=None, *, left_default=None, right_default=None):
    """``monoid.plus(x | y)``, ``semiring.min_plus(A @ B)``,
    ``binary.minus(x | y, left_default=0, right_default=0)`` (an
    ewise_union), ``binary.plus(A, 1)`` and ``binary.plus(1, A)`` (bound
    applies); an expression operand is computed first."""
    from ..base import BaseExpression, BaseType
    from ..expr import AmbiguousAssignOrExtract, InfixExprBase

    if isinstance(left, (BaseExpression, AmbiguousAssignOrExtract)):
        left = left._get_value()
    if isinstance(right, (BaseExpression, AmbiguousAssignOrExtract)):
        right = right._get_value()
    if right is None and left_default is None and right_default is None:
        if isinstance(left, InfixExprBase):
            return left._apply_op(op)
        raise TypeError(
            f"Bad type when calling {op!r}.\n"
            f"    - Expected an infix expression, such as: {op!r}(x & y)\n"
            f"    - Or a combination of a collection and a scalar, such as: "
            f"{op!r}(x, 1)")
    if left_default is not None or right_default is not None:
        if (left_default is None or right_default is None
                or right is not None or not isinstance(left, InfixExprBase)
                or left.method_name != "ewise_add"):
            raise TypeError(
                f"Bad arguments when calling {op!r}.  Specify both "
                f"left_default and right_default when calling with an "
                f"ewise-union infix expression, e.g.:\n"
                f"    {op!r}(x | y, left_default=0, right_default=0)")
        return left.left.ewise_union(left.right, op, left_default,
                                     right_default)
    if isinstance(left, BaseType) and isinstance(right, BaseType):
        raise TypeError(
            f"Bad types when calling {op!r}.  Got {type(left)} and "
            f"{type(right)}.\n    When calling with two arguments, one must "
            f"be a scalar.")
    if isinstance(left, BaseType):
        return left.apply(op, right=right)
    if isinstance(right, BaseType):
        return right.apply(op, left=left)
    raise TypeError(
        f"Bad types when calling {op!r}.  Got {type(left)} and "
        f"{type(right)}.\n    At least one argument must be a Matrix, "
        f"Vector, or Scalar.")


def call_op_unary(op, val):
    """``unary.abs(A)``: the apply of a collection or an expression."""
    from ..base import BaseExpression, BaseType
    from ..expr import AmbiguousAssignOrExtract, InfixExprBase

    if isinstance(val, (BaseExpression, AmbiguousAssignOrExtract,
                        InfixExprBase)):
        val = val._get_value()
    if isinstance(val, BaseType):
        return val.apply(op)
    raise TypeError(f"Bad type when calling {op!r}: {type(val)}")


def call_expr(op, *args, **kwargs):
    """An operator called on collections: by its class, call_op,
    call_op_unary or call_indexunary."""
    if op.opclass == "UnaryOp":
        return call_op_unary(op, *args, **kwargs)
    if op.opclass in ("IndexUnaryOp", "SelectOp"):
        return call_indexunary(op, *args, **kwargs)
    return call_op(op, *args, **kwargs)


def call_indexunary(op, val, thunk=None):
    """``indexunary.rowindex(A, 1)`` (apply), ``select.tril(A, -1)`` and
    ``select.valueeq(5, s)`` (select: a literal first operand is a
    Scalar)."""
    if thunk is None:
        thunk = False
    if op.opclass == "SelectOp":
        if not hasattr(val, "select"):
            from ..scalar import Scalar

            val = Scalar.from_value(val)
        return val.select(op, thunk)
    if not hasattr(val, "apply"):
        raise TypeError(f"Bad type when calling {op!r}: {type(val)}")
    return val.apply(op, right=thunk)
