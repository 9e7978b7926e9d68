"""Operator strings (graphblas_tpu/core/operator/utils.py: the string
branch of ``get_typed_op``, ``_from_string`` and the ``*_from_string``
parsers with their symbol tables).

``"+"``, ``"plus[FP64]"``, ``"min_plus[FP64]"``, ``"min.+"``,
``"abs[int]"`` and the aggregators' ``"count"`` and ``"ss.argmin"``
resolve as in the JAX package: a bracketed type gives that typed
operator, whatever the operands' types.  An unknown name raises
ValueError; a name the JAX package knows and the port lacks (its
operators, and the ``numpy`` namespaces) raises NotImplementedError naming
ROADMAP.md queue 1, item 12."""

import importlib
import itertools

from ..dtypes import lookup_dtype
from .base import OpBase, TypedOpBase, not_ported, typed

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

# the names of the JAX package's numpy namespaces (graphblas_tpu/
# {unary,binary,monoid,semiring}/numpy.py), which a bare name also reaches
_NP_BINARY = frozenset((
    "add", "subtract", "multiply", "divide", "logaddexp", "logaddexp2",
    "true_divide", "floor_divide", "power", "float_power", "remainder", "mod",
    "fmod", "gcd", "lcm", "arctan2", "hypot", "bitwise_and", "bitwise_or",
    "bitwise_xor", "left_shift", "right_shift", "greater", "greater_equal",
    "less", "less_equal", "not_equal", "equal", "logical_and", "logical_or",
    "logical_xor", "maximum", "minimum", "fmax", "fmin", "copysign",
    "nextafter", "ldexp"))
_NP_UNARY = frozenset((
    "negative", "abs", "absolute", "cbrt", "fabs", "rint", "sign", "exp",
    "exp2", "log", "log2", "log10", "expm1", "log1p", "positive", "sqrt",
    "square", "reciprocal", "sin", "cos", "tan", "arcsin", "arccos", "arctan",
    "sinh", "cosh", "tanh", "arcsinh", "arccosh", "arctanh", "deg2rad",
    "rad2deg", "degrees", "radians", "bitwise_not", "invert", "logical_not",
    "isfinite", "isinf", "isnan", "signbit", "floor", "ceil", "trunc",
    "spacing"))
_NP_MONOID = frozenset((
    "add", "multiply", "logaddexp", "logaddexp2", "gcd", "hypot",
    "bitwise_and", "bitwise_or", "bitwise_xor", "equal", "logical_and",
    "logical_or", "logical_xor", "maximum", "minimum", "fmax", "fmin"))


def _np_semiring_names():
    """graphblas_tpu/semiring/numpy.py's name set: monoid x binary, less
    the families whose types do not meet."""
    names = {f"{mo}_{mu}" for mo, mu in itertools.product(_NP_MONOID,
                                                          _NP_BINARY)}
    for mos, mus in (
            ({"equal", "hypot", "logaddexp", "logaddexp2"},
             {"gcd", "lcm", "left_shift", "right_shift"}),
            ({"bitwise_and", "bitwise_or", "bitwise_xor", "equal", "gcd"},
             {"arctan2", "copysign", "divide", "float_power", "hypot",
              "ldexp", "logaddexp2", "logaddexp", "nextafter",
              "true_divide"}),
            ({"hypot", "logaddexp", "logaddexp2"},
             {"bitwise_and", "bitwise_or", "bitwise_xor"}),
            ({"equal"}, {"floor_divide", "fmod", "mod", "power",
                         "remainder", "subtract"})):
        names -= {f"{mo}_{mu}" for mo, mu in itertools.product(mos, mus)}
    return frozenset(names)


_NUMPY_NAMES = {"unary": _NP_UNARY, "binary": _NP_BINARY,
                "monoid": _NP_MONOID, "semiring": _np_semiring_names()}


def _resolve(module, path):
    """The operator at a dotted path of a namespace; None where a name is
    absent (AttributeError).  A name the JAX package has and the port
    lacks raises NotImplementedError from the namespace's hook."""
    cur = module
    for part in path.split("."):
        if isinstance(cur, OpBase) or cur is None:
            return None
        try:
            cur = getattr(cur, part)
        except AttributeError:
            return None
    return cur if isinstance(cur, (OpBase, TypedOpBase)) else None


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
    op = _resolve(module, mapping.get(base, base))
    if op is None:
        if base in _NUMPY_NAMES.get(modname, ()):
            raise not_ported(f"{modname}.numpy.{base}", 12)
        raise ValueError(
            f"Unknown {modname} string: {string!r}.  Example usage: "
            f"{example!r}")
    if dtype:
        op = op[dtype]
    return op


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
    # "monoid.binaryop": the ring of both untyped parents, as the JAX
    # package's get_semiring composes it
    mono, mult = (op.parent if isinstance(op, TypedOpBase) else op
                  for op in (monoid_from_string(split[0]),
                             binary_from_string(split[1])))
    return _from_string(f"{mono.name}_{mult.name}", "semiring", {},
                        "min.+[int]")


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
