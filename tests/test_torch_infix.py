"""The reference's infix cases against the port (the twin of
tests/test_infix.py): ``|``, ``&``, ``@``, operators called on infix
expressions, the BOOL auto-compute, Python arithmetic and comparisons,
run on the CPU with the same inputs and expected values; and every
operator of graphblas_tpu/core/infix.py on each pair of operand kinds
(Matrix, its transpose, Vector, Scalar, a Python scalar) through both
packages: the same expression kind, dtype, shape and computed value, or
the same exception."""

import operator

import numpy as np
import pytest

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt
from tests.test_torch_operator_grids import twin

twin("test_infix", globals())


# --------------------------------------------------------------------- #
# every dunder of graphblas_tpu/core/infix.py through both packages

_BINARY = {"+": operator.add, "-": operator.sub, "*": operator.mul,
           "/": operator.truediv, "//": operator.floordiv,
           "**": operator.pow, "%": operator.mod, "==": operator.eq,
           "!=": operator.ne, "<": operator.lt, "<=": operator.le,
           ">": operator.gt, ">=": operator.ge, "divmod": divmod}
_PAIRS = ("M,M", "M,c", "c,M", "M.T,M", "v,v", "v,c", "c,v", "s,s", "s,c",
          "c,s")


def _operands(gb, dtype):
    vals = {"INT64": [3, -2, 5, 7], "FP64": [1.5, -2.0, 4.0, 0.5],
            "BOOL": [True, False, True, True]}[dtype]
    M = gb.Matrix.from_coo([0, 0, 1, 2], [1, 2, 2, 0], vals, dtype=dtype,
                           nrows=3, ncols=3)
    v = gb.Vector.from_coo([0, 2], vals[:2], dtype=dtype, size=3)
    s = gb.Scalar.from_value(vals[2], dtype=dtype)
    c = {"INT64": 2, "FP64": 2.5, "BOOL": True}[dtype]
    return {"M": M, "M.T": M.T, "v": v, "s": s, "c": c}


def _outcome(fn):
    """(kind, dtype, shape, computed value) of an expression, or the
    exception's type."""
    try:
        e = fn()
    except (TypeError, KeyError, ValueError) as exc:
        return type(exc).__name__
    parts = e if isinstance(e, tuple) else (e,)
    out = []
    for x in parts:
        try:
            kind = (type(x).__name__, getattr(x, "method_name", None),
                    str(x.dtype), tuple(x.shape))
            y = x.new()
        except (TypeError, KeyError, ValueError, AttributeError) as exc:
            out.append((type(x).__name__, type(exc).__name__))
            continue
        val = ([[x if x == x else "nan" for x in
                 np.asarray(a, np.float64).tolist()] for a in y.to_coo()]
               if hasattr(y, "to_coo") else
               (None if y.value is None else float(y.value)))
        out.append((kind, val))
    return out


def _both(fn):
    want = _outcome(lambda: fn(gbj))
    with gbt.config.set(device="cpu"):
        got = _outcome(lambda: fn(gbt))
    return got, want


@pytest.mark.parametrize("dtype", ["INT64", "FP64"])
@pytest.mark.parametrize("op", list(_BINARY))
def test_arithmetic_dunders_match(op, dtype):
    """Each arithmetic and comparison operator on every pair of operand
    kinds gives the JAX package's expression kind, dtype, shape and
    computed value (or its exception)."""
    for pair in _PAIRS:
        left, right = pair.split(",")
        got, want = _both(lambda gb: _BINARY[op](
            _operands(gb, dtype)[left], _operands(gb, dtype)[right]))
        assert got == want, (op, pair)


@pytest.mark.parametrize("op", ["|", "&", "^", "@", "neg", "abs"])
@pytest.mark.parametrize("dtype", ["BOOL", "INT64"])
def test_logical_and_unary_dunders_match(op, dtype):
    fns = {"|": operator.or_, "&": operator.and_, "^": operator.xor,
           "@": operator.matmul}
    for pair in _PAIRS + ("M,v", "v,M", "v,M.T"):
        left, right = pair.split(",")
        if op in fns:
            got, want = _both(lambda gb: fns[op](
                _operands(gb, dtype)[left], _operands(gb, dtype)[right]))
        else:
            if left == "c":
                continue
            f = operator.neg if op == "neg" else abs
            got, want = _both(lambda gb: f(_operands(gb, dtype)[left]))
        assert got == want, (op, pair)


SELECTS = {
    "select.value(M > c)": lambda gb, o: gb.select.value(o["M"] > o["c"]),
    "select.value(M.T >= c)": lambda gb, o: gb.select.value(
        o["M.T"] >= o["c"]),
    "select.value(s < 10)": lambda gb, o: gb.select.value(o["s"] < 10),
    "select.row(M <= 1)": lambda gb, o: gb.select.row(o["M"] <= 1),
    "select.row(M < 1)": lambda gb, o: gb.select.row(o["M"] < 1),
    "select.column(M > 1)": lambda gb, o: gb.select.column(o["M"] > 1),
    "select.column(M >= 1)": lambda gb, o: gb.select.column(o["M"] >= 1),
    "select.index(v < 2)": lambda gb, o: gb.select.index(o["v"] < 2),
    "select.index(v >= 2)": lambda gb, o: gb.select.index(o["v"] >= 2),
    "M.select(M > c)": lambda gb, o: o["M"].select(o["M"] > o["c"]),
    "s.select(s == 5)": lambda gb, o: o["s"].select(o["s"] == 5),
    "M.select(M.T.S)": lambda gb, o: o["M"].select(o["M"].T.new().S),
    "M.select(~M.V)": lambda gb, o: o["M"].select(~o["M"].V),
    "v.select(BOOL v)": lambda gb, o: o["v"].select(
        gb.Vector.from_coo([0, 1, 2], [True, False, True], size=3)),
    "select.valueeq(c, s)": lambda gb, o: gb.select.valueeq(5, o["s"]),
    "indexunary.rowindex(M, 1)": lambda gb, o: gb.indexunary.rowindex(
        o["M"], 1),
}


@pytest.mark.parametrize("dtype", ["INT64", "FP64"])
@pytest.mark.parametrize("case", list(SELECTS))
def test_select_expressions_match(case, dtype):
    """The expression selects (``select.value``/``row``/``column``/
    ``index``), ``select`` by an expression, a mask or a BOOL collection,
    and operators called on collections, against the JAX package."""
    got, want = _both(lambda gb: SELECTS[case](gb, _operands(gb, dtype)))
    assert got == want
