"""The public surface of the PyTorch port against the JAX package's.

Operator strings: every form the JAX package parses (``"+"``,
``"plus[FP64]"``, ``"min_plus[FP64]"``, ``"min.+"``, ``"abs[FP64]"``, ...)
gives the same result in the port, exactly (each output value is one
operation of the same operands, in the same type); an unknown name raises
ValueError in both; a name the JAX package knows and the port lacks
raises NotImplementedError naming ROADMAP.md queue 1, item 12.

The name walk: every public name of the JAX package on ``gb``, a Matrix,
a Vector and a Scalar either works in the port or raises
NotImplementedError naming its ROADMAP.md item, and so do the infix
operators.
"""

import pkgutil
import re

import numpy as np
import pytest
import torch

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt

torch.set_num_threads(1)

ITEM = re.compile(r"ROADMAP\.md queue 1, item \d+")


def both(fn):
    """fn(gb) through each package (the port on the CPU)."""
    want = fn(gbj)
    with gbt.config.set(device="cpu"):
        got = fn(gbt)
    return got, want


def mats(gb):
    A = gb.Matrix.from_coo([0, 0, 1, 2, 3], [1, 3, 2, 0, 3],
                           [1.5, -2.0, 3.0, 4.0, -0.5], dtype="FP32",
                           nrows=4, ncols=4)
    B = gb.Matrix.from_coo([0, 1, 1, 3], [1, 0, 2, 3],
                           [2.0, 1.0, -1.5, 3.0], dtype="FP32", nrows=4,
                           ncols=4)
    return A, B


STRING_FORMS = {
    "ewise_add +": lambda A, B: A.ewise_add(B, "+"),
    "ewise_add plus[FP64]": lambda A, B: A.ewise_add(B, "plus[FP64]"),
    "ewise_add min": lambda A, B: A.ewise_add(B, "min"),
    "ewise_add times[int]": lambda A, B: A.ewise_add(B, "times[int]"),
    "ewise_mult *": lambda A, B: A.ewise_mult(B, "*"),
    "ewise_mult -": lambda A, B: A.ewise_mult(B, "-"),
    "ewise_union +": lambda A, B: A.ewise_union(B, "+", 0, 0),
    "mxm min_plus[FP64]": lambda A, B: A.mxm(B, "min_plus[FP64]"),
    "mxm plus_times[FP32]": lambda A, B: A.mxm(B, "plus_times[FP32]"),
    "mxm min.+": lambda A, B: A.mxm(B, "min.+"),
    "mxm max.times": lambda A, B: A.mxm(B, "max.times"),
    "apply abs[FP64]": lambda A, B: A.apply("abs[FP64]"),
    "apply abs": lambda A, B: A.apply("abs"),
    "apply rowindex": lambda A, B: A.apply("rowindex"),
    "apply ==": lambda A, B: A.apply("==", 3.0),
    "apply_bound +": lambda A, B: A.apply(gbt.binary.plus if isinstance(
        A, gbt.Matrix) else gbj.binary.plus, right=1.0),
    "select tril": lambda A, B: A.select("tril"),
    "select <=": lambda A, B: A.select("<=", 1.5),
    "select row<=": lambda A, B: A.select("row<=", 1),
    "reduce_rowwise +": lambda A, B: A.reduce_rowwise("+"),
    "reduce_columnwise max[FP64]": lambda A, B: A.reduce_columnwise(
        "max[FP64]"),
    "reduce_scalar *": lambda A, B: A.reduce_scalar("*"),
}


@pytest.mark.parametrize("form", list(STRING_FORMS))
def test_operator_strings(form):
    got, want = both(lambda gb: STRING_FORMS[form](*mats(gb)).new())
    assert got.dtype.name == want.dtype.name
    if hasattr(want, "to_coo"):
        for g, w in zip(got.to_coo(), want.to_coo()):
            np.testing.assert_array_equal(g, w)
    else:
        assert got.value == want.value


def test_accum_strings():
    def fn(gb):
        A, B = mats(gb)
        C = A.dup()
        C(accum="min") << B
        D = A.dup()
        D(accum="+[FP64]")[[0, 1], [1, 2]] << 5.0
        return C, D

    for got, want in zip(*both(fn)):
        for g, w in zip(got.to_coo(), want.to_coo()):
            np.testing.assert_array_equal(g, w)


UNKNOWN = {
    "ewise_add foo": lambda A, B: A.ewise_add(B, "foo"),
    "ewise_add div": lambda A, B: A.ewise_add(B, "div"),
    "ewise_add plus[": lambda A, B: A.ewise_add(B, "plus[FP64"),
    "mxm foo": lambda A, B: A.mxm(B, "foo"),
    "mxm a.b.c": lambda A, B: A.mxm(B, "min.plus.times"),
    "apply foo": lambda A, B: A.apply("foo"),
    "select foo": lambda A, B: A.select("foo"),
    "reduce foo": lambda A, B: A.reduce_rowwise("foo"),
}


@pytest.mark.parametrize("form", list(UNKNOWN))
def test_unknown_operator_strings(form):
    for gb in (gbj, gbt):
        with gbt.config.set(device="cpu"):
            A, B = mats(gb)
            with pytest.raises(ValueError):
                UNKNOWN[form](A, B)


NOT_PORTED = {
    "apply ainv": lambda A, B: A.apply("ainv"),
    "apply -": lambda A, B: A.apply("-"),
    "ewise_add <": lambda A, B: A.ewise_add(B, "<"),
    "ewise_add logaddexp": lambda A, B: A.ewise_add(B, "logaddexp"),
    "mxm min_lt": lambda A, B: A.mxm(B, "min_lt"),
    "mxm any.eq": lambda A, B: A.mxm(B, "any.=="),
    "reduce ^": lambda A, B: A.reduce_rowwise("^"),
}


@pytest.mark.parametrize("form", list(NOT_PORTED))
def test_not_ported_operator_strings(form):
    """The JAX package takes these; the port names item 12."""
    A, B = mats(gbj)
    NOT_PORTED[form](A, B).new()
    with gbt.config.set(device="cpu"):
        A, B = mats(gbt)
        with pytest.raises(NotImplementedError, match="queue 1, item 12"):
            NOT_PORTED[form](A, B)


# --------------------------------------------------------------------- #
# the public-name walk
def instances(gb):
    A, _ = mats(gb)
    return {"gb": gb, "Matrix": A,
            "Vector": gb.Vector.from_coo([0, 2], [1.0, 2.0], size=3),
            "Scalar": gb.Scalar.from_value(1.5)}


def public_names():
    """Each public name, and on ``gb`` each subpackage too (``dir(gb)``
    lists a subpackage only once something has imported it)."""
    out = []
    for kind, obj in instances(gbj).items():
        names = {n for n in dir(obj) if not n.startswith("_")}
        if kind == "gb":
            names |= {m.name for m in pkgutil.iter_modules(gbj.__path__)}
        out += [(kind, name) for name in sorted(names)]
    return out


@pytest.mark.parametrize("kind", ["gb", "Matrix", "Vector", "Scalar"])
def test_public_names_work_or_name_their_item(kind):
    with gbt.config.set(device="cpu"):
        obj = instances(gbt)[kind]
        names = [n for k, n in public_names() if k == kind]
        assert names
        stubbed = []
        for name in names:
            try:
                getattr(obj, name)
            except NotImplementedError as exc:
                assert ITEM.search(str(exc)), (name, str(exc))
                stubbed.append(name)
        # the stubs are what the port lacks, not what it has
        assert "get" not in stubbed and "clear" not in stubbed


def test_infix_operators_name_their_item():
    with gbt.config.set(device="cpu"):
        A, B = mats(gbt)
        v = gbt.Vector.from_coo([0, 2], [1.0, 2.0], size=4)
        for fn in (lambda: A @ B, lambda: A | B, lambda: A & B,
                   lambda: A.T @ v, lambda: v @ A, lambda: v | v,
                   lambda: v & v, lambda: 2 @ v):
            with pytest.raises(NotImplementedError, match="item 12"):
                fn()


def test_stubs_and_small_ports():
    """The stubs raise on the class too; ``clear``, ``get``, ``replace`` and
    the package's GraphblasException work as in the JAX package."""
    for name in ("from_csr", "from_edgelist", "ss"):
        with pytest.raises(NotImplementedError, match="item 12"):
            getattr(gbt.Matrix, name)
    with gbt.config.set(device="cpu"):
        v = gbt.Vector.from_coo([0, 2], [1.5, 2.0], size=3)
        assert v.reduce(gbt.agg.count).new().value == 2
    with pytest.raises(AttributeError):
        gbt.no_such_name

    def fn(gb):
        A, B = mats(gb)
        C = A.dup()
        C(B.S, gb.replace) << A
        D = A.dup()
        D.clear()
        s = gb.Scalar.from_value(2.0)
        e = gb.Scalar("FP64")
        return C, D, s.get(), e.get(5), issubclass(
            gb.exceptions.DimensionMismatch, gb.GraphblasException)

    got, want = both(fn)
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape
        for a, b in zip(g.to_coo(), w.to_coo()):
            np.testing.assert_array_equal(a, b)
    assert got[2:] == want[2:] == (2.0, 5, True)
