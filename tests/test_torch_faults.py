"""Three faults of the port, each against the JAX package on the CPU.

1. A reduce by a BinaryOp (typed, untyped or its name) reduces with the
   op's monoid, in all four forms (rowwise, columnwise, ``reduce_scalar``,
   ``Vector.reduce``) and through ``A.T``; a BinaryOp without a monoid
   raises TypeError.
2. Duplicate indices without a ``dup_op`` raise ``InvalidValue``, a
   GraphblasException (and not a ValueError), for Matrix and Vector on
   both backings; the port has the JAX package's 17 exception classes.
3. ``Scalar.value`` is a numpy scalar of the dtype, as in the JAX
   package, for reduces, extracted elements and ``get``; ``repr`` shows
   that value.
4. ``==``, ``!=``, ``<``, ``<=``, ``>``, ``>=`` build the JAX package's
   comparison expressions (two collections: an ``ewise_mult``; a
   collection and a scalar: a bound ``apply``; two Scalars: a Scalar
   ``ewise_mult``), whose truth is the computed comparison's:
   ``bool(A.reduce_scalar() == 6)`` is True.  Python compared identities
   before.
5. ``bool(A)`` and ``np.asarray(A)`` raise TypeError for Matrix and
   Vector; a Scalar converts with ``bool``, ``int``, ``float``,
   ``complex``, ``operator.index`` and ``np.asarray`` as in the JAX
   package.
6. A Scalar is unhashable; collections keep identity hashing.
7. ``==`` and ``bool()`` on a mask raise TypeError.
8. What raised the wrong exception: ``float(s)``, ``int(s)``,
   ``s.value = 4``, ``A.S & B.S``, ``v.S | v.V``, ``A + B``, ``A < 1``,
   ``-A``, ``abs(A)``, ``A.S.dtype`` and ``A.S.new()`` compute what the JAX
   package computes.
"""

import operator

import numpy as np
import pytest
import torch

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt

torch.set_num_threads(1)

BACKINGS = {"dense": {}, "sparse": {"auto_sparse_limit": 0}}


def operands(gb, dtype):
    A = gb.Matrix.from_coo([0, 0, 1, 3, 3], [1, 3, 2, 0, 3],
                           np.array([1.5, 2.0, 3.0, 4.0, 0.5]).astype(
                               gbt.dtypes.lookup_dtype(dtype).np_type),
                           dtype=dtype, nrows=4, ncols=5)
    v = gb.Vector.from_coo([1, 2, 4], np.array([2.5, 1.0, 3.0]).astype(
        gbt.dtypes.lookup_dtype(dtype).np_type), dtype=dtype, size=6)
    return A, v


REDUCES = {
    "rowwise": lambda A, v, op: A.reduce_rowwise(op),
    "columnwise": lambda A, v, op: A.reduce_columnwise(op),
    "A.T rowwise": lambda A, v, op: A.T.reduce_rowwise(op),
    "scalar": lambda A, v, op: A.reduce_scalar(op),
    "vector": lambda A, v, op: v.reduce(op),
}


def result(x):
    x = x.new()
    if hasattr(x, "to_coo"):
        return x.dtype.name, [a.tolist() for a in x.to_coo()]
    return x.dtype.name, x.value


@pytest.mark.parametrize("backing", list(BACKINGS))
@pytest.mark.parametrize("dtype", ["FP32", "INT64", "BOOL"])
def test_reduce_by_a_binary_op(backing, dtype):
    ops = {"untyped": lambda gb: gb.binary.max,
           "typed": lambda gb: gb.binary.min[dtype],
           "string": lambda gb: "max",
           "times": lambda gb: gb.binary.times}
    jA, jv = operands(gbj, dtype)
    with gbt.config.set(device="cpu", **BACKINGS[backing]):
        tA, tv = operands(gbt, dtype)
        for name, op in ops.items():
            for form, fn in REDUCES.items():
                want = result(fn(jA, jv, op(gbj)))
                got = result(fn(tA, tv, op(gbt)))
                assert got == want, (name, form)
        for gb, A, v in ((gbj, jA, jv), (gbt, tA, tv)):
            for form, fn in REDUCES.items():
                with pytest.raises(TypeError, match="BinaryOp minus has no "
                                   "corresponding Monoid for reduce"):
                    fn(A, v, gb.binary.minus)


@pytest.mark.parametrize("backing", list(BACKINGS))
def test_duplicates_raise_invalid_value(backing):
    for gb in (gbj, gbt):
        with gb.config.set(**BACKINGS[backing]), \
                gbt.config.set(device="cpu"):
            with pytest.raises(gb.exceptions.InvalidValue, match="dup_op"):
                gb.Matrix.from_coo([0, 0, 1], [1, 1, 2], [2, 3, 4])
            with pytest.raises(gb.exceptions.InvalidValue, match="dup_op"):
                gb.Vector.from_coo([1, 1], [2, 3], size=3)
            try:
                gb.Matrix.from_coo([0, 0], [1, 1], [2, 3])
            except Exception as exc:  # noqa: BLE001 - its kind is checked
                assert isinstance(exc, gb.GraphblasException)
                assert not isinstance(exc, ValueError)
            A = gb.Matrix.from_coo([0, 0, 1], [1, 1, 2], [2, 3, 4],
                                   dup_op=gb.binary.plus)
            assert A.nvals == 2
    assert issubclass(gbt.exceptions.InvalidValue,
                      gbt.exceptions.GraphblasException)


def test_the_exception_classes():
    names = sorted(n for n, c in vars(gbj.exceptions).items()
                   if isinstance(c, type) and issubclass(c, Exception))
    assert len(names) == 17
    assert sorted(gbt.exceptions.__all__) == names
    for name in names:
        t, j = getattr(gbt.exceptions, name), getattr(gbj.exceptions, name)
        assert [b.__name__ for b in j.__mro__ if b.__module__ ==
                j.__module__] == [b.__name__ for b in t.__mro__ if
                                  b.__module__ == t.__module__]


@pytest.mark.parametrize("dtype", ["FP32", "FP64", "INT64", "BOOL", "INT32",
                                   "UINT32"])
def test_scalar_value_is_a_numpy_scalar(dtype):
    monoid = "lor" if dtype == "BOOL" else "plus"
    got, want = [], []
    for gb, out in ((gbj, want), (gbt, got)):
        with gbt.config.set(device="cpu"):
            A, v = operands(gb, dtype)
            m = getattr(gb.monoid, monoid)
            out += [v.reduce(m).new().value, A.reduce_scalar(m).new().value,
                    v[1].new().value, A[0, 1].new().value,
                    v.reduce(m).new().get(),
                    gb.Scalar.from_value(1, dtype).value]
    for g, w in zip(got, want):
        assert type(g) is type(w), (dtype, g, w)
        assert g == w
    with gbt.config.set(device="cpu"):
        s = gbt.Scalar.from_value(0.1, "FP32")
        assert s.value == np.float32(0.1)
        assert repr(s) == repr(gbj.Scalar.from_value(0.1, "FP32")) == \
            "gb.Scalar\nvalue: 0.1\ndtype: FP32"
        assert repr(gbt.Scalar.from_value(3, "INT64")) == \
            repr(gbj.Scalar.from_value(3, "INT64"))
        assert repr(gbt.Scalar("BOOL")) == repr(gbj.Scalar("BOOL")) == \
            "gb.Scalar\nvalue: (empty)\ndtype: BOOL"
        assert gbt.Scalar("FP64").get(7) == 7


# --------------------------------------------------------------------- #
# 4-8: equality, truth, conversion, hashing and masks
def infix_operands(gb):
    A = gb.Matrix.from_coo([0, 0, 1, 2], [1, 2, 2, 0], [1.0, 2.0, 3.0, 0.0],
                           nrows=3, ncols=3)
    B = gb.Matrix.from_coo([0, 1, 2, 2], [1, 2, 0, 2], [1.0, 5.0, 0.0, 4.0],
                           nrows=3, ncols=3)
    v = gb.Vector.from_coo([0, 2], [3.0, 1.0], size=3)
    return A, B, v


def computed(x):
    """What an expression computes, or a Python value as it is."""
    if hasattr(x, "new"):
        x = x.new()
    if hasattr(x, "to_coo"):
        return x.dtype.name, [a.tolist() for a in x.to_coo()]
    if hasattr(x, "value"):
        return x.dtype.name, None if x.value is None else x.value.item()
    return x


COMPARISONS = {
    "reduce_scalar == 6": lambda A, B, v: A.reduce_scalar() == 6,
    "Scalar == 3": lambda A, B, v: v.reduce().new() == 4,
    "Scalar != 3": lambda A, B, v: v.reduce().new() != 3,
    "3 < Scalar": lambda A, B, v: 3 < v.reduce().new(),
    "Scalar == Scalar": lambda A, B, v: (v.reduce().new()
                                         == A.reduce_scalar().new()),
    "A == B": lambda A, B, v: A == B,
    "A != B": lambda A, B, v: A != B,
    "A.T == A.T": lambda A, B, v: A.T == A.T,
    "A < B": lambda A, B, v: A < B,
    "A >= 1": lambda A, B, v: A >= 1,
    "v <= 1": lambda A, B, v: v <= 1,
    "ewise_mult == v": lambda A, B, v: v.ewise_mult(v) == v,
    "v[0] == 3": lambda A, B, v: v[0] == 3.0,
}


@pytest.mark.parametrize("backing", list(BACKINGS))
@pytest.mark.parametrize("case", list(COMPARISONS))
def test_comparisons_are_expressions(backing, case):
    def fn(gb):
        e = COMPARISONS[case](*infix_operands(gb))
        kind = (type(e).__name__, getattr(e, "method_name", None),
                str(e.dtype), tuple(e.shape))
        truth = bool(e) if e.ndim == 0 else None
        return kind, truth, computed(e)

    want = fn(gbj)
    with gbt.config.set(device="cpu", **BACKINGS[backing]):
        got = fn(gbt)
    assert got == want
    if case in ("reduce_scalar == 6", "Scalar == 3", "v[0] == 3"):
        assert got[1] is True


@pytest.mark.parametrize("kind", ["Matrix", "Vector"])
def test_no_truth_or_array_of_collections(kind):
    for gb, cfg in ((gbj, {}), (gbt, {"device": "cpu"})):
        with gbt.config.set(**cfg):
            A, _, v = infix_operands(gb)
            x = A if kind == "Matrix" else v
            with pytest.raises(TypeError, match="__bool__"):
                bool(x)
            with pytest.raises(TypeError, match="numpy array"):
                np.asarray(x)


@pytest.mark.parametrize("value", [5, 2.5, 0, True, -3])
def test_scalar_conversions(value):
    def fn(gb):
        s = gb.Scalar.from_value(value)
        out = [bool(s), int(s), float(s), complex(s),
               np.asarray(s).dtype.name, np.asarray(s).item()]
        try:
            out.append(operator.index(s))
        except TypeError:
            out.append("TypeError")
        e = gb.Scalar(s.dtype)
        out.append(bool(e))
        try:
            float(e)
        except TypeError:
            out.append("TypeError")
        return out

    want = fn(gbj)
    with gbt.config.set(device="cpu"):
        assert fn(gbt) == want


def test_scalar_unhashable_collections_hashable():
    for gb, cfg in ((gbj, {}), (gbt, {"device": "cpu"})):
        with gbt.config.set(**cfg):
            A, _, v = infix_operands(gb)
            s = A.reduce_scalar().new()
            with pytest.raises(TypeError, match="unhashable"):
                hash(s)
            assert {A: 1, v: 2, A.T: 3}[v] == 2
            assert hash(A) == hash(A)


def test_mask_equality_and_truth():
    for gb, cfg in ((gbj, {}), (gbt, {"device": "cpu"})):
        with gbt.config.set(**cfg):
            A, _, v = infix_operands(gb)
            for m in (v.S, ~v.V, A.S, ~A.V):
                with pytest.raises(TypeError, match="__eq__"):
                    m == m  # noqa: B015
                with pytest.raises(TypeError, match="__bool__"):
                    bool(m)


WRONG_EXCEPTIONS = {
    "float(s)": lambda A, B, v: float(A.reduce_scalar().new()),
    "int(s)": lambda A, B, v: int(A.reduce_scalar().new()),
    "s.value = 4": lambda A, B, v: _set_value(A.reduce_scalar().new(), 4),
    "A.S & B.S": lambda A, B, v: (A.S & B.S).new(),
    "v.S | v.V": lambda A, B, v: (v.S | v.V).new(),
    "A + B": lambda A, B, v: A + B,
    "A < 1": lambda A, B, v: A < 1,
    "-A": lambda A, B, v: -A,
    "abs(A)": lambda A, B, v: abs(-A),
    "A.S.dtype": lambda A, B, v: str(A.S.dtype),
    "A.S.new()": lambda A, B, v: A.S.new(),
}


def _set_value(s, x):
    s.value = x
    return s


@pytest.mark.parametrize("case", list(WRONG_EXCEPTIONS))
def test_calls_that_raised_the_wrong_exception(case):
    def fn(gb):
        return computed(WRONG_EXCEPTIONS[case](*infix_operands(gb)))

    want = fn(gbj)
    with gbt.config.set(device="cpu"):
        assert fn(gbt) == want
