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
"""

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
        assert repr(s) == "Scalar(0.1, dtype=FP32)"
        assert repr(gbt.Scalar.from_value(3, "INT64")) == \
            "Scalar(3, dtype=INT64)"
        assert repr(gbt.Scalar("BOOL")) == "Scalar(None, dtype=BOOL)"
        assert gbt.Scalar("FP64").get(7) == 7
