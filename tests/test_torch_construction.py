"""The Matrix and Vector constructors and exports against the JAX
package on both backings: from_csr, from_csc, from_dcsr, from_dcsc,
from_edgelist, from_dicts, build (with and without duplicates, clear),
the to_* exports, resize, and Vector's from_pairs, from_dict, build,
resize and outer.  A sparse-backed matrix stays sparse through each."""

import numpy as np
import pytest
import torch

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt

torch.set_num_threads(1)

BACKINGS = {"dense": {}, "sparse": {"auto_sparse_limit": 0}}
RNG = np.random.default_rng(5)
N_R, N_C = 7, 9
R, C = np.nonzero(RNG.random((N_R, N_C)) < 0.3)
V = RNG.integers(-9, 10, len(R)).astype(np.float64)


def csr():
    indptr = np.r_[0, np.cumsum(np.bincount(R, minlength=N_R))]
    return indptr, C, V


def csc():
    order = np.lexsort((R, C))
    return (np.r_[0, np.cumsum(np.bincount(C, minlength=N_C))], R[order],
            V[order])


def doubly(indptr, minor, v):
    counts = np.diff(indptr)
    nz = np.flatnonzero(counts)
    return nz, np.r_[0, np.cumsum(counts[nz])], minor, v


CONSTRUCT = {
    "from_csr": lambda gb: gb.Matrix.from_csr(*csr(), ncols=N_C),
    "from_csc": lambda gb: gb.Matrix.from_csc(*csc(), nrows=N_R),
    "from_dcsr": lambda gb: gb.Matrix.from_dcsr(*doubly(*csr()), nrows=N_R,
                                                ncols=N_C),
    "from_dcsc": lambda gb: gb.Matrix.from_dcsc(*doubly(*csc()), nrows=N_R,
                                                ncols=N_C),
    "from_edgelist": lambda gb: gb.Matrix.from_edgelist(
        np.column_stack([R, C]), V, nrows=N_R, ncols=N_C),
    "from_edgelist 3 columns": lambda gb: gb.Matrix.from_edgelist(
        [(int(r), int(c), float(v)) for r, c, v in zip(R, C, V)],
        nrows=N_R, ncols=N_C),
    "from_dicts": lambda gb: gb.Matrix.from_dicts(
        gb.Matrix.from_coo(R, C, V, nrows=N_R, ncols=N_C).to_dicts(),
        nrows=N_R, ncols=N_C),
    "from_dicts columnwise": lambda gb: gb.Matrix.from_dicts(
        gb.Matrix.from_coo(R, C, V, nrows=N_R, ncols=N_C).to_dicts(
            "columnwise"), order="columnwise", nrows=N_R, ncols=N_C),
    "build dup_op=min": lambda gb: _built(gb, gb.binary.min, False),
    "build dup_op=plus, clear": lambda gb: _built(gb, gb.binary.plus, True),
    "resize down": lambda gb: _resized(gb, (4, 5)),
    "resize up": lambda gb: _resized(gb, (9, 12)),
    "resize down and back": lambda gb: _resized(gb, (4, 5), (N_R, N_C)),
}


def _built(gb, op, clear):
    A = gb.Matrix(gb.dtypes.FP64, N_R, N_C)
    if clear:
        A[0, 0] = 100.0
    dup = np.arange(0, len(R), 3)
    A.build(np.r_[R, R[dup]], np.r_[C, C[dup]], np.r_[V, V[dup] * 2 + 1],
            dup_op=op, clear=clear)
    return A


def _resized(gb, *shapes):
    A = gb.Matrix.from_coo(R, C, V, nrows=N_R, ncols=N_C)
    for shape in shapes:
        A.resize(*shape)
    return A


def coo(M):
    return M.shape, [np.asarray(a).tolist() for a in M.to_coo()]


@pytest.mark.parametrize("backing", list(BACKINGS))
@pytest.mark.parametrize("case", list(CONSTRUCT))
def test_constructors(case, backing):
    with gbj.config.set(**BACKINGS[backing]):
        want = coo(CONSTRUCT[case](gbj))
    with gbt.config.set(device="cpu", **BACKINGS[backing]):
        M = CONSTRUCT[case](gbt)
        assert (M._sparse is not None) == (backing == "sparse")
        assert coo(M) == want


EXPORTS = ("to_csr", "to_csc", "to_dcsr", "to_dcsc", "to_edgelist")


@pytest.mark.parametrize("backing", list(BACKINGS))
@pytest.mark.parametrize("export", EXPORTS)
def test_exports(export, backing):
    def fn(gb):
        A = gb.Matrix.from_coo(R, C, V, nrows=N_R, ncols=N_C)
        return [np.asarray(a).tolist() for a in getattr(A, export)()]

    with gbj.config.set(**BACKINGS[backing]):
        want = fn(gbj)
    with gbt.config.set(device="cpu", **BACKINGS[backing]):
        assert fn(gbt) == want


def test_build_errors():
    for gb, cfg in ((gbj, {}), (gbt, {"device": "cpu"})):
        with gbt.config.set(**cfg):
            A = gb.Matrix.from_coo([0], [1], [1.0], nrows=2, ncols=2)
            with pytest.raises(gb.exceptions.OutputNotEmpty):
                A.build([1], [1], [2.0])
            with pytest.raises(gb.exceptions.IndexOutOfBound):
                A.build([5], [1], [2.0], clear=True)
            with pytest.raises(ValueError):
                A.build([0, 1], [1], [2.0], clear=True)
            with pytest.raises(TypeError):
                A.build([0], [1], [2.0], clear=True, nrows=4)
            with pytest.raises(gb.exceptions.InvalidValue):
                A.build([0, 0], [1, 1], [2.0, 3.0], clear=True)
            v = gb.Vector.from_coo([0], [1.0], size=3)
            with pytest.raises(gb.exceptions.OutputNotEmpty):
                v.build([1], [2.0])
            with pytest.raises(TypeError):
                v.build([1], [2.0], clear=True, size=5)


VECTOR = {
    "from_pairs": lambda gb: gb.Vector.from_pairs([(3, 1.5), (0, -2.0)],
                                                  size=5),
    "from_dict": lambda gb: gb.Vector.from_dict({4: 2, 1: 7}),
    "build dup_op=max": lambda gb: _vbuilt(gb),
    "resize": lambda gb: _vresized(gb),
    "outer": lambda gb: gb.Vector.from_coo([0, 2], [2.0, 3.0], size=4).outer(
        gb.Vector.from_coo([1, 4], [5.0, -1.0], size=6)).new(),
    "outer minus": lambda gb: gb.Vector.from_coo([1, 2], [2, 3], size=3)
    .outer(gb.Vector.from_coo([0], [10], size=2), gb.binary.minus).new(),
    "outer monoid": lambda gb: gb.Vector.from_coo([0], [True], size=2)
    .outer(gb.Vector.from_coo([0, 1], [True, False], size=2),
           gb.monoid.lor).new(),
}


def _vbuilt(gb):
    v = gb.Vector(gb.dtypes.INT64, 6)
    v.build([4, 1, 4, 0, 4], [1, 2, 9, 3, -5], dup_op=gb.binary.max)
    return v


def _vresized(gb):
    v = gb.Vector.from_coo([0, 3, 5], [1, 2, 3], size=6)
    v.resize(4)
    v.resize(8)
    return v


@pytest.mark.parametrize("backing", list(BACKINGS))
@pytest.mark.parametrize("case", list(VECTOR))
def test_vector_constructors(case, backing):
    def fn(gb):
        x = VECTOR[case](gb)
        return (type(x).__name__, str(x.dtype), x.shape,
                [np.asarray(a).tolist() for a in x.to_coo()])

    with gbj.config.set(**BACKINGS[backing]):
        want = fn(gbj)
    with gbt.config.set(device="cpu", **BACKINGS[backing]):
        assert fn(gbt) == want


def test_outer_large_is_sparse():
    """An outer product over auto_sparse_limit elements is a sparse store
    with the product of the two structures."""
    with gbt.config.set(device="cpu", auto_sparse_limit=1 << 10):
        a = gbt.Vector.from_coo([3, 70], [2.0, -1.0], size=100)
        b = gbt.Vector.from_coo([0, 5, 99], [1.0, 4.0, 0.5], size=100)
        M = a.outer(b).new()
        assert M._sparse is not None
        r, c, v = M.to_coo()
    np.testing.assert_array_equal(r, [3, 3, 3, 70, 70, 70])
    np.testing.assert_array_equal(c, [0, 5, 99, 0, 5, 99])
    np.testing.assert_array_equal(v, [2.0, 8.0, 1.0, -1.0, -4.0, -0.5])
