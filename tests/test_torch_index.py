"""Extract, assign, subassign and delete by index, ``input_mask``,
membership, iteration and ``get``: the PyTorch port against the JAX
package on the CPU.

Each scenario is one function of the package module ``gb``; it runs
through both packages on the same numpy inputs (from a seed) and returns
its results, which must agree exactly: type, structure and values (every
value is a copy, a cast or one accumulate of the same two operands), or
the name of the error raised.  The scenarios follow tests/test_extract.py,
tests/test_assign.py and tests/test_vector_assign.py, over FP32, FP64,
INT64 and BOOL, on dense-backed collections (the default) and on
sparse-backed ones (``auto_sparse_limit=0``), with and without mask, accum
and replace, and with index lists that repeat and that do not.  Index
lists that repeat are assigned scalars only (which element of a repeated
index lands is unspecified in both packages).
"""

import numpy as np
import pytest
import torch

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt

torch.set_num_threads(1)

NR, NC, NV = 12, 10, 12
DTYPES = ("FP32", "FP64", "INT64", "BOOL")
BACKINGS = ("dense", "sparse")
ROWS_U = [7, 1, 4, 10]  # duplicate-free, out of order
COLS_U = [2, 9, 0]
ROWS_S = [1, 3, 8]  # duplicate-free, increasing
COLS_S = [0, 4, 5, 9]
ROWS_D = [2, 2, 5, 0]  # with a repeat
COLS_D = [3, 6, 3]
SCALAR = {"FP32": 2.5, "FP64": -1.25, "INT64": 7, "BOOL": True}


def np_type(dtype):
    return gbt.dtypes.lookup_dtype(dtype).np_type


def values(rng, n, dtype):
    if dtype == "BOOL":
        return rng.random(n) < 0.6
    if dtype == "INT64":
        return rng.integers(-5, 6, n).astype(np.int64)
    return (rng.integers(-8, 9, n) * 0.5).astype(np_type(dtype))


def coo(seed, shape, dtype, density=0.35):
    rng = np.random.default_rng(seed)
    r, c = np.nonzero(rng.random(shape) < density)
    return r, c, values(rng, len(r), dtype)


def accum(gb, dtype):
    return gb.binary.lor if dtype == "BOOL" else gb.binary.plus


class Env:
    """The inputs of one scenario, built in one package."""

    def __init__(self, gb, dtype):
        self.gb, self.dt = gb, dtype

    def mat(self, seed=1, shape=(NR, NC), dtype=None, density=0.35):
        dt = dtype or self.dt
        r, c, v = coo(seed, shape, dt, density)
        return self.gb.Matrix.from_coo(r, c, v, dtype=dt, nrows=shape[0],
                                       ncols=shape[1])

    def vec(self, seed=2, size=NV, dtype=None, density=0.5):
        dt = dtype or self.dt
        rng = np.random.default_rng(seed)
        idx = np.nonzero(rng.random(size) < density)[0]
        return self.gb.Vector.from_coo(idx, values(rng, len(idx), dt),
                                       dtype=dt, size=size)

    def mask(self, seed, shape):
        """A BOOL mask parent whose values are not all True."""
        if len(shape) == 1:
            return self.vec(seed, shape[0], "BOOL", 0.6)
        return self.mat(seed, shape, "BOOL", 0.5)


def error(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 -- the class is the result
        return type(exc).__name__
    return "no error"


def run(scenario, backing, *args):
    sparse = backing == "sparse"
    limit = {"auto_sparse_limit": 0} if sparse else {}
    with gbj.config.set(**limit):
        want = scenario(Env(gbj, *args[:1]), *args[1:])
    with gbt.config.set(device="cpu", **limit):
        got = scenario(Env(gbt, *args[:1]), *args[1:])
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        if hasattr(w, "to_coo"):
            assert g.dtype.name == w.dtype.name, k
            assert g.shape == w.shape, k
            for a, b in zip(g.to_coo(), w.to_coo()):
                np.testing.assert_array_equal(a, b, err_msg=str(k))
        else:
            assert g == w, (k, g, w)
    return got


# --------------------------------------------------------------------- #
# extract
def sc_extract(e):
    out = []
    for rows, cols in ((ROWS_U, COLS_U), (ROWS_S, COLS_S), (ROWS_U, COLS_S),
                       (slice(2, 11, 3), slice(None, None, -1)),
                       ([-1, -3], [0, -1]), (np.array([], np.int64), COLS_U),
                       (ROWS_D, COLS_D)):
        out.append(e.mat()[rows, cols].new())  # a new A: a repeat densifies
    A = e.mat()
    out += [A[3, :].new(), A[:, 4].new(), A[3, COLS_D].new(),
            A[ROWS_U, 4].new(), A[-1, ::2].new(), A.T[COLS_U, 2].new(),
            A[ROWS_S, COLS_S].new(e.dt if e.dt == "BOOL" else "FP64")]
    out += [A[i, j].new().value for i, j in ((0, 0), (7, 2), (-1, -1))]
    return out


@pytest.mark.parametrize("backing", BACKINGS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_extract(dtype, backing):
    got = run(sc_extract, backing, dtype)
    if backing == "sparse":  # duplicate-free lists stay sparse
        assert got[0]._sparse is not None and got[1]._sparse is not None


def sc_extract_vector(e):
    v = e.vec()
    out = [v[idx].new() for idx in (ROWS_U, ROWS_S, ROWS_D, slice(None, None,
                                                                  -2), np.array([], np.int64))]
    w = e.vec(5)
    w(accum=accum(e.gb, e.dt)) << v[list(range(NV - 1, -1, -1))]
    return out + [w, v[3].new().value, v[-2].new().value]


@pytest.mark.parametrize("dtype", DTYPES)
def test_extract_vector(dtype):
    run(sc_extract_vector, "dense", dtype)


def sc_extract_into(e, kind):
    """C(mask, accum, replace) << A[rows, cols] and the input mask."""
    A = e.mat()
    shape = (len(ROWS_U), len(COLS_U))
    C = e.mat(3, shape)
    M = e.mask(4, shape)
    if kind == "mask":
        C(M.S) << A[ROWS_U, COLS_U]
    elif kind == "accum_replace":
        C(~M.V, accum(e.gb, e.dt), replace=True) << A[ROWS_U, COLS_U]
    else:  # input_mask
        IM = e.mask(6, (NR, NC))
        m = e.mask(7, (NC,))
        out = [A[ROWS_S, COLS_S].new(input_mask=IM.S),
               A[ROWS_D, COLS_S].new(input_mask=IM.V),
               A[3, COLS_U].new(input_mask=m.S),
               A[ROWS_U, 2].new(input_mask=e.mask(8, (NR,)).V)]
        w = e.vec(5, len(COLS_U))
        w(input_mask=IM.S) << A[5, COLS_U]
        return out + [w]
    return [C]


@pytest.mark.parametrize("kind", ["mask", "accum_replace", "input_mask"])
@pytest.mark.parametrize("backing", BACKINGS)
@pytest.mark.parametrize("dtype", ["FP32", "INT64"])
def test_extract_into(dtype, backing, kind):
    run(sc_extract_into, backing, dtype, kind)


# --------------------------------------------------------------------- #
# assign and subassign into a Matrix
def M_S(M):
    return M.S


def M_V(M):
    return M.V


def M_NV(M):
    return ~M.V


def sc_assign(e, value_kind):
    gb, dt = e.gb, e.dt
    out = []
    if value_kind == "scalar":
        regions = ((ROWS_U, COLS_U), (ROWS_D, COLS_D))  # a repeat: scalars
        combos = ((None, None, False), (M_S, True, False), (M_NV, True, True),
                  (M_V, None, True))
    else:
        regions = ((ROWS_S, COLS_S), (ROWS_U, COLS_U))
        combos = ((None, None, False), (M_S, True, False), (M_NV, True, True))
    for k, (rows, cols) in enumerate(regions):
        val = SCALAR[dt] if value_kind == "scalar" else \
            e.mat(10 + k, (len(rows), len(cols)))
        M = e.mask(20 + k, (NR, NC))
        for mask_of, acc, replace in combos:
            C = e.mat()
            C(mask=None if mask_of is None else mask_of(M),
              accum=accum(gb, dt) if acc else None,
              replace=replace)[rows, cols] << val
            out.append(C)
    C = e.mat()
    C[ROWS_U, COLS_U] = gb.Scalar(dt)  # an empty Scalar deletes
    C[2, 3] = SCALAR[dt]
    C[:, 7] = SCALAR[dt]
    return out + [C]


@pytest.mark.parametrize("value_kind", ["scalar", "matrix"])
@pytest.mark.parametrize("backing", BACKINGS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_assign(dtype, backing, value_kind):
    got = run(sc_assign, backing, dtype, value_kind)
    if backing == "sparse":
        assert all(C._sparse is not None for C in got[:3])


def sc_subassign(e):
    gb, dt = e.gb, e.dt
    out = []
    for k, (rows, cols) in enumerate(((ROWS_U, COLS_U), (ROWS_S, COLS_S))):
        shape = (len(rows), len(cols))
        m = e.mask(30 + k, shape)
        for val, mask, acc, replace in (
                (SCALAR[dt], m.S, None, False),
                (SCALAR[dt], ~m.S, None, True),
                (e.mat(40 + k, shape), m.V, accum(gb, dt), True)):
            C = e.mat()
            C[rows, cols](mask=mask, accum=acc, replace=replace) << val
            out.append(C)
    # a row and a column with a Vector submask
    v = e.vec(50, NC)
    C = e.mat()
    C[4, :](e.mask(51, (NC,)).V, replace=True) << v
    out.append(C)
    C = e.mat()
    C[ROWS_U, 6](~e.mask(52, (len(ROWS_U),)).S) << SCALAR[dt]
    out.append(C)
    return out


@pytest.mark.parametrize("backing", BACKINGS)
@pytest.mark.parametrize("dtype", ["FP32", "BOOL"])
def test_subassign(dtype, backing):
    run(sc_subassign, backing, dtype)


def sc_assign_row_col(e):
    """A Vector into a row or a column, with a Vector mask (GrB_Row_assign,
    GrB_Col_assign) and with a Matrix mask."""
    gb, dt = e.gb, e.dt
    out = []
    for mask_of in (None, lambda C: e.mask(60, (NC,)).S,
                    lambda C: e.mask(61, (NR, NC)).V):
        C = e.mat()
        C(mask=None if mask_of is None else mask_of(C),
          replace=mask_of is not None)[5, :] << \
            e.vec(62, NC)
        out.append(C)
    C = e.mat()
    C(e.mask(63, (NR,)).V, accum(gb, dt))[:, 1] << e.vec(64, NR)
    C[ROWS_U, 8] = e.vec(65, len(ROWS_U))
    C[0, COLS_U] = np.array([SCALAR[dt]] * len(COLS_U), np_type(dt))
    return out + [C]


@pytest.mark.parametrize("backing", BACKINGS)
@pytest.mark.parametrize("dtype", ["FP64", "BOOL"])
def test_assign_row_col(dtype, backing):
    run(sc_assign_row_col, backing, dtype)


# --------------------------------------------------------------------- #
# Vector assign and delete
def sc_vector_assign(e):
    gb, dt = e.gb, e.dt
    out = []
    for idx in (ROWS_U, ROWS_S, ROWS_D, slice(None)):
        m = e.mask(70, (NV,))
        n = len(range(NV)) if isinstance(idx, slice) else len(idx)
        for val in ([SCALAR[dt]] if idx is ROWS_D else
                    [SCALAR[dt], e.vec(71, n)]):
            for mask, acc, replace in ((None, None, False),
                                       (m.V, accum(gb, dt), True),
                                       (~m.S, None, False)):
                v = e.vec()
                v(mask=mask, accum=acc, replace=replace)[idx] << val
                out.append(v)
            v = e.vec()
            v[idx](e.mask(72, (n,)).S, replace=True) << val
            out.append(v)
    v = e.vec()
    v[3] = SCALAR[dt]
    v[0] = gb.Scalar(dt)
    v(accum=accum(gb, dt)) << SCALAR[dt]
    out.append(v)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_vector_assign(dtype):
    run(sc_vector_assign, "dense", dtype)


def sc_delete(e):
    out = []
    for rows, cols in ((ROWS_U, COLS_U), (ROWS_D, COLS_S), (3, 4),
                       (slice(None), [1, 2])):
        C = e.mat()
        del C[rows, cols]
        out.append(C)
    C = e.mat()
    del C(e.mask(80, (NR, NC)).V)[ROWS_S, :]
    v = e.vec()
    del v[ROWS_D]
    w = e.vec()
    del w(~e.mask(81, (NV,)).S)[ROWS_U]
    x = e.vec()
    del x[-1]
    return out + [C, v, w, x]


@pytest.mark.parametrize("backing", BACKINGS)
@pytest.mark.parametrize("dtype", ["INT64"])
def test_delete(dtype, backing):
    got = run(sc_delete, backing, dtype)
    if backing == "sparse":
        assert got[0]._sparse is not None


# --------------------------------------------------------------------- #
# membership, iteration and get
def sc_membership(e):
    v = e.vec()
    A = e.mat()
    out = [list(v), list(A), [i in v for i in range(-NV, NV)],
           [(i, j) in A for i in range(NR) for j in range(NC)],
           [v.get(i) for i in range(NV)], [v.get(i, -3) for i in range(NV)],
           [A.get(i, j, default=9) for i in range(NR) for j in range(NC)],
           A.get((2, 3)), v.get(4, default=0)]
    out.append(error(lambda: [0, 1] in v))
    return out


@pytest.mark.parametrize("backing", BACKINGS)
@pytest.mark.parametrize("dtype", ["FP32", "BOOL"])
def test_membership_and_iteration(dtype, backing):
    run(sc_membership, backing, dtype)


def test_membership_fault():
    """0 in v was False in the port (Python's sequence fallback over
    __getitem__); list(v) gave Scalar expressions."""
    jv = gbj.Vector.from_coo([0, 2], [5, 7], size=3)
    with gbt.config.set(device="cpu"):
        tv = gbt.Vector.from_coo([0, 2], [5, 7], size=3)
        assert (0 in tv) is (0 in jv) is True
        assert (1 in tv) is (1 in jv) is False
        assert list(tv) == list(jv) == [0, 2]
        assert tv.get(2) == jv.get(2) == 7


# --------------------------------------------------------------------- #
# the error contract
def sc_errors(e):
    gb = e.gb
    A, v = e.mat(), e.vec()
    B = e.mat(5, (2, 2))

    def assign_bad_shape():
        A[[0, 2, 4], [0, 5]] = B

    def assign_vmask_block():
        A(v.S)[[0, 1], [0, 1]] = 1

    def submask_wrong_rank():
        A[0, :](B.S) << e.vec(3, NC)

    def assign_input_mask():
        A(input_mask=A.S)[[0], [0]] = 1

    cases = [lambda: A[NR, 0], lambda: v[NV], lambda: v[[0, NV]],
             lambda: A[[0, -NR - 1], 0], lambda: v[np.array([True, False])],
             lambda: v[[0.5]], lambda: v[np.zeros((2, 2), np.int64)],
             lambda: A[0], lambda: A[0, 1, 2], lambda: v[0, 1],
             lambda: A[gb.Scalar.from_value(1.5), 0],
             assign_bad_shape, assign_vmask_block, submask_wrong_rank,
             assign_input_mask,
             lambda: A[0, 0].new(input_mask=A.S),
             lambda: A[[0], [0]].new(input_mask=v.S),
             lambda: A[0, [0, 1]].new(input_mask=B.S)]
    return [error(f) for f in cases]


def test_errors():
    run(sc_errors, "dense", "INT64")
