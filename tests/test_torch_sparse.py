"""The PyTorch port's generic sparse engine against the JAX package's.

Both packages run with ``auto_sparse_limit=0``, so every Matrix is
sparse-backed, on the same random matrices (24 x 24 and 24 x 20, from a
seed): the store (``to_coo``, the shared structure of ``apply``, the
transposes' permutation, a cast, ``A[i, j]``); ``apply`` with a unary op
and a bound scalar; ``select`` with a structural and a value operator;
``A.T.new()``; the generic SpMV and reduces over FP32 (monoids the sort
pipeline declines), FP64, INT64 and BOOL; ``mxm`` by a diagonal; the
element-wise merges; the masked write-back over mask x accum x replace;
and SpGEMM by each formulation, forced, with structural, value and
complemented masks and with empty operands.

Tolerances: structure, BOOL and integer values exact; FP32 to rel 1e-5 and
FP64 to rel 1e-12 (sums run in another order).  Every port result that is
a matrix must stay sparse-backed.
"""

import numpy as np
import pytest
import torch

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt
from graphblas_tpu_torch.core import execute as tex

torch.set_num_threads(1)

N, NC = 24, 20
DTYPES = ("FP32", "FP64", "INT64", "BOOL")
REL = {"FP32": 1e-5, "FP64": 1e-12}


@pytest.fixture(autouse=True)
def sparse_cpu():
    with gbt.config.set(device="cpu", auto_sparse_limit=0), \
            gbj.config.set(auto_sparse_limit=0):
        yield


def coo_data(seed, dtype, shape=(N, N), density=0.18):
    rng = np.random.default_rng(seed)
    r, c = np.nonzero(rng.random(shape) < density)
    if dtype == "BOOL":
        v = rng.random(len(r)) < 0.7
    elif dtype.startswith("INT"):
        v = rng.integers(-3, 4, len(r))
    else:
        v = rng.choice([-1.5, 0.0, 0.25, 2.0, 3.0], len(r)) + \
            rng.random(len(r))
    return r, c, v.astype(gbt.dtypes.lookup_dtype(dtype).np_type), shape


def both(data, dtype):
    r, c, v, (nr, nc) = data
    return tuple(gb.Matrix.from_coo(r, c, v, dtype=dtype, nrows=nr, ncols=nc)
                 for gb in (gbj, gbt))


def same(got, want, sparse=True):
    """A port result against the JAX package's: type, structure, values."""
    assert got.dtype.name == want.dtype.name
    if sparse and got.ndim == 2:
        assert got._sparse is not None
    g, w = got.to_coo(), want.to_coo()
    for a, b in zip(g[:-1], w[:-1]):
        np.testing.assert_array_equal(a, b)
    rel = REL.get(got.dtype.name)
    if rel is None:
        np.testing.assert_array_equal(g[-1], w[-1])
    else:
        np.testing.assert_allclose(g[-1], w[-1], rtol=rel, atol=0)


@pytest.fixture(scope="module")
def mats():
    """Per dtype: square A, another square B, and a 24 x 20 R."""
    out = {}
    for i, dt in enumerate(DTYPES):
        out[dt] = (coo_data(10 + i, dt), coo_data(20 + i, dt),
                   coo_data(30 + i, dt, (N, NC)))
    return out


# --------------------------------------------------------------------- #
def test_store_is_on_the_device_and_shares_structure(mats):
    jA, tA = both(mats["FP32"][0], "FP32")
    sp = tA._sparse
    assert sp.rows.dtype == torch.int64 and sp.vals.dtype == torch.float32
    keys = sp.rows * N + sp.cols
    assert bool((keys[1:] > keys[:-1]).all())  # sorted, no duplicates
    same(tA, jA)
    one = tA.apply(gbt.unary.one).new()
    assert one._sparse.struct is sp.struct  # same structure, shared
    assert not one._sparse._sortpipe_plans  # plans carry values: its own
    perm = sp.csc_perm()
    assert one._sparse.csc_perm() is perm
    ck = sp.cols[perm] * N + sp.rows[perm]
    assert bool((ck[1:] > ck[:-1]).all())
    tT = tA.T.new()
    assert torch.equal(tT._sparse.csc_perm(),
                       torch.sort(tT._sparse.cols, stable=True)[1])
    same(tT.T.new(), jA)
    # a reduce builds a plan on the store; a same-structure result has none
    tA.reduce_rowwise("plus").new()
    assert tA._sparse._sortpipe_plans and not one._sparse._sortpipe_plans
    i, j = (int(x[0]) for x in tA.to_coo()[:2])
    assert tA[i, j].new().value == jA[i, j].new().value
    assert tA[i, (j + 1) % N].new().value == jA[i, (j + 1) % N].new().value


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_select_transpose_cast(mats, dtype):
    jA, tA = both(mats[dtype][0], dtype)
    jR, tR = both(mats[dtype][2], dtype)
    cases = [
        lambda gb, A, R: A.apply(gb.unary.one).new(),
        lambda gb, A, R: A.apply(gb.unary.abs).new(),
        lambda gb, A, R: A.apply(gb.unary.minv).new(),
        lambda gb, A, R: A.apply(gb.binary.times, right=3).new(),
        lambda gb, A, R: A.apply(gb.binary.minus, left=2).new(),
        lambda gb, A, R: A.select(gb.select.tril, -1).new(),
        lambda gb, A, R: A.select(gb.select.valuegt, 0).new(),
        lambda gb, A, R: R.select(gb.select.offdiag).new(),
        lambda gb, A, R: R.T.select(gb.select.triu, 2).new(),
        lambda gb, A, R: R.T.new(),
        lambda gb, A, R: R.T.new(dtype="FP64"),
        lambda gb, A, R: A.dup(dtype="INT64"),
        lambda gb, A, R: A.T.apply(gb.unary.one).new(dtype="FP32"),
        lambda gb, A, R: A.apply(gb.indexunary.rowindex, 1).new(),
    ]
    for case in cases:
        same(case(gbt, tA, tR), case(gbj, jA, jR))


@pytest.mark.parametrize("dtype,ring,mono", [
    ("FP64", "plus_times", "plus"), ("FP64", "min_plus", "min"),
    ("INT64", "plus_times", "max"), ("INT64", "any_second", "times"),
    ("FP32", "any_first", "any"), ("BOOL", "lor_land", "land"),
])
def test_generic_spmv_and_reduces(mats, dtype, ring, mono):
    """Rings and types the lanepipe and the sort pipeline decline go to the
    generic SpMV; monoids the sort pipeline's scan lacks to the generic
    reduce."""
    jA, tA = both(mats[dtype][2], dtype)
    rng = np.random.default_rng(5)
    for size, expr in ((NC, lambda gb, A, x, r: A.mxv(x, r)),
                       (N, lambda gb, A, x, r: x.vxm(A, r))):
        idx = np.flatnonzero(rng.random(size) < 0.6)
        vals = mats[dtype][0][2][:len(idx)]
        x = [gb.Vector.from_coo(idx, vals, dtype=dtype, size=size)
             for gb in (gbj, gbt)]
        want = expr(gbj, jA, x[0], getattr(gbj.semiring, ring)[dtype]).new()
        got = expr(gbt, tA, x[1], getattr(gbt.semiring, ring)[dtype]).new()
        same(got, want)
    jm, tm = getattr(gbj.monoid, mono), getattr(gbt.monoid, mono)
    for pick in (lambda A: A.reduce_rowwise, lambda A: A.T.reduce_rowwise):
        same(pick(tA)(tm).new(), pick(jA)(jm).new())
    for allow_empty in (True, False):
        got = tA.reduce_scalar(tm, allow_empty=allow_empty).new()
        want = jA.reduce_scalar(jm, allow_empty=allow_empty).new()
        assert got.dtype.name == want.dtype.name
        if dtype in REL and mono in ("plus", "times"):
            assert got.value == pytest.approx(want.value, rel=REL[dtype])
        else:
            assert got.value == want.value


@pytest.mark.parametrize("side", ["left", "right", "left_T"])
def test_mxm_by_a_diagonal(mats, side):
    """diag(v) @ A scales rows and A @ diag(v) columns; an entry whose
    diagonal element is missing is dropped."""
    jA, tA = both(mats["FP64"][2], "FP64")
    n = N if side != "right" else NC
    rng = np.random.default_rng(8)
    idx = np.flatnonzero(rng.random(n) < 0.8)
    vals = rng.random(len(idx)) + 0.5
    res = []
    for gb, A in ((gbj, jA), (gbt, tA)):
        D = gb.Vector.from_coo(idx, vals, dtype="FP64", size=n).diag()
        ring = gb.semiring.plus_times
        if side == "left":
            res.append(D.mxm(A, ring).new())
        elif side == "right":
            res.append(A.mxm(D, ring).new())
        else:
            res.append(D.T.mxm(A, ring).new())
    assert res[1]._sparse is not None and res[1]._sparse.nvals() < tA.nvals
    same(res[1], res[0])
    v = gbt.Vector.from_dense(np.ones(N)).diag()
    assert v._sparse.is_diag
    full = v.mxm(tA, gbt.semiring.plus_times).new()
    assert full._sparse.struct is tA._sparse.struct


@pytest.mark.parametrize("dtype", ["FP32", "INT64", "BOOL"])
def test_ewise_merges(mats, dtype):
    jA, tA = both(mats[dtype][0], dtype)
    jB, tB = both(mats[dtype][1], dtype)
    op = "plus" if dtype != "BOOL" else "lor"
    cases = [
        lambda gb, A, B: A.ewise_add(B, getattr(gb.binary, op)).new(),
        lambda gb, A, B: A.ewise_mult(B, gb.binary.times).new(),
        lambda gb, A, B: A.ewise_union(B, gb.binary.minus, 1, 2).new(),
        lambda gb, A, B: A.ewise_add(B.T, gb.binary.max).new(),
        lambda gb, A, B: A.T.ewise_mult(B.T, gb.binary.first).new(),
        # one structure
        lambda gb, A, B: A.ewise_add(A.apply(gb.unary.one).new(),
                                     gb.binary.plus).new(),
        lambda gb, A, B: A.ewise_union(A, gb.binary.times, 0, 0).new(),
        # sparse .* dense, and a vector broadcast along the rows
        lambda gb, A, B: A.ewise_mult(
            gb.Matrix.from_dense(np.arange(N * N).reshape(N, N) % 3,
                                 missing_value=0), gb.binary.times).new(),
        lambda gb, A, B: A.ewise_mult(
            gb.Vector.from_coo([1, 4, 5, 9], [2, 3, 4, 5], size=N),
            gb.binary.times).new(),
    ]
    for case in cases:
        same(case(gbt, tA, tB), case(gbj, jA, jB))


WRITE_BACK = [(m, a, r) for m in ("none", "S", "V", "~S", "~V", "dense_S")
              for a in (None, "plus") for r in (False, True)
              if m != "none" or not r]  # replace needs a mask


@pytest.mark.parametrize("mask,accum,replace", WRITE_BACK,
                         ids=[f"{m}-{a}-{r}" for m, a, r in WRITE_BACK])
def test_write_back_sparse(mats, mask, accum, replace):
    """C(mask, accum, replace) << Z, every collection sparse (the mask of
    ``dense_S`` is dense-backed), against the JAX package."""
    res = []
    for gb in (gbj, gbt):
        C, Z = (gb.Matrix.from_coo(*d[:3], dtype="INT64", nrows=N, ncols=N)
                for d in (mats["INT64"][0], mats["INT64"][1]))
        limit = 1 << 22 if mask == "dense_S" else 0
        with gb.config.set(auto_sparse_limit=limit):
            M = gb.Matrix.from_coo(*mats["BOOL"][1][:3], dtype="BOOL",
                                   nrows=N, ncols=N)
        m = {"none": None, "S": M.S, "V": M.V, "~S": ~M.S, "~V": ~M.V,
             "dense_S": M.S}[mask]
        acc = None if accum is None else getattr(gb.binary, accum)
        C(mask=m, accum=acc, replace=replace) << Z.apply(gb.unary.identity)
        res.append(C)
    same(res[1], res[0])


def _spgemm_operands(gb, kind):
    """A, B and a mask M.  kind "empty": A has no entries; "disjoint": A
    lies in the top-left quarter and B in the bottom-right, so A @ B.T and
    A.T @ B have entries on both sides but no term; "full": M stores every
    position."""
    r, c, v, _ = coo_data(40, "INT64", density=0.2)
    keep = (r < N // 2) & (c < N // 2) if kind == "disjoint" else \
        np.ones(len(r), dtype=bool)
    A = gb.Matrix.from_coo(r[keep], c[keep], v[keep], dtype="INT64",
                           nrows=N, ncols=N)
    keep = (r >= N // 2) & (c >= N // 2) if kind == "disjoint" else keep
    B = gb.Matrix.from_coo(c[keep], r[keep], v[keep], dtype="INT64",
                           nrows=N, ncols=N)
    mr, mc, mv, _ = coo_data(41, "INT64", density=1.0 if kind == "full"
                             else 0.3)
    M = gb.Matrix.from_coo(mr, mc, mv, dtype="INT64", nrows=N, ncols=N)
    if kind == "empty":
        A = gb.Matrix("INT64", N, N)
    return A, B, M


SPGEMM = [("plus_times", "S"), ("plus_times", "V"), ("min_plus", "S"),
          ("plus_pair", "~S"), ("max_first", None), ("plus_times", "emptyS"),
          ("min_plus", "disjointS"), ("min_plus", "disjoint"),
          ("max_first", "~fullS")]


def spgemm_choices(fn):
    """fn() and the choices of the SpGEMMs it ran, read from the profiler
    ranges that execute._spgemm_run opens (execute.spgemm_record)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    recs = [tex.spgemm_record(e.name) for e in prof.events()]
    return out, [r for r in recs if r is not None]


@pytest.mark.parametrize("ring,mask", SPGEMM,
                         ids=[f"{r}-{m}" for r, m in SPGEMM])
def test_spgemm_both_formulations(ring, mask):
    """A @ B.T and A.T @ B under each formulation forced: the same result,
    equal to the JAX package's (which picks by the expansion totals).  The
    last three make no term: no index k meets on both sides, or a
    complemented mask that stores every position drops them all."""
    kind = {"emptyS": "empty", "disjointS": "disjoint", "disjoint": "disjoint",
            "~fullS": "full"}.get(mask, "")
    out = {}
    for gb in (gbj, gbt):
        A, B, M = _spgemm_operands(gb, kind)
        m = {"S": M.S, "V": M.V, "~S": ~M.S, "emptyS": M.S, None: None,
             "disjointS": M.S, "disjoint": None, "~fullS": ~M.S}[mask]
        rg = getattr(gb.semiring, ring)
        for tr in ("nt", "tn"):
            expr = A.mxm(B.T, rg) if tr == "nt" else A.T.mxm(B, rg)
            if gb is gbj:
                out[tr] = expr.new(mask=m)
                continue
            for f in ("dot", "gustavson"):
                got, recs = spgemm_choices(
                    lambda: expr.new(mask=m, axb_method=f))
                same(got, out[tr])
                # an empty operand makes no product at all
                want = [] if mask == "emptyS" else [
                    f if mask in ("S", "V", "disjointS") else "gustavson"]
                assert [r["formulation"] for r in recs] == want


def test_masked_dot_counts_terms():
    """The dot's term count is sum over the mask of min(deg_A, deg_B),
    Gustavson's sum over k of deg_A(k) deg_B(k); the default takes the
    smaller, from one device read of both.  A mask made on the device
    gives the JAX package's result too."""
    A, B, M = _spgemm_operands(gbt, "")
    _, recs = spgemm_choices(
        lambda: A.mxm(B.T, gbt.semiring.plus_pair).new(mask=M.S))
    (rec,) = recs
    ar, ac, _ = (x.astype(np.int64) for x in A.to_coo())
    br, bc, _ = (x.astype(np.int64) for x in B.to_coo())
    mr, mc, _ = (x.astype(np.int64) for x in M.to_coo())
    da, db = np.bincount(ar, minlength=N), np.bincount(br, minlength=N)
    assert rec["dot_terms"] == int(np.minimum(da[mr], db[mc]).sum())
    assert rec["gustavson_terms"] == int(
        (np.bincount(ac, minlength=N) * np.bincount(bc, minlength=N)).sum())
    dot_wins = rec["dot_terms"] <= rec["gustavson_terms"]
    assert rec["formulation"] == ("dot" if dot_wins else "gustavson")
    assert rec["terms"] == rec[rec["formulation"] + "_terms"]
    L = M.select(gbt.select.tril, 0).new()
    got = A.mxm(B.T, gbt.semiring.plus_pair).new(mask=L.S)
    jA, jB, jM = _spgemm_operands(gbj, "")
    jL = jM.select(gbj.select.tril, 0).new()
    same(got, jA.mxm(jB.T, gbj.semiring.plus_pair).new(mask=jL.S))


def test_float_sums_are_per_segment():
    """An FP64 plus reduce adds each output's terms on their own: values
    from 1e-3 to 1e20 in one matrix leave every small sum intact (a
    difference of running sums over the whole array would lose them).
    Held per entry at rel 1e-12 against math.fsum; the JAX package sums by
    running sums, so it is no reference here."""
    import math

    rng = np.random.default_rng(8)
    pres = rng.random((N, N)) < 0.3
    d = np.where(pres, rng.random((N, N)) * 10.0 ** rng.integers(
        -3, 21, (N, N)), 0.0)
    r, c = np.nonzero(pres)
    A = gbt.Matrix.from_coo(r, c, d[r, c], dtype="FP64", nrows=N, ncols=N)
    ones = gbt.Vector.from_dense(np.ones(N))
    ring = gbt.semiring.plus_times

    def check(got, terms):
        gi, gj, gv = got.to_coo() if got.ndim == 2 else (
            got.to_coo()[0], None, got.to_coo()[1])
        want = {k: math.fsum(t) for k, t in terms.items() if t}
        keys = list(zip(gi, gj)) if gj is not None else list(gi)
        assert sorted(keys) == sorted(want)
        np.testing.assert_allclose(gv, [want[k] for k in keys], rtol=1e-12,
                                   atol=0)

    rows = {i: list(d[i, pres[i]]) for i in range(N)}
    cols = {j: list(d[pres[:, j], j]) for j in range(N)}
    check(A.reduce_rowwise(gbt.monoid.plus).new(), rows)
    check(A.reduce_columnwise(gbt.monoid.plus).new(), cols)
    check(A.mxv(ones, ring).new(), rows)
    check(ones.vxm(A, ring).new(), cols)
    aat = {(i, j): list(d[i] * d[j])
           for i in range(N) for j in range(N)
           if (pres[i] & pres[j]).any()}
    aat = {k: [x for x in t if x] for k, t in aat.items()}
    check(A.mxm(A.T, ring).new(), aat)
    masked = {k: aat[k] for k in zip(r, c) if k in aat}
    for f in ("dot", "gustavson"):
        check(A.mxm(A.T, ring).new(mask=A.S, axb_method=f), masked)


def test_empty_operands():
    for gb in (gbj, gbt):
        E = gb.Matrix("FP64", N, N)
        A = gb.Matrix.from_coo([0, 3], [1, 2], [1.0, 2.0], nrows=N, ncols=N)
        C = gb.Matrix("FP64", N, N)
        C(E.S) << A.mxm(A, gb.semiring.plus_times)
        assert C.nvals == 0
        assert E.mxm(A).new().nvals == 0
        assert E.select(gb.select.tril).new().nvals == 0
        assert E.T.new().nvals == 0
        assert E.ewise_add(A).new().nvals == 2
        assert E.ewise_mult(A).new().nvals == 0
        assert E.reduce_scalar(gb.monoid.plus).new().value is None
        x = gb.Vector.from_dense(np.ones(N))
        assert E.mxv(x).new().nvals == 0
        assert E.reduce_rowwise(gb.monoid.max).new().nvals == 0
