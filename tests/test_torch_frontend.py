"""The PyTorch port's frontend against the JAX package, on bench.py's loops.

PageRank (bench.py ``pr_body``) and level BFS (``bfs_body`` with the
``lor`` reduce as the loop condition) run under ``ss.iterate`` on both
packages at n=2000, with the JAX side's lanepipe on (``lane_on``).  At
that size the zipf graph's hub destination would pack over PACK_LIMIT at
the default SPLIT_DEG, so both packages split destinations at 64 edges,
which also drives the appendix tail.  The masked BFS step of
tests/test_lanepipe.py:158 runs level by level on both, and vxm, the
transposed mxv, the sparse-u branch and the two-level tail go through
both public APIs (the mxv semiring grid is in test_torch_lanepipe.py).
"""

import numpy as np
import pytest
import torch

import bench
import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt
from graphblas_tpu.core.engine import lanepipe as jlp
from graphblas_tpu_torch.core.engine import lanepipe as tlp

from .test_lanepipe import SEMIRINGS, lane_on, random_graph  # noqa: F401
from .test_torch_lanepipe import (assert_values_match, both_matrices,
                                  both_vectors, rand_values)

torch.set_num_threads(1)

N = 2000


@pytest.fixture
def bench_graph(monkeypatch):
    monkeypatch.setattr(jlp, "SPLIT_DEG", 64)
    monkeypatch.setattr(tlp, "SPLIT_DEG", 64)
    src, dst = bench.build_graph(N, 8)
    return src, dst


@pytest.fixture
def cpu():
    """The CPU, and every Matrix sparse-backed: these tests hold the SpMV
    engines, which a matrix under ``auto_sparse_limit`` would bypass."""
    with gbt.config.set(device="cpu", auto_sparse_limit=0):
        yield


def run_pagerank(gb, src, dst, iters):
    """bench.py's pr_body under ss.iterate; returns the rank vector."""
    n = N
    with gb.config.set(auto_sparse_limit=0):
        outdeg = np.bincount(src, minlength=n).astype(np.float32)
        w = (1.0 / outdeg[src]).astype(np.float32)
        A = gb.Matrix.from_coo(src, dst, w, dtype="FP32", nrows=n, ncols=n)
    ring = gb.semiring.plus_times["FP32"]
    damp = np.float32(0.85)
    tele = np.float32(0.15 / n)
    damp_tele = gb.unary.register_anonymous(lambda x: x * damp + tele,
                                            name="damp_tele_test")
    rank = gb.Vector.from_dense(np.full(n, 1.0 / n, np.float32))
    y = gb.Vector(gb.dtypes.FP32, n)

    def pr_body(s, i):
        s["y"] << s["rank"].vxm(A, ring)
        s["rank"] << s["y"].apply(damp_tele)

    it = gb.ss.iterate(pr_body, {"rank": rank, "y": y}, max_iter=iters)
    return rank, int(it)


def run_bfs(gb, src, dst):
    """bench.py's bfs_body and bfs_cond under ss.iterate."""
    n = N
    with gb.config.set(auto_sparse_limit=0):
        Ab = gb.Matrix.from_coo(src, dst, np.ones(len(src), bool),
                                dtype="BOOL", nrows=n, ncols=n)
    lor_land = gb.semiring.lor_land["BOOL"]

    def bfs_body(s, i):
        s["v"](mask=s["q"].V)[:] = i
        s["q"](~s["v"].S, replace=True) << s["q"].vxm(Ab, lor_land)

    def bfs_cond(s, i):
        return s["q"].reduce(gb.monoid.lor, allow_empty=False).new()

    q = gb.Vector.from_coo([0], [True], size=n)
    v = gb.Vector(gb.dtypes.INT32, n)
    it = gb.ss.iterate(bfs_body, {"q": q, "v": v}, cond=bfs_cond, max_iter=64)
    return v, int(it)


def test_pagerank_bench_body(bench_graph, lane_on, cpu):
    src, dst = bench_graph
    want, jit = run_pagerank(gbj, src, dst, 10)
    assert lane_on, "the JAX lanepipe was not used"
    got, tit = run_pagerank(gbt, src, dst, 10)
    assert tit == jit == 10
    gi, gv = got.to_coo()
    wi, wv = want.to_coo()
    assert np.array_equal(gi, wi)
    assert np.allclose(gv, wv, rtol=1e-5, atol=0)
    assert abs(gv.astype(np.float64).sum() - 1.0) < 1e-3
    assert got[0].new().value == pytest.approx(float(wv[0]), rel=1e-5)


def test_bfs_bench_body(bench_graph, lane_on, cpu):
    src, dst = bench_graph
    want, jit = run_bfs(gbj, src, dst)
    assert lane_on, "the JAX lanepipe was not used"
    got, tit = run_bfs(gbt, src, dst)
    assert tit == jit
    gi, gv = got.to_coo()
    wi, wv = want.to_coo()
    assert np.array_equal(gi, wi)
    assert np.array_equal(gv, wv)
    assert got.nvals == N  # the ring edges reach every node


def test_masked_vxm_bfs_step(rng, lane_on, cpu):
    """tests/test_lanepipe.py:158, the BFS statement level by level."""
    n = 80
    r, c, _ = random_graph(rng, n, 500, "BOOL")
    with gbj.config.set(auto_sparse_limit=0):
        jA = gbj.Matrix.from_coo(r, c, np.ones(len(r), bool), dtype="BOOL",
                                 nrows=n, ncols=n)
    tA = gbt.Matrix.from_coo(r, c, np.ones(len(r), bool), dtype="BOOL",
                             nrows=n, ncols=n)
    jq = gbj.Vector.from_coo([0], [True], size=n)
    jlev = gbj.Vector(gbj.dtypes.INT32, n)
    tq = gbt.Vector.from_coo([0], [True], size=n)
    tlev = gbt.Vector(gbt.dtypes.INT32, n)
    for d in range(1, 6):
        jlev(mask=jq.V)[:] = d
        jq(~jlev.S, replace=True) << jq.vxm(jA, gbj.semiring.lor_land["BOOL"])
        tlev(mask=tq.V)[:] = d
        tq(~tlev.S, replace=True) << tq.vxm(tA, gbt.semiring.lor_land["BOOL"])
        for got, want in ((tq, jq), (tlev, jlev)):
            gi, gv = got.to_coo()
            wi, wv = want.to_coo()
            assert np.array_equal(gi, wi), f"level {d}"
            assert np.array_equal(gv, wv), f"level {d}"
    assert lane_on


def test_entry_points_raise_without_gpu(monkeypatch):
    """The default device is CUDA; with no GPU an entry point raises
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert gbt.config["device"] == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gbt.Vector(gbt.dtypes.FP32, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gbt.Matrix.from_coo([0], [1], [1.0], nrows=2, ncols=2)
    with gbt.config.set(device="cpu"):
        assert gbt.Vector(gbt.dtypes.FP32, 4).device.type == "cpu"
    assert gbt.config["device"] == "cuda"


def test_vector_basics(cpu):
    v = gbt.Vector.from_coo([3, 1, 3], [1.0, 2.0, 5.0], size=5,
                            dup_op=gbt.binary.plus)
    assert v.dtype.name == "FP64" and v.nvals == 2
    idx, vals = v.to_coo()
    assert idx.tolist() == [1, 3] and vals.tolist() == [2.0, 6.0]
    assert v[3].new().value == 6.0 and v[0].new().value is None
    assert v.reduce(gbt.monoid.max).new().value == 6.0
    e = gbt.Vector(gbt.dtypes.BOOL, 3)
    assert e.reduce(gbt.monoid.lor).new().value is None
    assert e.reduce(gbt.monoid.lor, allow_empty=False).new().value is np.False_
    u = gbt.Vector.from_dense(np.array([1, 2, 3], np.uint32), dtype="UINT32")
    assert u.reduce(gbt.monoid.band).new().value == 0
    assert u.to_coo()[1].dtype == np.uint32
    with pytest.raises(gbt.exceptions.InvalidValue, match="dup_op"):
        gbt.Vector.from_coo([1, 1], [1.0, 2.0], size=3)


def test_setitem_dup_isequal(cpu):
    """What algorithms.sssp and bfs_level touch beyond the bench loops."""
    d = gbt.Vector(gbt.dtypes.FP32, 5)
    d[2] = 0
    assert d.nvals == 1 and d[2].new().value == 0.0
    prev = d.dup()
    assert prev.isequal(d) and prev.dtype is d.dtype
    d[-1] = 3.5
    assert prev.nvals == 1 and d.nvals == 2  # the copy does not follow
    assert not d.isequal(prev)
    d[4] = gbt.Scalar(gbt.dtypes.FP32)  # an empty Scalar deletes
    assert d.isequal(prev)
    as_int = d.dup(dtype="INT32")
    assert as_int.dtype.name == "INT32" and as_int.isequal(d)
    assert not as_int.isequal(d, check_dtype=True)
    assert d.dup(clear=True).nvals == 0
    other = gbt.Vector.from_coo([2], [1.0], dtype="FP32", size=5)
    assert not d.isequal(other)                     # same structure
    assert not d.isequal(gbt.Vector(gbt.dtypes.FP32, 6))
    with pytest.raises(IndexError):
        d[5] = 1.0
    with pytest.raises(TypeError):
        d.isequal(3)
    q = gbt.Vector(gbt.dtypes.BOOL, 3)
    q[0] = True
    assert q.to_coo()[1].tolist() == [True]


def test_accum_min_union_structure(cpu):
    """``d(accum=min) << z``: min where both, z where only z, d stays
    where only d (the SSSP relaxation on a sparse d and a sparse z)."""
    d = gbt.Vector.from_coo([0, 2], [5.0, 1.0], dtype="FP32", size=5)
    z = gbt.Vector.from_coo([2, 3, 0], [4.0, 7.0, 2.0], dtype="FP32", size=5)
    d(accum=gbt.binary.min) << z
    assert d.to_coo()[0].tolist() == [0, 2, 3]
    assert d.to_coo()[1].tolist() == [2.0, 1.0, 7.0]


def test_masked_accum_write_back(cpu):
    """c(mask, accum) << expr keeps c outside the mask, accumulates inside."""
    c = gbt.Vector.from_coo([0, 1, 2], [1.0, 1.0, 1.0], size=4)
    z = gbt.Vector.from_dense(np.array([10.0, 20.0, 30.0, 40.0]))
    m = gbt.Vector.from_coo([1, 3], [True, False], size=4)
    c(m.V, accum=gbt.binary.plus) << z.apply(gbt.unary.identity)
    assert c.to_coo()[0].tolist() == [0, 1, 2]
    assert c.to_coo()[1].tolist() == [1.0, 21.0, 1.0]
    c(~m.S, replace=True) << z
    assert c.to_coo()[0].tolist() == [0, 2]
    assert c.to_coo()[1].tolist() == [10.0, 30.0]


# --------------------------------------------------------------------- #
# the SpMV pipeline through both public APIs (mxv: test_torch_lanepipe.py)
@pytest.mark.parametrize("ring_name,dtype", SEMIRINGS[:4])
def test_vxm_parity(rng, ring_name, dtype, lane_on, cpu):
    n = 150
    r, c, v = random_graph(rng, n, 1200, dtype)
    jA, tA = both_matrices(r, c, v, dtype, n)
    jx, tx = both_vectors(rand_values(rng, n, dtype), dtype)
    want = jx.vxm(jA, getattr(gbj.semiring, ring_name)[dtype]).new()
    got = tx.vxm(tA, getattr(gbt.semiring, ring_name)[dtype]).new()
    assert lane_on
    assert_values_match(got.to_coo(), want.to_coo(), dtype)


@pytest.mark.parametrize("at", [False, True])
def test_transposed_parity(rng, at, lane_on, cpu):
    n = 120
    r, c, v = random_graph(rng, n, 900, "FP32")
    jA, tA = both_matrices(r, c, v, "FP32", n)
    jx, tx = both_vectors(rand_values(rng, n, "FP32"), "FP32")
    want = (jA.T if at else jA).mxv(jx, gbj.semiring.plus_times["FP32"]).new()
    got = (tA.T if at else tA).mxv(tx, gbt.semiring.plus_times["FP32"]).new()
    assert lane_on
    assert_values_match(got.to_coo(), want.to_coo(), "FP32")


def test_sparse_u_slow_branch(rng, lane_on, cpu):
    """Output structure = dests with >=1 (edge AND present-u) pair."""
    n = 100
    r, c, v = random_graph(rng, n, 600, "FP32")
    jA, tA = both_matrices(r, c, v, "FP32", n)
    idx = np.sort(rng.choice(n, 30, replace=False))
    jx, tx = both_vectors(rng.random(30).astype(np.float32), "FP32", idx, n)
    want = jA.mxv(jx, gbj.semiring.plus_times["FP32"]).new()
    got = tA.mxv(tx, gbt.semiring.plus_times["FP32"]).new()
    assert lane_on
    assert got.nvals < n  # the sparse u leaves destinations empty
    assert_values_match(got.to_coo(), want.to_coo(), "FP32")


@pytest.mark.parametrize("sparse_u", [False, True])
def test_skewed_dest_two_level(rng, monkeypatch, lane_on, cpu, sparse_u):
    """A destination with degree >> SPLIT_DEG takes the appendix tail."""
    monkeypatch.setattr(jlp, "SPLIT_DEG", 16)
    monkeypatch.setattr(tlp, "SPLIT_DEG", 16)
    # another size per case: the JAX package caches the compiled call by
    # plan geometry, and a cache hit would not reach its lanepipe again
    n = 66 if sparse_u else 64
    r = np.concatenate([np.arange(n), np.arange(0, n, 3)])
    c = np.concatenate([np.full(n, 3), (np.arange(0, n, 3) + 1) % n])
    lin = np.unique(r.astype(np.int64) * n + c)
    r, c = lin // n, lin % n
    v = rng.random(len(r)).astype(np.float32)
    jA, tA = both_matrices(r, c, v, "FP32", n)
    xv = rng.random(n).astype(np.float32)
    if sparse_u:
        idx = np.sort(rng.choice(n, 40, replace=False))
        jx, tx = both_vectors(xv[idx], "FP32", idx, n)
    else:
        jx, tx = both_vectors(xv, "FP32")
    want = jx.vxm(jA, gbj.semiring.plus_times["FP32"]).new()
    got = tx.vxm(tA, gbt.semiring.plus_times["FP32"]).new()
    assert lane_on
    assert any(p and p["two_level"] for p in tA._sparse._lanepipe_plans.values())
    assert_values_match(got.to_coo(), want.to_coo(), "FP32")


def test_not_ported_raises(cpu):
    """What the port lacks raises; FP64 products and reduces and a sparse
    mxm, which raised before the generic sparse engine, match the JAX
    package."""
    A = gbt.Matrix.from_coo([0, 1], [1, 0], [1.0, 2.0], dtype="FP64")
    x = gbt.Vector.from_dense(np.ones(2))
    with gbj.config.set(auto_sparse_limit=0):
        jA = gbj.Matrix.from_coo([0, 1], [1, 0], [1.0, 2.0], dtype="FP64")
    jx = gbj.Vector.from_dense(np.ones(2))
    for got, want in (
            (A.mxv(x, gbt.semiring.plus_times["FP64"]),
             jA.mxv(jx, gbj.semiring.plus_times["FP64"])),
            (A.mxm(A), jA.mxm(jA)),
            (A.reduce_rowwise("plus"), jA.reduce_rowwise(gbj.monoid.plus))):
        got, want = got.new(), want.new()
        assert got.dtype.name == want.dtype.name == "FP64"
        assert all(np.array_equal(g, w) for g, w in zip(got.to_coo(),
                                                         want.to_coo()))
    assert A.mxm(A).new()._sparse is not None
    assert gbt.dtypes.lookup_dtype("FC64").name == \
        gbj.dtypes.lookup_dtype("FC64").name
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gbt.parallel
    # conj, which raised before the complex types, matches the JAX package
    C = gbt.Matrix.from_coo([0, 1], [1, 0], [1 + 2j, 3 - 1j])
    with gbj.config.set(auto_sparse_limit=0):
        jC = gbj.Matrix.from_coo([0, 1], [1, 0], [1 + 2j, 3 - 1j])
    assert all(np.array_equal(g, w) for g, w in zip(
        C.apply(gbt.unary.conj).new().to_coo(),
        jC.apply(gbj.unary.conj).new().to_coo()))
    # to_csr and x @ x, which raised before the constructors and the
    # infix slice, match the JAX package
    assert all(np.array_equal(g, w) for g, w in zip(A.to_csr(), jA.to_csr()))
    assert (x @ x).new().value == (jx @ jx).new().value == 2.0
    # one destination with 5000 in-edges packs over PACK_LIMIT: the sort
    # pipeline takes it
    n = 5001
    H = gbt.Matrix.from_coo(np.arange(1, n), np.zeros(n - 1, np.int64),
                            np.ones(n - 1, np.float32), nrows=n, ncols=n)
    u = gbt.Vector.from_dense(np.ones(n, np.float32))
    out = u.vxm(H, gbt.semiring.plus_times["FP32"]).new()
    assert H._sparse._lanepipe_plans[(False, torch.device("cpu"))] is None
    assert out.to_coo()[0].tolist() == [0]
    assert out.to_coo()[1].tolist() == [float(n - 1)]
