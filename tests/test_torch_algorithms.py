"""``graphblas_tpu_torch.algorithms`` against ``graphblas_tpu.algorithms``.

``sssp`` (Bellman-Ford over min_plus, whose one-entry distance vector runs
the sparse-vector branch of the SpMV) and ``bfs_level`` run on both
packages from the same numpy graph.  Each graph runs twice on the port:
through the lanepipe (the JAX side under ``lane_on``, with destinations
split at 64 edges on both, as tests/test_torch_frontend.py does) and
through the sort pipeline, with PACK_LIMIT set so that the lanepipe turns
every matrix down.  Structure, BOOL and integer
results must match exactly; FP32 distances to rel 1e-5.
"""

import numpy as np
import pytest
import torch

import bench
import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt
from graphblas_tpu import algorithms as jalg
from graphblas_tpu.core.engine import lanepipe as jlp
from graphblas_tpu_torch import algorithms as talg
from graphblas_tpu_torch.core.engine import lanepipe as tlp

from .test_lanepipe import lane_on, random_graph  # noqa: F401
from .test_torch_lanepipe import assert_values_match, both_matrices

torch.set_num_threads(1)

N = 600


@pytest.fixture
def cpu():
    """The CPU, and every Matrix sparse-backed: these tests hold the SpMV
    engines, which a matrix under ``auto_sparse_limit`` would bypass."""
    with gbt.config.set(device="cpu", auto_sparse_limit=0):
        yield


@pytest.fixture(params=["lanepipe", "sortpipe"])
def engine(request, monkeypatch):
    """lanepipe: split destinations at 64 edges so the small zipf graph
    packs.  sortpipe: no plan fits under PACK_LIMIT, as for a hypersparse
    matrix, so every vxm falls to the sort pipeline."""
    if request.param == "lanepipe":
        monkeypatch.setattr(jlp, "SPLIT_DEG", 64)
        monkeypatch.setattr(tlp, "SPLIT_DEG", 64)
    else:
        monkeypatch.setattr(jlp, "PACK_LIMIT", -1e9)
        monkeypatch.setattr(tlp, "PACK_LIMIT", -1e9)
    return request.param


def check_engine(tA, engine):
    plans = tA._sparse._lanepipe_plans
    assert plans, "no vxm ran"
    took_lanepipe = all(p is not None for p in plans.values())
    assert took_lanepipe == (engine == "lanepipe")
    assert bool(tA._sparse._sortpipe_plans) == (engine == "sortpipe")


def test_sssp_zipf(engine, lane_on, cpu, rng):
    src, dst = bench.build_graph(N, 8)
    w = (rng.random(len(src)) + 0.1).astype(np.float32)
    jA, tA = both_matrices(src, dst, w, "FP32", N)
    want = jalg.sssp(jA, 0)
    got = talg.sssp(tA, 0)
    check_engine(tA, engine)
    assert got.dtype.name == want.dtype.name == "FP32"
    assert got.nvals == N  # the ring edges reach every node
    assert_values_match(got.to_coo(), want.to_coo(), "FP32")


@pytest.mark.parametrize("dtype", ["FP32", "INT32"])
def test_sssp_unreachable_and_max_iters(dtype, cpu, rng):
    """A sparse random graph leaves nodes unreached; max_iters cuts the
    relaxation short on both packages alike."""
    n = 300
    r, c, v = random_graph(rng, n, 450, dtype)
    source = int(np.bincount(r).argmax())
    jA, tA = both_matrices(r, c, v, dtype, n)
    for kw in ({}, {"max_iters": 2}):
        want = jalg.sssp(jA, source, **kw)
        got = talg.sssp(tA, source, **kw)
        assert 1 < got.nvals < n
        assert_values_match(got.to_coo(), want.to_coo(), dtype)
    assert got[source].new().value == 0


def test_bfs_level_zipf(engine, lane_on, cpu):
    src, dst = bench.build_graph(N, 8)
    jA, tA = both_matrices(src, dst, np.ones(len(src), bool), "BOOL", N)
    want = jalg.bfs_level(jA, 0)
    got = talg.bfs_level(tA, 0)
    check_engine(tA, engine)
    assert got.dtype.name == want.dtype.name == "INT64"
    assert got.nvals == N and got[0].new().value == 1
    assert_values_match(got.to_coo(), want.to_coo(), "INT64")


def test_bfs_level_unreachable(cpu, rng):
    n = 200
    r, c, _ = random_graph(rng, n, 260, "BOOL")
    jA, tA = both_matrices(r, c, np.ones(len(r), bool), "BOOL", n)
    source = int(np.bincount(r).argmax())
    want = jalg.bfs_level(jA, source)
    got = talg.bfs_level(tA, source)
    assert 1 < got.nvals < n
    assert_values_match(got.to_coo(), want.to_coo(), "INT64")


def test_what_waits_is_not_stubbed(cpu):
    """Every algorithm of the JAX package is ported: ``bfs_parent`` (the
    positional ring ``min_secondi``) runs as there."""
    assert talg.__all__ == ["bfs_level", "bfs_parent",
                            "connected_components", "pagerank", "sssp",
                            "triangle_count"]
    assert sorted(talg.__all__) == sorted(jalg.__all__)
    r, c = [0, 0, 1, 2, 4], [1, 2, 3, 3, 5]
    jA, tA = both_matrices(r, c, np.ones(len(r), np.float32), "FP32", 6)
    assert_values_match(talg.bfs_parent(tA).to_coo(),
                        jalg.bfs_parent(jA).to_coo(), "INT64")


# --------------------------------------------------------------------- #
# pagerank and triangle_count, sparse-backed and dense-backed
# Zachary's karate club (the networkx edge list, 0-based, each edge once):
# 34 nodes, 78 edges, 45 triangles
KARATE = {0: [1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 17, 19, 21, 31],
          1: [2, 3, 7, 13, 17, 19, 21, 30], 2: [3, 7, 8, 9, 13, 27, 28, 32],
          3: [7, 12, 13], 4: [6, 10], 5: [6, 10, 16], 6: [16], 8: [30, 32, 33],
          9: [33], 13: [33], 14: [32, 33], 15: [32, 33], 18: [32, 33],
          19: [33], 20: [32, 33], 22: [32, 33], 23: [25, 27, 29, 32, 33],
          24: [25, 27, 31], 25: [31], 26: [29, 33], 27: [33], 28: [31, 33],
          29: [32, 33], 30: [32, 33], 31: [32, 33], 32: [33]}


def graph_of(name):
    """(src, dst, n) of the karate club or a small zipf graph."""
    if name == "karate":
        src = np.array([a for a, bs in KARATE.items() for _ in bs])
        dst = np.array([b for bs in KARATE.values() for b in bs])
        return src, dst, 34
    src, dst = bench.build_graph(300, 4)
    return src, dst, 300


def triangles_ref(src, dst, n):
    A = np.zeros((n, n))
    A[src, dst] = A[dst, src] = 1
    np.fill_diagonal(A, 0)
    return int(round(np.trace(A @ A @ A) / 6))


def both_graphs(name, dtype, sparse):
    src, dst, n = graph_of(name)
    limit = 0 if sparse else 1 << 22
    out = []
    for gb in (gbj, gbt):
        with gb.config.set(auto_sparse_limit=limit):
            out.append(gb.Matrix.from_coo(src, dst, 1, dtype=dtype, nrows=n,
                                          ncols=n))
    assert (out[1]._sparse is not None) == sparse
    return out, (src, dst, n)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("name", ["karate", "zipf"])
def test_triangle_count(name, sparse):
    with gbt.config.set(device="cpu"):
        (jA, tA), (src, dst, n) = both_graphs(name, "BOOL", sparse)
        got = talg.triangle_count(tA)
    assert got == jalg.triangle_count(jA) == triangles_ref(src, dst, n)
    if name == "karate":
        assert got == 45


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("name", ["karate", "zipf"])
def test_pagerank(name, sparse):
    """FP64 ranks to rel 1e-12 of the largest, the same iteration count."""
    with gbt.config.set(device="cpu"):
        (jA, tA), _ = both_graphs(name, "FP32", sparse)
        got, it = talg.pagerank(tA)
    want, jit = jalg.pagerank(jA)
    assert got.dtype.name == want.dtype.name == "FP64"
    assert it == jit and 2 < it < 100
    gi, gv = got.to_coo()
    wi, wv = want.to_coo()
    assert np.array_equal(gi, wi)
    assert np.abs(gv - wv).max() <= 1e-12 * np.abs(wv).max()
    assert abs(gv.sum() - 1.0) < 1e-9


def test_nothing_densifies():
    """With dense_limit=0 any densify of a matrix raises OutOfMemory: every
    operation of pagerank and triangle_count runs on sparse-backed
    matrices and matches the JAX package."""
    src, dst, n = graph_of("karate")
    res = {}
    for gb in (gbj, gbt):
        with gb.config.set(auto_sparse_limit=0), \
                gbt.config.set(device="cpu", dense_limit=0):
            A = gb.Matrix.from_coo(src, dst, 2.5, dtype="FP32", nrows=n,
                                   ncols=n)
            A64 = A.dup(dtype="FP64")
            I64 = A.apply(gb.unary.one).new(dtype="INT64")
            S = I64.dup()
            S(accum=gb.binary.max) << A.T.new(dtype="INT64").apply(
                gb.unary.one)
            L = S.select(gb.select.tril, -1).new()
            C = gb.Matrix("INT64", n, n)
            C(L.S) << L.mxm(L.T, gb.semiring.plus_pair)
            x = gb.Vector.from_dense(np.arange(n, dtype=np.float64))
            inv = A64.reduce_rowwise(gb.monoid.plus).new().apply(
                gb.unary.minv).new()
            res[gb] = [
                A.apply(gb.binary.times, right=2.0).new(),
                L, A.T.new(), S, C,
                A.ewise_add(A.T, gb.binary.plus).new(),
                A.ewise_mult(A.T, gb.binary.times).new(),
                A.ewise_union(A.T, gb.binary.minus, 0.0, 0.0).new(),
                x.vxm(A64, gb.semiring.plus_times).new(),
                A64.mxv(x, gb.semiring.plus_times).new(),
                I64.reduce_rowwise(gb.monoid.plus).new(),
                inv.diag().mxm(A64, gb.semiring.plus_times).new(),
                S.mxm(S, gb.semiring.plus_times).new(),
            ]
            res[gb].append(C.reduce_scalar(gb.monoid.plus,
                                           allow_empty=False).new().value)
            if gb is gbt:
                assert all(m._sparse is not None for m in res[gb][:8])
                assert talg.triangle_count(A) == 45
                rank, _ = talg.pagerank(A)
                assert abs(rank.reduce().new().value - 1.0) < 1e-9
    assert res[gbt][-1] == res[gbj][-1] == 45
    for got, want in zip(res[gbt][:-1], res[gbj][:-1]):
        assert got.dtype.name == want.dtype.name
        g, w = got.to_coo(), want.to_coo()
        for a, b in zip(g[:-1], w[:-1]):
            assert np.array_equal(a, b)
        assert np.allclose(g[-1], w[-1], rtol=1e-12, atol=0)


# --------------------------------------------------------------------- #
# connected_components (FastSV: min_second hooking, f[parents] shortcut)
def components_ref(src, dst, n):
    """scipy's weakly connected components, each labelled by its smallest
    vertex id."""
    import scipy.sparse as sps
    from scipy.sparse.csgraph import connected_components

    G = sps.coo_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    _, lab = connected_components(G, directed=True, connection="weak")
    smallest = np.full(lab.max() + 1, n)
    np.minimum.at(smallest, lab, np.arange(n))
    return smallest[lab]


def components_graph(name):
    if name == "zipf":
        src, dst = bench.build_graph(2000, 8)
        return src, dst, 2000
    rng = np.random.default_rng(7)  # 1500 nodes, 600 edges: many pieces
    n = 1500
    return rng.integers(0, n, 600), rng.integers(0, n, 600), n


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("name", ["zipf", "forest"])
def test_connected_components(name, sparse):
    src, dst, n = components_graph(name)
    ref = components_ref(src, dst, n)
    limit = 0 if sparse else 1 << 22
    with gbt.config.set(device="cpu", auto_sparse_limit=limit):
        tA = gbt.Matrix.from_coo(src, dst, 1, dtype="BOOL", nrows=n,
                                 ncols=n, dup_op="lor")
        assert (tA._sparse is not None) == sparse
        got = talg.connected_components(tA)
    with gbj.config.set(auto_sparse_limit=limit):
        jA = gbj.Matrix.from_coo(src, dst, 1, dtype="BOOL", nrows=n, ncols=n,
                                 dup_op=gbj.binary.lor)
        want = jalg.connected_components(jA)
    assert got.dtype.name == want.dtype.name == "INT64"
    gi, gv = got.to_coo()
    wi, wv = want.to_coo()
    assert np.array_equal(gi, wi) and np.array_equal(gi, np.arange(n))
    assert np.array_equal(gv, wv) and np.array_equal(gv, ref)
    if name == "forest":
        assert len(np.unique(ref)) == 900  # many isolated and small ones
