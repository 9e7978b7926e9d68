"""``graphblas_tpu_torch.parallel`` against ``graphblas_tpu.parallel``.

The port runs on a mesh of 8 ``cpu`` blocks, the JAX package on its 8
virtual CPU devices (tests/conftest.py), on the same numpy inputs from a
seed.  Each JAX call of a distributed path compiles a ``shard_map`` (up to
25 s), so the JAX package runs once per path in the module fixture
``jax_runs`` (the blocked arrays, a row reduce, the masked SpGEMM with B
replicated and with B sharded, the mask redistribution, extract, and the
Recorder lines of the five distributed dispatches); every other case is
held against the port's own unsharded result, which the other port tests
hold against the JAX package.  tests/test_torch_parallel_rings.py holds
``dist_mxv_ring`` against the JAX package (its fourth case runs here).

Each block of a vxm/mxv runs the sort pipeline unless a test asks for the
lanepipe (fixture ``lanepipe``): on the CPU a lanepipe call costs a fixed
~0.08 s a block (its plain kernels work on whole 128 x 128 tiles) and its
plan ~0.35 s, which eight blocks multiply.

Tolerances: structure, BOOL and integer values, triangle counts and
extracts exact; FP32 sums to rel 1e-5 (the blocks' partials fold in
another order).  On a 1-block mesh every result is bitwise equal to the
unsharded call.
"""

import collections

import numpy as np
import pytest
import torch

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt
from graphblas_tpu_torch.core.engine import lanepipe as tlp
from graphblas_tpu_torch.parallel import (
    P,
    dist_bfs_step,
    dist_pagerank_step,
    ewise_blocked,
    make_blocked_csr,
    make_mesh,
    replicate,
    shard_matrix,
    shard_vector,
)

from .test_torch_parallel_rings import CASES, check_ring

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 64


@pytest.fixture(autouse=True)
def sparse_cpu(request, monkeypatch):
    """The CPU, every Matrix sparse-backed, and the port's SpMV on the sort
    pipeline unless the test takes the fixture ``lanepipe``."""
    if "lanepipe" not in request.fixturenames:
        monkeypatch.setattr(tlp, "PACK_LIMIT", -1e9)
    with gbt.config.set(device="cpu", auto_sparse_limit=0), \
            gbj.config.set(auto_sparse_limit=0):
        yield


@pytest.fixture
def lanepipe():
    """Leave the lanepipe on (see sparse_cpu)."""


def mesh8():
    return make_mesh((8,), ("i",), devices=[CPU] * 8)


def graph(seed, n=N, e=600, lower=False):
    """Distinct off-diagonal coordinates (the JAX tests' _r4_graph)."""
    rng = np.random.default_rng(seed)
    lin = np.unique(rng.integers(0, n * n, e))
    r, c = lin // n, lin % n
    keep = (r > c) if lower else (r != c)
    return r[keep], c[keep]


def values(dtype, k, seed):
    rng = np.random.default_rng(seed)
    if dtype == "BOOL":
        return rng.random(k) < 0.7
    if dtype.startswith("INT"):
        return rng.integers(-20, 21, k).astype(np.int64)
    return rng.random(k).astype(np.float32)


def pair(r, c, v, dtype, n=N, gb=gbt):
    """Two equal matrices of one package: one to shard, one to keep."""
    return tuple(gb.Matrix.from_coo(r, c, v, dtype=dtype, nrows=n, ncols=n)
                 for _ in range(2))


def same(got, want, rel=None):
    """A port result against another's: type, structure and values
    (bitwise where rel is None)."""
    assert got.dtype.name == want.dtype.name
    g, w = got.to_coo(), want.to_coo()
    for a, b in zip(g[:-1], w[:-1]):
        np.testing.assert_array_equal(a, b)
    if rel is None:
        np.testing.assert_array_equal(g[-1], w[-1])
    else:
        np.testing.assert_allclose(g[-1], w[-1], rtol=rel, atol=0)


def rel_of(dtype):
    return 1e-5 if dtype in ("FP32", "FP64") else None


# --------------------------------------------------------------------- #
# the JAX package, once per distributed path
@pytest.fixture(scope="module")
def jax_runs():
    from graphblas_tpu.parallel import make_blocked_csr as jblocked
    from graphblas_tpu.parallel import make_mesh as jmesh
    from graphblas_tpu.parallel import shard_matrix as jshard

    out = {}
    mesh = jmesh((8,), ("i",))
    with gbj.config.set(auto_sparse_limit=0):
        r, c = graph(1, n=61)
        v = values("FP32", len(r), 2)
        out["blocked"] = jblocked((r, c, v, 61), mesh)
        A, _ = pair(r, c, v, "FP32", n=61, gb=gbj)
        jshard(A, mesh)
        with gbj.Recorder() as rec:
            out["rowwise"] = A.reduce_rowwise(gbj.monoid.plus).new()
            out["extract"] = A[np.arange(5, 40), np.arange(0, 61, 2)].new()
            x = gbj.Vector.from_dense(np.ones(61, np.float32))
            A.mxv(x, gbj.semiring.ss.min_firsti).new()
        out["rec_a"] = rec.data
        r, c = graph(3, e=800, lower=True)
        L, L2 = pair(r, c, np.ones(len(r), np.float32), "FP32", gb=gbj)
        jshard(L, mesh)
        ring = gbj.semiring.plus_pair["FP32"]
        with gbj.Recorder() as rec:
            C = gbj.Matrix(gbj.dtypes.FP32, N, N)
            C(L.S) << L.mxm(L.T, ring)
            out["tri_sharded"] = C
            C = gbj.Matrix(gbj.dtypes.FP32, N, N)
            C(L.S) << L.mxm(L2.T, ring)
            out["tri_replicated"] = C
        out["rec_tri"] = rec.data
        r, c = graph(4, n=48, e=500)
        v = values("FP32", len(r), 5)
        A, _ = pair(r, c, v, "FP32", n=48, gb=gbj)
        M, _ = pair(r[::2], c[::2], np.ones(len(r[::2]), bool), "BOOL", n=48,
                    gb=gbj)
        jshard(A, mesh)
        with gbj.Recorder() as rec:
            C = gbj.Matrix(gbj.dtypes.FP32, 48, 48)
            C(M.S) << A.mxm(A, gbj.semiring.plus_times["FP32"])
            out["redistributed"] = C
            A.mxm(A.T, gbj.semiring.plus_times["FP32"]).new()
        out["rec_mask"] = rec.data
    return out


def test_blocked_csr_matches_jax(jax_runs):
    """n padded to the block count, rows_per, nnz, and each block's (local
    row, col, value) entries equal the JAX arrays where edge_ok holds."""
    jb = jax_runs["blocked"]
    r, c = graph(1, n=61)
    v = values("FP32", len(r), 2)
    for src in ((r, c, v, 61), pair(r, c, v, "FP32", n=61)[0]):
        tb = make_blocked_csr(src, mesh8())
        assert (tb.n, tb.rows_per, tb.n_blocks, tb.nnz) == \
            (jb.n, jb.rows_per, jb.n_blocks, jb.nnz) == (64, 8, 8, len(r))
        ok = np.asarray(jb.edge_ok)
        for b, blk in enumerate(tb.blocks):
            assert (blk.nrows, blk.ncols) == (8, 64)
            assert blk.device == CPU
            np.testing.assert_array_equal(blk.rows.numpy(),
                                          np.asarray(jb.rowids)[b][ok[b]])
            np.testing.assert_array_equal(blk.cols.numpy(),
                                          np.asarray(jb.cols)[b][ok[b]])
            np.testing.assert_array_equal(blk.vals.numpy(),
                                          np.asarray(jb.vals)[b][ok[b]])


def test_reduce_rowwise_matches_jax(jax_runs):
    r, c = graph(1, n=61)
    A, _ = pair(r, c, values("FP32", len(r), 2), "FP32", n=61)
    shard_matrix(A, mesh8())
    got = A.reduce_rowwise(gbt.monoid.plus).new()
    want = jax_runs["rowwise"]
    g, w = got.to_coo(), want.to_coo()
    np.testing.assert_array_equal(g[0], w[0])
    np.testing.assert_allclose(g[1], w[1], rtol=1e-5, atol=0)


def test_extract_matches_jax(jax_runs):
    r, c = graph(1, n=61)
    A, A2 = pair(r, c, values("FP32", len(r), 2), "FP32", n=61)
    shard_matrix(A, mesh8())
    got = A[np.arange(5, 40), np.arange(0, 61, 2)].new()
    assert got._sparse is not None
    same(got, jax_runs["extract"])
    same(got, A2[np.arange(5, 40), np.arange(0, 61, 2)].new())


@pytest.mark.parametrize("b_side", ["sharded", "replicated"])
def test_triangle_count_matches_jax(jax_runs, b_side):
    """C(L.S) << plus_pair(L @ L.T) with L over 8 blocks: the rotation
    (B is L, sharded) and the replicated B (an unsharded copy); the count
    and C exactly the JAX package's and the unsharded call's."""
    r, c = graph(3, e=800, lower=True)
    L, L2 = pair(r, c, np.ones(len(r), np.float32), "FP32")
    shard_matrix(L, mesh8())
    ring = gbt.semiring.plus_pair["FP32"]
    C = gbt.Matrix(gbt.dtypes.FP32, N, N)
    C(L.S) << L.mxm((L if b_side == "sharded" else L2).T, ring)
    want = jax_runs[f"tri_{b_side}"]
    same(C, want)
    assert C.reduce_scalar(gbt.monoid.plus).new().value == \
        want.reduce_scalar(gbj.monoid.plus).new().value
    C2 = gbt.Matrix(gbt.dtypes.FP32, N, N)
    C2(L2.S) << L2.mxm(L2.T, ring)
    same(C, C2)


def test_mask_redistribution_matches_jax(jax_runs):
    """An unsharded mask is given A's row blocks (and keeps them)."""
    r, c = graph(4, n=48, e=500)
    v = values("FP32", len(r), 5)
    A, A2 = pair(r, c, v, "FP32", n=48)
    M, M2 = pair(r[::2], c[::2], np.ones(len(r[::2]), bool), "BOOL", n=48)
    shard_matrix(A, mesh8())
    C = gbt.Matrix(gbt.dtypes.FP32, 48, 48)
    C(M.S) << A.mxm(A, gbt.semiring.plus_times["FP32"])
    assert M._dist is not None and M._dist.mesh is A._dist.mesh
    same(C, jax_runs["redistributed"], rel=1e-5)
    C2 = gbt.Matrix(gbt.dtypes.FP32, 48, 48)
    C2(M2.S) << A2.mxm(A2, gbt.semiring.plus_times["FP32"])
    same(C, C2, rel=1e-5)


def test_recorder_lines_match_jax(jax_runs):
    """The five lines the distributed dispatch writes (positional
    fallback, extract, rotation, mask redistribution, single-device
    SpGEMM fallback), with the operations' own, word for word and in the
    JAX package's order."""
    mesh = mesh8()
    r, c = graph(1, n=61)
    A, _ = pair(r, c, values("FP32", len(r), 2), "FP32", n=61)
    shard_matrix(A, mesh)
    with gbt.Recorder() as rec:
        A.reduce_rowwise(gbt.monoid.plus).new()
        A[np.arange(5, 40), np.arange(0, 61, 2)].new()
        x = gbt.Vector.from_dense(np.ones(61, np.float32))
        A.mxv(x, gbt.semiring.ss.min_firsti).new()
    assert rec.data == jax_runs["rec_a"]
    r, c = graph(3, e=800, lower=True)
    L, L2 = pair(r, c, np.ones(len(r), np.float32), "FP32")
    shard_matrix(L, mesh)
    ring = gbt.semiring.plus_pair["FP32"]
    with gbt.Recorder() as rec:
        C = gbt.Matrix(gbt.dtypes.FP32, N, N)
        C(L.S) << L.mxm(L.T, ring)
        C = gbt.Matrix(gbt.dtypes.FP32, N, N)
        C(L.S) << L.mxm(L2.T, ring)
    assert rec.data == jax_runs["rec_tri"]
    r, c = graph(4, n=48, e=500)
    A, _ = pair(r, c, values("FP32", len(r), 5), "FP32", n=48)
    M, _ = pair(r[::2], c[::2], np.ones(len(r[::2]), bool), "BOOL", n=48)
    shard_matrix(A, mesh)
    with gbt.Recorder() as rec:
        C = gbt.Matrix(gbt.dtypes.FP32, 48, 48)
        C(M.S) << A.mxm(A, gbt.semiring.plus_times["FP32"])
        A.mxm(A.T, gbt.semiring.plus_times["FP32"]).new()
    assert rec.data == jax_runs["rec_mask"]
    lines = rec.data + jax_runs["rec_a"] + jax_runs["rec_tri"]
    for line in ("mxv fallback: single-device (positional semiring "
                 "min_firsti)",
                 "extract distributed over the row blocks",
                 "mxm distributed: sharded-B rotation SpGEMM",
                 "mxm mask redistributed to the distributed row blocks",
                 "mxm fallback: single-device SpGEMM (mask=no, at=False)"):
        assert line in lines


def test_dist_mxv_ring_max_first_matches_jax(monkeypatch):
    """dist_mxv_ring's fourth case against the JAX package (see
    tests/test_torch_parallel_rings.py)."""
    check_ring(monkeypatch, *CASES[3])


# --------------------------------------------------------------------- #
# the port on 8 blocks against the port unsharded
RINGS = [("plus_times", "FP32"), ("min_plus", "FP32"),
         ("max_first", "INT64"), ("lor_land", "BOOL")]


@pytest.mark.parametrize("ring_name,dtype", RINGS)
@pytest.mark.parametrize("kind", ["mxv", "vxm"])
@pytest.mark.parametrize("at", [False, True])
def test_mxv_vxm_through_the_api(ring_name, dtype, kind, at):
    """mxv/vxm of a sharded matrix (n = 61: padded to 64) against the
    unsharded call, both directions of contraction."""
    r, c = graph(5, n=61)
    A, A2 = pair(r, c, values(dtype, len(r), 6), dtype, n=61)
    shard_matrix(A, mesh8())
    ring = getattr(gbt.semiring, ring_name)[dtype]
    x = gbt.Vector.from_dense(values(dtype, 61, 7))
    if kind == "mxv":
        got = (A.T if at else A).mxv(x, ring).new()
        want = (A2.T if at else A2).mxv(x, ring).new()
    else:
        got = x.vxm(A.T if at else A, ring).new()
        want = x.vxm(A2.T if at else A2, ring).new()
    same(got, want, rel=rel_of(dtype))


def test_blocks_keep_their_plans(lanepipe):
    """Each block runs the lanepipe on a plan built once and kept in the
    block's store; a second vxm builds none."""
    r, c = graph(5)
    A, A2 = pair(r, c, values("FP32", len(r), 6), "FP32")
    shard_matrix(A, mesh8())
    ring = gbt.semiring.plus_times["FP32"]
    x = gbt.Vector.from_dense(values("FP32", N, 7))
    first = x.vxm(A, ring).new()
    plans = [dict(blk._lanepipe_plans) for blk in A._dist.blocks]
    assert all(p and all(e is not None for e in p.values()) for p in plans)
    second = x.vxm(A, ring).new()
    for blk, before in zip(A._dist.blocks, plans):
        assert blk._lanepipe_plans.keys() == before.keys()
        assert all(blk._lanepipe_plans[k] is before[k] for k in before)
    same(first, second)
    same(first, x.vxm(A2, ring).new(), rel=1e-5)


def test_sparse_u_and_empty_blocks(lanepipe):
    """A sparse u (the lanepipe's sparse-vector branch on each block) and
    a matrix whose rows lie in two of the eight blocks."""
    rng = np.random.default_rng(8)
    r = rng.integers(40, 56, 120)
    c = rng.integers(0, N, 120)
    lin = np.unique(r * N + c)
    r, c = lin // N, lin % N
    A, A2 = pair(r, c, values("FP32", len(r), 9), "FP32")
    shard_matrix(A, mesh8())
    assert [blk.nvals() for blk in A._dist.blocks][:5] == [0] * 5
    ring = gbt.semiring.min_plus["FP32"]
    u = gbt.Vector.from_coo([3, 41, 50], [0.5, 1.0, 2.0], size=N)
    for got, want in ((u.vxm(A, ring), u.vxm(A2, ring)),
                      (A.mxv(u, ring), A2.mxv(u, ring))):
        same(got.new(), want.new(), rel=1e-5)
    assert all(p is not None for blk in A._dist.blocks[5:]
               for p in blk._lanepipe_plans.values())


def _bfs_levels(r, c, n, src=0):
    lev = np.zeros(n, np.int32)
    lev[src] = 1
    adj = collections.defaultdict(list)
    for a, b in zip(r, c):
        adj[a].append(b)
    q = collections.deque([src])
    while q:
        u = q.popleft()
        for w in adj[u]:
            if lev[w] == 0 and w != src:
                lev[w] = lev[u] + 1
                q.append(w)
    return lev


def test_dist_bfs_and_pagerank_steps():
    """dist_bfs_step and dist_pagerank_step loops on global tensors (n =
    61, padded to 64) against a numpy BFS and power iteration (the JAX
    tests' oracles)."""
    n = 61
    r, c = graph(6, n=n, e=500)
    r, c = np.concatenate([r, c]), np.concatenate([c, r])
    lin = np.unique(r * n + c)
    r, c = lin // n, lin % n
    blocked = make_blocked_csr((r, c, np.ones(len(r), np.float32), n),
                               mesh8())
    m = blocked.n
    frontier = torch.zeros(m, dtype=torch.bool)
    frontier[0] = True
    visited = torch.zeros(m, dtype=torch.bool)
    levels = torch.zeros(m, dtype=torch.int32)
    d = 0
    while True:
        d += 1
        frontier, visited, levels, more = dist_bfs_step(
            blocked, frontier, visited, levels, d)
        if not bool(more) or d > n:
            break
    np.testing.assert_array_equal(levels[:n].numpy(), _bfs_levels(r, c, n))
    assert not levels[n:].any()
    outdeg = np.bincount(r, minlength=m).astype(np.float32)
    inv = torch.from_numpy(np.where(outdeg > 0, 1 / np.maximum(outdeg, 1),
                                    0).astype(np.float32))
    rank = torch.full((m,), 1.0 / n)
    for _ in range(20):
        rank = dist_pagerank_step(blocked, rank, inv, 0.85, 0.15 / n)
    P_ = np.zeros((n, n))
    P_[r, c] = 1
    deg = P_.sum(axis=1)
    x = np.full(n, 1.0 / n)
    for _ in range(20):
        x = 0.85 * ((x / np.maximum(deg, 1)) @ P_) + 0.15 / n
    np.testing.assert_allclose(rank[:n].numpy(), x, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["FP32", "INT64", "BOOL"])
@pytest.mark.parametrize("how", ["rowwise", "columnwise", "T.rowwise",
                                 "scalar"])
def test_reduces_through_the_api(dtype, how):
    r, c = graph(7, n=61)
    A, A2 = pair(r, c, values(dtype, len(r), 8), dtype, n=61)
    shard_matrix(A, mesh8())
    monoids = ["lor", "land"] if dtype == "BOOL" else \
        ["plus", "min", "max", "times"]
    for mono in monoids:
        op = getattr(gbt.monoid, mono)
        if how == "scalar":
            got = A.reduce_scalar(op).new().value
            want = A2.reduce_scalar(op).new().value
            if rel_of(dtype):
                np.testing.assert_allclose(got, want, rtol=1e-5)
            else:
                assert got == want
            continue
        f = {"rowwise": lambda M: M.reduce_rowwise(op),
             "columnwise": lambda M: M.reduce_columnwise(op),
             "T.rowwise": lambda M: M.T.reduce_rowwise(op)}[how]
        rel = None if mono in ("min", "max") else rel_of(dtype)
        same(f(A).new(), f(A2).new(), rel=rel)


def test_udt_and_complex_partials_fold():
    """The fold of full-width partials for the monoids without a
    collective of their own: a user-defined type's monoid and FC64 plus,
    column reduces over 8 blocks against the unsharded ones."""
    r, c = graph(9)
    rng = np.random.default_rng(10)
    z = rng.random(len(r)) + 1j * rng.random(len(r))
    A, A2 = pair(r, c, z, "FC64")
    shard_matrix(A, mesh8())
    same(A.reduce_columnwise(gbt.monoid.plus).new(),
         A2.reduce_columnwise(gbt.monoid.plus).new(), rel=1e-12)
    # fields of its own: the registry holds one type per numpy dtype, and
    # test_torch_pickle.py loads a ("x", "y") type under its own name
    pt = gbt.dtypes.register_anonymous(
        np.dtype([("px", "f8"), ("py", "f8")]), "pt_parallel")
    v = np.zeros(len(r), pt.np_type)
    v["px"] = rng.integers(-9, 10, len(r))
    v["py"] = rng.integers(-9, 10, len(r))
    P_, P2 = (gbt.Matrix.from_coo(r, c, v, dtype=pt, nrows=N, ncols=N)
              for _ in range(2))
    shard_matrix(P_, mesh8())
    add = gbt.binary.register_anonymous(
        lambda a, b: {"px": a["px"] + b["px"], "py": a["py"] + b["py"]},
        is_udt=True)
    mono = gbt.monoid.register_anonymous(add, 0.0)
    got = P_.reduce_columnwise(mono).new()
    want = P2.reduce_columnwise(mono).new()
    gi, gv = got.to_coo()
    wi, wv = want.to_coo()
    np.testing.assert_array_equal(gi, wi)
    assert gv.tobytes() == wv.tobytes()


@pytest.mark.parametrize("rows,cols", [
    (np.arange(5, 40), np.arange(0, 64, 2)),
    (np.arange(10, 50), slice(None)),
    ([40, 3, 17, 9, 63], [5, 1, 60, 0, 33]),
])
def test_extract_over_the_row_blocks(rows, cols):
    r, c = graph(11, e=900)
    A, A2 = pair(r, c, values("FP32", len(r), 12), "FP32")
    shard_matrix(A, mesh8())
    with gbt.Recorder() as rec:
        got = A[rows, cols].new()
    assert "extract distributed over the row blocks" in rec.data
    same(got, A2[rows, cols].new())


@pytest.mark.parametrize("pred,thunk", [("valuegt", 0.5), ("triu", 0),
                                        ("rowle", 30), ("tril", -3)])
def test_select_keeps_the_row_blocks(pred, thunk):
    """A positional predicate sees global row ids; the blocks of the
    result are each block's select, and drive a distributed reduce."""
    r, c = graph(13)
    A, A2 = pair(r, c, values("FP32", len(r), 14), "FP32")
    shard_matrix(A, mesh8())
    op = getattr(gbt.select, pred)
    B = A.select(op, thunk).new()
    want = A2.select(op, thunk).new()
    same(B, want)
    assert B._dist is not None and B._dist.nnz == want.nvals
    rows = np.concatenate([blk.rows.numpy() + b * 8
                           for b, blk in enumerate(B._dist.blocks)])
    np.testing.assert_array_equal(rows, want.to_coo()[0])
    np.testing.assert_allclose(B.reduce_scalar(gbt.monoid.plus).new().value,
                               want.reduce_scalar(gbt.monoid.plus).new().value,
                               rtol=1e-5)
    same(B.reduce_columnwise(gbt.monoid.max).new(),
         want.reduce_columnwise(gbt.monoid.max).new())


@pytest.mark.parametrize("op", ["ainv", "abs", "minv"])
def test_apply_keeps_the_row_blocks(op):
    r, c = graph(15)
    A, A2 = pair(r, c, values("FP32", len(r), 16), "FP32")
    shard_matrix(A, mesh8())
    u = getattr(gbt.unary, op)
    B = A.apply(u).new()
    want = A2.apply(u).new()
    same(B, want)
    assert B._dist is not None and B._dist.dtype == B.dtype
    np.testing.assert_allclose(B.reduce_scalar(gbt.monoid.plus).new().value,
                               want.reduce_scalar(gbt.monoid.plus).new().value,
                               rtol=1e-5)
    C = A.apply(gbt.unary.ss.positioni).new()
    assert C._dist is None


@pytest.mark.parametrize("variant", ["mult", "add"])
def test_ewise_blocked(variant):
    r, c = graph(17, e=500)
    A, A2 = pair(r, c, values("FP32", len(r), 18), "FP32")
    B = gbt.Matrix(gbt.dtypes.FP32, N, N)
    B << A.apply(gbt.binary.times, right=np.float32(2.0))
    mesh = mesh8()
    shard_matrix(A, mesh)
    shard_matrix(B, mesh)
    C = ewise_blocked(A, B, gbt.binary.plus, variant=variant, name="C")
    assert C._dist is not None and C.name == "C"
    want = A2.ewise_mult(B, gbt.binary.plus).new()
    same(C, want)
    got = C.reduce_scalar(gbt.monoid.plus).new().value
    np.testing.assert_allclose(
        got, want.reduce_scalar(gbt.monoid.plus).new().value, rtol=1e-5)
    vals = np.concatenate([blk.vals.numpy() for blk in C._dist.blocks])
    np.testing.assert_array_equal(vals, want.to_coo()[2])
    D = pair(r, c, values("FP32", len(r), 18), "FP32")[0]  # equal
    shard_matrix(D, mesh)  # coordinates, another Structure object
    with pytest.raises(ValueError, match="identical structure"):
        ewise_blocked(A, D, gbt.binary.plus)
    with pytest.raises(ValueError, match="shard_matrix"):
        ewise_blocked(A, A2, gbt.binary.plus)


def test_2d_mesh():
    """A (4, 2) mesh: row blocks over the first axis on devices[b, 0], no
    replica over the second."""
    r, c = graph(19)
    A, A2 = pair(r, c, values("FP32", len(r), 20), "FP32")
    mesh = make_mesh((4, 2), ("i", "j"), devices=[CPU] * 8)
    assert mesh.shape == collections.OrderedDict([("i", 4), ("j", 2)])
    shard_matrix(A, mesh)
    assert A._dist.n_blocks == 4 and A._dist.rows_per == 16
    assert A._dist.devices == [mesh.devices[b, 0] for b in range(4)]
    x = gbt.Vector.from_dense(values("FP32", N, 21))
    ring = gbt.semiring.plus_times["FP32"]
    same(A.mxv(x, ring).new(), A2.mxv(x, ring).new(), rel=1e-5)
    same(A.reduce_columnwise(gbt.monoid.plus).new(),
         A2.reduce_columnwise(gbt.monoid.plus).new(), rel=1e-5)
    jb = make_blocked_csr(A2, mesh, axis="j")
    assert (jb.n_blocks, jb.rows_per) == (2, 32)


@pytest.mark.parametrize("dtype", ["FP32", "INT64"])
def test_masked_spgemm_over_blocks(dtype):
    """plus_times masked products with B replicated and B sharded, value
    and structure masks, against the unsharded call."""
    r, c = graph(22, e=700)
    A, A2 = pair(r, c, values(dtype, len(r), 23), dtype)
    B, B2 = pair(c, r, values(dtype, len(r), 24), dtype)
    M, M2 = pair(r[::3], c[::3], np.arange(len(r[::3])) % 3 > 0, "BOOL")
    mesh = mesh8()
    shard_matrix(A, mesh)
    shard_matrix(M, mesh)
    ring = gbt.semiring.plus_times[dtype]
    for structure in (True, False):
        for b_sharded in (False, True):
            if b_sharded:
                shard_matrix(B, mesh)
            mask, mask2 = (M.S, M2.S) if structure else (M.V, M2.V)
            for bt in (False, True):
                C = gbt.Matrix(ring.return_type, N, N)
                C(mask) << A.mxm(B.T if bt else B, ring)
                C2 = gbt.Matrix(ring.return_type, N, N)
                C2(mask2) << A2.mxm(B2.T if bt else B2, ring)
                same(C, C2, rel=rel_of(dtype))
    C = gbt.Matrix(ring.return_type, N, N)
    with gbt.Recorder() as rec:
        C(~M.S) << A.mxm(B, ring)
    assert "mxm fallback: single-device SpGEMM (mask=yes, at=False)" in \
        rec.data


def test_store_writes_drop_the_row_blocks():
    r, c = graph(25)
    A, A2 = pair(r, c, values("FP32", len(r), 26), "FP32")
    mesh = mesh8()
    shard_matrix(A, mesh)
    A._densify()  # a change of representation keeps them
    assert A._dist is not None and A._sparse is None
    shard_matrix(A2, mesh)
    A2 << A2.apply(gbt.unary.ainv)
    assert A2._dist is None
    B = A2.dup()
    shard_matrix(B, mesh)
    B[0, 1] = 5.0
    assert B._dist is None
    B = A2.dup()
    shard_matrix(B, mesh)
    B.clear()
    assert B._dist is None


def test_one_block_is_bitwise_the_unsharded_call(lanepipe):
    """On a 1-block mesh the block is the matrix's own store (its plans
    shared), and every distributed result equals the unsharded call bit
    for bit."""
    mesh = make_mesh((1,), devices=[CPU])
    r, c = graph(27, e=900)
    v = values("FP32", len(r), 28)
    A, A2 = pair(r, c, v, "FP32")
    shard_matrix(A, mesh)
    assert A._dist.blocks[0] is A._sparse
    ring = gbt.semiring.plus_times["FP32"]
    rank = gbt.Vector.from_dense(np.full(N, 1.0 / N, np.float32))
    rank2 = rank.dup()
    for _ in range(10):
        rank = rank.vxm(A, ring).new()
        rank2 = rank2.vxm(A2, ring).new()
    same(rank, rank2)
    x = gbt.Vector.from_dense(values("FP32", N, 29))
    for f in (lambda M: M.mxv(x, gbt.semiring.min_plus["FP32"]),
              lambda M: x.vxm(M.T, ring),
              lambda M: M.reduce_rowwise(gbt.monoid.plus),
              lambda M: M.reduce_columnwise(gbt.monoid.plus),
              lambda M: M.select("triu"),
              lambda M: M.apply(gbt.unary.ainv),
              lambda M: M[np.arange(3, 50), np.arange(0, 64, 3)]):
        same(f(A).new(), f(A2).new())
    assert A.reduce_scalar(gbt.monoid.plus).new().value == \
        A2.reduce_scalar(gbt.monoid.plus).new().value
    lr, lc = graph(30, e=900, lower=True)
    L, L2 = pair(lr, lc, np.ones(len(lr), np.float32), "FP32")
    shard_matrix(L, mesh)
    tri = gbt.semiring.plus_pair["FP32"]
    C = gbt.Matrix(gbt.dtypes.FP32, N, N)
    C(L.S) << L.mxm(L.T, tri)
    C2 = gbt.Matrix(gbt.dtypes.FP32, N, N)
    C2(L2.S) << L2.mxm(L2.T, tri)
    same(C, C2)


def test_mesh_and_placement():
    """make_mesh defaults to the configured device; P; a dense-backed
    matrix and a vector are placed whole on the first device, and a
    sharded dimension must divide evenly (the JAX package's ValueError)."""
    mesh = make_mesh()
    assert mesh.devices.shape == (1,) and mesh.devices[0] == CPU
    assert mesh.axis_names == ("i",) and mesh.shape["i"] == 1
    assert make_mesh((2, 4), devices=["cpu"] * 8).axis_names == ("i", "j")
    with pytest.raises(ValueError):
        make_mesh((8,))
    mesh = mesh8()
    assert P("i", None) == ("i", None) and P() == ()
    D = gbt.Matrix.from_dense(np.arange(256, dtype=np.float64).reshape(16,
                                                                       16))
    D2 = D.dup()
    assert shard_matrix(D, mesh) is D and D._sparse is None
    same(D.mxm(D).new(), D2.mxm(D2).new())
    with pytest.raises(ValueError, match="divisible by 8"):
        shard_matrix(gbt.Matrix.from_dense(np.ones((10, 10))), mesh)
    with pytest.raises(ValueError, match="divisible by 8"):
        shard_vector(gbt.Vector.from_dense(np.ones(10)), mesh)
    v = replicate(gbt.Vector.from_dense(np.ones(10)), mesh)
    assert v.device == CPU and v.nvals == 10
    shard_matrix(gbt.Matrix.from_dense(np.ones((10, 16))), mesh, P(None, "i"))
    with gbt.config.set(auto_sparse_limit=1 << 22):
        with pytest.raises(ValueError, match="square"):
            make_blocked_csr(gbt.Matrix.from_coo([0], [1], [1.0], nrows=3,
                                                 ncols=4), mesh)


def test_public_names():
    """gb.parallel has every name of graphblas_tpu.parallel.__all__, and
    ewise_blocked."""
    import graphblas_tpu.parallel as jpar

    names = set(jpar.__all__) | {"ewise_blocked"}
    assert names <= set(dir(gbt.parallel))
    assert names <= set(gbt.parallel.__all__)
    assert "parallel" in gbt.__all__


def test_dryrun_multichip():
    """The counterpart of __graft_entry__.dryrun_multichip: one sharded BFS
    and PageRank step, then through the library a masked BFS step
    (lor_land), an SSSP relaxation (min_plus with accum=min), the row
    reduce, reduce_scalar and the triangle kernel on 8 blocks, each
    against the same calls unsharded."""
    n_devices = 8
    n = 16 * n_devices
    rng = np.random.default_rng(1)
    r = rng.integers(0, n, n * 4)
    c = rng.integers(0, n, n * 4)
    keep = r != c
    r2 = np.concatenate([r[keep], c[keep]])
    c2 = np.concatenate([c[keep], r[keep]])
    lin = np.unique(r2 * n + c2)
    r2, c2 = lin // n, lin % n
    v2 = np.ones(len(r2), np.float32)
    mesh = make_mesh((n_devices,), ("i",), devices=[CPU] * n_devices)
    blocked = make_blocked_csr((r2, c2, v2, n), mesh)
    frontier = torch.zeros(n, dtype=torch.bool)
    frontier[0] = True
    f, _, _, more = dist_bfs_step(blocked, frontier,
                                  torch.zeros(n, dtype=torch.bool),
                                  torch.zeros(n, dtype=torch.int32), 1)
    assert bool(more)
    np.testing.assert_array_equal(np.flatnonzero(f.numpy()),
                                  np.unique(c2[r2 == 0]))
    outdeg = np.bincount(r2, minlength=n).astype(np.float32)
    inv = torch.from_numpy(1 / np.maximum(outdeg, 1))
    rank = dist_pagerank_step(blocked, torch.full((n,), 1.0 / n), inv,
                              0.85, 0.15 / n)
    assert abs(float(rank.sum()) - 1.0) < 1e-3

    def flow(sharded):
        A = gbt.Matrix.from_coo(r2, c2, v2, dtype="FP32", nrows=n, ncols=n)
        Ab = gbt.Matrix.from_coo(r2, c2, np.ones(len(r2), bool), nrows=n,
                                 ncols=n)
        low = r2 > c2
        L = gbt.Matrix.from_coo(r2[low], c2[low], 1.0, dtype="FP32", nrows=n,
                                ncols=n)
        if sharded:
            for M in (A, Ab, L):
                shard_matrix(M, mesh)
            assert A._dist is not None and Ab._dist is not None
        q = gbt.Vector.from_coo([0], [True], size=n)
        lev = gbt.Vector(gbt.dtypes.INT64, n)
        lev(mask=q.V)[:] = 1
        q(~lev.S, replace=True) << q.vxm(Ab, gbt.semiring.lor_land[bool])
        dist = gbt.Vector.from_coo([0], [0.0], size=n, dtype="FP32")
        dist(accum=gbt.binary.min) << dist.vxm(A,
                                               gbt.semiring.min_plus["FP32"])
        deg = A.reduce_rowwise(gbt.monoid.plus).new()
        tot = A.reduce_scalar(gbt.monoid.plus).new()
        C = gbt.Matrix(gbt.dtypes.FP32, n, n)
        C(L.S) << L.mxm(L.T, gbt.semiring.plus_pair["FP32"])
        return q, dist, deg, tot.value, C

    got, want = flow(True), flow(False)
    for g, w in zip(got, want):
        if isinstance(g, (gbt.Vector, gbt.Matrix)):
            same(g, w, rel=1e-5)
        else:
            assert g == w
