"""Sort-pipeline engine of the PyTorch port against the JAX package's.

Kernel level: the port's plain version of K6 (the flat multi-channel
``segscan``) against ``_segscan_pallas`` in interpret mode (the
``_INTERPRET`` hook of tests/test_sortpipe.py) and against
``_segscan_xla``, on segments longer than two (256,128) blocks, with the
``first``, integer ``plus`` and monoid combines.  Plan level: every array
of ``build_plan_device`` equal to the JAX package's.  Pipeline level:
``spmv_pipeline`` and ``reduce_pipeline`` on identical plan arrays (handed
over with ``sortpipe.plan_from_numpy``) over the semiring grid of
tests/test_lanepipe.py, and the public API (row/column reduce, a vxm whose
matrix packs over PACK_LIMIT).  Structure, BOOL and integers must match
exactly; FP32 is held to rel 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt
from graphblas_tpu.core.engine import sortpipe as jsp
from graphblas_tpu_torch.core import dtypes as tdt
from graphblas_tpu_torch.core.engine import sortpipe as tsp

from .test_lanepipe import SEMIRINGS, random_graph
from .test_torch_lanepipe import (CARRIER, assert_values_match, both_matrices,
                                  both_vectors, rand_values)

torch.set_num_threads(1)


@pytest.fixture
def cpu():
    """The CPU, and every Matrix sparse-backed: these tests hold the SpMV
    engines, which a matrix under ``auto_sparse_limit`` would bypass."""
    with gbt.config.set(device="cpu", auto_sparse_limit=0):
        yield


def sequential_scan(barrier, vals, fn):
    out = np.empty_like(vals)
    acc = vals[0]
    for i in range(len(vals)):
        acc = vals[i] if (barrier[i] or i == 0) else fn(acc, vals[i])
        out[i] = acc
    return out


# --------------------------------------------------------------------- #
# K6's plain version against the Pallas kernel and the XLA scan
def scan_inputs(L, seed=7):
    rng = np.random.default_rng(seed)
    barrier = (rng.random(L) < 0.001).astype(np.int32)
    barrier[0] = 1
    barrier[L // 8:L * 3 // 4] = 0  # at 2**17: more than two 32768-blocks
    return rng, barrier


def port_combine(name, dtype):
    if name == "first":
        return tsp.FIRST
    if name == "count":
        return tsp.COUNT
    return tsp.monoid_combine(getattr(gbt.monoid, name)[dtype])


def jax_combine(name, dtype):
    if name == "first":
        return lambda a, b: a
    if name == "count":
        return lambda a, b: a + b
    comb = jsp.monoid_scan_fn(name, CARRIER[dtype])

    def fn(a, b):
        r = comb(a, b)
        return r.astype(a.dtype) if r.dtype != a.dtype else r

    return fn


def scan_values(rng, L, dtype):
    if dtype == "FP32":
        return rng.random(L).astype(np.float32)
    if dtype == "BOOL":
        return (rng.random(L) < 0.5).astype(np.int32)
    return rng.integers(0, 100, L).astype(CARRIER[dtype])


SCAN_PAIRS = [
    (("first", "FP32"), ("first", "INT32")),    # the fill of spmv_pipeline
    (("plus", "FP32"), ("count", "INT32")),     # the reduce pair
    (("min", "FP32"), ("count", "INT32")),
    (("plus", "INT32"), ("count", "INT32")),
    (("max", "UINT32"), ("first", "INT32")),
    (("lor", "BOOL"), ("count", "INT32")),      # BOOL rides as int32 0/1
    (("land", "BOOL"), ("count", "INT32")),
]


# XLA takes tens of seconds to compile an associative scan over `first`;
# the Pallas kernel covers those pairs
SCAN_CASES = [("pallas", p, "random") for p in SCAN_PAIRS] + [
    ("xla", p, "random") for p in SCAN_PAIRS
    if all(n != "first" for n, _ in p)]
# where the CUDA kernel's look-back is most exposed: one segment across
# all of its 4096-element tiles, barriers only at tile starts or only at
# tile ends, and four channels (one launch)
SCAN_CASES += [
    ("pallas", (("plus", "FP32"), ("count", "INT32")), "one segment"),
    ("pallas", (("first", "FP32"), ("first", "INT32")), "one segment"),
    ("pallas", (("plus", "FP32"), ("count", "INT32")), "tile starts"),
    ("pallas", (("min", "FP32"), ("count", "INT32")), "tile ends"),
    ("pallas", (("plus", "FP32"), ("first", "INT32"), ("max", "UINT32"),
                ("count", "INT32")), "random")]


def scan_case_id(ref, pair, layout):
    tag = "-".join([ref] + [n + d for n, d in pair])
    return tag if layout == "random" else f"{tag}-{layout.replace(' ', '_')}"


def layout_barrier(barrier, layout):
    T = tsp.SEG_BLOCK
    if layout == "random":
        return barrier
    b = np.zeros_like(barrier)
    if layout == "tile starts":
        b[::T] = 1
    elif layout == "tile ends":
        b[T - 1::T] = 1
    return b


@pytest.mark.parametrize("ref,pair,layout", SCAN_CASES,
                         ids=[scan_case_id(*c) for c in SCAN_CASES])
def test_segscan_plain_matches_jax(monkeypatch, pair, ref, layout):
    # Pallas: 4 grid blocks of 256*128; the XLA scan has no blocks, and its
    # compile time grows with L
    L = 1 << 17 if ref == "pallas" else 1 << 13
    rng, barrier = scan_inputs(L)
    barrier = layout_barrier(barrier, layout)
    vals = [scan_values(rng, L, dt) for _, dt in pair]
    jcomb = tuple(jax_combine(n, dt) for n, dt in pair)
    if ref == "pallas":
        monkeypatch.setattr(jsp, "_INTERPRET", True)
        with jax.enable_x64(False):
            want = jsp._segscan_pallas(jnp.asarray(barrier),
                                       [jnp.asarray(v) for v in vals], jcomb)
    else:
        want = jsp._segscan_xla(jnp.asarray(barrier),
                                [jnp.asarray(v) for v in vals], jcomb)
    tvals = [torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v)
             for v in vals]
    got = tsp.segscan(torch.from_numpy(barrier), tvals,
                      [port_combine(n, dt) for n, dt in pair])
    for g, w, (name, dt) in zip(got, want, pair):
        g, w = g.numpy(), np.asarray(w)
        if dt == "FP32" and name in ("plus", "times"):
            assert np.allclose(g, w, rtol=1e-5, atol=0)
        else:
            assert np.array_equal(g.view(np.int32), w.view(np.int32))


def test_segscan_plain_is_the_sequential_fold():
    """Against a Python loop, with element 0 unflagged: it starts a segment
    either way, and ``first`` keeps the left operand."""
    L = 5000
    rng = np.random.default_rng(3)
    barrier = (rng.random(L) < 0.01).astype(np.int32)
    barrier[0] = 0
    vi = rng.integers(0, 100, L).astype(np.int32)
    got = tsp.segscan(torch.from_numpy(barrier),
                      [torch.from_numpy(vi), torch.from_numpy(vi)],
                      [tsp.COUNT, tsp.FIRST])
    assert np.array_equal(got[0].numpy(),
                          sequential_scan(barrier, vi, lambda a, b: a + b))
    assert np.array_equal(got[1].numpy(),
                          sequential_scan(barrier, vi, lambda a, b: a))


# --------------------------------------------------------------------- #
# plan arrays
PLAN_NAMES = ("rank_m", "barrier_m", "merged_slot_of_d", "rank_back",
              "barrier_i", "ext_rank")


@pytest.mark.parametrize("dest_is_row", [True, False])
@pytest.mark.parametrize("n,e", [(300, 2000), (700, 900)])
def test_plan_arrays_equal(rng, dest_is_row, n, e):
    """build_plan_device on the JAX store's padded arrays (cap > nnz)."""
    r, c, v = random_graph(rng, n, e, "FP32")
    with gbj.config.set(auto_sparse_limit=0):
        jA = gbj.Matrix.from_coo(r, c, v, dtype="FP32", nrows=n, ncols=n + 5)
    sp = jA._sparse
    assert sp.cap > len(r)
    want = jsp.get_plan(sp, dest_is_row)["plan"]
    n_out, n_in = (n, n + 5) if dest_is_row else (n + 5, n)
    rows, cols, ok = (torch.from_numpy(np.array(a))
                      for a in (sp.rowids, sp.cols, sp.ok))
    # as the JAX package does, roles are swapped before the plan is built
    a, b = (rows, cols) if dest_is_row else (cols, rows)
    got = tsp.build_plan_device(a, b, ok, cap=sp.cap, n_out=n_out, n_in=n_in)
    assert set(got) == set(PLAN_NAMES)
    for name in PLAN_NAMES:
        assert got[name].dtype == torch.int32
        assert np.array_equal(got[name].numpy(), np.asarray(want[name])), name


def test_plan_entry_inverts_ranks(rng, cpu):
    """The cached entry keeps each permutation as its inverse, and of
    ext_rank exactly the first n_out sorted positions."""
    n = 400
    r, c, v = random_graph(rng, n, 1500, "FP32")
    tA = gbt.Matrix.from_coo(r, c, v, dtype="FP32", nrows=n, ncols=n)
    rows, cols = torch.from_numpy(r), torch.from_numpy(c)
    plan = tsp.build_plan_device(rows, cols, torch.ones(len(r), dtype=torch.bool),
                                 cap=len(r), n_out=n, n_in=n)
    entry = tsp.get_plan(tA._sparse, True, device="cpu")
    L = entry["L"]
    assert L == tsp._plan_len(n, n, len(r)) and L % tsp.SEG_BLOCK == 0
    x = torch.arange(L, dtype=torch.int32)
    for src, rank in (("src_m", "rank_m"), ("src_back", "rank_back")):
        moved, = tsp.sort_apply(entry[src], [x])
        assert np.array_equal(moved.numpy()[plan[rank].numpy()], x.numpy())
    order = np.argsort(plan["ext_rank"].numpy(), kind="stable")[:n]
    assert np.array_equal(entry["ext_src"].numpy(), order)
    assert tsp.get_plan(tA._sparse, True, device="cpu") is entry
    assert tsp.get_plan(tA._sparse, False, at=True, device="cpu") is entry


# --------------------------------------------------------------------- #
# pipelines on identical plan arrays
def both_entries(jA, dest_is_row, at=False):
    jentry = jsp.get_plan(jA._sparse, dest_is_row, at=at)
    tentry = tsp.plan_from_numpy(
        {k: np.asarray(v) for k, v in jentry["plan"].items()},
        np.asarray(jentry["vals_m"]), np.asarray(jentry["ok_m"]),
        jentry["n_in"], jentry["n_out"], "cpu")
    return jentry, tentry


def run_both_spmv(jA, jx, tx, jring, tring, kind, at=False):
    jentry, tentry = both_entries(jA, kind == "mxv", at=at)
    jv, jok = jx._vals, jx._valid
    wv, wok = jsp.spmv_pipeline(
        jsp.plan_dyn_tuple(jentry), jv, jok, jring, jA.dtype, jx.dtype,
        kind=kind, n_in=jentry["n_in"], n_out=jentry["n_out"], L=jentry["L"],
        a_np=None, out_np=None)
    gv, gok = tsp.spmv_pipeline(
        tsp.plan_dyn_tuple(tentry), tx._vals, tx._valid, tring,
        tring.binaryop.type, tx.dtype, kind=kind, n_in=tentry["n_in"],
        L=tentry["L"])
    wok = np.asarray(wok)
    gok = gok.numpy()
    idx = np.flatnonzero(wok)
    return ((np.flatnonzero(gok), tdt.to_numpy(gv, tring.monoid.type)[gok]),
            (idx, np.asarray(wv)[wok]))


@pytest.mark.parametrize("ring_name,dtype", SEMIRINGS)
@pytest.mark.parametrize("kind", ["mxv", "vxm"])
def test_spmv_pipeline_parity(rng, ring_name, dtype, kind, cpu):
    n = 300
    r, c, v = random_graph(rng, n, 2000, dtype)
    jA, _ = both_matrices(r, c, v, dtype, n)
    jx, tx = both_vectors(rand_values(rng, n, dtype), dtype)
    got, want = run_both_spmv(jA, jx, tx, getattr(gbj.semiring, ring_name)[dtype],
                              getattr(gbt.semiring, ring_name)[dtype], kind)
    assert_values_match(got, want, dtype)


@pytest.mark.parametrize("ring_name,dtype", [SEMIRINGS[0], SEMIRINGS[2],
                                             SEMIRINGS[4], SEMIRINGS[5]])
@pytest.mark.parametrize("at", [False, True])
def test_spmv_pipeline_sparse_u_transposed(rng, ring_name, dtype, at, cpu):
    """A sparse u leaves destinations empty; `at` swaps the plan's roles."""
    n = 300
    r, c, v = random_graph(rng, n, 2000, dtype)
    jA, _ = both_matrices(r, c, v, dtype, n)
    idx = np.sort(rng.choice(n, 40, replace=False))
    jx, tx = both_vectors(rand_values(rng, 40, dtype), dtype, idx, n)
    got, want = run_both_spmv(jA, jx, tx, getattr(gbj.semiring, ring_name)[dtype],
                              getattr(gbt.semiring, ring_name)[dtype], "mxv",
                              at=at)
    assert len(got[0]) < n
    assert_values_match(got, want, dtype)


REDUCES = [("plus", "FP32"), ("max", "FP32"), ("min", "INT32"),
           ("times", "INT32"), ("lor", "BOOL"), ("land", "BOOL"),
           ("bor", "UINT32")]


@pytest.mark.parametrize("mono_name,dtype", REDUCES)
@pytest.mark.parametrize("dest_is_row", [True, False])
def test_reduce_pipeline_parity(rng, mono_name, dtype, dest_is_row, cpu):
    n = 300
    r, c, v = random_graph(rng, n, 1200, dtype)
    if mono_name == "times":
        v = rng.integers(1, 4, len(r))
    jA, _ = both_matrices(r, c, v, dtype, n)
    jentry, tentry = both_entries(jA, dest_is_row)
    jmono = getattr(gbj.monoid, mono_name)[dtype]
    tmono = getattr(gbt.monoid, mono_name)[dtype]
    wv, wok = jsp.reduce_pipeline(jsp.plan_dyn_tuple(jentry), jmono, jA.dtype,
                                  n_out=n, L=jentry["L"])
    gv, gok = tsp.reduce_pipeline(tsp.plan_dyn_tuple(tentry), tmono,
                                  tmono.type)
    wok, gok = np.asarray(wok), gok.numpy()
    assert len(np.flatnonzero(wok)) < n  # some rows/columns are empty
    assert_values_match(
        (np.flatnonzero(gok), tdt.to_numpy(gv, tmono.type)[gok]),
        (np.flatnonzero(wok), np.asarray(wv)[wok]), dtype)


# --------------------------------------------------------------------- #
# through both public APIs
@pytest.mark.parametrize("mono_name,dtype", REDUCES[:5])
def test_reduce_rowwise_columnwise(rng, mono_name, dtype, cpu):
    n = 250
    r, c, v = random_graph(rng, n, 1000, dtype)
    jA, tA = both_matrices(r, c, v, dtype, n)
    jm, tm = getattr(gbj.monoid, mono_name), getattr(gbt.monoid, mono_name)
    for jexpr, texpr in (
            (jA.reduce_rowwise(jm), tA.reduce_rowwise(tm)),
            (jA.reduce_columnwise(jm), tA.reduce_columnwise(tm)),
            (jA.T.reduce_rowwise(jm), tA.T.reduce_rowwise(tm)),
            (jA.T.reduce_columnwise(jm), tA.T.reduce_columnwise(tm))):
        want, got = jexpr.new(), texpr.new()
        assert got.dtype.name == want.dtype.name
        assert got.nvals < n
        assert_values_match(got.to_coo(), want.to_coo(), dtype)
    assert set(tA._sparse._sortpipe_plans) == {
        (True, torch.device("cpu")), (False, torch.device("cpu"))}


def test_reduce_new_dtype_and_ineligible(rng, cpu):
    n = 100
    r, c, v = random_graph(rng, n, 400, "INT32")
    jA, tA = both_matrices(r, c, v, "INT32", n)
    want = jA.reduce_rowwise(gbj.monoid.plus).new(dtype="FP32")
    got = tA.reduce_rowwise("plus").new(dtype="FP32")
    assert got.dtype.name == "FP32"
    assert_values_match(got.to_coo(), want.to_coo(), "INT32")
    # FP64, which the sort pipeline declines, takes the generic reduce
    jA64, A64 = both_matrices(r, c, v.astype(np.float64), "FP64", n)
    got = A64.reduce_rowwise("plus").new()
    want = jA64.reduce_rowwise(gbj.monoid.plus).new()
    assert got.dtype.name == want.dtype.name == "FP64"
    assert not A64._sparse._sortpipe_plans
    assert_values_match(got.to_coo(), want.to_coo(), "INT32")
    empty = gbt.Matrix("FP32", 5, 7)
    assert empty.reduce_columnwise("plus").new().nvals == 0
    assert empty.reduce_columnwise("plus").new().size == 7


@pytest.mark.parametrize("sparse_u", [False, True])
def test_pack_limit_overflow_takes_sortpipe(monkeypatch, rng, cpu, sparse_u):
    """The n=2000 zipf graph at the default SPLIT_DEG packs over
    PACK_LIMIT: the port's vxm falls to its sort pipeline."""
    n = 2000
    src, dst = bench.build_graph(n, 8)
    w = rng.random(len(src)).astype(np.float32)
    jA, tA = both_matrices(src, dst, w, "FP32", n)
    calls = []
    orig = tsp.spmv_pipeline
    monkeypatch.setattr(tsp, "spmv_pipeline",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    xv = rng.random(n).astype(np.float32)
    if sparse_u:
        idx = np.sort(rng.choice(n, 300, replace=False))
        jx, tx = both_vectors(xv[idx], "FP32", idx, n)
    else:
        jx, tx = both_vectors(xv, "FP32")
    want = jx.vxm(jA, gbj.semiring.plus_times["FP32"]).new()
    got = tx.vxm(tA, gbt.semiring.plus_times["FP32"]).new()
    assert calls, "the port's sort pipeline was not used"
    assert tA._sparse._lanepipe_plans[(False, torch.device("cpu"))] is None
    assert_values_match(got.to_coo(), want.to_coo(), "FP32")
    # the BOOL twin through mxv, the other direction of the same fallback
    jB, tB = both_matrices(src, dst, np.ones(len(src), bool), "BOOL", n)
    jb, tb = both_vectors(rng.random(n) < 0.2, "BOOL")
    want = jB.mxv(jb, gbj.semiring.lor_land["BOOL"]).new()
    got = tB.mxv(tb, gbt.semiring.lor_land["BOOL"]).new()
    assert_values_match(got.to_coo(), want.to_coo(), "BOOL")
