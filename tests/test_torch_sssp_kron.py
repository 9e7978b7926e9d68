"""GAP SSSP on the benchmark's weighted Kronecker graph, on the CPU.

The port's ``algorithms.sssp`` against the benchmark's plain reference
(``gbbench/reference/sssp.py``) on kron graphs drawn by ``gbbench.gen``
from the ``kron20w`` configuration at scales 9-12 (INT32 weights in
[1, 255]); the reference against a heap Dijkstra; the ``kron20w.sssp``
cell run whole through ``gbbench.harness`` at scale 10, sound, and its
check and control; and the spans and counters the cell's
per-layer metrics read (``lanepipe:sparse``, ``lanepipe:tail``,
``sssp:round``, ``trace.counts["lanepipe.sparse_calls"]`` and
``["lanepipe.tail_calls"]``).
"""

import collections
import heapq
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import graphblas_tpu_torch as gb
from gbbench import control, gen, harness, spec
from gbbench.devtrace import Trace
from gbbench.reference import sssp as ref_sssp
from graphblas_tpu_torch.core import trace
from graphblas_tpu_torch.core.engine import lanepipe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "kron20w.sssp"
METRICS = ("sssp.rounds", "lanepipe.sparse_ms", "lanepipe.tail_ms",
           "sssp.syncs_per_round")


@pytest.fixture
def cpu():
    with gb.config.set(device="cpu", auto_sparse_limit=0):
        yield


def kron(scale, seed=None):
    """The cell's graph at ``scale``, or, with ``seed``, the graph that
    seed draws in place of the configuration's fixed one."""
    cfg = dict(spec.cell(CELL)[1], scale=scale)
    if seed is not None:
        del cfg["graph_seed"]
    return gen.build(cfg, seed, "cpu")


def matrix(g):
    return gb.Matrix.from_coo(g.rows.numpy(), g.cols.numpy(),
                              g.values.numpy(), dtype=g.dtype, nrows=g.n,
                              ncols=g.n)


def sources(g, seed):
    """The hub, an isolated vertex and three vertices drawn from ``seed``
    among those with a neighbour."""
    deg = torch.bincount(g.rows, minlength=g.n).numpy()
    isolated = np.flatnonzero(deg == 0)
    assert isolated.size, "a kron graph has isolated vertices"
    drawn = np.random.default_rng(seed).choice(np.flatnonzero(deg > 0), 3,
                                               replace=False)
    return [int(deg.argmax()), int(isolated[0])] + [int(s) for s in drawn]


def added(before):
    return {k: trace.counts[k] - before.get(k, 0)
            for k in ("lanepipe.sparse_calls", "lanepipe.tail_calls")}


@pytest.mark.parametrize("split", [None, 64])
@pytest.mark.parametrize("scale", [9, 10, 11, 12])
def test_sssp_is_the_reference_on_kron(cpu, monkeypatch, scale, split):
    """Every distance equal, through the lanepipe's sparse-vector branch
    every round; with destinations split at ``split`` entries the hubs
    take the two-level tail, which no destination under 2048 does."""
    if split is not None:
        monkeypatch.setattr(lanepipe, "SPLIT_DEG", split)
    g = kron(scale)
    A = matrix(g)
    for src in sources(g, scale):
        before = dict(trace.counts)
        got = gb.algorithms.sssp(A, src).to_dense(fill_value=-1)
        want = ref_sssp.distances(g.rows, g.cols, g.values, g.n, src)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got.astype(np.int64), want.numpy())
        calls = added(before)
        assert calls["lanepipe.sparse_calls"] >= 1
        assert calls["lanepipe.tail_calls"] == (
            calls["lanepipe.sparse_calls"] if split else 0)
    (entry,) = A._sparse._lanepipe_plans.values()
    assert entry is not None and entry["two_level"] == bool(split)


def dijkstra(rows, cols, weights, n, source):
    adj = collections.defaultdict(list)
    for r, c, w in zip(rows.tolist(), cols.tolist(), weights.tolist()):
        adj[r].append((c, w))
    dist = [-1] * n
    heap = [(0, source)]
    while heap:
        d, v = heapq.heappop(heap)
        if dist[v] >= 0:
            continue
        dist[v] = d
        for c, w in adj[v]:
            if dist[c] < 0:
                heapq.heappush(heap, (d + w, c))
    return dist


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_is_dijkstra(seed):
    rng = np.random.default_rng(seed)
    n = 200
    r, c = rng.integers(0, n, (2, 600))
    rows, cols = gen.symmetrize(torch.from_numpy(r), torch.from_numpy(c), n)
    w = torch.from_numpy(rng.integers(1, 256, rows.numel())).to(torch.int32)
    g = kron(7, seed)
    for rows_, cols_, w_, n_ in ((rows, cols, w, n),
                                 (g.rows, g.cols, g.values, g.n)):
        for src in (0, int(rows_[0]), int(rows_[-1])):
            got = ref_sssp.distances(rows_, cols_, w_, n_, src)
            assert got.dtype == torch.int64
            assert got.tolist() == dijkstra(rows_, cols_, w_, n_, src)


_RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
import graphblas_tpu_torch as gb
from gbbench import harness, spec
full = spec.traffic
spec.traffic = lambda name: dict(full(name), warmup_trials=4, trace_trials=2)
cfg = dict(spec.cell({cell!r})[1], scale=10)
with gb.config.set(device="cpu", auto_sparse_limit=0):
    result, checks, notes = harness.run({cell!r}, 2**31 + 99, 0.3, {trace},
                                        time.perf_counter(), device="cpu",
                                        config=cfg)
print(json.dumps(result))
"""


@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_on_the_port(traced):
    """The whole run at scale 10, with 4 warm-up and 2 traced trials in
    place of the traffic's 64 and 16 (each call of the port's plain
    kernels costs about 0.3 s of this CPU), in a process of its own: this
    one has the JAX package loaded, and a run refuses to report beside
    it."""
    code = _RUN.format(root=ROOT, cell=CELL, trace=traced)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result is not None, "the run loaded a module it may not load"
    assert result["correct"] and result["failed"] == 0
    assert result["checks"] == {"dist_mismatches": {"value": 0, "limit": 0}}
    assert result["attempted"] >= 1
    names = set(result["metrics"])
    if traced:
        # the span readers read on any device; the device-trace ones only
        # on a card, so a CPU run leaves them out
        assert {"sssp.rounds", "sssp.syncs_per_round"} <= names
        assert names <= set(METRICS)
        assert 2 <= result["metrics"]["sssp.rounds"]["value"] <= 30
        # each round reads u_valid.all() and isequal on the host
        assert result["metrics"]["sssp.syncs_per_round"]["value"] >= 2
    else:
        assert {"setup_s", "trial_ms", "trial_ms_p95"} <= names


def _plus_one(orig):
    def broken(A, source=0):
        d = orig(A, source)
        d[(source + 1) % A.nrows] = 1
        return d
    return broken


def _no_accumulate(orig):
    def broken(A, source=0):  # d << d.vxm(A): each round forgets the last
        d = gb.Vector(A.dtype, A.nrows)
        d[source] = 0
        for _ in range(16):
            nxt = d.vxm(A, gb.semiring.min_plus).new()
            if nxt.isequal(d):
                break
            d = nxt
        return d
    return broken


def _two_rounds(orig):
    return lambda A, source=0: orig(A, source, max_iters=2)


@pytest.mark.parametrize("fault", [None, _plus_one, _no_accumulate,
                                   _two_rounds])
def test_check_fails_a_broken_sssp(cpu, monkeypatch, fault):
    """The driver's trials through the port and its check, as a run
    makes them: sound, every trial passes; with ``algorithms.sssp``
    broken underneath, every trial fails (a run is then not correct)."""
    if fault is not None:
        monkeypatch.setattr(gb.algorithms, "sssp",
                            fault(gb.algorithms.sssp))
    _, cfg, trf, _, _ = spec.cell(CELL)
    drv = spec.driver(trf["driver"])
    g = kron(10)
    A = matrix(g)
    state = drv.prepare(g, trf, 2**31 + 5)
    assert len(state["sources"]) == trf["sources"] == 64
    kept = [(i, drv.trial(gb, A, state, i)) for i in (0, 1, 65)]
    checks, failed = drv.check(g, state, kept, "cpu")
    mismatches = checks["dist_mismatches"]
    assert mismatches["limit"] == 0
    if fault is None:
        assert failed == 0 and mismatches["value"] == 0
    else:
        assert failed == 3 and mismatches["value"] > 0


def test_control_fails():
    checks, failed = control.readings(
        CELL, 7, 4, "cpu", dict(spec.cell(CELL)[1], scale=10))
    assert failed == 4 and checks["dist_mismatches"]["value"] > 0


def test_cell_pieces_found_by_name():
    """Every piece of the cell comes from its name: the traffic file, its
    driver, the configuration and the metric readers."""
    work, cfg, trf, e2e, per_layer = spec.cell(CELL)
    assert (work["config"], work["traffic"], work["chips"]) == \
        ("kron20w", "sssp", 1)
    assert cfg["values"] == {"dtype": "INT32", "low": 1, "high": 255}
    assert {"undirected", "sssp"} <= set(cfg["guarantees"])
    # kron18's graph (tc's) at scale 20, one graph for every run
    kron18 = spec.config("kron18")
    for key in ("generator", "degree", "initiator", "values"):
        assert cfg[key] == kron18[key]
    assert cfg["scale"] == 20 and cfg["reduced"]["scale"]["published"] == 27
    assert "graph_seed" in cfg and "graph_seed" not in kron18
    drv = spec.driver(trf["driver"])
    for fn in ("prepare", "trial", "check", "control"):
        assert callable(getattr(drv, fn))
    assert {m["name"] for m in e2e} == {"setup_s", "trial_ms",
                                        "trial_ms_p95", "peak_mem_gib"}
    assert {m["name"] for m in per_layer} == set(METRICS)
    for m in e2e + per_layer:
        assert callable(spec.metric(m["name"]).read)


def _ev(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def test_device_readers():
    """The device ms launched inside ``lanepipe:sparse`` (the tail
    included) and inside ``lanepipe:tail``, per traced trial; nothing
    where the program opens no such range, as a program without them
    does."""
    tr = Trace([
        _ev("user_annotation", "gbbench.trial", 0, 200),
        _ev("user_annotation", "lanepipe:sparse", 10, 100),
        _ev("user_annotation", "lanepipe:tail", 60, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 5, 1, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 1, 2),
        _ev("cuda_runtime", "cudaLaunchKernel", 65, 1, 3),
        _ev("kernel", "outside", 6, 4, 1),
        _ev("kernel", "lane_segscan_kernel", 30, 10, 2),
        _ev("kernel", "where", 70, 6, 3),
    ])
    run = harness.Run(cuda=True, trace=tr, traced_trials=2)
    assert spec.metric("lanepipe.sparse_ms").read(run) == \
        pytest.approx(16e-3 / 2)
    assert spec.metric("lanepipe.tail_ms").read(run) == \
        pytest.approx(6e-3 / 2)
    bare = harness.Run(cuda=True, trace=Trace([
        _ev("user_annotation", "gbbench.trial", 0, 200),
        _ev("user_annotation", "gb.sync:x", 10, 5)]), traced_trials=2)
    for name in METRICS:
        assert spec.metric(name).read(bare) is None
        assert spec.metric(name).read(harness.Run(cuda=True)) is None


def events(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events()
            if e.name.startswith(("gb.", "lanepipe:", "sssp:"))]


def inside(inner, outer):
    return outer.time_range.start <= inner.time_range.start and \
        inner.time_range.end <= outer.time_range.end


def test_sssp_spans(cpu, monkeypatch):
    monkeypatch.setattr(lanepipe, "SPLIT_DEG", 64)
    g = kron(10)
    A = matrix(g)
    src = sources(g, 1)[0]
    gb.algorithms.sssp(A, src)  # the plan, outside the profile
    evs = events(lambda: gb.algorithms.sssp(A, src))
    by = collections.defaultdict(list)
    for e in evs:
        by[e.name].append(e)
    (algo,) = by["gb.algo:sssp"]
    rounds, sparse, tails = (by["sssp:round"], by["lanepipe:sparse"],
                             by["lanepipe:tail"])
    # a vxm a round, each through the sparse-vector branch and its tail
    # (two tails: the values' and the validity's)
    assert len(rounds) >= 2
    assert len(sparse) == len(rounds) == len(by["gb.engine:lanepipe"])
    assert len(tails) == 2 * len(sparse)
    assert all(inside(r, algo) for r in rounds)
    assert all(any(inside(s, r) for r in rounds) for s in sparse)
    assert all(any(inside(s, e) for e in by["gb.engine:lanepipe"])
               for s in sparse)
    assert all(any(inside(t, s) for s in sparse) for t in tails)
    syncs = [e for e in evs if e.name.startswith("gb.sync:")]
    assert sum(e.name == "gb.sync:lanepipe.u_valid_all" for e in syncs) \
        == len(rounds)


def test_bfs_opens_no_lanepipe_range(cpu):
    """A BOOL ``bfs_level`` takes the packed branch, and on a graph with
    no destination over SPLIT_DEG no tail: neither range opens, and
    neither counter moves."""
    g = kron(10)
    A = gb.Matrix.from_coo(g.rows.numpy(), g.cols.numpy(), True,
                           dtype="BOOL", nrows=g.n, ncols=g.n)
    src = sources(g, 2)[0]
    gb.algorithms.bfs_level(A, src)
    before = dict(trace.counts)
    names = collections.Counter(e.name for e in events(
        lambda: gb.algorithms.bfs_level(A, src)))
    assert names["gb.engine:lanepipe"] >= 2
    assert not [n for n in names if n.startswith("lanepipe:")]
    assert added(before) == {"lanepipe.sparse_calls": 0,
                             "lanepipe.tail_calls": 0}
