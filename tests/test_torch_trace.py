"""The port's spans and counters (graphblas_tpu_torch/core/trace.py) on
the CPU: off the profiler a span is a flag check and nothing more; under
``torch.profiler`` the algorithms, the frontend's dispatches, the
engines and every host read open their ranges, nested as the layers
are; the host-plan counters move on a plan built and on nothing else.
``test_every_host_read_goes_through_trace_read`` catches, by a torch
function mode, each call that would wait for a card (a read, ``nonzero``
and its kin) made outside ``trace.read``."""

import collections
import sys
import weakref

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.profiler import ProfilerActivity, profile

import graphblas_tpu_torch as gb
from graphblas_tpu_torch.core import execute, trace
from graphblas_tpu_torch.core.engine import lanepipe


@pytest.fixture
def cpu():
    with gb.config.set(device="cpu", auto_sparse_limit=0):
        yield


def path(n, dtype="BOOL"):
    """The undirected path 0 - 1 - ... - n-1: BFS from 0 runs n levels."""
    r = np.arange(n - 1)
    return gb.Matrix.from_coo(np.r_[r, r + 1], np.r_[r + 1, r], 1,
                              dtype=dtype, nrows=n, ncols=n)


def random_graph(n, m, seed, dtype="FP32"):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, (2, m))
    keep = r != c
    key = np.unique(np.r_[r[keep] * n + c[keep], c[keep] * n + r[keep]])
    w = rng.integers(1, 9, key.size).astype(np.float32)
    return gb.Matrix.from_coo(key // n, key % n, w, dtype=dtype, nrows=n,
                              ncols=n)


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events()
            if e.name.startswith(("gb.", "spgemm:"))]


def interval(ev):
    return ev.time_range.start, ev.time_range.end


def inside(inner, outer):
    (s, e), (s0, e0) = interval(inner), interval(outer)
    return s0 <= s and e <= e0


def by_name(events):
    return collections.Counter(e.name for e in events)


# ---- off the profiler
def test_off_the_profiler_spans_are_the_shared_no_op(cpu, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered off the profiler")

    monkeypatch.setattr(trace, "_record", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)

    class NoFormat:
        def __format__(self, spec):
            raise AssertionError("a name built off the profiler")

    assert trace.span("gb.op:x") is trace._OFF
    assert trace.span(execute._SPGEMM_RANGE, NoFormat(), 1, 2, 3) \
        is trace._OFF
    assert trace.sync("x") is trace._OFF
    assert trace.read("x", lambda a, b=0: a + b, 1, b=2) == 3
    A = path(6)
    lev = gb.algorithms.bfs_level(A, 0)
    assert list(lev.to_dense(fill_value=0)) == [1, 2, 3, 4, 5, 6]
    G = random_graph(60, 300, 1)
    assert gb.algorithms.triangle_count(G) >= 0


def test_span_formats_its_name_only_when_on(cpu):
    def spans():
        with trace.span("gb.op:{}-{}", "a", 7), trace.sync("here"):
            pass

    assert by_name(profiled(spans)) == {"gb.op:a-7": 1, "gb.sync:here": 1}


# ---- under the profiler
@pytest.mark.parametrize("levels", [2, 5])
def test_bfs_level_spans(cpu, levels):
    A = path(levels)
    gb.algorithms.bfs_level(A, 0)  # the plan, outside the profile
    events = profiled(lambda: gb.algorithms.bfs_level(A, 0))
    names = by_name(events)
    algo = [e for e in events if e.name == "gb.algo:bfs_level"]
    assert len(algo) == 1
    for e in events:
        assert inside(e, algo[0]), e.name
    # one lanepipe vxm a level, inside the update that writes it
    assert names["gb.engine:lanepipe"] == levels
    updates = [e for e in events if e.name == "gb.op:update_into"]
    for e in events:
        if e.name == "gb.engine:lanepipe":
            assert any(inside(e, u) for u in updates)
    # a masked assign a level, and q[source] = True before the loop
    assert names["gb.op:assign_update"] == levels + 1
    assert names["gb.op:setitem"] == 1
    assert names["gb.op:value"] == levels
    # each level reads its lor reduce, the validity and then the value,
    # and uploads three constants: the level assigned and the monoid's
    # identity twice (the reduce's and allow_empty's); q[source] = True
    # uploads its value and its index and puts True in its region
    reads = ("gb.sync:scalar.is_empty", "gb.sync:dtypes.to_numpy")
    assert [names[r] for r in reads] == [levels, levels]
    assert names["gb.sync:scalar.value"] == levels + 1
    assert names["gb.sync:store.identity"] == 2 * levels
    assert names["gb.sync:execute.index"] == 1
    assert names["gb.sync:dense.scatter"] == 1
    assert sum(n.startswith("gb.sync:") for n in names.elements()) \
        == 5 * levels + 3
    values = [e for e in events if e.name == "gb.op:value"]
    for e in events:
        if e.name in reads:
            assert any(inside(e, v) for v in values)


def test_to_dense_reads_twice(cpu):
    A = path(4)
    lev = gb.algorithms.bfs_level(A, 0)
    names = by_name(profiled(lambda: lev.to_dense(fill_value=0)))
    assert names == {"gb.op:to_dense": 1, "gb.sync:vector.valid": 1,
                     "gb.sync:dtypes.to_numpy": 1}


def test_triangle_count_spans(cpu):
    G = random_graph(80, 500, 3)
    want = gb.algorithms.triangle_count(G)
    got = []
    events = profiled(lambda: got.append(gb.algorithms.triangle_count(G)))
    assert got == [want]
    names = by_name(events)
    assert names["gb.algo:triangle_count"] == 1
    ranges = [e for e in events if e.name.startswith("spgemm:")]
    assert len(ranges) == 1
    rec = execute.spgemm_record(ranges[0].name)
    assert rec["formulation"] == "dot" and rec["terms"] > 0
    assert rec["terms"] == rec["dot_terms"]
    engines = [e for e in events if e.name == "gb.engine:sparse"]
    assert any(inside(ranges[0], e) for e in engines)
    assert names["gb.sync:execute.spgemm_totals"] == 1
    assert names["gb.sync:sparse.masked_dot"] == 1


def test_engine_spans_by_route(cpu, monkeypatch):
    A = random_graph(200, 1500, 5)
    u = gb.Vector.from_dense(np.ones(200, np.float32))
    names = by_name(profiled(lambda: u.vxm(A, gb.semiring.min_plus).new()))
    assert names["gb.engine:lanepipe"] == 1
    assert names["gb.sync:lanepipe.u_valid_all"] == 1
    monkeypatch.setattr(lanepipe, "PACK_LIMIT", -1e9)
    B = random_graph(200, 1500, 6)
    names = by_name(profiled(lambda: u.vxm(B, gb.semiring.min_plus).new()))
    assert names["gb.engine:lanepipe"] == 1 and \
        names["gb.engine:sortpipe"] == 1
    names = by_name(profiled(lambda: u.vxm(B, gb.semiring.plus_times[
        "FP64"]).new()))
    assert names["gb.engine:sparse"] == 1
    D = gb.Matrix.from_dense(np.eye(4, dtype=np.float32))
    names = by_name(profiled(lambda: D.mxm(D, gb.semiring.min_plus).new()))
    assert names["gb.engine:dense"] >= 1 and names["gb.engine:tropical"] == 1


# ---- host-plan counters
def test_lanepipe_plan_counters(cpu, monkeypatch):
    monkeypatch.setattr(trace, "counts", collections.Counter())
    A = random_graph(300, 2000, 7, "BOOL")
    u = gb.Vector.from_dense(np.ones(300, bool))
    ring = gb.semiring.lor_land[bool]
    u.vxm(A, ring).new()
    c = dict(trace.counts)
    assert c["plan.build_s"] > c["plan.perm_s"] > 0
    (entry,) = A._sparse._lanepipe_plans.values()
    assert c["plan.bytes"] == trace.tensor_bytes(entry) > 0
    u.vxm(A, ring).new()  # a hit
    assert dict(trace.counts) == c


def test_truth_twin_adds_its_bytes(cpu, monkeypatch):
    monkeypatch.setattr(trace, "counts", collections.Counter())
    A = random_graph(300, 2000, 8)
    u = gb.Vector.from_dense(np.ones(300, np.float32))
    u.vxm(A, gb.semiring.lor_land["FP32"]).new()
    (entry,) = A._sparse._lanepipe_plans.values()
    assert entry["truth"]
    assert trace.counts["plan.bytes"] == trace.tensor_bytes(entry)


def test_sortpipe_plan_counters(cpu, monkeypatch):
    monkeypatch.setattr(trace, "counts", collections.Counter())
    A = random_graph(300, 2000, 9)
    A.reduce_rowwise(gb.monoid.plus).new()
    c = dict(trace.counts)
    (entry,) = A._sparse._sortpipe_plans.values()
    assert c["plan.build_s"] > 0 and "plan.perm_s" not in c
    assert c["plan.bytes"] == trace.tensor_bytes(entry) > 0
    A.reduce_rowwise(gb.monoid.plus).new()
    assert dict(trace.counts) == c


def test_tensor_bytes():
    t = torch.zeros(10, dtype=torch.int32)
    assert trace.tensor_bytes({"a": t, "b": (t, [t[:2]]), "c": 3}) == 88


# ---- every host read inside trace.read
T = torch.Tensor
_READS = {T.item, T.tolist, T.cpu, T.__bool__, T.__int__, T.__float__,
          T.__index__, T.nonzero, torch.nonzero, torch.unique, T.unique,
          torch.unique_consecutive, T.unique_consecutive, torch.masked_select,
          T.masked_select, torch.bincount, T.bincount, torch.argwhere,
          T.argwhere, torch.equal, torch.allclose, T.__contains__}


def _waits(func, args, kwargs):
    """Whether the call would wait for a card: a read, or an operation
    whose output size depends on the data."""
    if func in _READS:
        return True
    if func in (torch.repeat_interleave, T.repeat_interleave):
        reps = args[1] if len(args) > 1 else kwargs.get("repeats")
        return (len(args) == 1 and "repeats" not in kwargs) or (
            isinstance(reps, torch.Tensor) and reps.numel() > 1
            and kwargs.get("output_size") is None)
    if func is torch.where:
        return len(args) == 1
    if func in (T.__getitem__, T.__setitem__, T.index_put_):
        idx = args[1] if isinstance(args[1], (tuple, list)) else (args[1],)
        if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
               and i.ndim > 0 for i in idx):
            return True
        # t[index tensor] = a Python scalar: the value is copied to the
        # card before the put
        return func is T.__setitem__ and not isinstance(
            args[2], torch.Tensor) and any(
            isinstance(i, (torch.Tensor, list)) for i in idx)
    return False


_MADE = (torch.from_numpy, torch.tensor, torch.as_tensor, torch.asarray)


def _device_given(func, args, kwargs):
    """Whether a call places data on a device: ``t.to(device)``,
    ``t.to(other)``, ``torch.tensor(x, device=...)``."""
    if kwargs.get("device") is not None:
        return True
    return func is T.to and any(
        isinstance(a, (str, torch.device, torch.Tensor)) for a in args[1:])


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensors(x)


class _Reads(TorchFunctionMode):
    """Counts the calls outside trace.read that would wait for a card:
    the reads of _waits, and the uploads of host data (a blocking copy to
    a card synchronises its stream).  Host data is what torch.from_numpy,
    torch.tensor and torch.as_tensor make without a device, and what is
    computed from host data alone."""

    def __init__(self):
        super().__init__()
        self.outside = collections.Counter()
        self.host = {}

    def _is_host(self, t):
        ref = self.host.get(id(t))
        return ref is not None and ref() is t

    def _host_index(self, index):
        """An index of host data: a list, an array, a host tensor."""
        idx = index if isinstance(index, tuple) else (index,)
        return any(isinstance(i, (list, np.ndarray)) or (
            isinstance(i, torch.Tensor) and i.ndim > 0 and self._is_host(i))
            for i in idx)

    def _mark(self, out):
        for t in _tensors(out):
            self.host[id(t)] = weakref.ref(t)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = list(_tensors(list(args) + list(kwargs.values())))
        placed = _device_given(func, args, kwargs)
        upload = placed and (func in _MADE or (
            func is T.to and self._is_host(args[0]))) or (
            func is T.copy_ and self._is_host(args[1])
            and not self._is_host(args[0])) or (
            func in (T.__getitem__, T.__setitem__)
            and not self._is_host(args[0]) and self._host_index(args[1]))
        if upload or _waits(func, args, kwargs):
            site, through = None, False
            f = sys._getframe(1)
            while f is not None:
                through |= f.f_code is trace.read.__code__
                name = f.f_code.co_filename
                if site is None and "graphblas_tpu_torch" in name \
                        and not name.endswith("trace.py"):
                    site = f"{name.rsplit('graphblas_tpu_torch', 1)[1]}:" \
                           f"{f.f_lineno}"
                f = f.f_back
            if site is not None and not through:
                self.outside[f"{site} {func.__name__}"] += 1
        out = func(*args, **kwargs)
        if not placed and ((func in _MADE and not ins) or (
                ins and all(self._is_host(t) for t in ins))):
            self._mark(out)
        return out


_CALLS = {
    "bfs_level": lambda A: gb.algorithms.bfs_level(A, 3).to_dense(0),
    "bfs_parent": lambda A: gb.algorithms.bfs_parent(A, 3).to_dense(0),
    "sssp": lambda A: gb.algorithms.sssp(A, 3).to_dense(0),
    "pagerank": lambda A: gb.algorithms.pagerank(A),
    "triangle_count": lambda A: gb.algorithms.triangle_count(A),
    "connected_components":
        lambda A: gb.algorithms.connected_components(A).to_dense(),
    "reads": lambda A: (A.nvals, A.to_coo(), A.to_csc(), 3 in A[3, :].new(),
                        A.reduce_rowwise().new().to_coo(), A.isequal(A),
                        A.get(0, 1), A.select("tril").new().nvals),
}


@pytest.mark.parametrize("call", sorted(_CALLS))
def test_every_host_read_goes_through_trace_read(cpu, call):
    A = random_graph(300, 2000, 11, "BOOL" if call == "bfs_level"
                     else "FP32")
    _CALLS[call](A)  # plans built
    with _Reads() as reads:
        _CALLS[call](A)
    assert not reads.outside, dict(reads.outside)
