"""The interval arithmetic of ``gbbench/spans.py`` on hand-built traces,
each reader of the program's spans and counters on a fake run, and the
traced CPU runs of both cells reporting every metric that reads them."""

import collections
import types

import pytest

from gbbench import harness, spans, spec
from gbbench.devtrace import Trace

from .test_gbbench_runs import cpu_run

SPAN_METRICS = ("frontend.host_ms", "lanepipe.host_ms", "sync.count",
                "sync.wait_ms")
COUNTER_METRICS = ("plan.build_s", "plan.perm_s", "plan.gib")


def _ev(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _range(name, ts, dur):
    return _ev("user_annotation", name, ts, dur)


def test_merged_intersect_subtract():
    assert spans.merged([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert spans.intersect([(0, 10), (20, 30)], [(5, 25)]) == \
        [(5, 10), (20, 25)]
    assert spans.intersect([(0, 1)], [(2, 3)]) == []
    assert spans.subtract([(0, 10), (20, 30)], [(2, 4), (8, 22), (29, 40)]) \
        == [(0, 2), (4, 8), (22, 29)]
    assert spans.subtract([(0, 10)], []) == [(0, 10)]
    assert spans.subtract([(3, 4)], [(0, 10)]) == []


def trial_trace():
    """Two trials of 100 us.  The first: an algorithm's span (0-90) with
    nested same-prefix ops (10-60 holding 20-40), an engine (25-35)
    holding a sync (28-33), a second sync (70-80) and device work at
    30-32 and 82-84; 90-100 lies inside no span.  The second: one op
    (110-150) with an engine (120-140) and no sync."""
    return Trace([
        _range(harness.TRIAL_RANGE, 0, 100),
        _range("gb.algo:bfs_level", 0, 90),
        _range("gb.op:update_into", 10, 50),
        _range("gb.op:update_into", 20, 20),
        _range("gb.engine:lanepipe", 25, 10),
        _range("gb.sync:scalar.is_empty", 28, 5),
        _range("gb.sync:dtypes.to_numpy", 70, 10),
        _ev("kernel", "k", 30, 2, 1),
        _ev("kernel", "k", 82, 2, 2),
        _range(harness.TRIAL_RANGE, 100, 100),
        _range("gb.op:to_dense", 110, 40),
        _range("gb.engine:lanepipe", 120, 20),
        _range("gb.op:outside_any_trial", 300, 10),
    ])


def test_host_time_by_layer():
    tr = trial_trace()
    assert spans.trials(tr) == [(0, 200)]
    # inside algo/op, outside engine/sync: 0-25, 35-70, 80-90, 110-120,
    # 140-150
    assert spans.host_us(tr, ("gb.algo:", "gb.op:"),
                         ("gb.engine:", "gb.sync:")) == 90
    # the lanepipe less its sync: 25-28, 33-35; 120-140
    assert spans.host_us(tr, ("gb.engine:lanepipe",), ("gb.sync:",)) == 25
    assert spans.host_us(tr, ("gb.sync:",)) == 15
    assert spans.host_us(tr, ("gb.engine:sortpipe",)) is None
    assert len(spans.starts_in(tr, ("gb.sync:",))) == 2
    assert len(spans.starts_in(tr, ("gb.op:",))) == 3  # not the one at 300
    # the trials' time inside some gb. span: 0-90 and 110-150
    assert spans.host_us(tr, ("gb.",)) == 130


def test_idle_by_innermost_span():
    idle = spans.idle_by_span(trial_trace())
    # the trials touch, so they are one window, 0-200; the gaps 0-30,
    # 32-82 and 84-200 are cut at every range's edge
    assert idle == {"gb.algo:bfs_level": 10 + 10 + 2 + 6,
                    "gb.op:update_into": 10 + 5 + 5 + 20,
                    "gb.engine:lanepipe": 3 + 2 + 20,
                    "gb.sync:scalar.is_empty": 2 + 1,
                    "gb.sync:dtypes.to_numpy": 10,
                    "gb.op:to_dense": 10 + 10,
                    "none": 20 + 50}
    assert sum(idle.values()) == 200 - 4


def fake_run(trace=None, counts=None, trials=2):
    core = types.SimpleNamespace()
    if counts is not None:
        core.trace = types.SimpleNamespace(counts=collections.Counter(counts))
    return harness.Run(cuda=True, program=types.SimpleNamespace(core=core),
                       trace=trace, traced_trials=trials)


def test_span_readers_on_a_fake_run():
    r = fake_run(trial_trace())
    read = {m: spec.metric(m).read(r) for m in SPAN_METRICS}
    assert read == {"frontend.host_ms": pytest.approx(0.045),
                    "lanepipe.host_ms": pytest.approx(0.0125),
                    "sync.count": 1.0,
                    "sync.wait_ms": pytest.approx(0.0075)}


def test_span_readers_find_nothing_without_the_programs_spans():
    # the parent program: a trial, device work, no gb. range
    bare = Trace([_range(harness.TRIAL_RANGE, 0, 100),
                  _ev("kernel", "k", 30, 2, 1)])
    for m in SPAN_METRICS:
        assert spec.metric(m).read(fake_run(bare)) is None, m
        assert spec.metric(m).read(fake_run(None)) is None, m
    # the program's spans but no sync: a count of 0, a wait of 0
    no_sync = Trace([_range(harness.TRIAL_RANGE, 0, 100),
                     _range("gb.algo:triangle_count", 0, 90)])
    r = fake_run(no_sync)
    assert spec.metric("sync.count").read(r) == 0
    assert spec.metric("sync.wait_ms").read(r) == 0
    assert spec.metric("lanepipe.host_ms").read(r) is None


def test_counter_readers_on_a_fake_run():
    r = fake_run(counts={"plan.build_s": 61.5, "plan.perm_s": 30.25,
                         "plan.bytes": 3 * 2**29})
    assert spec.metric("plan.build_s").read(r) == 61.5
    assert spec.metric("plan.perm_s").read(r) == 30.25
    assert spec.metric("plan.gib").read(r) == 1.5
    for m in COUNTER_METRICS:  # no plan built; a program without counters
        assert spec.metric(m).read(fake_run(counts={})) is None, m
        assert spec.metric(m).read(fake_run()) is None, m


@pytest.mark.parametrize("cell", ["urand19.bfs", "kron18.tc"])
def test_traced_cpu_run_reports_the_new_metrics(cell):
    result = cpu_run(cell, trace=1)
    assert result["correct"]
    mine = {m["name"] for m in spec.cell(cell)[4]}
    new = mine & set(SPAN_METRICS + COUNTER_METRICS)
    assert new == ({"frontend.host_ms", "sync.count", "sync.wait_ms"} | (
        {"lanepipe.host_ms", *COUNTER_METRICS} if cell == "urand19.bfs"
        else set()))
    got = result["metrics"]
    assert new <= set(got)
    for m in new:
        assert got[m]["value"] >= 0
    assert got["sync.count"]["value"] >= 1
