"""Whole runs of both cells against the port on the CPU, at small scales:
correct on sound runs, not correct where the timed path is broken
underneath, the control, the runner's refusals and the modules a run
loads."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

import graphblas_tpu_torch as gb
from gbbench import control, harness, spec
from gbbench.devtrace import Trace, kernel_symbol, union_us

from .conftest import ROOT

SMALL = {"urand19.bfs": 9, "kron18.tc": 10}


def cpu_run(cell, seed=2**31 + 99, trace=0, seconds=0.5):
    cfg = dict(spec.cell(cell)[1], scale=SMALL[cell])
    with gb.config.set(device="cpu", auto_sparse_limit=0):
        result, checks, notes = harness.run(
            cell, seed, seconds, trace, time.perf_counter(), device="cpu",
            config=cfg)
    return result


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_runs_on_the_port(cell, trace):
    result = cpu_run(cell, trace=trace)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in result["checks"].values())
    mine = spec.cell(cell)[4 if trace else 3]
    # the host-clock metrics read on any device; the device ones only on
    # a card, so a CPU run leaves them out
    assert set(result["metrics"]) <= {m["name"] for m in mine}
    for name, m in result["metrics"].items():
        assert m["value"] == m["value"] and m["unit"]
    if trace:
        assert "setup.from_coo_s" in result["metrics"]
        assert result["device"]["window_s"] > 0
    else:
        assert {"setup_s", "trial_ms", "trial_ms_p95"} <= set(result["metrics"])


def _alter(orig):
    def broken(A, source=0):
        v = orig(A, source)
        v[(source + 1) % A.nrows] = 99
        return v
    return broken


def _unchanged(orig):
    def broken(A, source=0):  # the first step leaves the frontier as it was
        return orig(gb.Matrix(A.dtype, A.nrows, A.ncols), source)
    return broken


def _half_bfs(orig):
    def broken(A, source=0):  # half of the rows left out of the product
        return orig(A.select("rowle", A.nrows // 2 - 1).new(), source)
    return broken


def _count_plus_one(orig):
    return lambda A: orig(A) + 1


def _half_tc(orig):
    return lambda A: orig(A.select("rowle", A.nrows // 2 - 1).new())


def _zero(orig):
    return lambda A: 0


FAULTS = [("urand19.bfs", "bfs_level", f) for f in
          (_alter, _unchanged, _half_bfs)] + \
         [("kron18.tc", "triangle_count", f) for f in
          (_count_plus_one, _half_tc, _zero)]


@pytest.mark.parametrize("cell, fn, fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, _, f in FAULTS])
def test_broken_timed_path_is_not_correct(monkeypatch, cell, fn, fault):
    monkeypatch.setattr(gb.algorithms, fn,
                        fault(getattr(gb.algorithms, fn)))
    result = cpu_run(cell)
    assert not result["correct"]
    assert result["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_bfs_control_fails():
    checks, failed = control.readings(
        "urand19.bfs", 11, 4, "cpu", dict(spec.config("urand19"), scale=10))
    assert failed == 4 and checks["level_mismatches"]["value"] > 0


def test_tc_control_fails():
    checks, failed = control.readings(
        "kron18.tc", 5, 1, "cpu", dict(spec.config("kron18"), scale=10))
    assert failed == 1 and checks["count_gap"]["value"] > 0


def _cli(cwd, env=None):
    cmd = [sys.executable, "gbbench/run.py", "--workload", "kron18.tc",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


def test_runner_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _cli(ROOT, env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_runner_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "gbbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_run_loads_no_jax():
    code = (
        "import sys, json, time\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from gbbench.tests import test_gbbench_runs as t\n"
        "t.cpu_run('kron18.tc', trace=1)\n"
        "from gbbench import harness\n"
        "print(json.dumps([harness.banned_modules(),"
        " sorted({m.split('.')[0] for m in sys.modules})]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    banned, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert banned == []
    assert "graphblas_tpu_torch" in tops and "graphblas_tpu" not in tops
    assert not {"jax", "jaxlib", "flax"} & set(tops)


def test_keeper_samples_from_the_seed():
    def sample(seed, n=1000):
        k = harness.Keeper(12, seed)
        for i in range(n):
            k.offer(i, i)
        return sorted(i for i, _ in k.kept)

    a = sample(3)
    assert a == sample(3) and a != sample(4) and len(a) == 12
    assert max(a) > 500  # spread over the whole window, not its start
    every = harness.Keeper(None, 1)
    for i in range(50):
        every.offer(i, i)
    assert len(every.kept) == 50


def _ev(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def test_trace_reading():
    tr = Trace([
        _ev("user_annotation", "spgemm:dot:terms=10:gustavson=40:dot=10",
            0, 50),
        _ev("cuda_runtime", "cudaLaunchKernel", 5, 2, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 60, 2, 2),
        _ev("kernel", "void ns::gather_mult_kernel<int>(int*)", 10, 20, 1),
        _ev("kernel", "other", 25, 15, 2),
        _ev("cpu_op", "aten::item", 70, 30),
        _ev("kernel", "other", 100, 10, 3),
    ])
    assert union_us([(0, 10), (5, 20), (30, 40)]) == 30
    assert tr.busy_us() == 40
    evs, spans = tr.launched_in(lambda n: n.startswith("spgemm:"))
    assert [e[3] for e in evs] == [1] and len(spans) == 1
    assert kernel_symbol(tr.device[0][2]) == "gather_mult_kernel"
    assert tr.device_ops()[0] == ["other", pytest.approx(25e-6)]
    gaps = dict(tr.idle_gaps((0, 110)))
    assert gaps["in aten::item"] == pytest.approx(60e-6)


def test_metric_readers_on_a_fake_run():
    r = harness.Run(cuda=True, n=100, nnz=1000, trials=10,
                    window_s=0.5, trial_ms=list(np.arange(1.0, 101.0)),
                    peak_bytes=2**31, launches=300)
    assert spec.metric("trial_ms").read(r) == 50.0
    assert spec.metric("trial_ms_p95").read(r) == pytest.approx(95.05)
    assert spec.metric("peak_mem_gib").read(r) == 2.0
    assert spec.metric("launches_per_trial").read(r) == 30.0
    for name in ("idle_pct", "hand_kernel_ms", "spgemm_ms", "spgemm_terms",
                 "spmv_roofline"):
        assert spec.metric(name).read(r) is None  # nothing to read
