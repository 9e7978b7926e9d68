"""The harness on the card, at small scales: every metric of each cell
read, the checks passed, and the controls failed.  Run on a card with
``python -m pytest gbbench/tests -q -m gpu``; each test skips without
one."""

import time

import pytest
import torch

from gbbench import control, harness, spec

SMALL = {"urand19.bfs": 14, "kron18.tc": 14}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_on_the_card(card, cell, trace):
    cfg = dict(spec.cell(cell)[1], scale=SMALL[cell])
    result, checks, notes = harness.run(cell, 2**31 + 7, 2.0, trace,
                                        time.perf_counter(), config=cfg)
    assert result["correct"], (checks, notes)
    mine = spec.cell(cell)[4 if trace else 3]
    assert set(result["metrics"]) == {m["name"] for m in mine}, notes
    dev = result["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == torch.cuda.get_device_name(0)
    assert dev["memory_peak_bytes"] > 0
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert result["breakdown"]["device_ops"]
        for m in mine:
            if m["name"].endswith("_roofline"):
                assert 0 < result["metrics"][m["name"]]["value"] <= 100


@pytest.mark.gpu
def test_trial_clock_bounds_the_host_clock(card):
    """A trial timed by the events is at most the host's time for it."""
    t = harness.Timer(True)
    host = []
    for _ in range(5):
        mark = t.start()
        h0 = time.perf_counter()
        torch.cuda._sleep(10_000_000)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - h0) * 1e3)
        t.stop(mark)
    for dev_ms, host_ms in zip(t.times_ms(), host):
        assert 0.9 * host_ms < dev_ms < host_ms + 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("cell, scale, trials", [("urand19.bfs", 14, 4),
                                                 ("kron18.tc", 14, 1)])
def test_control_fails_on_the_card(card, cell, scale, trials):
    cfg = dict(spec.cell(cell)[1], scale=scale)
    checks, failed = control.readings(cell, 5, trials, "cuda", cfg)
    assert failed == trials
    assert all(c["value"] > c["limit"] for c in checks.values())
