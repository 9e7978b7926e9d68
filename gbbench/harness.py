"""One run of one cell: set-up, the measured window, the traced trials,
the check against the plain reference, and the result line.

The window is a closed loop: one caller, the next trial once the last
result is on the host, for ``seconds`` seconds of the host clock.  Each
trial is also timed on the device's clock, by CUDA events recorded before
the call and after its result is on the host (the stream is idle at both
points, so the two events bound the trial's wall time to within
microseconds, where the host clock is good to about half a millisecond).
"""

import dataclasses
import gc
import importlib
import subprocess
import sys
import time

import numpy as np
import torch

from . import devtrace, drivers, gen, spec

TRIAL_RANGE = "gbbench.trial"
BANNED = ("jax", "jaxlib", "flax", "graphblas_tpu")
PEAKS = "peaks.json"


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers read it."""

    cuda: bool
    program: object = None         # the graphblas_tpu_torch module
    matrix: object = None          # the cell's Matrix, until it is freed
    n: int = 0
    nnz: int = 0
    setup_s: float = 0.0           # process start to the first timed trial
    from_coo_s: float = 0.0        # Matrix.from_coo until wait() returns
    first_trial_s: float = 0.0     # the warm-up trial
    trials: int = 0                # trials completed in the window
    window_s: float = 0.0
    trial_ms: list = dataclasses.field(default_factory=list)  # device clock
    launches: int = 0              # the program's kernel launches, window
    peak_bytes: int = 0
    trace: object = None           # devtrace.Trace of the traced trials
    traced_trials: int = 0
    trace_window: tuple = None     # (start, end) us on the trace's clock
    probes: dict = dataclasses.field(default_factory=dict)
    kind: str = ""
    peaks: dict = dataclasses.field(default_factory=dict)

    def capture(self, fn):
        return devtrace.capture(fn, self.cuda)

    def traced_busy_s(self):
        t0, t1 = self.trace_window
        return self.trace.busy_us([
            (max(s, t0), min(e, t1), n, c)
            for s, e, n, c in self.trace.device if e > t0 and s < t1]) * 1e-6


class Timer:
    """Per-trial times in ms: CUDA events on a card, else the host clock."""

    def __init__(self, cuda):
        self.cuda, self.marks = cuda, []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, start):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.marks.append((start, ev))

    def times_ms(self):
        if self.cuda:
            torch.cuda.synchronize()
            return [s.elapsed_time(e) for s, e in self.marks]
        return [(e - s) * 1e3 for s, e in self.marks]


class Keeper:
    """The results the check compares: every one, or a uniform sample of
    ``size`` of them drawn from the seed (reservoir sampling), so that the
    sample spreads over the whole window however many trials it holds."""

    def __init__(self, size, seed):
        self.size, self.kept, self.seen = size, [], 0
        self.rng = drivers.rng(seed, 2)

    def offer(self, i, result):
        self.seen += 1
        if self.size is None or len(self.kept) < self.size:
            self.kept.append((i, result))
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.size:
            self.kept[j] = (i, result)


def banned_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def power_limit():
    """The card's name and power limit as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def sync(cuda):
    if cuda:
        torch.cuda.synchronize()


def run(cell, seed, seconds, trace, t_start, device="cuda", config=None):
    """Run ``cell`` and return (result, checks, notes), or (None, banned,
    notes) where a banned module was loaded; ``notes`` are lines for
    standard error.  ``config`` replaces the cell's
    configuration (the tests run at small scales)."""
    work, cfg, trf, e2e, per_layer = spec.cell(cell)
    cfg = cfg if config is None else config
    cuda = device == "cuda"
    program = importlib.import_module("graphblas_tpu_torch")
    kernels = importlib.import_module(
        "graphblas_tpu_torch.core.engine.kernels")
    drv = spec.driver(trf["driver"])
    r = Run(cuda=cuda, program=program,
            kind=torch.cuda.get_device_name(0) if cuda else "cpu")
    r.peaks = spec.load_json(f"{spec.HERE}/{PEAKS}").get(r.kind, {})

    # set-up: the graph (kept on the host; the peak counts from here, the
    # program's), the matrix, the warm-up trials
    t = time.perf_counter()
    graph = gen.build(cfg, seed, device)
    graph = dataclasses.replace(graph, rows=graph.rows.cpu(),
                                cols=graph.cols.cpu(),
                                values=graph.values.cpu())
    r.n, r.nnz = graph.n, graph.nnz
    notes = [f"graph of seed {gen.graph_seed(cfg, seed)}: n {graph.n}, "
             f"{graph.pairs} pairs, {graph.nnz} "
             f"entries, {time.perf_counter() - t:.3f} s"]
    peaks = []

    def peak(phase):
        if cuda:
            sync(cuda)
            peaks.append(f"{phase} {torch.cuda.max_memory_allocated()}")

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    A = program.Matrix.from_coo(
        graph.rows.numpy(), graph.cols.numpy(), graph.values.numpy(),
        dtype=graph.dtype, nrows=graph.n, ncols=graph.n)
    A.wait()
    r.from_coo_s = time.perf_counter() - t
    peak("from_coo")
    r.matrix = A
    state = drv.prepare(graph, trf, seed)
    # one trial for each distinct input of the window: every shape it uses
    warm = int(trf.get("warmup_trials", 1))
    for k in range(warm):
        t = time.perf_counter()
        drv.trial(program, A, state, k)
        sync(cuda)
        if k == 0:
            r.first_trial_s = time.perf_counter() - t
            peak("first trial")
    peak("warm-up")
    r.setup_s = time.perf_counter() - t_start

    # the measured window
    keeper = Keeper(trf.get("check_sample"), seed)
    timer = Timer(cuda)
    kernels.reset_launches()
    i = warm
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        mark = timer.start()
        result = drv.trial(program, A, state, i)
        timer.stop(mark)
        keeper.offer(i, result)
        i += 1
        if time.perf_counter() >= deadline:
            break
    r.window_s = time.perf_counter() - t0
    r.trials = i - warm
    r.launches = sum(kernels.launches.values())
    r.trial_ms = timer.times_ms()
    peak("window")
    q = np.percentile(r.trial_ms, [5, 25, 50, 75, 95, 100])
    thirds = [float(np.mean(x)) for x in np.array_split(r.trial_ms, 3)
              if len(x)]
    notes.append(
        f"set-up {r.setup_s:.3f} s (from_coo {r.from_coo_s:.3f} s, first "
        f"trial {r.first_trial_s:.3f} s); {r.trials} trials in "
        f"{r.window_s:.3f} s; ms p5 p25 p50 p75 p95 max "
        f"{' '.join(f'{x:.3f}' for x in q)}; mean by thirds "
        f"{' '.join(f'{x:.3f}' for x in thirds)}; first "
        f"{' '.join(f'{x:.3f}' for x in r.trial_ms[:4])}; "
        f"{r.launches} launches")

    # the traced trials and the metrics' probes
    if trace:
        r.traced_trials = int(trf["trace_trials"])
        first = i

        def traced():
            for k in range(first, first + r.traced_trials):
                with torch.profiler.record_function(TRIAL_RANGE):
                    res = drv.trial(program, A, state, k)
                keeper.offer(k, res)

        r.trace, _ = r.capture(traced)
        _, spans = r.trace.launched_in(lambda name: name == TRIAL_RANGE)
        r.trace_window = (min(s for s, _, _ in spans),
                          max(e for _, e, _ in spans))
        for m in per_layer:
            reader = spec.metric(m["name"])
            if hasattr(reader, "probe"):
                r.probes[m["name"]] = reader.probe(r)
        peak("traced trials and probes")
    r.peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    notes.append("peak bytes after " + ", ".join(peaks))

    # the program's state goes before the reference runs
    r.matrix = A = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    banned = banned_modules()
    if banned:
        return None, banned, notes
    t = time.perf_counter()
    checks, failed = drv.check(graph, state, keeper.kept, device)
    notes.append(f"check of {len(keeper.kept)} results: "
                 f"{time.perf_counter() - t:.3f} s")
    correct = failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in (per_layer if trace else e2e):
        value = spec.metric(m["name"]).read(r)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": r.kind,
           "count": int(work["chips"]), "memory_peak_bytes": int(r.peak_bytes)}
    if trace:
        dev["busy_s"] = r.traced_busy_s()
        dev["window_s"] = (r.trace_window[1] - r.trace_window[0]) * 1e-6
    if cuda:
        dev["power"] = power_limit()
    result = {"correct": bool(correct),
              "attempted": r.trials + r.traced_trials,
              "failed": int(failed), "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {
            "device_ops": r.trace.device_ops(),
            "idle_gaps": r.trace.idle_gaps(r.trace_window)}
    result["checks"] = checks
    return result, checks, notes
