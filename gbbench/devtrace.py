"""A torch.profiler capture, read back from its Chrome trace.

:func:`capture` runs a function under the profiler (CPU and, on a card,
CUDA activity) and returns a :class:`Trace`: the device's operations
(kernels, copies, memsets) with the host call that launched each, the host
ranges opened with ``torch.profiler.record_function`` (the program's and
the benchmark's), and the host's torch operations.  Times are in
microseconds on the profiler's clock.
"""

import bisect
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def kernel_symbol(name):
    """The bare function name of a demangled kernel signature
    (``void ns::k<int>(int*)`` -> ``k``)."""
    head = name.split("(", 1)[0].split("<", 1)[0].strip()
    return head.split()[-1].split("::")[-1] if head else name


class Trace:
    def __init__(self, events):
        self.device = []      # (start, end, name, correlation)
        self.ranges = []      # (start, end, name): record_function ranges
        self.ops = []         # (start, end, name): torch operations
        launches = {}         # correlation -> host launch time
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = str(ev.get("cat", "")).lower()
            ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
            corr = (ev.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, ev.get("name", ""), corr))
            elif cat in LAUNCH_CATS and corr is not None:
                launches[corr] = ts
            elif cat == "user_annotation":
                self.ranges.append((ts, ts + dur, ev.get("name", "")))
            elif cat == "cpu_op":
                self.ops.append((ts, ts + dur, ev.get("name", "")))
        self.device.sort()
        self.launch = launches

    def busy_us(self, events=None):
        """Microseconds in which some device operation ran."""
        evs = self.device if events is None else events
        return union_us([(s, e) for s, e, _, _ in evs])

    def launched_in(self, pred):
        """Device operations launched from inside a host range whose name
        satisfies ``pred``, with the matching ranges."""
        spans = sorted((s, e) for s, e, name in self.ranges if pred(name))
        starts = [s for s, _ in spans]
        out = []
        for ev in self.device:
            t = self.launch.get(ev[3])
            if t is None:
                continue
            k = bisect.bisect_right(starts, t) - 1
            # ranges of one name do not overlap: the last one that starts
            # before the launch is the only candidate
            if k >= 0 and t <= spans[k][1]:
                out.append(ev)
        return out, [(s, e, name) for s, e, name in self.ranges if pred(name)]

    def device_ops(self, top=10):
        """[[name, seconds]] of the device operations that took most
        time, summed by name."""
        by = {}
        for s, e, name, _ in self.device:
            by[name] = by.get(name, 0.0) + (e - s)
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:160], us * 1e-6] for name, us in rows]

    def idle_gaps(self, window, top=10):
        """[[label, seconds]]: the device's idle time inside ``window``
        (start, end), summed by what the host was doing at the middle of
        each gap: the innermost torch operation running then, else the
        last one that had ended ("after <op>")."""
        t0, t1 = window
        merged = []
        for s, e, _, _ in self.device:
            if e < t0 or s > t1:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        edges = [t0] + [x for iv in merged for x in iv] + [t1]
        ops = sorted(self.ops)
        ends = sorted((e, name) for s, e, name in self.ops)
        end_times = [e for e, _ in ends]
        by, active, p = {}, [], 0
        for k in range(0, len(edges), 2):
            g0, g1 = edges[k], edges[k + 1]
            if g1 <= g0:
                continue
            mid = 0.5 * (g0 + g1)
            while p < len(ops) and ops[p][0] <= mid:
                active.append(ops[p])
                p += 1
            active = [o for o in active if o[1] >= mid]
            if active:  # torch operations nest: the innermost began last
                label = "in " + max(active)[2]
            else:
                j = bisect.bisect_right(end_times, mid) - 1
                label = "after " + ends[j][1] if j >= 0 else "host"
            by[label] = by.get(label, 0.0) + (g1 - g0)
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[label[:160], us * 1e-6] for label, us in rows]


def capture(fn, cuda):
    """Run ``fn()`` under torch.profiler and return (Trace, wall seconds
    of fn on the host clock, ending in a device synchronise)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="gbbench-trace-") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return Trace(events), wall
