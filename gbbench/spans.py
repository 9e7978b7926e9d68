"""Interval arithmetic over the program's spans in a traced run.

The program opens ``gb.algo:``, ``gb.op:``, ``gb.engine:`` and
``gb.sync:`` ranges (``graphblas_tpu_torch/core/trace.py``); they land in
``Trace.ranges`` on the profiler's clock, beside the device's work.  Spans
of one prefix may nest (``materialize`` calls ``update_into``), so every
quantity here is taken over unions of intervals, never by matching one
range to one event.  Times are in microseconds, as in the trace.
:func:`counter` reads the program's host-plan counters.
"""

import bisect

from .devtrace import union_us
from .harness import TRIAL_RANGE


def merged(intervals):
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def intersect(a, b):
    """The intervals both disjoint sorted lists cover."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a, b):
    """The parts of disjoint sorted intervals a that b does not cover."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def named(trace, prefixes):
    """(start, end, name) of the ranges whose names start with one of
    ``prefixes``."""
    return [r for r in trace.ranges if r[2].startswith(prefixes)]


def trials(trace):
    """The ``gbbench.trial`` ranges, as disjoint sorted intervals."""
    return merged((s, e) for s, e, name in trace.ranges
                  if name == TRIAL_RANGE)


def covered(trace, prefixes, windows):
    """The parts of ``windows`` inside some range of ``prefixes``."""
    return intersect(merged((s, e) for s, e, _ in named(trace, prefixes)),
                     windows)


def host_us(trace, inside, outside=()):
    """Host microseconds in the traced trials inside some range of the
    ``inside`` prefixes and inside none of the ``outside`` prefixes, or
    None where no range of ``inside`` lies in a trial."""
    windows = trials(trace)
    spans = covered(trace, inside, windows)
    if not spans:
        return None
    if outside:
        spans = subtract(spans, covered(trace, outside, windows))
    return union_us(spans)


def starts_in(trace, prefixes):
    """The ranges of ``prefixes`` that start inside a traced trial."""
    windows = trials(trace)
    starts = [s for s, _ in windows]
    out = []
    for r in named(trace, prefixes):
        k = bisect.bisect_right(starts, r[0]) - 1
        if k >= 0 and r[0] <= windows[k][1]:
            out.append(r)
    return out


def idle_by_span(trace, prefix="gb."):
    """{label: microseconds} of the device's idle time in the traced
    trials, by the innermost range of ``prefix`` open on the host (the
    one that began last): each idle gap is cut at the ranges' edges and
    each piece labelled; "none" where no such range was open."""
    windows = trials(trace)
    busy = merged((s, e) for s, e, _, _ in trace.device)
    spans = sorted(named(trace, (prefix,)))
    edges = sorted({t for s, e, _ in spans for t in (s, e)})
    pieces = []
    for g0, g1 in subtract(windows, busy):
        cuts = [g0] + edges[bisect.bisect_right(edges, g0):
                            bisect.bisect_left(edges, g1)] + [g1]
        pieces += zip(cuts[:-1], cuts[1:])
    out, active, p = {}, [], 0
    for g0, g1 in pieces:
        mid = 0.5 * (g0 + g1)
        while p < len(spans) and spans[p][0] <= mid:
            active.append(spans[p])
            p += 1
        active = [r for r in active if r[1] >= mid]
        label = max(active)[2] if active else "none"
        out[label] = out.get(label, 0.0) + (g1 - g0)
    return out


def counter(run, key):
    """The program's counter ``core.trace.counts[key]`` at the end of the
    run, or None where the program has no such counter or never added to
    it."""
    trace = getattr(getattr(run.program, "core", None), "trace", None)
    return getattr(trace, "counts", {}).get(key)
