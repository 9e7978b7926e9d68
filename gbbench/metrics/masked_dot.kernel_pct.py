"""Share of the masked dot's mask entries over the run whose matching
terms kernel K8 counted (a `pair` ring), in %: the program's counters
``core.trace.counts["masked_dot.kernel_entries"]`` over
``["masked_dot.entries"]``.  None where the program has no such counters
or ran no masked dot."""

from .. import spans


def read(run):
    entries = spans.counter(run, "masked_dot.entries")
    if not entries:
        return None
    return 100.0 * (spans.counter(run, "masked_dot.kernel_entries") or 0) \
        / entries
