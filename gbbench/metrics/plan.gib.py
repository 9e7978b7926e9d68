"""GiB of the device tensors of the plans the program built over the
run: its counter ``core.trace.counts["plan.bytes"]`` over 2**30."""

from .. import spans


def read(run):
    b = spans.counter(run, "plan.bytes")
    return None if b is None else b / 2**30
