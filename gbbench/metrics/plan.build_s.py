"""Host seconds the program spent building plans over the run: its
counter ``core.trace.counts["plan.build_s"]`` at the end of the run (each
miss of ``lanepipe.get_plan`` and ``sortpipe.get_plan``)."""

from .. import spans


def read(run):
    return spans.counter(run, "plan.build_s")
