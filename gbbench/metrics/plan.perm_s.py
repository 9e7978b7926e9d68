"""The part of ``plan.build_s`` in ``permute.build_perm_plan`` (the Clos
colouring of the lanepipe's two permutations), in seconds: the program's
counter ``core.trace.counts["plan.perm_s"]``."""

from .. import spans


def read(run):
    return spans.counter(run, "plan.perm_s")
