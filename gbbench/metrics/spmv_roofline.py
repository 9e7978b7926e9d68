"""A SpMV's share of its memory roofline, in %.  The probe runs
``u.vxm(A, lor_land)`` on the cell's matrix with a full BOOL ``u``,
``CALLS`` times inside a range of the benchmark's own; the bound is the
bytes the operation needs, counted from its inputs alone (``work.spmv``),
over the card's memory rate, and the time is the device's busy time of
the work launched inside the range."""

import numpy as np
import torch

from .. import work

RANGE = "gbbench.spmv_probe"
CALLS = 20


def probe(run):
    gb, A = run.program, run.matrix
    u = gb.Vector.from_dense(np.ones(A.nrows, dtype=bool))
    ring = gb.semiring.lor_land[bool]
    u.vxm(A, ring).new()  # warm: the plan of this direction

    def calls():
        with torch.profiler.record_function(RANGE):
            for _ in range(CALLS):
                u.vxm(A, ring).new()

    trace, _ = run.capture(calls)
    return trace


def read(run):
    trace = run.probes.get("spmv_roofline")
    rate = run.peaks.get("hbm_bytes_per_s")
    if trace is None or rate is None:
        return None
    evs, _ = trace.launched_in(lambda name: name == RANGE)
    busy_s = trace.busy_us(evs) * 1e-6 / CALLS
    if busy_s <= 0:
        return None
    bound_s = work.spmv_bytes(run.n, run.nnz, value_bytes=1) / rate
    return 100.0 * bound_s / busy_s
