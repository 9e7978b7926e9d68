"""Device ms per traced trial of the work launched inside the program's
``lanepipe:sparse`` ranges (the lanepipe's sparse-vector branch, its
two-level tail included; ``core/engine/lanepipe.spmv_pipeline``)."""


def read(run):
    if run.trace is None:
        return None
    evs, spans = run.trace.launched_in(lambda name: name == "lanepipe:sparse")
    if not spans or not evs:
        return None
    return run.trace.busy_us(evs) * 1e-3 / run.traced_trials
