"""Device ms per traced trial of the work launched inside the program's
``spgemm:<formulation>:terms=...`` ranges (``execute._spgemm_run``)."""


def _is_spgemm(name):
    return name.startswith("spgemm:")


def read(run):
    if run.trace is None:
        return None
    evs, spans = run.trace.launched_in(_is_spgemm)
    if not spans or not evs:
        return None
    return run.trace.busy_us(evs) * 1e-3 / run.traced_trials
