"""Device ms per traced trial of the work launched inside the program's
``lanepipe:tail`` ranges (the two-level tail that recombines destinations
split over ``lanepipe.SPLIT_DEG`` entries)."""


def read(run):
    if run.trace is None:
        return None
    evs, spans = run.trace.launched_in(lambda name: name == "lanepipe:tail")
    if not spans or not evs:
        return None
    return run.trace.busy_us(evs) * 1e-3 / run.traced_trials
