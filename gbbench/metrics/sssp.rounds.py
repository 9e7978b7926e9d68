"""Bellman-Ford rounds per traced trial: the program's ``sssp:round``
ranges (``algorithms/sssp.py``) that start in a trial.  None where the
trials hold no such range."""

from .. import spans


def read(run):
    if run.trace is None:
        return None
    rounds = spans.starts_in(run.trace, ("sssp:round",))
    return len(rounds) / run.traced_trials if rounds else None
