"""Host ms per traced trial in the algorithms and the frontend: inside
some ``gb.algo:`` or ``gb.op:`` range of the program and inside no
``gb.engine:`` or ``gb.sync:`` range (expression building, masks, the
Recorder, the Python between dispatches)."""

from .. import spans


def read(run):
    if run.trace is None:
        return None
    us = spans.host_us(run.trace, ("gb.algo:", "gb.op:"),
                       ("gb.engine:", "gb.sync:"))
    return None if us is None else us * 1e-3 / run.traced_trials
