"""Host ms per traced trial inside the program's ``gb.sync:`` ranges (the
union of them): the time the host waits for the device's answers, the
copy included.  None where the trials hold no range of the program at
all."""

from .. import spans


def read(run):
    if run.trace is None:
        return None
    us = spans.host_us(run.trace, ("gb.sync:",))
    if us is None:
        return None if spans.host_us(run.trace, ("gb.",)) is None else 0.0
    return us * 1e-3 / run.traced_trials
