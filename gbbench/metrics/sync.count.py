"""The program's host reads of the device per traced trial: its
``gb.sync:<site>`` ranges that start in a trial.  None where the trials
hold no range of the program at all."""

from .. import spans


def read(run):
    if run.trace is None or not spans.starts_in(run.trace, ("gb.",)):
        return None
    return len(spans.starts_in(run.trace, ("gb.sync:",))) / run.traced_trials
