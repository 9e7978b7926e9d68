"""The program's host reads of the device per Bellman-Ford round: its
``gb.sync:<site>`` ranges that start in the traced trials over its
``sssp:round`` ranges that do (the reads of a trial outside its rounds
included).  None where the trials hold no ``sssp:round`` range."""

from .. import spans


def read(run):
    if run.trace is None:
        return None
    rounds = spans.starts_in(run.trace, ("sssp:round",))
    if not rounds:
        return None
    return len(spans.starts_in(run.trace, ("gb.sync:",))) / len(rounds)
