"""Host ms per traced trial inside the program's ``gb.engine:lanepipe``
ranges and inside no ``gb.sync:`` range: the lanepipe's plan lookup and
its Python between kernel launches."""

from .. import spans


def read(run):
    if run.trace is None:
        return None
    us = spans.host_us(run.trace, ("gb.engine:lanepipe",), ("gb.sync:",))
    return None if us is None else us * 1e-3 / run.traced_trials
