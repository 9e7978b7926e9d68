"""The window's wall time over the trials it completed, in ms."""


def read(run):
    return run.window_s * 1e3 / run.trials if run.trials else None
