"""Seconds from the process's start to the first timed trial: imports,
the graph's generation, ``from_coo``, the host plan and the warm-up trial
(which builds the kernels in a checkout's first run)."""


def read(run):
    return run.setup_s
