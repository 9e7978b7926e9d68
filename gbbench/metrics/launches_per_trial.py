"""The program's own count of hand-kernel launches
(``core/engine/kernels.launches``) over the window, per trial."""


def read(run):
    return run.launches / run.trials if run.trials else None
