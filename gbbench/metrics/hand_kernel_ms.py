"""Device ms per traced trial in the port's hand-written kernels, found
by their symbols (``<source>_kernel`` for each ``csrc/<source>.cu`` the
program builds)."""

from ..devtrace import kernel_symbol


def read(run):
    if run.trace is None:
        return None
    from graphblas_tpu_torch.core.engine import kernels

    names = {f"{src}_kernel" for src in kernels.SOURCES}
    mine = [ev for ev in run.trace.device if kernel_symbol(ev[2]) in names]
    if not mine:
        return None
    return sum(e - s for s, e, _, _ in mine) * 1e-3 / run.traced_trials
