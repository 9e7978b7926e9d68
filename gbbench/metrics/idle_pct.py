"""The share of a trial's wall time in which no operation runs on the
device, in %: 1 - (device busy per traced trial, from the profiler) /
(the window's wall time per trial, measured without the profiler, which
slows the host)."""


def read(run):
    if run.trace is None or not run.trials or not run.trace.device:
        return None
    busy_ms = run.traced_busy_s() * 1e3 / run.traced_trials
    trial_ms = run.window_s * 1e3 / run.trials
    return 100.0 * (1.0 - busy_ms / trial_ms)
