"""The 95th percentile of the window's trial times, in ms, each timed on
the device's clock from the call until its result was on the host."""

import numpy as np


def read(run):
    return float(np.percentile(run.trial_ms, 95)) if run.trial_ms else None
