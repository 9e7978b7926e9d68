"""Seconds of the warm-up trial: the host plan (``lanepipe.build_plan``,
``permute.build_perm_plan``, ``native/``), the kernels' build in a first
run, and whatever else the first call sets up."""


def read(run):
    return run.first_trial_s
