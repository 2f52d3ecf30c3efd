"""Kernel launches on the card per step, over the profiled steps that
follow the window (the traffic mix's profile_steps)."""


def read(run):
    prof = run["profiled"]
    if prof is None or not prof.kernels or prof.steps == 0:
        return None
    return prof.launches / prof.steps
