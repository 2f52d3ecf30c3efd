"""Share of the window's diffusion training steps in which nothing runs
on the card, in %: one minus the card's busy time a step (the union of
its kernels, copies and sets, over the profiled steps that follow the
window) over the window's time a step (its seconds over its steps, on
the host's clock)."""


def read(run):
    prof = run["profiled"]
    if (run["cell"]["traffic"]["driver"] != "diffusion" or prof is None
            or not prof.device or not run["spans"]):
        return None
    busy = prof.busy_s / prof.steps
    return 100.0 * (1.0 - busy / (run["seconds"] / len(run["spans"])))
