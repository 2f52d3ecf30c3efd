"""Share of the window's prediction calls in which nothing runs on the
card, in %: one minus the card's busy time a call (the union of its
activity, over the profiled calls that follow the window) over the
window's time a call (its seconds over its calls, on the host's
clock)."""

def read(run):
    prof = run["profiled"]
    if (run["cell"]["traffic"]["driver"] != "predict" or prof is None
            or not prof.device or not run["spans"]):
        return None
    busy = prof.busy_s / prof.steps
    return 100.0 * (1.0 - busy / (run["seconds"] / len(run["spans"])))
