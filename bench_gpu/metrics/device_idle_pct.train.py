"""Share of the window's training steps in which nothing runs on the
card, in %: one minus the card's busy time a step (no kernel, copy or
set: the union of its activity, over the profiled steps that follow the
window) over the window's time a step (its seconds over its steps, on
the host's clock). The profiler slows the host, so the profiled steps'
own interval would overstate the idle share of a host-bound step."""

def read(run):
    prof = run["profiled"]
    if (run["cell"]["traffic"]["driver"] != "train" or prof is None
            or not prof.device or not run["spans"]):
        return None
    busy = prof.busy_s / prof.steps
    return 100.0 * (1.0 - busy / (run["seconds"] / len(run["spans"])))
