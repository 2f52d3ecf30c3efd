"""The program's own host spans in a profiled run: svbrdf_tpu_torch's
utils/profiling.span records each as a host range on the profiler's clock,
so it is among a core.Profiled's host operations (`ops`), not on the
card's timeline. A program without the span has none to read."""


def mean_ms(run, name: str):
    """Summed host ms of the spans called `name` among the profiled steps
    (calls), over their count; None without a trace or without such a
    span."""
    prof = run["profiled"]
    if prof is None or prof.steps == 0:
        return None
    spans = [e - s for s, e, n in prof.ops if n == name]
    return sum(spans) / 1e3 / prof.steps if spans else None
