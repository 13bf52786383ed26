"""Host milliseconds a step in the media's work of a bounce: the self time
of the program's `medium` spans (coefficients, transmittance, distance
sample and event), over the traced window's steps."""

from benchmark import spans


def read(run):
    recs = spans.of_run(run)
    if recs is None or not run.trace_steps:
        return None
    s = spans.self_s(recs, ("medium",))
    return None if s is None else 1e3 * s / run.trace_steps
