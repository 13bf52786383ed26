"""Host milliseconds a step in the wavefront loop's own code: the self time
of the program's `wave` spans (regeneration, the loop's bookkeeping) and
of its `accum` spans (the splat into the framebuffer), over the traced
window's steps."""

from benchmark import spans


def read(run):
    recs = spans.of_run(run)
    if recs is None or not run.trace_steps:
        return None
    s = spans.self_s(recs, ("wave", "accum"))
    return None if s is None else 1e3 * s / run.trace_steps
