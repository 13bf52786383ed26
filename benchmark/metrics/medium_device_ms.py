"""Device milliseconds a step busy with the operations launched inside the
program's `medium` spans (the media's work of a bounce), wherever they ran
on the device: the union of those operations' intervals, each linked to
the span by the host start of the call that launched it, over the traced
window's steps."""

from benchmark import spans


def read(run):
    recs = spans.of_run(run)
    if recs is None or not run.trace_steps:
        return None
    s = spans.launched_busy_s(run.trace, recs, "medium")
    return None if s is None else 1e3 * s / run.trace_steps
