"""Host milliseconds a step spent waiting on the device for a value: the
program's `sync` spans over the traced window's steps."""

from benchmark import spans


def read(run):
    recs = spans.of_run(run)
    if recs is None or not run.trace_steps:
        return None
    s = spans.total_s(recs, ("sync",))
    return None if s is None else 1e3 * s / run.trace_steps
