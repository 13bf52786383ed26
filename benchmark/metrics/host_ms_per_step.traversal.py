"""Host milliseconds a step in the traversal dispatch and its kernels'
launches: the program's `traverse` spans over the traced window's
steps."""

from benchmark import spans


def read(run):
    recs = spans.of_run(run)
    if recs is None or not run.trace_steps:
        return None
    s = spans.total_s(recs, ("traverse",))
    return None if s is None else 1e3 * s / run.trace_steps
