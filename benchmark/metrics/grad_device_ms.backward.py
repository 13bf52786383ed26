"""Device milliseconds a train step between the CUDA events that open and
close the program's `train.backward` span (the gradient through the
render's tape), over the traced window's steps."""

from benchmark import spans


def read(run):
    recs = spans.of_run(run)
    if recs is None or not run.trace_steps:
        return None
    ms = spans.device_ms(recs, "train.backward")
    return None if ms is None else ms / run.trace_steps
