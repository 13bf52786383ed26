"""Device milliseconds a train step between the CUDA events that open and
close the program's `train.forward` span (the differentiable render and
the loss), over the traced window's steps."""

from benchmark import spans


def read(run):
    recs = spans.of_run(run)
    if recs is None or not run.trace_steps:
        return None
    ms = spans.device_ms(recs, "train.forward")
    return None if ms is None else ms / run.trace_steps
