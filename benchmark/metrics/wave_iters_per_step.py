"""Iterations of the regenerating wavefront a step over the traced window,
full-width and tail (the runtime's `WaveIterations` and `TailIterations`
counters, carried on the device)."""


def read(run):
    if not run.trace_steps or not run.wave_iters:
        return None
    return run.wave_iters / run.trace_steps
