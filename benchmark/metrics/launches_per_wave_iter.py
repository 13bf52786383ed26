"""Device operations in the traced window over its wavefront iterations
(full-width and tail): the eager launches of shading, RNG, traversal and
accumulation an iteration."""


def read(run):
    if not run.wave_iters or not run.trace.device:
        return None
    return len(run.trace.device) / run.wave_iters
