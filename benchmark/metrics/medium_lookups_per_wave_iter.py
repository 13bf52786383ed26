"""Grid lookups of heterogeneous media issued a wavefront iteration over
the traced window: the runtime's `MediumLookups` counter (a batched
`grid_lookup` call each, counted on the host) over the window's
iterations, full-width and tail.  None where the program counts none."""


def read(run):
    counts = getattr(run.sampler, "counts", None) or {}
    if "MediumLookups" not in counts or not run.wave_iters:
        return None
    return counts["MediumLookups"] / run.wave_iters
