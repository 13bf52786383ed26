"""Null collisions a sample over the traced window: the runtime's
`MediumNullEvents` counter (added up on the device, read outside the
window) over the samples of the window's steps.  None where the program
counts no media events, or the entry brackets no window's counters."""


def read(run):
    counts = getattr(run.sampler, "counts", None) or {}
    if "MediumNullEvents" not in counts or not run.trace_steps:
        return None
    return counts["MediumNullEvents"] / (run.trace_steps
                                         * run.entry.work_per_step)
