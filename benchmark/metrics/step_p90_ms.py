"""The 90th percentile of the window's step wall times (each step closed by
the runtime's synchronise), in milliseconds: an interactive viewer's frame
time.  Python's inclusive quantiles over all steps."""

import statistics


def read(run):
    if run.steps < 2:
        return None
    return 1e3 * statistics.quantiles(run.step_s, n=10,
                                      method="inclusive")[8]
