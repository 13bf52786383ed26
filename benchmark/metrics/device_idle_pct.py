"""100 x (1 - union of the device operations' intervals / the traced
window's wall).  Reads `device_idle_pct.render` and `device_idle_pct.grad`
alike: the two names only say which end-to-end metric the share moves."""

from benchmark.trace import busy_s


def read(run):
    if not run.trace.device:
        return None
    return 100.0 * (1.0 - busy_s(run.trace) / run.trace.window_s)
