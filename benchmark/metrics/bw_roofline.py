"""Kernel 1 (`bw_closest` / `bw_any`, device operation `bw_kernel`): the
sampled launches' roofline bound (`roofline.bw_bound_s`) over their device
time in the trace, in percent."""

from benchmark.roofline import bw_bound_s, roofline_pct


def read(run):
    tables = getattr(run.entry, "rt", None)
    if run.sampler is None or tables is None or "bw_tris" not in \
            tables.tables:
        return None
    return roofline_pct(run.trace, run.sampler, "bw_kernel", tables.tables,
                        bw_bound_s)
