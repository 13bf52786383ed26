"""Kernel 2 (`packet_bvh_closest` / `_any`, device operation `pbvh_kernel`):
the sampled launches' roofline bound (`roofline.pb_bound_s`) over their
device time in the trace, in percent."""

from benchmark.roofline import pb_bound_s, roofline_pct


def read(run):
    tables = getattr(run.entry, "rt", None)
    if run.sampler is None or tables is None or "pb_rows" not in \
            tables.tables:
        return None
    return roofline_pct(run.trace, run.sampler, "pbvh_kernel", tables.tables,
                        pb_bound_s)
