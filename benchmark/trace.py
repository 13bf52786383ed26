"""The device trace of a traced window, reduced to what the per-layer
metrics and the `breakdown` read: device operations as (name, start, end)
intervals in seconds, host operations likewise, the union of the device
intervals (busy time), the idle gaps between them and what the host was
doing in each.  The arithmetic takes plain lists, so tests can give it a
synthetic trace; `from_profiler` fills the lists from `torch.profiler`.

A device operation from the profiler is an `Op`: it also keeps its kineto
correlation id, and `Trace.launches` maps that id to the host start of the
runtime call that launched the operation, so an operation can be traced
back to the program span that launched it (`launched_in`)."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

TOP = 10
# CUDA API calls (runtime `cuda*`, low-level `cu*`) that put an operation on
# the device: the host end of a kineto correlation id
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaMemcpy", "cudaMemset",
                "cuLaunchKernel", "cuMemcpy", "cuMemset")


class Op(tuple):
    """A device operation, (name, start_s, end_s), with the kineto
    correlation id of the call that launched it (`corr`)."""

    def __new__(cls, name, start, end, corr=None):
        op = super().__new__(cls, (name, start, end))
        op.corr = corr
        return op


@dataclass
class Trace:
    device: list = field(default_factory=list)   # (name, start_s, end_s)
    host: list = field(default_factory=list)     # (name, start_s, end_s)
    start: float = 0.0                           # the traced window
    end: float = 0.0
    launches: dict = field(default_factory=dict)  # corr -> launch's start_s

    @property
    def window_s(self):
        return self.end - self.start

    def named(self, part):
        """Device operations whose name holds `part`, in start order."""
        return sorted((e for e in self.device if part in e[0]),
                      key=lambda e: e[1])


def from_profiler(prof, start_s, end_s):
    """A `Trace` of a `torch.profiler.profile` run; `start_s`, `end_s` are
    the window's bounds on the profiler's clock (`time.time_ns() / 1e9`)."""
    from torch.autograd import DeviceType
    tr = Trace(start=start_s, end=end_s)
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        rec = (e.name(), s, s + e.duration_ns() * 1e-9)
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            tr.device.append(Op(*rec, e.correlation_id()))
            continue
        if e.name().startswith(LAUNCH_CALLS) and e.correlation_id():
            tr.launches[e.correlation_id()] = s
        if not e.name().startswith(("cuda", "cudaLaunch")):
            tr.host.append(rec)
    return tr


def launched_in(tr, intervals):
    """The device operations whose launching call started inside one of
    the host's (start_s, end_s) `intervals`, which do not overlap, wherever
    on the device the operations ran.  Operations that no launch links to
    are left out."""
    spans = sorted(intervals)
    starts = [s for s, _ in spans]
    out = []
    for op in tr.device:
        t = tr.launches.get(getattr(op, "corr", None))
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            out.append(op)
    return out


def merged(intervals, lo=None, hi=None):
    """The union of (start, end) intervals, clipped to [lo, hi], sorted."""
    out = []
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(tr):
    """Seconds of the window in which some device operation ran."""
    return sum(e - s for s, e in merged([(d[1], d[2]) for d in tr.device],
                                        tr.start, tr.end))


def idle_gaps(tr):
    """The window's (start, end) stretches in which no device operation
    ran."""
    gaps, t = [], tr.start
    for s, e in merged([(d[1], d[2]) for d in tr.device], tr.start, tr.end):
        if s > t:
            gaps.append((t, s))
        t = e
    if tr.end > t:
        gaps.append((t, tr.end))
    return gaps


def gaps_by_host(tr, top=TOP):
    """Idle seconds summed by the innermost host operation under way at
    each gap's midpoint ("host" where none is), largest first."""
    host = sorted(tr.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    sums = {}
    for s, e in idle_gaps(tr):
        mid = 0.5 * (s + e)
        label = "host"
        i = bisect.bisect_right(starts, mid) - 1
        # the innermost: the latest-starting operation that still runs
        while i >= 0 and i > bisect.bisect_right(starts, mid) - 64:
            if host[i][2] >= mid:
                label = host[i][0]
                break
            i -= 1
        sums[label] = sums.get(label, 0.0) + (e - s)
    return sorted(sums.items(), key=lambda kv: -kv[1])[:top]


def device_ops(tr, top=TOP):
    """Device seconds summed by operation name, largest first."""
    sums = {}
    for name, s, e in tr.device:
        sums[name] = sums.get(name, 0.0) + (e - s)
    return sorted(sums.items(), key=lambda kv: -kv[1])[:top]


def breakdown(tr):
    return {"device_ops": [[n[:200], v] for n, v in device_ops(tr)],
            "idle_gaps": [[n[:200], v] for n, v in gaps_by_host(tr)]}
