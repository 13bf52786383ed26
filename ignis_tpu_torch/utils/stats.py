"""Statistics / profiling subsystem.

Mirrors the reference's Statistics semantics (src/runtime/Statistics.h:9-66,
Statistics.cpp:151-228): named section timers with call counts and
workloads, plus ray/sample quantities, dumped as an indented tree.  The
reference merges thread-local stats; here the analogues are host wall-clock
sections (scene load, BVH build, compile = first step, steps) and
device-derived quantities (rays, bounce-lane occupancy) that the wavefront
loop carries as cheap scalar counters.

Use:
    stats = Statistics()
    with stats.section("loading"):
        ...
    stats.add("CameraRayCount", n)
    print(stats.dump())

Tracing inside a step: `span(name)` marks a layer boundary of the hot path
(`step`, `wave`, `emit`, `bounce`, `traverse`, `accum`, `train.*`);
`host_item(t)` is the one way the hot path reads a device value back, and
`host_tensor` the one way it copies host values to the device (each such
blocking operation counted by `host_syncs()`, and a `sync` span);
`row_scatters()` counts the backward calls of the parameter tables' row
gathers (`core.dgather`); `grid_lookups()` the heterogeneous media's grid
lookups issued (`medium.volume.grid_lookup`, a batched call each); and
inside `medium_counts(sink)` the media's events and ratio-tracker flights
are added up on the device into `sink` (`count_medium`), with no host
sync: a `Runtime` reads its sink in `dumpStats`.  A span
records only while a `torch.profiler` runs: otherwise it costs one check
and allocates nothing.  Its record holds `time.time_ns()` stamps, the clock of
the profiler's own events, so it lines up with a device trace:

    with torch.profiler.profile():
        rt.step()
    records = read_spans()     # dicts: name, start_ns, end_ns, parent, ...

The section timers above stay on always: set-up runs before any profiler.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


@dataclass
class _Section:
    total: float = 0.0
    count: int = 0
    workload: int = 0
    min_t: float = float("inf")
    max_t: float = 0.0

    def record(self, dt: float, workload: int = 0):
        self.total += dt
        self.count += 1
        self.workload += workload
        self.min_t = min(self.min_t, dt)
        self.max_t = max(self.max_t, dt)


@dataclass
class Statistics:
    sections: dict = field(default_factory=dict)
    quantities: dict = field(default_factory=dict)

    @contextmanager
    def section(self, name: str, workload: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0, workload)

    def record(self, name: str, dt: float, workload: int = 0):
        self.sections.setdefault(name, _Section()).record(dt, workload)

    def add(self, quantity: str, n):
        self.quantities[quantity] = self.quantities.get(quantity, 0) + n

    def set(self, quantity: str, n):
        self.quantities[quantity] = n

    def merge(self, other: "Statistics"):
        for k, s in other.sections.items():
            mine = self.sections.setdefault(k, _Section())
            mine.total += s.total
            mine.count += s.count
            mine.workload += s.workload
            mine.min_t = min(mine.min_t, s.min_t)
            mine.max_t = max(mine.max_t, s.max_t)
        for k, v in other.quantities.items():
            self.add(k, v)

    def dump(self) -> str:
        """Indented report (Statistics::dump analog)."""
        lines = ["Statistics:", "  Sections:"]
        for name in sorted(self.sections):
            s = self.sections[name]
            avg = s.total / max(s.count, 1)
            line = (f"    {name}: {s.total * 1e3:.1f} ms "
                    f"[{s.count} call{'s' if s.count != 1 else ''}, "
                    f"avg {avg * 1e3:.2f} ms")
            if s.count > 1:
                line += f", min {s.min_t * 1e3:.2f}, max {s.max_t * 1e3:.2f}"
            if s.workload:
                line += f", {s.workload / s.total / 1e6:.2f} M/s"
            lines.append(line + "]")
        lines.append("  Quantities:")
        for name in sorted(self.quantities):
            v = self.quantities[name]
            if isinstance(v, float):
                lines.append(f"    {name}: {v:.4g}")
            else:
                lines.append(f"    {name}: {v}")
        return "\n".join(lines)


# ----------------------------------------------------------------- tracing

SPAN_CAP = 1 << 17          # records kept; the oldest go first
_profiler_enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _SpanLog:
    """The records of the spans opened while a profiler ran, oldest first,
    and the stack of those still open."""

    def __init__(self, cap=SPAN_CAP):
        self.records = deque(maxlen=cap)
        self.open = []
        self.next_index = 0

    def clear(self):
        self.records.clear()
        self.open.clear()


_LOG = _SpanLog()
_host_syncs = 0
_row_scatters = 0
_grid_lookups = 0
# the device tensor that the media's event counts go to (None: not counted)
_medium_sink = None
# its slots, by the names `Runtime.dumpStats` gives them
MEDIUM_COUNTS = ("MediumNullEvents", "MediumScatters", "MediumAbsorbs",
                 "RatioFlights")


class _Span:
    """One span's record; its own context manager.  `index` numbers every
    span of the process; `parent` is the index of the span open around it
    (None at the top); `request` is given, or else its parent's."""

    __slots__ = ("index", "name", "start_ns", "end_ns", "parent", "request",
                 "attrs", "device", "events")

    def __init__(self, name, attrs=None, request=None, device=None):
        self.name = name
        self.attrs = attrs
        self.request = request
        self.device = device
        self.events = None
        self.end_ns = None

    def __enter__(self):
        log = _LOG
        up = log.open[-1] if log.open else None
        self.parent = None if up is None else up.index
        if self.request is None and up is not None:
            self.request = up.request
        self.index = log.next_index
        log.next_index += 1
        log.records.append(self)
        log.open.append(self)
        if self.device is not None and self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.device))
            self.events = (start,)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            self.events = self.events + (end,)
        if _LOG.open and _LOG.open[-1] is self:
            _LOG.open.pop()
        return False


def span(name, attrs=None, *, request=None, device=None):
    """A context manager marking one layer's work on the host, recorded
    while a `torch.profiler` runs and a no-op otherwise.  `attrs` (a dict,
    kept by reference: pass a constant on a hot path) is stored with the
    record; `request` ties the span to one request (a step's iteration),
    and its children inherit it.  With `device` a CUDA device, CUDA events
    on its current stream mark the span's ends too, read as device
    milliseconds by `read_spans`."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, attrs, request, device)


def _blocking(op):
    """`op()`, an operation that waits for the device: counted in
    `host_syncs()` always, and a `sync` span under a profiler."""
    global _host_syncs
    _host_syncs += 1
    if not _profiler_enabled():
        return op()
    with _Span("sync"):
        return op()


def host_item(t):
    """`t.item()`: a blocking read of a device value by the host."""
    return _blocking(t.item)


def host_tensor(data, dtype, device):
    """`torch.tensor(data, dtype=dtype, device=device)`: host values copied
    to a CUDA device by a blocking copy, which waits for the device's queue
    (counted as `host_item` is; a tensor made on the CPU is not)."""
    if torch.device(device).type != "cuda":
        return torch.tensor(data, dtype=dtype, device=device)
    return _blocking(lambda: torch.tensor(data, dtype=dtype, device=device))


def host_syncs():
    """The hot path's blocking reads of device values and blocking copies
    to the device (`host_item`, `host_tensor`) so far in this process."""
    return _host_syncs


def row_scatters():
    """The backward calls of `core.dgather.gather_rows` so far in this
    process, on either device: each sums a gathered parameter table's
    gradient rows into the table (`gather_rows_backward.launches` counts
    those that took the CUDA kernel)."""
    return _row_scatters


def count_row_scatter():
    """+1 on `row_scatters()`: one backward of `core.dgather.gather_rows`."""
    global _row_scatters
    _row_scatters += 1


def grid_lookups():
    """The grid lookups of heterogeneous media issued so far in this
    process (`medium.volume.grid_lookup` calls, each over a batch of
    lanes), on either device."""
    return _grid_lookups


def count_grid_lookup():
    """+1 on `grid_lookups()`."""
    global _grid_lookups
    _grid_lookups += 1


@contextmanager
def medium_counts(sink):
    """Within the block, `count_medium` adds into `sink`, an int64 tensor
    of `len(MEDIUM_COUNTS)` slots on the run's device."""
    global _medium_sink
    prev, _medium_sink = _medium_sink, sink
    try:
        yield
    finally:
        _medium_sink = prev


def count_medium(first, counts):
    """Add `counts()`, device values (a 1-d integer tensor), into the slots
    of the current sink from `first` on, in place on the device: no host
    sync.  Outside `medium_counts`, nothing (and `counts` is not called)."""
    sink = _medium_sink
    if sink is not None:
        c = counts()
        sink[first:first + c.shape[0]] += c


def read_spans():
    """The span log as dicts, oldest first: `index`, `name`, `start_ns`,
    `end_ns` (None while open), `parent`, `request`, `attrs` and
    `device_ms` (the device time between the span's CUDA events, None
    without them).  Synchronises once where some span has events."""
    recs = list(_LOG.records)
    if any(r.events is not None for r in recs):
        torch.cuda.synchronize()
    return [dict(index=r.index, name=r.name, start_ns=r.start_ns,
                 end_ns=r.end_ns, parent=r.parent, request=r.request,
                 attrs=r.attrs,
                 device_ms=(r.events[0].elapsed_time(r.events[1])
                            if r.events is not None and len(r.events) == 2
                            else None))
            for r in recs]


def clear_spans():
    """Forget every record (the counter of host syncs stays)."""
    _LOG.clear()


def self_ns(record, records):
    """A span's duration less the part of it that its children cover."""
    kids = sorted((max(r["start_ns"], record["start_ns"]),
                   min(r["end_ns"], record["end_ns"]))
                  for r in records if r["parent"] == record["index"]
                  and r["end_ns"] is not None)
    covered, reach = 0, record["start_ns"]
    for s, e in kids:
        s = max(s, reach)
        if e > s:
            covered += e - s
            reach = e
    return record["end_ns"] - record["start_ns"] - covered
