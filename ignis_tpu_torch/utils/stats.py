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
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


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
