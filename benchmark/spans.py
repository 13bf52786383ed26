"""The program's own spans over a traced window: the records that
`ignis_tpu_torch.utils.stats.read_spans` gives (dicts with `index`,
`name`, `start_ns`, `end_ns`, `parent`, `request`, `attrs`, `device_ms`;
stamps on the profiler's clock, `time.time_ns()`), cut to the window, their
self times, and the window's idle gaps labelled by the innermost program
span under way.  The arithmetic takes plain lists, so tests can give it a
synthetic log; `of_run` reads the program's log, and gives None where the
program keeps none."""

from __future__ import annotations

from benchmark.trace import TOP, idle_gaps, launched_in, merged

OUTSIDE = "outside"          # a gap's label where no program span is open


def in_window(records, start_s, end_s):
    """The closed records that lie wholly inside [start_s, end_s]."""
    lo, hi = start_s * 1e9, end_s * 1e9
    return [r for r in records if r["end_ns"] is not None
            and lo <= r["start_ns"] and r["end_ns"] <= hi]


def of_run(run):
    """The program's records inside the run's traced window; None where
    there is no trace or the program logs no span there."""
    if run.trace is None:
        return None
    try:
        from ignis_tpu_torch.utils.stats import read_spans
    except ImportError:
        return None
    recs = in_window(read_spans(), run.trace.start, run.trace.end)
    return recs or None


def self_ns(records):
    """{index: the span's duration less the union of its children's
    intervals, clipped to it}, in nanoseconds."""
    kids = {}
    for r in records:
        if r["parent"] is not None:
            kids.setdefault(r["parent"], []).append(r)
    out = {}
    for r in records:
        s0, e0 = r["start_ns"], r["end_ns"]
        covered, reach = 0, s0
        for k in sorted(kids.get(r["index"], ()), key=lambda k: k["start_ns"]):
            s, e = max(k["start_ns"], reach), min(k["end_ns"], e0)
            if e > s:
                covered += e - s
                reach = e
        out[r["index"]] = e0 - s0 - covered
    return out


def self_s(records, names):
    """Seconds of self time of the spans named in `names`, summed; None
    where there is none of them."""
    named = [r for r in records if r["name"] in names]
    if not named:
        return None
    own = self_ns(records)
    return sum(own[r["index"]] for r in named) * 1e-9


def total_s(records, names):
    """Seconds of the spans named in `names`, summed; None where there is
    none of them."""
    named = [r for r in records if r["name"] in names]
    if not named:
        return None
    return sum(r["end_ns"] - r["start_ns"] for r in named) * 1e-9


def count(records, name):
    return sum(r["name"] == name for r in records)


def launched_busy_s(trace, records, name):
    """Device seconds busy with the operations launched inside the spans
    called `name`: the union of those operations' intervals in the window,
    which may lie after a span's host end.  None where no device operation
    links to such a span (no span, or a trace without correlation ids)."""
    ops = launched_in(trace, [(r["start_ns"] * 1e-9, r["end_ns"] * 1e-9)
                              for r in records if r["name"] == name])
    if not ops:
        return None
    return sum(e - s for s, e in merged([(op[1], op[2]) for op in ops],
                                        trace.start, trace.end))


def innermost(records, times_ns):
    """For each time (ascending), the name of the innermost span open at it
    (OUTSIDE where none is).  Spans nest: one thread opens them."""
    spans = sorted(records, key=lambda r: (r["start_ns"], -r["end_ns"]))
    stack, j, out = [], 0, []
    for t in times_ns:
        while j < len(spans) and spans[j]["start_ns"] <= t:
            while stack and stack[-1]["end_ns"] < spans[j]["start_ns"]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1]["end_ns"] < t:
            stack.pop()
        out.append(stack[-1]["name"] if stack else OUTSIDE)
    return out


def gaps_by_span(trace, records, top=TOP):
    """The window's idle seconds summed by the innermost program span open
    at each gap's midpoint, largest first."""
    gaps = idle_gaps(trace)
    mids = [0.5 * (s + e) * 1e9 for s, e in gaps]
    sums = {}
    for (s, e), name in zip(gaps, innermost(records, mids)):
        sums[name] = sums.get(name, 0.0) + (e - s)
    return sorted(sums.items(), key=lambda kv: -kv[1])[:top]
