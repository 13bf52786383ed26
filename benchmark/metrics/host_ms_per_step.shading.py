"""Host milliseconds a step in shading: the self time of the program's
`bounce` spans (surface, BSDF, lights, NEE, roulette; traversal and syncs
left out) and of its `emit` spans (camera emission), over the traced
window's steps."""

from benchmark import spans


def read(run):
    recs = spans.of_run(run)
    if recs is None or not run.trace_steps:
        return None
    s = spans.self_s(recs, ("bounce", "emit"))
    return None if s is None else 1e3 * s / run.trace_steps
