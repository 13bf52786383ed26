"""Blocking reads of a device value by the host a step: the program's
`sync` spans (`utils.stats.host_item`, each also counted in `HostSyncs`)
in the traced window over its steps."""

from benchmark import spans


def read(run):
    recs = spans.of_run(run)
    if recs is None or not run.trace_steps:
        return None
    return spans.count(recs, "sync") / run.trace_steps
