"""Seconds the runtime's statistics give the scene's load and compile and
its table builds (`loading` + `build_*`; a table the asset cache served
records no build)."""


def read(run):
    return run.entry.table_build_s()
