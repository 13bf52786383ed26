"""The window's wall time over the train steps completed in it, each closed
by a synchronise."""


def read(run):
    return run.window_s / run.steps
