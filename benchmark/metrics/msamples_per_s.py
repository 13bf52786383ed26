"""Samples of every step completed in the window over the wall time from
the window's start to the end of its last step, in millions a second."""


def read(run):
    return run.entry.work_per_step * run.steps / run.window_s / 1e6
