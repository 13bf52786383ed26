"""Seconds from process start to the first timed step: imports, CUDA
start, the kernel library, the scene's compile and tables (or the asset
cache), the cell's warm-up."""


def read(run):
    return run.setup_s
