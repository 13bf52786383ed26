"""Tiny cells on the CPU: the workload and configuration keys that the
tests override to make a cell run in seconds here."""

import pytest

SEED = 2 ** 31 + 4242          # above 32 signed bits: seeds may be that large


def tiny(cell):
    """(workload overrides, configuration overrides) of a tiny `cell`."""
    if cell == "cbox.inverse":
        return {"film": [12, 12]}, {}
    wl = {"film": [12, 12], "check_pixels": 64}
    return wl, ({"size_factor": 3} if cell.startswith("spd_tetra") else {})


@pytest.fixture
def cpu_cell():
    from benchmark.harness import run_cell

    def run(cell, fault=None, seed=SEED, control=False):
        wl, cfg = tiny(cell)
        return run_cell(cell, seed, 0.5, 0, device="cpu", overrides=wl,
                        config_overrides=cfg, fault=fault, control=control)
    return run
