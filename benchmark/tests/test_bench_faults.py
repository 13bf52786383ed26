"""A run with its timed path broken comes out not correct, in every cell,
for each fault the cell can have, and so does a run with the control (the
reference in bfloat16) in the program's place; a sound run comes out
correct."""

import pytest

from benchmark.harness import FAULTS, spec_file

CELLS = [w["name"] for w in spec_file()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cpu_cell, cell):
    r = cpu_cell(cell)
    assert r["correct"] is True, r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_broken_run_is_not_correct(cpu_cell, cell, fault):
    r = cpu_cell(cell, fault=fault)
    assert r["correct"] is False, (fault, r["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_run_is_not_correct(cpu_cell, cell):
    r = cpu_cell(cell, control=True)
    assert r["correct"] is False, r["checks"]


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark.harness import run_cell
    r = run_cell("cbox.render", 12345, 1.0, 0)
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
