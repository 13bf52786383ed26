"""The port's two-level traversal (`ops/tlas.py`) against the JAX package's
Pallas kernel in interpret mode, closest hit: split from
tests/test_torch_tlas.py, whose helpers and tolerances (the gate of
tests/test_instancing.py, plus: what disagrees is a tie or a rounding case)
it uses, so that `--dist loadfile` runs the slow interpret-mode groups on
different workers.
"""

import pytest
import torch

from ignis_tpu_torch.convert import tables_from_numpy
from test_torch_tlas import (  # noqa: F401
    _assert_gate, _both, _port_tables, _rays, scenes,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops on these small inputs run faster on one intra-op
    thread, and the test workers sharing the CPU then do not oversubscribe
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mask_bit", [0x1, 0x4, 0x8])
@pytest.mark.parametrize("n", [4, 25])
def test_tlas_closest_matches_pallas_interpret(scenes, n, mask_bit):
    jrt = scenes(n)
    ttab = tables_from_numpy(_port_tables(jrt), "cpu")
    ref, got = _both(jrt.tables, ttab, _rays(512, 5), mask_bit, False)
    assert _assert_gate(ref, got) > 10
