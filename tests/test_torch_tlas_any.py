"""The port's two-level traversal (`ops/tlas.py`) against the JAX package's
Pallas kernel in interpret mode, any hit (only `pool_row >= 0` is read):
split from tests/test_torch_tlas.py, whose helpers and tolerances it uses,
so that `--dist loadfile` runs the slow interpret-mode groups on different
workers.
"""

import numpy as np
import pytest
import torch

from ignis_tpu_torch.convert import tables_from_numpy
from ignis_tpu_torch.ops import tlas as ttl
from test_torch_tlas import (  # noqa: F401
    F32, _both, _port_tables, _rays, scenes,
)


@pytest.mark.parametrize("mask_bit", [0x1, 0x4, 0x8])
@pytest.mark.parametrize("n", [4, 25])
def test_tlas_any_matches_pallas_interpret(scenes, n, mask_bit):
    """Any-hit: only `pool_row >= 0` is read."""
    jrt = scenes(n)
    ttab = tables_from_numpy(_port_tables(jrt), "cpu")
    org, d, tmin, _ = _rays(512, 6)
    rays = (org, d, np.full(512, 1e-3, F32), np.full(512, 5.0, F32))
    ref, got = _both(jrt.tables, ttab, rays, mask_bit, True)
    occ_r, occ_g = ref[3] >= 0, got[3] >= 0
    assert (occ_r != occ_g).sum() <= 1 and occ_g.any() and not occ_g.all()
    occ = ttl.tlas_any(ttab, *(torch.from_numpy(a) for a in rays),
                       mask_bit=mask_bit).numpy()
    assert occ.dtype == np.bool_ and (occ == occ_g).all()
