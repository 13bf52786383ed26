"""The `volpath` scenes of tests/test_torch_volpath_render.py by image mean
at depth 4 (2 %), through both packages' `Runtime.step` (the port on the
JAX package's tables).  Split from that file so that neither takes much
over a minute under the tier-1 run's six workers."""

import numpy as np
import pytest
import torch

from test_torch_volpath_render import SCENES, frames


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("what", sorted(SCENES))
def test_volpath_scene_by_mean_depth4(what, tmp_path):
    ref, got = frames(SCENES[what](tmp_path), 16, seed=1, depth=4)
    assert np.isfinite(got).all() and ref.mean() > 0
    assert abs(got.mean() - ref.mean()) <= 0.02 * ref.mean()
