"""Measured materials (Klems, TensorTree, Dupuy-Jakob) through both
packages: `scenes.measured_scene()` per lane at depth 2 on a 16 x 16 film
(the port's own compiler and tables against the JAX package's `Runtime`;
1e-4 rtol and atol, at most 0.5 % of the lanes apart).  A small scene of
the three materials is held by image mean and by its gradient in
tests/test_torch_measured_panes.py."""

import copy

import numpy as np
import pytest
import torch

from ignis_tpu.api import Runtime as JRuntime
from ignis_tpu_torch.api import Runtime
from ignis_tpu_torch.scenes import measured_scene
from test_torch_volpath_render import per_lane


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_measured_scene_per_lane_depth2(tmp_path):
    scene = measured_scene(tmp_path)
    scene["technique"]["max_depth"] = 2
    jrt = JRuntime(copy.deepcopy(scene), width=16, height=16)
    jrt.step(spi=1)
    rt = Runtime(scene, width=16, height=16, device="cpu")
    assert "pb_rows" in rt.tables
    assert sorted(rt.scene.klems_info) == [4]
    assert sorted(rt.scene.tensortree_info) == [5]
    assert sorted(rt.scene.djmeasured_info) == [6]
    rt.step(spi=1)
    ref = np.asarray(jrt.currentFrame())
    per_lane(ref, rt.currentFrame())
    assert ref.mean() > 0
