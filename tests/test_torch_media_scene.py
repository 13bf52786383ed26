"""`scenes.media_scene()` (the chip run's `media` path, its grids cut to
32^3 and 16^3) through the port's own compiler, table build and
`Runtime.step`, per lane against the JAX package's `Runtime` at depth 2 on
a 12 x 12 film: 1e-4 (rtol and atol), at most 0.5 % of the lanes apart."""

import copy

import numpy as np
import pytest
import torch

from ignis_tpu.api import Runtime as JRuntime
from ignis_tpu_torch.api import Runtime
from ignis_tpu_torch.scenes import media_scene
from test_torch_volpath_render import per_lane


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_media_scene_per_lane_depth2(tmp_path):
    scene = media_scene(tmp_path, cloud_res=32, glow_res=16)
    scene["technique"]["max_depth"] = 2
    jrt = JRuntime(copy.deepcopy(scene), width=12, height=12)
    jrt.step(spi=1)
    rt = Runtime(scene, width=12, height=12, device="cpu")
    assert "bw_tris" in rt.tables
    assert [m["type"] for m in rt.scene.media] == [
        "homogeneous", "homogeneous", "hetero_density", "hetero_voxel"]
    rt.step(spi=1)
    ref = np.asarray(jrt.currentFrame())
    per_lane(ref, rt.currentFrame())
    assert ref.mean() > 0
