"""The port's light scenes, `daylight_scene()` (kernel 2's tables; a sun,
a Hosek sky, 256 spots under the hierarchy) and `env_scene()` (kernel 1's; an
SAT-sampled HDR env, 64 points under `cdf`), at 32x32 through both
packages' `Runtime.step` on the JAX tables: per lane at depth 2 and by image
mean at depth 6 (helpers and tolerances in tests/test_torch_lights_render.py).
"""

from ignis_tpu_torch.scenes import daylight_scene, env_scene
from test_torch_lights_render import (  # noqa: F401
    _by_mean, _frames, _one_torch_thread, _per_lane,
)


def test_daylight_scene(tmp_path):
    ref, got, rt = _frames(daylight_scene(), 32, depth=2)
    assert "pb_rows" in rt.tables and rt.scene.lh_depth == 9
    _per_lane(ref, got)
    ref, got, _ = _frames(daylight_scene(), 32, seed=2)
    _by_mean(ref, got)


def test_env_scene(tmp_path):
    ref, got, rt = _frames(env_scene(tmp_path), 32, depth=2)
    assert "bw_tris" in rt.tables and "light1_sat" in rt.tables
    _per_lane(ref, got)
    ref, got, _ = _frames(env_scene(tmp_path), 32, seed=2)
    _by_mean(ref, got)
