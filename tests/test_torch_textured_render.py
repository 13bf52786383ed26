"""Textured scenes rendered through both packages: every place the `path`
technique reads a texture (color slots of either lobe, a blend weight,
normal-modifier kinds 1, 2 and 4, a uniformly sampled textured environment),
then `scenes.textured_scene()` per lane at depth 2 and by image mean at full
depth, and the registry checks of tests/test_parameters.py through the
port's `Runtime`.

Both packages trace the raw compiled tables (the Moeller-Trumbore sweep);
`Runtime` renders through its Baldwin-Weber tables.  Tolerances: per lane
1e-4 (rtol and atol) with at most 0.5 % of the lanes flipped, as
test_torch_materials_render.py holds its scene; bumped and PExpr normals
per lane to rel 1e-3, since the bump map's differences at delta 1e-3
multiply a last-ulp difference of a texture by 1e3; image means 1 %.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import create_flat_scene
from test_parameters import _param_scene
from ignis_tpu.render.integrator import trace_wave as j_trace_wave
from ignis_tpu.scene.compile import load_and_compile as j_compile
from ignis_tpu_torch.api import Runtime
from ignis_tpu_torch.convert import tables_from_numpy
from ignis_tpu_torch.render.integrator import trace_wave
from ignis_tpu_torch.scene.compile import load_and_compile as t_compile
from ignis_tpu_torch.scenes import textured_scene
from ignis_tpu_torch.utils.exr import write_exr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops on these small inputs run faster on one intra-op
    thread, and the test workers sharing the CPU then do not oversubscribe
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pixels(w, h):
    idx = np.arange(w * h, dtype=np.int32)
    return idx % w, idx // w


def _both_trace(scene, w, h, seed=0):
    js, ts = j_compile(scene, w, h), t_compile(scene, w, h)
    x, y = _pixels(w, h)
    ref = np.asarray(j_trace_wave(
        js, {k: jnp.asarray(v) for k, v in js.tables.items()},
        jnp.asarray(x), jnp.asarray(y), jnp.uint32(0), jnp.uint32(0),
        jnp.uint32(0), seed))
    got = trace_wave(ts, tables_from_numpy(ts.tables, "cpu"),
                     torch.from_numpy(x), torch.from_numpy(y), 0, 0, 0,
                     seed).numpy()
    return ref, got, ts


def _hold(ref, got, rtol=1e-4):
    assert np.isfinite(got).all() and ref.mean() > 0
    ok = np.isclose(got, ref, rtol=rtol, atol=1e-4).all(axis=-1)
    assert ok.mean() >= 0.995, (~ok).sum()
    assert abs(got.mean() - ref.mean()) <= 2e-3 * ref.mean()


CHECKER = {"type": "checkerboard", "name": "checker", "scale_x": 6,
           "scale_y": 4, "color0": [0.2, 0.3, 0.9], "color1": 0.8}
CLOUDS = {"type": "fbm", "name": "clouds", "scale_x": 5, "scale_y": 5,
          "seed": 2}
RELIEF = ("ensure_valid_reflection(Ng, V, bump(N, Nx, Ny, 0.5, "
          "noise(uv * 8) - 0.5, noise(uv * 8 + 3) - 0.5))")


def _flat(bsdfs, textures=(), lights=None):
    """The flat test scene, its plane shaded by the last of `bsdfs` (named
    "ground"), under a point light and a white sky."""
    s = copy.deepcopy(create_flat_scene())
    s["bsdfs"] = list(bsdfs[:-1]) + [dict(bsdfs[-1], name="ground")]
    s["textures"] = list(textures)
    s["lights"] = lights or [
        {"type": "point", "name": "l", "position": [0.3, 0.2, -0.8],
         "intensity": [1, 1, 1]},
        {"type": "env", "name": "sky", "radiance": [0.5, 0.5, 0.5]}]
    return s


def _sky(tmp_path):
    rng = np.random.default_rng(11)
    img = rng.uniform(0.1, 2.0, (16, 32, 3)).astype(np.float32)
    path = str(tmp_path / "sky.exr")
    write_exr(path, img)
    return {"type": "image", "name": "sky", "filename": path,
            "filter_type": "bilinear"}


FEATURES = {
    "texture color": (lambda tmp: _flat(
        [{"type": "diffuse", "reflectance": "checker"}], [CHECKER]),
        lambda ts: (ts.tables["mat_tex"] >= 0).any(), 1e-4),
    "lobe b texture and blend weight": (lambda tmp: _flat(
        [{"type": "diffuse", "name": "a", "reflectance": "clouds"},
         {"type": "roughconductor", "name": "b", "roughness": 0.3,
          "specular_reflectance": "checker"},
         {"type": "blend", "first": "a", "second": "b",
          "weight": "checker"}], [CHECKER, CLOUDS]),
        lambda ts: ((ts.tables["mat_wrap_tex"] >= 0).any()
                    and (ts.tables["mat_tex_b"] >= 0).any()), 1e-4),
    "normal map": (lambda tmp: _flat(
        [{"type": "diffuse", "name": "a", "reflectance": 0.7},
         {"type": "normalmap", "bsdf": "a", "map": "tilt",
          "strength": 0.9}],
        [dict(CHECKER, name="tilt", color0=[0.6, 0.45, 0.9],
              color1=[0.35, 0.6, 0.8])]),
        lambda ts: 1 in ts.nmod_kinds, 1e-4),
    "bump map": (lambda tmp: _flat(
        [{"type": "diffuse", "name": "a", "reflectance": 0.7},
         {"type": "bumpmap", "bsdf": "a", "map": "clouds",
          "strength": 0.6}], [CLOUDS]),
        lambda ts: 2 in ts.nmod_kinds, 1e-3),
    "pexpr normal": (lambda tmp: _flat(
        [{"type": "plastic", "name": "a"},
         {"type": "transform", "bsdf": "a", "normal": RELIEF}]),
        lambda ts: 4 in ts.nmod_kinds, 1e-3),
    "textured uniform env": (lambda tmp: _flat(
        [{"type": "diffuse", "reflectance": 0.6}], [_sky(tmp)],
        lights=[{"type": "env", "name": "sky", "radiance": "sky",
                 "scale": [1.0, 0.8, 0.6], "cdf": False,
                 "transform": {"rotate": [0, 40, 0]}}]),
        lambda ts: ts.lights[0].tex >= 0 and ts.lights[0].type == 3, 1e-4),
}


@pytest.mark.parametrize("what", sorted(FEATURES))
def test_textured_feature_per_lane_depth2(what, tmp_path):
    make, holds, rtol = FEATURES[what]
    ref, got, ts = _both_trace(make(tmp_path), 16, 16)
    assert holds(ts)
    _hold(ref, got, rtol)


def test_textured_scene_per_lane_depth2(tmp_path):
    scene = textured_scene(tmp_path)
    scene["technique"] = dict(scene["technique"], max_depth=2)
    ref, got, _ = _both_trace(scene, 20, 20)
    _hold(ref, got, 1e-3)


def test_textured_runtime_full_depth_by_mean(tmp_path):
    """`Runtime(textured_scene())` on the CPU through its Baldwin-Weber
    tables, held to the JAX package's render of the same samples by image
    mean (1 %), most pixels one by one."""
    ref, got_t, _ = _both_trace(textured_scene(tmp_path), 16, 16, seed=3)
    rt = Runtime(textured_scene(tmp_path), width=16, height=16, seed=3,
                 device="cpu")
    assert "bw_tris" in rt.tables
    rt.step(spi=1)
    img = rt.currentFrame().reshape(-1, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    assert abs(img.mean() - ref.mean()) <= 1e-2 * ref.mean()
    assert abs(got_t.mean() - ref.mean()) <= 1e-2 * ref.mean()
    ok = np.isclose(img, ref, rtol=1e-3, atol=1e-3).all(axis=-1)
    assert ok.mean() >= 0.95


# ------------------------------------ tests/test_parameters.py, through the port
def _tables_unchanged(rt, before):
    """Nothing but the registry's values changed: every table is the same
    tensor, in the same storage, and all but `params` hold the same bits."""
    for k, (obj, ptr, copy_) in before.items():
        t = rt.tables[k]
        assert t is obj and t.data_ptr() == ptr, k
        if k != "params":
            assert torch.equal(t, copy_), k


def _snapshot(rt):
    return {k: (v, v.data_ptr(), v.clone()) for k, v in rt.tables.items()
            if isinstance(v, torch.Tensor)}


def test_set_parameter_changes_image_without_rebuilding():
    rt = Runtime(_param_scene(), device="cpu")
    rt.step(spi=2)
    img0 = rt.currentFrame()
    before = _snapshot(rt)
    rt.setParameter("p_col0", [0.9, 0.1, 0.1])
    rt.reset()
    rt.step(spi=2)
    img1 = rt.currentFrame()
    assert not np.allclose(img0, img1)
    # red checker cells: red mean rises
    assert img1[..., 0].mean() > img0[..., 0].mean()
    _tables_unchanged(rt, before)


def test_camera_pose_parameter_without_rebuilding():
    rt = Runtime(_param_scene(), device="cpu")
    rt.step(spi=2)
    img0 = rt.currentFrame()
    before = _snapshot(rt)
    rt.setCameraOrientationParameter([0, 0.5, -3.0], [0, -0.1, 1], [0, 1, 0])
    rt.reset()
    rt.step(spi=2)
    assert not np.allclose(img0, rt.currentFrame())
    _tables_unchanged(rt, before)


def test_number_parameter_scales_checker():
    rt = Runtime(_param_scene(), device="cpu")
    rt.step(spi=2)
    img_coarse = rt.currentFrame()
    rt.setParameter("p_scale", 16.0)
    rt.reset()
    rt.step(spi=2)
    img_fine = rt.currentFrame()
    assert not np.allclose(img_coarse, img_fine)
    assert img_fine.std() < img_coarse.std() * 1.2


def test_parameter_renders_match_jax():
    """The same registry change in both packages gives the same frame."""
    from ignis_tpu.api import Runtime as JRuntime
    jrt = JRuntime(_param_scene())
    rt = Runtime(_param_scene(), device="cpu")
    for r in (jrt, rt):
        r.setParameter("p_col1", [0.2, 0.7, 0.4])
        r.setParameter("p_scale", 7.0)
        r.step(spi=1)
    np.testing.assert_allclose(rt.currentFrame(), jrt.currentFrame(),
                               rtol=1e-4, atol=1e-5)
