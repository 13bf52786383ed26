"""The `Runtime` tail of the port: checkpoints, `tonemap`, `imageinfo`,
`evaluateGlare` and the denoiser.

First the JAX package's own cases of these (tests/test_checkpoint.py,
tests/test_glare.py, tests/test_denoise.py) through the port, with their
oracles as they are there.  Then the port against the JAX functions on the
same inputs: `tonemap` for the five operators on an image holding NaN, Inf
and negative pixels (4e-6 relative, and 1e-6 absolute before the sRGB gamma,
4e-6 after it);
`image_info` (counts and histogram exact, the rest 1e-6); `evaluate_glare`
under a perspective and a fishlens camera (DGP 1e-5 relative; heatmap 1e-5,
mask exact; solid angles 2e-6); `atrous_denoise` (1e-5).

The colour matrices are 3x3 products whose last bit XLA's CPU dot and
PyTorch's matmul round differently (XLA fuses some rows' multiply-adds and
not others).  The gamma curve's slope, up to 13 near black, carries that
last bit of a linear value to some 3e-6 of an output, and the division by y
of xyY -> XYZ to some 2e-6 of a value.  A pixel's solid angle
is a sum of four angles near pi less 2 pi, so it keeps the absolute error of
2 pi's last bits (5e-7 each), not a relative one.
"""

import copy
import json
import math

import numpy as np
import pytest
import torch

from ignis_tpu_torch.api import Runtime, load_scene
from ignis_tpu_torch.render.glare import (
    WHITE_EFFICIENCY, GlareSettings, evaluate_glare_host, pixel_solid_angles,
)
from ignis_tpu_torch.scene.compile import CameraConfig
from test_checkpoint import SCENE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(scene, **kw):
    return load_scene(json.dumps(scene), device="cpu", **kw)


# ---------------------------------------------------------------- checkpoint

def test_checkpoint_resume_bitwise(tmp_path):
    rt = _load(SCENE, seed=11)
    for _ in range(3):
        rt.step(spi=2)
    rt.saveCheckpoint(tmp_path / "ck.npz")
    for _ in range(3):
        rt.step(spi=2)
    full = rt.currentFrame()

    rt2 = _load(SCENE, seed=0)  # the seed comes from the checkpoint
    rt2.loadCheckpoint(tmp_path / "ck.npz")
    assert rt2.currentSampleCount() == 6 and rt2.seed == 11
    assert rt2._accum.device == rt2.device
    for _ in range(3):
        rt2.step(spi=2)
    assert np.array_equal(full, rt2.currentFrame())


def test_checkpoint_size_mismatch(tmp_path):
    rt = _load(SCENE)
    rt.step(spi=1)
    rt.saveCheckpoint(tmp_path / "ck.npz")
    other = copy.deepcopy(SCENE)
    other["film"]["size"] = [8, 8]
    with pytest.raises(ValueError):
        _load(other).loadCheckpoint(tmp_path / "ck.npz")


def test_tonemap_imageinfo_api():
    rt = _load(SCENE)
    rt.step(spi=2)
    tm = rt.tonemap("aces")
    assert tm.shape == (16, 16, 3) and isinstance(tm, np.ndarray)
    assert tm.min() >= 0.0 and tm.max() <= 1.0
    linear = rt.tonemap("none", gamma=False)
    assert np.allclose(linear[linear < 1.0],
                       rt.currentFrame()[linear < 1.0], atol=1e-5)
    info = rt.imageinfo(histogram=True, percentile=True)
    assert info["max"] >= info["avg"] >= info["min"] >= 0
    assert info["nan_count"] == 0 and info["inf_count"] == 0
    assert "histogram" in info and "soft_max" in info
    assert int(info["histogram"].sum()) == 16 * 16


# --------------------------------------------------------------------- glare

def make_cam(fov=60.0, aspect=1.0):
    s = math.tan(math.radians(fov) / 2)
    return CameraConfig(
        type="perspective", eye=np.zeros(3, np.float32),
        dir=np.array([0, 0, 1], np.float32),
        up=np.array([0, 1, 0], np.float32),
        scale=np.array([s * aspect, s], np.float32), tmin=0.0, tmax=1e30)


def _frustum(cam):
    sw, sh = cam.scale
    return 4 * math.atan(sw * sh / math.sqrt(1 + sw * sw + sh * sh))


def test_solid_angle_sums_to_frustum():
    cam = make_cam(fov=90.0)
    omega = pixel_solid_angles(cam, 64, 64).numpy()
    assert omega.shape == (64, 64) and (omega > 0).all()
    assert np.sum(omega) == pytest.approx(_frustum(cam), rel=2e-3)


def test_no_glare_dgp_is_ev_term_only():
    cam = make_cam()
    img = np.full((32, 32, 3), 0.25, np.float32)
    out, heat, mask = evaluate_glare_host(
        cam, img, GlareSettings(max=1.0, avg=0.25, mul=50.0, scale=1.0))
    assert out.num_pixels == 0 and not mask.any()
    assert out.dgp == pytest.approx(5.87e-5 * out.vertical_illuminance + 0.16,
                                    abs=1e-6)
    lum = WHITE_EFFICIENCY * 0.25
    assert 0 < out.vertical_illuminance < lum * _frustum(cam)


def test_bright_source_raises_dgp():
    cam = make_cam()
    base = np.full((64, 64, 3), 0.05, np.float32)
    out0, _, _ = evaluate_glare_host(
        cam, base, GlareSettings(max=1.0, avg=0.05, mul=6.0))
    img = base.copy()
    img[28:36, 28:36] = 500.0
    out1, heat, mask = evaluate_glare_host(
        cam, img, GlareSettings(max=500.0, avg=0.05, mul=6.0))
    assert out1.num_pixels == 64 and mask.sum() == 64
    assert out1.dgp > out0.dgp and 0.0 < out1.dgp <= 1.5
    assert out1.avg_lum > WHITE_EFFICIENCY * 0.05 * 6.0
    assert heat[32, 32].sum() > heat[0, 0].sum()


def test_fixed_vertical_illuminance_passthrough():
    img = np.full((16, 16, 3), 0.1, np.float32)
    out, _, _ = evaluate_glare_host(
        make_cam(), img, GlareSettings(max=1.0, avg=0.1, mul=100.0,
                                       vertical_illuminance=1234.5))
    assert out.vertical_illuminance == pytest.approx(1234.5)


def test_runtime_evaluate_glare_end_to_end():
    from ignis_tpu_torch.scenes import demo_scene
    rt = Runtime(demo_scene(), width=32, height=32, device="cpu")
    rt.step(spi=1)
    out, heat, mask = rt.evaluateGlare(mul=3.0)
    assert np.isfinite(out.dgp)
    assert heat.shape == (32, 32, 3) and mask.shape == (32, 32)


# ------------------------------------------------------------------- denoise

def test_denoise_reduces_noise_preserves_edges():
    from ignis_tpu_torch.render.denoise import atrous_denoise
    rng = np.random.RandomState(0)
    h = w = 64
    clean = np.zeros((h, w, 3), np.float32)
    clean[:, : w // 2] = 0.2
    clean[:, w // 2:] = 0.8
    normals = np.zeros((h, w, 3), np.float32)
    normals[:, : w // 2, 2] = 1.0
    normals[:, w // 2:, 0] = 1.0
    depth = np.ones((h, w), np.float32)
    noisy = clean + rng.normal(0, 0.15, clean.shape).astype(np.float32)
    out = atrous_denoise(noisy, normals=normals, depth=depth).numpy()
    assert np.abs(out - clean).mean() < 0.35 * np.abs(noisy - clean).mean()
    assert abs(out[:, : w // 2 - 2].mean() - 0.2) < 0.05
    assert abs(out[:, w // 2 + 2:].mean() - 0.8) < 0.05


def _denoise_scene():
    sc = copy.deepcopy(SCENE)
    sc["film"] = {"size": [32, 32]}
    sc["lights"] = [{"type": "area", "name": "l", "entity": "p2",
                     "radiance": 4},
                    {"type": "point", "name": "pl", "position": [0.5, 0.5, -1],
                     "intensity": [1, 1, 1]}]
    sc["shapes"].append({"type": "rectangle", "name": "p2", "width": 0.3,
                         "height": 0.3,
                         "transform": [{"translate": [0, 0.8, -0.5]}]})
    sc["bsdfs"].append({"type": "diffuse", "name": "b", "reflectance": 0})
    sc["entities"].append({"name": "p2", "shape": "p2", "bsdf": "b"})
    return sc


def test_denoise_runtime_end_to_end():
    from ignis_tpu_torch.render.denoise import denoise_runtime
    rt = _load(_denoise_scene())
    rt.step(spi=1)
    noisy = rt.currentFrame()
    out = denoise_runtime(rt)
    assert out.shape == noisy.shape and np.isfinite(out).all()
    assert out.std() < noisy.std()
    assert abs(out.mean() - noisy.mean()) < 0.25 * max(noisy.mean(), 1e-6)


# ------------------------------------------------------ port against the JAX

def _bad_image(seed=0, h=14, w=18):
    r = np.random.default_rng(seed)
    img = r.exponential(0.6, (h, w, 3)).astype(np.float32)
    img[1, 2] = [np.nan, 0.5, 0.5]
    img[3, 4] = [np.inf, 1.0, 1.0]
    img[5, 6] = [0.5, -0.25, 0.5]
    img[7, 8] = [-np.inf, 0.0, 0.0]
    img[9, 10] = 0.0
    return img


@pytest.mark.parametrize("method", range(5))
def test_tonemap_matches(method):
    from ignis_tpu.render import tonemap as jtm
    from ignis_tpu_torch.render import tonemap as ttm
    img = _bad_image()
    for gamma, tol in ((False, 1e-6), (True, 4e-6)):
        kw = dict(method=method, scale=1.3, exposure_factor=0.8,
                  exposure_offset=0.05, use_gamma=gamma)
        ref = np.asarray(jtm.tonemap(img, **kw))
        got = ttm.tonemap(torch.from_numpy(img), **kw).numpy()
        np.testing.assert_allclose(got, ref, rtol=4e-6, atol=tol)
    # the false colours: cyan NaN, pink Inf, orange negative
    assert got[1, 2].tolist() == [0.0, 1.0, 1.0]
    assert got[3, 4].tolist() == [1.0, 0.0, np.float32(150 / 255)]
    assert got[5, 6].tolist() == [1.0, 1.0, 0.0]


def test_image_info_matches():
    from ignis_tpu.render import tonemap as jtm
    from ignis_tpu_torch.render import tonemap as ttm
    img = _bad_image(1)
    ref = jtm.image_info(img, scale=2.0, bins=16, histogram=True,
                         percentile=True)
    got = ttm.image_info(torch.from_numpy(img), scale=2.0, bins=16,
                         histogram=True, percentile=True)
    assert ref.keys() == got.keys()
    for k in ("nan_count", "inf_count", "neg_count", "histogram"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert got["histogram"].dtype == torch.int32
    assert (int(got["nan_count"]), int(got["inf_count"]),
            int(got["neg_count"])) == (1, 2, 2)
    for k in ("min", "max", "avg", "soft_min", "soft_max", "median"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def _glare_cams(kind):
    from conftest import create_flat_scene
    from ignis_tpu.scene.compile import load_and_compile as j_compile
    from ignis_tpu_torch.scene.compile import load_and_compile as t_compile
    s = create_flat_scene()
    s["camera"] = dict(s["camera"], type=kind, mode="circular")
    return (j_compile(copy.deepcopy(s), 24, 20).camera,
            t_compile(s, 24, 20).camera)


@pytest.mark.parametrize("kind", ["perspective", "fishlens"])
def test_evaluate_glare_matches(kind):
    from ignis_tpu.render import glare as jg
    jcam, tcam = _glare_cams(kind)
    img = _bad_image(2, 20, 24)
    img[8:12, 10:14] = 40.0              # a glare source off the centre
    settings = dict(max=40.0, avg=0.6, mul=6.0, scale=1.0)
    ref, rheat, rmask = jg.evaluate_glare_host(jcam, img,
                                               jg.GlareSettings(**settings))
    got, gheat, gmask = evaluate_glare_host(tcam, img,
                                            GlareSettings(**settings))
    assert got.num_pixels == ref.num_pixels > 0
    np.testing.assert_array_equal(gmask, rmask)
    for f in ("dgp", "vertical_illuminance", "avg_lum", "avg_omega"):
        assert getattr(got, f) == pytest.approx(getattr(ref, f), rel=1e-5), f
    np.testing.assert_allclose(gheat, rheat, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        pixel_solid_angles(tcam, 24, 20).numpy(),
        np.asarray(jg.pixel_solid_angles(jcam, 24, 20)), rtol=0, atol=2e-6)


def test_atrous_denoise_matches():
    from ignis_tpu.render.denoise import atrous_denoise as j_atrous
    from ignis_tpu_torch.render.denoise import atrous_denoise
    r = np.random.default_rng(4)
    h, w = 20, 24
    color = r.uniform(0, 1, (h, w, 3)).astype(np.float32)
    normals = r.normal(0, 1, (h, w, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    depth = r.uniform(1, 3, (h, w)).astype(np.float32)
    albedo = r.uniform(0, 1, (h, w, 3)).astype(np.float32)
    for kw in (dict(), dict(normals=normals, depth=depth, albedo=albedo)):
        ref = np.asarray(j_atrous(color, iterations=3, **kw))
        got = atrous_denoise(color, iterations=3, **kw).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
