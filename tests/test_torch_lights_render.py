"""Light scenes rendered through both packages' `Runtime.step`: the
reference's light-transport scenes (tests/test_integrator_lights.py: point,
spot, env by BSDF sampling, one-sided env NEE, the two-sided furnace, the
SAT env).  Its hierarchy checks and the selectors are in
tests/test_torch_lights_selectors.py, the port's `daylight_scene()` and
`env_scene()` in tests/test_torch_lights_scenes.py; both use the helpers
here.

The port renders the JAX package's own tables (`runtime_from_jax_tables`):
per lane at depth 2 (1e-4, rtol and atol, with at most 0.5 % of the lanes
apart, as the other render tests hold a scene: a last-bit difference can
flip a branch) and by image mean at depth 6 (2 %).
"""

import copy

import numpy as np
import pytest
import torch

from conftest import create_flat_scene
from ignis_tpu.api import Runtime as JRuntime
from ignis_tpu_torch.convert import runtime_from_jax_tables
from ignis_tpu_torch.utils.exr import write_exr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops on these small films run faster on one intra-op
    thread, and the test workers sharing the CPU then do not oversubscribe
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(scene, size, spi=1, seed=0, depth=None):
    """(JAX frame, the port's frame on the JAX tables, the port runtime)."""
    scene = copy.deepcopy(scene)
    if depth is not None:
        scene["technique"] = dict(scene["technique"], max_depth=depth)
    jrt = JRuntime(scene, width=size, height=size, seed=seed)
    jrt.step(spi=spi)
    rt = runtime_from_jax_tables(jrt.scene, jrt.tables, device="cpu",
                                 seed=seed)
    rt.step(spi=spi)
    return np.asarray(jrt.currentFrame()), rt.currentFrame(), rt


def _per_lane(ref, got):
    assert np.isfinite(got).all() and got.shape == ref.shape
    ok = np.isclose(got, ref, rtol=1e-4, atol=1e-4).all(axis=-1)
    assert ok.mean() >= 0.995, (~ok).sum()


def _by_mean(ref, got):
    assert np.isfinite(got).all() and ref.mean() > 0
    assert abs(got.mean() - ref.mean()) <= 0.02 * ref.mean()


def _flat(lights, nee=True):
    s = copy.deepcopy(create_flat_scene())
    s["technique"]["nee"] = nee
    s["lights"] = lights
    return s


def _sat_scene(tmp_path):
    exr = str(tmp_path / "e.exr")
    write_exr(exr, np.random.default_rng(1).uniform(
        0, 2, (16, 32, 3)).astype(np.float32))
    return {
        "technique": {"type": "path", "max_depth": 2},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": {"translate": [0, 0, -3]}},
        "film": {"size": [24, 24]},
        "textures": [{"type": "image", "name": "env", "filename": exr}],
        "bsdfs": [{"type": "diffuse", "name": "m", "reflectance": 0.6}],
        "shapes": [{"type": "rectangle", "name": "sq", "width": 2,
                    "height": 2}],
        "entities": [{"name": "sq", "shape": "sq", "bsdf": "m"}],
        "lights": [{"type": "env", "name": "sky", "radiance": "env",
                    "cdf": True, "cdf_method": "sat"}],
    }


def _furnace(nee):
    return {
        "technique": {"type": "path", "max_depth": 3, "nee": nee},
        "camera": {"type": "perspective", "fov": 40,
                   "transform": [1, 0, 0, 0, 0, 0, 1, -5,
                                 0, -1, 0, 0, 0, 0, 0, 1]},
        "film": {"size": [24, 24]},
        "bsdfs": [{"type": "diffuse", "name": "m", "reflectance": 0.8}],
        "shapes": [{"type": "rectangle", "name": "p", "width": 60,
                    "height": 60, "transform": [{"rotate": [-90, 0, 0]}]}],
        "entities": [{"name": "p", "shape": "p", "bsdf": "m"}],
        "lights": [{"type": "constant", "name": "sky", "radiance": 1}],
    }


REFERENCE = {
    "point": lambda tmp: _flat([
        {"type": "point", "name": "_light", "position": [0, 0, -2],
         "intensity": [1, 1, 1]}]),
    "spot": lambda tmp: _flat([
        {"type": "spot", "name": "_light", "cutoff": 45, "falloff": 45,
         "position": [0, 0, -2], "direction": [0, 0, 1],
         "intensity": [1, 1, 1]}]),
    "env bsdf sampling": lambda tmp: _flat([
        {"type": "env", "name": "_light", "radiance": [1, 1, 1]}],
        nee=False),
    "env nee one-sided": lambda tmp: _flat([
        {"type": "env", "name": "_light", "radiance": [1, 1, 1]}]),
    "furnace bsdf": lambda tmp: _furnace(False),
    "furnace nee": lambda tmp: _furnace(True),
    "env sat": _sat_scene,
}


@pytest.mark.parametrize("what", sorted(REFERENCE))
def test_reference_scene_per_lane_depth2(what, tmp_path):
    ref, got, rt = _frames(REFERENCE[what](tmp_path), 16, spi=2, depth=2)
    _per_lane(ref, got)
    if what == "env bsdf sampling":
        # the furnace of the reference: exactly 1 per path
        assert got.mean() == pytest.approx(1, rel=1e-4)
    if what == "env sat":
        assert any(k.endswith("_sat") for k in rt.tables)


@pytest.mark.parametrize("what", sorted(REFERENCE))
def test_reference_scene_by_mean_depth6(what, tmp_path):
    ref, got, _ = _frames(REFERENCE[what](tmp_path), 16, spi=2, seed=1,
                          depth=6)
    _by_mean(ref, got)
