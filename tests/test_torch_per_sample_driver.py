"""The per-sample wave driver of the port's `Runtime` against the JAX
package's: a scene whose entity is hidden from the camera (camera and bounce
visibility differ, so the regenerating wavefront is not used) and an `ao`
scene, through both `Runtime`s at spi 2 over two steps, with a `tile_size`
that does not divide the film (the last tile padded with the film's last
pixel).  The port runs on the JAX package's own runtime tables.  Frames
within 1e-5.  Then tests/test_fuzz_lifecycle.py's alternation of techniques
(path, volpath, debug, path) through the port's `load_scene`.
"""

import copy
import json

import numpy as np
import pytest
import torch

from ignis_tpu.api import Runtime as JRuntime
from ignis_tpu_torch.api import load_scene
from ignis_tpu_torch.convert import runtime_from_jax_tables
from ignis_tpu_torch.scenes import demo_scene

FILM = (12, 10)
TILE = 48          # 120 pixels: tiles of 48, 48 and 24 (+ 24 padded lanes)
BACK = 2           # the demo scene's entity that fills the camera's view


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hidden_scene():
    """The demo box at depth 3 with the entity in view (`back`) hidden from
    camera rays (still seen by bounces and shadows)."""
    s = demo_scene()
    s["technique"] = dict(s["technique"], max_depth=3)
    assert s["entities"][BACK]["name"] == "back"
    s["entities"][BACK] = dict(s["entities"][BACK], camera_visible=False)
    return s


def _ao_scene():
    s = demo_scene()
    s["technique"] = {"type": "ao"}
    return s


@pytest.mark.parametrize("name,scene_fn", [("hidden", _hidden_scene),
                                           ("ao", _ao_scene)])
def test_per_sample_driver_frames(name, scene_fn):
    jrt = JRuntime(copy.deepcopy(scene_fn()), width=FILM[0], height=FILM[1],
                   seed=3, tile_size=TILE)
    trt = runtime_from_jax_tables(
        jrt.scene, {k: np.asarray(v) for k, v in jrt.tables.items()},
        device="cpu", seed=3, tile_size=TILE)
    assert not jrt._wavefront_ok and not trt._wavefront_ok
    for _ in range(2):
        jrt.step(spi=2)
        trt.step(spi=2)
    a, b = jrt.currentFrame(), trt.currentFrame()
    assert trt.currentSampleCount() == 4 and trt.iteration == 2
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    assert a.mean() > 0
    # no wave ran: the wavefront counters stay out of the stats
    stats = trt.dumpStats()
    assert "CameraRayCount: 480" in stats and "WaveIterations" not in stats


def test_hidden_entity_is_seen_by_bounces_only():
    """Hiding the entity from the camera changes the frame where it was in
    view, and the wavefront still serves the same scene unhidden."""
    from ignis_tpu_torch.api import Runtime
    hidden = Runtime(_hidden_scene(), width=FILM[0], height=FILM[1],
                     device="cpu")
    s = _hidden_scene()
    s["entities"][BACK] = dict(s["entities"][BACK], camera_visible=True)
    shown = Runtime(s, width=FILM[0], height=FILM[1], device="cpu")
    assert not hidden._wavefront_ok and shown._wavefront_ok
    hidden.step(spi=1)
    shown.step(spi=1)
    assert not np.array_equal(hidden.currentFrame(), shown.currentFrame())


def test_multiple_runtimes_lifecycle():
    """tests/test_fuzz_lifecycle.py's alternation through the port: four
    runtimes in turn (path, volpath, debug, path), each to 8 spp."""
    scenes = []
    for i, tech in enumerate(["path", "volpath", "debug", "path"]):
        scenes.append(json.dumps({
            "technique": {"type": tech, "max_depth": 3},
            "camera": {"type": "perspective", "fov": 45,
                       "transform": [1, 0, 0, 0, 0, 1, 0, 0,
                                     0, 0, 1, -2 - i, 0, 0, 0, 1]},
            "film": {"size": [12, 12]},
            "bsdfs": [{"type": "diffuse", "name": "m",
                       "reflectance": 0.3 + 0.1 * i}],
            "shapes": [{"type": "rectangle", "name": "p", "width": 2,
                        "height": 2}],
            "entities": [{"name": "p", "shape": "p", "bsdf": "m"}],
            "lights": [{"type": "point", "name": "l",
                        "position": [0, 1, -1], "intensity": [1, 1, 1]}],
        }))
    means = []
    for src in scenes:
        rt = load_scene(src, device="cpu")
        while rt.currentSampleCount() < 8:
            rt.step(spi=2)
        img = rt.currentFrame()
        assert np.isfinite(img).all()
        means.append(float(img.mean()))
        del rt
    assert means[0] != means[3]
    assert means[2] > 0          # the debug normals of the plane
