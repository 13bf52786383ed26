"""The single-intersection techniques (`render/techniques.py`) against the
JAX package's: `simple_technique_wave` for every technique and every debug
mode, and `infobuffer_aovs`, per lane.

Both packages get the JAX compiler's raw tables (no `bw_*` / `pb_*`), so both
trace through the Moeller-Trumbore sweep on the CPU, with the same hit
predicate.  Two scenes: the flat scene, and a scene with an analytic glass
sphere, whose hits carry prim ids past the soup (the clamped gather of the
`prim id` modes), and an emissive quad holding a medium.

Tolerance: ids, flags and colour-map entries exact; floats within 1e-5
(absolute and relative).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import create_flat_scene
from ignis_tpu.render import techniques as jt
from ignis_tpu.scene.compile import load_and_compile as j_compile
from ignis_tpu_torch.convert import runtime_from_jax_tables
from ignis_tpu_torch.render import techniques as tt

TOL = 1e-5
FILM = (12, 10)
# the modes whose every value is an id, a flag colour or a colour-map entry
EXACT_MODES = {"raw prim id", "prim id", "raw entity id", "entity id",
               "raw material id", "material id", "is emissive",
               "is specular", "is entering", "medium inner", "medium outer"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops on these small films run faster on one intra-op
    thread, and the test workers sharing the CPU then do not oversubscribe
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat():
    s = copy.deepcopy(create_flat_scene())
    s["film"] = {"size": list(FILM)}
    return s


def _sphere_scene():
    """The flat scene with an analytic glass sphere and an emissive quad that
    holds a medium (an entity with a medium is tessellated, not analytic)."""
    s = _flat()
    s["bsdfs"] += [{"type": "dielectric", "name": "glass"},
                   {"type": "diffuse", "name": "lamp",
                    "reflectance": [0.2, 0.3, 0.4]}]
    s["shapes"] += [
        {"type": "sphere", "name": "ball", "center": [0.25, 0.1, -0.2],
         "radius": 0.35},
        {"type": "rectangle", "name": "quad", "width": 0.6, "height": 0.4,
         "transform": {"translate": [-0.45, -0.3, -0.1]}}]
    s["entities"] += [
        {"name": "ball", "shape": "ball", "bsdf": "glass"},
        {"name": "quad", "shape": "quad", "bsdf": "lamp",
         "inner_medium": "fog"}]
    s["media"] = [{"type": "homogeneous", "name": "fog",
                   "sigma_s": [1, 1, 1]}]
    s["lights"] = [{"type": "area", "name": "l", "entity": "quad",
                    "radiance": [2, 2, 2]}]
    return s


SCENES = {"flat": _flat, "sphere": _sphere_scene}
_CACHE = {}


def _setup(name, technique):
    """(JAX compiled scene, its jnp tables, the port's Runtime on the same
    tables), the technique set on both."""
    key = (name, tuple(sorted(technique.items())))
    if key not in _CACHE:
        s = SCENES[name]()
        s["technique"] = dict(technique)
        js = j_compile(s, *FILM)
        jtab = {k: jnp.asarray(v) for k, v in js.tables.items()}
        trt = runtime_from_jax_tables(js, js.tables, device="cpu", seed=5)
        _CACHE[key] = (js, jtab, trt)
    return _CACHE[key]


def _lanes():
    w, h = FILM
    idx = np.arange(w * h, dtype=np.int32)
    return idx % w, idx // w


def _both(name, technique, sample=1, iteration=2, seed=5):
    js, jtab, trt = _setup(name, technique)
    x, y = _lanes()
    ref = np.asarray(jt.simple_technique_wave(
        js, jtab, jnp.asarray(x), jnp.asarray(y), jnp.uint32(sample),
        jnp.uint32(iteration), jnp.uint32(0), seed))
    got = tt.simple_technique_wave(
        trt.scene, trt.tables, torch.from_numpy(x), torch.from_numpy(y),
        sample, iteration, 0, seed).numpy()
    return np.broadcast_to(ref, got.shape), got


def test_debug_mode_list_is_the_reference_list():
    assert tt.DEBUG_MODES == jt.DEBUG_MODES and len(tt.DEBUG_MODES) == 28
    np.testing.assert_array_equal(tt._COLOR_MAP, jt._COLOR_MAP)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("mode", tt.DEBUG_MODES + ["no such mode"])
def test_debug_mode_per_lane(mode, scene):
    ref, got = _both(scene, {"type": "debug", "mode": mode})
    assert got.shape == (FILM[0] * FILM[1], 3) and np.isfinite(got).all()
    if mode in EXACT_MODES:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("tech", ["ao", "wireframe", "lightvisibility",
                                  "camera_check", "infobuffer"])
def test_technique_per_lane(tech, scene):
    ref, got = _both(scene, {"type": tech})
    assert got.shape == (FILM[0] * FILM[1], 3)
    if tech in ("ao", "lightvisibility", "camera_check"):
        np.testing.assert_array_equal(got, ref)
        assert got.max() == 1.0
    else:
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    if tech == "wireframe" and scene == "sphere":
        assert (got > 0).any()


def test_sphere_hits_reach_the_clamped_gathers():
    """The sphere scene's camera rays hit the analytic sphere, whose prim ids
    lie past `tri_prim`, and the quad's medium."""
    _, _, trt = _setup("sphere", {"type": "debug", "mode": "raw prim id"})
    from ignis_tpu_torch.render.integrator import (
        _emit_camera, _traverse_closest, sphere_prim_base,
    )
    x, y = (torch.from_numpy(a) for a in _lanes())
    _, _, org, d, tmin, tmax = _emit_camera(trt.scene, x, y, 1, 2, 0, 5,
                                            trt.tables)
    prim = _traverse_closest(trt.scene, trt.tables, org, d, tmin, tmax,
                             None, mask_bit=0x1)[3]
    assert (prim >= sphere_prim_base(trt.tables)).any()
    assert int(prim.max()) >= trt.tables["tri_prim"].shape[0]
    ref, got = _both("sphere", {"type": "debug", "mode": "medium inner"})
    assert (got > 0).any()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_infobuffer_aovs_per_lane(scene):
    js, jtab, trt = _setup(scene, {"type": "infobuffer"})
    x, y = _lanes()
    ref = jt.infobuffer_aovs(js, jtab, jnp.asarray(x), jnp.asarray(y),
                             jnp.uint32(0), jnp.uint32(3), jnp.uint32(0), 5)
    got = tt.infobuffer_aovs(trt.scene, trt.tables, torch.from_numpy(x),
                             torch.from_numpy(y), 0, 3, 0, 5)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    assert (got["Depth"] > 0).any()


def test_ray_list_form_dispatches_to_the_technique():
    """`trace_wave` with `org` given (the ray-list emitter) shades through
    the technique too: `camera_check` is 1 where a ray hits, 0 where not."""
    _, _, trt = _setup("flat", {"type": "camera_check"})
    rays = [((0, 0, -1), (0, 0, 1)), ((0, 0, -1), (0, 0, -1)),
            ((0.5, 0.5, -1), (0, 0, 1), 0.0, 0.5)]
    np.testing.assert_array_equal(trt.trace(rays), [[1, 1, 1], [0, 0, 0],
                                                    [0, 0, 0]])
