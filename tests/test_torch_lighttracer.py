"""The port's light emission and light tracer against the JAX package's.

* `sample_light_emission` for each of the nine light types (a scene each,
  its light beside the box's plane light, 4096 seeded lanes): counters and
  `infinite` exact; pos, dir, intensity, cos, le_area and nrm within 1e-5
  relative (1e-6 absolute) on every lane but at most 10 of 4096, which stay
  within 1e-3 (the rule of test_torch_lights_breadth.py: the last bit of a
  trig function, amplified on a few lanes); an environment's intensity may
  pass 1e-5 on 1 % of its lanes (`_env_intensity` says why).
* `render_lighttracer` per pixel on the box with a glass sphere over its
  floor at max_depth 1 and 2, on tests/test_lt_ppm.py's box at max_depth 2
  with and without a clamp: 1e-5 relative, 1e-6 absolute; on the glass box
  at max_depth 4 the image mean within 1e-4 relative (a lane's path may
  take another branch on a last-bit difference at a later bounce).  Both
  packages get the JAX compiler's raw tables, so both trace through the
  Moeller-Trumbore sweep; the light tracer also in padded tiles.
* tests/test_lt_ppm.py's light-tracer tests through the port's `Runtime`,
  each with its own statistical tolerance, and `Runtime.trace` on a
  light-tracer scene against the JAX package's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.light.emission import sample_light_emission as j_emission
from ignis_tpu.render.lighttracer import render_lighttracer as j_render_lt
from ignis_tpu.scene.compile import load_and_compile as j_compile
from ignis_tpu_torch.api import Runtime
from ignis_tpu_torch.convert import runtime_from_jax_tables
from ignis_tpu_torch.light.emission import sample_light_emission
from ignis_tpu_torch.render.lighttracer import render_lighttracer
from ignis_tpu_torch.scene.compile import (
    LIGHT_AREA_MESH, LIGHT_AREA_PLANE, LIGHT_AREA_SPHERE, LIGHT_DIRECTIONAL,
    LIGHT_ENV, LIGHT_ENV_CDF, LIGHT_POINT, LIGHT_SPOT, LIGHT_SUN,
)
from test_lt_ppm import _box_scene, _mix_box
from test_torch_lights_breadth import (
    FIELD, N, _env_exr, _exact, _lanes_rel, _t,
)

FILM = 16
PIXEL = dict(rtol=1e-5, atol=1e-6)
MEAN_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops on these small films run faster on one intra-op
    thread, and the test workers sharing the CPU then do not oversubscribe
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def glass_box(tech):
    """tests/test_lt_ppm.py's box with a glass sphere over its floor: light
    through the sphere onto the floor (LS*D paths)."""
    s = _box_scene(tech)
    s["bsdfs"].append({"type": "dielectric", "name": "glass"})
    s["shapes"].append({"type": "sphere", "name": "ball",
                        "center": [0.1, -0.6, 0.0], "radius": 0.3})
    s["entities"].append({"name": "ball", "shape": "ball", "bsdf": "glass"})
    return s


SCENES = {"box": _box_scene, "glass": glass_box}


# ---------------------------------------------------------------- emission
def _add_emitter(s, shape, light):
    s["shapes"].append(dict(shape, name="emitter"))
    s["entities"].append({"name": "emitter", "shape": "emitter",
                          "bsdf": "white"})
    s["lights"].append(dict(light, entity="emitter"))


def _emission_scene(what, tmp_path):
    s = _box_scene({"type": "lighttracer"})
    area = {"type": "area", "name": "x", "radiance": [2, 3, 4]}
    if what == "point":
        s["lights"].append({"type": "point", "name": "x",
                            "position": [0.1, 0.2, 0.3],
                            "intensity": [2, 1, 1]})
    elif what == "area mesh":
        _add_emitter(s, {"type": "icosphere", "center": [0.3, -0.4, 0.2],
                         "radius": 0.2, "subdivisions": 1}, area)
    elif what == "area sphere":
        _add_emitter(s, {"type": "sphere", "center": [-0.3, -0.5, 0.1],
                         "radius": 0.25}, area)
    elif what == "directional":
        s["lights"].append({"type": "directional", "name": "x",
                            "direction": [0.3, -1, 0.2],
                            "irradiance": [1, 2, 3]})
    elif what == "spot":
        s["lights"].append({"type": "spot", "name": "x",
                            "position": [0.2, 0.5, -0.1],
                            "direction": [0, -1, 0.2],
                            "intensity": [2, 1, 1], "cutoff": 40,
                            "falloff": 30})
    elif what == "sun":
        s["lights"].append({"type": "sun", "name": "x",
                            "direction": [0.2, -0.5, 1.0],
                            "irradiance": [3, 2.5, 2]})
    elif what == "env":
        s["lights"].append({"type": "env", "name": "x",
                            "radiance": [0.5, 0.6, 0.7]})
    elif what == "env cdf":
        s["textures"] = [{"type": "image", "name": "env",
                          "filename": _env_exr(tmp_path),
                          "filter_type": "bilinear"}]
        s["lights"].append({"type": "env", "name": "x", "radiance": "env",
                            "scale": 0.6,
                            "transform": {"rotate": [20, 35, 0]}})
    return s


EMITTERS = {
    "point": LIGHT_POINT, "area plane": LIGHT_AREA_PLANE,
    "area mesh": LIGHT_AREA_MESH, "area sphere": LIGHT_AREA_SPHERE,
    "directional": LIGHT_DIRECTIONAL, "spot": LIGHT_SPOT, "sun": LIGHT_SUN,
    "env": LIGHT_ENV, "env cdf": LIGHT_ENV_CDF,
}


@pytest.mark.parametrize("what", sorted(EMITTERS))
def test_sample_light_emission(what, tmp_path):
    js = j_compile(_emission_scene(what, tmp_path), FILM, FILM)
    assert js.lights[-1].type == EMITTERS[what]
    jt = {k: jnp.asarray(v) for k, v in js.tables.items()}
    trt = runtime_from_jax_tables(js, js.tables, device="cpu")
    r = np.random.default_rng(17)
    lidx = r.integers(0, js.num_lights, N).astype(np.int32)
    seed = r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    ctr = r.integers(0, 2**32 - 8, N, dtype=np.uint64).astype(np.uint32)
    active = r.uniform(size=N) < 0.8
    ref, jc = j_emission(js, jt, jnp.asarray(lidx), jnp.asarray(seed),
                         jnp.asarray(ctr), jnp.asarray(active))
    got, tc = sample_light_emission(trt.scene, trt.tables, _t(lidx),
                                    _t(seed), _t(ctr), _t(active))
    _exact(tc, jc)
    assert got.keys() == ref.keys()
    _exact(got["infinite"], ref["infinite"])
    for k in ("pos", "dir", "cos", "le_area", "nrm"):
        _lanes_rel(got[k], ref[k], **FIELD)
    if EMITTERS[what] in (LIGHT_ENV, LIGHT_ENV_CDF):
        _env_intensity(js, jt, got, ref, lidx == js.num_lights - 1)
    else:
        _lanes_rel(got["intensity"], ref["intensity"], **FIELD)
    # every lane of the scene's last light emits
    assert (np.abs(got["intensity"].numpy()[lidx == js.num_lights - 1])
            .sum(axis=-1) > 0).mean() > 0.5


def _env_intensity(js, jt, got, ref, env):
    """An environment's photon intensity is its radiance along an
    equal-area direction: two trig evaluations in a row (the direction, then
    its image uv by atan2 / arccos), each of whose last bit the image's
    steep texels amplify (the 40.0 texel of test_torch_lights_breadth's
    image; one ulp of uv moves the radiance by up to 1.2e-4 there, in the
    JAX package's own lookup as in the port's).  So the environment's lanes
    may pass 1e-5 on at most 1 % of them (15 of 2,040 on the CPU), and stay
    within 1e-3; the other lanes hold to the rule of the other fields."""
    gi, ri = got["intensity"].numpy(), np.asarray(ref["intensity"])
    _lanes_rel(np.where(env[:, None], 0.0, gi),
               np.where(env[:, None], 0.0, ri), **FIELD)
    bad = env & ~np.isclose(gi, ri, **FIELD).all(axis=1)
    assert bad.sum() <= 0.01 * env.sum(), bad.sum()
    np.testing.assert_allclose(gi, ri, rtol=1e-3, atol=FIELD["atol"])


# ------------------------------------------------------------ light tracer
_SETUP = {}


def _setup(name, technique):
    key = (name, tuple(sorted(technique.items())))
    if key not in _SETUP:
        js = j_compile(SCENES[name](dict(technique)), FILM, FILM)
        jt = {k: jnp.asarray(v) for k, v in js.tables.items()}
        trt = runtime_from_jax_tables(js, js.tables, device="cpu", seed=7)
        _SETUP[key] = (js, jt, trt)
    return _SETUP[key]


N_PATHS = FILM * FILM * 2
_REF = {}


def _renders(name, technique, tile=1 << 16):
    js, jt, trt = _setup(name, technique)
    key = (name, tuple(sorted(technique.items())))
    if key not in _REF:
        _REF[key] = np.asarray(jax.jit(lambda t: j_render_lt(
            js, t, N_PATHS, jnp.uint32(3), jnp.uint32(1), 7))(jt))
    got = render_lighttracer(trt.scene, trt.tables, N_PATHS, 3, 1, 7,
                             tile=tile).numpy()
    return got, _REF[key]


CASES = [("glass", 1, 0.0), ("glass", 2, 0.0), ("box", 2, 0.0),
         ("box", 2, 0.5)]


@pytest.mark.parametrize("name,depth,clamp", CASES)
def test_render_lighttracer_per_pixel(name, depth, clamp):
    tech = {"type": "lighttracer", "max_depth": depth, "clamp": clamp}
    got, ref = _renders(name, tech)
    assert got.shape == ref.shape == (FILM * FILM, 3)
    assert ref.mean() > 0
    np.testing.assert_allclose(got, ref, **PIXEL)
    if clamp > 0:
        # a lane's splat is clamped: no pixel sum over the paths' count
        assert got.max() <= clamp * N_PATHS


def test_render_lighttracer_mean_at_depth_4():
    got, ref = _renders("glass", {"type": "lighttracer", "max_depth": 4})
    assert np.isfinite(got).all()
    assert abs(got.mean() - ref.mean()) <= MEAN_REL * abs(ref.mean())


def test_render_lighttracer_tiles():
    """Tiles of 96 lanes (the last one padded) trace the same paths: only
    the order of the splat's sums changes."""
    got, ref = _renders("glass", {"type": "lighttracer", "max_depth": 2},
                        tile=96)
    np.testing.assert_allclose(got, ref, **PIXEL)


# ---------------------------------------------- through the port's Runtime
def _render_mean(scene, iters, spi):
    rt = Runtime(json.dumps(scene), device="cpu")
    for _ in range(iters):
        rt.step(spi=spi)
    img = rt.currentFrame()
    assert np.isfinite(img).all()
    return img.mean()


@pytest.mark.parametrize("technique", ["lighttracer", "lt"])
def test_lighttracer_matches_path(technique):
    pt_mean = _render_mean(_box_scene({"type": "path", "max_depth": 4}), 6, 4)
    lt_mean = _render_mean(_box_scene({"type": technique, "max_depth": 4}),
                           8, 8)
    assert lt_mean > 0.0
    # same estimand, very different variance profiles
    assert abs(lt_mean - pt_mean) < 0.5 * pt_mean


def test_emission_sampling_point_light():
    """A point light's photons: intensity over the uniform sphere pdf, four
    draws a lane, directions over the whole sphere."""
    sc = _box_scene({"type": "path"})
    sc["lights"] = [{"type": "point", "name": "p",
                     "position": [0.1, 0.2, 0.3], "intensity": [2, 2, 2]}]
    rt = Runtime(json.dumps(sc), device="cpu")
    n = 256
    seed = torch.arange(n, dtype=torch.int64) * 977
    em, c2 = sample_light_emission(
        rt.scene, rt.tables, torch.zeros(n, dtype=torch.int32), seed,
        torch.ones(n, dtype=torch.int64), torch.ones(n, dtype=torch.bool))
    assert (c2 == 5).all()
    np.testing.assert_allclose(em["pos"].numpy(),
                               np.tile([0.1, 0.2, 0.3], (n, 1)), atol=1e-6)
    np.testing.assert_allclose(em["intensity"].numpy(), 2 * 4 * np.pi,
                               rtol=1e-4)
    d = em["dir"].numpy()
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-4)
    assert (d[:, 2] > 0).any() and (d[:, 2] < 0).any()


def test_lighttracer_respects_mix_weight():
    """The light tracer goes through the two-lobe BSDF dispatch: a mix of
    diffuse(0.9) and diffuse(0.1) at 0.75 renders as diffuse(0.3)."""
    tech = {"type": "lighttracer", "max_depth": 4}
    ref = _render_mean(_mix_box(tech, mixed=False), 8, 8)
    mix = _render_mean(_mix_box(tech, mixed=True), 8, 8)
    assert mix > 0.0
    assert abs(mix - ref) < 0.25 * ref


def test_trace_of_a_lighttracer_scene():
    """`Runtime.trace` traces camera paths under any technique: on a
    light-tracer scene it gives the bits of the same scene under `path`, and
    the JAX package's radiance within 1e-3 relative (one of these 24 rays
    sits at 1.4e-4 under `path` too: the arccos of the plane light's
    spherical-rectangle sample, near its last bit), every other ray within
    1e-5."""
    from ignis_tpu.api import load_scene as j_load_scene
    r = np.random.default_rng(5)
    rays = [((float(x), float(y), 3.0), (0.0, 0.0, -1.0))
            for x, y in r.uniform(-0.9, 0.9, (24, 2))]
    scene = glass_box({"type": "lighttracer", "max_depth": 2})
    ref = np.asarray(j_load_scene(json.dumps(scene)).trace(rays, spp=2))
    got = Runtime(json.dumps(scene), device="cpu").trace(rays, spp=2)
    path = Runtime(json.dumps(dict(scene, technique={
        "type": "path", "max_depth": 2})), device="cpu").trace(rays, spp=2)
    np.testing.assert_array_equal(got, path)
    assert ref.mean() > 0
    near = np.isclose(got, ref, **PIXEL).all(axis=1)
    assert (~near).sum() <= 1
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=PIXEL["atol"])
