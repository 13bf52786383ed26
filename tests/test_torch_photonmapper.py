"""The port's progressive photon mapper against the JAX package's, function
by function, on tests/test_lt_ppm.py's box and on the box with a glass
sphere over its floor (LS*D paths: photons through the sphere onto the
floor).  Both packages get the JAX compiler's raw tables, so both trace
through the Moeller-Trumbore sweep.

* `ppm_compute_radius`: exact.
* `trace_photons` per lane: valid, depth and light exact; pos, in_dir and
  power within 1e-5 relative (1e-6 absolute); at max_light_depth 2 and, on
  the glass box, at 4, where photons cross the sphere before they land.
* `build_photon_grid`, fed the JAX package's photons with one cell crowded
  past CELL_CAP: every array exact (the sort is stable in both packages).
* `gather_photons` per lane, on the same grid, surface and radius: 1e-5
  relative (the port sums a cell's slots at once, the JAX package one by
  one; the sums differ in order only); in lane chunks the same bits.
* `render_ppm` per pixel at max_depth 2 (the box): 1e-5 relative; at
  max_depth 4 (the glass box) the image mean within 1e-4 (a lane may take
  another branch on a last-bit difference at a later bounce).
* Two steps of both `Runtime`s on the glass box at max_depth 2, per pixel,
  and
  tests/test_lt_ppm.py's photon-mapper tests through the port's `Runtime`,
  each with its own statistical tolerance.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ignis_tpu.render.photonmapper as jp
import ignis_tpu_torch.render.photonmapper as tp
from ignis_tpu.scene.compile import load_and_compile as j_compile
from ignis_tpu_torch.api import Runtime
from ignis_tpu_torch.convert import runtime_from_jax_tables
from test_lt_ppm import _box_scene, _mix_box
from test_torch_lighttracer import SCENES

FILM = 16
FIELD = dict(rtol=1e-5, atol=1e-6)
MEAN_REL = 1e-4
N_PHOTONS = 20000
CROWD = 200      # photons moved into one cell, past CELL_CAP


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops on these small films run faster on one intra-op
    thread, and the test workers sharing the CPU then do not oversubscribe
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tech(max_depth, max_light_depth=8):
    return {"type": "photonmapper", "max_depth": max_depth,
            "max_light_depth": max_light_depth, "photons": N_PHOTONS,
            "radius": 0.05}


_SETUP = {}


def _setup(name, technique):
    key = (name, tuple(sorted(technique.items())))
    if key not in _SETUP:
        js = j_compile(SCENES[name](dict(technique)), FILM, FILM)
        jt = {k: jnp.asarray(v) for k, v in js.tables.items()}
        trt = runtime_from_jax_tables(js, js.tables, device="cpu", seed=7)
        _SETUP[key] = (js, jt, trt)
    return _SETUP[key]


def _torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


_PHOTONS = {}


def _photons(name, technique):
    """The JAX package's photons of the scene (iteration 1, seed 7)."""
    js, jt, _ = _setup(name, technique)
    key = (name, tuple(sorted(technique.items())))
    if key not in _PHOTONS:
        _PHOTONS[key] = {k: np.asarray(v) for k, v in jax.jit(
            lambda t: jp.trace_photons(js, t, N_PHOTONS, jnp.uint32(1),
                                       jnp.uint32(0), 7))(jt).items()}
    return _PHOTONS[key]


def _crowded(photons):
    """The photons with the first CROWD valid ones moved to one point of the
    floor, so that their cell holds more than CELL_CAP."""
    p = dict(photons)
    pos = p["pos"].copy()
    first = np.nonzero(p["valid"])[0][:CROWD]
    pos[first] = [0.02, -1.0, 0.03]
    p["pos"] = pos
    return p


def _few_lanes(got, ref, few=0.0025, loose=1e-3):
    """Within FIELD on all lanes but at most `few` of them, which stay within
    `loose` relative: a photon refracted twice through the sphere near its
    rim carries a last-bit difference of the sphere's intersection on (16
    of 20,000 photons at max_light_depth 4 on the CPU)."""
    a = got.astype(np.float64).reshape(got.shape[0], -1)
    b = np.asarray(ref).astype(np.float64).reshape(got.shape[0], -1)
    ok = np.isclose(a, b, **FIELD).all(axis=1)
    assert (~ok).sum() <= few * a.shape[0], (~ok).sum()
    np.testing.assert_allclose(a, b, rtol=loose, atol=FIELD["atol"])


def test_ppm_compute_radius():
    for r, it in ((1.0, 0), (1.0, 5), (0.3, 20), (2e-4, 60), (0.07, 1)):
        assert tp.ppm_compute_radius(r, it) == jp.ppm_compute_radius(r, it)
    assert tp.ppm_compute_radius(1.0, 20) < tp.ppm_compute_radius(1.0, 5) \
        < tp.ppm_compute_radius(1.0, 0) == 1.0


@pytest.mark.parametrize("name,light_depth", [("box", 2), ("glass", 2),
                                              ("glass", 4)])
def test_trace_photons_per_lane(name, light_depth):
    tech = _tech(4, light_depth)
    _, _, trt = _setup(name, tech)
    ref = _photons(name, tech)
    # tiles of 3000 lanes, the last one padded
    got = tp.trace_photons(trt.scene, trt.tables, N_PHOTONS, 1, 0, 7,
                           tile=3000)
    assert got.keys() == ref.keys()
    for k in ("valid", "depth", "light"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    for k in ("pos", "in_dir", "power"):
        _few_lanes(got[k].numpy(), ref[k])
    assert ref["valid"].mean() > 0.3
    if light_depth == 4:
        # photons that crossed the sphere land at depth 3
        assert (ref["depth"][ref["valid"]] == 3).sum() > 10


def test_build_photon_grid():
    js, _, trt = _setup("box", _tech(4))
    photons = _crowded(_photons("box", _tech(4)))
    ref = jp.build_photon_grid(js, {k: jnp.asarray(v)
                                    for k, v in photons.items()})
    got = tp.build_photon_grid(trt.scene, _torch(photons))
    assert got.keys() == ref.keys()
    for k in ref:
        a, b = got[k].numpy(), np.asarray(ref[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    _, counts = np.unique(np.asarray(ref["cell_sorted"]), return_counts=True)
    assert counts[:-1].max() > tp.CELL_CAP == jp.CELL_CAP
    assert tp.GRID == jp.GRID


def _camera_surface(js, jt, technique):
    """The JAX package's first camera hit of every pixel: surface, material
    type, outgoing direction and a mask of the lanes that gather."""
    from ignis_tpu.bsdf import prepare_surface
    from ignis_tpu.core.vec import FLT_MAX
    from ignis_tpu.render.integrator import (
        _emit_camera, _surface_at, _traverse_closest,
    )
    idx = np.arange(FILM * FILM, dtype=np.int32)
    x, y = jnp.asarray(idx % FILM), jnp.asarray(idx // FILM)
    seed, counter, org, d, tmin, _ = _emit_camera(
        js, x, y, jnp.uint32(0), jnp.uint32(1), jnp.uint32(0), 7, tables=jt)
    t, u, v, prim = _traverse_closest(js, jt, org, d, tmin,
                                      jnp.full_like(tmin, FLT_MAX), None)
    hit = prim >= 0
    surf = _surface_at(jt, jnp.maximum(prim, 0), org, d,
                       jnp.where(hit, t, 1.0), u, v)
    mat_type, specular = prepare_surface(js, jt, surf, d, org)
    return surf, mat_type, -d, hit & ~specular


_GATHER = {}


def _gather_setup():
    """The glass box's grid (a crowded cell in it), first camera hits, a
    seeded radius a lane, and the JAX package's gather compiled once."""
    if not _GATHER:
        tech = _tech(4, 4)
        js, jt, trt = _setup("glass", tech)
        photons = _crowded(_photons("glass", tech))
        jgrid = jp.build_photon_grid(js, {k: jnp.asarray(v)
                                          for k, v in photons.items()})
        surf, mat_type, out_dir, active = _camera_surface(js, jt, tech)
        radius = np.random.default_rng(3).uniform(
            0.02, 0.12, out_dir.shape[0]).astype(np.float32)
        fn = jax.jit(lambda t, g, s, m, o, r, c, a: jp.gather_photons(
            js, t, g, s, m, o, r, c, a, N_PHOTONS))
        _GATHER.update(js=js, jt=jt, trt=trt, jgrid=jgrid, surf=surf,
                       mat_type=mat_type, out_dir=out_dir, active=active,
                       radius=radius, fn=fn)
    return _GATHER


@pytest.mark.parametrize("cam_depth", [1, 3])
def test_gather_photons_per_lane(cam_depth, monkeypatch):
    g = _gather_setup()
    ref = np.asarray(g["fn"](g["jt"], g["jgrid"], g["surf"], g["mat_type"],
                             g["out_dir"], jnp.asarray(g["radius"]),
                             cam_depth, g["active"]))
    trt = g["trt"]
    args = (trt.scene, trt.tables,
            _torch({k: np.asarray(v) for k, v in g["jgrid"].items()}),
            _torch({k: np.asarray(v) for k, v in g["surf"].items()}),
            torch.from_numpy(np.array(g["mat_type"])),
            torch.from_numpy(np.array(g["out_dir"])),
            torch.from_numpy(g["radius"]), cam_depth,
            torch.from_numpy(np.array(g["active"])), N_PHOTONS)
    got = tp.gather_photons(*args).numpy()
    active = np.asarray(g["active"])
    assert (ref.max(axis=-1) > 0)[active].mean() > 0.8
    np.testing.assert_allclose(got, ref, **FIELD)
    # the lanes in chunks of 24 (the last one short): the same bits
    monkeypatch.setattr(tp, "GATHER_PAIRS", 24 * tp.CELL_CAP)
    np.testing.assert_array_equal(tp.gather_photons(*args).numpy(), got)


_FRAMES = {}


def _render_ppm(name, technique):
    """(port, JAX) camera pass of every pixel on the JAX package's grid."""
    js, jt, trt = _setup(name, technique)
    key = (name, tuple(sorted(technique.items())))
    jgrid = jp.build_photon_grid(js, {k: jnp.asarray(v) for k, v in
                                      _photons(name, technique).items()})
    radius = np.float32(tp.ppm_compute_radius(
        0.05 * 2.0 * js.scene_radius(), 1))
    idx = np.arange(FILM * FILM, dtype=np.int32)
    if key not in _FRAMES:
        _FRAMES[key] = np.asarray(jax.jit(lambda t, g: jp.render_ppm(
            js, t, g, jnp.asarray(idx % FILM), jnp.asarray(idx // FILM),
            jnp.uint32(1), jnp.uint32(1), jnp.uint32(0), 7,
            jnp.float32(radius), N_PHOTONS))(jt, jgrid))
    got = tp.render_ppm(
        trt.scene, trt.tables, _torch({k: np.asarray(v)
                                       for k, v in jgrid.items()}),
        torch.from_numpy(idx % FILM), torch.from_numpy(idx // FILM), 1, 1,
        0, 7, float(radius), N_PHOTONS).numpy()
    return got, _FRAMES[key]


def test_render_ppm_per_pixel():
    got, ref = _render_ppm("box", _tech(2))
    assert ref.mean() > 0
    np.testing.assert_allclose(got, ref, **FIELD)


def test_render_ppm_mean_at_depth_4():
    got, ref = _render_ppm("glass", _tech(4, 4))
    assert np.isfinite(got).all()
    assert abs(got.mean() - ref.mean()) <= MEAN_REL * abs(ref.mean())


def test_runtime_step_per_pixel():
    """Two steps of both `Runtime`s on the glass box at max_depth 2: the
    photon pass, the grid and the camera pass as a whole."""
    from ignis_tpu.api import Runtime as JRuntime
    scene = SCENES["glass"](_tech(2))
    jrt = JRuntime(scene, width=FILM, height=FILM)
    trt = Runtime(scene, width=FILM, height=FILM, device="cpu")
    for _ in range(2):
        jrt.step()
        trt.step()
    ref, got = jrt.currentFrame(), trt.currentFrame()
    assert ref.mean() > 0
    np.testing.assert_allclose(got, ref, **FIELD)


# ---------------------------------------------- through the port's Runtime
def _render_mean(scene, iters, spi):
    rt = Runtime(json.dumps(scene), device="cpu")
    for _ in range(iters):
        rt.step(spi=spi)
    img = rt.currentFrame()
    assert np.isfinite(img).all()
    return img.mean()


def test_photonmapper_runs_and_is_plausible():
    pt_mean = _render_mean(_box_scene({"type": "path", "max_depth": 4}), 6, 4)
    ppm_mean = _render_mean(_box_scene(
        {"type": "photonmapper", "max_depth": 4, "photons": 20000,
         "radius": 0.05}), 4, 2)
    assert ppm_mean > 0.0
    assert abs(ppm_mean - pt_mean) < 0.75 * pt_mean


@pytest.mark.parametrize("technique", ["ppm", "sppm"])
def test_photonmapper_names(technique):
    rt = Runtime(json.dumps(_box_scene({"type": technique, "max_depth": 3,
                                        "photons": 2000})), device="cpu")
    rt.step()
    img = rt.currentFrame()
    assert np.isfinite(img).all() and img.mean() > 0


def test_ppm_radius_shrinks():
    r0 = tp.ppm_compute_radius(1.0, 0)
    r5 = tp.ppm_compute_radius(1.0, 5)
    r20 = tp.ppm_compute_radius(1.0, 20)
    assert r0 == 1.0 and r5 < r0 and r20 < r5 and r20 >= 1e-5


def test_photonmapper_respects_mix_weight():
    """A mix of diffuse(0.9) and diffuse(0.1) at 0.75 renders as
    diffuse(0.3).  One iteration, where tests/test_lt_ppm.py takes four:
    both renders draw the same seeds, so their means move together (0.19768
    and 0.19809 after one iteration on the CPU, 0.15349 and 0.15354 after
    four; the tolerance is 30 %)."""
    tech = {"type": "photonmapper", "max_depth": 4, "photons": 20000,
            "radius": 0.05}
    ref = _render_mean(_mix_box(tech, mixed=False), 1, 2)
    mix = _render_mean(_mix_box(tech, mixed=True), 1, 2)
    assert mix > 0.0
    assert abs(mix - ref) < 0.3 * ref
