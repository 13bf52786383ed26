"""The port's analytic spheres (`ops/spheres.py`) and the sphere area light
(`light/union.py`) against the JAX package's.

Both sides are plain array code (the reference has no kernel here either).
Tolerances: sphere ids exact; t to 1e-5 relative and absolute (t = (S - Q) / D2
cancels for a hit near the origin); u, v to 1e-4 away from the u seam (XLA on
the CPU contracts multiply-adds and its `atan2` / `acos` differ from torch's
in the last bits); light samples to 1e-5; solid-angle pdfs to 1e-4 relative
where |cos| > 0.05 (they divide by the cosine, which amplifies its rounding
at grazing angles).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.light import union as jlu
from ignis_tpu.ops import spheres as jsp
from ignis_tpu.scene.compile import load_and_compile as j_compile
from ignis_tpu_torch.convert import tables_from_numpy
from ignis_tpu_torch.light import union as tlu
from ignis_tpu_torch.ops import spheres as tsp
from ignis_tpu_torch.scene.compile import LIGHT_AREA_SPHERE, check_slice
from ignis_tpu_torch.scene.compile import load_and_compile as t_compile

F32 = np.float32


def sphere_scene(depth=4):
    """A diffuse and an emissive analytic sphere (uniform scale, rotated)
    over a floor under a constant environment."""
    return {
        "technique": {"type": "path", "max_depth": depth},
        "camera": {"type": "perspective", "fov": 50,
                   "transform": {"lookat": {"origin": [0, 1.5, -5],
                                            "target": [0, 0, 0],
                                            "up": [0, 1, 0]}}},
        "film": {"size": [32, 32]},
        "bsdfs": [
            {"type": "diffuse", "name": "white", "reflectance": [.7, .7, .7]},
            {"type": "diffuse", "name": "red", "reflectance": [.8, .2, .1]},
        ],
        "shapes": [
            {"type": "rectangle", "name": "floor", "width": 8, "height": 8,
             "transform": [{"translate": [0, -1, 0]},
                           {"rotate": [-90, 0, 0]}]},
            {"type": "sphere", "name": "ball", "radius": 0.5},
            {"type": "sphere", "name": "bulb", "radius": 1.0},
        ],
        "entities": [
            {"name": "floor", "shape": "floor", "bsdf": "white"},
            {"name": "ball", "shape": "ball", "bsdf": "red",
             "transform": [{"translate": [-0.8, -0.1, 0]},
                           {"rotate": [20, 30, 0]}, {"scale": 1.8}]},
            {"name": "bulb", "shape": "bulb", "bsdf": "white",
             "transform": [{"translate": [1.2, 0.4, 0.5]}, {"scale": 0.4}]},
        ],
        "lights": [
            {"type": "area", "name": "bulb", "entity": "bulb",
             "radiance": [12, 10, 8]},
            {"type": "env", "name": "sky", "radiance": [0.3, 0.35, 0.4]},
        ],
    }


def _sph_rows(s, seed):
    rng = np.random.default_rng(seed)
    rows = np.zeros((s, 16), F32)
    rows[:, 0:3] = rng.uniform(-3, 3, (s, 3))
    rows[:, 3] = rng.uniform(0.2, 1.2, s)
    rows[:, 4] = np.arange(s)
    rows[:, 5] = rng.choice([0xF, 0x1, 0x5, 0xD], s)
    for i in range(s):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        rows[i, 6:15] = q.reshape(9)
    return rows


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-4, 4, (n, 3)).astype(F32)
    d = rng.normal(0, 1, (n, 3)).astype(F32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::3] *= 2.5                         # unnormalised, like shadow rays
    return org, d, np.full(n, 1e-3, F32), np.full(n, 1e30, F32)


@pytest.mark.parametrize("mask_bit", [0xF, 0x1, 0x4, 0x8])
@pytest.mark.parametrize("s", [1, 5, 64])
def test_sphere_closest_matches_jax(s, mask_bit):
    rows, rays = _sph_rows(s, s), _rays(2048, s + 1)
    ref = [np.asarray(a) for a in jsp.sphere_closest(
        {"sph_rows": jnp.asarray(rows)}, *(jnp.asarray(a) for a in rays),
        mask_bit=mask_bit)]
    got = [a.numpy() for a in tsp.sphere_closest(
        {"sph_rows": torch.from_numpy(rows)},
        *(torch.from_numpy(a) for a in rays), mask_bit=mask_bit)]
    assert got[3].dtype == np.int32
    np.testing.assert_array_equal(got[3], ref[3])
    hit = got[3] >= 0
    assert hit.any() and not hit.all()
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-5)
    seam = np.minimum(ref[1], 1 - ref[1]) < 1e-3
    np.testing.assert_allclose(got[1][~seam], ref[1][~seam], atol=1e-4)
    np.testing.assert_allclose(got[2], ref[2], atol=1e-4)
    vis = (rows[got[3][hit], 5].astype(int) & mask_bit) != 0
    assert vis.all()


@pytest.mark.parametrize("mask_bit", [0xF, 0x8])
def test_sphere_any_matches_jax(mask_bit):
    rows = _sph_rows(7, 3)
    org, d, tmin, _ = _rays(2048, 4)
    rays = (org, d, tmin, np.full(2048, 3.0, F32))
    ref = np.asarray(jsp.sphere_any(
        {"sph_rows": jnp.asarray(rows)}, *(jnp.asarray(a) for a in rays),
        mask_bit=mask_bit))
    got = tsp.sphere_any({"sph_rows": torch.from_numpy(rows)},
                         *(torch.from_numpy(a) for a in rays),
                         mask_bit=mask_bit).numpy()
    assert got.dtype == np.bool_ and got.any() and not got.all()
    assert (got != ref).sum() <= 1      # a hit within an ulp of tmax


def test_sphere_behind_the_origin_is_a_miss():
    """The reference's predicate: S < 0 (the center behind the ray origin)
    reports no hit, even from inside the sphere."""
    rows = np.zeros((1, 16), F32)
    rows[0, 3], rows[0, 5] = 1.0, 0xF
    rows[0, 6:15] = np.eye(3).reshape(9)
    tab = {"sph_rows": torch.from_numpy(rows)}
    org = torch.tensor([[0, 0, -3.0], [0, 0, 3.0], [0, 0, 0.5], [0, 0, -0.5]])
    d = torch.tensor([[0, 0, 1.0]]).repeat(4, 1)
    t, _, _, idx = tsp.sphere_closest(tab, org, d, 0.0, 1e30)
    assert idx.tolist() == [0, -1, -1, 0]
    np.testing.assert_allclose(t[[0, 3]].numpy(), [2.0, 1.5], rtol=1e-6)
    assert tsp.sphere_any(tab, org, d, 0.0, 1e30).tolist() \
        == [True, False, False, True]


def test_sphere_sweep_is_chunked_at_65536_rays():
    rows, n = _sph_rows(3, 5), tsp._CHUNK + 1000
    tab = {"sph_rows": torch.from_numpy(rows)}
    org, d, tmin, tmax = (torch.from_numpy(a) for a in _rays(n, 6))
    whole = tsp.sphere_closest(tab, org, d, tmin, tmax)
    assert all(a.shape == (n,) for a in whole)
    tail = tsp.sphere_closest(tab, org[tsp._CHUNK:], d[tsp._CHUNK:],
                              tmin[tsp._CHUNK:], tmax[tsp._CHUNK:])
    for a, b in zip(whole, tail):
        assert torch.equal(a[tsp._CHUNK:], b)
    occ = tsp.sphere_any(tab, org, d, tmin, tmax)
    assert torch.equal(occ, whole[3] >= 0)
    assert tsp._CHUNK == jsp._CHUNK == 65536


def test_sphere_uv_maps_equal_and_invert():
    rng = np.random.default_rng(7)
    d = rng.normal(size=(512, 3)).astype(F32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ru, rv = (np.asarray(a) for a in jsp.sphere_map_uv(jnp.asarray(d)))
    gu, gv = (a.numpy() for a in tsp.sphere_map_uv(torch.from_numpy(d)))
    np.testing.assert_allclose(gu, ru, atol=1e-6)
    np.testing.assert_allclose(gv, rv, atol=1e-6)
    back = tsp.sphere_unmap_uv(torch.from_numpy(gu), torch.from_numpy(gv))
    np.testing.assert_allclose(back.numpy(), d, atol=1e-5)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jsp.sphere_unmap_uv(jnp.asarray(gu),
                                                     jnp.asarray(gv))),
        atol=1e-6)
    assert tsp.sphere_area(0.5) == jsp.sphere_area(0.5)


def test_sphere_scene_compiles_equal_and_is_in_the_slice():
    a, b = j_compile(sphere_scene(), 32, 32), t_compile(sphere_scene(), 32, 32)
    check_slice(b)
    assert a.tables.keys() == b.tables.keys() and "sph_rows" in b.tables
    for k in a.tables:
        np.testing.assert_array_equal(np.asarray(a.tables[k]),
                                      np.asarray(b.tables[k]), err_msg=k)
    assert b.tables["sph_rows"].shape == (2, 16)
    assert [l.type for l in b.lights][0] == LIGHT_AREA_SPHERE
    assert b.tables["tri_v0"].shape[0] == 2          # the floor only


def _emitter_inputs(n, seed):
    rng = np.random.default_rng(seed)
    data = np.zeros((n, 32), F32)
    data[:, 0:3] = rng.uniform(1, 10, (n, 3))
    data[:, 3] = rng.uniform(0.1, 1.0, n)
    data[:, 4:7] = rng.uniform(-2, 2, (n, 3))
    data[:, 8] = 4 * np.pi * data[:, 3] ** 2
    from_point = rng.uniform(-4, 4, (n, 3)).astype(F32)
    entering = rng.uniform(size=n) < 0.7
    u1, u2 = rng.uniform(size=(2, n)).astype(F32)
    return data, from_point, entering, u1, u2


def _assert_samples_close(got, ref):
    assert ref.keys() == got.keys()
    steep = np.abs(np.asarray(ref["cos"])) > 0.05
    for k in ref:
        g, r = got[k].numpy(), np.asarray(ref[k])
        if g.dtype == np.bool_:
            np.testing.assert_array_equal(g, r, err_msg=k)
        elif k == "pdf_solid":
            np.testing.assert_allclose(g[steep], r[steep], rtol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5, err_msg=k)


def test_sphere_emitter_sample_matches_jax():
    args = _emitter_inputs(1024, 8)
    ref = jlu._sample_area_sphere(*(jnp.asarray(a) for a in args))
    got = tlu._sample_area_sphere(*(torch.from_numpy(a) for a in args))
    _assert_samples_close(got, ref)
    # the sampled point lies on the sphere
    data = args[0]
    to_p = got["pos"].numpy() - data[:, 4:7]
    np.testing.assert_allclose(np.linalg.norm(to_p, axis=1), data[:, 3],
                               rtol=1e-5)
    assert tlu._LIGHT_DRAWS[LIGHT_AREA_SPHERE] \
        == jlu._LIGHT_DRAWS[LIGHT_AREA_SPHERE] == 2


def test_sphere_emitter_through_the_light_union_matches_jax():
    """`sample_light_direct` and `light_pdf_direct_solid` on the compiled
    sphere scene: the sphere light's branch, its two draws and its pdf."""
    js, ts = j_compile(sphere_scene(), 16, 16), t_compile(sphere_scene(), 16,
                                                          16)
    jt = {k: jnp.asarray(v) for k, v in js.tables.items()}
    tt = tables_from_numpy(ts.tables, "cpu")
    n = 512
    rng = np.random.default_rng(9)
    lidx = rng.integers(0, 2, n).astype(np.int32)
    fp = rng.uniform(-3, 3, (n, 3)).astype(F32)
    ent = rng.uniform(size=n) < 0.8
    seed = rng.integers(0, 2 ** 32, n, dtype=np.uint64)
    counter = rng.integers(1, 50, n).astype(np.uint64)
    active = rng.uniform(size=n) < 0.9
    ref, rc = jlu.sample_light_direct(
        js, jt, jnp.asarray(lidx), jnp.asarray(fp), jnp.asarray(ent),
        jnp.asarray(seed.astype(np.uint32)),
        jnp.asarray(counter.astype(np.uint32)), jnp.asarray(active))
    got, gc = tlu.sample_light_direct(
        ts, tt, torch.from_numpy(lidx), torch.from_numpy(fp),
        torch.from_numpy(ent), torch.from_numpy(seed.astype(np.int64)),
        torch.from_numpy(counter.astype(np.int64)), torch.from_numpy(active))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc).astype(np.int64))
    _assert_samples_close(got, ref)
    dist = rng.uniform(0.5, 5, n).astype(F32)
    cos = rng.uniform(-1, 1, n).astype(F32)
    valid = rng.uniform(size=n) < 0.9
    d = rng.normal(size=(n, 3)).astype(F32)
    uv = rng.uniform(size=(n, 2)).astype(F32)
    ref = jlu.light_pdf_direct_solid(
        js, jt, *(jnp.asarray(a) for a in (lidx, fp, d, dist, cos, uv, valid)))
    got = tlu.light_pdf_direct_solid(
        ts, tt, *(torch.from_numpy(a) for a in (lidx, fp, d, dist, cos, uv,
                                                valid)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    assert (got.numpy()[valid & (lidx == 0)] > 0).all()
