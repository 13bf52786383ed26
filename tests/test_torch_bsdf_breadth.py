"""The BSDFs beyond diffuse / dielectric / conductor against the JAX package:
phong, rough conductor, rough dielectric, plastic and rough plastic,
principled, passthrough, two-lobe materials (`blend`, `add`, `mask`) and the
constant normal modifier (`transform` with a normal, kind 3).

The same numpy-seeded surfaces and directions go through
`ignis_tpu.bsdf` (`prepare_surface`, `bsdf_eval`, `bsdf_pdf`,
`bsdf_sample`) and the port's.  The scene compiles every material of
`_breadth_scene`, so every branch of the union runs on every lane, as in a
render.

Tolerances: eval and pdf 2e-5 relative and absolute (TOL), 1e-4 for the
principled BSDF's longer chains; sample outputs per lane 1e-4 where the two
packages took the same branch.  The draw counter is held equal on EVERY lane,
so the random streams stay aligned.  XLA contracts multiply-adds and eager
torch does not, so a last-ulp difference may flip a Fresnel, lobe or VNDF
pick against the same random number: at most 1 % of a material's lanes may
take another branch.  Gradients of eval with respect to the material tables
are held to `jax.grad` per type, on one-type scenes (rel 1e-4, abs 1e-6 of
the largest entry), where the JAX package's are finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.bsdf import bsdf_eval as j_eval
from ignis_tpu.bsdf import bsdf_pdf as j_pdf
from ignis_tpu.bsdf import bsdf_sample as j_sample
from ignis_tpu.bsdf import prepare_surface as j_prepare
from ignis_tpu.bsdf import union as j_union
from ignis_tpu.core import vec as jvec
from ignis_tpu.scene.compile import load_and_compile as j_compile
from ignis_tpu_torch.bsdf import bsdf_eval, bsdf_pdf, bsdf_sample
from ignis_tpu_torch.bsdf import prepare_surface
from ignis_tpu_torch.bsdf import union as t_union
from ignis_tpu_torch.convert import params_from_numpy, tables_from_numpy
from ignis_tpu_torch.scene.compile import load_and_compile as t_compile
from ignis_tpu_torch.scenes import materials_scene

N = 1024
TOL = dict(rtol=2e-5, atol=2e-5)


def _breadth_scene():
    """materials_scene() plus a passthrough, a thin principled BSDF with
    sheen and clearcoat, an `add`, a `mask` and a `cutoff`."""
    s = materials_scene()
    s["bsdfs"] = s["bsdfs"] + [
        {"type": "passthrough", "name": "null"},
        {"type": "principled", "name": "thin_principled", "thin": True,
         "base_color": [0.5, 0.7, 0.9], "diffuse_transmission": 0.3,
         "specular_transmission": 0.4, "sheen": 0.3, "sheen_tint": 0.5,
         "clearcoat": 0.6, "clearcoat_gloss": 0.4, "flatness": 0.2,
         "specular_tint": 0.3, "roughness_u": 0.3, "roughness_v": 0.5},
        {"type": "add", "name": "sum", "first": "plastic",
         "second": "phong"},
        {"type": "mask", "name": "masked", "bsdf": "rough_plastic",
         "weight": 0.7},
        {"type": "cutoff", "name": "cut", "bsdf": "frosted", "weight": 0.3,
         "cutoff": 0.5},
    ]
    return s


def _pair(scene):
    js, ts = j_compile(scene, 32, 32), t_compile(scene, 32, 32)
    return (js, {k: jnp.asarray(v) for k, v in js.tables.items()},
            ts, tables_from_numpy(ts.tables, "cpu"))


@pytest.fixture(scope="module")
def breadth():
    return _pair(_breadth_scene())


def _unit(rng, n):
    v = rng.normal(0, 1, (n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a)


def _inputs(seed, nmat, mat):
    """Surfaces (3/4 of the lanes of material `mat`, the rest of any),
    view and light directions, RNG state and the active mask."""
    r = np.random.default_rng(seed)
    nrm = _unit(r, N)
    tb, bb = jvec.orthonormal_basis(jnp.asarray(nrm))
    mat_id = np.where(r.uniform(size=N) < 0.75, mat,
                      r.integers(0, nmat, N)).astype(np.int32)
    surf = dict(
        point=r.uniform(-1, 1, (N, 3)).astype(np.float32), n=nrm, ng=nrm,
        is_entering=r.uniform(size=N) < 0.5,
        tex=r.uniform(0, 1, (N, 2)).astype(np.float32),
        t=np.asarray(tb), b=np.asarray(bb), mat_id=mat_id,
        ent=np.zeros(N, np.int32), light_id=np.full(N, -1, np.int32),
        prim_coords=r.uniform(0, 0.5, (N, 2)).astype(np.float32))
    out_dir = _unit(r, N)
    # out_dir on the shading side, as the integrator guarantees
    flip = np.sum(out_dir * nrm, axis=1) < 0
    out_dir[flip] *= -1
    in_dir = _unit(r, N)
    seed_ = r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    ctr = r.integers(1, 50, N).astype(np.uint32)
    active = r.uniform(size=N) < 0.9
    return surf, out_dir, in_dir, seed_, ctr, active


def _surfs(surf):
    return ({k: jnp.asarray(v) for k, v in surf.items()},
            {k: _t(v) for k, v in surf.items()})


MATERIALS = ["brushed", "frosted", "plastic", "rough_plastic", "principled",
             "phong", "blend", "tilted", "null", "thin_principled", "sum",
             "masked", "cut"]


@pytest.mark.parametrize("name", MATERIALS)
def test_bsdf_matches_jax(breadth, name):
    js, jt, ts, tt = breadth
    mat = ts.material_names.index(name)
    surf, out_dir, in_dir, seed, ctr, active = _inputs(
        11 + mat, len(ts.bsdf_types), mat)
    jsurf, tsurf = _surfs(surf)
    d = -out_dir

    jmt, jspec = j_prepare(js, jt, jsurf, jnp.asarray(d))
    tmt, tspec = prepare_surface(ts, tt, tsurf, _t(d))
    np.testing.assert_array_equal(tmt.numpy(), np.asarray(jmt))
    np.testing.assert_array_equal(tspec.numpy(), np.asarray(jspec))
    for k in ("n", "t", "b"):           # the normal modifier's frame
        np.testing.assert_allclose(tsurf[k].numpy(), np.asarray(jsurf[k]),
                                   rtol=1e-6, atol=1e-6)
    if "mix_k" in jsurf:
        np.testing.assert_array_equal(tsurf["mix_k"].numpy(),
                                      np.asarray(jsurf["mix_k"]))

    tol = dict(rtol=1e-4, atol=1e-4) if "principled" in name else TOL
    np.testing.assert_allclose(
        bsdf_eval(ts, tt, tmt, tsurf, _t(in_dir), _t(out_dir)).numpy(),
        np.asarray(j_eval(js, jt, jmt, jsurf, jnp.asarray(in_dir),
                          jnp.asarray(out_dir))), **tol)
    np.testing.assert_allclose(
        bsdf_pdf(ts, tt, tmt, tsurf, _t(in_dir), _t(out_dir)).numpy(),
        np.asarray(j_pdf(js, jt, jmt, jsurf, jnp.asarray(in_dir),
                         jnp.asarray(out_dir))), **tol)

    ref = [np.asarray(a) for a in j_sample(
        js, jt, jmt, jsurf, jnp.asarray(seed), jnp.asarray(ctr),
        jnp.asarray(out_dir), active=jnp.asarray(active))]
    got = [a.numpy() for a in bsdf_sample(
        ts, tt, tmt, tsurf, _t(seed), _t(ctr), _t(out_dir),
        active=_t(active))]
    # every lane advanced its counter by the same number of draws
    np.testing.assert_array_equal(got[5], ref[5].astype(np.int64))
    mine = surf["mat_id"] == mat
    assert (got[5][~active] == ctr[~active]).all()
    same = (np.isclose(got[0], ref[0], rtol=1e-4, atol=1e-4).all(axis=1)
            & (got[4] == ref[4]) & np.isclose(got[3], ref[3], atol=1e-5))
    assert (~same[mine]).sum() <= 0.01 * mine.sum(), (~same).sum()
    assert ref[4][mine & active].any()
    for i, w in ((1, 2e-4), (2, 2e-4)):
        np.testing.assert_allclose(got[i][same], ref[i][same], rtol=w,
                                   atol=w)


def test_counters_advance_by_each_types_draws(breadth):
    """Lanes of one material advance by that type's draws: principled 3
    (thin specular transmission 1), plastic 3 or 1 by the lobe picked,
    rough plastic 3, rough conductor 2, rough dielectric 3, phong 2,
    passthrough 0; a mix lane (blend, mask, cutoff) adds its lobe pick, an
    `add` lane samples its first lobe only."""
    js, jt, ts, tt = breadth
    mat = ts.material_names.index("brushed")
    surf, out_dir, _i, seed, ctr, active = _inputs(5, len(ts.bsdf_types),
                                                   mat)
    surf["mat_id"] = np.arange(N, dtype=np.int32) % len(ts.bsdf_types)
    _j, tsurf = _surfs(surf)
    tmt, _s = prepare_surface(ts, tt, tsurf, -_t(out_dir))
    got = bsdf_sample(ts, tt, tmt, tsurf, _t(seed), _t(ctr), _t(out_dir),
                      active=_t(active))
    adv = got[5].numpy() - ctr.astype(np.int64)
    names = np.asarray(ts.material_names)[surf["mat_id"]]
    expect = {"brushed": {2}, "frosted": {3}, "rough_plastic": {3},
              "phong": {2}, "null": {0}, "principled": {3},
              "thin_principled": {1, 3}, "plastic": {1, 3},
              "blend": {1 + 2}, "white": {2}, "tilted": {2},
              "sum": {1, 3}, "masked": {1 + 3, 1 + 0},
              "cut": {1 + 3, 1 + 0}}
    for nm, ks in expect.items():
        m = (names == nm) & active
        assert set(np.unique(adv[m])) <= ks and m.any(), (nm, adv[m][:8])
    assert (adv[~active] == 0).all()


ONE_TYPE = {
    "phong": {"type": "phong", "exponent": 12,
              "specular_reflectance": [0.6, 0.7, 0.8]},
    "roughconductor": {"type": "roughconductor", "material": "gold",
                       "roughness": 0.3},
    "roughdielectric": {"type": "roughdielectric", "int_ior": 1.4,
                        "roughness": 0.25},
    "plastic": {"type": "plastic", "diffuse_reflectance": [0.6, 0.2, 0.1]},
    "roughplastic": {"type": "roughplastic", "roughness": 0.35,
                     "diffuse_reflectance": [0.2, 0.6, 0.1]},
    "principled": {"type": "principled", "base_color": [0.8, 0.5, 0.3],
                   "metallic": 0.4, "specular_transmission": 0.3,
                   "roughness": 0.45, "sheen": 0.2, "clearcoat": 0.3},
}


@pytest.mark.parametrize("name", sorted(ONE_TYPE))
def test_eval_gradient_matches_jax_grad(name):
    """d sum(w * eval) / d (mat_colors, mat_scalars) on a scene of one type
    (so no other type's branch reads its rows): autograd against
    `jax.grad`."""
    scene = materials_scene()
    scene["bsdfs"] = [dict(ONE_TYPE[name], name="m")]
    scene["entities"] = [dict(e, bsdf="m") for e in scene["entities"]]
    js, jt, ts, _tt = _pair(scene)
    surf, out_dir, in_dir, *_r = _inputs(23, 1, 0)
    # the light side of the surface for reflection, both for the others
    jsurf, tsurf = _surfs(surf)
    w = np.random.default_rng(4).uniform(0.5, 1.5, (N, 3)).astype(np.float32)
    keys = ("mat_colors", "mat_scalars")
    mt = np.zeros(N, np.int32) + js.bsdf_types[0]

    def jloss(p):
        t = dict(jt)
        t.update(p)
        v = j_union.bsdf_eval(js, t, jnp.asarray(mt), jsurf,
                              jnp.asarray(in_dir), jnp.asarray(out_dir))
        pd = j_union.bsdf_pdf(js, t, jnp.asarray(mt), jsurf,
                              jnp.asarray(in_dir), jnp.asarray(out_dir))
        return jnp.sum(v * w) + jnp.sum(pd * w[:, 0])
    jg = jax.grad(jloss)({k: jt[k] for k in keys})

    tt = params_from_numpy(ts.tables, keys, "cpu")
    v = t_union.bsdf_eval(ts, tt, _t(mt), tsurf, _t(in_dir), _t(out_dir))
    pd = t_union.bsdf_pdf(ts, tt, _t(mt), tsurf, _t(in_dir), _t(out_dir))
    (torch.sum(v * _t(w)) + torch.sum(pd * _t(w[:, 0]))).backward()
    for k in keys:
        ref, got = np.asarray(jg[k]), tt[k].grad.numpy()
        # the JAX package's gradient with respect to an IOR is NaN where a
        # lane meets total internal reflection (the slope of its
        # sqrt(max(cos2_t, 0)) there); the port's is finite everywhere and
        # is held to it on the entries where it is finite
        fin = np.isfinite(ref)
        assert np.isfinite(got).all(), k
        assert set(np.argwhere(~fin)[:, -1]) <= ({1, 2} if k == "mat_scalars"
                                                  else set()), k
        assert np.abs(ref[fin]).max() > 0, k
        np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-4,
                                   atol=1e-6 * np.abs(ref[fin]).max(),
                                   err_msg=k)
