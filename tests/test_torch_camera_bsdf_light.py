"""Camera, BSDF union and light union of the port against the JAX package's,
function by function on the same numpy-seeded inputs.

Tolerances: integer outputs (RNG counters, light ids, masks) are exact.
Floats are held to 2e-5 absolute + 2e-5 relative for one function: XLA on the
CPU contracts multiply-adds and its sin/cos/acos differ from torch's in the
last bits, and a few of these functions (the spherical-rectangle sampler)
chain a dozen such calls.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.bsdf import bsdf_eval as j_eval
from ignis_tpu.bsdf import bsdf_pdf as j_pdf
from ignis_tpu.bsdf import bsdf_sample as j_sample
from ignis_tpu.bsdf import prepare_surface as j_prepare
from ignis_tpu.core import vec as jvec
from ignis_tpu.core import warp as jwarp
from ignis_tpu.light import union as jlight
from ignis_tpu.render import camera as jcam
from ignis_tpu.render import integrator as jint
from ignis_tpu.scene.compile import load_and_compile as j_compile
from ignis_tpu_torch.bsdf import bsdf_eval, bsdf_pdf, bsdf_sample
from ignis_tpu_torch.bsdf import prepare_surface
from ignis_tpu_torch.convert import tables_from_numpy
from ignis_tpu_torch.core import vec as tvec
from ignis_tpu_torch.core import warp as twarp
from ignis_tpu_torch.light import union as tlight
from ignis_tpu_torch.render import camera as tcam
from ignis_tpu_torch.render import integrator as tint
from ignis_tpu_torch.scene.compile import load_and_compile as t_compile
from test_torch_compile import dof_scene, lights_scene
from ignis_tpu_torch.scenes import demo_scene

N = 2048
TOL = dict(rtol=2e-5, atol=2e-5)


def _close(got, ref, **kw):
    tol = dict(TOL, **kw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **tol)


def _unit(rng, n):
    v = rng.normal(0, 1, (n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _pair(scene_fn):
    js, ts = j_compile(scene_fn(), 32, 32), t_compile(scene_fn(), 32, 32)
    jt = {k: jnp.asarray(v) for k, v in js.tables.items()}
    tt = tables_from_numpy(ts.tables, "cpu")
    return js, jt, ts, tt


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a)


# ------------------------------------------------------------------ warps
@pytest.mark.parametrize("name", [
    "sample_cosine_hemisphere", "square_to_concentric_disk",
    "equal_area_square_to_sphere", "sample_triangle",
    "sample_uniform_sphere"])
def test_warps(name):
    r = np.random.default_rng(0)
    u, v = (r.uniform(0, 1, N).astype(np.float32) for _ in range(2))
    u[:4], v[:4] = [0, 1, 0.5, 0.5], [0, 1, 0.5, 0.25]
    ref = getattr(jwarp, name)(jnp.asarray(u), jnp.asarray(v))
    got = getattr(twarp, name)(_t(u), _t(v))
    for a, b in zip(got, ref) if isinstance(ref, tuple) else [(got, ref)]:
        _close(a, b)


def test_equal_area_round_trip_and_basis():
    r = np.random.default_rng(1)
    d = _unit(r, N)
    _close(twarp.equal_area_sphere_to_square(_t(d)),
           jwarp.equal_area_sphere_to_square(jnp.asarray(d)))
    jt_, jb = jvec.orthonormal_basis(jnp.asarray(d))
    tt_, tb = tvec.orthonormal_basis(_t(d))
    _close(tt_, jt_)
    _close(tb, jb)
    a = r.normal(0, 1, N).astype(np.float32)
    a[:3] = 0.0
    _close(tvec.safe_div(1.0, _t(a)), jvec.safe_div(1.0, jnp.asarray(a)))
    assert tvec.FLT_MAX == float(jvec.FLT_MAX)
    assert tvec.FLT_EPS == float(jvec.FLT_EPS)


# ----------------------------------------------------------------- camera
@pytest.mark.parametrize("scene_fn", [demo_scene, dof_scene])
def test_generate_rays(scene_fn):
    js, _, ts, _ = _pair(scene_fn)
    r = np.random.default_rng(2)
    nx, ny = (r.uniform(-1, 1, N).astype(np.float32) for _ in range(2))
    lens = None
    tlens = None
    if js.camera.aperture_radius > 0:
        l1, l2 = (r.uniform(0, 1, N).astype(np.float32) for _ in range(2))
        lens, tlens = (jnp.asarray(l1), jnp.asarray(l2)), (_t(l1), _t(l2))
    ref = jcam.generate_rays(js.camera, jnp.asarray(nx), jnp.asarray(ny),
                             lens_uv=lens)
    got = tcam.generate_rays(ts.camera, _t(nx), _t(ny), lens_uv=tlens)
    for a, b in zip(got, ref):
        _close(a, b, rtol=1e-6, atol=1e-6)
    assert float(got[3][0]) == float(np.float32(ts.camera.tmax))


@pytest.mark.parametrize("scene_fn", [demo_scene, dof_scene])
def test_emit_camera(scene_fn):
    """Seeds and counters bit-equal, rays to 1e-6 (the pose comes from the
    parameter registry on both sides)."""
    js, jt, ts, tt = _pair(scene_fn)
    idx = np.arange(1024, dtype=np.int32)
    x, y = idx % 32, idx // 32
    samp = (idx % 3).astype(np.uint32)
    ref = jint._emit_camera(js, jnp.asarray(x), jnp.asarray(y),
                            jnp.asarray(samp), jnp.uint32(2), jnp.uint32(1),
                            5, jt, 3)
    got = tint._emit_camera(ts, _t(x), _t(y), _t(samp), 2, 1, 5, tt, 3)
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(ref[0]).astype(np.int64))
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(ref[1]).astype(np.int64))
    for a, b in zip(got[2:], ref[2:]):
        _close(a, b, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------- bsdf
def _surf(rng, n, nmat):
    nrm = _unit(rng, n)
    tb, bb = jvec.orthonormal_basis(jnp.asarray(nrm))
    return dict(
        point=rng.uniform(-1, 1, (n, 3)).astype(np.float32), n=nrm, ng=nrm,
        is_entering=rng.uniform(size=n) < 0.5,
        tex=rng.uniform(0, 1, (n, 2)).astype(np.float32),
        t=np.asarray(tb), b=np.asarray(bb),
        mat_id=rng.integers(0, nmat, n).astype(np.int32),
        ent=np.zeros(n, np.int32), light_id=np.full(n, -1, np.int32),
        prim_coords=rng.uniform(0, 0.5, (n, 2)).astype(np.float32))


def _surfs(surf):
    return ({k: jnp.asarray(v) for k, v in surf.items()},
            {k: _t(v) for k, v in surf.items()})


def _thin_scene():
    s = demo_scene()
    s["bsdfs"] = s["bsdfs"] + [
        {"type": "dielectric", "name": "thin", "thin": True, "int_ior": 1.4},
        {"type": "mirror", "name": "mirror"},
        {"type": "diffuse", "name": "rough", "reflectance": [0.4, 0.5, 0.6],
         "roughness": 0.4}]
    return s


@pytest.mark.parametrize("scene_fn", [demo_scene, _thin_scene])
def test_bsdf_union(scene_fn):
    """prepare_surface, bsdf_sample (incl. the per-type draw counters),
    bsdf_eval and bsdf_pdf over every material of the scene."""
    js, jt, ts, tt = _pair(scene_fn)
    r = np.random.default_rng(3)
    surf = _surf(r, N, len(js.bsdf_types))
    out_dir = _unit(r, N)
    # out_dir on the shading side, as the integrator guarantees
    flip = np.sum(out_dir * surf["n"], axis=1) < 0
    out_dir[flip] *= -1
    in_dir = _unit(r, N)
    seed = r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    ctr = r.integers(1, 50, N).astype(np.uint32)
    active = r.uniform(size=N) < 0.8
    jsurf, tsurf = _surfs(surf)

    jmt, jspec = j_prepare(js, jt, jsurf, -jnp.asarray(out_dir))
    tmt, tspec = prepare_surface(ts, tt, tsurf, -_t(out_dir))
    np.testing.assert_array_equal(tmt.numpy(), np.asarray(jmt))
    np.testing.assert_array_equal(tspec.numpy(), np.asarray(jspec))
    assert set(np.unique(tmt.numpy())) == set(ts.bsdf_types)

    ref = j_sample(js, jt, jmt, jsurf, jnp.asarray(seed), jnp.asarray(ctr),
                   jnp.asarray(out_dir), active=jnp.asarray(active))
    got = bsdf_sample(ts, tt, tmt, tsurf, _t(seed), _t(ctr), _t(out_dir),
                      active=_t(active))
    np.testing.assert_array_equal(got[5].numpy(),
                                  np.asarray(ref[5]).astype(np.int64))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
    # the draw count is per type: diffuse 2, dielectric 1, conductor 0
    adv = (got[5].numpy() - ctr.astype(np.int64))
    per_type = {0: 2, 1: 1, 2: 0}
    for t, k in per_type.items():
        m = (tmt.numpy() == t) & active
        assert (adv[m] == k).all()
    assert (adv[~active] == 0).all()
    # a last-ulp difference in the fresnel factor can flip a dielectric's
    # reflect/refract pick against the same random number: allow 2 lanes
    same = np.isclose(got[3].numpy(), np.asarray(ref[3]), atol=1e-5) & \
        np.isclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-4).all(axis=1)
    assert (~same).sum() <= 2
    for i in (0, 1, 2, 3):
        _close(got[i].numpy()[same], np.asarray(ref[i])[same], atol=1e-4)

    _close(bsdf_eval(ts, tt, tmt, tsurf, _t(in_dir), _t(out_dir)),
           j_eval(js, jt, jmt, jsurf, jnp.asarray(in_dir),
                  jnp.asarray(out_dir)))
    _close(bsdf_pdf(ts, tt, tmt, tsurf, _t(in_dir), _t(out_dir)),
           j_pdf(js, jt, jmt, jsurf, jnp.asarray(in_dir),
                 jnp.asarray(out_dir)))


# ------------------------------------------------------------------ light
@pytest.mark.parametrize("scene_fn", [demo_scene, lights_scene])
def test_select_and_sample_light_direct(scene_fn):
    js, jt, ts, tt = _pair(scene_fn)
    r = np.random.default_rng(4)
    seed = r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    ctr = r.integers(1, 50, N).astype(np.uint32)
    active = r.uniform(size=N) < 0.8
    pos = r.uniform(-0.9, 0.9, (N, 3)).astype(np.float32)
    entering = r.uniform(size=N) < 0.5

    jl, jp, jc = jlight.select_light(js, jt, jnp.asarray(seed),
                                     jnp.asarray(ctr), jnp.asarray(active),
                                     from_pos=jnp.asarray(pos))
    tl, tp, tc = tlight.select_light(ts, tt, _t(seed), _t(ctr), _t(active),
                                     from_pos=_t(pos))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
    _close(tp, jp, rtol=0, atol=0)
    assert set(np.unique(tl.numpy()[active])) == set(range(ts.num_lights))

    ref, jc2 = jlight.sample_light_direct(js, jt, jl, jnp.asarray(pos),
                                          jnp.asarray(entering),
                                          jnp.asarray(seed), jc,
                                          jnp.asarray(active))
    got, tc2 = tlight.sample_light_direct(ts, tt, tl, _t(pos), _t(entering),
                                          _t(seed), tc, _t(active))
    np.testing.assert_array_equal(tc2.numpy(),
                                  np.asarray(jc2).astype(np.int64))
    assert got.keys() == ref.keys()
    for k in ("infinite", "delta"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    for k in ("dir", "dist", "cos", "pos", "pdf_value"):
        _close(got[k], ref[k], rtol=1e-4, atol=1e-4)
    # intensity and the solid-angle pdf divide by small solid angles / cosines
    _close(got["intensity"], ref["intensity"], rtol=2e-3, atol=1e-3)
    _close(got["pdf_solid"], ref["pdf_solid"], rtol=2e-3, atol=1e-3)


@pytest.mark.parametrize("scene_fn", [demo_scene, lights_scene])
def test_light_pdfs_and_emission(scene_fn):
    js, jt, ts, tt = _pair(scene_fn)
    r = np.random.default_rng(5)
    nl = ts.num_lights
    lidx = r.integers(0, nl, N).astype(np.int32)
    org = r.uniform(-0.9, 0.9, (N, 3)).astype(np.float32)
    d = _unit(r, N)
    dist = r.uniform(0.1, 3, N).astype(np.float32)
    cosv = r.uniform(-1, 1, N).astype(np.float32)
    pc = r.uniform(0, 0.5, (N, 2)).astype(np.float32)
    valid = r.uniform(size=N) < 0.7
    _close(tlight.light_pdf_direct_solid(ts, tt, _t(lidx), _t(org), _t(d),
                                         _t(dist), _t(cosv), _t(pc),
                                         _t(valid)),
           jlight.light_pdf_direct_solid(js, jt, jnp.asarray(lidx),
                                         jnp.asarray(org), jnp.asarray(d),
                                         jnp.asarray(dist), jnp.asarray(cosv),
                                         jnp.asarray(pc), jnp.asarray(valid)),
           rtol=2e-3, atol=1e-4)
    _close(tlight.light_select_pdf(ts, tt, _t(lidx), _t(org)),
           jlight.light_select_pdf(js, jt, jnp.asarray(lidx),
                                   jnp.asarray(org)), rtol=0, atol=0)
    _close(tint._area_light_radiance(ts, tt, _t(lidx)),
           jint._area_light_radiance(js, jt, jnp.asarray(lidx)),
           rtol=0, atol=0)
    env = [i for i, l in enumerate(ts.lights) if l.infinite][0]
    tc_, tp_ = tlight.env_emission_and_pdf(ts, tt, env, _t(d))
    jc_, jp_ = jlight.env_emission_and_pdf(js, jt, env, jnp.asarray(d))
    _close(tc_, jc_, rtol=0, atol=0)
    _close(tp_, jp_, rtol=1e-7, atol=0)


def test_surface_at_packed_and_unpacked():
    from ignis_tpu_torch.api import pack_tri_shade
    js, jt, ts, tt = _pair(demo_scene)
    r = np.random.default_rng(6)
    nt = ts.tables["tri_v0"].shape[0]
    prim = r.integers(0, nt, N).astype(np.int32)
    org = r.uniform(-1, 1, (N, 3)).astype(np.float32)
    d = _unit(r, N)
    t = r.uniform(0.1, 3, N).astype(np.float32)
    u = r.uniform(0, 0.5, N).astype(np.float32)
    v = r.uniform(0, 0.5, N).astype(np.float32)
    ref = jint._surface_at(jt, jnp.asarray(prim), jnp.asarray(org),
                           jnp.asarray(d), jnp.asarray(t), jnp.asarray(u),
                           jnp.asarray(v))
    packed = dict(tt, tri_shade=_t(pack_tri_shade(ts.tables)))
    for tables in (tt, packed):
        got = tint._surface_at(tables, _t(prim), _t(org), _t(d), _t(t),
                               _t(u), _t(v))
        assert got.keys() == ref.keys()
        for k in ref:
            if np.asarray(ref[k]).dtype.kind in "ib":
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(ref[k]), k)
            else:
                _close(got[k], ref[k], rtol=1e-5, atol=1e-5)
