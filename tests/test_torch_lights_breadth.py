"""The port's light breadth against the JAX package's, function by function
on 4096 seeded lanes: the 2D CDF's sampling and pdf, the env direction <->
uv maps, the cone warp, the light hierarchy's descent and replay, every
selector with and without infinite lights, and sampling / pdf / emission
for every light type and every sky model.

Tolerances: table offsets, light ids and RNG counters exact; CDF positions
and pdfs 1e-6 relative; the uv maps 1e-6; hierarchy pdfs 1e-5; selector
pdfs 1e-6; every field of a light sample, its pdfs and an infinite light's
emission 1e-5 relative (or 1e-6 absolute near 0).

The 1e-5 holds on every lane but a few (at most 0.25 %, 10 of 4096), which
stay within 1e-3: XLA's and PyTorch's CPU arccos, atan2, cos and 3x3
products differ in the last bit on some inputs, and a few lanes amplify
that: arccos near +-1 (the CIE clear sky's angle to the sun), sqrt(1 - z^2)
near the poles (an env's solid-angle pdf), 1 - p near p = 1 (a hierarchy
pdf's right branch) and the steep texels of an HDR image.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import create_flat_scene
from ignis_tpu.core import warp as jwarp
from ignis_tpu.light import env_cdf as jcdf
from ignis_tpu.light import hierarchy as jh
from ignis_tpu.light import union as jlight
from ignis_tpu.scene.compile import load_and_compile as j_compile
from ignis_tpu_torch.convert import tables_from_numpy
from ignis_tpu_torch.core import warp as twarp
from ignis_tpu_torch.light import env_cdf as tcdf
from ignis_tpu_torch.light import hierarchy as th
from ignis_tpu_torch.light import union as tlight
from ignis_tpu_torch.scene.compile import load_and_compile as t_compile
from ignis_tpu_torch.utils.exr import write_exr

N = 4096
FIELD = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _exact(got, ref):
    np.testing.assert_array_equal(_np(got).astype(np.int64),
                                  np.asarray(ref).astype(np.int64))


def _rel(got, ref, rtol, atol=0.0):
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _lanes_rel(got, ref, rtol, atol=0.0, few=0.0025, loose=1e-3):
    """Within (rtol, atol) on all lanes but at most `few` of them, and
    those within `loose` relative (see the module docstring)."""
    a = _np(got).astype(np.float64).reshape(N, -1)
    b = np.asarray(ref).astype(np.float64).reshape(N, -1)
    ok = np.isclose(a, b, rtol=rtol, atol=atol).all(axis=1)
    assert (~ok).sum() <= few * N, ((~ok).sum(), np.nonzero(~ok)[0][:8])
    np.testing.assert_allclose(a, b, rtol=loose, atol=atol)


def _unit(rng, n):
    v = rng.normal(0, 1, (n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _lanes(seed=3):
    r = np.random.default_rng(seed)
    return dict(
        seed=r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32),
        ctr=r.integers(0, 2**32 - 64, N, dtype=np.uint64).astype(np.uint32),
        active=r.uniform(size=N) < 0.8,
        pos=r.uniform(-0.9, 0.9, (N, 3)).astype(np.float32),
        entering=r.uniform(size=N) < 0.5)


# ------------------------------------------------------------- CDF tables
def _image(seed, h=32, w=64):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32) ** 2
    img[5, 11] = 40.0
    img[h - 3, :] = 0.0        # a black row: the uniform fallback
    return img


def _tables(method, seed):
    img = _image(seed)
    if method == "sat":
        return jcdf.sat_to_cdf(jcdf.build_sat2d(img, compensate=False))
    return jcdf.build_cdf2d(img, compensate=True)


@pytest.mark.parametrize("method", ["cdf", "sat"])
def test_cdf2d_sample_and_pdf(method):
    marg, cond = _tables(method, 2)
    r = np.random.default_rng(9)
    u = r.uniform(0, 1, N).astype(np.float32)
    v = r.uniform(0, 1, N).astype(np.float32)
    u[:8] = [0.0, 1.0 - 2**-24, 0.5, 0.25, 0.0, 0.999, 1e-7, 0.75]
    v[:8] = [0.0, 1.0 - 2**-24, 0.5, 0.0, 0.999, 0.25, 0.75, 1e-7]
    jm, jc = jnp.asarray(marg), jnp.asarray(cond)
    tm, tc = _t(marg), _t(cond)
    # offsets of both 1D samples, exactly
    joff, _, jpos, jpdf = jcdf._cdf1d_sample(jm, jnp.asarray(v))
    toff, _, tpos, tpdf = tcdf._cdf1d_sample(tm, _t(v))
    _exact(toff, joff)
    jxo, _, jx, jxp = jcdf._cdf1d_sample_rows(jc[joff], jnp.asarray(u))
    txo, _, tx, txp = tcdf._cdf1d_sample_rows(tc, toff, _t(u))
    _exact(txo, jxo)
    _rel(tpos, jpos, 1e-6)
    _rel(tx, jx, 1e-6)
    _rel(txp, jxp, 1e-6)
    jp, jpd = jcdf.cdf2d_sample(jm, jc, jnp.asarray(u), jnp.asarray(v))
    tp, tpd = tcdf.cdf2d_sample(tm, tc, _t(u), _t(v))
    _rel(tp, jp, 1e-6)
    _rel(tpd, jpd, 1e-6)
    # the pdf at the sampled and at free positions
    for pos in (np.asarray(jp), r.uniform(0, 1, (N, 2)).astype(np.float32)):
        _rel(tcdf.cdf2d_pdf(tm, tc, _t(pos)),
             jcdf.cdf2d_pdf(jm, jc, jnp.asarray(pos)), 1e-6)
    joff, _ = jcdf._cdf1d_pdf(jm, jnp.asarray(v))
    toff, _ = tcdf._cdf1d_pdf(tm, _t(v))
    _exact(toff, joff)


def test_env_maps():
    r = np.random.default_rng(5)
    d = _unit(r, N)
    d[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0]]
    uv = r.uniform(0, 1, (N, 2)).astype(np.float32)
    _rel(tcdf.map_env_uv(_t(d)), jcdf.map_env_uv(jnp.asarray(d)), 1e-6,
         1e-6)
    _rel(tcdf.uv_to_dir(_t(uv)), jcdf.uv_to_dir(jnp.asarray(uv)), 1e-6,
         1e-6)
    _rel(tcdf.sin_theta_of(_t(d)), jcdf.sin_theta_of(jnp.asarray(d)), 1e-6,
         1e-6)
    _exact(tcdf.switch_env_up(_t(d)).view(torch.int32),
           np.asarray(jcdf.switch_env_up(jnp.asarray(d))).view(np.int32))


def test_uniform_cone():
    r = np.random.default_rng(6)
    u, v = r.uniform(0, 1, (2, N)).astype(np.float32)
    cos_a = r.uniform(0.9, 1.0, N).astype(np.float32)
    cos_a[:2] = [1.0, 0.0]
    jd, jp = jwarp.sample_uniform_cone(jnp.asarray(u), jnp.asarray(v),
                                       jnp.asarray(cos_a))
    td, tp = twarp.sample_uniform_cone(_t(u), _t(v), _t(cos_a))
    _rel(td, jd, 1e-6, 1e-7)
    _rel(tp, jp, 1e-6)
    _rel(twarp.uniform_cone_pdf(_t(cos_a)),
         jwarp.uniform_cone_pdf(jnp.asarray(cos_a)), 1e-6)


# -------------------------------------------------------------- hierarchy
def _hier(n, with_dirs, seed=1):
    r = np.random.default_rng(seed)
    pos = r.uniform(-2, 2, (n, 3)).astype(np.float32)
    dirs = _unit(r, n)
    has = (r.uniform(size=n) < 0.6) if with_dirs else np.zeros(n, bool)
    flux = r.uniform(0.1, 5.0, n).astype(np.float32)
    tabs, depth = jh.build_light_hierarchy(pos, dirs, has, flux)
    return tabs, depth


@pytest.mark.parametrize("n,with_dirs", [(2, False), (16, True),
                                         (257, True), (1024, False)])
def test_hierarchy_sample_and_pdf(n, with_dirs):
    tabs, depth = _hier(n, with_dirs)
    jt = {k: jnp.asarray(v) for k, v in tabs.items()}
    tt = tables_from_numpy(tabs, "cpu")
    ln = _lanes(n)
    pos = ln["pos"] * 2.5
    jl, jp, jc = jh.hierarchy_sample(jt, jnp.asarray(pos),
                                     jnp.asarray(ln["seed"]),
                                     jnp.asarray(ln["ctr"]),
                                     jnp.asarray(ln["active"]), depth)
    tl, tp, tc = th.hierarchy_sample(tt, _t(pos), _t(ln["seed"]),
                                     _t(ln["ctr"]), _t(ln["active"]), depth)
    _exact(tl, jl)
    _exact(tc, jc)
    _lanes_rel(tp, jp, 1e-5)
    # the replay gives the sample's pdf, and the JAX replay's
    _rel(th.hierarchy_pdf(tt, tl, _t(pos), depth), tp, 1e-5)
    other = np.random.default_rng(n).integers(0, n, N).astype(np.int32)
    _lanes_rel(th.hierarchy_pdf(tt, _t(other), _t(pos), depth),
               jh.hierarchy_pdf(jt, jnp.asarray(other), jnp.asarray(pos),
                                depth), 1e-5)


# -------------------------------------------------------- scenes of lights
def _env_exr(tmp_path):
    path = str(tmp_path / "env.exr")
    write_exr(path, _image(7, 16, 32))
    return path


def _with_lights(lights, selector="uniform", tmp_path=None):
    s = copy.deepcopy(create_flat_scene())
    s["film"] = {"size": [16, 16]}
    s["technique"] = dict(s["technique"], light_selector=selector)
    if tmp_path is not None:
        s["textures"] = [{"type": "image", "name": "env",
                          "filename": _env_exr(tmp_path),
                          "filter_type": "bilinear"}]
    s["lights"] = lights
    return s


ROT = {"rotate": [20, 35, 0]}
SUNNY = dict(elevation=0.7, azimuth=2.1)
INFINITE = {
    "sun": {"type": "sun", "name": "i", "direction": [0.2, -0.5, 1.0],
            "irradiance": [3, 2.5, 2]},
    "sun ea": {"type": "sun", "name": "i", "radius": 0.05, **SUNNY},
    "directional": {"type": "directional", "name": "i",
                    "direction": [0.3, 0.2, 1], "irradiance": [1, 2, 3]},
    "sky": {"type": "sky", "name": "i", "turbidity": 4.0, **SUNNY,
            "transform": ROT},
    "cie_uniform": {"type": "cie_uniform", "name": "i", "transform": ROT},
    "cie_cloudy": {"type": "cie_cloudy", "name": "i", "has_ground": False,
                   "zenith": [1.2, 1.1, 1.0]},
    "cie_clear": {"type": "cie_clear", "name": "i", **SUNNY,
                  "transform": ROT},
    "cie_intermediate": {"type": "cie_intermediate", "name": "i",
                         "has_ground": False, **SUNNY},
    "perez": {"type": "perez", "name": "i", "clearness": 3.0,
              "brightness": 0.3, **SUNNY, "transform": ROT},
    "env cdf": {"type": "env", "name": "i", "radiance": "env", "scale": 0.6,
                "transform": ROT},
    "env sat": {"type": "env", "name": "i", "radiance": "env",
                "cdf_method": "sat"},
    "env uniform": {"type": "env", "name": "i", "radiance": "env",
                    "cdf": False, "transform": ROT},
}
FINITE = [
    {"type": "spot", "name": "s0", "position": [0.2, 0.1, -1.5],
     "direction": [0, 0, 1], "intensity": [2, 1, 1], "cutoff": 40,
     "falloff": 30},
    {"type": "spot", "name": "s1", "position": [-0.4, -0.2, -1.0],
     "direction": [0.2, 0.1, 1], "power": [3, 3, 3], "cutoff": 25,
     "falloff": 25},
    {"type": "point", "name": "p0", "position": [0.3, 0.5, -0.8],
     "intensity": [1, 1, 2]},
    {"type": "point", "name": "p1", "position": [-0.6, -0.5, -0.4],
     "intensity": [0.3, 0.2, 0.1]},
]


def _pair(scene):
    js, ts = j_compile(scene, 16, 16), t_compile(scene, 16, 16)
    return (js, {k: jnp.asarray(v) for k, v in js.tables.items()}, ts,
            tables_from_numpy(ts.tables, "cpu"))


def _sample_and_hold(js, jt, ts, tt, lidx, ln):
    ref, jc = jlight.sample_light_direct(
        js, jt, jnp.asarray(lidx), jnp.asarray(ln["pos"]),
        jnp.asarray(ln["entering"]), jnp.asarray(ln["seed"]),
        jnp.asarray(ln["ctr"]), jnp.asarray(ln["active"]))
    got, tc = tlight.sample_light_direct(
        ts, tt, _t(lidx), _t(ln["pos"]), _t(ln["entering"]),
        _t(ln["seed"]), _t(ln["ctr"]), _t(ln["active"]))
    _exact(tc, jc)
    assert got.keys() == ref.keys()
    for k in ref:
        if k in ("infinite", "delta"):
            _exact(got[k], ref[k])
        else:
            _lanes_rel(got[k], ref[k], **FIELD)
    return got


@pytest.mark.parametrize("what", sorted(INFINITE))
def test_sample_pdf_and_emission(what, tmp_path):
    """sample_light_direct over the infinite light and two spots and two
    points (uniform selector), light_pdf_direct_solid, and the infinite
    light's emission and pdf for escaped rays."""
    js, jt, ts, tt = _pair(_with_lights([INFINITE[what]] + FINITE,
                                        tmp_path=tmp_path))
    ln = _lanes()
    r = np.random.default_rng(11)
    lidx = r.integers(0, ts.num_lights, N).astype(np.int32)
    got = _sample_and_hold(js, jt, ts, tt, lidx, ln)
    assert (_np(got["pdf_value"])[lidx == 0] > 0).any()
    d = _unit(r, N)
    dist = r.uniform(0.1, 3, N).astype(np.float32)
    cosv = r.uniform(-1, 1, N).astype(np.float32)
    pc = r.uniform(0, 0.5, (N, 2)).astype(np.float32)
    _lanes_rel(tlight.light_pdf_direct_solid(ts, tt, _t(lidx), _t(ln["pos"]),
                                       _t(d), _t(dist), _t(cosv), _t(pc),
                                       _t(ln["active"])),
         jlight.light_pdf_direct_solid(js, jt, jnp.asarray(lidx),
                                       jnp.asarray(ln["pos"]),
                                       jnp.asarray(d), jnp.asarray(dist),
                                       jnp.asarray(cosv), jnp.asarray(pc),
                                       jnp.asarray(ln["active"])), **FIELD)
    tcol, tpdf = tlight.env_emission_and_pdf(ts, tt, 0, _t(d))
    jcol, jpdf = jlight.env_emission_and_pdf(js, jt, 0, jnp.asarray(d))
    _lanes_rel(tcol, jcol, **FIELD)
    _lanes_rel(tpdf, jpdf, **FIELD)
    # along the directions NEE sampled
    sd = _np(got["dir"])
    _lanes_rel(tlight.env_emission_and_pdf(ts, tt, 0, _t(sd))[1],
               jlight.env_emission_and_pdf(js, jt, 0, jnp.asarray(sd))[1],
               **FIELD)


SELECTORS = [(k, inf) for k in ("uniform", "simple", "cdf", "hierarchy")
             for inf in (0, 1, 2)]


@pytest.mark.parametrize("selector,n_inf", SELECTORS)
def test_select_light(selector, n_inf, tmp_path):
    """Ids, counters and pdfs of every selector with no, one and two
    infinite lights beside the finite ones, then the pdf the MIS weight
    reads for each pick (`light_select_pdf`) and the sample of the picked
    light."""
    inf = [INFINITE["sun"], dict(INFINITE["env cdf"], name="j")][:n_inf]
    js, jt, ts, tt = _pair(_with_lights(inf + FINITE, selector,
                                        tmp_path=tmp_path))
    assert ("lh_child" in ts.tables) == (selector == "hierarchy")
    ln = _lanes(5)
    jl, jp, jc = jlight.select_light(
        js, jt, jnp.asarray(ln["seed"]), jnp.asarray(ln["ctr"]),
        jnp.asarray(ln["active"]), from_pos=jnp.asarray(ln["pos"]))
    tl, tp, tc = tlight.select_light(ts, tt, _t(ln["seed"]), _t(ln["ctr"]),
                                     _t(ln["active"]), from_pos=_t(ln["pos"]))
    _exact(tl, jl)
    _exact(tc, jc)
    pdf_tol = 1e-6 if selector != "hierarchy" else 1e-5
    _lanes_rel(tp, jp, pdf_tol)
    picked = np.unique(_np(tl)[ln["active"]])
    assert len(picked) == ts.num_lights
    # the MIS replay gives the selection's pdf, and the JAX replay's
    tsel = tlight.light_select_pdf(ts, tt, tl, _t(ln["pos"]))
    _rel(np.where(ln["active"], _np(tsel), 0),
         np.where(ln["active"], _np(tp), 0), pdf_tol)
    _lanes_rel(tsel, jlight.light_select_pdf(js, jt, jl,
                                             jnp.asarray(ln["pos"])),
               pdf_tol)
    _sample_and_hold(js, jt, ts, tt, np.asarray(jl), dict(ln, ctr=jc))
