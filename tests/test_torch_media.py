"""The port's participating media (`ignis_tpu_torch/medium/`) against the JAX
package's (`ignis_tpu/medium/`), function by function on 4096 lanes.

One compiled scene holds every kind of medium: homogeneous (scattering,
absorb-only, PExpr-valued), `.bin` voxel grids (nearest and trilinear) and
NanoVDB density grids under each shader (`pbrt_volume`, `principled_volume`,
`monochromatic`), with the quadrature (`regular`) and the ratio tracker
(`delta_tracking`); the same numpy-seeded inputs go through both packages.

Tolerances: ids, event masks and RNG counters exactly equal; float fields
within 1e-5 (rtol and atol).  The shaders' temperature branches are held
here at the function level (`write_nvdb_grid` puts one grid in a file, so
no scene carries a temperature grid).
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.medium import union as jm
from ignis_tpu.medium import volume as jv
from ignis_tpu.medium.nanovdb import write_nvdb_grid
from ignis_tpu.scene.compile import load_and_compile as j_compile
from ignis_tpu_torch.convert import scene_from_metadata, tables_from_numpy
from ignis_tpu_torch.medium import union as tm
from ignis_tpu_torch.medium import volume as tv

N = 4096
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager ops run faster on one intra-op thread, and the test
    workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_bin(path, rng, dims=(6, 5, 7)):
    w, h, d = dims
    vox = rng.uniform(0.0, 2.0, (d, h, w, 12)).astype(np.float32)
    with open(path, "wb") as f:
        f.write(struct.pack("4I", w, h, d, 0))
        f.write(vox.tobytes())


# (name, medium) of the scene's media, one cube each, in this order
def _media(d):
    rng = np.random.default_rng(5)
    _write_bin(d / "g.bin", rng)
    cloud = rng.uniform(0.0, 1.5, (9, 8, 10)).astype(np.float32)
    cloud[cloud < 0.3] = 0.0
    write_nvdb_grid(str(d / "c.nvdb"), cloud, "density")
    vox = dict(type="heterogeneous", filename=str(d / "g.bin"))
    nvdb = dict(type="heterogeneous", filename=str(d / "c.nvdb"))
    return [
        ("scat", dict(type="homogeneous", sigma_a=[0.1, 0.2, 0.3],
                      sigma_s=[0.5, 0.8, 1.1], g=0.4)),
        ("absorb", dict(type="homogeneous", sigma_a=[0.3, 0.6, 0.9],
                        sigma_s=[0, 0, 0])),
        ("expr", dict(type="homogeneous",
                      sigma_a="color(0.2 + uv.x, 0.3, 0.4 + 0.1 * P.y)",
                      sigma_s=[0.4, 0.4, 0.4], g=-0.3)),
        ("vox", dict(vox, g=0.2, scalar_emission=0.7)),
        ("vox_lin", dict(vox, interpolate=True, method="delta_tracking",
                         scalar_density=1.5)),
        ("cloud", dict(nvdb, shader="pbrt_volume", interpolate=True,
                       method="delta_tracking", scalar_emission=0.5,
                       scalar_density=2.0, g=-0.5)),
        ("cloud_p", dict(nvdb, shader="principled_volume",
                         scalar_emission=0.3)),
        ("cloud_m", dict(nvdb, shader="monochromatic",
                         scalar_absorption=0.2, method="delta_tracking")),
        ("vac", dict(type="vacuum")),
    ]


def _center(i):
    return np.asarray([-4.0 + 1.5 * i, 0.25 * i, 0.1 * i], np.float32)


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    d = tmp_path_factory.mktemp("media")
    meds = _media(d)
    scene = {
        "technique": {"type": "volpath", "max_depth": 4},
        "camera": {"type": "perspective", "fov": 40,
                   "transform": {"translate": [0, 0, -8]}},
        "film": {"size": [8, 8]},
        "bsdfs": [{"type": "passthrough", "name": "null"}],
        "shapes": [{"type": "cube", "name": f"c{i}", "width": 1,
                    "height": 0.8, "depth": 1.2,
                    "transform": {"translate": _center(i).tolist()}}
                   for i in range(len(meds))],
        "entities": [{"name": f"c{i}", "shape": f"c{i}", "bsdf": "null",
                      "inner_medium": name}
                     for i, (name, _) in enumerate(meds)],
        "lights": [{"type": "constant", "name": "sky", "radiance": 1}],
        "media": [dict(m, name=name) for name, m in meds],
    }
    js = j_compile(scene)
    jt = {k: jnp.asarray(v) for k, v in js.tables.items()}
    ts = scene_from_metadata(js)
    tt = tables_from_numpy(js.tables, "cpu")
    return js, jt, ts, tt


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a))


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def _lanes(js, seed):
    """Per-lane inputs: medium ids in [-1, #media), segments around the
    lane's medium's cube (partly outside it), seeds and counters."""
    rng = np.random.default_rng(seed)
    nm = len(js.media)
    mid = rng.integers(-1, nm, N).astype(np.int32)
    c = np.stack([_center(max(m, 0)) for m in mid])
    p0 = (c + rng.uniform(-0.7, 0.7, (N, 3))).astype(np.float32)
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p1 = (p0 + d * rng.uniform(0.05, 1.6, (N, 1))).astype(np.float32)
    return dict(mid=mid, p0=p0, p1=p1, dir=d.astype(np.float32), around=c,
                seed=rng.integers(0, 2**32, N, dtype=np.uint32),
                ctr=rng.integers(0, 2**20, N).astype(np.uint32),
                active=rng.uniform(size=N) < 0.85,
                uv=rng.uniform(size=(N, 2)).astype(np.float32),
                g=rng.uniform(-0.9, 0.9, N).astype(np.float32))


def _hetero(js):
    return [(mi, m) for mi, m in enumerate(js.media)
            if m["type"].startswith("hetero")]


# ---------------------------------------------------------------- volume.py

@pytest.mark.parametrize("interp", [False, True])
def test_grid_lookup_matches(interp):
    rng = np.random.default_rng(1)
    grid = rng.uniform(size=(5, 4, 7, 3)).astype(np.float32)
    # in and out of [0, 1]^3, on voxel faces, and a NaN lane
    lp = rng.uniform(-0.3, 1.3, (N, 3)).astype(np.float32)
    lp[:64] = np.round(lp[:64] * 28) / 28
    lp[64] = np.nan
    ref = jv.grid_lookup(jnp.asarray(grid), jnp.asarray(lp), interp)
    got = tv.grid_lookup(_t(grid), _t(lp), interp)
    ok = ~np.isnan(lp).any(axis=1)
    _close(got[ok], np.asarray(ref)[ok])


def test_grid_lookup_gradient_accumulates():
    """The lookup's backward is a scatter-add over the voxels (atomic on
    the card): each voxel's gradient is the sum of its lanes' weights."""
    rng = np.random.default_rng(2)
    grid = _t(rng.uniform(size=(3, 3, 3, 1)).astype(np.float32))
    grid.requires_grad_(True)
    lp = _t(rng.uniform(size=(N, 3)).astype(np.float32))
    tv.grid_lookup(grid, lp, True).sum().backward()
    import jax
    jg = jax.grad(lambda g: jv.grid_lookup(g, jnp.asarray(lp.numpy()),
                                           True).sum())(
        jnp.asarray(grid.detach().numpy()))
    np.testing.assert_allclose(grid.grad.numpy(), np.asarray(jg), rtol=1e-4)
    assert float(grid.grad.sum()) == pytest.approx(N, rel=1e-5)


def test_point_mapper_and_bounds_match(media):
    js, jt, ts, tt = media
    x = _lanes(js, 3)
    for mi, m in _hetero(js):
        ref = jv.to_normalized_point(jt, m["ref_entity"],
                                     jnp.asarray(x["p0"]))
        got = tv.to_normalized_point(tt, m["ref_entity"], _t(x["p0"]))
        _close(got, ref)
        np.testing.assert_array_equal(
            tv.inside_unit(_t(np.asarray(ref))).numpy(),
            np.asarray(jv.inside_unit(ref)))


def test_blackbody_matches():
    t = np.concatenate([np.linspace(0, 40000, N - 4),
                        [999.0, 1000.0, 6500.0, 1e6]]).astype(np.float32)
    _close(tv._blackbody_rgb(_t(t)), jv._blackbody_rgb(jnp.asarray(t)))


@pytest.mark.parametrize("shader", ["monochromatic", "pbrt_volume",
                                    "principled_volume"])
@pytest.mark.parametrize("temperature", [False, True])
def test_density_shader_matches(shader, temperature):
    rng = np.random.default_rng(4)
    row = tv.shader_row_from_props(dict(
        shader=shader, scalar_density=1.7, scalar_emission=0.6,
        color_blackbody=[1.0, 0.8, 0.6], scalar_blackbody=0.7,
        scalar_temperature=900.0, offset_temperature=0.1))
    np.testing.assert_array_equal(row, jv.shader_row_from_props(dict(
        shader=shader, scalar_density=1.7, scalar_emission=0.6,
        color_blackbody=[1.0, 0.8, 0.6], scalar_blackbody=0.7,
        scalar_temperature=900.0, offset_temperature=0.1)))
    dens = rng.uniform(-0.1, 2.0, N).astype(np.float32)
    dens[:16] = 0.0
    temp = (rng.uniform(0.0, 8.0, N).astype(np.float32)
            if temperature else None)
    ref = jv.apply_density_shader(shader, jnp.asarray(row),
                                  jnp.asarray(dens),
                                  None if temp is None else jnp.asarray(temp))
    got = tv.apply_density_shader(shader, _t(row), _t(dens),
                                  None if temp is None else _t(temp))
    for a, b in zip(got, ref):
        _close(a, np.broadcast_to(np.asarray(b), tuple(a.shape)),
               rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(b).max())))


# ----------------------------------------------------------------- union.py

def test_medium_coefficients_match(media):
    js, jt, ts, tt = media
    x = _lanes(js, 6)
    ctx = dict(uv=x["uv"], P=x["p0"])
    ref = jm.medium_coefficients(js, jt, jnp.asarray(x["mid"]),
                                 {k: jnp.asarray(v) for k, v in ctx.items()})
    got = tm.medium_coefficients(ts, tt, _t(x["mid"]),
                                 {k: _t(v) for k, v in ctx.items()})
    for a, b in zip(got, ref):
        _close(a, b)
    # the PExpr medium varies by lane
    expr = x["mid"] == 2
    assert np.ptp(got[0].numpy()[expr, 0]) > 0.5


@pytest.mark.parametrize("kind", ["props", "quadrature", "ratio"])
def test_hetero_functions_match(media, kind):
    js, jt, ts, tt = media
    x = _lanes(js, 7)
    for mi, m in _hetero(js):
        # every lane's segment around this medium's cube
        p0 = x["p0"] - x["around"] + _center(mi)
        p1 = x["p1"] - x["around"] + _center(mi)
        if kind == "props":
            ref = jm._hetero_props_at(js, jt, mi, m, jnp.asarray(p0))
            got = tm._hetero_props_at(ts, tt, mi, m, _t(p0))
        elif kind == "quadrature":
            ref = (jm._hetero_transmittance(js, jt, mi, m, jnp.asarray(p0),
                                            jnp.asarray(p1)),)
            got = (tm._hetero_transmittance(ts, tt, mi, m, _t(p0), _t(p1)),)
        else:
            ref = (jm._hetero_ratio_transmittance(
                js, jt, mi, m, jnp.asarray(p0), jnp.asarray(p1),
                jnp.asarray(x["seed"]), jnp.asarray(x["ctr"])),)
            got = (tm._hetero_ratio_transmittance(
                ts, tt, mi, m, _t(p0), _t(p1), _t(x["seed"]),
                _t(x["ctr"])),)
        for a, b in zip(got, ref):
            _close(a, np.broadcast_to(np.asarray(b), tuple(a.shape)))
        if kind != "props":
            # attenuated and unattenuated lanes both occur
            tr = got[0].numpy()
            assert (tr < 0.9).any() and (tr > 0.999).any()


def test_ratio_stream_is_salted_in_range():
    """The salted seed stays a uint32 in the int64 carrier, and its draws
    are the JAX stream's bit for bit."""
    from ignis_tpu.core import rng as jr
    from ignis_tpu_torch.core import rng as tr
    seeds = np.asarray([0, 1, 0x9E3779B9, 0xFFFFFFFF, 0x61C88646],
                       np.uint32)
    salted = _t(seeds) ^ tm._RT_SALT
    assert int(salted.min()) >= 0 and int(salted.max()) < 2**32
    np.testing.assert_array_equal(
        salted.numpy(), (seeds ^ np.uint32(0x9E3779B9)).astype(np.int64))
    ctr = np.arange(5, dtype=np.uint32)
    uj, cj = jr.next_f32(jnp.asarray(seeds) ^ jnp.uint32(jm._RT_SALT),
                         jnp.asarray(ctr))
    ut, ct = tr.next_f32(salted, _t(ctr))
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize("stream", [False, True])
def test_medium_eval_matches(media, stream):
    js, jt, ts, tt = media
    x = _lanes(js, 8)
    sa, ss = (np.abs(np.random.default_rng(9).normal(size=(2, N, 3)))
              .astype(np.float32))
    kw_j = kw_t = {}
    if stream:
        kw_j = dict(seed=jnp.asarray(x["seed"]), counter=jnp.asarray(x["ctr"]))
        kw_t = dict(seed=_t(x["seed"]), counter=_t(x["ctr"]))
    ref = jm.medium_eval(js, jt, jnp.asarray(x["mid"]), jnp.asarray(sa),
                         jnp.asarray(ss), jnp.asarray(x["p0"]),
                         jnp.asarray(x["p1"]), **kw_j)
    got = tm.medium_eval(ts, tt, _t(x["mid"]), _t(sa), _t(ss), _t(x["p0"]),
                         _t(x["p1"]), **kw_t)
    _close(got, ref)
    ref_i = jm.medium_eval_inf(js, jt, jnp.asarray(x["mid"]),
                               jnp.asarray(sa * (x["uv"][:, :1] < 0.5)),
                               jnp.asarray(ss * 0), jnp.asarray(x["p0"]),
                               jnp.asarray(x["dir"]))
    got_i = tm.medium_eval_inf(ts, tt, _t(x["mid"]),
                               _t(sa * (x["uv"][:, :1] < 0.5)),
                               _t(ss * 0), _t(x["p0"]), _t(x["dir"]))
    _close(got_i, np.broadcast_to(np.asarray(ref_i), (N, 3)))


def test_medium_sample_matches(media):
    """Free flights (homogeneous) and delta tracking against the majorant
    (heterogeneous): valid lanes and counters exactly, fields to 1e-5."""
    js, jt, ts, tt = media
    x = _lanes(js, 10)
    rng = np.random.default_rng(11)
    sa = rng.uniform(0, 1.0, (N, 3)).astype(np.float32)
    ss = rng.uniform(0, 2.0, (N, 3)).astype(np.float32)
    ss[:128] = 0.0          # absorb-only lanes draw nothing
    sa[128:160] = ss[128:160] = 0.0
    ref, cj = jm.medium_sample(js, jt, jnp.asarray(x["mid"]), jnp.asarray(sa),
                               jnp.asarray(ss), jnp.asarray(x["seed"]),
                               jnp.asarray(x["ctr"]), jnp.asarray(x["p0"]),
                               jnp.asarray(x["p1"]), jnp.asarray(x["active"]))
    got, ct = tm.medium_sample(ts, tt, _t(x["mid"]), _t(sa), _t(ss),
                               _t(x["seed"]), _t(x["ctr"]), _t(x["p0"]),
                               _t(x["p1"]), _t(x["active"]))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj).astype(np.int64))
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(ref["valid"]))
    for k in ("pos", "pdf", "color", "sigma_a", "sigma_s", "sigma_n",
              "emission"):
        _close(got[k], ref[k], rtol=1e-5, atol=1e-5 * max(
            1.0, float(np.abs(np.asarray(ref[k])).max())))
    # every kind of lane is present: draws, no draws, collisions
    moved = ct.numpy() != x["ctr"]
    assert 0 < moved.sum() < N and 0 < got["valid"].sum()


@pytest.mark.parametrize("g_kind", ["negative", "zero", "positive", "mixed"])
def test_phase_functions_match(media, g_kind):
    js, *_ = media
    x = _lanes(js, 12)
    g = {"negative": -np.abs(x["g"]), "zero": np.zeros(N, np.float32),
         "positive": np.abs(x["g"]), "mixed": x["g"]}[g_kind]
    g = g.astype(np.float32)
    if g_kind == "mixed":
        g[:32] = 0.0005     # isotropic below |g| = 1e-3
    d_j, pdf_j, w_j, c_j = jm.phase_sample(
        jnp.asarray(g), jnp.asarray(x["seed"]), jnp.asarray(x["ctr"]),
        jnp.asarray(x["dir"]), jnp.asarray(x["active"]))
    d_t, pdf_t, w_t, c_t = tm.phase_sample(_t(g), _t(x["seed"]),
                                           _t(x["ctr"]), _t(x["dir"]),
                                           _t(x["active"]))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    _close(d_t, d_j)
    _close(pdf_t, pdf_j, rtol=1e-5, atol=1e-5 * float(
        np.abs(np.asarray(pdf_j)).max()))
    _close(w_t, w_j)
    ev_j = jm.phase_eval(jnp.asarray(g), jnp.asarray(x["p0"] / np.linalg.norm(
        x["p0"], axis=1, keepdims=True)), jnp.asarray(x["dir"]))
    ev_t = tm.phase_eval(_t(g), _t(x["p0"] / np.linalg.norm(
        x["p0"], axis=1, keepdims=True)), _t(x["dir"]))
    _close(ev_t, ev_j, rtol=1e-5, atol=1e-5 * float(
        np.abs(np.asarray(ev_j)).max()))


def test_hg_is_not_rotated_about_out_dir():
    """The reference's HG sampler returns its direction in the canonical
    frame: the sample does not depend on out_dir (kept for parity; listed
    in ROADMAP.md's queue 3)."""
    n = 64
    g = torch.full((n,), 0.7)
    seed = torch.arange(n, dtype=torch.int64) * 7919
    ctr = torch.ones(n, dtype=torch.int64)
    act = torch.ones(n, dtype=torch.bool)
    a = tm.phase_sample(g, seed, ctr, torch.tensor([[0.0, 0.0, 1.0]] * n),
                        act)[0]
    b = tm.phase_sample(g, seed, ctr, torch.tensor([[1.0, 0.0, 0.0]] * n),
                        act)[0]
    assert torch.equal(a, b)


def test_vjp_substitutes_keep_gradients_finite():
    """The where-substitutes of the sampler and the phase function give a
    zero slope, not 0 x inf, on lanes with zero extinction or g = 0."""
    n = 256
    g = torch.zeros(n, requires_grad=True)
    seed = torch.arange(n, dtype=torch.int64)
    ctr = torch.ones(n, dtype=torch.int64)
    d = torch.tensor([[0.0, 0.0, 1.0]] * n)
    _, pdf, _, _ = tm.phase_sample(g, seed, ctr, d,
                                   torch.ones(n, dtype=torch.bool))
    (pdf.sum() + tm.phase_eval(g, d, d).sum()).backward()
    assert torch.isfinite(g.grad).all()

    class _S:
        media = [dict(type="homogeneous")]
    sa = torch.zeros((n, 3), requires_grad=True)
    ss = torch.zeros((n, 3), requires_grad=True)
    ms, _ = tm.medium_sample(_S(), {}, torch.zeros(n, dtype=torch.int32), sa,
                             ss, seed, ctr, torch.zeros((n, 3)),
                             torch.ones((n, 3)),
                             torch.ones(n, dtype=torch.bool))
    (ms["color"].sum() + ms["pdf"].sum()).backward()
    assert torch.isfinite(sa.grad).all() and torch.isfinite(ss.grad).all()
