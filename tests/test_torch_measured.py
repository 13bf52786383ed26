"""The port's measured BSDFs (`ignis_tpu_torch/measured/`, `bsdf/klems_bsdf`,
`bsdf/tensortree_bsdf`) against the JAX package's.

Dupuy-Jakob (djmeasured): the host side (tensor_file, the Marginal2D CDF
tables) equal, bit for bit; the warps, the BRDF and the Ignis closure on
4096 lanes; the internal consistency checks of tests/test_djmeasured.py on
the port.  Klems and TensorTree: the test writes its own small XML
(`scenes.write_klems_xml` over a 3-band basis, `write_tensortree_xml` at
depth 3, and a one-leaf TensorTree4 by hand); the loaders' tables equal,
bit for bit; patch indices and tree lookups exactly equal; eval, pdf and
sample within 1e-5 (rtol and atol) on 4096 lanes.  The Dupuy-Jakob
sampler's outputs may part by up to 1e-3 on at most 1.5 % of the lanes
(`_close_but_few`: the last bit of arcsin / atan2 through an
ill-conditioned quadratic solve).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ignis_tpu.bsdf import klems_bsdf as jk
from ignis_tpu.bsdf import tensortree_bsdf as jtt
from ignis_tpu.measured import djmeasured as jdj
from ignis_tpu.measured import klems as jkl
from ignis_tpu.measured import tensortree as jtree
from ignis_tpu_torch.bsdf import klems_bsdf as tk
from ignis_tpu_torch.bsdf import tensortree_bsdf as ttt
from ignis_tpu_torch.measured import djmeasured as tdj
from ignis_tpu_torch.measured import klems as tkl
from ignis_tpu_torch.measured import tensortree as ttree
from ignis_tpu_torch.scenes import (
    write_dj_bsdf, write_klems_xml, write_tensortree_xml,
)

N = 4096
TOL = dict(rtol=1e-5, atol=1e-5)
SMALL_BASIS = ((0.0, 0.0, 20.0, 1), (35.0, 20.0, 50.0, 6),
               (70.0, 50.0, 90.0, 8))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a)


def _both(tables):
    return ({k: jnp.asarray(v) for k, v in tables.items()},
            {k: _t(v) for k, v in tables.items()})


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def _close_but_few(got, ref, scale=1.0):
    """Within 1e-5 (x `scale`) but on at most 1.5 % of the lanes, which
    are held to 1e-3: arcsin / atan2 differ in the last bit between XLA
    and PyTorch (and within XLA itself: eager and jitted `_elevation`
    differ on 374 of these 4096 lanes), and the Dupuy-Jakob sampler's
    quadratic solve (c0 - sqrt(c0^2 - 2 s (c0 - c1))) / (c0 - c1)
    magnifies that where c0 ~ c1."""
    a, b = got.detach().numpy(), np.asarray(ref)
    far = ~np.isclose(a, b, rtol=1e-5, atol=1e-5 * scale)
    lanes = far.reshape(far.shape[0], -1).any(axis=1)
    assert lanes.mean() <= 0.015, lanes.sum()
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3 * scale)


def _dirs(rng, n, upper=None):
    v = rng.normal(size=(n, 3))
    if upper is not None:
        v[:, 2] = np.abs(v[:, 2]) + upper
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _surf(rng, n):
    """Shading frames: a normal, its ONB, and the entering flag."""
    nrm = _dirs(rng, n)
    s = np.where(nrm[:, 2:3] >= 0, 1.0, -1.0)
    a = -1.0 / (s + nrm[:, 2:3])
    b = nrm[:, 0:1] * nrm[:, 1:2] * a
    t = np.concatenate([1 + s * nrm[:, 0:1] ** 2 * a, s * b,
                        -s * nrm[:, 0:1]], 1)
    bt = np.concatenate([b, s + nrm[:, 1:2] ** 2 * a, -nrm[:, 1:2]], 1)
    ent = rng.uniform(size=n) < 0.7
    arrs = dict(n=nrm, t=t.astype(np.float32), b=bt.astype(np.float32),
                is_entering=ent)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: _t(v) for k, v in arrs.items()})


# ------------------------------------------------------------- djmeasured

@pytest.fixture(scope="module")
def brdf(tmp_path_factory):
    p = tmp_path_factory.mktemp("dj") / "synth.bsdf"
    write_dj_bsdf(p, 7, ntheta=5, res=16, lres=8)
    tj, info_j = jdj.load_brdf(p, "dj0")
    tt, info_t = tdj.load_brdf(p, "dj0")
    return p, tj, tt, info_j, info_t


def test_dj_generator_is_the_reference_tests(tmp_path):
    from test_djmeasured import make_bsdf_file
    ref = make_bsdf_file(tmp_path / "a.bsdf", nphi=1, ntheta=11, res=64,
                         lres=32, seed=3)
    got = write_dj_bsdf(tmp_path / "b.bsdf", 3)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert (tmp_path / "a.bsdf").read_bytes() == \
        (tmp_path / "b.bsdf").read_bytes()


def test_dj_host_tables_equal(brdf, tmp_path):
    p, tj, tt, info_j, info_t = brdf
    assert info_j == info_t and tj.keys() == tt.keys()
    for k in tj:
        np.testing.assert_array_equal(tt[k], tj[k], err_msg=k)
    fields = tdj.load_tensor_file(p)
    back = tmp_path / "back.bsdf"
    jdj.write_tensor_file(back, fields)
    assert back.read_bytes() == p.read_bytes()


@pytest.mark.parametrize("what", ["weights", "eval0", "invert", "sample",
                                  "eval2", "rgb"])
def test_dj_warps_match(brdf, what):
    _, tj, tt, info, _ = brdf
    j, t = _both(tj)
    rng = np.random.default_rng(3)
    u = (rng.random((N, 2), np.float32) * 0.98 + 0.01).astype(np.float32)
    u[:8] = [[0, 0], [1, 1], [0, 1], [1, 0], [0.5, 0], [0, 0.5],
             [1, 0.25], [0.999999, 1e-7]]
    phi = np.zeros(N, np.float32)
    theta = (rng.random(N, np.float32) * 1.6).astype(np.float32)
    theta[:4] = [0.0, 1.5, 0.375, 1.6]
    if what == "weights":
        for a, b in zip(tdj._param_weights(t["dj0_theta_i"], _t(theta)),
                        jdj._param_weights(j["dj0_theta_i"],
                                           jnp.asarray(theta))):
            _close(a, b, rtol=0, atol=0)
        return
    if what == "eval0":
        _close(tdj._eval_warp0(t["dj0_ndf"], _t(u)),
               jdj._eval_warp0(j["dj0_ndf"], jnp.asarray(u)))
        return
    slj = jdj._make_slice(j, "dj0", info, jnp.asarray(phi),
                          jnp.asarray(theta))
    slt = tdj._make_slice(t, "dj0", info, _t(phi), _t(theta))
    args = ("dj0_vndf_data", "dj0_vndf_cond", "dj0_vndf_marg")
    if what in ("invert", "sample"):
        fj = getattr(jdj, f"_{what}_warp2")
        ft = getattr(tdj, f"_{what}_warp2")
        ref = fj(slj, *(j[a] for a in args), jnp.asarray(u))
        got = ft(slt, *(t[a] for a in args), _t(u))
        for a, b in zip(got, ref):
            _close(a, b, rtol=1e-5, atol=1e-5 * max(
                1.0, float(np.abs(np.asarray(b)).max())))
    elif what == "eval2":
        _close(tdj._eval_warp2(slt, t["dj0_lum_data"], _t(u)),
               jdj._eval_warp2(slj, j["dj0_lum_data"], jnp.asarray(u)))
    else:
        _close(tdj._eval_rgb(slt, t["dj0_rgb"], _t(u)),
               jdj._eval_rgb(slj, j["dj0_rgb"], jnp.asarray(u)))


@pytest.mark.parametrize("what", ["eval", "pdf", "sample", "closure"])
def test_dj_brdf_matches(brdf, what):
    _, tj, tt, info, _ = brdf
    j, t = _both(tj)
    rng = np.random.default_rng(5)
    wi, wo = _dirs(rng, N, 0.05), _dirs(rng, N)
    u1, u2 = (rng.random((2, N), np.float32) * 0.98 + 0.01).astype(np.float32)
    if what in ("eval", "pdf"):
        fj = getattr(jdj, f"brdf_{what}_local")
        ft = getattr(tdj, f"brdf_{what}_local")
        ref = fj(j, "dj0", info, jnp.asarray(wi), jnp.asarray(wo))
        got = ft(t, "dj0", info, _t(wi), _t(wo))
        _close(got, ref, rtol=1e-5, atol=1e-5 * float(
            np.abs(np.asarray(ref)).max()))
        assert (np.asarray(ref) > 0).mean() > 0.3
    elif what == "sample":
        ref = jdj.brdf_sample_local(j, "dj0", info, jnp.asarray(u1),
                                    jnp.asarray(u2), jnp.asarray(wi))
        got = tdj.brdf_sample_local(t, "dj0", info, _t(u1), _t(u2), _t(wi))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
        for a, b in zip(got[:3], ref[:3]):
            _close_but_few(a, b, max(1.0, float(np.abs(np.asarray(b)).max())))
    else:
        sj, st = _surf(rng, N)
        tint = rng.uniform(0.2, 1, (N, 3)).astype(np.float32)
        _close(tdj.dj_eval(t, "dj0", info, _t(tint), st, _t(wi), _t(wo)),
               jdj.dj_eval(j, "dj0", info, jnp.asarray(tint), sj,
                           jnp.asarray(wi), jnp.asarray(wo)), rtol=1e-5,
               atol=1e-4)
        ref = jdj.dj_sample(j, "dj0", info, jnp.asarray(tint), sj,
                            jnp.asarray(u1), jnp.asarray(u2),
                            jnp.asarray(wo))
        got = tdj.dj_sample(t, "dj0", info, _t(tint), st, _t(u1), _t(u2),
                            _t(wo))
        valid = np.array(ref[4])
        np.testing.assert_array_equal(got[4].numpy(), valid)
        # the direction of an invalid sample (below the horizon) is unused
        _close_but_few(got[0][valid], np.asarray(ref[0])[valid])
        for a, b in zip(got[1:4], ref[1:4]):
            _close_but_few(a, b, max(1.0, float(np.abs(np.asarray(b)).max())))


def test_dj_sample_invert_roundtrip_on_the_port(brdf):
    _, _, tt, info, _ = brdf
    t = _both(tt)[1]
    rng = np.random.default_rng(3)
    u = _t((rng.random((512, 2), np.float32) * 0.96 + 0.02))
    sl = tdj._make_slice(t, "dj0", info, torch.zeros(512),
                         _t(rng.random(512, np.float32) * 1.4))
    args = (t["dj0_vndf_data"], t["dj0_vndf_cond"], t["dj0_vndf_marg"])
    uv, pdf_s = tdj._sample_warp2(sl, *args, u)
    back, pdf_i = tdj._invert_warp2(sl, *args, uv)
    assert np.quantile((back - u).abs().amax(-1).numpy(), 0.9) < 2e-3
    assert np.quantile(((pdf_s - pdf_i).abs() / pdf_s).numpy(), 0.9) < 2e-3
    # the density integrates to one over the unit square
    k = 64
    xs = (np.arange(k) + 0.5) / k
    gx, gy = np.meshgrid(xs, xs)
    pos = _t(np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32))
    sl = tdj._make_slice(t, "dj0", info, torch.zeros(k * k),
                         torch.full((k * k,), 0.7))
    d = tdj._eval_warp2(sl, t["dj0_vndf_data"], pos)
    assert float(d.mean()) == pytest.approx(1.0, rel=2e-2)


# ------------------------------------------------------------------ Klems

@pytest.fixture(scope="module")
def klems(tmp_path_factory):
    p = tmp_path_factory.mktemp("klems") / "k.xml"
    write_klems_xml(p, 3, basis=SMALL_BASIS)
    cj, ct = jkl.load_klems_xml(p), tkl.load_klems_xml(p)
    tj, info_j = jkl.klems_tables(cj, "klems0")
    tt, info_t = tkl.klems_tables(ct, "klems0")
    return cj, ct, tj, tt, info_j, info_t


def test_klems_loader_tables_equal(klems, tmp_path):
    cj, ct, tj, tt, info_j, info_t = klems
    assert tj.keys() == tt.keys() and info_j == info_t
    for k in tj:
        np.testing.assert_array_equal(tt[k], tj[k], err_msg=k)
    assert tt["klems0_front_transmission_mat"].shape == (15, 15)
    # the full basis: 145 patches, four 145 x 145 matrices
    p = tmp_path / "full.xml"
    write_klems_xml(p, 4)
    full, _ = tkl.klems_tables(tkl.load_klems_xml(p), "k")
    ref, _ = jkl.klems_tables(jkl.load_klems_xml(p), "k")
    for k in ref:
        np.testing.assert_array_equal(full[k], ref[k], err_msg=k)
    assert full["k_back_reflection_mat"].shape == (145, 145)


def test_klems_lookup_matches(klems):
    _, _, tj, tt, info, _ = klems
    j, t = _both(tj)
    rng = np.random.default_rng(8)
    wi, wo = _dirs(rng, N), _dirs(rng, N)
    for comp in jkl._COMP_ORDER:
        it, ip = jkl._spherical(jnp.asarray(wi))
        idx_j = jkl._basis_index(j, "klems0", comp, "col", it, ip)
        idx_t = tkl._basis_index(t, "klems0", comp, "col", *tkl._spherical(
            _t(wi)))
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        _close(tkl.klems_eval_component(t, "klems0", comp, _t(wi), _t(wo)),
               jkl.klems_eval_component(j, "klems0", comp, jnp.asarray(wi),
                                        jnp.asarray(wo)), rtol=0, atol=0)


def _bsdf_case(rng, tj):
    j, t = _both(tj)
    sj, st = _surf(rng, N)
    wi, wo = _dirs(rng, N), _dirs(rng, N)
    u = (rng.random((3, N), np.float32) * 0.98 + 0.01).astype(np.float32)
    col = rng.uniform(0.2, 1, (N, 3)).astype(np.float32)
    return j, t, sj, st, wi, wo, u, col


@pytest.mark.parametrize("kind", ["klems", "tensortree"])
@pytest.mark.parametrize("up", [(0.0, 0.0, 1.0), (0.0, 1.0, 0.0)])
def test_measured_bsdf_matches(klems, tree, kind, up):
    """eval / pdf / sample of the Ignis closures over random frames (the
    `up` vector along and across the normals)."""
    rng = np.random.default_rng(9)
    if kind == "klems":
        tj, info = klems[2], dict(klems[4])
        mj, mt, pre = jk, tk, "klems0"
        names = ("klems_eval", "klems_pdf", "klems_sample")
    else:
        tj, info = tree[2], dict(tree[4])
        mj, mt, pre = jtt, ttt, "tt0"
        names = ("tensortree_eval", "tensortree_pdf", "tensortree_sample")
    info["up"] = np.asarray(up, np.float32)
    j, t, sj, st, wi, wo, u, col = _bsdf_case(rng, tj)
    ev_j = getattr(mj, names[0])(j, pre, info, jnp.asarray(col), info["up"],
                                 sj, jnp.asarray(wi), jnp.asarray(wo))
    ev_t = getattr(mt, names[0])(t, pre, dict(info), _t(col), info["up"],
                                 st, _t(wi), _t(wo))
    _close(ev_t, ev_j, rtol=1e-5, atol=1e-5 * float(
        np.abs(np.asarray(ev_j)).max()))
    assert (np.asarray(ev_j) > 0).any()
    pdf_j = getattr(mj, names[1])(j, pre, info, info["up"], sj,
                                  jnp.asarray(wi), jnp.asarray(wo))
    pdf_t = getattr(mt, names[1])(t, pre, info, info["up"], st, _t(wi),
                                  _t(wo))
    _close(pdf_t, pdf_j)
    ref = getattr(mj, names[2])(j, pre, info, jnp.asarray(col), info["up"],
                                sj, *map(jnp.asarray, u), jnp.asarray(wo))
    got = getattr(mt, names[2])(t, pre, dict(info), _t(col), info["up"], st,
                                *map(_t, u), _t(wo))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
    for a, b in zip(got[:4], ref[:4]):
        _close(a, b, rtol=1e-5, atol=1e-5 * max(
            1.0, float(np.abs(np.asarray(b)).max())))


# ------------------------------------------------------------- TensorTree

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    p = tmp_path_factory.mktemp("tt") / "t.xml"
    write_tensortree_xml(p, 5, depth=3)
    tj, info_j = jtree.tensortree_tables(jtree.load_tensortree_xml(p), "tt0")
    tt, info_t = ttree.tensortree_tables(ttree.load_tensortree_xml(p), "tt0")
    return p, tt, tj, info_t, info_j


def _tt4(path):
    """A TensorTree4 whose root is one leaf of 16 values."""
    vals = " ".join(str(0.1 + 0.05 * i) for i in range(16))
    body = "".join(
        "<WavelengthData><WavelengthDataBlock><WavelengthDataDirection>"
        f"{d}</WavelengthDataDirection><ScatteringData>{{ {{ {vals} }} }}"
        "</ScatteringData></WavelengthDataBlock></WavelengthData>"
        for d in ("Transmission Front", "Reflection Front"))
    path.write_text(
        "<WindowElement><Optical><Layer><DataDefinition>"
        "<IncidentDataStructure>TensorTree4</IncidentDataStructure>"
        f"</DataDefinition>{body}</Layer></Optical></WindowElement>")


def test_tensortree_loader_tables_equal(tree, tmp_path):
    p, tt, tj, info_t, info_j = tree
    assert tt.keys() == tj.keys() and info_t == info_j
    for k in tj:
        np.testing.assert_array_equal(tt[k], tj[k], err_msg=k)
        assert tt[k].dtype == tj[k].dtype
    # refined where the peak varies: a tree of 3 levels
    nodes = tt["tt0_front_transmission_nodes"]
    assert ttree.tree_levels(nodes, 3) == 3
    _tt4(tmp_path / "t4.xml")
    a = ttree.load_tensortree_xml(tmp_path / "t4.xml")
    b = jtree.load_tensortree_xml(tmp_path / "t4.xml")
    assert a["ndim"] == b["ndim"] == 4
    for k in jtree._COMP_ORDER:
        assert a[k]["root_is_leaf"] == b[k]["root_is_leaf"]
        np.testing.assert_array_equal(a[k]["values"], b[k]["values"])


@pytest.mark.parametrize("ndim", [3, 4])
def test_tensortree_lookup_matches(tree, tmp_path, ndim):
    if ndim == 3:
        _, tt, tj, info, _ = tree
    else:
        _tt4(tmp_path / "t4.xml")
        tj, info = jtree.tensortree_tables(
            jtree.load_tensortree_xml(tmp_path / "t4.xml"), "tt0")
    j, t = _both(tj)
    rng = np.random.default_rng(10)
    wi, wo = _dirs(rng, N, 0.0), _dirs(rng, N, 0.0)
    nonzero = 0
    for ci, comp in enumerate(jtree._COMP_ORDER):
        ref = jtree.tt_eval_component(j, "tt0", comp, ci, info,
                                      jnp.asarray(wi), jnp.asarray(wo))
        got = ttree.tt_eval_component(t, "tt0", comp, ci, dict(info),
                                      _t(wi), _t(wo))
        _close(got, ref)
        nonzero += int((np.asarray(ref) != 0).any())
    # the one-leaf TensorTree4 gives two components (and its back
    # transmission stands in for the missing front one), the writer all four
    assert nonzero == (4 if ndim == 3 else 3)
