"""The port's whole-soup Moeller-Trumbore sweep (`ops/mt_intersect.py`): its
plain PyTorch version (the one the CPU wrapper runs) against the
`ops/intersect.py` oracle of both packages and against the JAX package's
Pallas kernels in interpret mode.

The Pallas entries take no `interpret` argument and no test of the JAX
package runs them; here `pl.pallas_call` is patched, inside that module only,
to run in interpret mode, which changes no file of the JAX package.

Tolerances: prim ids equal, except that at bit-equal t either id is right
(the sweep keeps the HIGHEST index among equal t, the oracle the lowest);
t to 1e-5 relative and u, v to 1e-4 absolute, because XLA on the CPU
contracts multiply-adds and the oracle sums with a reduction.  The plain
version against a triangle-by-triangle sweep written like the CUDA kernel:
EQUAL, bit for bit.
"""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.ops import intersect as j_int
from ignis_tpu.ops import pallas_intersect as j_pal
from ignis_tpu_torch.ops import intersect as t_int
from ignis_tpu_torch.ops import mt_intersect as mt

F32 = np.float32


def _soup(t, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2, 2, (t, 3)).astype(F32),
            rng.uniform(-1, 1, (t, 3)).astype(F32),
            rng.uniform(-1, 1, (t, 3)).astype(F32))


def _rays(n, seed=1):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-3, 3, (n, 3)).astype(F32)
    d = rng.normal(0, 1, (n, 3)).astype(F32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d, np.zeros(n, F32), np.full(n, 1e30, F32)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(j_pal.pl, "pallas_call", functools.partial(
        j_pal.pl.pallas_call, interpret=True))


def _assert_same_hits(ref, got):
    rt, ru, rv, ri = (np.asarray(a) for a in ref)
    gt, gu, gv, gi = (np.asarray(a) for a in got)
    differ = ri != gi
    tie = differ & (ri >= 0) & (gi >= 0) & (rt == gt)
    assert not (differ & ~tie).any(), (ri[differ], gi[differ])
    hit = (ri >= 0) & ~differ
    np.testing.assert_allclose(gt[hit], rt[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gu[hit], ru[hit], rtol=0, atol=1e-4)
    np.testing.assert_allclose(gv[hit], rv[hit], rtol=0, atol=1e-4)
    assert (gt[ri < 0] == rt[ri < 0]).all()      # misses keep tmax
    return int(hit.sum())


def _mask(t, kind):
    if kind == "none":
        return None
    m = np.ones(t, bool)
    m[::2 if kind == "even off" else 3] = False
    return m


@pytest.mark.parametrize("kind", ["none", "even off", "thirds off"])
@pytest.mark.parametrize("t", [5, 300, 700])
def test_mt_closest_matches_the_oracle_of_both_packages(t, kind):
    tris, rays, m = _soup(t, t), _rays(512, t + 1), _mask(t, kind)
    got = [a.numpy() for a in mt.mt_closest(*_t(*rays, *tris), *_t(m))]
    ref_t = t_int.intersect_closest(*_t(*rays, *tris), tri_mask=_t(m)[0])
    ref_j = j_int.intersect_closest(*_j(*rays, *tris), tri_mask=_j(m)[0])
    assert _assert_same_hits([a.numpy() for a in ref_t], got) > 0
    _assert_same_hits(ref_j, got)
    if m is not None:
        assert m[got[3][got[3] >= 0]].all()


@pytest.mark.parametrize("kind", ["none", "even off"])
@pytest.mark.parametrize("t", [5, 300])
def test_mt_closest_matches_pallas_interpret(pallas_interpret, t, kind):
    tris, rays, m = _soup(t, t), _rays(1024, t + 2), _mask(t, kind)
    ref = j_pal.pallas_intersect_closest(*_j(*rays, *tris),
                                         tri_mask=_j(m)[0])
    got = [a.numpy() for a in mt.mt_closest(*_t(*rays, *tris), *_t(m))]
    assert _assert_same_hits(ref, got) > 0


@pytest.mark.parametrize("kind", ["none", "even off"])
def test_mt_any_matches_pallas_interpret_and_the_oracles(pallas_interpret,
                                                         kind):
    t = 200
    tris, m = _soup(t, 3), _mask(t, kind)
    org, d, _, _ = _rays(1024, 4)
    rays = (org, d, np.full(1024, 1e-3, F32), np.full(1024, 2.5, F32))
    got = mt.mt_any(*_t(*rays, *tris), *_t(m)).numpy()
    assert got.dtype == np.bool_ and got.any() and not got.all()
    for ref in (j_pal.pallas_intersect_any(*_j(*rays, *tris),
                                           tri_mask=_j(m)[0]),
                j_int.intersect_any(*_j(*rays, *tris), tri_mask=_j(m)[0]),
                t_int.intersect_any(*_t(*rays, *tris),
                                    tri_mask=_t(m)[0]).numpy()):
        # a hit within an ulp of tmin/tmax may fall on either side
        assert (got != np.asarray(ref)).sum() <= 1


def _sweep_tri_by_tri(rays, v0, e1, e2, mask, any_hit):
    """The sweep as the CUDA kernel does it: every triangle in ascending
    order against all rays, float32, the kernel's grouping of every term."""
    org, d, tmin, tmax = rays
    ox, oy, oz = org.T
    dx, dy, dz = d.T
    n = org.shape[0]
    bt, bu, bv = tmax.copy(), np.zeros(n, F32), np.zeros(n, F32)
    bi = np.full(n, -1, np.int32)
    tol = F32(-1.1920928955078125e-07)
    for k in range(v0.shape[0]):
        (ax, ay, az), (bx, by, bz), (cx_, cy_, cz_) = v0[k], e1[k], e2[k]
        nx = by * cz_ - bz * cy_
        ny = bz * cx_ - bx * cz_
        nz = bx * cy_ - by * cx_
        cx, cy, cz = ax - ox, ay - oy, az - oz
        rx = dy * cz - dz * cy
        ry = dz * cx - dx * cz
        rz = dx * cy - dy * cx
        det = nx * dx + ny * dy + nz * dz
        inv = np.where(det == 0, F32(0), F32(1) / np.where(det == 0, F32(1),
                                                           det))
        u = -(rx * cx_ + ry * cy_ + rz * cz_) * inv
        v = (rx * bx + ry * by + rz * bz) * inv
        w = F32(1) - u - v
        tt = (cx * nx + cy * ny + cz * nz) * inv
        ok = ((det != 0) & (u >= tol) & (v >= tol) & (w >= tol)
              & (tt >= tmin) & (tt <= bt))
        if mask is not None:
            ok &= bool(mask[k])
        if any_hit:
            ok &= bi < 0
        bt = np.where(ok, tt, bt)
        bu = np.where(ok, np.maximum(u, F32(0)), bu)
        bv = np.where(ok, np.maximum(v, F32(0)), bv)
        bi = np.where(ok, k, bi).astype(np.int32)
    return bt, bu, bv, bi


@pytest.mark.parametrize("kind", ["none", "thirds off"])
def test_plain_equals_triangle_by_triangle_sweep(kind):
    """More triangles than one chunk of the plain version, and duplicated
    triangles, so that ties inside a chunk and across chunks both occur."""
    v0, e1, e2 = _soup(333, 5)
    tris = [np.concatenate([a, a[:120], a[200:]]) for a in (v0, e1, e2)]
    t = tris[0].shape[0]
    m, rays = _mask(t, kind), _rays(256, 6)
    with np.errstate(all="ignore"):
        ref = _sweep_tri_by_tri(rays, *tris, m, False)
        occ = _sweep_tri_by_tri(rays, *tris, m, True)[3] >= 0
    got = [a.numpy() for a in mt.mt_closest_plain(*_t(*rays, *tris), *_t(m))]
    assert t > mt._CHUNK and (got[3] >= 0).sum() > 20
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        mt.mt_any_plain(*_t(*rays, *tris), *_t(m)).numpy(), occ)


def test_equal_t_goes_to_the_highest_index():
    """The same triangle three times: the sweep reports the last copy, the
    `ops/intersect.py` oracle the first, at the same t to rounding (the
    oracle sums its dot products with a reduction)."""
    v0, e1, e2 = _soup(40, 7)
    tris = [np.concatenate([a, a, a]) for a in (v0, e1, e2)]
    rays = _rays(256, 8)
    got = [a.numpy() for a in mt.mt_closest(*_t(*rays, *tris))]
    ref = [a.numpy() for a in t_int.intersect_closest(*_t(*rays, *tris))]
    hit = got[3] >= 0
    assert hit.sum() > 20 and (got[3][hit] >= 80).all()
    assert (ref[3][hit] < 40).all() and (got[3][hit] - 80 == ref[3][hit]).all()
    np.testing.assert_allclose(got[0][hit], ref[0][hit], rtol=1e-5)
    assert ((got[3] >= 0) == (ref[3] >= 0)).all()


def test_edge_cases():
    """No triangles, no rays, dead rays, axis-aligned rays, scalar tmin."""
    v0, e1, e2 = _t(*_soup(50, 9))
    org, d, tmin, tmax = _t(*_rays(64, 10))
    none = torch.zeros((0, 3))
    out = mt.mt_closest(org, d, tmin, tmax, none, none, none)
    assert (out[3] == -1).all() and torch.equal(out[0], tmax)
    assert not mt.mt_any(org, d, tmin, tmax, none, none, none).any()
    assert mt.mt_closest(none, none, tmin[:0], tmax[:0], v0, e1, e2)[3].shape \
        == (0,)
    tmax[::2] = -1.0
    assert (mt.mt_closest(org, d, tmin, tmax, v0, e1, e2)[3][::2] == -1).all()
    d = torch.zeros_like(d)
    d[:, 1] = 1.0
    a = mt.mt_closest(org, d, 0.0, 1e30, v0, e1, e2)
    b = t_int.intersect_closest(org, d, 0.0, 1e30, v0, e1, e2)
    _assert_same_hits([x.numpy() for x in b], [x.numpy() for x in a])


def test_tables_changed_in_place_are_seen():
    """Nothing is packed or cached between calls."""
    v0, e1, e2 = _t(*_soup(50, 11))
    rays = _t(*_rays(128, 12))
    before = mt.mt_closest(*rays, v0, e1, e2)[3]
    v0 += 100.0                         # in place: the soup moves away
    after = mt.mt_closest(*rays, v0, e1, e2)[3]
    assert (before >= 0).any() and not (after >= 0).any()


def test_mt_cuda_tensor_never_takes_the_plain_version():
    """The wrapper picks the plain version only because the tensor is on the
    CPU; this is the dispatch condition, checked without a card."""
    src = inspect.getsource(mt.mt_closest) + inspect.getsource(mt.mt_any)
    assert "is_cuda" in src and "try" not in src
    assert mt.mt_closest.launches == 0 and mt.mt_any.launches == 0


@pytest.mark.cuda
def test_mt_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no interpret "
                    "mode")
    tris = [a.cuda() for a in _t(*_soup(733, 13))]
    rays = [a.cuda() for a in _t(*_rays(4096, 14))]
    m = torch.from_numpy(_mask(733, "thirds off")).cuda()
    for mask in (None, m):
        got = mt.mt_closest(*rays, *tris, tri_mask=mask)
        ref = mt.mt_closest_plain(*rays, *tris, tri_mask=mask)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert torch.equal(mt.mt_any(*rays, *tris, tri_mask=mask),
                           mt.mt_any_plain(*rays, *tris, tri_mask=mask))
