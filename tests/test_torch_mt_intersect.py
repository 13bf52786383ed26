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
EQUAL, bit for bit.  The kernel's early rejection (`_mt_reject`) against
the full sequence: an implication, no tolerance.  On the float-rule rays of
tests/test_torch_packet_bvh.py (subnormal, infinite and NaN components) prim
ids must be EQUAL.
"""

import functools
import inspect
import pathlib
import re

import hypothesis
import hypothesis.strategies as st
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.ops import intersect as j_int
from ignis_tpu.ops import pallas_intersect as j_pal
from ignis_tpu_torch.ops import intersect as t_int
from ignis_tpu_torch.ops import mt_intersect as mt
from test_torch_packet_bvh import (
    RULE_HITS, RULE_RAYS, RULE_TRI, face_rays, rule_rays, same_bits,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops on these small inputs run faster on one intra-op
    thread, and the test workers sharing the CPU then do not oversubscribe
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    np.testing.assert_array_equal(gt[ri < 0], rt[ri < 0])  # misses keep tmax
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


def _rule_case(case, n_faces=512):
    """Triangles and rays of a float-rule case; "faces": rays on the faces
    of a random soup's triangle boxes."""
    if case != "faces":
        return RULE_TRI, rule_rays(case)
    tris = _soup(300, 25)
    v = np.stack([tris[0], tris[0] + tris[1], tris[0] + tris[2]])
    boxes = np.concatenate([v.min(0), v.max(0)], 1)
    return tris, face_rays(boxes, n_faces, 26)


@pytest.mark.parametrize("case", sorted(RULE_RAYS) + ["faces"])
def test_mt_float_rules_match_pallas_interpret(pallas_interpret, case):
    """Subnormal, infinite and NaN components: the JAX package's results
    (the subnormal case failed before the port took its float rules: a
    subnormal determinant is 0 for the reference)."""
    tris, rays = _rule_case(case)
    ref = j_pal.pallas_intersect_closest(*_j(*rays, *tris))
    got = [a.numpy() for a in mt.mt_closest(*_t(*rays, *tris))]
    if case in RULE_HITS:
        assert got[3].tolist() == RULE_HITS[case]
    np.testing.assert_array_equal(got[3], np.asarray(ref[3]))
    _assert_same_hits(ref, got)
    occ = mt.mt_any(*_t(*rays, *tris)).numpy()
    np.testing.assert_array_equal(
        occ, np.asarray(j_pal.pallas_intersect_any(*_j(*rays, *tris))))


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


# ---- the kernel's early rejection and its 64-bit key, mirrored on the CPU

def _aimed_rays(v0, e1, e2, seed):
    """Rays through edge points, vertices and near misses of every triangle:
    the pairs the rejection's margin has to let through."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0, 1, (v0.shape[0], 1)).astype(F32)
    eps = F32(1e-6)
    ab = [(s, 0 * s), (0 * s, s), (s, 1 - s), (0 * s, 0 * s), (1 + 0 * s, 0 * s),
          (0 * s, 1 + 0 * s), (s, -eps + 0 * s), (-eps + 0 * s, s),
          (s, 1 - s + eps)]
    org, d = [], []
    for a, b in ab:
        p = v0 + a * e1 + b * e2
        o = rng.uniform(-3, 3, p.shape).astype(F32)
        org.append(o)
        d.append(p - o)
    return np.concatenate(org), np.concatenate(d)


def _reject_case(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    v0, e1, e2 = _soup(96, 21)
    org, d, _, _ = _rays(384, 22)
    if kind == "edges and vertices":
        org, d = _aimed_rays(v0, e1, e2, 23)
    elif kind == "degenerate triangles":
        e2 = e1 * rng.choice([0.0, 1.0, -2.0, 1.0 + 2.0 ** -20],
                             (96, 1)).astype(F32)
    elif kind == "det zero":
        # rays inside each triangle's plane: d = a e1 + b e2
        org = np.repeat(v0, 4, axis=0) + F32(0.25)
        d = np.repeat(e1 + F32(0.5) * e2, 4, axis=0)
    elif kind in ("1e-20", "1e+18", "1e-9", "1e+9"):
        k = F32(float(kind))
        v0, e1, e2, org = v0 * k, e1 * k, e2 * k, org * k
    elif kind == "mixed scales":
        k = (10.0 ** rng.integers(-20, 19, (96, 1))).astype(F32)
        v0, e1, e2 = v0 * k, e1 * k, e2 * k
        org = org * (10.0 ** rng.integers(-20, 19, (384, 1))).astype(F32)
    elif kind == "nan and inf":
        for a in (v0, e1, e2, org, d):
            flat = a.reshape(-1)
            idx = rng.choice(flat.size, flat.size // 10, replace=False)
            flat[idx] = rng.choice([np.nan, np.inf, -np.inf, 0.0, -0.0,
                                    3.4e38, 1e-45], idx.size).astype(F32)
    return org, d, v0, e1, e2


@pytest.mark.parametrize("kind", [
    "random", "edges and vertices", "degenerate triangles", "det zero",
    "1e-20", "1e-9", "1e+9", "1e+18", "mixed scales", "nan and inf"])
def test_rejected_pairs_are_never_inside(kind):
    """`_mt_reject` is the kernel's early rejection, operation by operation:
    whatever it rejects must fail u, v, w >= tol of the full sequence, or
    the kernel would lose a hit the plain version finds."""
    org, d, v0, e1, e2 = _t(*_reject_case(kind))
    rej = mt._mt_reject(org, d, v0, e1, e2)
    inside = mt._mt_chunk(org, d, v0, e1, e2)[3]
    assert rej.shape == inside.shape == (org.shape[0], v0.shape[0])
    assert not (rej & inside).any()
    if kind == "random":
        # and it is worth having: nearly every miss is rejected early
        assert inside.any() and rej[~inside].float().mean() > 0.98
    if kind == "edges and vertices":
        assert inside.sum() >= 3 * v0.shape[0]
    if kind == "nan and inf":
        t, u, v, _ = mt._mt_chunk(org, d, v0, e1, e2)
        assert not rej[torch.isnan(u) & torch.isnan(v)].any()


@hypothesis.settings(max_examples=60, deadline=None)
@hypothesis.given(
    seed=st.integers(0, 2 ** 31 - 1),
    tri_exp=st.integers(-38, 37), org_exp=st.integers(-38, 37),
    dir_exp=st.integers(-20, 20), aimed=st.booleans())
def test_rejected_pairs_are_never_inside_at_any_scale(seed, tri_exp, org_exp,
                                                      dir_exp, aimed):
    rng = np.random.default_rng(seed)
    k = F32(10.0) ** F32(tri_exp)
    v0, e1, e2 = (a * k for a in _soup(24, seed))
    if aimed:
        org, d = _aimed_rays(v0, e1, e2, seed + 1)
    else:
        org = rng.uniform(-3, 3, (64, 3)).astype(F32) * F32(10.0) ** F32(org_exp)
        d = rng.normal(0, 1, (64, 3)).astype(F32)
    d = d * F32(10.0) ** F32(dir_exp)
    with np.errstate(all="ignore"):
        org, d, v0, e1, e2 = _t(org, d, v0, e1, e2)
    rej = mt._mt_reject(org, d, v0, e1, e2)
    assert not (rej & mt._mt_chunk(org, d, v0, e1, e2)[3]).any()


def test_sweep_that_skips_rejected_pairs_equals_the_plain_sweep():
    """The kernel's loop in numpy terms: a pair the rejection skips is never
    looked at again, and the result is the plain version's, bit for bit."""
    v0, e1, e2 = _soup(333, 31)
    tris = [np.concatenate([a, a[:100]]) for a in (v0, e1, e2)]
    rays = _rays(256, 32)
    tt = _t(*rays, *tris)
    t, u, v, inside = mt._mt_chunk(tt[0], tt[1], *tt[4:])
    keep = inside & ~mt._mt_reject(tt[0], tt[1], *tt[4:])
    ok = keep & (t >= tt[2][:, None]) & (t <= tt[3][:, None])
    tm = torch.where(ok, t, torch.full_like(t, float("inf")))
    best = tm.amin(dim=1)
    idx = torch.arange(t.shape[1])[None, :]
    j = torch.where(ok & (tm == best[:, None]), idx, -1).amax(dim=1)
    ref = mt.mt_closest_plain(*tt)
    assert (ref[3] >= 0).sum() > 20
    assert torch.equal(j.to(torch.int32), ref[3])
    assert torch.equal(best[j >= 0], ref[0][j >= 0])


_KEY_T = np.array([-np.inf, -3.4028234663852886e38, -1.5, -1e-45, -0.0, 0.0,
                   1e-45, 1.1754944e-38, 1.0, 1.0000001, 3.4028234663852886e38,
                   np.inf], F32)


def test_key_order_is_t_ascending_then_index_descending():
    """Among the keys of all (t, index) pairs the smallest is the hit the
    sequential `t <= best` sweep leaves: least t, and the highest index among
    equal t, where -0.0 and +0.0 are equal."""
    idx = np.array([0, 1, 2, 31, 32, 32001, 2 ** 31 - 1])
    t, i = (a.reshape(-1) for a in np.meshgrid(_KEY_T, idx, indexing="ij"))
    keys = mt._mt_key(t, i)
    assert keys.dtype == np.uint64 and (keys < np.uint64(2 ** 64 - 1)).all()
    by_key = np.argsort(keys, kind="stable")
    by_hit = sorted(range(t.size), key=lambda k: (float(t[k]), -int(i[k])))
    # equal keys only where (t, index) are equal as the sweep sees them
    assert [(float(t[k]), int(i[k])) for k in by_key] == \
        [(float(t[k]), int(i[k])) for k in by_hit]
    assert (np.diff(keys[by_key].astype(object)) >= 0).all()
    zeros = keys[(t == 0)]
    assert len(set(zeros.tolist())) == idx.size      # -0.0 and +0.0 share keys


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_key_minimum_is_what_the_sequential_sweep_leaves(seed):
    rng = np.random.default_rng(seed)
    t = rng.choice(_KEY_T[1:-1], 64)
    best, bi = F32(np.inf), -1
    for k in range(64):                 # ascending, accept t <= best
        if t[k] <= best:
            best, bi = t[k], k
    win = int(np.argmin(mt._mt_key(t, np.arange(64))))
    assert win == bi and t[win] == best


def _kernel_shape():
    """(rays a block, triangles a tile, blocks a multiprocessor) as the
    kernel's source has them."""
    src = (pathlib.Path(inspect.getfile(mt)).parents[1] / "csrc"
           / "mt_intersect.cu").read_text()
    k = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
         for name in ("kThreads", "kRays", "kTile", "kBlocksPerSm")}
    # and the launch sizes its ranges by the rule `_tiles_per_range` mirrors
    assert "(kBlocksPerSm * sms + ray_blocks - 1) / ray_blocks" in src
    return k["kThreads"] * k["kRays"], k["kTile"], k["kBlocksPerSm"]


@pytest.mark.parametrize("n,ntris", [(1, 1), (100, 255), (4096, 733),
                                     (4096, 32002), (65536, 32002),
                                     (65553, 733), (10 ** 6, 5), (7, 10 ** 6)])
def test_ranges_cover_the_soup_and_fill_the_card(n, ntris):
    sms = 132
    rays_per_block, tile, per_sm = _kernel_shape()
    per = mt._tiles_per_range(n, ntris, sms, rays_per_block, tile, per_sm)
    tiles = -(-ntris // tile)
    ranges = -(-tiles // per)
    ray_blocks = -(-n // rays_per_block)
    assert per >= 1 and ranges * per >= tiles > (ranges - 1) * per
    assert ranges <= 65535
    # enough blocks for every multiprocessor, or every tile its own range
    assert ray_blocks * ranges >= per_sm * sms / 2 or per == 1


@pytest.mark.cuda
def test_mt_float_rules_kernel_matches_plain_on_the_card():
    """The float-rule rays and rays on a soup's triangle boxes with special
    components: the kernel's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no interpret "
                    "mode")
    for tris, rays in (_rule_case(None), _rule_case("faces", 8192)):
        args = [a.cuda() for a in _t(*rays, *tris)]
        got = mt.mt_closest(*args)
        ref = mt.mt_closest_plain(*args)
        assert all(same_bits(a, b) for a, b in zip(got, ref))
        assert torch.equal(mt.mt_any(*args), mt.mt_any_plain(*args))


@pytest.mark.cuda
def test_mt_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no interpret "
                    "mode")

    def same(rays, tris, mask):
        got = mt.mt_closest(*rays, *tris, tri_mask=mask)
        ref = mt.mt_closest_plain(*rays, *tris, tri_mask=mask)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert torch.equal(mt.mt_any(*rays, *tris, tri_mask=mask),
                           mt.mt_any_plain(*rays, *tris, tri_mask=mask))
        return got

    for n in (1, 100, 4096, 65536 + 17):
        rays = [a.cuda() for a in _t(*_rays(n, 14 + n))]
        for t in (1, 255, 256, 257, 733):
            tris = [a.cuda() for a in _t(*_soup(t, 13 + t))]
            for kind in ("none", "even off", "thirds off"):
                m = _mask(t, kind)
                same(rays, tris, None if m is None
                     else torch.from_numpy(m).cuda())
        # every triangle twice, 733 apart: with 128-triangle tiles the copies
        # lie in different ranges, and the later copy has to win
        twice = [torch.cat([a, a]) for a in tris]
        rays_per_block, tile, per_sm = _kernel_shape()
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        per = mt._tiles_per_range(n, 1466, sms, rays_per_block, tile, per_sm)
        assert 733 >= per * tile or n == 1
        got = same(rays, twice, None)
        assert ((got[3] < 0) | (got[3] >= 733)).all()
    # a negative tmin, bounded segments, -0.0 and FLT_MAX
    rays = [a.cuda() for a in _t(*_rays(4096, 15))]
    for tmin, tmax in ((-5.0, 2.5), (-0.0, 3.4028234663852886e38)):
        rays[2].fill_(tmin)
        rays[3].fill_(tmax)
        same(rays, tris, None)
    # nothing to sweep: misses, and nothing is launched
    before = mt.mt_closest.launches, mt.mt_any.launches
    none = torch.zeros((0, 3)).cuda()
    out = mt.mt_closest(*rays, none, none, none)
    assert (out[3] == -1).all() and torch.equal(out[0], rays[3])
    assert not mt.mt_any(*rays, none, none, none).any()
    assert mt.mt_closest(none, none, rays[2][:0], rays[3][:0],
                         *tris)[3].shape == (0,)
    assert (mt.mt_closest.launches, mt.mt_any.launches) == before
