"""The port's 8-wide BVH traversal (plain PyTorch version, the one the CPU
wrapper runs) against the JAX package's Pallas kernel in interpret mode and
against the port's own Moeller-Trumbore oracle; mirrors
tests/test_pallas_bvh.py.

Tolerances: prim ids equal except at exact ties (two triangles with bit-equal
t: the per-ray walk and the reference's shared-stack walk test in another
order, and the last tested wins); t to 1e-5 relative, u and v to 1e-4, because
XLA on the CPU contracts multiply-adds and sums in another order than eager
torch.

The float-rule rays (`RULE_RAYS`, also used by the other kernels' test files)
have subnormal, infinite or NaN components: XLA on the CPU flushes subnormals
to zero and keeps NaN in its minima, and the port follows it
(`ops.ref_float`); on them prim ids must be EQUAL.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.ops.bvh import build_bvh as j_build_bvh
from ignis_tpu.ops.pallas_bvh import build_packet_bvh as j_build_packet_bvh
from ignis_tpu.ops.pallas_bvh import packet_bvh_any as j_any
from ignis_tpu.ops.pallas_bvh import packet_bvh_closest as j_closest
from ignis_tpu_torch.convert import tables_from_numpy
from ignis_tpu_torch.ops import packet_bvh as tpb
from ignis_tpu_torch.ops.bvh import build_bvh
from ignis_tpu_torch.ops.intersect import intersect_any, intersect_closest


def _random_soup(n_tris, seed=0, spread=4.0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    v0 = c + rng.normal(0, 0.3, (n_tris, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.5, (n_tris, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.5, (n_tris, 3)).astype(np.float32)
    return v0, e1, e2


def _random_rays(n, seed=1, spread=6.0):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


F32 = np.float32
_INF, _NAN = np.inf, np.nan
# The triangle of the float-rule cases, in the plane z = 1: its box is flat in
# z and has the face x = 0.
RULE_TRI = tuple(np.array([v], F32) for v in ((0, -1, 1), (0, 2, 0),
                                              (1, 1, 0)))
RULE_RAYS = {
    # on the face x = 0 with a subnormal x direction (the reference hits at
    # t = 1, the port used to miss); the same off the face; two subnormal
    # components; a ray in the plane whose determinant is subnormal (the
    # reference misses, the port's sweep used to hit)
    "subnormal": ([[0, 0, 0], [0.25, 0, 0], [0, 0, 0], [0.25, 0, 1]],
                  [[1e-40, 0, 1], [1e-40, 0, 1], [-1e-40, 1e-40, 1],
                   [0, 1, -2.5e-39]]),
    "infinite": ([[0.25, 0, 0], [0, 0, 0], [0.25, 0, 0], [_INF, 0, 0],
                  [0.25, 0, -_INF]],
                 [[_INF, 0, 1], [0, -_INF, 1], [0, 0, _INF], [1e-40, 0, 1],
                  [0, 0, 1]]),
    # NaN in a direction, an origin, a tmin and a tmax
    "nan": ([[0.25, 0, 0], [0.25, 0, 0], [_NAN, 0, 0], [0.25, 0, 0],
             [0.25, 0, 0]],
            [[_NAN, 0, 1], [0, _NAN, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1]]),
}
RULE_HITS = {"subnormal": [0, 0, 0, -1], "infinite": [-1] * 5,
             "nan": [-1] * 5}


def rule_rays(case=None):
    """(org, d, tmin, tmax) of one float-rule case, or of all of them."""
    if case is None:
        parts = [rule_rays(c) for c in sorted(RULE_RAYS)]
        return tuple(np.concatenate(a) for a in zip(*parts))
    org, d = (np.array(a, F32) for a in RULE_RAYS[case])
    n = org.shape[0]
    tmin, tmax = np.zeros(n, F32), np.full(n, 1e30, F32)
    if case == "nan":
        tmin[3], tmax[4] = _NAN, _NAN
    return org, d, tmin, tmax


_SPECIAL = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40,
                     1e-45, 3e-39, 1e-30, -0.6, 0.7], F32)


def face_rays(boxes, n, seed):
    """Rays for the float rules over many boxes ((B, 6) lo | hi): origins on
    a box face on every axis (box - o = 0), some moved off it; directions
    random, a component in three drawn from NaN, +-inf, +-0 and subnormals.
    tmin 1e-3 (a few NaN: an origin may be a vertex, where a hit at t = 0 is
    a matter of rounding), tmax 1e30 (a few finite, a few NaN)."""
    rng = np.random.default_rng(seed)
    b = boxes[rng.integers(0, boxes.shape[0], n)]
    org = np.where(rng.random((n, 3)) < 0.5, b[:, 0:3], b[:, 3:6])
    org = np.where(rng.random((n, 3)) < 0.1, org + rng.normal(0, 1, (n, 3)),
                   org).astype(F32)
    org[rng.random((n, 3)) < 0.01] = np.nan
    d = rng.normal(0, 1, (n, 3))
    d = np.where(rng.random((n, 3)) < 0.35,
                 _SPECIAL[rng.integers(0, len(_SPECIAL), (n, 3))],
                 d).astype(F32)
    tmin = np.where(rng.random(n) < 0.02, F32(np.nan), F32(1e-3)).astype(F32)
    tmax = np.where(rng.random(n) < 0.1, rng.uniform(0.5, 4, n),
                    1e30).astype(F32)
    tmax[rng.random(n) < 0.02] = np.nan
    return org, d, tmin, tmax


def same_bits(a, b):
    """Equal to the bit (NaN outputs included), for float and int tensors."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _tables(v0, e1, e2, flags=None):
    """The port's packet tables with the kernel's copy of the rows."""
    if flags is None:
        flags = np.full(v0.shape[0], 0xF, np.uint8)
    tab = tpb.build_packet_bvh(build_bvh(v0, e1, e2), v0, e1, e2, flags)
    tab["pb_nodes"] = tpb.build_pb_nodes(tab["pb_rows"])
    return tab


def _tt(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _same_hits(ref, got, t_rtol=1e-5):
    rt, ru, rv, ri = [np.asarray(a) for a in ref]
    gt, gu, gv, gi = [np.asarray(a) for a in got]
    differ = ri != gi
    tie = differ & (ri >= 0) & (gi >= 0) & (rt == gt)
    assert not (differ & ~tie).any(), (ri[differ], gi[differ])
    hit = (ri >= 0) & ~differ
    np.testing.assert_allclose(gt[hit], rt[hit], rtol=t_rtol, atol=1e-6)
    np.testing.assert_allclose(gu[hit], ru[hit], rtol=0, atol=1e-4)
    np.testing.assert_allclose(gv[hit], rv[hit], rtol=0, atol=1e-4)
    return int(hit.sum())


@pytest.mark.parametrize("n_tris", [1, 3, 37, 500, 4096])
def test_bvh_and_packet_tables_equal(n_tris):
    v0, e1, e2 = _random_soup(n_tris, seed=n_tris)
    a, b = j_build_bvh(v0, e1, e2), build_bvh(v0, e1, e2)
    for f in ("node_min", "node_max", "node_left", "node_right",
              "node_count", "tri_order"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    flags = np.random.default_rng(1).integers(0, 16, n_tris).astype(np.uint8)
    ja = j_build_packet_bvh(a, v0, e1, e2, flags)
    tb = tpb.build_packet_bvh(b, v0, e1, e2, flags)
    assert ja.keys() == tb.keys()
    for k in ja:
        np.testing.assert_array_equal(np.asarray(ja[k]), np.asarray(tb[k]), k)
    assert tpb.stack_entries(int(tb["pb_depth"])) <= 128


@pytest.mark.parametrize("n_tris,n_rays", [(3, 64), (37, 256), (500, 1500),
                                           (4096, 1024)])
def test_closest_matches_pallas_interpret_and_oracle(n_tris, n_rays):
    v0, e1, e2 = _random_soup(n_tris, seed=n_tris)
    org, d = _random_rays(n_rays, seed=n_rays)
    tmin = np.zeros(n_rays, np.float32)
    tmax = np.full(n_rays, 1e30, np.float32)
    tab = _tables(v0, e1, e2)
    ref = j_closest({k: jnp.asarray(v) for k, v in tab.items()},
                    jnp.asarray(org), jnp.asarray(d), jnp.asarray(tmin),
                    jnp.asarray(tmax), interpret=True)
    got = tpb.packet_bvh_closest(tables_from_numpy(tab, "cpu"),
                                 *_tt(org, d, tmin, tmax))
    nhit = _same_hits(ref, got)
    oracle = intersect_closest(*_tt(org, d, tmin, tmax, v0, e1, e2))
    assert _same_hits(oracle, got) == nhit
    assert nhit > 0 or n_tris <= 3


def test_any_hit_matches_pallas_interpret_and_oracle():
    v0, e1, e2 = _random_soup(200, seed=9)
    org, d = _random_rays(700, seed=10)
    n = org.shape[0]
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 3.0, np.float32)   # finite segments: some blocked
    tab = _tables(v0, e1, e2)
    ref = np.asarray(j_any({k: jnp.asarray(v) for k, v in tab.items()},
                           jnp.asarray(org), jnp.asarray(d),
                           jnp.asarray(tmin), jnp.asarray(tmax),
                           mask_bit=tpb.MASK_SHADOW, interpret=True))
    got = tpb.packet_bvh_any(tables_from_numpy(tab, "cpu"),
                             *_tt(org, d, tmin, tmax)).numpy()
    oracle = intersect_any(*_tt(org, d, tmin, tmax, v0, e1, e2)).numpy()
    # a hit within an ulp of tmax may fall on either side of the window
    assert (got != ref).sum() <= 1
    assert (got != oracle).sum() <= 1
    assert got.any() and not got.all()


def test_visibility_mask_respected():
    # triangle 0 visible to shadow rays only, triangle 1 to camera only
    v0 = np.float32([[-5, -5, 1], [-5, -5, 2]])
    e1 = np.float32([[10, 0, 0], [10, 0, 0]])
    e2 = np.float32([[0, 10, 0], [0, 10, 0]])
    tab = tables_from_numpy(
        _tables(v0, e1, e2, np.array([0x8, 0x1], np.uint8)), "cpu")
    org, d = _tt(np.float32([[0, 0, 0]]), np.float32([[0, 0, 1]]))
    tmin, tmax = torch.zeros(1), torch.full((1,), 1e30)
    t_cam, _, _, p_cam = tpb.packet_bvh_closest(tab, org, d, tmin, tmax,
                                                mask_bit=tpb.MASK_CAMERA)
    assert int(p_cam[0]) == 1 and abs(float(t_cam[0]) - 2.0) < 1e-6
    t_sh, _, _, p_sh = tpb.packet_bvh_closest(tab, org, d, tmin, tmax,
                                              mask_bit=tpb.MASK_SHADOW)
    assert int(p_sh[0]) == 0 and abs(float(t_sh[0]) - 1.0) < 1e-6
    assert not bool(tpb.packet_bvh_any(tab, org, d, tmin, tmax,
                                       mask_bit=tpb.MASK_BOUNCE)[0])


@pytest.mark.parametrize("mask_bit", [tpb.MASK_CAMERA, tpb.MASK_BOUNCE,
                                      tpb.MASK_SHADOW])
def test_random_flags_match_masked_oracle(mask_bit):
    n_tris, n_rays = 800, 1024
    v0, e1, e2 = _random_soup(n_tris, seed=5)
    flags = np.random.default_rng(6).integers(0, 16, n_tris).astype(np.uint8)
    org, d = _random_rays(n_rays, seed=7)
    tmin = np.full(n_rays, 1e-3, np.float32)
    tmax = np.full(n_rays, 1e30, np.float32)
    tab = tables_from_numpy(_tables(v0, e1, e2, flags), "cpu")
    got = tpb.packet_bvh_closest(tab, *_tt(org, d, tmin, tmax),
                                 mask_bit=mask_bit)
    oracle = intersect_closest(*_tt(org, d, tmin, tmax, v0, e1, e2),
                               tri_mask=torch.from_numpy((flags & mask_bit) != 0))
    assert _same_hits(oracle, got) > 0


def test_dead_lanes_and_axis_rays():
    v0, e1, e2 = _random_soup(300, seed=12)
    n = 300
    org, _ = _random_rays(n, seed=13)
    d = np.zeros((n, 3), np.float32)
    d[np.arange(n), np.arange(n) % 3] = np.where(np.arange(n) % 2, 1.0, -1.0)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1e30, np.float32)
    tmax[::4] = -1.0
    tab = _tables(v0, e1, e2)
    ref = j_closest({k: jnp.asarray(v) for k, v in tab.items()},
                    jnp.asarray(org), jnp.asarray(d), jnp.asarray(tmin),
                    jnp.asarray(tmax), interpret=True)
    got = tpb.packet_bvh_closest(tables_from_numpy(tab, "cpu"),
                                 *_tt(org, d, tmin, tmax))
    _same_hits(ref, got)
    assert (got[3][::4] == -1).all()
