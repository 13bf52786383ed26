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


def _inner_boxes(rows):
    """(B, 6) lo | hi of every child box of the inner rows."""
    inner = rows[rows[:, tpb.TYPE_LANE] == 0]
    return inner[:, :48].reshape(-1, 6)


def _rule_case(case, n_faces=512):
    """(v0, e1, e2), rays of a float-rule case; "faces": rays on the child
    boxes' faces of a random soup."""
    if case != "faces":
        return RULE_TRI, rule_rays(case)      # None: every case
    geo = _random_soup(300, seed=21)
    return geo, face_rays(_inner_boxes(_tables(*geo)["pb_rows"]), n_faces, 22)


@pytest.mark.parametrize("case", sorted(RULE_RAYS) + ["faces"])
def test_float_rules_match_pallas_interpret(case):
    """Subnormal, infinite and NaN components: the JAX package's results
    (the subnormal case failed before the port took its float rules)."""
    geo, rays = _rule_case(case)
    tab = _tables(*geo)
    jtab = {k: jnp.asarray(v) for k, v in tab.items()}
    ref = j_closest(jtab, *(jnp.asarray(a) for a in rays), interpret=True)
    got = tpb.packet_bvh_closest(tables_from_numpy(tab, "cpu"), *_tt(*rays))
    if case in RULE_HITS:
        assert np.asarray(got[3]).tolist() == RULE_HITS[case]
    np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(ref[3]))
    _same_hits(ref, got)
    occ_ref = np.asarray(j_any(jtab, *(jnp.asarray(a) for a in rays),
                               mask_bit=tpb.MASK_SHADOW, interpret=True))
    occ = tpb.packet_bvh_any(tables_from_numpy(tab, "cpu"), *_tt(*rays))
    np.testing.assert_array_equal(occ.numpy(), occ_ref)


def _decode_nodes(nodes, rows):
    """Walk `pb_nodes` from its root and check every float against the row
    it came from; returns the number of inner records and leaf records."""
    units = np.asarray(nodes, F32)
    codes = units.view(np.int32)
    seen_inner, seen_leaf = 0, 0
    todo = [(0, 0)]                               # (code, row id)
    while todo:
        code, rid = todo.pop()
        row = rows[rid]
        if code >= 0:
            assert row[tpb.TYPE_LANE] == 0
            seen_inner += 1
            for c in range(tpb.WIDTH):
                a, b = units[code + c], units[code + tpb.WIDTH + c]
                box = np.concatenate([a, b[:2]])
                np.testing.assert_array_equal(box.view(np.int32),
                                              row[6 * c:6 * c + 6].view(
                                                  np.int32))
                assert b[3] == 0
                ev = row[64 + c]
                child = int(codes[code + tpb.WIDTH + c, 2])
                if ev <= tpb.MISSING_F * 0.5:
                    assert child == tpb.NODE_MISSING
                    continue
                kept = rows[int(ev)][9:16 * tpb.WIDTH:16] != 0
                if rows[int(ev), tpb.TYPE_LANE] > 0.5 and not kept.any():
                    assert child == tpb.NODE_MISSING    # nothing to hit
                    continue
                todo.append((child, int(ev)))
            continue
        seen_leaf += 1
        assert row[tpb.TYPE_LANE] == 1
        cnt, ptr = ((code >> 28) & 7) + 1, code & 0x0FFFFFFF
        recs = row.reshape(tpb.WIDTH, 16)
        recs = recs[recs[:, 9] != 0]
        assert recs.shape[0] == cnt
        got = units[ptr:ptr + 3 * cnt].reshape(3, cnt, 4).transpose(1, 0, 2)
        np.testing.assert_array_equal(got.reshape(cnt, 12).view(np.int32),
                                      recs[:, :12].view(np.int32))
    return seen_inner, seen_leaf


@pytest.mark.parametrize("n_tris", [1, 37, 500, 4096])
def test_pb_nodes_hold_the_rows_floats(n_tris):
    """`pb_nodes` holds exactly `pb_rows`' floats, reached through the entry
    codes; built from the JAX package's rows it is the same table."""
    v0, e1, e2 = _random_soup(n_tris, seed=n_tris + 7)
    flags = np.random.default_rng(n_tris).integers(0, 16, n_tris)
    flags[::5] = 0                 # records no ray can hit are left out
    tab = _tables(v0, e1, e2, flags.astype(np.uint8))
    rows, nodes = tab["pb_rows"], tab["pb_nodes"]
    assert nodes.dtype == np.float32 and nodes.shape[1] == 4
    n_inner, n_leaf = _decode_nodes(nodes, rows)
    assert n_inner == int((rows[:, tpb.TYPE_LANE] == 0).sum())
    kept = rows[rows[:, tpb.TYPE_LANE] == 1][:, 9:16 * tpb.WIDTH:16] != 0
    assert nodes.shape[0] == 16 * n_inner + 3 * kept.sum()
    assert n_leaf == int(kept.any(1).sum())
    ja = j_build_packet_bvh(j_build_bvh(v0, e1, e2), v0, e1, e2,
                            flags.astype(np.uint8))
    np.testing.assert_array_equal(
        tpb.build_pb_nodes(np.asarray(ja["pb_rows"])).view(np.int32),
        nodes.view(np.int32))


def _walk_ray_by_ray(nodes, rays, mask_bit, any_hit):
    """The traversal as the CUDA kernel does it, over `pb_nodes`: one ray at
    a time, scalar float32 arithmetic in the kernel's order and grouping,
    the passing children pushed far to near (closest) or in slot order
    (any), each leaf's records tested one after the other."""
    units = np.asarray(nodes, F32)
    codes = units.view(np.int32)
    tol, one, zero = F32(-1.1920928955078125e-07), F32(1), F32(0)
    tiny = np.finfo(F32).tiny
    nmin, nmax = np.minimum, np.maximum             # keep NaN, as the kernel

    def inv(x):
        return F32(1e30) if abs(x) < tiny else one / x

    out = []
    for o, d, tmn, bt in zip(*rays):
        i3 = [inv(x) for x in d]
        bu = bv = zero
        bi = -1
        stack, done = [0], False
        while stack and not done:
            code = stack.pop()
            if code >= 0:
                passing = []
                for c in range(tpb.WIDTH):
                    a, b = units[code + c], units[code + tpb.WIDTH + c]
                    lo, hi = (a[0], a[1], a[2]), (a[3], b[0], b[1])
                    t0 = [(lo[k] - o[k]) * i3[k] for k in range(3)]
                    t1 = [(hi[k] - o[k]) * i3[k] for k in range(3)]
                    near = nmax(nmax(nmin(t0[0], t1[0]), nmin(t0[1], t1[1])),
                                nmax(nmin(t0[2], t1[2]), tmn))
                    far = nmin(nmin(nmax(t0[0], t1[0]), nmax(t0[1], t1[1])),
                               nmin(nmax(t0[2], t1[2]), bt))
                    child = int(codes[code + tpb.WIDTH + c, 2])
                    if near <= far and child != tpb.NODE_MISSING:
                        passing.append((near, c, child))
                if not any_hit:                       # nearest on top
                    passing.sort(key=lambda e: (e[0], e[1]), reverse=True)
                stack += [e[2] for e in passing]
                continue
            cnt, ptr = ((code >> 28) & 7) + 1, code & 0x0FFFFFFF
            for k in range(cnt):
                a, b, c = (units[ptr + q * cnt + k] for q in range(3))
                v0, e1, e2 = a[0:3], (a[3], b[0], b[1]), (b[2], b[3], c[0])
                nx = e1[1] * e2[2] - e1[2] * e2[1]
                ny = e1[2] * e2[0] - e1[0] * e2[2]
                nz = e1[0] * e2[1] - e1[1] * e2[0]
                cx, cy, cz = v0[0] - o[0], v0[1] - o[1], v0[2] - o[2]
                rx = d[1] * cz - d[2] * cy
                ry = d[2] * cx - d[0] * cz
                rz = d[0] * cy - d[1] * cx
                det = nx * d[0] + ny * d[1] + nz * d[2]
                dzr = abs(det) < tiny
                inv_det = zero if dzr else one / det
                u = -(rx * e2[0] + ry * e2[1] + rz * e2[2]) * inv_det
                v = (rx * e1[0] + ry * e1[1] + rz * e1[2]) * inv_det
                w = one - u - v
                tt = (cx * nx + cy * ny + cz * nz) * inv_det
                if (int(c[1]) & mask_bit and not dzr and u >= tol
                        and v >= tol and w >= tol and tmn <= tt <= bt):
                    bt, bi = tt, int(c[2])
                    bu, bv = max(u, zero), max(v, zero)
                    if any_hit:
                        done = True
                        break
        out.append((bt, bu, bv, bi))
    return [np.array(col) for col in zip(*out)]


def _tie_soup(seed):
    """A random soup in which triangle 0 has 11 exact copies (more than a
    leaf holds, so they fall into several leaves) and ten others one copy
    each; and rays aimed at the copies as well as random ones."""
    v0, e1, e2 = _random_soup(600, seed=seed, spread=2.0)
    for k in range(1, 12):
        v0[100 + 40 * k], e1[100 + 40 * k], e2[100 + 40 * k] = v0[0], e1[0], \
            e2[0]
    for k in range(10):
        a, b = 3 + k, 590 - k
        v0[b], e1[b], e2[b] = v0[a], e1[a], e2[a]
    rng = np.random.default_rng(seed + 1)
    org, d = _random_rays(384, seed=seed + 2, spread=5.0)
    aim = v0[0] + 0.3 * e1[0] + 0.3 * e2[0]
    d[::3] = aim - org[::3]
    d[1::3] = (v0[3:13] + 0.25 * (e1[3:13] + e2[3:13]))[
        rng.integers(0, 10, d[1::3].shape[0])] - org[1::3]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (v0, e1, e2), (org, d.astype(F32), np.full(384, 1e-3, F32))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("seed", [31, 32])
def test_plain_equals_ray_by_ray_walk(seed, any_hit):
    """The plain version visits what the kernel visits, in its order: equal
    to a scalar walk over `pb_nodes` written like the kernel, bit for bit,
    with exact-t ties between copies of a triangle (the last tested wins)."""
    geo, (org, d, tmin) = _tie_soup(seed)
    tab = _tables(*geo)
    tmax = np.full(org.shape[0], 3.0 if any_hit else 1e30, F32)
    rays = (org, d, tmin, tmax)
    with np.errstate(all="ignore"):
        ref = _walk_ray_by_ray(tab["pb_nodes"], rays, tpb.MASK_BOUNCE,
                               any_hit)
    got = [a.numpy() for a in tpb._traverse_plain(
        tables_from_numpy(tab, "cpu"), *_tt(*rays), tpb.MASK_BOUNCE,
        any_hit)]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b.astype(a.dtype))
    hit = got[3] >= 0
    assert hit.sum() > 100
    if not any_hit:                 # exact ties were decided
        assert np.isin(got[3][hit], [100 + 40 * k for k in range(1, 12)]
                       + [0]).sum() > 5


def test_work_counters_of_the_plain_version():
    v0, e1, e2 = _random_soup(500, seed=2)
    org, d = _random_rays(256, seed=3)
    tab = tables_from_numpy(_tables(v0, e1, e2), "cpu")
    work = {}
    tpb.packet_bvh_closest_plain(tab, *_tt(org, d, np.zeros(256, np.float32),
                                           np.full(256, 1e30, np.float32)),
                                 work=work)
    assert work["inner_visits"] >= 256          # every ray reads the root
    assert 0 < work["rows_touched"] <= tab["pb_rows"].shape[0]
    assert work["leaf_visits"] > 0


def test_launch_raises_on_a_deep_tree_or_missing_nodes(monkeypatch):
    """The wrapper checks the stack bound and the kernel's table before any
    launch (a stand-in library that fails if it is launched)."""
    from ignis_tpu_torch import native

    class Lib:
        def ignis_packet_bvh_stack_entries(self):
            return 128

        def ignis_packet_bvh(self, *args):
            raise AssertionError("launched")

    monkeypatch.setattr(native, "library", lambda: Lib())
    monkeypatch.setattr(native, "check_rays", lambda *rays: list(rays))
    tab = tables_from_numpy(_tables(*_random_soup(300, seed=8)), "cpu")
    org, d = _tt(*_random_rays(16, seed=9))
    rays = (org, d, torch.zeros(16), torch.full((16,), 1e30))
    tab["pb_depth"] = 19                        # 7 * 19 + 1 = 134 > 128
    with pytest.raises(ValueError, match="134-entry stack"):
        tpb._launch(tab, *rays, tpb.MASK_BOUNCE, False)
    del tab["pb_nodes"]
    with pytest.raises(ValueError, match="pb_nodes"):
        tpb._launch(tab, *rays, tpb.MASK_BOUNCE, False)


def test_stack_bound_is_checked_before_launch():
    import inspect
    src = inspect.getsource(tpb._launch)
    assert "stack_entries" in src and "raise ValueError" in src
    src = (inspect.getsource(tpb.packet_bvh_closest)
           + inspect.getsource(tpb.packet_bvh_any))
    assert "is_cuda" in src and "try" not in src


@pytest.mark.cuda
def test_float_rules_kernel_matches_plain_on_the_card():
    """The float-rule rays, and rays on the box faces of a random soup with
    subnormal, infinite and NaN components: the kernel's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no interpret "
                    "mode")
    for geo, rays in (_rule_case(None), _rule_case("faces", 8192)):
        tab = tables_from_numpy(_tables(*geo), "cuda")
        args = [a.cuda() for a in _tt(*rays)]
        for mb in (tpb.MASK_CAMERA, tpb.MASK_SHADOW):
            got = tpb.packet_bvh_closest(tab, *args, mask_bit=mb)
            ref = tpb.packet_bvh_closest_plain(tab, *args, mask_bit=mb)
            assert all(same_bits(a, b) for a, b in zip(got, ref))
            assert torch.equal(tpb.packet_bvh_any(tab, *args, mask_bit=mb),
                               tpb.packet_bvh_any_plain(tab, *args,
                                                        mask_bit=mb))


@pytest.mark.cuda
def test_packet_kernel_matches_plain_on_the_card():
    """1 to 65553 rays over soups of 1 to 6000 triangles (the tie soups with
    exact copies among them), every mask, closest and any: the kernel's four
    outputs equal the plain version's, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no interpret "
                    "mode")
    cases = []
    for n_tris, n_rays, seed in ((1, 1, 41), (37, 7, 42), (6000, 4096, 43),
                                 (6000, 65553, 44)):
        geo = _random_soup(n_tris, seed=seed)
        org, d = _random_rays(n_rays, seed=seed + 1)
        cases.append((geo, (org, d, np.zeros(n_rays, F32))))
    cases += [_tie_soup(31), _tie_soup(32)]
    for geo, (org, d, tmin) in cases:
        flags = np.random.default_rng(7).integers(1, 16, geo[0].shape[0])
        tab = tables_from_numpy(_tables(*geo, flags.astype(np.uint8)), "cuda")
        n = org.shape[0]
        hits = 0
        for any_hit in (False, True):
            tmax = np.full(n, 3.0 if any_hit else 1e30, F32)
            args = [a.cuda() for a in _tt(org, d, tmin, tmax)]
            for mb in (tpb.MASK_CAMERA, tpb.MASK_LIGHT, tpb.MASK_BOUNCE,
                       tpb.MASK_SHADOW):
                if any_hit:
                    got = tpb.packet_bvh_any(tab, *args, mask_bit=mb)
                    ref = tpb.packet_bvh_any_plain(tab, *args, mask_bit=mb)
                    assert torch.equal(got, ref), (n, mb)
                    continue
                got = tpb.packet_bvh_closest(tab, *args, mask_bit=mb)
                ref = tpb.packet_bvh_closest_plain(tab, *args, mask_bit=mb)
                assert all(same_bits(a, b) for a, b in zip(got, ref)), (n, mb)
                hits += int((got[3] >= 0).sum())
        assert hits > 0 or n < 10
