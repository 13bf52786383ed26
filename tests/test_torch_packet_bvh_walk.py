"""The port's 8-wide BVH traversal, second half of the tests of
test_torch_packet_bvh.py (split so that neither file runs long under the
tier-1 run's workers): the float-rule rays against the JAX package's Pallas
kernel in interpret mode, the kernel's node records (`pb_nodes`), the plain
version against a ray-by-ray walk, its work counters, the launch checks and
the `cuda`-marked kernel tests.

Tolerances as in test_torch_packet_bvh.py: on the float-rule rays prim ids
must be EQUAL; elsewhere t to 1e-5 relative, u and v to 1e-4, prim ids
equal except at exact ties.
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
from test_torch_packet_bvh import (
    F32, RULE_HITS, RULE_RAYS, RULE_TRI, _random_rays, _random_soup,
    _same_hits, _tables, _tt, face_rays, rule_rays, same_bits,
)


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
