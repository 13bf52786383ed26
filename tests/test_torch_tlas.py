"""The port's two-level instanced traversal (`ops/tlas.py`): its host tables
against the JAX package's, and its plain PyTorch version (the one the CPU
wrapper runs) against the Pallas kernel in interpret mode and the XLA
reference path, as tests/test_instancing.py runs them.

Tolerances.  Tables are numpy on the host and must be EQUAL.  Traversal: the
gate of tests/test_instancing.py (pool rows agree on more than 99 % of the
rays, t to 1e-5 where they agree, instance ids equal there); on top of that
every disagreement must be an exact-t tie or a hit within rounding of a box
face (the reference decides enter / skip for a block of 1024 rays, the port
per ray), so the t of the two still agree to 1e-5.  XLA on the CPU contracts
multiply-adds and eager torch does not, hence 1e-5 and not 0.  The plain
version against a ray-by-ray walk written like the CUDA kernel: EQUAL, bit
for bit, since the kernel is held to the plain version the same way on the
card.  On the float-rule rays of tests/test_torch_packet_bvh.py (subnormal,
infinite and NaN components) pool rows and instances must be EQUAL.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.api import Runtime as JRuntime
from ignis_tpu.ops import bw_tlas as jtl
from ignis_tpu_torch.convert import tables_from_numpy
from ignis_tpu_torch.ops import tlas as ttl
from test_instancing import _scene
from test_torch_packet_bvh import (
    RULE_HITS, RULE_RAYS, RULE_TRI, face_rays, rule_rays, same_bits,
)

TABLE_KEYS = ("tl_tris", "tl_clust", "tl_shade", "tl_inst", "tl_norm",
              "tl_top")
F32 = np.float32


def _rays(n, seed, lo=-4.0, hi=4.0):
    rng = np.random.default_rng(seed)
    org = rng.uniform(lo, hi, (n, 3)).astype(F32)
    d = rng.normal(0, 1, (n, 3)).astype(F32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d, np.zeros(n, F32), np.full(n, 1e30, F32)


@pytest.fixture(scope="module")
def scenes():
    """JAX runtimes of the instanced test scene, by instance count."""
    cache = {}

    def get(n):
        if n not in cache:
            cache[n] = JRuntime(_scene(True, n=n))
        return cache[n]
    return get


def _port_tables(jrt):
    inst = jrt.scene.instanced
    tab = ttl.build_tlas(inst["shapes"], inst["records"])
    tab["tl_ctree"] = ttl.build_cluster_tree(tab["tl_clust"], tab["tl_inst"])
    return tab


@pytest.mark.parametrize("n,rows", [(3, 1), (8, 1), (25, 9), (100, 73)])
def test_build_tlas_tables_equal(scenes, n, rows):
    """<= 8 instances give one leaf row, more give inner rows."""
    jrt = scenes(n)
    mine = _port_tables(jrt)
    for k in TABLE_KEYS:
        ref = np.asarray(jrt.tables[k])
        assert mine[k].dtype == np.float32 and mine[k].shape == ref.shape, k
        np.testing.assert_array_equal(mine[k], ref, err_msg=k)
    assert mine["tl_top"].shape == (rows, 128)
    assert int(mine["tl_depth"]) == ttl.top_depth(mine["tl_top"])
    assert (mine["tl_depth"] == 1) == (n <= 8)


@pytest.mark.parametrize("n", [1, 8, 9, 70, 600])
def test_build_top_rows_equal_on_random_boxes(n):
    rng = np.random.default_rng(n)
    inst = np.zeros((n, 32), F32)
    lo = rng.uniform(-20, 20, (n, 3))
    inst[:, 0:3] = lo
    inst[:, 3:6] = lo + rng.uniform(0.1, 2, (n, 3))
    inst[:, 6] = 1.0
    inst[::7, 6] = 0.0                      # invalid records are left out
    rows, depth = ttl._build_top_rows(inst)
    np.testing.assert_array_equal(rows, jtl._build_top_rows(inst))
    assert depth == ttl.top_depth(rows)
    assert ttl.stack_entries({"tl_top": rows, "tl_depth": depth}) \
        == min(7 * depth + 1, rows.shape[0])
    assert ttl.stack_entries({"tl_top": rows}) == rows.shape[0]


def _both(jtab, ttab, rays, mask_bit, any_hit):
    org, d, tmin, tmax = rays
    ref = [np.asarray(a) for a in jtl.tlas_traverse(
        jtab, jnp.asarray(org), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax), mask_bit=mask_bit, any_hit=any_hit,
        interpret=True)]
    got = [a.numpy() for a in ttl.tlas_traverse(
        ttab, *(torch.from_numpy(a) for a in rays), mask_bit=mask_bit,
        any_hit=any_hit)]
    return ref, got


def _assert_gate(ref, got):
    """The gate of tests/test_instancing.py, plus: what disagrees is a tie
    or a rounding case, never another surface."""
    agree = ref[3] == got[3]
    assert agree.mean() > 0.99
    np.testing.assert_allclose(got[0][agree], ref[0][agree], rtol=1e-5,
                               atol=1e-5)
    assert (got[4][agree] == ref[4][agree]).all()
    hit = agree & (ref[3] >= 0)
    np.testing.assert_allclose(got[1][hit], ref[1][hit], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[2][hit], ref[2][hit], rtol=0, atol=1e-4)
    both = ~agree & (ref[3] >= 0) & (got[3] >= 0)
    np.testing.assert_allclose(got[0][both], ref[0][both], rtol=1e-5,
                               atol=1e-5)
    return int(hit.sum())


@pytest.mark.parametrize("mask_bit", [0x1, 0x4, 0x8])
@pytest.mark.parametrize("n", [4, 25])
def test_tlas_closest_matches_pallas_interpret(scenes, n, mask_bit):
    jrt = scenes(n)
    ttab = tables_from_numpy(_port_tables(jrt), "cpu")
    ref, got = _both(jrt.tables, ttab, _rays(512, 5), mask_bit, False)
    assert _assert_gate(ref, got) > 10


@pytest.mark.parametrize("mask_bit", [0x1, 0x4, 0x8])
@pytest.mark.parametrize("n", [4, 25])
def test_tlas_any_matches_pallas_interpret(scenes, n, mask_bit):
    """Any-hit: only `pool_row >= 0` is read."""
    jrt = scenes(n)
    ttab = tables_from_numpy(_port_tables(jrt), "cpu")
    org, d, tmin, _ = _rays(512, 6)
    rays = (org, d, np.full(512, 1e-3, F32), np.full(512, 5.0, F32))
    ref, got = _both(jrt.tables, ttab, rays, mask_bit, True)
    occ_r, occ_g = ref[3] >= 0, got[3] >= 0
    assert (occ_r != occ_g).sum() <= 1 and occ_g.any() and not occ_g.all()
    occ = ttl.tlas_any(ttab, *(torch.from_numpy(a) for a in rays),
                       mask_bit=mask_bit).numpy()
    assert occ.dtype == np.bool_ and (occ == occ_g).all()


@pytest.mark.parametrize("n", [4, 25])
def test_tlas_closest_matches_xla_reference(scenes, n):
    jrt = scenes(n)
    ttab = tables_from_numpy(_port_tables(jrt), "cpu")
    rays = _rays(512, 7)
    ref = [np.asarray(a) for a in jtl.tlas_traverse_xla(
        jrt.tables, *(jnp.asarray(a) for a in rays))]
    got = [a.numpy() for a in ttl.tlas_closest(
        ttab, *(torch.from_numpy(a) for a in rays))]
    assert _assert_gate(ref, got) > 10


def _degenerate_tables():
    rng = np.random.default_rng(7)
    t = 16
    v0 = rng.uniform(-2, 2, (t, 3)).astype(F32)
    e1 = rng.uniform(-1, 1, (t, 3)).astype(F32)
    e2 = rng.uniform(-1, 1, (t, 3)).astype(F32)
    e2[3] = e1[3]  # degenerate
    e1[9] = 0.0
    n0 = np.cross(e1, e2).astype(F32)
    z2 = np.zeros((t, 2), F32)
    sh = {"v0": v0, "e1": e1, "e2": e2, "n0": n0, "n1": n0, "n2": n0,
          "uv0": z2, "uv1": z2, "uv2": z2}
    ident = np.eye(3, 4, dtype=F32)
    return [sh], ident


def test_tlas_degenerate_triangles_never_hit():
    """The per-triangle mask in lane 12 is 0 for degenerate and padding rows;
    the traversal must honour it beside the instance's visibility bits."""
    shapes, ident = _degenerate_tables()
    recs = [(0, ident, ident, np.eye(3, dtype=F32), 0, 0xF)]
    mine, ref_tab = ttl.build_tlas(shapes, recs), jtl.build_tlas(shapes, recs)
    for k in TABLE_KEYS:
        np.testing.assert_array_equal(mine[k], ref_tab[k], err_msg=k)
    rays = _rays(256, 8, -3, 3)
    ref, got = _both({k: jnp.asarray(v) for k, v in ref_tab.items()},
                     tables_from_numpy(mine, "cpu"), rays, 0xF, False)
    _assert_gate(ref, got)
    assert (got[3] >= 0).any()
    assert not np.isin(got[3], [3, 9]).any()
    assert (got[4][got[3] >= 0] == 0).all()


def test_tlas_instance_visibility_bits():
    """Two instances of one shape, the second visible to camera rays only."""
    shapes, ident = _degenerate_tables()
    moved = ident.copy()
    moved[0, 3] = 5.0                       # toWorld: +5 in x
    back = ident.copy()
    back[0, 3] = -5.0
    eye = np.eye(3, dtype=F32)
    tab = tables_from_numpy(ttl.build_tlas(
        shapes, [(0, ident, ident, eye, 0, 0xF), (0, back, moved, eye, 1, 0x1)]),
        "cpu")
    org, d, tmin, tmax = (torch.from_numpy(a) for a in _rays(512, 9, -3, 8))
    cam = ttl.tlas_closest(tab, org, d, tmin, tmax, mask_bit=0x1)
    bounce = ttl.tlas_closest(tab, org, d, tmin, tmax, mask_bit=0x4)
    assert (cam[4] == 1).any() and (cam[4] == 0).any()
    assert not (bounce[4] == 1).any() and (bounce[4] == 0).any()
    assert ttl.tlas_any(tab, org, d, tmin, tmax, mask_bit=0x8).sum() \
        < ttl.tlas_any(tab, org, d, tmin, tmax, mask_bit=0x1).sum()


def _walk_ray_by_ray(tab, rays, mask_bit, any_hit):
    """The traversal as the CUDA kernel does it: one ray at a time, scalar
    float32 arithmetic in the kernel's order and grouping."""
    top, tris, clust, inst = (np.asarray(tab[k], F32) for k in (
        "tl_top", "tl_tris", "tl_clust", "tl_inst"))
    tol, one = F32(1.1920928955078125e-07), F32(1.0)
    tiny = np.finfo(F32).tiny          # below it a float counts as 0

    def inv(x):
        return F32(1e30) if abs(x) < tiny else one / x

    def slab(b, o, i, tmn, bt):
        t0, t1 = (b[0:3] - o) * i, (b[3:6] - o) * i
        lo, hi = np.minimum(t0, t1), np.maximum(t0, t1)
        near = max(max(lo[0], lo[1]), max(lo[2], tmn))
        far = min(min(hi[0], hi[1]), min(hi[2], bt))
        return near <= far

    out = []
    for o, d, tmn, bt in zip(*rays):
        i3 = np.array([inv(x) for x in d], F32)
        bu = bv = F32(0)
        bi = be = -1
        stack, done = [0], False
        while stack and not done:
            row = top[stack.pop()]
            if row[126] <= 0.5:
                for c in range(8):
                    if slab(row[6 * c:6 * c + 6], o, i3, tmn, bt) \
                            and row[64 + c] > -0.5e9:
                        stack.append(int(row[64 + c]))
                continue
            for s in range(8):
                iid = int(row[s])
                if iid < 0 or done:
                    continue
                ir = inst[iid]
                if not ir[6] > 0 or not int(ir[23]) & mask_bit:
                    continue
                if not slab(ir[0:6], o, i3, tmn, bt):
                    continue
                m = ir[10:22]
                lo = np.array([(m[4 * r] * o[0] + m[4 * r + 1] * o[1])
                               + (m[4 * r + 2] * o[2] + m[4 * r + 3])
                               for r in range(3)], F32)
                ld = np.array([m[4 * r] * d[0] + m[4 * r + 1] * d[1]
                               + m[4 * r + 2] * d[2] for r in range(3)], F32)
                li = np.array([inv(x) for x in ld], F32)
                cl0, ccnt, toff = int(ir[7]), int(ir[8]), int(ir[9])
                for c in range(ccnt):
                    cb = clust[cl0 + c]
                    if done or not cb[6] > 0 \
                            or not slab(cb[0:6], lo, li, tmn, bt):
                        continue
                    for kk in range(8):
                        r = toff + c * 8 + kk
                        tr = tris[r]
                        nn, b1, b2 = tr[0:3], tr[4:7], tr[8:11]
                        mm = (nn[0] * lo[0] + nn[1] * lo[1]) \
                            + (nn[2] * lo[2] + tr[3])
                        k = nn[0] * ld[0] + nn[1] * ld[1] + nn[2] * ld[2]
                        tt = -mm * (F32(0) if abs(k) < tiny else one / k)
                        u = ((b1[0] * lo[0] + b1[1] * lo[1])
                             + (b1[2] * lo[2] + tr[7])) + tt * (
                            b1[0] * ld[0] + b1[1] * ld[1] + b1[2] * ld[2])
                        v = ((b2[0] * lo[0] + b2[1] * lo[1])
                             + (b2[2] * lo[2] + tr[11])) + tt * (
                            b2[0] * ld[0] + b2[1] * ld[1] + b2[2] * ld[2])
                        if (int(tr[12]) & mask_bit and abs(k) >= tiny
                                and u >= -tol
                                and v >= -tol and u + v <= one + tol
                                and tmn <= tt <= bt):
                            bt, bi, be = tt, r, iid
                            if any_hit:
                                done = True
                                break
                            bu, bv = max(u, F32(0)), max(v, F32(0))
        out.append((bt, bu, bv, bi, be))
    return [np.array(col) for col in zip(*out)]


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n", [4, 25])
def test_plain_equals_ray_by_ray_walk(scenes, n, any_hit):
    """The bulk evaluation of the plain version gives exactly what the
    sequential walk of the kernel gives: same order, same ties, same bits."""
    tab = _port_tables(scenes(n))
    rays = _rays(192, 11)
    rays = (rays[0], rays[1], np.full(192, 1e-3, F32),
            np.full(192, 6.0 if any_hit else 1e30, F32))
    with np.errstate(all="ignore"):
        ref = _walk_ray_by_ray(tab, rays, 0x4, any_hit)
    work = {}
    got = [a.numpy() for a in ttl.tlas_traverse_plain(
        tables_from_numpy(tab, "cpu"), *(torch.from_numpy(a) for a in rays),
        mask_bit=0x4, any_hit=any_hit, work=work)]
    assert (got[3] >= 0).sum() > 5
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b.astype(a.dtype))
    assert work["instances_entered"] > 0 and work["tri_tests"] > 0
    assert work["cluster_tests"] == work["instances_entered"] * 40


def test_equal_t_goes_to_the_last_visited():
    """Two instances of one shape at the same place: every hit is an exact
    tie, and the later slot of the leaf row wins, as `t <= best` says."""
    shapes, ident = _degenerate_tables()
    eye = np.eye(3, dtype=F32)
    tab = tables_from_numpy(ttl.build_tlas(
        shapes, [(0, ident, ident, eye, 0, 0xF), (0, ident, ident, eye, 1, 0xF)]),
        "cpu")
    out = ttl.tlas_closest(tab, *(torch.from_numpy(a)
                                  for a in _rays(256, 12, -3, 3)))
    hit = out[3] >= 0
    assert hit.any() and (out[4][hit] == 1).all()


def test_int32_encoding_is_checked():
    tab = {"tl_inst": np.zeros((70000, 32)), "tl_tris": np.zeros((40000, 16))}
    with pytest.raises(ValueError, match="int32"):
        ttl.check_encoding(10, tab)
    ttl.check_encoding(10, {"tl_inst": np.zeros((1024, 32)),
                            "tl_tris": np.zeros((1280, 16))}, n_spheres=4)


def test_no_rays_and_dead_rays(scenes):
    ttab = tables_from_numpy(_port_tables(scenes(4)), "cpu")
    e3, e1 = torch.zeros((0, 3)), torch.zeros(0)
    assert all(a.shape == (0,) for a in ttl.tlas_closest(ttab, e3, e3, e1, e1))
    org, d, tmin, tmax = (torch.from_numpy(a) for a in _rays(64, 13))
    tmax[::2] = -1.0
    out = ttl.tlas_closest(ttab, org, d, tmin, tmax)
    assert (out[3][::2] == -1).all() and (out[0][::2] == -1.0).all()


def test_tlas_cuda_tensor_never_takes_the_plain_version():
    """The wrapper picks the plain version only because the tensor is on the
    CPU; this is the dispatch condition, checked without a card."""
    src = inspect.getsource(ttl._traverse)
    assert "is_cuda" in src and "try" not in src
    assert ttl.tlas_closest.launches == 0 and ttl.tlas_any.launches == 0


# ------------------------------------------------------------ cluster tree
def _strip_shape(t, seed, dup=True):
    """A coherent strip of t small triangles along x (consecutive clusters
    are neighbours), with an exact duplicate of triangle 2 at 5 (one
    cluster) and of triangle 1 at t - 1 (another cluster)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-1.0, 1.0, t)
    v0 = np.stack([x, 0.3 * np.sin(3 * x), np.zeros(t)], 1)
    v0 += rng.uniform(-0.02, 0.02, (t, 3))
    e1 = rng.uniform(-0.2, 0.2, (t, 3))
    e2 = rng.uniform(-0.2, 0.2, (t, 3))
    if dup and t > 5:
        for a, b in ((5, 2), (t - 1, 1)):
            v0[a], e1[a], e2[a] = v0[b], e1[b], e2[b]
    v0, e1, e2 = (a.astype(F32) for a in (v0, e1, e2))
    n0 = np.cross(e1, e2)
    n0 = (n0 / np.maximum(np.linalg.norm(n0, axis=1, keepdims=True),
                          1e-12)).astype(F32)
    z2 = np.zeros((t, 2), F32)
    return {"v0": v0, "e1": e1, "e2": e2, "n0": n0, "n1": n0, "n2": n0,
            "uv0": z2, "uv1": z2, "uv2": z2}


def _pool(n_inst, seed, tris=(72, 520)):
    """Shapes of len(tris) different cluster counts; `n_inst` instances
    with random rotation, scale, place and visibility bits, instance 1 an
    exact copy of instance 0 (every hit on it an equal-t tie)."""
    rng = np.random.default_rng(seed)
    shapes = [_strip_shape(t, seed + k) for k, t in enumerate(tris)]
    recs = []
    for i in range(n_inst):
        q, _ = np.linalg.qr(rng.normal(0, 1, (3, 3)))
        lin = q * rng.uniform(0.5, 1.5)
        tw = np.concatenate([lin, rng.uniform(-4, 4, (3, 1))], 1)
        tl = np.linalg.inv(np.concatenate([tw, [[0, 0, 0, 1]]]))[:3]
        nmat = np.linalg.inv(lin).T
        recs.append((i % len(shapes), tl.astype(F32), tw.astype(F32),
                     nmat.astype(F32), i, int(rng.integers(1, 16))))
    if n_inst > 1:
        recs[1] = recs[0][:4] + (1,) + recs[0][5:]
    tab = ttl.build_tlas(shapes, recs)
    tab["tl_ctree"] = ttl.build_cluster_tree(tab["tl_clust"], tab["tl_inst"])
    return tab


def _aimed_rays(tab, n, seed):
    """Rays from [-6, 6]^3, each aimed near a random instance's box centre."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-6, 6, (n, 3)).astype(F32)
    inst = tab["tl_inst"]
    pick = inst[rng.integers(0, inst.shape[0], n)]
    aim = 0.5 * (pick[:, 0:3] + pick[:, 3:6]) + rng.normal(0, 0.3, (n, 3))
    d = (aim - org).astype(F32)
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-6)
    return org, d.astype(F32), np.zeros(n, F32), np.full(n, 1e30, F32)


def _brute_node(clust, cl0, ccnt, level, j):
    """A node's box and validity from the clusters it covers, directly."""
    part = clust[cl0 + (8 ** level) * j:cl0 + min(ccnt, (8 ** level) * (j + 1))]
    v = part[part[:, 6] > 0]
    if not len(v):
        return None
    return (np.minimum(v[:, 0:3], v[:, 3:6]).min(0),
            np.maximum(v[:, 0:3], v[:, 3:6]).max(0))


@pytest.mark.parametrize("ccnt", [1, 7, 8, 9, 64, 65, 160])
def test_cluster_tree_nodes_are_min_max_of_valid_children(ccnt):
    """Each node is the exact min / max of the valid clusters below it, only
    of its own shape's range; shapes of <= 8 clusters get no levels."""
    shapes = [_strip_shape(8 * ccnt - 3, 1), _strip_shape(8 * 11, 2)]
    ident = np.eye(3, 4, dtype=F32)
    recs = [(k % 2, ident, ident, np.eye(3, dtype=F32), k, 0xF)
            for k in range(5)]
    tab = ttl.build_tlas(shapes, recs)
    clust = tab["tl_clust"].copy()
    clust[1::5, 6] = 0.0                      # some clusters invalid
    clust[2::7, 0:3] = clust[2::7, 3:6] + 0.5  # some boxes inverted
    tree = ttl.build_cluster_tree(clust, tab["tl_inst"])
    assert tree.dtype == np.float32 and tree.shape[1] == 8
    rows_seen = set()
    for ii in range(5):
        cl0, cnt = int(tab["tl_inst"][ii, 7]), int(tab["tl_inst"][ii, 8])
        hdr = tree[ii]
        levels = int(hdr[0])
        want = 0
        while -(-cnt // 8 ** want) > 8:
            want += 1
        assert levels == want and (hdr[1 + levels:] == 0).all()
        for lev in range(1, levels + 1):
            nodes = -(-cnt // 8 ** lev)
            base = int(hdr[lev])
            for j in range(nodes):
                row = tree[base + j]
                rows_seen.add((base + j, cl0))
                ref = _brute_node(clust, cl0, cnt, lev, j)
                if ref is None:
                    assert row[6] == 0.0
                    continue
                assert row[6] == 1.0 and row[7] == 0.0
                np.testing.assert_array_equal(row[0:3], ref[0])
                np.testing.assert_array_equal(row[3:6], ref[1])
    # one tree per shape: no row is shared by two cluster ranges
    assert len({r for r, _ in rows_seen}) == len(rows_seen)
    assert tree.shape[0] == 5 + len(rows_seen)


@pytest.mark.parametrize("n", [4, 25, 100])
def test_cluster_tree_from_reference_tables_equals_the_ports(scenes, n):
    jrt = scenes(n)
    mine = _port_tables(jrt)
    ref = ttl.build_cluster_tree(np.asarray(jrt.tables["tl_clust"]),
                                 np.asarray(jrt.tables["tl_inst"]))
    np.testing.assert_array_equal(mine["tl_ctree"], ref)
    assert (ref[:n, 0] == 1).all()              # 40 clusters: one level


def _inv32(x):
    """`safe_inv`: 1e30 for a zero or subnormal component."""
    with np.errstate(all="ignore"):
        return np.where(np.abs(x) < np.finfo(F32).tiny, F32(1e30),
                        F32(1) / x).astype(F32)


def _cuda_slab(lo, hi, o, inv, tmn, bt, node):
    """The kernel's `bw_slab` (node=False: minima and maxima keep NaN, as
    np.minimum / np.maximum do) and node test (node=True: an axis with a NaN
    end is unconstrained, fminf / fmaxf drop NaN as np.fmin / np.fmax do) in
    float32."""
    with np.errstate(all="ignore"):
        t0 = (lo - o) * inv
        t1 = (hi - o) * inv
    if not node:
        lo_, hi_ = np.minimum(t0, t1), np.maximum(t0, t1)
        near = np.maximum(np.maximum(lo_[..., 0], lo_[..., 1]),
                          np.maximum(lo_[..., 2], tmn))
        far = np.minimum(np.minimum(hi_[..., 0], hi_[..., 1]),
                         np.minimum(hi_[..., 2], bt))
        return near <= far
    nan = np.isnan(t0) | np.isnan(t1)
    a = np.where(nan, -np.inf, np.fmin(t0, t1)).astype(F32)
    b = np.where(nan, np.inf, np.fmax(t0, t1)).astype(F32)
    near = np.fmax(np.fmax(a[..., 0], a[..., 1]), np.fmax(a[..., 2], tmn))
    far = np.fmin(np.fmin(b[..., 0], b[..., 1]), np.fmin(b[..., 2], bt))
    return near <= far


_SPECIAL = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40,
                     1e-45, 3e-39, 1e-30, -1e-3, 0.7, -0.6, 1.0], F32)


def _hard_rays(clust, n, rng):
    """Origins on the clusters' faces (box - o = 0 exactly), inside, outside
    and at +-inf / NaN; directions drawn from NaN, +-inf, +-0, subnormals and
    ordinary values, component by component."""
    faces = np.concatenate([clust[:, 0:3], clust[:, 3:6]])
    org = faces[rng.integers(0, len(faces), n)].copy()
    pick = rng.random((n, 3))
    org = np.where(pick < 0.2, rng.uniform(-2, 2, (n, 3)), org).astype(F32)
    org[rng.random((n, 3)) < 0.02] = np.inf
    org[rng.random((n, 3)) < 0.02] = np.nan
    d = _SPECIAL[rng.integers(0, len(_SPECIAL), (n, 3))]
    d = np.where(rng.random((n, 3)) < 0.3, rng.normal(0, 1, (n, 3)),
                 d).astype(F32)
    tmn = np.where(rng.random(n) < 0.8, F32(0), F32(np.nan)).astype(F32)
    tmn[rng.random(n) < 0.2] = F32(-0.0)
    bt = np.where(rng.random(n) < 0.5, F32(np.inf),
                  rng.uniform(0, 3, n)).astype(F32)
    bt[rng.random(n) < 0.05] = np.nan
    return org, d, tmn, bt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_node_passes_where_a_child_passes(seed):
    """Monotonicity: a cluster that passes `bw_slab` has every ancestor of
    `build_cluster_tree` pass the node test, on the same best t, for rays
    with NaN / +-inf / +-0 / zero / subnormal components and origins on the
    box faces, over boxes that are flat, inverted, NaN or infinite."""
    rng = np.random.default_rng(seed)
    nc = 200
    lo = rng.uniform(-1, 1, (nc, 3)).astype(F32)
    hi = (lo + rng.uniform(0, 0.5, (nc, 3))).astype(F32)
    flat = rng.random((nc, 3)) < 0.3
    hi = np.where(flat, lo, hi)
    clust = np.zeros((nc, 8), F32)
    clust[:, 0:3], clust[:, 3:6], clust[:, 6] = lo, hi, 1.0
    clust[5, 0:3], clust[5, 3:6] = hi[5], lo[5]       # inverted
    clust[17, 1] = np.nan
    clust[29, 5] = np.inf
    clust[41, 0] = -np.inf
    clust[3::9, 6] = 0.0
    inst = np.zeros((1, 32), F32)
    inst[0, 6], inst[0, 8] = 1.0, nc
    tree = ttl.build_cluster_tree(clust, inst)
    levels = int(tree[0, 0])
    assert levels == 2
    org, d, tmn, bt = _hard_rays(clust, 4000, rng)
    inv = _inv32(d)
    o, i = org[:, None, :], inv[:, None, :]
    tm, b = tmn[:, None], bt[:, None]
    child = _cuda_slab(clust[:, 0:3], clust[:, 3:6], o, i, tm, b, False)
    child &= clust[:, 6] > 0
    assert child.any() and not child.all()
    for lev in range(1, levels + 1):
        rows = tree[(tree[0, lev] + np.arange(nc) // 8 ** lev).astype(int)]
        node = _cuda_slab(rows[:, 0:3], rows[:, 3:6], o, i, tm, b, True)
        assert (rows[:, 6][child.any(0)] > 0).all()
        assert not (child & ~node).any(), lev


def test_plain_slab_on_a_node_is_not_monotone():
    """Why the node test leaves an axis with a NaN end unconstrained: an
    infinite direction component makes 1 / d zero, so a node whose box
    reaches to -inf on that axis (a sibling's does) is NaN there and fails
    `bw_slab`, while its finite child passes.  (A subnormal component, whose
    1 / d was infinite before the reference's float rules, is no longer
    such a case: its reciprocal is 1e30.)"""
    child_lo = np.array([-1.0, -1.0, -1.0], F32)
    child_hi = np.array([1.0, 1.0, 1.0], F32)
    node_lo = np.array([-np.inf, -1.0, -1.0], F32)
    o = np.array([0.0, 0.0, 0.0], F32)
    inv = _inv32(np.array([np.inf, 0.0, 1.0], F32))
    args = (o, inv, F32(0), F32(np.inf))
    assert inv[0] == 0 and _inv32(np.array([1e-40], F32))[0] == F32(1e30)
    assert _cuda_slab(child_lo, child_hi, *args, node=False)
    assert not _cuda_slab(node_lo, child_hi, *args, node=False)
    assert _cuda_slab(node_lo, child_hi, *args, node=True)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("mask_bit", [0x1, 0x2, 0x4, 0x8])
@pytest.mark.parametrize("n", [4, 25, 100])
def test_cluster_walk_equals_the_dense_sweep(scenes, n, mask_bit, any_hit):
    """The kernel's walk over the cluster tree, in PyTorch: bit-equal to the
    dense `tlas_traverse_plain`, entering the same clusters (the same
    triangle tests) after fewer box decisions."""
    tab = tables_from_numpy(_port_tables(scenes(n)), "cpu")
    org, d, _, _ = _rays(256, 21 + n)
    rays = (torch.from_numpy(org), torch.from_numpy(d),
            torch.full((256,), 1e-3), torch.full((256,), 5.0 if any_hit
                                                 else 1e30))
    dense, walk = {}, {}
    ref = ttl.tlas_traverse_plain(tab, *rays, mask_bit=mask_bit,
                                  any_hit=any_hit, work=dense)
    got = ttl.cluster_walk_plain(tab, *rays, mask_bit=mask_bit,
                                 any_hit=any_hit, work=walk)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert (got[3] >= 0).sum() > 3
    assert walk["tri_tests"] == dense["tri_tests"]
    assert walk["node_tests"] + walk["cluster_tests"] < dense["cluster_tests"]


@pytest.mark.parametrize("any_hit", [False, True])
def test_cluster_walk_equals_the_dense_sweep_on_two_shapes(any_hit):
    """Shapes of 9 and 65 clusters, 40 instances, an exact copy of an
    instance and duplicated triangles: equal-t ties resolve as in the dense
    sweep."""
    pool = _pool(40, 3)
    tab = tables_from_numpy(pool, "cpu")
    org, d, _, _ = _aimed_rays(pool, 384, 22)
    rays = (torch.from_numpy(org), torch.from_numpy(d), torch.zeros(384),
            torch.full((384,), 8.0 if any_hit else 1e30))
    for mb in (0x1, 0x4):
        ref = ttl.tlas_traverse_plain(tab, *rays, mask_bit=mb,
                                      any_hit=any_hit)
        got = ttl.cluster_walk_plain(tab, *rays, mask_bit=mb, any_hit=any_hit)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert (got[3] >= 0).sum() > 10


def _rule_case(case, n_faces=512):
    """Tables and rays of a float-rule case: the rule triangle under one
    instance of identity transforms; "faces": a strip shape under an
    identity instance and seven others, with rays on the faces of the
    clusters, the instances' world boxes and the top rows' boxes."""
    eye, ident = np.eye(3, dtype=F32), np.eye(3, 4, dtype=F32)
    if case != "faces":
        v0, e1, e2 = RULE_TRI
        n0 = np.cross(e1, e2).astype(F32)
        z2 = np.zeros((1, 2), F32)
        shape = {"v0": v0, "e1": e1, "e2": e2, "n0": n0, "n1": n0,
                 "n2": n0, "uv0": z2, "uv1": z2, "uv2": z2}
        tab = ttl.build_tlas([shape], [(0, ident, ident, eye, 0, 0xF)])
        tab["tl_ctree"] = ttl.build_cluster_tree(tab["tl_clust"],
                                                 tab["tl_inst"])
        return tab, rule_rays(case)
    recs = [(0, ident, ident, eye, 0, 0xF)]
    rng = np.random.default_rng(28)
    for i in range(1, 9):
        tw = np.concatenate([eye, rng.uniform(-4, 4, (3, 1))], 1).astype(F32)
        tl = np.concatenate([eye, -tw[:, 3:]], 1).astype(F32)
        recs.append((0, tl, tw, eye, i, 0xF))
    tab = ttl.build_tlas([_strip_shape(520, 27)], recs)
    tab["tl_ctree"] = ttl.build_cluster_tree(tab["tl_clust"], tab["tl_inst"])
    top = tab["tl_top"][tab["tl_top"][:, 126] == 0][:, :48].reshape(-1, 6)
    boxes = np.concatenate([tab["tl_clust"][:, :6], tab["tl_inst"][:, :6],
                            top])
    return tab, face_rays(boxes, n_faces, 29)


@pytest.mark.parametrize("case", sorted(RULE_RAYS) + ["faces"])
def test_tlas_float_rules_match_pallas_interpret(case):
    """Subnormal, infinite and NaN components: the JAX package's results
    (the subnormal case failed before the port took its float rules)."""
    tab, rays = _rule_case(case)
    jtab = {k: jnp.asarray(v) for k, v in tab.items()}
    ttab = tables_from_numpy(tab, "cpu")
    for any_hit in (False, True):
        ref, got = _both(jtab, ttab, rays, 0xF, any_hit)
        if case in RULE_HITS and not any_hit:
            assert got[3].tolist() == RULE_HITS[case]
        if case == "faces":
            # rays that start on box faces, where vertices lie, along
            # near-axis directions graze triangle edges: a hit within
            # rounding of an edge (XLA contracts multiply-adds and flushes
            # subnormals in the functionals) may go either way.  The first
            # gate of this file holds, and the plain version is the
            # ray-by-ray walk of the kernel, bit for bit.
            key = (lambda x: x[3] >= 0) if any_hit else (lambda x: x[3])
            assert (key(got) == key(ref)).mean() > 0.99
            with np.errstate(all="ignore"):
                walk = _walk_ray_by_ray(tab, rays, 0xF, any_hit)
            for a, b in zip(got, walk):
                np.testing.assert_array_equal(a, b.astype(a.dtype))
            continue
        np.testing.assert_array_equal(got[3] >= 0, ref[3] >= 0)
        if any_hit:
            continue
        np.testing.assert_array_equal(got[3], ref[3])
        np.testing.assert_array_equal(got[4], ref[4])
        hit = ref[3] >= 0
        np.testing.assert_allclose(got[0][hit], ref[0][hit], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got[1][hit], ref[1][hit], atol=1e-4)
        np.testing.assert_allclose(got[2][hit], ref[2][hit], atol=1e-4)
        np.testing.assert_array_equal(got[0][~hit], ref[0][~hit])


@pytest.mark.cuda
def test_tlas_float_rules_kernel_matches_plain_on_the_card():
    """The float-rule rays and the face rays with special components: the
    kernel's bits, closest and any."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no interpret "
                    "mode")
    for tab, rays in (_rule_case(None), _rule_case("faces", 8192)):
        tab = tables_from_numpy(tab, "cuda")
        args = [torch.from_numpy(a).cuda() for a in rays]
        for any_hit in (False, True):
            for mb in (0x1, 0x8):
                got = ttl.tlas_traverse(tab, *args, mask_bit=mb,
                                        any_hit=any_hit)
                ref = ttl.tlas_traverse_plain(tab, *args, mask_bit=mb,
                                              any_hit=any_hit)
                assert all(same_bits(a, b) for a, b in zip(got, ref))


@pytest.mark.cuda
def test_tlas_kernel_matches_plain_on_the_card(scenes):
    """1 to 65553 rays over 1 to 600 instances of two shapes of 9 and 65
    clusters (and the fixture's 25 icospheres), every mask, an exact copy of
    an instance and duplicated triangles: the kernel's five outputs equal the
    plain version's, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no interpret "
                    "mode")
    fixture = _port_tables(scenes(25))
    cases = [(fixture, _rays(4096, 14))]
    for n_inst, n_rays, seed in ((1, 1, 31), (9, 7, 32), (64, 4096, 33),
                                 (600, 65553, 34), (600, 129, 35)):
        pool = _pool(n_inst, seed)
        cases.append((pool, _aimed_rays(pool, n_rays, seed)))
    for tab, rays in cases:
        tab = tables_from_numpy(tab, "cuda")
        org, d, tmin, tmax = (torch.from_numpy(a).cuda() for a in rays)
        n_rays = org.shape[0]
        hits = 0
        for any_hit in (False, True):
            tm = torch.full_like(tmax, 8.0) if any_hit else tmax
            for mb in (0x1, 0x2, 0x4, 0x8):
                got = ttl.tlas_traverse(tab, org, d, tmin, tm, mask_bit=mb,
                                        any_hit=any_hit)
                ref = ttl.tlas_traverse_plain(tab, org, d, tmin, tm,
                                              mask_bit=mb, any_hit=any_hit)
                for a, b in zip(got, ref):
                    assert torch.equal(a, b), (n_rays, any_hit, mb)
                hits += int((got[3] >= 0).sum())
        assert hits > 0 or n_rays < 10
