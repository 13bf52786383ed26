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
card.
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
    return ttl.build_tlas(inst["shapes"], inst["records"])


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

    def inv(x):
        return F32(1e30) if x == 0 else one / x

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
                        tt = -mm * (F32(0) if k == 0 else one / k)
                        u = ((b1[0] * lo[0] + b1[1] * lo[1])
                             + (b1[2] * lo[2] + tr[7])) + tt * (
                            b1[0] * ld[0] + b1[1] * ld[1] + b1[2] * ld[2])
                        v = ((b2[0] * lo[0] + b2[1] * lo[1])
                             + (b2[2] * lo[2] + tr[11])) + tt * (
                            b2[0] * ld[0] + b2[1] * ld[1] + b2[2] * ld[2])
                        if (int(tr[12]) & mask_bit and k != 0 and u >= -tol
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


@pytest.mark.cuda
def test_tlas_kernel_matches_plain_on_the_card(scenes):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no interpret "
                    "mode")
    tab = tables_from_numpy(_port_tables(scenes(25)), "cuda")
    rays = [torch.from_numpy(a).cuda() for a in _rays(4096, 14)]
    for any_hit in (False, True):
        got = ttl.tlas_traverse(tab, *rays, mask_bit=0x4, any_hit=any_hit)
        ref = ttl.tlas_traverse_plain(tab, *rays, mask_bit=0x4,
                                      any_hit=any_hit)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
