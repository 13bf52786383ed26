"""Baldwin-Weber precomputed-triangle brute-force intersection.

Counterpart of ignis_tpu/ops/bw_intersect.py (a Pallas TPU kernel there); the
kernel here is hand-written CUDA, `csrc/bw_intersect.cu`.  Used for soups
under 4096 triangles.

Per-triangle precomputation (host, float64) moves the cross products and
barycentric solves out of the inner loop:

  n  = e1 x e2,   d0 = -n.v0                      (plane)
  B1 = (e2 x n) / ((e2 x n).e1), b1 = -B1.v0      (u functional)
  B2 = (n x e1) / ((n x e1).e2), b2 = -B2.v0      (v functional)

Per ray-triangle test:  m = n.o + d0, k = n.d, t = -m/k,
u = (B1.o + b1) + t (B1.d), v = (B2.o + b2) + t (B2.d); hit iff
u >= -tol, v >= -tol, u+v <= 1+tol, tmin <= t <= t_best, k not zero (nor
subnormal: `ops.ref_float`) and the ray class bit is set in the triangle's
maskbits.  Later equal-t hits win.

`bw_closest` / `bw_any` launch the CUDA kernel for tensors on the card and
run the plain PyTorch version (`bw_closest_plain` / `bw_any_plain`, the dense
cluster-by-cluster sweep, which stays the specification) for tensors on the
CPU.  The kernel walks the port's own `bw_ctree` (`build_bw_ctree`, derived
from `bw_clusters` alone): an implicit 8-ary tree of boxes over the clusters,
whose subtrees it skips when the ray's window misses their box, which changes
no decision (`csrc/cluster_walk.cuh` has the argument; `bw_walk_plain` is the
same walk in PyTorch, for the tests).  Both decide the cluster skip per ray,
from that ray's own [tmin, best] window, so they agree bit for bit; the
reference kernel decides it per 1024-ray block, which can differ only for a
hit that lies within rounding of a cluster box face.

The tree, its node test and the walk are shared with the two-level traversal
(`ops/tlas.py`, whose instances each walk a range of a pooled cluster table),
as `csrc/cluster_walk.cuh` is shared by the two kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ignis_tpu_torch.ops.ref_float import is_zero, safe_inv

TRI_TILE = 8
_TOL = 1.1920928955078125e-07
WIDTH = 8                       # children of a tree node, lanes of a ray
CTREE_FLOATS = 8                # cluster-tree row: header or node


def bw_tables(v0, e1, e2, maskbits, order=None):
    """Precompute the Baldwin–Weber triangle + cluster tables.

    maskbits: (T,) int visibility bits per triangle (camera=1, light=2,
    bounce=4, shadow=8).  Degenerate triangles get maskbits 0.

    order: optional (T,) permutation (e.g. the SAH BVH's tri_order) —
    triangles are stored permuted so consecutive TRI_TILE-sized clusters
    are spatially tight, and each cluster gets an AABB; the kernel slab-
    tests the cluster box against the ray and skips the eight
    triangle tests when the ray cannot hit (a two-level BVH flattened into
    a dense sweep + conditional skip).  Reported prim ids are always
    ORIGINAL indices.
    """
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    t = v0.shape[0]
    if order is None:
        order = np.arange(t)
    else:
        order = np.asarray(order, np.int64)
    v0 = v0[order]
    e1 = e1[order]
    e2 = e2[order]
    maskbits = np.asarray(maskbits, np.int64)[order]
    n = np.cross(e1, e2)
    nn = np.einsum("ij,ij->i", n, n)
    degen = nn < 1e-30
    c1 = np.cross(e2, n)
    c2 = np.cross(n, e1)
    den1 = np.einsum("ij,ij->i", c1, e1)
    den2 = np.einsum("ij,ij->i", c2, e2)
    bad = degen | (np.abs(den1) < 1e-30) | (np.abs(den2) < 1e-30)
    den1 = np.where(bad, 1.0, den1)
    den2 = np.where(bad, 1.0, den2)
    B1 = c1 / den1[:, None]
    B2 = c2 / den2[:, None]
    d0 = -np.einsum("ij,ij->i", n, v0)
    b1 = -np.einsum("ij,ij->i", B1, v0)
    b2 = -np.einsum("ij,ij->i", B2, v0)
    mask = np.where(bad, 0, np.asarray(maskbits, np.int64) & 0xF)

    pad = (-t) % TRI_TILE
    tp = max(t + pad, TRI_TILE)
    tab = np.zeros((tp, 16), np.float32)
    tab[:t, 0:3] = n
    tab[:t, 3] = d0
    tab[:t, 4:7] = B1
    tab[:t, 7] = b1
    tab[:t, 8:11] = B2
    tab[:t, 11] = b2
    tab[:t, 12] = mask.astype(np.float32)
    tab[:t, 13] = order.astype(np.float32)     # original id, exact < 2^24

    # per-cluster AABBs; lane 6 = valid flag (empty padding clusters skip)
    nclust = tp // TRI_TILE
    va = np.asarray(v0, np.float32)
    vb = np.asarray(v0 + e1, np.float32)
    vc = np.asarray(v0 + e2, np.float32)
    cb = np.zeros((nclust, 8), np.float32)
    for ci in range(nclust):
        lo, hi = ci * TRI_TILE, min((ci + 1) * TRI_TILE, t)
        if lo >= t:
            continue
        pts = np.concatenate([va[lo:hi], vb[lo:hi], vc[lo:hi]])
        cb[ci, 0:3] = pts.min(axis=0)
        cb[ci, 3:6] = pts.max(axis=0)
        cb[ci, 6] = 1.0
    bounds = np.zeros(8, np.float32)
    if t:
        bounds[0:3] = np.concatenate([va, vb, vc]).min(axis=0)
        bounds[3:6] = np.concatenate([va, vb, vc]).max(axis=0)
    else:
        bounds[3:6] = 1.0
    return {"bw_tris": tab, "bw_clusters": cb, "bw_bounds": bounds,
            "bw_ntris": np.int32(t)}


def cluster_levels(clust, first_row):
    """Levels 1..L of the implicit 8-ary tree over a range of cluster rows
    (`clust`, (C, 8) with lane 6 = valid), numbered from row `first_row` of
    the table they go into.  Returns (header, rows): the header row is
    [levels L, first row of level 1, ..., first row of level 7]; node j of
    level l covers clusters [8^l j, 8^l (j + 1)), its row is [lo(3), hi(3),
    valid, 0] with lo / hi the float32 min / max of its valid children's
    min(lo, hi) / max(lo, hi) (NaN kept), valid iff a child is.  Level l + 1
    exists while level l has more than 8 nodes; a range of <= 8 clusters has
    no level (an all-zero header: the walk decides its clusters directly)."""
    part = np.asarray(clust, np.float32)
    lo = np.minimum(part[:, 0:3], part[:, 3:6])
    hi = np.maximum(part[:, 0:3], part[:, 3:6])
    valid = part[:, 6] > 0.0
    head = np.zeros(CTREE_FLOATS, np.float32)
    out = []
    nrows = first_row
    level = 0
    while lo.shape[0] > WIDTH:
        level += 1
        if level >= CTREE_FLOATS:
            raise ValueError(f"{part.shape[0]} clusters need more than "
                             f"{CTREE_FLOATS - 1} tree levels")
        n = -(-lo.shape[0] // WIDTH)
        pad = n * WIDTH - lo.shape[0]
        v = np.pad(valid, (0, pad)).reshape(n, WIDTH, 1)
        group = lambda a: np.pad(a, ((0, pad), (0, 0))).reshape(n, WIDTH, 3)
        # invalid children take no part; NaN of a valid one is kept
        lo = np.where(v, group(lo), np.float32(np.inf)).min(axis=1)
        hi = np.where(v, group(hi), np.float32(-np.inf)).max(axis=1)
        valid = v.any(axis=(1, 2))
        lo[~valid] = 0.0
        hi[~valid] = 0.0
        rows = np.zeros((n, CTREE_FLOATS), np.float32)
        rows[:, 0:3], rows[:, 3:6] = lo, hi
        rows[:, 6] = valid
        head[level] = np.float32(nrows)
        out.append(rows)
        nrows += n
    head[0] = level
    rows = (np.concatenate(out) if out
            else np.zeros((0, CTREE_FLOATS), np.float32))
    return head, rows


def build_bw_ctree(bw_clusters):
    """`bw_ctree` (1 + N, 8) float32: the cluster tree the kernel walks,
    derived from `bw_clusters` alone (so also for tables built by the
    reference package): row 0 is the header of `cluster_levels` over all
    clusters, the N rows after it the tree's nodes."""
    head, rows = cluster_levels(bw_clusters, 1)
    return np.concatenate([head[None], rows]).astype(np.float32)


def ctree_rows(nclusters) -> int:
    """Rows of `build_bw_ctree` over `nclusters` clusters, from the count
    alone (what the wrapper checks without reading the table)."""
    rows, n = 1, int(nclusters)
    while n > WIDTH:
        n = -(-n // WIDTH)
        rows += n
    return rows


def _tri_test(row, mask_bit, ox, oy, oz, dx, dy, dz, tmin, bt):
    """One triangle row per lane ((N, 16) or (16,)) against N rays: returns
    (ok, tt, u, v) with the association of the reference's `_tri_test`."""
    (nx, ny, nz, d0, b1x, b1y, b1z, b1c, b2x, b2y, b2z, b2c, mbf) = (
        row[..., c] for c in range(13))
    vis = (mbf.to(torch.int32) & mask_bit) != 0
    m = (nx * ox + ny * oy) + (nz * oz + d0)
    k = nx * dx + ny * dy + nz * dz
    kz = is_zero(k)
    inv_k = torch.where(kz, torch.zeros_like(k),
                        1.0 / torch.where(kz, torch.ones_like(k), k))
    tt = -m * inv_k
    s1 = (b1x * ox + b1y * oy) + (b1z * oz + b1c)
    r1 = b1x * dx + b1y * dy + b1z * dz
    u = s1 + tt * r1
    s2 = (b2x * ox + b2y * oy) + (b2z * oz + b2c)
    r2 = b2x * dx + b2y * dy + b2z * dz
    v = s2 + tt * r2
    ok = (vis & ~kz & (u >= -_TOL) & (v >= -_TOL)
          & (u + v <= 1.0 + _TOL) & (tt >= tmin) & (tt <= bt))
    return ok, tt, u, v


def _sweep_plain(tables, org, d, tmin, tmax, mask_bit, any_hit, work=None):
    """Cluster-by-cluster sweep in table order, all rays at once.  `work`,
    when given, receives the counts of box and triangle tests these rays
    needed (`box_tests`, `tri_tests`)."""
    tris, clusters = tables["bw_tris"], tables["bw_clusters"]
    n = org.shape[0]
    dev = org.device
    f32 = dict(dtype=torch.float32, device=dev)
    tmin = torch.broadcast_to(torch.as_tensor(tmin, **f32), (n,))
    bt = torch.broadcast_to(torch.as_tensor(tmax, **f32), (n,)).clone()
    bu = torch.zeros(n, **f32)
    bv = torch.zeros(n, **f32)
    bi = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ox, oy, oz = org[:, 0], org[:, 1], org[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    ix, iy, iz = safe_inv(dx), safe_inv(dy), safe_inv(dz)
    mask_bit = int(mask_bit)
    cl_host = clusters.cpu()
    for c in range(clusters.shape[0]):
        if float(cl_host[c, 6]) <= 0.0:
            continue
        cb = clusters[c]
        t0x = (cb[0] - ox) * ix
        t1x = (cb[3] - ox) * ix
        t0y = (cb[1] - oy) * iy
        t1y = (cb[4] - oy) * iy
        t0z = (cb[2] - oz) * iz
        t1z = (cb[5] - oz) * iz
        near = torch.maximum(
            torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
            torch.maximum(torch.minimum(t0z, t1z), tmin))
        far = torch.minimum(
            torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
            torch.minimum(torch.maximum(t0z, t1z), bt))
        go = near <= far
        if any_hit:
            go = go & (bi < 0)
        if work is not None:
            work["box_tests"] = work.get("box_tests", 0) + n
            work["tri_tests"] = (work.get("tri_tests", 0)
                                 + TRI_TILE * int(go.sum()))
        for k in range(TRI_TILE):
            row = tris[c * TRI_TILE + k]
            ok, tt, u, v = _tri_test(row, mask_bit, ox, oy, oz, dx, dy, dz,
                                     tmin, bt)
            ok = ok & go
            bt = torch.where(ok, tt, bt)
            if not any_hit:
                bu = torch.where(ok, torch.clamp_min(u, 0.0), bu)
                bv = torch.where(ok, torch.clamp_min(v, 0.0), bv)
            bi = torch.where(ok, row[13].to(torch.int32), bi)
    return bt, bu, bv, bi


def bw_closest_plain(tables, org, d, tmin, tmax, mask_bit=0xF, work=None):
    """Plain PyTorch version of `bw_closest`: (t, u, v, prim)."""
    return _sweep_plain(tables, org, d, tmin, tmax, mask_bit, False, work)


def bw_any_plain(tables, org, d, tmin, tmax, mask_bit=0xF, work=None):
    """Plain PyTorch version of `bw_any`: bool per ray."""
    return _sweep_plain(tables, org, d, tmin, tmax, mask_bit, True,
                        work)[3] >= 0


# ------------------------------------------------- the kernel's walk, in torch
def _bump(work, key, v):
    if work is not None:
        work[key] = work.get(key, 0) + int(v)


def _slab(b, lo, hi, ox, oy, oz, ix, iy, iz, tmn):
    """Slab interval of box lanes b[..., lo:lo+3] / b[..., hi:hi+3]:
    (near, far without the best-t clip).  The reference's
    `near <= min(far, best)` equals `near <= far and near <= best`."""
    t0x = (b[..., lo + 0] - ox) * ix
    t1x = (b[..., hi + 0] - ox) * ix
    t0y = (b[..., lo + 1] - oy) * iy
    t1y = (b[..., hi + 1] - oy) * iy
    t0z = (b[..., lo + 2] - oz) * iz
    t1z = (b[..., hi + 2] - oz) * iz
    near = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.maximum(torch.minimum(t0z, t1z), tmn))
    far = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
        torch.maximum(t0z, t1z))
    return near, far


def _node_slab(b, ox, oy, oz, ix, iy, iz, tmn):
    """The kernels' node test without the best-t clip: an axis whose slab
    end is NaN constrains nothing, and NaN is dropped as fminf / fmaxf drop
    it.  Pass = near <= fmin(far, best)."""
    inf = torch.full_like(b[..., 0], float("inf"))
    a, e = [], []
    for ax, o, i in ((0, ox, ix), (1, oy, iy), (2, oz, iz)):
        t0, t1 = (b[..., ax] - o) * i, (b[..., ax + 3] - o) * i
        nan = torch.isnan(t0) | torch.isnan(t1)
        a.append(torch.where(nan, -inf, torch.fmin(t0, t1)))
        e.append(torch.where(nan, inf, torch.fmax(t0, t1)))
    return (torch.fmax(torch.fmax(a[0], a[1]), torch.fmax(a[2], tmn)),
            torch.fmin(torch.fmin(e[0], e[1]), e[2]))


def _aligned_level(c, levels):
    """Largest level <= `levels` whose nodes are aligned at cluster c > 0."""
    out = torch.zeros_like(c)
    for lev in range(1, CTREE_FLOATS):
        out = torch.where((c % (1 << (3 * lev)) == 0) & (lev <= levels),
                          torch.full_like(c, lev), out)
    return out


def _walk_clusters(tris, clust, ctree, levels, bases, cl0, ccnt, toff, ray,
                   tmn, best, mask_bit, any_hit, work):
    """The kernels' walk over a cluster tree (`csrc/cluster_walk.cuh`), one
    node or cluster a step for every lane at once.  Lane k walks clusters
    [cl0, cl0 + ccnt) of `clust` (their triangles from row toff of `tris`)
    under the tree of `ctree` with `levels[k]` levels starting at rows
    `bases[k]` (levels 1..7); ray = (ox, oy, oz, dx, dy, dz, ix, iy, iz),
    best = (t, u, v, row) at entry.  A node or cluster that fails is skipped
    (the walk goes on at the largest level aligned past it), a node that
    passes is descended into, a cluster that passes is entered and its eight
    triangles are tested in order against the running best.  Returns (t, u,
    v, row, hit): row is the triangle's row in `tris`, hit whether a triangle
    was accepted here.  `work` gets `node_tests`, `cluster_tests` (the boxes
    decided) and `tri_tests`."""
    ox, oy, oz, dx, dy, dz, ix, iy, iz = ray
    bt, bu, bv, bi = best
    k = ox.shape[0]
    dev = ox.device
    got = torch.zeros(k, dtype=torch.bool, device=dev)
    c = torch.zeros(k, dtype=torch.int64, device=dev)
    lev = levels.clone()
    while True:
        a = (c < ccnt).nonzero(as_tuple=True)[0]
        if a.shape[0] == 0:
            break
        la, ca = lev[a], c[a]
        sh = 3 * la
        j = ca >> sh
        node = la > 0
        nrow = bases[a, torch.clamp_min(la - 1, 0)] + j
        crow = cl0[a] + j
        box = torch.where(node[:, None],
                          ctree[torch.clamp(nrow, 0, ctree.shape[0] - 1)],
                          clust[torch.clamp(crow, 0, clust.shape[0] - 1)])
        r = lambda x: x[a]
        args = (r(ox), r(oy), r(oz), r(ix), r(iy), r(iz), r(tmn))
        n_near, n_far = _node_slab(box, *args)
        c_near, c_far = _slab(box, 0, 3, *args)
        bta = bt[a]
        valid = box[:, 6] > 0.0
        passed = valid & torch.where(
            node, n_near <= torch.fmin(n_far, bta),
            (c_near <= c_far) & (c_near <= bta))
        _bump(work, "node_tests", (valid & node).sum())
        _bump(work, "cluster_tests", (valid & ~node).sum())
        # a node that passes: its first child next, one level down
        down = passed & node
        lev[a[down]] -= 1
        # a cluster that passes: its eight triangles in order
        e = passed & ~node
        ae, je = a[e], j[e]
        hit = torch.zeros(ae.shape[0], dtype=torch.bool, device=dev)
        for kk in range(TRI_TILE):
            rows = torch.clamp_max(toff[ae] + je * TRI_TILE + kk,
                                   tris.shape[0] - 1)
            q = lambda x: x[ae]
            ok, tt, u, v = _tri_test(tris[rows], mask_bit, q(ox), q(oy),
                                     q(oz), q(dx), q(dy), q(dz), q(tmn),
                                     bt[ae])
            if any_hit:
                ok = ok & ~hit
            hit = hit | ok
            la_ = ae[ok]
            bt[la_] = tt[ok]
            if not any_hit:
                bu[la_] = torch.clamp_min(u[ok], 0.0)
                bv[la_] = torch.clamp_min(v[ok], 0.0)
            bi[la_] = rows[ok].to(torch.int32)
        got[ae[hit]] = True
        _bump(work, "tri_tests", TRI_TILE * ae.shape[0])
        # past a node or cluster that failed, or a cluster entered
        past = ~down
        ap = a[past]
        c[ap] = (j[past] + 1) << sh[past]
        lev[ap] = _aligned_level(c[ap], levels[ap])
        if any_hit:
            c[ae[hit]] = ccnt[ae[hit]]
    return bt, bu, bv, bi, got


def bw_walk_plain(tables, org, d, tmin, tmax, mask_bit=0xF, any_hit=False,
                  work=None):
    """The kernel's walk over `bw_ctree` in PyTorch: (t, u, v, prim) with
    prim the original id, -1 on miss; with `any_hit` a ray stops at its
    first hit and only `prim >= 0` is meaningful.  Bit-equal to
    `bw_closest_plain` (and, for any_hit, to `bw_any_plain`) while deciding
    fewer boxes; `work` gets `node_tests`, `cluster_tests` and `tri_tests`.
    For the tests only."""
    tris, clust, ctree = (tables[k] for k in ("bw_tris", "bw_clusters",
                                              "bw_ctree"))
    n = org.shape[0]
    dev = org.device
    f32 = dict(dtype=torch.float32, device=dev)
    full = lambda dtype, v: torch.full((n,), v, dtype=dtype, device=dev)
    tmn = torch.broadcast_to(torch.as_tensor(tmin, **f32), (n,))
    bt = torch.broadcast_to(torch.as_tensor(tmax, **f32), (n,)).clone()
    best = (bt, torch.zeros(n, **f32), torch.zeros(n, **f32),
            full(torch.int32, -1))
    ray = (org[:, 0], org[:, 1], org[:, 2], d[:, 0], d[:, 1], d[:, 2],
           safe_inv(d[:, 0]), safe_inv(d[:, 1]), safe_inv(d[:, 2]))
    head = ctree[0].long()
    bt, bu, bv, row, _ = _walk_clusters(
        tris, clust, ctree, head[0].expand(n), head[1:].expand(n, -1),
        full(torch.int64, 0), full(torch.int64, clust.shape[0]),
        full(torch.int64, 0), ray, tmn, best, int(mask_bit), any_hit, work)
    prim = torch.where(row >= 0, tris[row.long().clamp_min(0), 13].to(
        torch.int32), row)
    return bt, bu, bv, prim


def _launch(tables, org, d, tmin, tmax, mask_bit, any_hit):
    from ignis_tpu_torch import native
    org, d, tmin, tmax = native.check_rays(org, d, tmin, tmax)
    dev = org.device
    tris = native.check_table("bw_tris", tables["bw_tris"], 16, dev)
    clusters = native.check_table("bw_clusters", tables["bw_clusters"], 8,
                                  dev)
    if tris.shape[0] != clusters.shape[0] * TRI_TILE:
        raise ValueError("bw_tris / bw_clusters row counts disagree")
    if "bw_ctree" not in tables:
        raise ValueError("the kernel walks `bw_ctree`: set bw_ctree = "
                         "build_bw_ctree(bw_clusters) once")
    ctree = native.check_table("bw_ctree", tables["bw_ctree"], CTREE_FLOATS,
                               dev)
    if ctree.shape[0] != ctree_rows(clusters.shape[0]):
        raise ValueError(f"bw_ctree has {ctree.shape[0]} rows; the tree over "
                         f"{clusters.shape[0]} clusters has "
                         f"{ctree_rows(clusters.shape[0])}")
    n = org.shape[0]
    out_t, out_u, out_v, out_i = native.hit_outputs(n, dev)
    lib = native.library()
    with native.launch_guard(dev):
        err = lib.ignis_bw_intersect(
            tris.data_ptr(), clusters.data_ptr(), clusters.shape[0],
            ctree.data_ptr(), org.data_ptr(), d.data_ptr(), tmin.data_ptr(),
            tmax.data_ptr(), n, int(mask_bit), int(any_hit),
            out_t.data_ptr(), out_u.data_ptr(), out_v.data_ptr(),
            out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bw_intersect kernel launch failed: CUDA error "
                           f"{err}")
    return out_t, out_u, out_v, out_i


def bw_closest(tables, org, d, tmin, tmax, mask_bit=0xF):
    """Closest hit over the soup: (t, u, v, prim), prim -1 on miss.
    CUDA tensors go to the kernel, CPU tensors to the plain version."""
    if org.is_cuda:
        out = _launch(tables, org, d, tmin, tmax, mask_bit, False)
        if org.shape[0]:          # no rays: nothing is launched
            bw_closest.launches += 1
        return out
    return bw_closest_plain(tables, org, d, tmin, tmax, mask_bit)


def bw_any(tables, org, d, tmin, tmax, mask_bit=0xF):
    """Occlusion: True where any visible triangle blocks the segment."""
    if org.is_cuda:
        out = _launch(tables, org, d, tmin, tmax, mask_bit, True)
        if org.shape[0]:          # no rays: nothing is launched
            bw_any.launches += 1
        return out[3] >= 0
    return bw_any_plain(tables, org, d, tmin, tmax, mask_bit)


bw_closest.launches = 0
bw_any.launches = 0
