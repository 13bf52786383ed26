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
run the plain PyTorch version (`bw_closest_plain` / `bw_any_plain`) for
tensors on the CPU.  Both decide the cluster skip per ray, from that ray's own
[tmin, best] window, so they agree bit for bit; the reference kernel decides
it per 1024-ray block, which can differ only for a hit that lies within
rounding of a cluster box face.
"""

from __future__ import annotations

import numpy as np
import torch

from ignis_tpu_torch.ops.ref_float import is_zero, safe_inv

TRI_TILE = 8
_TOL = 1.1920928955078125e-07


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


def _launch(tables, org, d, tmin, tmax, mask_bit, any_hit):
    from ignis_tpu_torch import native
    org, d, tmin, tmax = native.check_rays(org, d, tmin, tmax)
    dev = org.device
    tris = native.check_table("bw_tris", tables["bw_tris"], 16, dev)
    clusters = native.check_table("bw_clusters", tables["bw_clusters"], 8,
                                  dev)
    if tris.shape[0] != clusters.shape[0] * TRI_TILE:
        raise ValueError("bw_tris / bw_clusters row counts disagree")
    n = org.shape[0]
    out_t, out_u, out_v, out_i = native.hit_outputs(n, dev)
    lib = native.library()
    with native.launch_guard(dev):
        err = lib.ignis_bw_intersect(
            tris.data_ptr(), clusters.data_ptr(), clusters.shape[0],
            org.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
            n, int(mask_bit), int(any_hit), out_t.data_ptr(),
            out_u.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
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
