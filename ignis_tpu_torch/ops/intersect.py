"""Ray/triangle intersection in plain torch: chunked Moeller-Trumbore.

Counterpart of ignis_tpu/ops/intersect.py.  It is the oracle the traversal
kernels are held against, and the path `render.integrator` takes when the
tables carry neither `bw_tris` nor `pb_rows`.  Peak memory is bounded at
(n_rays, CHUNK) whatever the scene size.  Direction vectors need not be
normalized (shadow rays are traced unnormalized with tmax = 1 - eps).
"""

from __future__ import annotations

import torch

CHUNK = 512
_TOL = -1.1920928955078125e-07


def _effective_chunk(t, chunk):
    """Shrink the chunk for tiny scenes so padding stays bounded."""
    r = max(8, -(-t // 8) * 8)
    return min(chunk, r)


def _as_lanes(x, n, like):
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=torch.float32, device=like.device)
    return torch.broadcast_to(x.to(torch.float32), (n,))


def _chunks(v0, e1, e2, tri_mask, chunk):
    """Yield (offset, v0, e1, e2, mask) per chunk; the ragged tail is simply
    shorter (the reference pads it with never-hit degenerate triangles)."""
    t = v0.shape[0]
    for lo in range(0, t, chunk):
        hi = min(lo + chunk, t)
        m = None if tri_mask is None else tri_mask[lo:hi]
        yield lo, v0[lo:hi], e1[lo:hi], e2[lo:hi], m


def intersect_closest(org, direction, tmin, tmax, v0, e1, e2, tri_mask=None,
                      chunk=CHUNK):
    """Closest hit over all triangles: (t, u, v, prim) with prim -1 on miss.

    Barycentric inside test with a 2^-23 tolerance and t in [tmin, tmax];
    `tri_mask` (T,) bool disables triangles (per-ray-class visibility).
    Among equal t the lowest triangle index wins.
    """
    n = org.shape[0]
    chunk = _effective_chunk(v0.shape[0], chunk)
    tmin = _as_lanes(tmin, n, org)
    best_t = _as_lanes(tmax, n, org).clone()
    best_u = torch.zeros(n, dtype=torch.float32, device=org.device)
    best_v = torch.zeros(n, dtype=torch.float32, device=org.device)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=org.device)
    rows = torch.arange(n, device=org.device)
    for coff, cv0, ce1, ce2, cmask in _chunks(v0, e1, e2, tri_mask, chunk):
        t, u, v, ok = _mt_block(org, direction, tmin, best_t, cv0, ce1, ce2)
        if cmask is not None:
            ok = ok & cmask[None, :]
        t_masked = torch.where(ok, t, torch.full_like(t, float("inf")))
        j = torch.argmin(t_masked, dim=1)
        tj = t_masked[rows, j]
        hit = tj < best_t
        best_u = torch.where(hit, u[rows, j], best_u)
        best_v = torch.where(hit, v[rows, j], best_v)
        best_i = torch.where(hit, (coff + j).to(torch.int32), best_i)
        best_t = torch.where(hit, tj, best_t)
    return best_t, best_u, best_v, best_i


def intersect_any(org, direction, tmin, tmax, v0, e1, e2, tri_mask=None,
                  chunk=CHUNK):
    """Any-hit (occlusion) test: bool per ray."""
    n = org.shape[0]
    chunk = _effective_chunk(v0.shape[0], chunk)
    tmin = _as_lanes(tmin, n, org)
    tmax = _as_lanes(tmax, n, org)
    occ = torch.zeros(n, dtype=torch.bool, device=org.device)
    for _, cv0, ce1, ce2, cmask in _chunks(v0, e1, e2, tri_mask, chunk):
        _, _, _, ok = _mt_block(org, direction, tmin, tmax, cv0, ce1, ce2)
        if cmask is not None:
            ok = ok & cmask[None, :]
        occ = occ | ok.any(dim=1)
    return occ


def _mt_block(org, direction, tmin, tmax, v0, e1, e2):
    """Moeller-Trumbore for (N,3) rays x (C,3) triangles -> (N,C) results.

    Edges are standard (e1 = v1-v0, e2 = v2-v0); (u, v) weight vertices 1
    and 2.
    """
    o = org[:, None, :]
    d = direction[:, None, :]
    tv0 = v0[None, :, :]
    te1 = e1[None, :, :]
    te2 = e2[None, :, :]
    tn = torch.linalg.cross(te1, te2, dim=-1)
    c = tv0 - o
    r = torch.linalg.cross(*torch.broadcast_tensors(d, c), dim=-1)
    det = torch.sum(tn * d, dim=-1)
    zero = det == 0.0
    inv_det = torch.where(zero, torch.zeros_like(det),
                          1.0 / torch.where(zero, torch.ones_like(det), det))
    u = -torch.sum(r * te2, dim=-1) * inv_det
    v = torch.sum(r * te1, dim=-1) * inv_det
    w = 1.0 - u - v
    t = torch.sum(c * tn, dim=-1) * inv_det
    ok = (~zero & (u >= _TOL) & (v >= _TOL) & (w >= _TOL)
          & (t >= tmin[:, None]) & (t <= tmax[:, None]))
    return t, torch.clamp_min(u, 0.0), torch.clamp_min(v, 0.0), ok
