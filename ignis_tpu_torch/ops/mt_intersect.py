"""Moeller-Trumbore sweep over a whole triangle soup, no acceleration.

Counterpart of ignis_tpu/ops/pallas_intersect.py (two Pallas TPU kernels
there); the kernel here is hand-written CUDA, `csrc/mt_intersect.cu`.  It is
the path of tables that carry neither `bw_tris` nor `pb_rows`.

Every ray is tested against every triangle in ascending order with

  n = e1 x e2, c = v0 - o, r = d x c, det = n.d, inv = 1/det (0 if det == 0)
  u = -(r.e2) inv, v = (r.e1) inv, w = 1 - u - v, t = (c.n) inv

and a hit is accepted when det != 0, u, v, w >= -2^-23, tmin <= t <= best
and the triangle's flag in `tri_mask` (a bool per triangle, or None) is set.
`t <= best` in ascending order means that among equal t the HIGHEST triangle
index wins; `ops.intersect` (argmin over chunks) takes the lowest and sums
with `torch.sum`, so it is the oracle these functions are held against, not
their plain version.

`mt_closest` / `mt_any` launch the CUDA kernel for tensors on the card and
run the plain PyTorch version (`mt_closest_plain` / `mt_any_plain`) for
tensors on the CPU.  The triangle tensors are read as they are on every call:
nothing is packed or cached, so a table changed in place is seen at once.

How the kernel is laid out (the source's header has the whole account):

- A pair is rejected after c, r, det, U' = -(r.e2), V' = r.e1, before the
  division, when those alone prove that u, v or w fails its test;
  `_mt_reject` is that predicate in plain PyTorch, term by term, for the
  tests (`rejected => not inside`).  Only un-rejected pairs run the full
  sequence, so the accepted hit's t, u, v are the plain version's bits.
- A block takes 512 rays (four a thread) and one range of whole
  128-triangle tiles; the launch sizes the ranges from the ray count so
  that there are several blocks for each multiprocessor, also at a few
  thousand rays (`_tiles_per_range` is that rule in Python, for the tests).
- Ranges combine through an atomic minimum on a 64-bit key per ray
  (`_mt_key`: smaller t first, among equal t the higher index); the wrapper
  allocates the keys, the launch initialises them, and a second small kernel
  decodes the winner and recomputes its t, u, v.  Any-hit sets one byte per
  occluded ray, which is the returned bool tensor.
"""

from __future__ import annotations

import torch

_TOL = -1.1920928955078125e-07
_CHUNK = 256          # triangles per (rays, chunk) block of the plain version
_REJ_UV = 2.0 ** -20  # margins of the kernel's early rejection
_REJ_W = 1.0 + 2.0 ** -16


def _lanes(x, n, dev):
    return torch.broadcast_to(
        torch.as_tensor(x, dtype=torch.float32, device=dev), (n,))


def _mt_chunk(org, d, v0, e1, e2):
    """`_mt_loop`'s arithmetic for (N,) rays x (C,) triangles -> (N, C):
    (t, u, v, inside) with products and sums grouped as the kernel has them."""
    ox, oy, oz = (org[:, c, None] for c in range(3))
    dx, dy, dz = (d[:, c, None] for c in range(3))
    v0x, v0y, v0z = (v0[None, :, c] for c in range(3))
    e1x, e1y, e1z = (e1[None, :, c] for c in range(3))
    e2x, e2y, e2z = (e2[None, :, c] for c in range(3))
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    cx, cy, cz = v0x - ox, v0y - oy, v0z - oz
    rx = dy * cz - dz * cy
    ry = dz * cx - dx * cz
    rz = dx * cy - dy * cx
    det = nx * dx + ny * dy + nz * dz
    zero = det == 0.0
    inv_det = torch.where(zero, torch.zeros_like(det),
                          1.0 / torch.where(zero, torch.ones_like(det), det))
    u = -(rx * e2x + ry * e2y + rz * e2z) * inv_det
    v = (rx * e1x + ry * e1y + rz * e1z) * inv_det
    w = 1.0 - u - v
    t = (cx * nx + cy * ny + cz * nz) * inv_det
    inside = ~zero & (u >= _TOL) & (v >= _TOL) & (w >= _TOL)
    return t, u, v, inside


def _mt_reject(org, d, v0, e1, e2):
    """The kernel's early rejection for (N,) rays x (C,) triangles -> (N, C)
    bool, operation by operation as `mt_reject` in `csrc/mt_intersect.cu` has
    it.  True means the kernel skips the pair; it must imply `not inside` of
    `_mt_chunk`.  Used by the tests only."""
    ox, oy, oz = (org[:, c, None] for c in range(3))
    dx, dy, dz = (d[:, c, None] for c in range(3))
    v0x, v0y, v0z = (v0[None, :, c] for c in range(3))
    e1x, e1y, e1z = (e1[None, :, c] for c in range(3))
    e2x, e2y, e2z = (e2[None, :, c] for c in range(3))
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    cx, cy, cz = v0x - ox, v0y - oy, v0z - oz
    rx = dy * cz - dz * cy
    ry = dz * cx - dx * cz
    rz = dx * cy - dy * cx
    det = nx * dx + ny * dy + nz * dz
    up = -(rx * e2x + ry * e2y + rz * e2z)
    vp = rx * e1x + ry * e1y + rz * e1z
    # xor with det's sign bit: negation flips exactly that bit
    neg = torch.signbit(det)
    us = torch.where(neg, -up, up)
    vs = torch.where(neg, -vp, vp)
    a = det.abs()
    m = -(a * _REJ_UV)
    return (us < m) | (vs < m) | (us + vs > a * _REJ_W)


def _mt_key(t, index):
    """The kernel's 64-bit key of a hit, in numpy (uint64): ordering keys
    orders hits by t ascending and, among equal t (-0.0 equals +0.0), by
    index descending.  Used by the tests only."""
    import numpy as np
    t = np.asarray(t, dtype=np.float32)
    b = np.where(t == 0, np.uint32(0), t.view(np.uint32)).astype(np.uint32)
    b = np.where(b & np.uint32(0x80000000), ~b, b | np.uint32(0x80000000))
    low = np.uint32(0xFFFFFFFF) - np.asarray(index).astype(np.uint32)
    return (b.astype(np.uint64) << np.uint64(32)) | low.astype(np.uint64)


def _tiles_per_range(n, ntris, sms, rays_per_block, tile, blocks_per_sm):
    """Tiles of the soup a block sweeps, as `ignis_mt_intersect` sizes them:
    as few ranges as give a launch over n rays `blocks_per_sm` blocks for
    each of `sms` multiprocessors.  Used by the tests only."""
    ray_blocks = -(-n // rays_per_block)
    tiles = -(-ntris // tile)
    ranges = min(tiles, max(1, -(-blocks_per_sm * sms // ray_blocks)))
    return -(-tiles // ranges)


def _sweep_plain(org, d, tmin, tmax, v0, e1, e2, tri_mask, any_hit):
    """The ascending sweep, a chunk of triangles at a time.  Accepting every
    inside hit with t <= best in order leaves the smallest t, at the last
    index that reaches it; a chunk takes exactly that from its (N, C) block,
    and `<=` between chunks lets a later chunk's equal t win.  With `any_hit`
    a ray stops at its first inside hit in [tmin, tmax] and only its index is
    kept."""
    n = org.shape[0]
    dev = org.device
    tmin = _lanes(tmin, n, dev)
    bt = _lanes(tmax, n, dev).clone()
    bu = torch.zeros(n, dtype=torch.float32, device=dev)
    bv = torch.zeros(n, dtype=torch.float32, device=dev)
    bi = torch.full((n,), -1, dtype=torch.int32, device=dev)
    inf = float("inf")
    for lo in range(0, v0.shape[0], _CHUNK):
        hi = min(lo + _CHUNK, v0.shape[0])
        t, u, v, ok = _mt_chunk(org, d, v0[lo:hi], e1[lo:hi], e2[lo:hi])
        ok = ok & (t >= tmin[:, None]) & (t <= bt[:, None])
        if tri_mask is not None:
            ok = ok & tri_mask[None, lo:hi]
        idx = torch.arange(hi - lo, device=dev)[None, :]
        if any_hit:
            # a ray stops at its first hit: keep that triangle's index
            first = torch.where(ok, idx, torch.full_like(idx, hi)).amin(dim=1)
            bi = torch.where((first < hi) & (bi < 0),
                             (lo + first).to(torch.int32), bi)
            continue
        tm = torch.where(ok, t, torch.full_like(t, inf))
        best = tm.amin(dim=1)
        j = torch.where(ok & (tm == best[:, None]), idx,
                        torch.full_like(idx, -1)).amax(dim=1)
        hit = j >= 0
        jc = torch.clamp_min(j, 0)[:, None]
        bt = torch.where(hit, best, bt)
        bu = torch.where(hit, torch.clamp_min(u.gather(1, jc)[:, 0], 0.0), bu)
        bv = torch.where(hit, torch.clamp_min(v.gather(1, jc)[:, 0], 0.0), bv)
        bi = torch.where(hit, (lo + j).to(torch.int32), bi)
    return bt, bu, bv, bi


def mt_closest_plain(org, d, tmin, tmax, v0, e1, e2, tri_mask=None):
    """Plain PyTorch version of `mt_closest`: (t, u, v, prim)."""
    return _sweep_plain(org, d, tmin, tmax, v0, e1, e2, tri_mask, False)


def mt_any_plain(org, d, tmin, tmax, v0, e1, e2, tri_mask=None):
    """Plain PyTorch version of `mt_any`: bool per ray."""
    return _sweep_plain(org, d, tmin, tmax, v0, e1, e2, tri_mask,
                        True)[3] >= 0


def _launch(org, d, tmin, tmax, v0, e1, e2, tri_mask, any_hit):
    """Launch the sweep: (t, u, v, prim) or, with `any_hit`, the bool per ray.
    Returns None when there is nothing to launch (no rays or no triangles)."""
    from ignis_tpu_torch import native
    org, d, tmin, tmax = native.check_rays(org, d, tmin, tmax)
    dev = org.device
    t = v0.shape[0]
    for name, x in (("v0", v0), ("e1", e1), ("e2", e2)):
        if (x.device != dev or x.dtype != torch.float32
                or x.shape != (t, 3) or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 ({t}, 3) "
                             f"tensor on {dev}")
    mask_ptr = None
    if tri_mask is not None:
        if (tri_mask.device != dev or tri_mask.dtype != torch.bool
                or tri_mask.shape != (t,)):
            raise ValueError(f"tri_mask must be a bool ({t},) tensor on "
                             f"{dev}")
        tri_mask = tri_mask.contiguous()
        mask_ptr = tri_mask.data_ptr()
    n = org.shape[0]
    if n == 0 or t == 0:
        return None
    lib = native.library()
    if any_hit:
        work = out = torch.empty(n, dtype=torch.bool, device=dev)
        ptrs = (None,) * 4
    else:
        work = torch.empty(n, dtype=torch.int64, device=dev)
        out = native.hit_outputs(n, dev)
        ptrs = tuple(x.data_ptr() for x in out)
    with native.launch_guard(dev):
        err = lib.ignis_mt_intersect(
            v0.data_ptr(), e1.data_ptr(), e2.data_ptr(), mask_ptr, t,
            org.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
            n, int(any_hit), work.data_ptr(), *ptrs,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mt_intersect kernel launch failed: CUDA error "
                           f"{err}")
    return out


def _misses(org, tmax):
    """What a sweep over nothing returns: prim -1 and t = tmax."""
    n, dev = org.shape[0], org.device
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    return (_lanes(tmax, n, dev).clone(), zero, zero.clone(),
            torch.full((n,), -1, dtype=torch.int32, device=dev))


def mt_closest(org, d, tmin, tmax, v0, e1, e2, tri_mask=None):
    """Closest hit over the soup: (t, u, v, prim), prim -1 on miss.
    CUDA tensors go to the kernel, CPU tensors to the plain version."""
    if org.is_cuda:
        out = _launch(org, d, tmin, tmax, v0, e1, e2, tri_mask, False)
        if out is None:           # no rays or no triangles: nothing launched
            return _misses(org, tmax)
        mt_closest.launches += 1
        return out
    return mt_closest_plain(org, d, tmin, tmax, v0, e1, e2, tri_mask)


def mt_any(org, d, tmin, tmax, v0, e1, e2, tri_mask=None):
    """Occlusion: True where any visible triangle blocks the segment."""
    if org.is_cuda:
        out = _launch(org, d, tmin, tmax, v0, e1, e2, tri_mask, True)
        if out is None:           # no rays or no triangles: nothing launched
            return torch.zeros(org.shape[0], dtype=torch.bool,
                               device=org.device)
        mt_any.launches += 1
        return out
    return mt_any_plain(org, d, tmin, tmax, v0, e1, e2, tri_mask)


mt_closest.launches = 0
mt_any.launches = 0
