"""BVH build (host, binned SAH) and the per-lane stack traversal.

Counterpart of ignis_tpu/ops/bvh.py.  `BVH` and `build_bvh` yield the same
arrays for the same soup: a single-level world-space BVH over the flat
triangle soup (entity transforms are baked); binned SAH (16 bins, largest
axis, leaf <= 4).  It feeds `ops.packet_bvh.build_packet_bvh`, the cluster
order of `ops.bw_intersect.bw_tables` and `bvh_tables`.

`bvh_closest` / `bvh_any` walk the binary tree of `bvh_tables` with every
lane of the wave in lockstep: each lane owns a `STACK_DEPTH`-entry stack and
every loop iteration visits one node per lane (slab test, or a leaf's
batched Moeller-Trumbore test).  This is tensor code, not a kernel: the
reference computes it in XLA (`lax.while_loop`).  The loop runs while any
lane has a stack entry, one host sync an iteration, read through
`utils.stats.host_item`, which counts it (`calls` counts the calls).  The
reference's behaviour is kept as it is: a closest-hit lane pushes the far
child, then the near one (`lnear <= rnear` takes the left child as near);
an any-hit lane pushes right, then left; a full stack drops the entries it
cannot hold; ties in a leaf go to the lowest row; u and v are clamped at 0.
Zero tests count a subnormal as 0, as XLA on the CPU does (`ops.ref_float`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ignis_tpu_torch.core.vec import cross
from ignis_tpu_torch.ops.ref_float import is_zero, safe_inv
from ignis_tpu_torch.utils.stats import host_item

LEAF_SIZE = 4
STACK_DEPTH = 48
N_BINS = 16
_TOL = -1.1920928955078125e-07


@dataclass
class BVH:
    node_min: np.ndarray    # (M, 3)
    node_max: np.ndarray    # (M, 3)
    node_left: np.ndarray   # (M,) child idx (inner) or tri start (leaf)
    node_right: np.ndarray  # (M,) child idx (inner); unused for leaf
    node_count: np.ndarray  # (M,) 0 = inner, >0 = leaf tri count
    tri_order: np.ndarray   # (T,) permutation into the original soup


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
              leaf_size: int = LEAF_SIZE) -> BVH:
    t = v0.shape[0]
    if t == 0:
        return BVH(np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
                   np.zeros(1, np.int32), np.zeros(1, np.int32),
                   np.zeros(1, np.int32), np.zeros(0, np.int32))
    p0, p1, p2 = v0, v0 + e1, v0 + e2
    tri_min = np.minimum(np.minimum(p0, p1), p2).astype(np.float32)
    tri_max = np.maximum(np.maximum(p0, p1), p2).astype(np.float32)
    cent = (tri_min + tri_max) * 0.5

    order = np.arange(t, dtype=np.int32)
    node_min, node_max = [], []
    node_left, node_right, node_count = [], [], []

    def new_node():
        node_min.append(None)
        node_max.append(None)
        node_left.append(0)
        node_right.append(0)
        node_count.append(0)
        return len(node_min) - 1

    stack = [(new_node(), 0, t)]
    while stack:
        ni, lo, hi = stack.pop()
        idx = order[lo:hi]
        bmin = tri_min[idx].min(axis=0)
        bmax = tri_max[idx].max(axis=0)
        node_min[ni] = bmin
        node_max[ni] = bmax
        n = hi - lo
        if n <= leaf_size:
            node_left[ni] = lo
            node_count[ni] = n
            continue

        c = cent[idx]
        cmin = c.min(axis=0)
        cmax = c.max(axis=0)
        ext = cmax - cmin
        axis = int(np.argmax(ext))
        if ext[axis] <= 1e-12:
            # degenerate spread: median split
            mid = n // 2
            part = np.argsort(c[:, axis], kind="stable")
            order[lo:hi] = idx[part]
            split = lo + mid
        else:
            # binned SAH
            scale = N_BINS * (1.0 - 1e-6) / ext[axis]
            bins = np.minimum(((c[:, axis] - cmin[axis]) * scale).astype(np.int32),
                              N_BINS - 1)
            counts = np.bincount(bins, minlength=N_BINS)
            bin_min = np.full((N_BINS, 3), np.inf, np.float32)
            bin_max = np.full((N_BINS, 3), -np.inf, np.float32)
            for b in range(N_BINS):
                sel = bins == b
                if counts[b]:
                    bin_min[b] = tri_min[idx[sel]].min(axis=0)
                    bin_max[b] = tri_max[idx[sel]].max(axis=0)
            # prefix/suffix areas
            lmin = np.minimum.accumulate(bin_min, axis=0)
            lmax = np.maximum.accumulate(bin_max, axis=0)
            rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
            lcnt = np.cumsum(counts)
            rcnt = np.cumsum(counts[::-1])[::-1]

            def area(mn, mx):
                d = np.maximum(mx - mn, 0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            cost = (area(lmin, lmax)[:-1] * lcnt[:-1]
                    + area(rmin[1:], rmax[1:]) * rcnt[1:])
            cost = np.where((lcnt[:-1] == 0) | (rcnt[1:] == 0), np.inf, cost)
            best = int(np.argmin(cost))
            if not np.isfinite(cost[best]):
                mid = n // 2
                part = np.argsort(c[:, axis], kind="stable")
                order[lo:hi] = idx[part]
                split = lo + mid
            else:
                sel = bins <= best
                part = np.concatenate([np.nonzero(sel)[0], np.nonzero(~sel)[0]])
                order[lo:hi] = idx[part]
                split = lo + int(sel.sum())

        li = new_node()
        ri = new_node()
        node_left[ni] = li
        node_right[ni] = ri
        stack.append((ri, split, hi))
        stack.append((li, lo, split))

    return BVH(np.asarray(node_min, np.float32), np.asarray(node_max, np.float32),
               np.asarray(node_left, np.int32), np.asarray(node_right, np.int32),
               np.asarray(node_count, np.int32), order)


def bvh_tables(bvh: BVH, tables: dict) -> dict:
    """Attach the node tables and BVH-ordered copies of the geometry.

    Shading arrays (tri_n*, tri_uv*, tri_ent, ...) stay in the ORIGINAL order,
    so entity-contiguous ranges (area-light triangle spans) keep working; the
    traversal uses its own reordered v0/e1/e2 copies and maps hits back
    through `bvh_tri_to_orig`.  numpy in, numpy out; returns a new dict."""
    out = dict(tables)
    o = bvh.tri_order
    for k in ("tri_v0", "tri_e1", "tri_e2"):
        if k in tables and tables[k].shape[0] == o.shape[0]:
            out["bvh_" + k] = np.asarray(tables[k])[o]
        else:
            out["bvh_" + k] = np.zeros((max(1, o.shape[0]), 3), np.float32)
    out["bvh_node_min"] = bvh.node_min
    out["bvh_node_max"] = bvh.node_max
    out["bvh_node_left"] = bvh.node_left
    out["bvh_node_right"] = bvh.node_right
    out["bvh_node_count"] = bvh.node_count
    out["bvh_tri_to_orig"] = (o if o.size else np.zeros(1, np.int32))
    return out


def _slab(org, inv_d, tmin, tmax, bmin, bmax):
    """Ray / box slab test per lane: (near, far, hit).  NaN anywhere in a
    chain rejects the box (`torch.minimum` / `maximum` keep it)."""
    t0 = (bmin - org) * inv_d
    t1 = (bmax - org) * inv_d
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    near = torch.maximum(tn.amax(-1), tmin)
    far = torch.minimum(tf.amin(-1), tmax)
    return near, far, near <= far


def _dot(a, b):
    # summed in a fixed order, x + y then z, on the card as on the CPU
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def _mt_row(org, direction, tmin, tmax, v0, e1, e2):
    """Moeller-Trumbore of each lane's own triangle batch (N, L, 3):
    (t, u, v, ok), each (N, L); u and v clamped at 0."""
    o = org[:, None, :]
    d = direction[:, None, :]
    tn = cross(e1, e2)
    c = v0 - o
    r = cross(d, c)
    det = _dot(tn, d)
    z = is_zero(det)
    inv_det = torch.where(z, torch.zeros_like(det),
                          1.0 / torch.where(z, torch.ones_like(det), det))
    u = -_dot(r, e2) * inv_det
    v = _dot(r, e1) * inv_det
    w = 1.0 - u - v
    t = _dot(c, tn) * inv_det
    ok = (~z & (u >= _TOL) & (v >= _TOL) & (w >= _TOL)
          & (t >= tmin[:, None]) & (t <= tmax[:, None]))
    return t, torch.clamp_min(u, 0.0), torch.clamp_min(v, 0.0), ok


def _leaf_intersect(tables, start, count, org, d, tmin, best_t, leaf_size):
    """Each lane against up to `leaf_size` triangles at BVH rows
    [start, start + count): (hit, t, u, v, row) of the nearest one that is
    nearer than `best_t` (the lowest row among equal t)."""
    n = org.shape[0]
    offs = torch.arange(leaf_size, device=org.device)
    rows = start[:, None] + offs[None, :]               # (N, L)
    valid = offs[None, :] < count[:, None]
    rows = torch.clamp(rows, 0, tables["bvh_tri_v0"].shape[0] - 1)
    t, u, v, ok = _mt_row(org, d, tmin, best_t, tables["bvh_tri_v0"][rows],
                          tables["bvh_tri_e1"][rows],
                          tables["bvh_tri_e2"][rows])
    ok = ok & valid
    t_masked = torch.where(ok, t, torch.full_like(t, float("inf")))
    j = torch.argmin(t_masked, dim=1)
    lanes = torch.arange(n, device=org.device)
    tj = t_masked[lanes, j]
    return tj < best_t, tj, u[lanes, j], v[lanes, j], rows[lanes, j]


def _walk_setup(tables, org, d, tmin, tmax, tri_mask, stack_depth):
    """What both walks start from: lane tensors, the node tables as int64
    indices, each lane's stack with the root on it, and `tri_mask` moved to
    BVH row order."""
    n = org.shape[0]
    dev = org.device
    f32 = dict(dtype=torch.float32, device=dev)
    tmin = torch.broadcast_to(torch.as_tensor(tmin, **f32), (n,))
    tmax = torch.broadcast_to(torch.as_tensor(tmax, **f32), (n,)).clone()
    nodes = dict(min=tables["bvh_node_min"], max=tables["bvh_node_max"],
                 left=tables["bvh_node_left"].long(),
                 right=tables["bvh_node_right"].long(),
                 count=tables["bvh_node_count"].long())
    if tri_mask is not None:
        tri_mask = tri_mask[tables["bvh_tri_to_orig"].long()]
    stack = torch.zeros((n, stack_depth), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)   # the root, node 0
    return tmin, tmax, nodes, tri_mask, stack, sp, safe_inv(d)


def _masked(lhit, lrow, tri_mask):
    if tri_mask is None:
        return lhit
    return lhit & tri_mask[torch.clamp(lrow, 0, tri_mask.shape[0] - 1)]


def _push(stack, sp, lanes, push, node, stack_depth):
    """Push `node` on the lanes of `push`; a full stack overwrites its top
    slot and keeps its size (the reference drops the entry)."""
    slot = torch.clamp_max(sp, stack_depth - 1)
    stack[lanes, slot] = torch.where(push, node, stack[lanes, slot])
    return torch.where(push, torch.clamp_max(sp + 1, stack_depth), sp)


def bvh_closest(tables, org, d, tmin, tmax, tri_mask=None,
                leaf_size=LEAF_SIZE, stack_depth=STACK_DEPTH):
    """Closest hit via the per-lane short-stack walk: (t, u, v, prim) with
    prim the ORIGINAL triangle index, -1 on a miss.  `tri_mask` (T,) bool,
    in original order, disables triangles."""
    bvh_closest.calls += 1
    n = org.shape[0]
    dev = org.device
    tmin, best_t, nd, tri_mask, stack, sp, inv_d = _walk_setup(
        tables, org, d, tmin, tmax, tri_mask, stack_depth)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
    lanes = torch.arange(n, device=dev)
    last = nd["min"].shape[0] - 1
    while True:
        if not host_item((sp > 0).any()):
            break
        active = sp > 0
        node = stack[lanes, torch.clamp_min(sp - 1, 0)]
        sp = torch.where(active, sp - 1, sp)
        _, _, box_hit = _slab(org, inv_d, tmin, best_t, nd["min"][node],
                              nd["max"][node])
        box_hit = box_hit & active
        count = nd["count"][node]
        is_leaf = count > 0
        left = nd["left"][node]
        right = nd["right"][node]

        # ---- leaf: batched triangle tests
        do_leaf = box_hit & is_leaf
        lhit, lt, lu, lv, lrow = _leaf_intersect(
            tables, left, torch.where(do_leaf, count, torch.zeros_like(count)),
            org, d, tmin, best_t, leaf_size)
        lhit = _masked(lhit, lrow, tri_mask)
        best_u = torch.where(lhit, lu, best_u)
        best_v = torch.where(lhit, lv, best_v)
        best_i = torch.where(lhit, lrow, best_i)
        best_t = torch.where(lhit, lt, best_t)

        # ---- inner: push the children, the near one on top (a leaf's
        # `left` is a triangle row: clamped, its slab results unused)
        do_inner = box_hit & ~is_leaf
        lc, rc = torch.clamp_max(left, last), torch.clamp_max(right, last)
        lnear, _, lhitb = _slab(org, inv_d, tmin, best_t, nd["min"][lc],
                                nd["max"][lc])
        rnear, _, rhitb = _slab(org, inv_d, tmin, best_t, nd["min"][rc],
                                nd["max"][rc])
        left_first = lnear <= rnear
        first = torch.where(left_first, left, right)
        second = torch.where(left_first, right, left)
        first_hit = torch.where(left_first, lhitb, rhitb) & do_inner
        second_hit = torch.where(left_first, rhitb, lhitb) & do_inner
        sp = _push(stack, sp, lanes, second_hit, second, stack_depth)
        sp = _push(stack, sp, lanes, first_hit, first, stack_depth)
    to_orig = tables["bvh_tri_to_orig"].long()
    prim = torch.where(best_i >= 0, to_orig[torch.clamp_min(best_i, 0)],
                       torch.full_like(best_i, -1))
    return best_t, best_u, best_v, prim.to(torch.int32)


def bvh_any(tables, org, d, tmin, tmax, tri_mask=None,
            leaf_size=LEAF_SIZE, stack_depth=STACK_DEPTH):
    """Occlusion query: bool per lane.  A lane that found a hit drops the
    rest of its stack at the next iteration."""
    bvh_any.calls += 1
    n = org.shape[0]
    dev = org.device
    tmin, tmax_b, nd, tri_mask, stack, sp, inv_d = _walk_setup(
        tables, org, d, tmin, tmax, tri_mask, stack_depth)
    occluded = torch.zeros(n, dtype=torch.bool, device=dev)
    lanes = torch.arange(n, device=dev)
    last = nd["min"].shape[0] - 1
    while True:
        if not host_item((sp > 0).any()):
            break
        active = (sp > 0) & ~occluded
        sp = torch.where(occluded, torch.zeros_like(sp), sp)
        node = stack[lanes, torch.clamp_min(sp - 1, 0)]
        sp = torch.where(active, sp - 1, sp)
        _, _, box_hit = _slab(org, inv_d, tmin, tmax_b, nd["min"][node],
                              nd["max"][node])
        box_hit = box_hit & active
        count = nd["count"][node]
        is_leaf = count > 0
        left = nd["left"][node]
        right = nd["right"][node]

        do_leaf = box_hit & is_leaf
        lhit, _, _, _, lrow = _leaf_intersect(
            tables, left, torch.where(do_leaf, count, torch.zeros_like(count)),
            org, d, tmin, tmax_b, leaf_size)
        occluded = occluded | _masked(lhit, lrow, tri_mask)

        do_inner = box_hit & ~is_leaf
        for child in (right, left):
            cc = torch.clamp_max(child, last)
            _, _, chit = _slab(org, inv_d, tmin, tmax_b, nd["min"][cc],
                               nd["max"][cc])
            sp = _push(stack, sp, lanes, do_inner & chit & ~occluded, child,
                       stack_depth)
    return occluded


bvh_closest.calls = 0
bvh_any.calls = 0
