"""BVH build (host, binned SAH).

Counterpart of the host half of ignis_tpu/ops/bvh.py: `BVH` and `build_bvh`
yield the same arrays for the same soup.  A single-level world-space BVH over
the flat triangle soup (entity transforms are baked); binned SAH (16 bins,
largest axis, leaf <= 4).  It feeds `ops.packet_bvh.build_packet_bvh` and the
cluster order of `ops.bw_intersect.bw_tables`.  The per-lane stack traversal
of the reference module (`bvh_tables`, `bvh_closest`, `bvh_any`) is not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LEAF_SIZE = 4
N_BINS = 16


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
