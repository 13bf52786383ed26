"""8-wide BVH traversal over the unified row table.

Counterpart of ignis_tpu/ops/pallas_bvh.py (a Pallas TPU kernel there); the
kernel here is hand-written CUDA, `csrc/packet_bvh.cu`.  Used for soups of
4096 triangles and more.

Host-side layout (built in `build_packet_bvh` from the binary SAH BVH of
ops/bvh.py), one dense (R, 128) float32 table:

* inner row: child c in [0,8): box slab at lanes [6c, 6c+6) as
  [min.xyz, max.xyz]; child row id at lane 64+c as an exact-integer float
  (MISSING_F = no child); lane 126 = 0.
* leaf row: 8 triangle records of 16 lanes:
  [v0.xyz, e1.xyz, e2.xyz, maskbits, orig_idx, pad x5]; degenerate fill has
  maskbits = 0; lane 126 = 1.  maskbits packs per-ray-class visibility (bit0
  camera, bit1 light, bit2 bounce, bit3 shadow) from the entity flags.

The intersection predicate matches ops/intersect.py `_mt_block`.  Each ray
walks the tree on its own: pop a row, test its 8 boxes or 8 triangles, push the
children whose slab interval crosses [tmin, best] in build order.  Among hits
at exactly equal t the last one tested wins; the reference kernel shares one
stack among 1024 rays and so tests in another order, which can pick the other
triangle of an exact tie and nothing else.

`packet_bvh_closest` / `packet_bvh_any` launch the CUDA kernel for tensors on
the card and run the plain PyTorch version (`packet_bvh_closest_plain` /
`packet_bvh_any_plain`) for tensors on the CPU.  The reference's coherence
sort of the rays is a remedy for its shared stack and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

LANES = 128
WIDTH = 8                     # children per node / triangles per leaf row
MISSING_F = np.float32(-1e9)  # child-slot sentinel in the enc lane
TYPE_LANE = 126               # row-type flag lane: 0 = inner, 1 = leaf
_TOL = -1.1920928955078125e-07

# ray-class bits of the packed per-triangle visibility mask, identical to the
# reference renderer's ray flags so a ray's flag value passes straight through
MASK_CAMERA = 0x1
MASK_LIGHT = 0x2
MASK_BOUNCE = 0x4
MASK_SHADOW = 0x8


# --------------------------------------------------------------------- build
def build_packet_bvh(bvh, tri_v0, tri_e1, tri_e2, ent_flags_per_tri):
    """Collapse a binary `ops.bvh.BVH` into the unified 8-wide row table.

    Children of an 8-wide node are gathered by repeatedly expanding the
    largest-subtree inner child; subtrees of <= 8 triangles collapse into a
    single 8-triangle leaf row (their tri_order range is contiguous by
    construction of the recursive SAH partition).

    ent_flags_per_tri: (T,) uint8 of reference visibility flags
    (camera=0x1, light=0x2, bounce=0x4, shadow=0x8) per ORIGINAL triangle.
    Returns dict of numpy arrays (pb_rows, pb_bounds, pb_depth).
    """
    order = np.asarray(bvh.tri_order)
    t = order.shape[0]
    if t >= (1 << 24):
        raise ValueError("packet BVH supports < 2^24 triangles per soup")
    v0 = np.asarray(tri_v0, np.float32)
    e1 = np.asarray(tri_e1, np.float32)
    e2 = np.asarray(tri_e2, np.float32)
    fl = np.asarray(ent_flags_per_tri, np.int64)
    maskbits = (fl & 0xF).astype(np.float32)

    nm, nx = bvh.node_min, bvh.node_max
    nl, nr, nc = bvh.node_left, bvh.node_right, bvh.node_count
    m = nm.shape[0]

    # subtree triangle counts + contiguous start offsets into tri_order
    size = np.zeros(m, np.int64)
    start = np.zeros(m, np.int64)
    st = [(0, False)] if m else []
    while st:
        b, done = st.pop()
        if nc[b] > 0:
            size[b] = nc[b]
            start[b] = nl[b]
        elif done:
            size[b] = size[nl[b]] + size[nr[b]]
            start[b] = min(start[nl[b]], start[nr[b]])
        else:
            st.append((b, True))
            st.append((int(nl[b]), False))
            st.append((int(nr[b]), False))

    # rows: list of ("inner", entries) | ("leaf", tri_index_array); inner
    # and leaf rows SHARE one index space (unified table)
    rows = []
    depth_of = {0: 1}   # 8-wide row depth (root = 1); single-row trees = 1

    def make_leaf(b):
        lo, n = int(start[b]), int(size[b])
        rows.append(("leaf", order[lo:lo + n]))
        return np.float32(len(rows) - 1)

    if t == 0 or m == 0:
        rows.append(("inner", []))
    elif nc[0] > 0 or size[0] <= WIDTH:
        # whole tree is one leaf row: synthesize a root pointing at it
        rows.append(None)
        rows[0] = ("inner", [(nm[0], nx[0], make_leaf(0))])
    else:
        row_of = {0: 0}
        rows.append(None)
        work = [0]
        while work:
            b = work.pop()
            kids = [int(nl[b]), int(nr[b])]
            while len(kids) < WIDTH:
                cand = [k for k in kids if nc[k] == 0 and size[k] > WIDTH]
                if not cand:
                    break
                big = max(cand, key=lambda k: size[k])
                kids.remove(big)
                kids += [int(nl[big]), int(nr[big])]
            entries = []
            for k in kids:
                if nc[k] > 0 or size[k] <= WIDTH:
                    entries.append((nm[k], nx[k], make_leaf(k)))
                else:
                    row_of[k] = len(rows)
                    depth_of[k] = depth_of[b] + 1
                    rows.append(None)
                    work.append(k)
                    entries.append((nm[k], nx[k], np.float32(row_of[k])))
            rows[row_of[b]] = ("inner", entries)

    tab = np.zeros((len(rows), LANES), np.float32)
    for ri, (kind, payload) in enumerate(rows):
        if kind == "inner":
            tab[ri, 64:64 + WIDTH] = MISSING_F
            for c, (bmin, bmax, enc) in enumerate(payload):
                tab[ri, 6 * c:6 * c + 3] = bmin
                tab[ri, 6 * c + 3:6 * c + 6] = bmax
                tab[ri, 64 + c] = enc
        else:
            tab[ri, TYPE_LANE] = 1.0
            for k, oi in enumerate(payload[:WIDTH]):
                oi = int(oi)
                o = 16 * k
                tab[ri, o:o + 3] = v0[oi]
                tab[ri, o + 3:o + 6] = e1[oi]
                tab[ri, o + 6:o + 9] = e2[oi]
                tab[ri, o + 9] = maskbits[oi] if maskbits.size else 7.0
                tab[ri, o + 10] = np.float32(oi)   # exact for oi < 2^24
            # record 7 pads end at lane 127; TYPE_LANE sits in that pad
            assert TYPE_LANE >= 16 * 7 + 11
    bounds = np.zeros(8, np.float32)
    if m:
        bounds[0:3] = nm[0]
        bounds[3:6] = nx[0]
    else:
        bounds[3:6] = 1.0
    return {"pb_rows": tab, "pb_bounds": bounds,
            "pb_depth": np.int32(max(depth_of.values()))}


def stack_entries(depth: int) -> int:
    """Stack a per-ray depth-first walk of a tree of `depth` 8-wide levels
    can need: one pop then up to 8 pushes per level."""
    return 7 * int(depth) + 1


# ------------------------------------------------------------- plain version
def _inv(x):
    z = x == 0.0
    return torch.where(z, torch.full_like(x, 1e30),
                       1.0 / torch.where(z, torch.ones_like(x), x))


def _traverse_plain(tables, org, d, tmin, tmax, mask_bit, any_hit, work=None):
    """Vectorised per-lane stack traversal: every live lane pops one row per
    round until all stacks are empty.  Lanes that finished are compacted
    away when fewer than half of the working set remain.  `work`, when given,
    receives what these rays needed: `inner_visits`, `leaf_visits` and
    `rows_touched` (distinct table rows read)."""
    rows = tables["pb_rows"]
    n = org.shape[0]
    dev = org.device
    f32 = dict(dtype=torch.float32, device=dev)
    mask_bit = int(mask_bit)
    depth = int(tables["pb_depth"]) if "pb_depth" in tables else 16
    cap = stack_entries(depth) + WIDTH

    out_t = torch.broadcast_to(torch.as_tensor(tmax, **f32), (n,)).clone()
    out_u = torch.zeros(n, **f32)
    out_v = torch.zeros(n, **f32)
    out_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if n == 0:
        return out_t, out_u, out_v, out_i
    tmin = torch.broadcast_to(torch.as_tensor(tmin, **f32), (n,))

    # working set (compacted as lanes finish)
    lane = torch.arange(n, device=dev)
    ox, oy, oz = org[:, 0], org[:, 1], org[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    ix, iy, iz = _inv(dx), _inv(dy), _inv(dz)
    tmn = tmin
    bt, bu, bv, bi = out_t.clone(), out_u.clone(), out_v.clone(), out_i.clone()
    stack = torch.zeros((n, cap), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)

    touched = (torch.zeros(rows.shape[0], dtype=torch.bool, device=dev)
               if work is not None else None)

    def flush():
        out_t[lane] = bt
        out_u[lane] = bu
        out_v[lane] = bv
        out_i[lane] = bi

    while True:
        active = sp > 0
        n_act = int(active.sum())
        if n_act == 0:
            break
        if n_act * 2 < lane.shape[0]:
            flush()
            keep = active
            (lane, ox, oy, oz, dx, dy, dz, ix, iy, iz, tmn, bt, bu, bv, bi,
             stack, sp) = (x[keep] for x in (
                 lane, ox, oy, oz, dx, dy, dz, ix, iy, iz, tmn, bt, bu, bv,
                 bi, stack, sp))
            active = sp > 0
        m = lane.shape[0]
        ar = torch.arange(m, device=dev)
        sp = torch.where(active, sp - 1, sp)
        rid = stack[ar, sp]
        r = rows[rid]                                   # (m, 128)
        is_leaf = active & (r[:, TYPE_LANE] > 0.5)
        is_inner = active & ~is_leaf
        if work is not None:
            work["inner_visits"] = (work.get("inner_visits", 0)
                                    + int(is_inner.sum()))
            work["leaf_visits"] = (work.get("leaf_visits", 0)
                                   + int(is_leaf.sum()))
            touched[rid[active]] = True

        # ---- leaf rows: 8 Moeller-Trumbore tests, in record order
        if bool(is_leaf.any()):
            for k in range(WIDTH):
                o = 16 * k
                v0x, v0y, v0z = r[:, o + 0], r[:, o + 1], r[:, o + 2]
                e1x, e1y, e1z = r[:, o + 3], r[:, o + 4], r[:, o + 5]
                e2x, e2y, e2z = r[:, o + 6], r[:, o + 7], r[:, o + 8]
                vis = (r[:, o + 9].to(torch.int32) & mask_bit) != 0
                oi = r[:, o + 10].to(torch.int32)
                nx = e1y * e2z - e1z * e2y
                ny = e1z * e2x - e1x * e2z
                nz = e1x * e2y - e1y * e2x
                cx = v0x - ox
                cy = v0y - oy
                cz = v0z - oz
                rx = dy * cz - dz * cy
                ry = dz * cx - dx * cz
                rz = dx * cy - dy * cx
                det = nx * dx + ny * dy + nz * dz
                dzr = det == 0.0
                inv_det = torch.where(
                    dzr, torch.zeros_like(det),
                    1.0 / torch.where(dzr, torch.ones_like(det), det))
                u = -(rx * e2x + ry * e2y + rz * e2z) * inv_det
                v = (rx * e1x + ry * e1y + rz * e1z) * inv_det
                w = 1.0 - u - v
                tt = (cx * nx + cy * ny + cz * nz) * inv_det
                ok = (is_leaf & vis & ~dzr & (u >= _TOL) & (v >= _TOL)
                      & (w >= _TOL) & (tt >= tmn) & (tt <= bt))
                if any_hit:
                    ok = ok & (bi < 0)
                bt = torch.where(ok, tt, bt)
                bu = torch.where(ok, torch.clamp_min(u, 0.0), bu)
                bv = torch.where(ok, torch.clamp_min(v, 0.0), bv)
                bi = torch.where(ok, oi, bi)
            if any_hit:
                sp = torch.where(bi >= 0, torch.zeros_like(sp), sp)

        # ---- inner rows: 8 slab tests, push passing children in build order
        for c in range(WIDTH):
            b = 6 * c
            t0x = (r[:, b + 0] - ox) * ix
            t1x = (r[:, b + 3] - ox) * ix
            t0y = (r[:, b + 1] - oy) * iy
            t1y = (r[:, b + 4] - oy) * iy
            t0z = (r[:, b + 2] - oz) * iz
            t1z = (r[:, b + 5] - oz) * iz
            near = torch.maximum(
                torch.maximum(torch.minimum(t0x, t1x),
                              torch.minimum(t0y, t1y)),
                torch.maximum(torch.minimum(t0z, t1z), tmn))
            far = torch.minimum(
                torch.minimum(torch.maximum(t0x, t1x),
                              torch.maximum(t0y, t1y)),
                torch.minimum(torch.maximum(t0z, t1z), bt))
            ev = r[:, 64 + c]
            push = is_inner & (near <= far) & (ev > float(MISSING_F) * 0.5)
            # in place: the stack is the largest tensor of the walk
            slot = torch.where(push, sp, torch.full_like(sp, cap - 1))
            stack[ar, slot] = torch.where(push, ev.to(torch.int64),
                                          stack[ar, slot])
            sp = sp + push.to(torch.int64)
    flush()
    if work is not None:
        work["rows_touched"] = int(touched.sum())
    return out_t, out_u, out_v, out_i


def packet_bvh_closest_plain(tables, org, d, tmin, tmax,
                             mask_bit=MASK_BOUNCE, work=None):
    """Plain PyTorch version of `packet_bvh_closest`: (t, u, v, prim)."""
    return _traverse_plain(tables, org, d, tmin, tmax, mask_bit, False, work)


def packet_bvh_any_plain(tables, org, d, tmin, tmax, mask_bit=MASK_SHADOW,
                         work=None):
    """Plain PyTorch version of `packet_bvh_any`: bool per ray."""
    return _traverse_plain(tables, org, d, tmin, tmax, mask_bit, True,
                           work)[3] >= 0


# ------------------------------------------------------------------- wrapper
def _launch(tables, org, d, tmin, tmax, mask_bit, any_hit):
    from ignis_tpu_torch import native
    org, d, tmin, tmax = native.check_rays(org, d, tmin, tmax)
    dev = org.device
    rows = native.check_table("pb_rows", tables["pb_rows"], LANES, dev)
    lib = native.library()
    need = stack_entries(int(tables["pb_depth"]))
    have = lib.ignis_packet_bvh_stack_entries()
    if need > have:
        raise ValueError(
            f"packet BVH of depth {int(tables['pb_depth'])} needs a "
            f"{need}-entry stack; the kernel was compiled with {have}")
    n = org.shape[0]
    out_t, out_u, out_v, out_i = native.hit_outputs(n, dev)
    with native.launch_guard(dev):
        err = lib.ignis_packet_bvh(
            rows.data_ptr(), org.data_ptr(), d.data_ptr(), tmin.data_ptr(),
            tmax.data_ptr(), n, int(mask_bit), int(any_hit),
            out_t.data_ptr(), out_u.data_ptr(), out_v.data_ptr(),
            out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"packet_bvh kernel launch failed: CUDA error "
                           f"{err}")
    return out_t, out_u, out_v, out_i


def packet_bvh_closest(tables, org, d, tmin, tmax, mask_bit=MASK_BOUNCE):
    """Closest hit: (t, u, v, prim) with prim = ORIGINAL tri index, -1 miss.
    CUDA tensors go to the kernel, CPU tensors to the plain version."""
    if org.is_cuda:
        out = _launch(tables, org, d, tmin, tmax, mask_bit, False)
        if org.shape[0]:          # no rays: nothing is launched
            packet_bvh_closest.launches += 1
        return out
    return packet_bvh_closest_plain(tables, org, d, tmin, tmax, mask_bit)


def packet_bvh_any(tables, org, d, tmin, tmax, mask_bit=MASK_SHADOW):
    """Occlusion query: True where any visible triangle blocks the segment."""
    if org.is_cuda:
        out = _launch(tables, org, d, tmin, tmax, mask_bit, True)
        if org.shape[0]:          # no rays: nothing is launched
            packet_bvh_any.launches += 1
        return out[3] >= 0
    return packet_bvh_any_plain(tables, org, d, tmin, tmax, mask_bit)


packet_bvh_closest.launches = 0
packet_bvh_any.launches = 0
