"""Two-level instanced traversal: a top BVH over instances, shared local
triangle clusters below it.

Counterpart of ignis_tpu/ops/bw_tlas.py (a Pallas TPU kernel there); the
kernel here is hand-written CUDA, `csrc/tlas.cu`.

A shape used by several entities is stored once, in its own local space, as
Baldwin-Weber rows grouped into 8-triangle clusters with an AABB each
(`ops.bw_intersect.bw_tables`); every instance is a record of a world box, a
world->local 3x4 and the slice of the pool its shape owns.  A ray walks an
8-wide BVH over the instances' world boxes; in every instance whose box its
[tmin, best] window crosses it is taken to local space by the 3x4 (the
direction is NOT normalised, so local t == world t and the best hit needs no
rescaling) and sweeps that shape's clusters: box test, then eight triangle
tests.  N instances of a mesh cost N records, not N meshes.

Tables (all float32, equal to the reference package's):
  tl_tris  (Tp, 16)  pooled local Baldwin-Weber rows, shapes concatenated
  tl_clust (Cp, 8)   pooled local cluster boxes, lane 6 = valid
  tl_shade (Tp, 28)  pooled LOCAL shading rows (v0|e1|e2|n0|n1|n2|uv0|uv1|uv2)
  tl_inst  (I, 32)   world box (6), valid, cluster offset, cluster count,
                     row offset, toLocal 3x4 (12), entity, visibility bits
  tl_norm  (I, 24)   normal matrix (9), |det toWorld|, toWorld 3x4 (12)
  tl_top   (R, 128)  8-wide BVH rows; inner: child boxes at lanes [6c, 6c+6),
                     child row at 64+c (-1e9 = none); leaf: lanes 0..7 =
                     instance ids, -1 = empty; lane 126 = row type
plus `tl_depth`, the depth of `tl_top`, which sizes the per-ray stack, and
the port's own `tl_ctree` (`build_cluster_tree`, derived from `tl_clust` and
`tl_inst`): per instance a header, then an implicit 8-ary tree of boxes over
each shape's clusters, which the kernel walks in place of the dense sweep.

`tlas_closest` / `tlas_any` (and `tlas_traverse`, the reference's signature)
launch the CUDA kernel for tensors on the card and run the plain PyTorch
version for tensors on the CPU.  The plain version sweeps every cluster of an
entered instance; the kernel skips the subtrees of `tl_ctree` whose box the
ray's window misses, which changes no decision (`csrc/cluster_walk.cuh` has the
argument, `cluster_walk_plain` is the same walk in PyTorch for the tests).
Both decide per ray whether to enter an instance, enter a cluster and push a
child, from that ray's own [tmin, best] window; the reference decides each of them for a block of 1024 rays at once,
which can differ only for a hit that lies within rounding of a box face.  Both
visit in the reference's order (children pushed 0..7 and popped last first,
leaf slots, clusters and triangles ascending), and the accept test is
`t <= best`, so among equal t the last one visited wins, here as there.
"""

from __future__ import annotations

import numpy as np
import torch

from ignis_tpu_torch.ops.bw_intersect import (
    CTREE_FLOATS, TRI_TILE, _bump, _slab, _tri_test, _walk_clusters,
    bw_tables, cluster_levels,
)
from ignis_tpu_torch.ops.ref_float import safe_inv

LANES = 128
_TOP_WIDTH = 8                  # children per top-level BVH row
_TOP_TYPE_LANE = 126            # 0 = inner row, 1 = instance-leaf row
_TOP_MISSING = np.float32(-1e9)


def _build_top_rows(inst):
    """8-wide BVH over instance world boxes -> ((R, 128) f32 rows, depth).

    Inner row: child boxes at lanes [6c, 6c+6), child row id at 64+c,
    `_TOP_MISSING` = none.  Leaf row: lanes 0..7 = instance ids, -1 = empty
    slot.  Lane 126 = row type.  Median split on the longest centroid axis;
    leaves hold <= 8 instances.
    """
    valid = [i for i in range(inst.shape[0]) if inst[i, 6] > 0.0]
    boxes = inst[:, 0:6]
    rows = []

    def emit_leaf(ids):
        row = np.zeros(LANES, np.float32)
        row[_TOP_TYPE_LANE] = 1.0
        row[0:_TOP_WIDTH] = -1.0
        for s, ii in enumerate(ids[:_TOP_WIDTH]):
            row[s] = np.float32(ii)
        rows.append(row)
        return len(rows) - 1

    def box_of(ids):
        lo = boxes[ids, 0:3].min(axis=0)
        hi = boxes[ids, 3:6].max(axis=0)
        return lo, hi

    def split8(ids):
        """Partition ids into <= 8 spatial groups by recursive median."""
        groups = [ids]
        while len(groups) < _TOP_WIDTH:
            gi = max(range(len(groups)), key=lambda g: len(groups[g]))
            g = groups[gi]
            if len(g) <= max(1, (len(ids) + _TOP_WIDTH - 1) // _TOP_WIDTH):
                break
            cent = (boxes[g, 0:3] + boxes[g, 3:6]) * 0.5
            ax = int(np.argmax(cent.max(axis=0) - cent.min(axis=0)))
            order = np.argsort(cent[:, ax], kind="stable")
            half = len(g) // 2
            groups[gi:gi + 1] = [[g[k] for k in order[:half]],
                                 [g[k] for k in order[half:]]]
        return groups

    def build(ids, depth):
        if len(ids) <= _TOP_WIDTH:
            return emit_leaf(ids), depth
        me = len(rows)
        rows.append(None)
        entries = []
        maxd = depth
        for g in split8(ids):
            lo, hi = box_of(g)
            child, d2 = build(g, depth + 1)
            maxd = max(maxd, d2)
            entries.append((lo, hi, child))
        row = np.zeros(LANES, np.float32)
        row[64:64 + _TOP_WIDTH] = _TOP_MISSING
        for c, (lo, hi, child) in enumerate(entries):
            row[6 * c:6 * c + 3] = lo
            row[6 * c + 3:6 * c + 6] = hi
            row[64 + c] = np.float32(child)
        rows[me] = row
        return me, maxd

    if not valid:
        emit_leaf([])
        depth = 1
    else:
        root, depth = build(valid, 1)
        assert root == 0
    return np.stack(rows), depth


def build_tlas(shapes, instances):
    """Build the instanced-pool tables (see the module docstring).

    shapes: list of dicts per unique LOCAL shape with keys
      v0, e1, e2, n0, n1, n2 (T,3) and uv0, uv1, uv2 (T,2).
    instances: list of (shape_idx, to_local 3x4, to_world 3x4,
                        normal_mat 3x3, ent_id, maskbits).
    """
    tri_chunks = []
    cl_chunks = []
    shade_chunks = []
    shape_info = []   # (tri_off_rows, cl_off, cl_cnt) per shape
    tri_rows = 0
    cl_rows = 0
    for sh in shapes:
        v0, e1, e2 = sh["v0"], sh["e1"], sh["e2"]
        t = np.asarray(v0).shape[0]
        tab = bw_tables(v0, e1, e2, np.full(t, 0xF))
        tri_chunks.append(tab["bw_tris"])
        cl_chunks.append(tab["bw_clusters"])
        tp = tab["bw_tris"].shape[0]
        shade = np.zeros((tp, 28), np.float32)
        for lo, key in ((0, "v0"), (3, "e1"), (6, "e2"), (9, "n0"),
                        (12, "n1"), (15, "n2")):
            shade[:t, lo:lo + 3] = np.asarray(sh[key], np.float32)
        for lo, key in ((18, "uv0"), (20, "uv1"), (22, "uv2")):
            shade[:t, lo:lo + 2] = np.asarray(sh[key], np.float32)
        shade_chunks.append(shade)
        shape_info.append((tri_rows, cl_rows, tab["bw_clusters"].shape[0]))
        tri_rows += tp
        cl_rows += tab["bw_clusters"].shape[0]

    tl_tris = (np.concatenate(tri_chunks) if tri_chunks
               else np.zeros((TRI_TILE, 16), np.float32))
    tl_clust = (np.concatenate(cl_chunks) if cl_chunks
                else np.zeros((1, 8), np.float32))
    tl_shade = (np.concatenate(shade_chunks) if shade_chunks
                else np.zeros((TRI_TILE, 28), np.float32))

    ninst = max(1, len(instances))
    inst = np.zeros((ninst, 32), np.float32)
    normt = np.zeros((ninst, 24), np.float32)
    for ii, (si, to_local, to_world, nmat, ent_id, mask) in enumerate(
            instances):
        v0 = np.asarray(shapes[si]["v0"], np.float64)
        e1 = np.asarray(shapes[si]["e1"], np.float64)
        e2 = np.asarray(shapes[si]["e2"], np.float64)
        pts = np.concatenate([v0, v0 + e1, v0 + e2])
        tw = np.asarray(to_world, np.float64)
        wpts = pts @ tw[:, :3].T + tw[:, 3]
        tri_off, cl_off, cl_cnt = shape_info[si]
        inst[ii, 0:3] = wpts.min(axis=0) if len(pts) else 0.0
        inst[ii, 3:6] = wpts.max(axis=0) if len(pts) else 0.0
        inst[ii, 6] = 1.0
        inst[ii, 7] = np.float32(cl_off)
        inst[ii, 8] = np.float32(cl_cnt)
        inst[ii, 9] = np.float32(tri_off)
        inst[ii, 10:22] = np.asarray(to_local, np.float32).reshape(12)
        inst[ii, 22] = np.float32(ent_id)
        inst[ii, 23] = np.float32(int(mask) & 0xF)
        normt[ii, 0:9] = np.asarray(nmat, np.float32).reshape(9)
        normt[ii, 9] = abs(float(np.linalg.det(
            np.asarray(to_world, np.float64)[:, :3])))
        normt[ii, 10:22] = np.asarray(to_world, np.float32).reshape(12)
    top, depth = _build_top_rows(inst)
    return {"tl_tris": tl_tris, "tl_clust": tl_clust,
            "tl_shade": tl_shade, "tl_inst": inst, "tl_norm": normt,
            "tl_top": top, "tl_depth": np.int32(depth)}


def build_cluster_tree(tl_clust, tl_inst):
    """`tl_ctree` (I + N, 8) float32: the cluster tree of `csrc/tlas.cu`,
    derived from `tl_clust` and `tl_inst` alone (so also for tables built by
    the reference package).

    Row i < I is instance i's header (`bw_intersect.cluster_levels`: [levels
    L, first row of level 1, ..., first row of level 7]; all 0 for an invalid
    instance or a shape of <= 8 clusters, which the kernel decides cluster by
    cluster).  The rows after them hold, for each distinct cluster range
    [cl0, cl0 + ccnt) of the valid instances, levels 1..L of the implicit
    8-ary tree over that range in its pool order."""
    clust = np.asarray(tl_clust, np.float32)
    inst = np.asarray(tl_inst, np.float32)
    ninst = inst.shape[0]
    header = np.zeros((ninst, CTREE_FLOATS), np.float32)
    levels_out = []
    nrows = ninst
    trees = {}
    for ii in range(ninst):
        if not inst[ii, 6] > 0.0:
            continue
        key = (int(inst[ii, 7]), int(inst[ii, 8]))
        if key not in trees:
            cl0, ccnt = key
            head, rows = cluster_levels(clust[cl0:cl0 + ccnt], nrows)
            levels_out.append(rows)
            nrows += rows.shape[0]
            trees[key] = head
        header[ii] = trees[key]
    return np.concatenate([header] + levels_out).astype(np.float32)


def top_depth(tl_top) -> int:
    """Depth of a `tl_top` row table on the host (1 = a single leaf row)."""
    top = np.asarray(tl_top)
    depth, level = 0, [0]
    while level:
        depth += 1
        nxt = []
        for r in level:
            if top[r, _TOP_TYPE_LANE] > 0.5:
                continue
            ch = top[r, 64:64 + _TOP_WIDTH]
            nxt.extend(int(c) for c in ch if c > _TOP_MISSING * 0.5)
        level = nxt
    return depth


def stack_entries(tables) -> int:
    """Stack a per-ray depth-first walk of `tl_top` can need: one pop then up
    to 8 pushes per level, and never more than there are rows."""
    nrows = int(tables["tl_top"].shape[0])
    if "tl_depth" in tables:
        return min(7 * int(tables["tl_depth"]) + 1, nrows)
    return nrows


def check_encoding(n_soup, tables, n_spheres=0):
    """Hits of the pool travel as `n_soup + instance * pool_rows + pool_row`
    in an int32 prim id, spheres past them: raise when that would overflow."""
    span = (int(n_soup) + int(tables["tl_inst"].shape[0])
            * int(tables["tl_tris"].shape[0]) + int(n_spheres))
    if span >= 2 ** 31:
        raise ValueError(
            f"{tables['tl_inst'].shape[0]} instances x "
            f"{tables['tl_tris'].shape[0]} pool rows do not fit the int32 "
            "prim id encoding")


# ------------------------------------------------------------- plain version
def _enter_instances(tables, st, sel, iid, mask_bit, work):
    """Working-set lanes `sel` meet the instances `iid` (one each): the enter
    test and, for the lanes that enter, the local ray.  Returns None when no
    lane enters, else (sel, iid, instance rows, (lox, loy, loz, ldx, ldy,
    ldz, lix, liy, liz), tmn, bt) of the lanes that do."""
    ir = tables["tl_inst"][iid]
    g = lambda k: st[k][sel]
    ox, oy, oz, dx, dy, dz = (g(k) for k in ("ox", "oy", "oz", "dx", "dy", "dz"))
    tmn, bt = g("tmn"), g("bt")
    near, far = _slab(ir, 0, 3, ox, oy, oz, g("ix"), g("iy"), g("iz"), tmn)
    enter = ((near <= far) & (near <= bt) & (ir[:, 6] > 0.0)
             & ((ir[:, 23].to(torch.int32) & mask_bit) != 0))
    _bump(work, "instance_tests", sel.shape[0])
    if not bool(enter.any()):
        return None
    sel, iid, ir = sel[enter], iid[enter], ir[enter]
    ox, oy, oz, dx, dy, dz, tmn, bt = (x[enter] for x in (
        ox, oy, oz, dx, dy, dz, tmn, bt))
    m = [ir[:, 10 + c] for c in range(12)]
    lox = (m[0] * ox + m[1] * oy) + (m[2] * oz + m[3])
    loy = (m[4] * ox + m[5] * oy) + (m[6] * oz + m[7])
    loz = (m[8] * ox + m[9] * oy) + (m[10] * oz + m[11])
    ldx = m[0] * dx + m[1] * dy + m[2] * dz
    ldy = m[4] * dx + m[5] * dy + m[6] * dz
    ldz = m[8] * dx + m[9] * dy + m[10] * dz
    _bump(work, "instances_entered", sel.shape[0])
    return (sel, iid, ir, (lox, loy, loz, ldx, ldy, ldz, safe_inv(ldx),
                           safe_inv(ldy), safe_inv(ldz)), tmn, bt)


def _visit_instances(tables, st, sel, iid, mask_bit, any_hit, work):
    """Working-set lanes `sel` meet the instances `iid` (one each): enter
    test, local ray, the shape's clusters in order.  Updates `st` in place.

    The sweep over clusters is sequential in a ray's best t.  It is evaluated
    in bulk: everything that does not depend on the running best (box
    intervals, the triangle functionals, the inside tests against the best t
    at entry) is computed for all clusters at once; the few triangles per ray
    that survive are then replayed in visiting order against the running
    best, which gives exactly the result of the ray-by-ray loop."""
    entered = _enter_instances(tables, st, sel, iid, mask_bit, work)
    if entered is None:
        return
    tris, clust = tables["tl_tris"], tables["tl_clust"]
    sel, iid, ir, local, tmn, bt = entered
    lox, loy, loz, ldx, ldy, ldz, lix, liy, liz = local
    k = sel.shape[0]
    dev = lox.device
    cl0 = ir[:, 7].long()
    ccnt = ir[:, 8].long()
    toff = ir[:, 9].long()
    _bump(work, "cluster_tests", ccnt.sum())

    # ---- every cluster box of the shape, without the running-best clip
    cmax = int(ccnt.max())
    cidx = torch.arange(cmax, device=dev)[None, :]
    jc = torch.clamp_max(cl0[:, None] + cidx, clust.shape[0] - 1)
    cb = clust[jc]                                        # (k, cmax, 8)
    col = lambda x: x[:, None]
    nr, fr = _slab(cb, 0, 3, col(lox), col(loy), col(loz), col(lix),
                   col(liy), col(liz), col(tmn))
    static_pass = ((cidx < ccnt[:, None]) & (nr <= fr) & (nr <= col(bt))
                   & (cb[..., 6] > 0.0))
    pk, pc = static_pass.nonzero(as_tuple=True)           # lane-major order
    if pk.shape[0] == 0:
        return
    # ---- the eight triangles of those clusters against the best t at entry
    rows = (toff[pk] + pc * TRI_TILE)[:, None] + torch.arange(
        TRI_TILE, device=dev)[None, :]                    # (P, 8) pool rows
    rows = torch.clamp_max(rows, tris.shape[0] - 1)
    pcol = lambda x: x[pk][:, None]
    ok, tt, u, v = _tri_test(tris[rows], mask_bit, pcol(lox), pcol(loy),
                             pcol(loz), pcol(ldx), pcol(ldy), pcol(ldz),
                             pcol(tmn), pcol(bt))
    qp, qk = ok.nonzero(as_tuple=True)        # lane, cluster, triangle order
    # ---- replay the survivors in visiting order against the running best
    ql = pk[qp]
    q_nr, q_cl = nr[pk, pc][qp], pc[qp]
    q_tt, q_u, q_v, q_row = tt[qp, qk], u[qp, qk], v[qp, qk], rows[qp, qk]
    nq = ql.shape[0]
    rank = torch.arange(nq, device=dev) - torch.searchsorted(ql, ql)
    lbt = bt.clone()
    lbu, lbv, lbi, lbe = (st[key][sel] for key in ("bu", "bv", "bi", "be"))
    seen = torch.full((k,), -1, dtype=torch.int64, device=dev)
    entered = torch.zeros(k, dtype=torch.bool, device=dev)
    accepts = []                               # (cluster, t) per replay step
    for r in range(int(rank.max()) + 1 if nq else 0):
        qs = (rank == r).nonzero(as_tuple=True)[0]
        l = ql[qs]
        # a cluster is entered on the best t at its box test, which is the
        # best t when the ray's first survivor of that cluster comes up
        ent = torch.where(q_cl[qs] != seen[l], q_nr[qs] <= lbt[l], entered[l])
        seen[l] = q_cl[qs]
        entered[l] = ent
        acc = ent & (q_tt[qs] <= lbt[l])
        if any_hit:
            acc = acc & (lbi[l] < 0)
        la, qa = l[acc], qs[acc]
        lbt[la] = q_tt[qa]
        if not any_hit:
            lbu[la] = torch.clamp_min(q_u[qa], 0.0)
            lbv[la] = torch.clamp_min(q_v[qa], 0.0)
        lbi[la] = q_row[qa].to(torch.int32)
        lbe[la] = iid[la].to(torch.int32)
        if work is not None:
            a_cl = torch.full((k,), cmax, dtype=torch.int64, device=dev)
            a_cl[la] = q_cl[qa]
            accepts.append((a_cl, lbt.clone()))
    if work is not None:
        # clusters entered: box test against the best t the ray had then
        before = col(bt).expand(k, cmax).clone()
        stop = torch.full((k,), cmax, dtype=torch.int64, device=dev)
        for a_cl, a_t in accepts:
            before = torch.where(col(a_cl) < cidx, col(a_t), before)
            if any_hit:
                stop = torch.minimum(stop, a_cl)
        went = static_pass & (nr <= before) & (cidx <= col(stop))
        _bump(work, "tri_tests", TRI_TILE * int(went.sum()))
    st["bt"][sel], st["bu"][sel], st["bv"][sel] = lbt, lbu, lbv
    st["bi"][sel], st["be"][sel] = lbi, lbe


def _walk_instances(tables, st, sel, iid, mask_bit, any_hit, work):
    """`_visit_instances` with the kernel's walk over the cluster tree
    (`tl_ctree`, `bw_intersect._walk_clusters`) in place of the dense
    sweep."""
    entered = _enter_instances(tables, st, sel, iid, mask_bit, work)
    if entered is None:
        return
    sel, iid, ir, local, tmn, bt = entered
    hdr = tables["tl_ctree"][iid]
    best = (bt.clone(),) + tuple(st[key][sel].clone()
                                 for key in ("bu", "bv", "bi"))
    bt, bu, bv, bi, hit = _walk_clusters(
        tables["tl_tris"], tables["tl_clust"], tables["tl_ctree"],
        hdr[:, 0].long(), hdr[:, 1:CTREE_FLOATS].long(),
        *(ir[:, q].long() for q in (7, 8, 9)), local, tmn, best, mask_bit,
        any_hit, work)
    st["bt"][sel], st["bu"][sel], st["bv"][sel] = bt, bu, bv
    st["bi"][sel] = bi
    st["be"][sel] = torch.where(hit, iid.to(torch.int32), st["be"][sel])


_WORK_KEYS = ("ox", "oy", "oz", "dx", "dy", "dz", "ix", "iy", "iz", "tmn",
              "bt", "bu", "bv", "bi", "be", "lane", "stack", "sp")


def tlas_traverse_plain(tables, org, d, tmin, tmax, mask_bit=0xF,
                        any_hit=False, work=None):
    """Plain PyTorch version of `tlas_traverse`: (t, u, v, pool_row,
    instance), -1 = miss.  Every live lane pops one `tl_top` row per round
    from its own stack; lanes that finished are compacted away.  `work`, when
    given, receives what these rays needed: `inner_visits`, `leaf_visits`,
    `instance_tests`, `instances_entered`, `cluster_tests`, `tri_tests`."""
    return _traverse_plain(tables, org, d, tmin, tmax, mask_bit, any_hit,
                           work, _visit_instances)


def cluster_walk_plain(tables, org, d, tmin, tmax, mask_bit=0xF,
                       any_hit=False, work=None):
    """`tlas_traverse_plain` with the kernel's walk over the cluster tree
    (`tl_ctree`) in every entered instance: the same results, bit for bit
    (tests/test_torch_tlas.py holds them so); `work` also gets
    `node_tests`, and `cluster_tests` / `tri_tests` count what the walk
    decided and tested.  For the tests only."""
    return _traverse_plain(tables, org, d, tmin, tmax, mask_bit, any_hit,
                           work, _walk_instances)


def _traverse_plain(tables, org, d, tmin, tmax, mask_bit, any_hit, work,
                    visit):
    top = tables["tl_top"]
    n = org.shape[0]
    dev = org.device
    f32 = dict(dtype=torch.float32, device=dev)
    mask_bit = int(mask_bit)
    cap = stack_entries(tables) + _TOP_WIDTH

    out_t = torch.broadcast_to(torch.as_tensor(tmax, **f32), (n,)).clone()
    out = dict(bt=out_t, bu=torch.zeros(n, **f32), bv=torch.zeros(n, **f32),
               bi=torch.full((n,), -1, dtype=torch.int32, device=dev),
               be=torch.full((n,), -1, dtype=torch.int32, device=dev))
    result = lambda: (out["bt"], out["bu"], out["bv"], out["bi"], out["be"])
    if n == 0:
        return result()
    st = dict(ox=org[:, 0], oy=org[:, 1], oz=org[:, 2],
              dx=d[:, 0], dy=d[:, 1], dz=d[:, 2],
              tmn=torch.broadcast_to(torch.as_tensor(tmin, **f32), (n,)),
              lane=torch.arange(n, device=dev),
              stack=torch.zeros((n, cap), dtype=torch.int64, device=dev),
              sp=torch.ones(n, dtype=torch.int64, device=dev))
    for k in ("dx", "dy", "dz"):
        st["i" + k[1]] = safe_inv(st[k])
    for k, v in out.items():
        st[k] = v.clone()

    def flush():
        for k in out:
            out[k][st["lane"]] = st[k]

    while True:
        active = st["sp"] > 0
        n_act = int(active.sum())
        if n_act == 0:
            break
        if n_act * 2 < st["lane"].shape[0]:
            flush()
            for k in _WORK_KEYS:
                st[k] = st[k][active]
            active = st["sp"] > 0
        m = st["lane"].shape[0]
        ar = torch.arange(m, device=dev)
        st["sp"] = torch.where(active, st["sp"] - 1, st["sp"])
        r = top[st["stack"][ar, st["sp"]]]               # (m, 128)
        is_leaf = active & (r[:, _TOP_TYPE_LANE] > 0.5)
        is_inner = active & ~is_leaf
        _bump(work, "inner_visits", is_inner.sum())
        _bump(work, "leaf_visits", is_leaf.sum())

        # ---- leaf rows: the instances of slots 0..7, in slot order
        if bool(is_leaf.any()):
            for s in range(_TOP_WIDTH):
                iid = r[:, s].to(torch.int64)
                go = is_leaf & (iid >= 0)
                if any_hit:
                    go = go & (st["bi"] < 0)
                sel = go.nonzero(as_tuple=True)[0]
                if sel.shape[0]:
                    visit(tables, st, sel, iid[sel], mask_bit, any_hit,
                          work)
            if any_hit:
                st["sp"] = torch.where(st["bi"] >= 0,
                                       torch.zeros_like(st["sp"]), st["sp"])

        # ---- inner rows: 8 slab tests, push passing children in order
        if bool(is_inner.any()):
            sp, stack = st["sp"], st["stack"]
            for c in range(_TOP_WIDTH):
                near, far = _slab(r, 6 * c, 6 * c + 3, st["ox"], st["oy"],
                                  st["oz"], st["ix"], st["iy"], st["iz"],
                                  st["tmn"])
                ev = r[:, 64 + c]
                push = (is_inner & (near <= far) & (near <= st["bt"])
                        & (ev > float(_TOP_MISSING) * 0.5))
                # in place: the stack is the largest tensor of the walk
                slot = torch.where(push, sp, torch.full_like(sp, cap - 1))
                stack[ar, slot] = torch.where(push, ev.to(torch.int64),
                                              stack[ar, slot])
                sp = sp + push.to(torch.int64)
            st["sp"] = sp
    flush()
    return result()


def tlas_closest_plain(tables, org, d, tmin, tmax, mask_bit=0xF, work=None):
    """Plain PyTorch version of `tlas_closest`."""
    return tlas_traverse_plain(tables, org, d, tmin, tmax, mask_bit, False,
                               work)


def tlas_any_plain(tables, org, d, tmin, tmax, mask_bit=0xF, work=None):
    """Plain PyTorch version of `tlas_any`: bool per ray."""
    return tlas_traverse_plain(tables, org, d, tmin, tmax, mask_bit, True,
                               work)[3] >= 0


# ------------------------------------------------------------------- wrapper
def _launch(tables, org, d, tmin, tmax, mask_bit, any_hit):
    from ignis_tpu_torch import native
    org, d, tmin, tmax = native.check_rays(org, d, tmin, tmax)
    dev = org.device
    top = native.check_table("tl_top", tables["tl_top"], LANES, dev)
    tris = native.check_table("tl_tris", tables["tl_tris"], 16, dev)
    clust = native.check_table("tl_clust", tables["tl_clust"], 8, dev)
    inst = native.check_table("tl_inst", tables["tl_inst"], 32, dev)
    if "tl_ctree" not in tables:
        raise ValueError("the kernel walks `tl_ctree`: set tl_ctree = "
                         "build_cluster_tree(tl_clust, tl_inst) once")
    ctree = native.check_table("tl_ctree", tables["tl_ctree"], CTREE_FLOATS,
                               dev)
    if ctree.shape[0] < inst.shape[0]:
        raise ValueError("tl_ctree holds fewer header rows than tl_inst has "
                         "instances")
    lib = native.library()
    need, have = stack_entries(tables), lib.ignis_tlas_stack_entries()
    if need > have:
        raise ValueError(
            f"the instance BVH needs a {need}-entry stack; the kernel was "
            f"compiled with {have}"
            + ("" if "tl_depth" in tables else
               " (tables without `tl_depth` are sized by their row count: "
               "set tl_depth = top_depth(tl_top) once)"))
    n = org.shape[0]
    buf = torch.empty((5, n), dtype=torch.float32, device=dev)
    out = (buf[0], buf[1], buf[2], buf[3].view(torch.int32),
           buf[4].view(torch.int32))
    with native.launch_guard(dev):
        err = lib.ignis_tlas(
            top.data_ptr(), tris.data_ptr(), clust.data_ptr(),
            inst.data_ptr(), ctree.data_ptr(), org.data_ptr(), d.data_ptr(), tmin.data_ptr(),
            tmax.data_ptr(), n, int(mask_bit), int(any_hit),
            *(o.data_ptr() for o in out),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tlas kernel launch failed: CUDA error {err}")
    return out


def _traverse(counter, tables, org, d, tmin, tmax, mask_bit, any_hit):
    if org.is_cuda:
        out = _launch(tables, org, d, tmin, tmax, mask_bit, any_hit)
        if org.shape[0]:          # no rays: nothing is launched
            counter.launches += 1
        return out
    return tlas_traverse_plain(tables, org, d, tmin, tmax, mask_bit, any_hit)


def tlas_closest(tables, org, d, tmin, tmax, mask_bit=0xF):
    """Closest hit over the instanced pool: (t, u, v, pool_row, instance),
    -1 on miss.  CUDA tensors go to the kernel, CPU tensors to the plain
    version."""
    return _traverse(tlas_closest, tables, org, d, tmin, tmax, mask_bit,
                     False)


def tlas_any(tables, org, d, tmin, tmax, mask_bit=0xF):
    """Occlusion: True where any visible instance blocks the segment."""
    return _traverse(tlas_any, tables, org, d, tmin, tmax, mask_bit,
                     True)[3] >= 0


def tlas_traverse(tables, org, d, tmin, tmax, mask_bit=0xF, any_hit=False):
    """The reference's entry: (t, u, v, pool_row, instance); with `any_hit`
    a ray stops at its first hit and only `pool_row >= 0` is meaningful."""
    return _traverse(tlas_any if any_hit else tlas_closest, tables, org, d,
                     tmin, tmax, mask_bit, any_hit)


tlas_closest.launches = 0
tlas_any.launches = 0
