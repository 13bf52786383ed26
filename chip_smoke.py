#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ignis_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

It builds the CUDA kernels from `ignis_tpu_torch/csrc/` with `nvcc`, holds
each kernel against its plain PyTorch version on the card, and drives the
port's main path (`Runtime.step` of the `path` technique) on four scenes: the
demo box through the Baldwin-Weber kernels, the 512,002-triangle field through
the packet-BVH kernels, 1024 instances of one mesh beside analytic spheres
through the two-level kernel, and a 32,002-triangle soup with un-accelerated
tables through the whole-soup Moeller-Trumbore kernel.  The packet-BVH,
two-level and whole-soup kernels are also checked and timed at the width of
a tail wave (4096 rays, `tail_ms` / `tail_device_ms`); the packet-BVH kernel
also on a second table set (a 46,082-triangle field), the two-level kernel on
a second table set (two shapes, 144 instances), the whole-soup kernel on the
soup twice over, whose copies fall into different ranges of its split sweep;
the three must give the plain versions' bits.  Every kernel is also held to
its plain version, bit for bit, on rays with subnormal, infinite and NaN
components that start on box faces (the JAX package's float rules,
`ops.ref_float`).  Every phase prints one
JSON line with its seconds.  Any failed phase ends the run with a non-zero exit code; nothing
falls back to the CPU.  The last line of the output is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

N_RAYS = 65536            # rays per kernel check, = the wave capacity
TAIL_RAYS = 4096          # rays of a tail wave (`render_wavefront`'s default)
FILM = 512                # film width and height of the headline scenes
BIG_SCENE = dict(n_spheres=25, subdiv=5)   # 512,002 triangles
BIG_SECOND = dict(n_spheres=9, subdiv=4)   # 46,082 triangles: kernel 2's second table set
RULE_RAYS = 8192          # float-rule rays per kernel check
SWEEP_SCENE = dict(n_spheres=25, subdiv=3)  # 32,002 triangles, no tables
T_REL, UV_ABS = 1e-5, 1e-4  # kernel vs plain: |dt|/max(1,|t|), |du|, |dv|
MEAN_REL = 0.02           # kernel render vs plain render, image mean
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, outside the tensor cores
# float32 operations per test, counted from the kernels' sources
OPS_BOX, OPS_BW_TRI, OPS_MT_TRI = 25, 48, 54
# what the whole-soup sweep needs of those 54: n = e1 x e2 once a triangle
# (9); c, r, det, U', V' for every pair (27), whose signs rule a miss out;
# the division, u, v, w and t (18) only where a ray is hit
OPS_MT_NORMAL, OPS_MT_PAIR, OPS_MT_HIT = 9, 27, 18
OPS_TO_LOCAL = 36         # a ray into an instance's space, 3 reciprocals


def emit(phase, t0, **kw):
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0, 3),
                      **kw}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps):
    """Mean milliseconds of `fn()` over `reps` calls, timed with CUDA events
    after one warm-up call; a synchronise closes the timed region."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps):
    """Mean device milliseconds of `fn()`: `reps` calls are captured into one
    CUDA graph and the graph is replayed between two events, so the host's
    enqueue cost of the wrapper (allocations, checks, the `ctypes` call) is
    left out and only what the card executes is timed."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()                              # warm-up replay
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def camera_rays(rt, n_side, dev):
    """n_side^2 camera rays on a regular grid over the whole film."""
    from ignis_tpu_torch.render.integrator import _emit_camera
    sc = rt.scene
    ii = torch.arange(n_side, device=dev)
    x = (ii * sc.width // n_side).repeat(n_side)
    y = (ii * sc.height // n_side).repeat_interleave(n_side)
    _, _, org, d, tmin, tmax = _emit_camera(sc, x, y, 0, 0, 0, 0, rt.tables)
    return org.contiguous(), d.contiguous(), tmin, tmax


def random_rays(rt, n, seed, dev):
    """Incoherent rays: numpy-seeded origins in the scene bounds, random unit
    directions."""
    r = np.random.default_rng(seed)
    lo, hi = rt.scene.bbox_min, rt.scene.bbox_max
    org = (lo + r.uniform(0, 1, (n, 3)) * (hi - lo)).astype(np.float32)
    d = r.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    to = lambda a: torch.from_numpy(a).to(dev)
    return (to(org), to(d), torch.full((n,), 1e-3, device=dev),
            torch.full((n,), 3.4028234663852886e38, device=dev))


def secondary_rays(primary, closest_plain, tables, seed):
    """Bounce-like rays: they start where the camera rays hit (camera rays
    that miss keep their origin) and leave in numpy-seeded random directions."""
    org, d, tmin, tmax = primary
    t, _, _, prim = closest_plain(tables, org, d, tmin, tmax)
    hit = (prim >= 0)[:, None]
    org2 = torch.where(hit, org + d * t[:, None], org).contiguous()
    r = np.random.default_rng(seed)
    d2 = r.normal(0, 1, (org.shape[0], 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return (org2, torch.from_numpy(d2).to(org.device),
            torch.full_like(tmin, 1e-3), torch.full_like(tmax, 3.4028234663852886e38))


_SPECIAL = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40,
                     1e-45, 3e-39, 1e-30, -0.6, 0.7], np.float32)


def float_rule_rays(boxes, n, seed, dev):
    """Rays for the reference's float rules over (B, 6) boxes (lo | hi):
    origins on a box face on every axis (box - o = 0), some moved off it,
    a few NaN; directions random, a component in three drawn from NaN,
    +-inf, +-0 and subnormals; tmin 1e-3 (a few NaN), tmax 1e30 (a few
    finite, a few NaN)."""
    r = np.random.default_rng(seed)
    b = boxes[r.integers(0, boxes.shape[0], n)]
    org = np.where(r.random((n, 3)) < 0.5, b[:, 0:3], b[:, 3:6])
    org = np.where(r.random((n, 3)) < 0.1, org + r.normal(0, 1, (n, 3)),
                   org).astype(np.float32)
    org[r.random((n, 3)) < 0.01] = np.nan
    d = r.normal(0, 1, (n, 3))
    d = np.where(r.random((n, 3)) < 0.35,
                 _SPECIAL[r.integers(0, len(_SPECIAL), (n, 3))],
                 d).astype(np.float32)
    tmin = np.where(r.random(n) < 0.02, np.float32(np.nan),
                    np.float32(1e-3)).astype(np.float32)
    tmax = np.where(r.random(n) < 0.1, r.uniform(0.5, 4, n),
                    1e30).astype(np.float32)
    tmax[r.random(n) < 0.02] = np.nan
    return tuple(torch.from_numpy(a).to(dev) for a in (org, d, tmin, tmax))


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def check_float_rules(tb, fns, boxes, recs, dev):
    """One module's kernels against their plain versions on the float-rule
    rays under the camera, bounce and shadow masks: every output bit for
    bit (NaN included), occlusion equal; fails otherwise."""
    from ignis_tpu_torch.ops.packet_bvh import (MASK_BOUNCE, MASK_CAMERA,
                                                MASK_SHADOW)
    closest, closest_plain, any_, any_plain = fns
    rays = float_rule_rays(np.asarray(boxes, np.float32), RULE_RAYS, 21, dev)
    hits = occluded = 0
    for mname, mb in (("camera", MASK_CAMERA), ("bounce", MASK_BOUNCE),
                      ("shadow", MASK_SHADOW)):
        got = closest(tb, *rays, mask_bit=mb)
        ref = closest_plain(tb, *rays, mask_bit=mb)
        occ = any_(tb, *rays, mask_bit=mb)
        occ_ref = any_plain(tb, *rays, mask_bit=mb)
        torch.cuda.synchronize()
        bad = sum(int((_bits(a) != _bits(b)).sum()) for a, b in zip(got, ref))
        bad_any = int((occ != occ_ref).sum())
        if bad or bad_any:
            fail(f"{closest.__name__}/float-rules/{mname}: {bad} output "
                 f"values and {bad_any} occlusions differ from the plain "
                 "versions' bits")
        hits += int((got[3] >= 0).sum())
        occluded += int(occ.sum())
    for fn in (closest, any_):
        recs[fn.__name__]["rays"] += 3 * RULE_RAYS
        recs[fn.__name__]["float_rules"] = dict(
            rays=RULE_RAYS, masks=3, mismatch=0, hits=hits,
            occluded=occluded)


def compare_closest(name, got, ref):
    """Kernel vs plain closest hit.  prim must agree except where both hit at
    bit-equal t (an exact tie between two triangles)."""
    (kt, ku, kv, ki), (pt, pu, pv, pi) = got, ref
    differ = ki != pi
    tie = differ & (ki >= 0) & (pi >= 0) & (kt == pt)
    bad = int((differ & ~tie).sum())
    both = (ki >= 0) & (ki == pi)
    if bool(both.any()):
        dt = float(((kt - pt).abs() / pt.abs().clamp_min(1.0))[both].max())
        dabs = float((kt - pt).abs()[both].max())
        duv = float(torch.maximum((ku - pu).abs(), (kv - pv).abs())[both].max())
    else:
        dt = dabs = duv = 0.0
    if bad or dt > T_REL or duv > UV_ABS:
        fail(f"{name}: {bad} prim mismatches outside exact-t ties, "
             f"max rel dt {dt:.3g}, max duv {duv:.3g}")
    return dict(mismatch=bad, ties=int(tie.sum()), hits=int((ki >= 0).sum()),
                max_rel_dt=dt, max_abs_dt=dabs, max_duv=duv)


def compare_sets(tb, sets, closest, closest_plain, any_, any_plain, rec_c,
                 rec_a, width=""):
    """Every ray set under the camera, bounce and shadow masks: closest hit
    and occlusion against the plain versions; fails on a mismatch."""
    from ignis_tpu_torch.ops.packet_bvh import (MASK_BOUNCE, MASK_CAMERA,
                                                MASK_SHADOW)
    for sname, (org, d, tmin, tmax) in sets.items():
        for mname, mb in (("camera", MASK_CAMERA), ("bounce", MASK_BOUNCE),
                          ("shadow", MASK_SHADOW)):
            got = closest(tb, org, d, tmin, tmax, mask_bit=mb)
            ref = closest_plain(tb, org, d, tmin, tmax, mask_bit=mb)
            torch.cuda.synchronize()
            c = compare_closest(f"{closest.__name__}/{sname}{width}/{mname}",
                                got, ref)
            rec_c["rays"] += org.shape[0]
            rec_c["checks"].append(dict(rays=sname + width, mask=mname, **c))
            rec_c["max_abs_err"] = max(rec_c["max_abs_err"], c["max_abs_dt"],
                                       c["max_duv"])
            # occlusion: unnormalised segments of bounded length
            smax = torch.full_like(tmax, 4.0)
            occ = any_(tb, org, d, tmin, smax, mask_bit=mb)
            occ_ref = any_plain(tb, org, d, tmin, smax, mask_bit=mb)
            torch.cuda.synchronize()
            bad = int((occ != occ_ref).sum())
            if bad:
                fail(f"{any_.__name__}/{sname}{width}/{mname}: {bad} rays "
                     "disagree with the plain version")
            rec_a["rays"] += org.shape[0]
            rec_a["checks"].append(dict(rays=sname + width, mask=mname,
                                        mismatch=bad, occluded=int(occ.sum())))


def check_kernels(rt, closest, closest_plain, any_, any_plain, dev, bound_fn,
                  tail=0):
    """Hold one module's two kernels against their plain versions on coherent
    and incoherent rays under the camera, bounce and shadow masks, and time
    them.  Each of the four takes (tables, org, d, tmin, tmax, mask_bit=);
    the plain ones also `work=`.  With `tail`, the same again on every
    (N_RAYS / tail)-th ray of each set, the width of a tail wave, with
    `tail_ms` / `tail_device_ms` on the secondary ones.  Returns {kernel
    name: record}."""
    from ignis_tpu_torch.ops.packet_bvh import MASK_BOUNCE, MASK_SHADOW
    tb = rt.tables
    sets = {"coherent": camera_rays(rt, int(np.sqrt(N_RAYS)), dev),
            "incoherent": random_rays(rt, N_RAYS, 11, dev)}
    sets["secondary"] = secondary_rays(sets["coherent"], closest_plain, tb, 12)
    rec_c = dict(rays=0, checks=[], max_abs_err=0.0)
    rec_a = dict(rays=0, checks=[], max_abs_err=0.0)
    fns = (closest, closest_plain, any_, any_plain)
    compare_sets(tb, sets, *fns, rec_c, rec_a)
    if tail:
        short = {k: tuple(x[::N_RAYS // tail].contiguous() for x in v)
                 for k, v in sets.items()}
        compare_sets(tb, short, *fns, rec_c, rec_a, width=f"/{tail}")
    # ---- times, at the wave's width, on the secondary rays (what a bounce
    # wave looks like); the coherent and incoherent times stand beside it
    org, d, tmin, tmax = sets["secondary"]
    smax = torch.full_like(tmax, 4.0)
    out = {}
    for fn, plain, rec, args, mb in (
            (closest, closest_plain, rec_c, (org, d, tmin, tmax), MASK_BOUNCE),
            (any_, any_plain, rec_a, (org, d, tmin, smax), MASK_SHADOW)):
        ms = cuda_ms(lambda: fn(tb, *args, mask_bit=mb), 10)
        device_ms = graph_ms(lambda: fn(tb, *args, mask_bit=mb), 10)
        side = {}
        for sname in ("coherent", "incoherent"):
            so, sd, stmin, stmax = sets[sname]
            if fn is any_:
                stmax = torch.full_like(stmax, 4.0)
            side[sname + "_ms"] = cuda_ms(
                lambda: fn(tb, so, sd, stmin, stmax, mask_bit=mb), 10)
        work = {}
        t0 = time.perf_counter()
        plain(tb, *args, mask_bit=mb, work=work)
        torch.cuda.synchronize()
        once = time.perf_counter() - t0
        # the plain version can take seconds at this size: 10 timed
        # launches when it is quick, else 2
        plain_ms = cuda_ms(lambda: plain(tb, *args, mask_bit=mb),
                           10 if once < 0.3 else 2)
        bound = bound_fn(rt, work, args[0].shape[0], fn is any_)
        rec.update(ms=ms, device_ms=device_ms, plain_ms=plain_ms, work=work,
                   rays_per_launch=int(args[0].shape[0]),
                   **side, **bound)
        if tail:
            targs = tuple(x[::N_RAYS // tail].contiguous() for x in args)
            twork = {}
            plain(tb, *targs, mask_bit=mb, work=twork)
            tbound = bound_fn(rt, twork, targs[0].shape[0], fn is any_)
            rec.update(
                tail_rays=int(targs[0].shape[0]),
                tail_ms=cuda_ms(lambda: fn(tb, *targs, mask_bit=mb), 10),
                tail_device_ms=graph_ms(lambda: fn(tb, *targs, mask_bit=mb),
                                        10),
                tail_bound_ms=tbound["bound_ms"],
                tail_bound_by=tbound["bound_by"])
        out[fn.__name__] = rec
    return out


def bw_bound(rt, work, n, is_any):
    tb = rt.tables
    nbytes = (tb["bw_tris"].numel() + tb["bw_clusters"].numel()) * 4 \
        + n * 32 + n * (1 if is_any else 16)
    ops = work["box_tests"] * OPS_BOX + work["tri_tests"] * OPS_BW_TRI
    return _bound(nbytes, ops)


def pb_bound(rt, work, n, is_any):
    """What the function needs, whatever implements it and in whatever
    order it visits (`work["needed"]`, counted by `pb_adapters` over the
    final outputs): 8 box tests for each inner row whose box the ray's final
    window [tmin, t] crosses, a test for each triangle record with non-zero
    mask bits of each leaf it crosses; an occluded any-hit ray one triangle
    test.  Bytes: the distinct inner rows of those walks at 28 bytes a
    child (box and child id), their distinct triangle records at 44 bytes
    (v0, e1, e2, mask bits, id), rays in, results out.  `bound_walk_*`: the
    earlier count, over the walk as it went (512-byte rows touched, 8 tests
    a row visited), which moves with the visiting order."""
    io = n * 32 + n * (1 if is_any else 16)
    need = work["needed"]
    nbytes = io + need.get("inner_rows_touched", 0) * 8 * 28 \
        + need.get("records_touched", 0) * 44
    ops = (need.get("inner_visits", 0) * 8 * OPS_BOX
           + need.get("tri_tests", 0) * OPS_MT_TRI
           + need.get("occluded", 0) * OPS_MT_TRI)
    walk = _bound(io + work["rows_touched"] * 512,
                  work["inner_visits"] * 8 * OPS_BOX
                  + work["leaf_visits"] * 8 * OPS_MT_TRI)
    return dict(_bound(nbytes, ops), bound_walk_ms=walk["bound_ms"],
                bound_walk_by=walk["bound_by"],
                bound_walk_operations=walk["bound_operations"])


def pb_adapters(pb):
    """`ops.packet_bvh` with plain versions that, with `work=`, also count
    under `work["needed"]` what the final outputs need (`pb_bound`): the
    plain walk again over each ray's final window, [tmin, t] (closest) or
    [tmin, tmax] of the unoccluded rays (any), plus the number of occluded
    rays."""
    def packet_bvh_closest_plain(tb, *rays, mask_bit=pb.MASK_BOUNCE,
                                 work=None):
        out = pb.packet_bvh_closest_plain(tb, *rays, mask_bit=mask_bit,
                                          work=work)
        if work is not None:
            work["needed"] = {}
            pb.packet_bvh_closest_plain(tb, *rays[:3], out[0],
                                        mask_bit=mask_bit,
                                        work=work["needed"])
        return out

    def packet_bvh_any_plain(tb, *rays, mask_bit=pb.MASK_SHADOW, work=None):
        occ = pb.packet_bvh_any_plain(tb, *rays, mask_bit=mask_bit,
                                      work=work)
        if work is not None:
            work["needed"] = {"occluded": int(occ.sum())}
            pb.packet_bvh_any_plain(tb, *(x[~occ] for x in rays),
                                    mask_bit=mask_bit, work=work["needed"])
        return occ
    return (pb.packet_bvh_closest, packet_bvh_closest_plain,
            pb.packet_bvh_any, packet_bvh_any_plain)


def check_pb_extras(pb, rt2, recs, dev):
    """Kernel 2 beyond the common checks.  (a) A second table set (a
    46,082-triangle field of another depth): the 3 ray sets x 3 masks of
    `check_kernels` at 65536 and at 4096 rays.  (b) Every kernel 2 check
    must be bit-equal: no prim mismatch, no exact-t tie to forgive, max abs
    err 0.0."""
    tb = rt2.tables
    fns = pb_adapters(pb)
    sets = {"coherent": camera_rays(rt2, int(np.sqrt(N_RAYS)), dev),
            "incoherent": random_rays(rt2, N_RAYS, 11, dev)}
    sets["secondary"] = secondary_rays(sets["coherent"], fns[1], tb, 12)
    short = {k: tuple(x[::N_RAYS // TAIL_RAYS].contiguous() for x in v)
             for k, v in sets.items()}
    rec_c = dict(rays=0, checks=[], max_abs_err=0.0)
    rec_a = dict(rays=0, checks=[], max_abs_err=0.0)
    compare_sets(tb, sets, *fns, rec_c, rec_a, width="/second")
    compare_sets(tb, short, *fns, rec_c, rec_a, width=f"/second/{TAIL_RAYS}")
    for name, rec in (("packet_bvh_closest", rec_c), ("packet_bvh_any", rec_a)):
        recs[name]["rays"] += rec["rays"]
        recs[name]["checks"] += rec["checks"]
        recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"],
                                        rec["max_abs_err"])
    recs["packet_bvh_closest"]["second_table"] = dict(
        triangles=int(tb["tri_v0"].shape[0]), pb_rows=list(tb["pb_rows"].shape),
        pb_depth=int(tb["pb_depth"]), pb_nodes=list(tb["pb_nodes"].shape))
    rc = recs["packet_bvh_closest"]
    ties = sum(c["ties"] for c in rc["checks"])
    if rc["max_abs_err"] != 0.0 or ties:
        fail(f"packet_bvh_closest: not the plain version's bits (max abs err "
             f"{rc['max_abs_err']}, {ties} exact-t ties with another prim)")


def tlas_bound(rt, work, n, is_any):
    """What the function needs, whatever implements it (`work["needed"]`,
    counted by `tlas_adapters` over the final outputs): 8 box tests for each
    top-level inner row whose box the ray's final window [tmin, t] crosses,
    a box test and a transform for each instance whose world box it crosses,
    8 triangle tests for each cluster of those whose local box it crosses;
    an occluded any-hit ray one transform and one cluster's triangles.  The
    tables once, rays in, results out.  `bound_dense_*`: the same bytes
    over the dense sweep's work (every cluster box of an entered instance),
    which the kernel did before it walked a cluster tree."""
    tb = rt.tables
    nbytes = sum(tb[k].numel() for k in ("tl_top", "tl_tris", "tl_clust",
                                         "tl_inst")) * 4 \
        + n * 32 + n * (1 if is_any else 20)
    need = work["needed"]
    ops = (need["inner_visits"] * 8 * OPS_BOX
           + need["instances_entered"] * (OPS_BOX + OPS_TO_LOCAL)
           + need["tri_tests"] * OPS_BW_TRI
           + need.get("occluded", 0) * (OPS_TO_LOCAL + 8 * OPS_BW_TRI))
    dense = _bound(nbytes, (work["inner_visits"] * 8 + work["instance_tests"]
                            + work["cluster_tests"]) * OPS_BOX
                   + work["instances_entered"] * OPS_TO_LOCAL
                   + work["tri_tests"] * OPS_BW_TRI)
    return dict(_bound(nbytes, ops), bound_dense_ms=dense["bound_ms"],
                bound_dense_by=dense["bound_by"],
                bound_dense_operations=dense["bound_operations"])


def mt_bound(rt, work, n, is_any):
    """The least the function needs, whatever implements it: every pair up
    to the point where it can be ruled out, the normal once a triangle, and
    one whole test for each ray that is hit."""
    ntris = rt.tables["tri_v0"].shape[0]
    nbytes = ntris * 37 + n * 32 + n * (1 if is_any else 16)
    return _bound(nbytes, work["tri_tests"] * OPS_MT_PAIR
                  + ntris * OPS_MT_NORMAL + work["rays_hit"] * OPS_MT_HIT)


def tlas_adapters(tlas):
    """`ops.tlas` in the (t, u, v, prim) shape `check_kernels` compares: the
    instance is folded into prim as instance * pool_rows + pool_row.  With
    `work=`, the plain versions also count under `work["needed"]` what the
    final outputs need (`tlas_bound`): the plain walk again over each ray's
    final window, [tmin, t] (closest) or [tmin, tmax] of the unoccluded rays
    (any), plus the number of occluded rays."""
    def fold(tb, out):
        t, u, v, row, inst = out
        return t, u, v, torch.where(row >= 0,
                                    inst * tb["tl_tris"].shape[0] + row, row)

    def tlas_closest(tb, *rays, mask_bit):
        return fold(tb, tlas.tlas_closest(tb, *rays, mask_bit=mask_bit))

    def tlas_closest_plain(tb, *rays, mask_bit=0xF, work=None):
        out = tlas.tlas_closest_plain(tb, *rays, mask_bit=mask_bit, work=work)
        if work is not None:
            work["needed"] = {}
            tlas.tlas_closest_plain(tb, *rays[:3], out[0], mask_bit=mask_bit,
                                    work=work["needed"])
        return fold(tb, out)

    def tlas_any_plain(tb, *rays, mask_bit=0xF, work=None):
        occ = tlas.tlas_any_plain(tb, *rays, mask_bit=mask_bit, work=work)
        if work is not None:
            work["needed"] = {"occluded": int(occ.sum())}
            tlas.tlas_any_plain(tb, *(x[~occ] for x in rays),
                                mask_bit=mask_bit, work=work["needed"])
        return occ
    return tlas_closest, tlas_closest_plain, tlas.tlas_any, tlas_any_plain


def check_tlas_extras(tlas, rt2, recs, dev):
    """Kernel 3 beyond the common checks.  (a) A second table set, two
    shapes of 160 and 10 clusters (the second no multiple of 8) under 144
    instances: the 3 ray sets x 3 masks of `check_kernels` at 65536 and at
    4096 rays.  (b) Every kernel 3 check must be bit-equal: no prim
    mismatch, no exact-t tie to forgive, max abs err 0.0."""
    tb = rt2.tables
    fns = tlas_adapters(tlas)
    sets = {"coherent": camera_rays(rt2, int(np.sqrt(N_RAYS)), dev),
            "incoherent": random_rays(rt2, N_RAYS, 11, dev)}
    sets["secondary"] = secondary_rays(sets["coherent"], fns[1], tb, 12)
    short = {k: tuple(x[::N_RAYS // TAIL_RAYS].contiguous() for x in v)
             for k, v in sets.items()}
    rec_c = dict(rays=0, checks=[], max_abs_err=0.0)
    rec_a = dict(rays=0, checks=[], max_abs_err=0.0)
    compare_sets(tb, sets, *fns, rec_c, rec_a, width="/two-shapes")
    compare_sets(tb, short, *fns, rec_c, rec_a,
                 width=f"/two-shapes/{TAIL_RAYS}")
    for name, rec in (("tlas_closest", rec_c), ("tlas_any", rec_a)):
        recs[name]["rays"] += rec["rays"]
        recs[name]["checks"] += rec["checks"]
        recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"],
                                        rec["max_abs_err"])
    recs["tlas_closest"]["two_shapes"] = dict(
        instances=int(tb["tl_inst"].shape[0]),
        clusters_per_shape=sorted({int(c) for c in tb["tl_inst"][:, 8]}),
        tl_ctree=list(tb["tl_ctree"].shape))
    rc = recs["tlas_closest"]
    ties = sum(c["ties"] for c in rc["checks"])
    if rc["max_abs_err"] != 0.0 or ties:
        fail(f"tlas_closest: not the plain version's bits (max abs err "
             f"{rc['max_abs_err']}, {ties} exact-t ties with another prim)")


def mt_adapters(mt, tb):
    """`ops.mt_intersect` behind the (tables, rays, mask_bit=) signature.  Its
    visibility is a bool per triangle: none for camera rays, the scene's own
    flags for bounce rays, and every third triangle switched off for shadow
    rays, so that the mask is exercised.  A closest-hit ray tests every
    triangle; an any-hit ray stops at its first hit."""
    from ignis_tpu_torch.ops.packet_bvh import (MASK_BOUNCE, MASK_CAMERA,
                                                MASK_SHADOW)
    from ignis_tpu_torch.render.integrator import _tri_mask_for
    ntris = tb["tri_v0"].shape[0]
    thirds = torch.arange(ntris, device=tb["tri_v0"].device) % 3 != 0
    masks = {MASK_CAMERA: None, MASK_BOUNCE: _tri_mask_for(tb, MASK_BOUNCE),
             MASK_SHADOW: thirds, 0xF: None}
    geo = lambda tb: (tb["tri_v0"], tb["tri_e1"], tb["tri_e2"])

    def mt_closest(tb, *rays, mask_bit):
        return mt.mt_closest(*rays, *geo(tb), tri_mask=masks[mask_bit])

    def mt_closest_plain(tb, *rays, mask_bit=0xF, work=None):
        out = mt.mt_closest_plain(*rays, *geo(tb), tri_mask=masks[mask_bit])
        if work is not None:
            work["tri_tests"] = rays[0].shape[0] * ntris
            work["rays_hit"] = int((out[3] >= 0).sum())
        return out

    def mt_any(tb, *rays, mask_bit):
        return mt.mt_any(*rays, *geo(tb), tri_mask=masks[mask_bit])

    def mt_any_plain(tb, *rays, mask_bit=0xF, work=None):
        first = mt._sweep_plain(*rays, *geo(tb), masks[mask_bit], True)[3]
        if work is not None:
            work["tri_tests"] = int(torch.where(first >= 0, first + 1,
                                                ntris).sum())
            work["rays_hit"] = int((first >= 0).sum())
        return first >= 0
    return mt_closest, mt_closest_plain, mt_any, mt_any_plain


def check_mt_extras(mt, rt, recs, dev):
    """Kernel 4 beyond the common checks.  (a) The soup twice over, so that
    every triangle's copy lies in another range of the split sweep: closest
    hit and occlusion bit-equal to the plain versions at both widths, and
    every hit reported at the later copy.  (b) t, u, v of every check so
    far must be the plain version's bits."""
    tb = rt.tables
    ntris = tb["tri_v0"].shape[0]
    twice = [torch.cat([tb[k], tb[k]]) for k in ("tri_v0", "tri_e1", "tri_e2")]
    prim = camera_rays(rt, int(np.sqrt(N_RAYS)), dev)
    full = secondary_rays(prim, lambda tb_, *r: mt.mt_closest_plain(
        *r, tb["tri_v0"], tb["tri_e1"], tb["tri_e2"]), tb, 12)
    dup = []
    for rays in (full, tuple(x[::N_RAYS // TAIL_RAYS].contiguous()
                             for x in full)):
        n = rays[0].shape[0]
        got = mt.mt_closest(*rays, *twice)
        ref = mt.mt_closest_plain(*rays, *twice)
        seg = rays[:3] + (torch.full_like(rays[3], 4.0),)
        occ = mt.mt_any(*seg, *twice)
        occ_ref = mt.mt_any_plain(*seg, *twice)
        torch.cuda.synchronize()
        c = compare_closest(f"mt_closest/duplicated/{n}", got, ref)
        early = int(((got[3] >= 0) & (got[3] < ntris)).sum())
        bad = int((occ != occ_ref).sum())
        if c["ties"] or c["max_abs_dt"] or c["max_duv"] or early or bad:
            fail(f"mt/duplicated/{n}: {c}, {early} hits at the earlier copy, "
                 f"{bad} occlusion mismatches")
        dup.append(dict(rays=n, triangles=2 * ntris, **c,
                        occlusion_mismatch=bad))
        for name in ("mt_closest", "mt_any"):
            recs[name]["rays"] += n
    recs["mt_closest"]["duplicated"] = dup
    if recs["mt_closest"]["max_abs_err"] != 0.0:
        fail("mt_closest: t, u, v are not the plain version's bits "
             f"(max abs err {recs['mt_closest']['max_abs_err']})")


def _bound(nbytes, ops):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations",
                bound_bytes=int(nbytes), bound_operations=int(ops))


def reset_counts(fns):
    for f in fns:
        f.launches = 0


# the kernels each main path must launch, once each in every wave iteration
PATH_KERNELS = {
    "demo": ("bw_closest", "bw_any"),
    "big": ("packet_bvh_closest", "packet_bvh_any"),
    "instanced": ("tlas_closest", "tlas_any", "bw_closest", "bw_any"),
    "sweep": ("mt_closest", "mt_any"),
}


def timed_steps(path, rt, steps, spi, wrappers):
    """Drive one main path: counts to 0, a first step and `steps` timed
    steps, counts read.  The launches of the path's kernels must each equal
    the wave iterations, a wave must be as wide as the kernel checks were,
    and the frame must be finite.  Returns a dict of
    first-step seconds, seconds per step, launches and the wave's counters."""
    reset_counts(wrappers)
    torch.cuda.synchronize()
    ta = time.perf_counter()
    rt.step(spi=spi)                         # first step, also the warm-up
    first = time.perf_counter() - ta
    ta = time.perf_counter()
    for _ in range(steps):
        rt.step(spi=spi)
    dt = (time.perf_counter() - ta) / steps
    launches = {f.__name__: f.launches for f in wrappers}
    img = rt.currentFrame()
    if img.shape != (rt.height, rt.width, 3) or not np.isfinite(img).all():
        fail(f"{path} frame is not finite (height, width, 3)")
    ds = rt._dev_stats.cpu().numpy()
    iters = int(ds[0] + ds[2])
    names = PATH_KERNELS[path]
    if iters <= 0 or any(launches[k] != iters for k in names):
        fail(f"{path}: launches {launches} do not match {iters} wave "
             f"iterations (one launch of each of {names} in each)")
    if rt._dev_stats_capacity != N_RAYS:
        fail(f"{path}: a wave holds {rt._dev_stats_capacity} rays, not the "
             f"{N_RAYS} its kernels were checked and timed at")
    nsamp = rt.width * rt.height * spi
    return dict(
        steps=steps, spi=spi, film=[rt.width, rt.height],
        first_step_seconds=round(first, 4), step_seconds=round(dt, 4),
        msamples_per_s=round(nsamp / dt / 1e6, 4), launches=launches,
        wave_iterations=int(ds[0]), tail_iterations=int(ds[2]),
        capacity=int(rt._dev_stats_capacity),
        occupancy=float(ds[1] / max(iters, 1) / rt._dev_stats_capacity),
        mean=float(img.mean()))


def kernel_and_plain_means(path, rt, spi, patches, mean_kernel=None):
    """Image mean with the kernels against the mean with `patches` ({name in
    the integrator: plain version}) in their place, on `rt` at the same seed.
    `mean_kernel`, when given, is a kernel render made elsewhere (a larger
    film of the same scene); else `rt` renders it too."""
    from ignis_tpu_torch.render import integrator
    if mean_kernel is None:
        mean_kernel = render_mean(rt, spi)
    with mock.patch.multiple(integrator, **patches):
        mean_plain = render_mean(rt, spi)
    rel = abs(mean_kernel - mean_plain) / abs(mean_plain)
    if rel > MEAN_REL:
        fail(f"{path}: kernel render mean {mean_kernel} vs plain-version "
             f"render {mean_plain}")
    return dict(mean_kernel=mean_kernel, mean_plain=mean_plain, rel_diff=rel,
                plain_film=[rt.width, rt.height])


def render_mean(rt, spi):
    rt.reset()
    rt.step(spi=spi)
    img = rt.currentFrame()
    if not np.isfinite(img).all():
        fail("render holds non-finite values")
    return float(img.mean())


def sweep_runtime(film, dev):
    """The sweep scene's compiled tables as they are, plus the shading rows:
    neither Baldwin-Weber nor packet rows, so the whole-soup kernel runs."""
    from ignis_tpu_torch.api import Runtime, pack_tri_shade
    from ignis_tpu_torch.scene.compile import load_and_compile
    from ignis_tpu_torch.scenes import big_scene
    scene = load_and_compile(big_scene(**SWEEP_SCENE), film, film)
    tables = dict(scene.tables)
    tables["tri_shade"] = pack_tri_shade(tables)
    rt = Runtime.from_compiled(scene, tables, device=dev)
    if "bw_tris" in rt.tables or "pb_rows" in rt.tables:
        fail("the sweep scene's tables are accelerated")
    return rt


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs the port on a GPU "
              "and does not fall back to the CPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    # the port itself: without it beside this script nothing is printed
    from ignis_tpu_torch import native
    from ignis_tpu_torch.api import Runtime
    from ignis_tpu_torch.ops import bw_intersect as bw
    from ignis_tpu_torch.ops import mt_intersect as mt
    from ignis_tpu_torch.ops import packet_bvh as pb
    from ignis_tpu_torch.ops import tlas
    from ignis_tpu_torch.scene.compile import load_and_compile
    from ignis_tpu_torch.scenes import big_scene, demo_scene, instanced_scene

    # ---- 1. device
    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit("device", t0, kind=kind, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    # ---- 2. build
    t0 = time.perf_counter()
    native.library()
    emit("build", t0, build_seconds=round(native.build_info["seconds"], 3),
         cached=native.build_info["cached"], nvcc=native.nvcc_release(),
         sources=[f"ignis_tpu_torch/csrc/{s}" for s in native.SOURCES],
         flags=" ".join(native.NVCC_FLAGS),
         ptxas=[l.strip() for l in native.build_info.get("log", "").splitlines()
                if "registers" in l or "spill" in l])

    wrappers = (bw.bw_closest, bw.bw_any, pb.packet_bvh_closest,
                pb.packet_bvh_any, tlas.tlas_closest, tlas.tlas_any,
                mt.mt_closest, mt.mt_any)

    # ---- scenes: compile and build the tables once
    t0 = time.perf_counter()
    rt_demo = Runtime(demo_scene(), width=FILM, height=FILM, device=dev)
    t1 = time.perf_counter()
    rt_big = Runtime(big_scene(**BIG_SCENE), width=FILM, height=FILM,
                     device=dev)
    sec = rt_big.stats.sections
    rt_big2 = Runtime(big_scene(**BIG_SECOND), width=FILM, height=FILM,
                      device=dev)
    t2 = time.perf_counter()
    rt_inst = Runtime(instanced_scene(), width=FILM, height=FILM, device=dev)
    isec = rt_inst.stats.sections
    rt_two = Runtime(instanced_scene(12, 3, second_subdiv=1), width=FILM,
                     height=FILM, device=dev)
    t3 = time.perf_counter()
    rt_sweep = sweep_runtime(FILM, dev)
    emit("scenes", t0, demo_seconds=round(t1 - t0, 3),
         instanced_seconds=round(t3 - t2, 3),
         instanced_compile_seconds=round(isec["loading"].total, 3),
         instanced_table_build_seconds=round(
             isec["build_bvh"].total + isec["build_traversal_tables"].total
             + isec["build_tlas"].total + isec["build_cluster_tree"].total, 3),
         instanced_cluster_tree_seconds=round(
             isec["build_cluster_tree"].total, 4),
         tl_ctree=list(rt_inst.tables["tl_ctree"].shape),
         instances=int(rt_inst.tables["tl_inst"].shape[0]),
         pool_rows=int(rt_inst.tables["tl_tris"].shape[0]),
         instanced_soup_tris=int(rt_inst.tables["tri_v0"].shape[0]),
         analytic_spheres=int(rt_inst.tables["sph_rows"].shape[0]),
         tl_top=list(rt_inst.tables["tl_top"].shape),
         tl_depth=int(rt_inst.tables["tl_depth"]),
         sweep_seconds=round(time.perf_counter() - t3, 3),
         sweep_tris=int(rt_sweep.tables["tri_v0"].shape[0]),
         demo_tris=int(rt_demo.tables["tri_v0"].shape[0]),
         big_seconds=round(t2 - t1, 3),
         big_compile_seconds=round(sec["loading"].total, 3),
         big_table_build_seconds=round(
             sec["build_bvh"].total + sec["build_traversal_tables"].total, 3),
         big_pb_nodes_seconds=round(sec["build_pb_nodes"].total, 4),
         big_tris=int(rt_big.tables["tri_v0"].shape[0]),
         pb_rows=list(rt_big.tables["pb_rows"].shape),
         pb_nodes=list(rt_big.tables["pb_nodes"].shape),
         pb_depth=int(rt_big.tables["pb_depth"]),
         big_second_tris=int(rt_big2.tables["tri_v0"].shape[0]))

    # ---- 3. kernels, each against its plain version on the card
    t0 = time.perf_counter()
    recs = {}
    recs.update(check_kernels(rt_demo, bw.bw_closest, bw.bw_closest_plain,
                              bw.bw_any, bw.bw_any_plain, dev, bw_bound))
    recs.update(check_kernels(rt_big, *pb_adapters(pb), dev, pb_bound,
                              tail=TAIL_RAYS))
    check_pb_extras(pb, rt_big2, recs, dev)
    recs.update(check_kernels(rt_inst, *tlas_adapters(tlas), dev, tlas_bound,
                              tail=TAIL_RAYS))
    check_tlas_extras(tlas, rt_two, recs, dev)
    recs.update(check_kernels(rt_sweep, *mt_adapters(mt, rt_sweep.tables),
                              dev, mt_bound, tail=TAIL_RAYS))
    check_mt_extras(mt, rt_sweep, recs, dev)
    # every kernel on rays with subnormal, infinite and NaN components that
    # start on the faces of its own boxes
    tb = rt_demo.tables
    check_float_rules(tb, (bw.bw_closest, bw.bw_closest_plain, bw.bw_any,
                           bw.bw_any_plain),
                      tb["bw_clusters"][:, :6].cpu(), recs, dev)
    rows = rt_big.tables["pb_rows"].cpu().numpy()
    check_float_rules(rt_big.tables, pb_adapters(pb),
                      rows[rows[:, 126] <= 0.5][:, :48].reshape(-1, 6), recs,
                      dev)
    tb = rt_inst.tables
    top = tb["tl_top"].cpu().numpy()
    check_float_rules(tb, tlas_adapters(tlas), np.concatenate([
        tb["tl_inst"][:, :6].cpu().numpy(), tb["tl_clust"][:, :6].cpu().numpy(),
        top[top[:, 126] <= 0.5][:, :48].reshape(-1, 6)]), recs, dev)
    tb = rt_sweep.tables
    corners = torch.stack([tb["tri_v0"], tb["tri_v0"] + tb["tri_e1"],
                           tb["tri_v0"] + tb["tri_e2"]])
    check_float_rules(tb, mt_adapters(mt, tb), torch.cat(
        [corners.amin(0), corners.amax(0)], 1).cpu(), recs, dev)
    emit("kernels", t0, tolerance=dict(t_rel=T_REL, uv_abs=UV_ABS),
         kernels=recs)

    # ---- 4. demo: the Baldwin-Weber path
    t0 = time.perf_counter()
    runs = {}
    runs["demo"] = timed_steps("demo", rt_demo, 1, 4, wrappers)
    means = kernel_and_plain_means("demo", rt_demo, 4, dict(
        bw_closest=bw.bw_closest_plain, bw_any=bw.bw_any_plain))
    emit("demo", t0, **runs["demo"], **means, stats=rt_demo.dumpStats())

    # ---- 5. big: the packet-BVH path
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    runs["big"] = timed_steps("big", rt_big, 3, 1, wrappers)
    peak = torch.cuda.max_memory_allocated()
    # the same scene at a quarter of the film size through the plain
    # traversal, on the card
    small = load_and_compile(big_scene(**BIG_SCENE), FILM // 4, FILM // 4)
    small_tables = dict(small.tables)
    # the traversal and shading tables do not depend on the film: reuse them
    for k in ("pb_rows", "pb_nodes", "pb_bounds", "pb_depth", "tri_shade"):
        v = rt_big.tables[k]
        small_tables[k] = v.cpu().numpy() if torch.is_tensor(v) else v
    rt_small = Runtime.from_compiled(small, small_tables, device=dev)
    means = kernel_and_plain_means("big", rt_small, 4, dict(
        packet_bvh_closest=pb.packet_bvh_closest_plain,
        packet_bvh_any=pb.packet_bvh_any_plain),
        mean_kernel=runs["big"]["mean"])
    emit("big", t0, **runs["big"], peak_memory_bytes=int(peak), **means)

    # ---- 6. instanced: the two-level kernel beside Baldwin-Weber (floor and
    # lamp) and the analytic spheres
    t0 = time.perf_counter()
    runs["instanced"] = timed_steps("instanced", rt_inst, 3, 1, wrappers)
    # kernels against plain versions on the same scene at a quarter of the
    # film size, same seed
    rt_small = Runtime(instanced_scene(), width=FILM // 4, height=FILM // 4,
                       device=dev)
    means = kernel_and_plain_means("instanced", rt_small, 4, dict(
        tlas_closest=tlas.tlas_closest_plain, tlas_any=tlas.tlas_any_plain,
        bw_closest=bw.bw_closest_plain, bw_any=bw.bw_any_plain))
    emit("instanced", t0, **runs["instanced"], **means,
         stats=rt_inst.dumpStats())

    # ---- 7. sweep: un-accelerated tables through the Moeller-Trumbore
    # kernel, at the full film, so a wave is N_RAYS wide as in the check above
    t0 = time.perf_counter()
    runs["sweep"] = timed_steps("sweep", rt_sweep, 2, 1, wrappers)
    # kernels against plain versions at a quarter of the film size, same seed
    means = kernel_and_plain_means(
        "sweep", sweep_runtime(FILM // 4, dev), 1, dict(
            mt_closest=mt.mt_closest_plain, mt_any=mt.mt_any_plain))
    emit("sweep", t0, **runs["sweep"], **means)

    # ---- the kernels line: launches are those of the main paths' runs, in
    # all and for each path that has to launch the kernel
    by_path = {}
    for path, names in PATH_KERNELS.items():
        for name in names:
            n = runs[path]["launches"][name]
            if n <= 0:
                fail(f"kernel {name} was not launched on path {path}")
            by_path.setdefault(name, {})[path] = n
    meta = {
        "bw_closest": ("ignis_tpu_torch/csrc/bw_intersect.cu",
                       "ignis_tpu/ops/bw_intersect.py:295"),
        "bw_any": ("ignis_tpu_torch/csrc/bw_intersect.cu",
                   "ignis_tpu/ops/bw_intersect.py:295"),
        "packet_bvh_closest": ("ignis_tpu_torch/csrc/packet_bvh.cu",
                               "ignis_tpu/ops/pallas_bvh.py:507"),
        "packet_bvh_any": ("ignis_tpu_torch/csrc/packet_bvh.cu",
                           "ignis_tpu/ops/pallas_bvh.py:507"),
        "tlas_closest": ("ignis_tpu_torch/csrc/tlas.cu",
                         "ignis_tpu/ops/bw_tlas.py:437"),
        "tlas_any": ("ignis_tpu_torch/csrc/tlas.cu",
                     "ignis_tpu/ops/bw_tlas.py:437"),
        "mt_closest": ("ignis_tpu_torch/csrc/mt_intersect.cu",
                       "ignis_tpu/ops/pallas_intersect.py:144"),
        "mt_any": ("ignis_tpu_torch/csrc/mt_intersect.cu",
                   "ignis_tpu/ops/pallas_intersect.py:167"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = recs[name]
        if name not in by_path:
            fail(f"kernel {name} is on no main path")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path[name].values()),
            launches_by_path=by_path[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            device_ms=r["device_ms"],
            coherent_ms=r["coherent_ms"], incoherent_ms=r["incoherent_ms"],
            rays_per_launch=r["rays_per_launch"],
            **{k: r[k] for k in ("tail_rays", "tail_ms", "tail_device_ms",
                                 "tail_bound_ms", "tail_bound_by",
                                 "bound_walk_ms", "bound_walk_by",
                                 "bound_dense_ms", "bound_dense_by")
               if k in r}))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
