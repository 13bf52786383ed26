#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ignis_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

It builds the CUDA kernels from `ignis_tpu_torch/csrc/` with `nvcc`, holds
each kernel against its plain PyTorch version on the card, and drives the
port's main path (`Runtime.step` of the `path` technique) on four scenes: the
demo box through the Baldwin-Weber kernels, the 512,002-triangle field through
the packet-BVH kernels, 1024 instances of one mesh beside analytic spheres
through the two-level kernel, and a 32,002-triangle soup with un-accelerated
tables through the whole-soup Moeller-Trumbore kernel.  Every kernel is also
checked and timed at the width of a tail wave (4096 rays, `tail_ms` /
`tail_device_ms`); the Baldwin-Weber kernel also on a second table set (a
3,842-triangle field, whose cluster tree has two levels), the packet-BVH
kernel on a second table set (a 46,082-triangle field), the two-level kernel
on a second table set (two shapes, 144 instances), the whole-soup kernel on
the soup twice over, whose copies fall into different ranges of its split
sweep; all four must give the plain versions' bits.  Every kernel is also
held to its plain version, bit for bit, on rays with subnormal, infinite and
NaN components that start on box faces (the JAX package's float rules,
`ops.ref_float`; for the Baldwin-Weber kernel also the faces of its cluster
tree's nodes).  The backward of the parameter tables' row gathers
(`core.dgather.gather_rows_backward`, `csrc/row_scatter.cu`) is held to the
float64 sum and to its plain version within the error bound of its serial
additions, and to itself bit for bit, and timed beside its plain version
and the library's `index_put_(accumulate=True)`, at the `cbox.inverse`
benchmark cell's shapes (`row_scatter`); the gradient phases count its calls
a call.  Then the second path: the materials scene (rough conductor and
dielectric, plastic, phong, principled, a two-lobe blend and a constant
normal modifier) through `Runtime.step`; the gradient of the demo's summed
differentiable render with respect to `mat_colors` at 2^19 lanes
(`trace_wave(differentiable=True)`, held to the gradient taken with the
plain traversal); five SGD steps of `parallel.sharding.train_step` on the
materials scene, whose losses must fall; and the textured scene (image,
checkerboard, brick, noise and PExpr textures on color slots, a blend weight,
normal, bump and PExpr normals and a uniformly sampled image environment)
through `Runtime.step`, a registry change on its next frame, and the gradient
of its summed differentiable render with respect to its albedo texels and
its registry at 2^18 lanes.  Last the light breadth (`lights`): a furnished
room under a sun, a Hosek-Wilkie sky through a window and 256 spot lights
under the light hierarchy (the packet-BVH kernels), and the demo box under
an HDR environment sampled by its summed-area table and 64 point lights
under the flux CDF (the Baldwin-Weber kernels), through `Runtime.step`, each
held to its plain traversal; the hierarchy's pdfs, the CDF tables' sample /
pdf agreement and CPU-vs-card light samples checked on the card; and the
gradient of the room's differentiable render with respect to the light rows
and the baked sky image.  Then participating media (`media`): the demo box
under the `volpath` technique with a scattering and an absorb-only medium in
glass spheres, a 128^3 NanoVDB cloud under delta tracking (ratio tracking for
its transmittance) and an emissive 64^3 voxel grid, through `Runtime.step`
on the Baldwin-Weber kernels, held to its plain traversal; the media
functions CPU vs card; the gradient with respect to the media's rows and
shader rows.  Last measured materials (`measured`): the daylight room with a
Klems and a TensorTree pane in its window and Dupuy-Jakob spheres, through
`Runtime.step` on the packet-BVH kernels, held to its plain traversal, and
its gradient with respect to the material colors.  Then the techniques
(`techniques`): the demo box under `ao`, `infobuffer`, `wireframe` and three
debug modes, under the mjitt and Halton samplers, an orthogonal camera and an
entity hidden from the camera (the per-sample driver), each held to its plain
traversal; the samplers' draws and the cameras' rays CPU vs card; the
daylight room under a fishlens camera on the packet-BVH kernels, with
`tonemap`, `imageinfo` and `evaluateGlare` on its frame (the DGP held to the
CPU's); the denoiser; a checkpoint's bitwise resume.  Last light transport
(`transport`): the demo box (the Baldwin-Weber kernels) and the daylight
room (the packet-BVH kernels; the sun, the sky and 256 spots emit) under the
light tracer, 262,144 light paths a step in four tiles, each frame's mean
held to the plain traversal's within 1e-5 (the splat's atomic sums differ in
order); the demo box under the photon mapper with 1,000,000 photons a step,
its photon buffer and frame held bit for bit to the plain traversal's, its
photon pass, grid and camera pass timed apart and one gather profiled; light
emission of every light type of both scenes CPU vs card.  Last the frontends
(`frontends`), each a main path with its counts zeroed just before it: igcli
on the demo box with its default flags, which walks the per-lane stack BVH
(`ops.bvh`) and must launch no kernel (its host syncs counted, its mean
within 2 % of `--no-bvh`'s; the walk card vs CPU on 65,536 rays), igcli with
`--no-bvh` (kernel 1, the frame bit-equal to the plain traversal's) and on
the daylight room (kernel 2), igtrace on 65,536 rays from a file (equal to
`Runtime.trace`), igview's `--fly` over three poses (each EXR equal to a
`Runtime`'s frame after `setCameraOrientationParameter`), the explicit work
list (within rtol 2e-4 of the arithmetic one), and a 2^18-lane render over two
gloo ranks spawned on the card and over NCCL at world size 1 (bit-equal to
one process; the sharded train step within 1e-6).  The run's asset cache is a
fresh directory under `build/ignis_tpu_torch/`, so the `scenes` phase times
`big`'s first load (tables built) and its second (read back).  Every phase
prints one JSON line with its seconds.  Any failed phase ends the run with a
non-zero exit code; nothing falls back to the CPU.  The last line of the output is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

N_RAYS = 65536            # rays per kernel check, = the wave capacity
TAIL_RAYS = 4096          # rays of a tail wave (`render_wavefront`'s default)
FILM = 512                # film width and height of the headline scenes
BIG_SCENE = dict(n_spheres=25, subdiv=5)   # 512,002 triangles
BIG_SECOND = dict(n_spheres=9, subdiv=4)   # 46,082 triangles: kernel 2's second table set
BW_SECOND = dict(n_spheres=3, subdiv=3)    # 3,842 triangles: kernel 1's second table set
RULE_RAYS = 8192          # float-rule rays per kernel check
SWEEP_SCENE = dict(n_spheres=25, subdiv=3)  # 32,002 triangles, no tables
T_REL, UV_ABS = 1e-5, 1e-4  # kernel vs plain: |dt|/max(1,|t|), |du|, |dv|
MEAN_REL = 0.02           # kernel render vs plain render, image mean
FWDBWD_LANES = 1 << 19    # lanes of the gradient phase (`phase_fwdbwd`'s)
GRAD_REL = 1e-4           # its gradient, kernels vs plain traversal
TRAIN_STEPS, TRAIN_LR = 5, 0.5
# the row scatter's checks: the cbox.inverse benchmark cell's lanes, (rows,
# columns) of its tables (mat_colors (4, 4, 3), light_data (1, 32)) and of a
# table cut into row slabs, and the share of the lanes in each row
SCATTER_LANES = 1 << 18
SCATTER_CASES = {"mat_colors": (4, 12, (0.7, 0.1, 0.1, 0.1)),
                 "light_data": (1, 32, (1.0,)),
                 "row_slabs": (300, 12, None)}
TEXTURED_LANES = 1 << 18  # lanes of the textured scene's gradient
DAYLIGHT_LANES = 1 << 18  # lanes of the daylight room's gradient
LIGHT_FILM = 128          # film of the lights' kernel-vs-plain renders
HIER_POINTS = 4096        # points of the hierarchy's pdf checks
CDF_DRAWS = 1 << 20       # draws of the CDF tables' sample / pdf check
CDF_REL = 1e-5
HIER_SUM_ABS = 1e-4
HIER_PDF_REL = 1e-5
DIR_ABS = 1e-5            # CPU vs card: sampled light directions
MEDIA_LANES = 1 << 18     # lanes of the media box's gradient
MEASURED_LANES = 1 << 18  # lanes of the measured room's gradient
POS_ABS = 1e-5            # CPU vs card: medium samples' positions and
                          # transmittance
# the path technique's clamp of each contribution in the `train` phase: a
# few unclamped firefly lanes (up to 6,064 in a 512x512 render of the
# materials scene on an H100, the JAX package's render the same there:
# scripts/torch_fireflies.py, tests/test_torch_materials_fireflies.py) rule
# a squared-error loss and its gradient
TRAIN_CLAMP = 10.0
RAY_ABS = 1e-6            # CPU vs card: orthogonal and fishlens camera rays
# card vs CPU: the DGP of one frame.  A pixel's solid angle is the float32
# spherical excess, four angles near pi less 2 pi, as the reference takes
# it: it keeps 2 pi's rounding, some 1 % of a 512x512 pixel's solid angle,
# so the last bit of `arccos`, which differs between the card and the CPU,
# moves the DGP (1.5e-5 on the fishlens daylight frame, H100)
DGP_REL = 1e-4
# 512x512 Halton: stride 2^9 * 3^6 = 373,248; index * stride passes 2^32
# after 11,507 samples
HALTON_PAST_WRAP = 11508
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
        recs[fn.__name__].setdefault("float_rules", []).append(dict(
            rays=RULE_RAYS, masks=3, mismatch=0, hits=hits,
            occluded=occluded))


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
    """What the function needs, whatever implements it (`work["needed"]`,
    counted by `bw_adapters` over the final outputs): a box test and 8
    triangle tests for each cluster whose box the ray's final window [tmin,
    t] crosses; an occluded any-hit ray one cluster's box and triangles.
    The tables once, rays in, results out.  `bound_dense_*`: the same bytes
    over the dense sweep's work (every ray box-tests every cluster), which
    the kernel did before it walked a cluster tree."""
    tb = rt.tables
    nbytes = (tb["bw_tris"].numel() + tb["bw_clusters"].numel()) * 4 \
        + n * 32 + n * (1 if is_any else 16)
    need = work["needed"]
    entered = need["tri_tests"] // 8 + need.get("occluded", 0)
    dense = _bound(nbytes, work["box_tests"] * OPS_BOX
                   + work["tri_tests"] * OPS_BW_TRI)
    return dict(_bound(nbytes, entered * (OPS_BOX + 8 * OPS_BW_TRI)),
                bound_dense_ms=dense["bound_ms"],
                bound_dense_by=dense["bound_by"],
                bound_dense_operations=dense["bound_operations"])


def bw_adapters(bw):
    """`ops.bw_intersect` with plain versions that, with `work=`, also count
    under `work["needed"]` what the final outputs need (`bw_bound`): the
    dense sweep again over each ray's final window, [tmin, t] (closest) or
    [tmin, tmax] of the unoccluded rays (any), plus the number of occluded
    rays."""
    def bw_closest_plain(tb, *rays, mask_bit=0xF, work=None):
        out = bw.bw_closest_plain(tb, *rays, mask_bit=mask_bit, work=work)
        if work is not None:
            work["needed"] = {}
            bw.bw_closest_plain(tb, *rays[:3], out[0], mask_bit=mask_bit,
                                work=work["needed"])
        return out

    def bw_any_plain(tb, *rays, mask_bit=0xF, work=None):
        occ = bw.bw_any_plain(tb, *rays, mask_bit=mask_bit, work=work)
        if work is not None:
            work["needed"] = {"occluded": int(occ.sum())}
            bw.bw_any_plain(tb, *(x[~occ] for x in rays), mask_bit=mask_bit,
                            work=work["needed"])
        return occ
    return bw.bw_closest, bw_closest_plain, bw.bw_any, bw_any_plain


def check_bw_extras(bw, rt2, recs, dev):
    """Kernel 1 beyond the common checks.  (a) A second table set, the
    3,842-triangle field (481 clusters under a tree of two levels): the 3 ray
    sets x 3 masks of `check_kernels` at 65536 rays, and its times and bound
    on the secondary rays (`second_ms`, `second_device_ms`,
    `second_bound_ms`).  (b) Every kernel 1 check must be bit-equal: no prim
    mismatch, no exact-t tie to forgive, max abs err 0.0."""
    from ignis_tpu_torch.ops.packet_bvh import MASK_BOUNCE, MASK_SHADOW
    tb = rt2.tables
    fns = bw_adapters(bw)
    sets = {"coherent": camera_rays(rt2, int(np.sqrt(N_RAYS)), dev),
            "incoherent": random_rays(rt2, N_RAYS, 11, dev)}
    sets["secondary"] = secondary_rays(sets["coherent"], fns[1], tb, 12)
    rec_c = dict(rays=0, checks=[], max_abs_err=0.0)
    rec_a = dict(rays=0, checks=[], max_abs_err=0.0)
    compare_sets(tb, sets, *fns, rec_c, rec_a, width="/second")
    for name, rec in (("bw_closest", rec_c), ("bw_any", rec_a)):
        recs[name]["rays"] += rec["rays"]
        recs[name]["checks"] += rec["checks"]
        recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"],
                                        rec["max_abs_err"])
    org, d, tmin, tmax = sets["secondary"]
    for fn, plain, args, mb in (
            (bw.bw_closest, fns[1], (org, d, tmin, tmax), MASK_BOUNCE),
            (bw.bw_any, fns[3], (org, d, tmin, torch.full_like(tmax, 4.0)),
             MASK_SHADOW)):
        work = {}
        plain(tb, *args, mask_bit=mb, work=work)
        bound = bw_bound(rt2, work, org.shape[0], fn is bw.bw_any)
        recs[fn.__name__].update(
            second_ms=cuda_ms(lambda: fn(tb, *args, mask_bit=mb), 10),
            second_device_ms=graph_ms(lambda: fn(tb, *args, mask_bit=mb), 10),
            second_bound_ms=bound["bound_ms"],
            second_bound_by=bound["bound_by"],
            second_bound_dense_ms=bound["bound_dense_ms"])
    recs["bw_closest"]["second_table"] = dict(
        triangles=int(tb["tri_v0"].shape[0]),
        clusters=int(tb["bw_clusters"].shape[0]),
        bw_ctree=list(tb["bw_ctree"].shape),
        tree_levels=int(tb["bw_ctree"][0, 0]))
    rc = recs["bw_closest"]
    ties = sum(c["ties"] for c in rc["checks"])
    if rc["max_abs_err"] != 0.0 or ties:
        fail(f"bw_closest: not the plain version's bits (max abs err "
             f"{rc['max_abs_err']}, {ties} exact-t ties with another prim)")


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


def row_scatter_phase(dev):
    """`gather_rows_backward` (the kernel) at `SCATTER_LANES` lanes for each
    of `SCATTER_CASES`, int32 indices as the render passes them: every cell
    within `depth` 2^-24 sum |terms| of the float64 sum and of the plain
    version, where `depth` is the most additions on the way of one term to
    its cell in the kernel's plan (its lanes in one thread, the lane groups,
    the blocks of one reduce group, the reduce groups); two calls bit-equal;
    `ms` (CUDA events), `device_ms` (graph replay), `bound_ms` (the gradient
    rows and indices read, the table written), `plain_ms` (`index_add_`) and
    `library_ms` (`index_put_(accumulate=True)`, autograd's backward of
    `table[idx]`: the yardstick, which the port never calls)."""
    from ignis_tpu_torch.core import dgather as dg
    recs = {}
    rng = np.random.default_rng(17)
    n = SCATTER_LANES
    for name, (m, k, share) in SCATTER_CASES.items():
        idx_np = rng.choice(m, n, p=share) if share else rng.integers(0, m, n)
        idx = torch.from_numpy(idx_np.astype(np.int32)).to(dev)
        idx64 = idx.long()
        g = torch.from_numpy(rng.standard_normal((n, k), np.float32)).to(dev)
        launches = dg.gather_rows_backward.launches
        got = dg.gather_rows_backward(g, idx, m)
        again = dg.gather_rows_backward(g, idx, m)
        torch.cuda.synchronize()
        if dg.gather_rows_backward.launches != launches + 2:
            fail(f"row_scatter/{name}: the wrapper did not launch the kernel")
        if not torch.equal(got, again):
            fail(f"row_scatter/{name}: two calls differ")
        g64 = g.double()
        exact = torch.zeros((m, k), dtype=torch.float64, device=dev)
        exact.index_add_(0, idx64, g64)
        absum = torch.zeros_like(exact).index_add_(0, idx64, g64.abs())
        plan = dg._plan(n, m, k, dg._sms(dev.index))
        depth = (-(-plan.lanes_per_block // plan.groups) + plan.groups
                 + -(-plan.blocks // 32) + 32)
        bound = depth * 2.0 ** -24 * absum
        plain = dg.gather_rows_backward_plain(g, idx, m)
        for other, ref in (("the float64 sum", exact),
                           ("the plain version", plain.double())):
            err = (got.double() - ref).abs()
            if not (err <= bound).all():
                fail(f"row_scatter/{name}: off {other} by "
                     f"{float((err - bound).max())} beyond the bound of "
                     f"{depth} serial additions")
        recs[name] = dict(
            lanes=n, rows=m, cols=k, plan=plan._asdict(), depth=depth,
            max_abs_err_vs_float64=float((got.double() - exact).abs().max()),
            max_abs_diff_vs_plain=float((got - plain).abs().max()),
            max_bound=float(bound.max()),
            ms=round(cuda_ms(lambda: dg.gather_rows_backward(g, idx, m), 20),
                     5),
            device_ms=round(graph_ms(
                lambda: dg.gather_rows_backward(g, idx, m), 20), 5),
            plain_ms=round(cuda_ms(
                lambda: dg.gather_rows_backward_plain(g, idx, m), 20), 5),
            library_ms=round(cuda_ms(
                lambda: torch.zeros((m, k), device=dev).index_put_(
                    (idx64,), g, accumulate=True), 5), 5),
            **_bound(n * (4 * k + idx.element_size()) + 4 * m * k, n * k))
    return recs


def _bound(nbytes, ops):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations",
                bound_bytes=int(nbytes), bound_operations=int(ops))


def reset_counts(fns):
    for f in fns:
        f.launches = 0


# the kernels each main path must launch, once each in every wave iteration
# (`fwdbwd`, `train`: once each in every bounce of the differentiable render)
PATH_KERNELS = {
    "demo": ("bw_closest", "bw_any"),
    "big": ("packet_bvh_closest", "packet_bvh_any"),
    "instanced": ("tlas_closest", "tlas_any", "bw_closest", "bw_any"),
    "sweep": ("mt_closest", "mt_any"),
    "materials": ("bw_closest", "bw_any"),
    "fwdbwd": ("bw_closest", "bw_any"),
    "train": ("bw_closest", "bw_any"),
    "textured": ("bw_closest", "bw_any"),
    "daylight": ("packet_bvh_closest", "packet_bvh_any"),
    "env": ("bw_closest", "bw_any"),
    "media": ("bw_closest", "bw_any"),
    "measured": ("packet_bvh_closest", "packet_bvh_any"),
    # the techniques phase: single-intersection techniques and the
    # per-sample driver launch once a tile of each sample (`ao` also its
    # occlusion rays), the samplers and the orthogonal camera go through
    # the wavefront, the fishlens daylight room through kernel 2
    "ao": ("bw_closest", "bw_any"),
    "infobuffer": ("bw_closest",),
    "wireframe": ("bw_closest",),
    "debug_normal": ("bw_closest",),
    "debug_prim_id": ("bw_closest",),
    "debug_albedo": ("bw_closest",),
    "mjitt": ("bw_closest", "bw_any"),
    "halton": ("bw_closest", "bw_any"),
    "orthogonal": ("bw_closest", "bw_any"),
    "hidden": ("bw_closest", "bw_any"),
    "fishlens": ("packet_bvh_closest", "packet_bvh_any"),
    # the transport phase: the light tracer's tiles launch closest and
    # any-hit rays (the camera connections), the photon mapper's passes
    # closest hits only
    "lighttracer": ("bw_closest", "bw_any"),
    "lighttracer_room": ("packet_bvh_closest", "packet_bvh_any"),
    "photonmapper": ("bw_closest",),
    # the frontends phase: igcli's default (`use_bvh=True`) walks the
    # binary tree of `ops.bvh` in tensor code and launches no kernel;
    # `--no-bvh` reaches kernel 1; the room's packet rows come before its
    # `bvh_*` tables; igtrace and the sharded ranks trace lanes through
    # `trace_wave`
    "igcli": (),
    "igcli_nobvh": ("bw_closest", "bw_any"),
    "igcli_room": ("packet_bvh_closest", "packet_bvh_any"),
    "igtrace": ("bw_closest", "bw_any"),
    "igview": ("bw_closest", "bw_any"),
    "work_list": ("bw_closest", "bw_any"),
    "sharded": ("bw_closest", "bw_any"),
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


def kernel_and_plain_means(path, rt, spi, patches, mean_kernel=None,
                           max_rel=MEAN_REL):
    """Image mean with the kernels against the mean with `patches` ({name in
    the integrator: plain version}) in their place, on `rt` at the same seed;
    their relative difference must be at most `max_rel`.
    `mean_kernel`, when given, is a kernel render made elsewhere (a larger
    film of the same scene); else `rt` renders it too."""
    from ignis_tpu_torch.render import integrator
    if mean_kernel is None:
        mean_kernel = render_mean(rt, spi)
    with mock.patch.multiple(integrator, **patches):
        mean_plain = render_mean(rt, spi)
    rel = abs(mean_kernel - mean_plain) / abs(mean_plain)
    if rel > max_rel:
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


def lanes_over_film(n, film, dev):
    """`n` lanes over a film x film image, row by row and around again:
    x = idx % film, y = (idx // film) % film."""
    idx = torch.arange(n, device=dev)
    return idx % film, (idx // film) % film


def grad_of_summed_render(rt, x, y, keys):
    """The differentiable render (detached) and d (its sum * 1e-6) / d each
    table of `keys`: the reference's `phase_fwdbwd` loss, with sample,
    iteration, frame and seed 0."""
    from ignis_tpu_torch.render.integrator import trace_wave
    tables = dict(rt.tables)
    for k in keys:
        tables[k] = rt.tables[k].detach().clone().requires_grad_(True)
    color = trace_wave(rt.scene, tables, x, y, 0, 0, 0, 0,
                       differentiable=True)
    (color.sum() * 1e-6).backward()
    return color.detach(), {k: tables[k].grad for k in keys}


def same_bits(path, got, want):
    """Fails unless the per-lane renders `got` (kernels) and `want` (plain
    traversal) hold the same float32 bits on every lane."""
    diff = (got.view(torch.int32) != want.view(torch.int32)).any(dim=-1)
    if diff.any():
        fail(f"{path}: the render with the kernels differs from the plain "
             f"traversal's on {int(diff.sum())} of {got.shape[0]} lanes")
    return int(got.shape[0])


def bw_plain(bw):
    """The plain Baldwin-Weber traversal patched into the integrator."""
    from ignis_tpu_torch.render import integrator
    return mock.patch.multiple(integrator, bw_closest=bw.bw_closest_plain,
                               bw_any=bw.bw_any_plain)


def pb_plain(pb):
    """The plain packet-BVH traversal patched into the integrator."""
    from ignis_tpu_torch.render import integrator
    return mock.patch.multiple(integrator,
                               packet_bvh_closest=pb.packet_bvh_closest_plain,
                               packet_bvh_any=pb.packet_bvh_any_plain)


def fwdbwd(path, rt, n, wrappers, plain, keys, reps):
    """A gradient phase on `rt` at `n` lanes with respect to the tables of
    `keys`: launches per call, seconds per call over `reps` calls after a
    warm-up (host clock closed by a synchronise), their peak device memory,
    and the per-lane render (bit for bit) and each gradient held to those
    taken with the plain traversal patched in (`plain()`, a context): every
    launch of the phase is `n` rays wide."""
    x, y = lanes_over_film(n, rt.width, rt.tables[keys[0]].device)
    depth = min(rt.scene.technique.max_depth, 64)
    reset_counts(wrappers)
    color, g = grad_of_summed_render(rt, x, y, keys)   # also the warm-up
    torch.cuda.synchronize()
    per_call = {f.__name__: f.launches for f in wrappers}
    if any(per_call[k] != depth for k in PATH_KERNELS[path]):
        fail(f"{path}: launches {per_call} per call, not one of each of "
             f"{PATH_KERNELS[path]} in each of {depth} bounces")
    gh = {k: v.cpu().numpy() for k, v in g.items()}
    for k, v in gh.items():
        if not np.isfinite(v).all() or not (v != 0).any():
            fail(f"{path}: the gradient w.r.t. {k} has "
                 f"{int((~np.isfinite(v)).sum())} non-finite entries or is "
                 "all zero")
    torch.cuda.reset_peak_memory_stats()
    scatters = row_scatter_counts()
    ta = time.perf_counter()
    for _ in range(reps):
        grad_of_summed_render(rt, x, y, keys)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - ta) / reps
    scatters = row_scatter_counts(scatters, reps, path)
    peak = torch.cuda.max_memory_allocated()
    launches = {f.__name__: f.launches for f in wrappers}
    with plain():
        color_plain, gp = grad_of_summed_render(rt, x, y, keys)
    lanes_equal = same_bits(path, color, color_plain)
    rels = {}
    for k in keys:
        a, b = gh[k], gp[k].cpu().numpy()
        nz = (a != 0) | (b != 0)
        rels[k] = float(np.max(np.abs(a[nz] - b[nz])
                               / np.maximum(np.abs(b[nz]), 1e-30)))
        if rels[k] > GRAD_REL:
            fail(f"{path}: kernel gradient w.r.t. {k} vs plain-traversal "
                 f"gradient: max relative difference {rels[k]} > {GRAD_REL}")
    return dict(lanes=n, bounces=depth, keys=list(keys),
                seconds_per_call=round(dt, 4),
                mrays_per_s=round(n / dt / 1e6, 4),
                peak_memory_gb=round(peak / 1e9, 3),
                grad_nonzero={k: int((v != 0).sum()) for k, v in gh.items()},
                grad_max_rel_vs_plain=rels,
                grad_bit_equal_to_plain={k: bool(torch.equal(g[k], gp[k]))
                                         for k in keys},
                render_lanes_bit_equal_to_plain=lanes_equal,
                launches_per_call=per_call, launches=launches,
                row_scatters_per_call=scatters)


def perturbed_tables(rt):
    """The `train` phase's start: `rt`'s tables with the colors x 0.7 and
    the roughness slots (0 and 4) of its microfacet materials + 0.1.
    Returns (tables, the perturbed materials)."""
    from ignis_tpu_torch.scene.compile import (
        BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIELECTRIC, BSDF_ROUGH_PLASTIC,
    )
    tables = dict(rt.tables)
    tables["mat_colors"] = rt.tables["mat_colors"] * 0.7
    rough = [i for i, t in enumerate(rt.scene.bsdf_types) if t in (
        BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIELECTRIC, BSDF_ROUGH_PLASTIC)]
    sc = rt.tables["mat_scalars"].clone()
    sc[rough, 0] += 0.1
    sc[rough, 4] += 0.1
    tables["mat_scalars"] = sc
    return tables, rough


def train(rt, steps, lr, wrappers, bw):
    """`steps` SGD steps of `parallel.sharding.train_step` from perturbed
    parameters toward the render of the true ones, one lane a pixel, the
    same seed every step.  The target and the first step's render are held
    bit for bit to the renders with the plain traversal: every launch of
    the phase is one lane a pixel wide."""
    from ignis_tpu_torch.parallel.sharding import train_step
    from ignis_tpu_torch.render.integrator import trace_wave
    dev = rt.tables["mat_colors"].device
    x, y = lanes_over_film(rt.width * rt.height, rt.width, dev)
    keys = ("mat_colors", "mat_scalars", "light_data")
    tables, rough = perturbed_tables(rt)

    def render(t):
        return trace_wave(rt.scene, t, x, y, 0, 0, 0, 0,
                          differentiable=True).detach()
    target, start = render(rt.tables), render(tables)
    with bw_plain(bw):
        same_bits("train target", target, render(rt.tables))
        lanes_equal = same_bits("train start", start, render(tables))
    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    scatters = row_scatter_counts()
    for _ in range(steps):
        ta = time.perf_counter()
        loss, tables = train_step(rt.scene, tables, x, y, 0, 0, 0, 0, target,
                                  param_keys=keys, lr=lr)
        losses.append(float(loss))                  # a synchronise
        secs.append(round(time.perf_counter() - ta, 4))
    scatters = row_scatter_counts(scatters, steps, "train")
    launches = {f.__name__: f.launches for f in wrappers}
    depth = min(rt.scene.technique.max_depth, 64)
    if any(launches[k] != depth * steps for k in PATH_KERNELS["train"]):
        fail(f"train: launches {launches} over {steps} steps of {depth} "
             "bounces")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(f"train: losses {losses} are not finite or do not fall")
    first = float(torch.mean((start - target) ** 2))
    if abs(losses[0] - first) > 1e-6 * abs(first):
        fail(f"train: the first loss {losses[0]} is not that of the start "
             f"render held to the plain traversal ({first})")
    return dict(steps=steps, lanes=int(x.shape[0]), lr=lr,
                param_keys=list(keys), rough_materials=rough, losses=losses,
                render_lanes_bit_equal_to_plain=lanes_equal,
                step_seconds=secs,
                peak_memory_gb=round(torch.cuda.max_memory_allocated() / 1e9,
                                     3),
                launches=launches, row_scatters_per_step=scatters)


def row_scatter_counts(before=None, calls=1, path=None):
    """The row scatters so far (`utils.stats.row_scatters()`, every
    backward of a parameter table's `gather_rows`) and the kernel launches
    among them (`gather_rows_backward.launches`); given the counts `before`
    `calls` calls of `path`, those made a call, which must all have taken
    the kernel."""
    from ignis_tpu_torch.core.dgather import gather_rows_backward
    from ignis_tpu_torch.utils.stats import row_scatters
    now = (row_scatters(), gather_rows_backward.launches)
    if before is None:
        return now
    scatters, launches = (a - b for a, b in zip(now, before))
    if launches != scatters:
        fail(f"{path}: {scatters} row scatters over {calls} calls, "
             f"{launches} of them on the kernel")
    return scatters / calls


def profiled_step(rt, spi):
    """One `rt.step` under `torch.profiler`, counted from the raw events
    (`key_averages()` would turn each of some 200,000 into a Python object
    first, a minute): device kernels (memsets and copies included) a wave
    iteration, their summed device time, the step's wall time (host clock
    closed by a synchronise; the profiler's own cost included) and the
    device's idle share, 1 - busy / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    before = rt._dev_stats.cpu().numpy()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ta = time.perf_counter()
        rt.step(spi=spi)
        torch.cuda.synchronize()
        wall = time.perf_counter() - ta
    after = rt._dev_stats.cpu().numpy()
    iters = int((after[0] + after[2]) - (before[0] + before[2]))
    n, busy, trav = 0, 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            continue
        n += 1
        busy += e.duration_ns()
        if any(k in e.name() for k in ("bw_kernel", "pbvh_kernel")):
            trav += e.duration_ns()
    return dict(launches_per_wave_iteration=(round(n / iters, 1) if iters
                                             else None),
                profiled_wave_iterations=iters, device_launches=n,
                device_busy_s=round(busy / 1e9, 4),
                step_wall_profiled_s=round(wall, 4),
                device_idle_share=round(1.0 - busy / 1e9 / wall, 4),
                traversal_share_of_device=round(trav / max(busy, 1), 4))


def room_points(n, seed, dev):
    """`n` seeded points inside `daylight_scene()`'s room."""
    rng = np.random.default_rng(seed)
    p = rng.uniform((-2.9, 0.05, -3.9), (2.9, 2.85, 3.9), (n, 3))
    return torch.from_numpy(p.astype(np.float32)).to(dev)


def check_hierarchy(rt, n, seed):
    """The light tree of `rt` on the card at `n` seeded points in the room:
    the pdfs of all its lights sum to 1, and each sample's pdf is the
    replay's pdf of its pick (the reference's hierarchy consistency test)."""
    from ignis_tpu_torch.light.hierarchy import hierarchy_pdf, hierarchy_sample
    tb, depth = rt.tables, rt.scene.lh_depth
    dev = tb["lh_child"].device
    pos = room_points(n, seed, dev)
    nl = tb["lh_codes"].shape[0]
    ids = torch.arange(nl, device=dev).repeat_interleave(n)
    pdfs = hierarchy_pdf(tb, ids, pos.repeat(nl, 1), depth).reshape(nl, n)
    sum_err = float((pdfs.double().sum(0) - 1.0).abs().max())
    if not sum_err <= HIER_SUM_ABS:
        fail(f"hierarchy: the pdfs of its {nl} lights sum to 1 +- {sum_err} "
             f"> {HIER_SUM_ABS}")
    rng = np.random.default_rng(seed + 1)
    sd = torch.from_numpy(rng.integers(0, 2**32, n).astype(np.int64)).to(dev)
    ct = torch.from_numpy(rng.integers(0, 2**20, n).astype(np.int64)).to(dev)
    act = torch.ones(n, dtype=torch.bool, device=dev)
    loc, pdf, _ = hierarchy_sample(tb, pos, sd, ct, act, depth)
    rel = float(((pdf - hierarchy_pdf(tb, loc, pos, depth)).abs()
                 / pdf).max())
    if not rel <= HIER_PDF_REL:
        fail(f"hierarchy: a sample's pdf and the replay's differ by {rel}")
    return dict(points=n, lights=nl, depth=depth, pdf_sum_max_abs_err=sum_err,
                sample_vs_replay_max_rel=rel,
                distinct_picks=int(torch.unique(loc).numel()))


def check_cdf(name, marg, cond, n, seed, chunk=1 << 16):
    """`n` seeded draws from an env's 2D CDF tables on the card: the pdf at
    each sampled position (`cdf2d_pdf`) must be the sample's pdf wherever
    that is > 0.  A draw whose position rounds onto the next cell's edge
    ((offset + remainder) / size in float32) is counted apart and not held:
    its position lies in the next cell."""
    from ignis_tpu_torch.core.vec import to_int32
    from ignis_tpu_torch.light import env_cdf
    dev = marg.device
    h, w = cond.shape
    g = torch.Generator(device=dev).manual_seed(seed)
    worst, held, edge = 0.0, 0, 0
    for i in range(0, n, chunk):
        u = torch.rand(chunk, generator=g, device=dev)
        v = torch.rand(chunk, generator=g, device=dev)
        pos, pdf = env_cdf.cdf2d_sample(marg, cond, u, v)
        yoff = env_cdf._cdf1d_sample(marg, v)[0]
        xoff = env_cdf._cdf1d_sample_rows(cond, yoff, u)[0]
        inside = ((to_int32(pos[:, 0] * w).long() == xoff)
                  & (to_int32(pos[:, 1] * h).long() == yoff))
        m = (pdf > 0) & inside
        got = env_cdf.cdf2d_pdf(marg, cond, pos)
        if m.any():
            worst = max(worst, float(((got - pdf).abs() / pdf)[m].max()))
        held += int(m.sum())
        edge += int(((pdf > 0) & ~inside).sum())
    if not worst <= CDF_REL:
        fail(f"{name}: cdf2d_pdf at the sampled positions differs from the "
             f"sample's pdf by {worst} > {CDF_REL}")
    return dict(draws=n, table=[h, w], held=held, on_cell_edge=edge,
                max_rel=worst)


def cpu_vs_card(rt, n, seed):
    """`select_light` and `sample_light_direct` on the same `n` lanes of
    `rt`'s scene, with its tables on the card and on the CPU: the same
    light ids and counters, the directions within DIR_ABS."""
    from ignis_tpu_torch.convert import tables_from_numpy
    from ignis_tpu_torch.light.union import sample_light_direct, select_light
    rng = np.random.default_rng(seed)
    host = dict(
        seed=torch.from_numpy(rng.integers(0, 2**32, n).astype(np.int64)),
        ctr=torch.from_numpy(rng.integers(0, 2**20, n).astype(np.int64)),
        active=torch.from_numpy(rng.uniform(size=n) < 0.9),
        entering=torch.from_numpy(rng.uniform(size=n) < 0.5),
        pos=room_points(n, seed, "cpu"))
    out = {}
    for dev, tb in (("cpu", tables_from_numpy(rt.scene.tables, "cpu")),
                    ("card", rt.tables)):
        d = {k: v.to(rt.device if dev == "card" else "cpu")
             for k, v in host.items()}
        idx, pdf, c = select_light(rt.scene, tb, d["seed"], d["ctr"],
                                   d["active"], from_pos=d["pos"])
        ls, c = sample_light_direct(rt.scene, tb, idx, d["pos"],
                                    d["entering"], d["seed"], c, d["active"])
        out[dev] = (idx.cpu(), c.cpu(), ls["dir"].cpu(), pdf.cpu(),
                    ls["pdf_solid"].cpu())
    (ia, ca, da, pa, qa), (ib, cb, db, pb_, qb) = out["cpu"], out["card"]
    ids_diff = int((ia != ib).sum())
    ctr_diff = int((ca != cb).sum())
    dir_err = float((da - db).abs().max())
    if ids_diff or ctr_diff or not dir_err <= DIR_ABS:
        fail(f"lights: CPU vs card: {ids_diff} light ids and {ctr_diff} "
             f"counters differ, directions by {dir_err} (> {DIR_ABS}?)")
    sel_rel = float(((pa - pb_).abs() / pa.abs().clamp_min(1e-30)).max())
    return dict(lanes=n, ids_differ=ids_diff, counters_differ=ctr_diff,
                dir_max_abs_err=dir_err, select_pdf_max_rel=sel_rel,
                lights_picked=int(torch.unique(ia).numel()))


def lights_phase(dev, wrappers, runs, bw, pb):
    """The light breadth through `Runtime.step`: the room of
    `daylight_scene()` (a sun, a Hosek sky baked to a CDF env, 256 spots
    under the light hierarchy) on the packet-BVH kernels and the demo box of
    `env_scene()` (an HDR env sampled by its summed-area table, 64 points
    under the flux CDF) on the Baldwin-Weber kernels.  Each scene's steps,
    profiled step and kernel-vs-plain means; the hierarchy, CDF and
    CPU-vs-card checks; the room's gradient with respect to `light_data`
    and the baked sky.  Adds the two paths' runs to `runs` and emits the
    `lights` line."""
    from ignis_tpu_torch.api import Runtime
    from ignis_tpu_torch.scenes import daylight_scene, env_scene
    t0 = time.perf_counter()
    env_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "env_scene")
    os.makedirs(env_dir, exist_ok=True)
    rt_day = Runtime(daylight_scene(), width=FILM, height=FILM, device=dev)
    rt_env = Runtime(env_scene(env_dir), width=FILM, height=FILM, device=dev)
    t1 = time.perf_counter()
    light_runs = {}
    for path, rt_l, patches in (
            ("daylight", rt_day, dict(
                packet_bvh_closest=pb.packet_bvh_closest_plain,
                packet_bvh_any=pb.packet_bvh_any_plain)),
            ("env", rt_env, dict(
                bw_closest=bw.bw_closest_plain, bw_any=bw.bw_any_plain))):
        steps = 2
        runs[path] = timed_steps(path, rt_l, steps, 1, wrappers)
        prof = profiled_step(rt_l, 1)
        # kernels against their plain versions on a smaller film, same seed:
        # the kernels are bit-equal, so the means must be equal
        scene = daylight_scene() if path == "daylight" else env_scene(env_dir)
        small = Runtime(scene, width=LIGHT_FILM, height=LIGHT_FILM,
                        device=dev)
        means = kernel_and_plain_means(path, small, 1, patches, max_rel=0.0)
        light_runs[path] = dict(
            **runs[path], **prof, **means,
            kernel_launches_per_step={
                k: runs[path]["launches"][k] / (steps + 1)
                for k in PATH_KERNELS[path]},
            tris=int(rt_l.tables["tri_v0"].shape[0]),
            lights=rt_l.scene.num_lights,
            light_types=sorted({l.type for l in rt_l.scene.lights}),
            selector=rt_l.scene.technique.light_selector,
            lh_depth=int(getattr(rt_l.scene, "lh_depth", 0)))
    t2 = time.perf_counter()
    checks = dict(
        hierarchy=check_hierarchy(rt_day, HIER_POINTS, 3),
        sky_cdf=check_cdf("sky", rt_day.tables["light1_cdf_m"],
                          rt_day.tables["light1_cdf_c"], CDF_DRAWS, 4),
        env_sat_cdf=check_cdf("env", rt_env.tables["light1_cdf_m"],
                              rt_env.tables["light1_cdf_c"], CDF_DRAWS, 5),
        cpu_vs_card=cpu_vs_card(rt_day, N_RAYS, 6))
    t3 = time.perf_counter()
    grad = fwdbwd("daylight", rt_day, DAYLIGHT_LANES, wrappers,
                  lambda: pb_plain(pb), ("light_data", "light1_sky_img"),
                  reps=1)
    emit("lights", t0, **light_runs, checks=checks, gradient=grad,
         part_seconds=dict(scenes=round(t1 - t0, 3), steps=round(t2 - t1, 3),
                           checks=round(t3 - t2, 3),
                           grad=round(time.perf_counter() - t3, 3)))


def media_lanes(rt, n, seed):
    """`n` seeded lanes in the media of `rt`'s scene: each lane's medium,
    a segment that starts in the bounding box of the entity holding it and
    runs 0.05 to 1 along a random direction, seeds, counters, the active
    mask.  Host tensors."""
    tb = rt.scene.tables
    rng = np.random.default_rng(seed)
    nmed = len(rt.scene.media)
    mid = rng.integers(0, nmed, n).astype(np.int32)
    tri_ent = np.asarray(tb["tri_ent"])
    corners = np.stack([tb["tri_v0"], tb["tri_v0"] + tb["tri_e1"],
                        tb["tri_v0"] + tb["tri_e2"]])
    lo, hi = np.zeros((nmed, 3)), np.zeros((nmed, 3))
    for mi in range(nmed):
        ent = int(np.nonzero(np.asarray(tb["ent_inner_medium"]) == mi)[0][0])
        c = corners[:, tri_ent == ent].reshape(-1, 3)
        lo[mi], hi[mi] = c.min(0), c.max(0)
    p0 = rng.uniform(lo[mid], hi[mid])
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p1 = p0 + d * rng.uniform(0.05, 1.0, (n, 1))
    return dict(mid=torch.from_numpy(mid),
                p0=torch.from_numpy(p0.astype(np.float32)),
                p1=torch.from_numpy(p1.astype(np.float32)),
                seed=torch.from_numpy(rng.integers(0, 2**32, n)
                                      .astype(np.int64)),
                ctr=torch.from_numpy(rng.integers(0, 2**20, n)
                                     .astype(np.int64)),
                active=torch.from_numpy(rng.uniform(size=n) < 0.9))


def media_cpu_vs_card(rt, n, seed):
    """`medium_sample`, `medium_events` and `medium_eval` (ratio tracking
    for the delta-tracked cloud, the quadrature for the voxel grid, closed
    forms for the homogeneous media) on the same `n` lanes of `rt`'s scene
    with its tables on the card and on the CPU: the same collisions, events
    and counters; positions and transmittance within POS_ABS."""
    from ignis_tpu_torch.convert import tables_from_numpy
    from ignis_tpu_torch.medium import (
        medium_coefficients, medium_eval, medium_events, medium_sample,
    )
    host = media_lanes(rt, n, seed)
    out = {}
    for dev, tb in (("cpu", tables_from_numpy(rt.scene.tables, "cpu")),
                    ("card", rt.tables)):
        d = {k: v.to(rt.device if dev == "card" else "cpu")
             for k, v in host.items()}
        sa, ss, _ = medium_coefficients(rt.scene, tb, d["mid"], {})
        ms, c = medium_sample(rt.scene, tb, d["mid"], sa, ss, d["seed"],
                              d["ctr"], d["p0"], d["p1"], d["active"])
        ev, c = medium_events(ms, d["seed"], c)
        tr = medium_eval(rt.scene, tb, d["mid"], sa, ss, d["p0"], d["p1"],
                         seed=d["seed"], counter=d["ctr"])
        code = (ev["absorb"].to(torch.int8) + 2 * ev["scatter"].to(torch.int8)
                + 3 * ev["null"].to(torch.int8))
        out[dev] = (ms["valid"].cpu(), code.cpu(), c.cpu(), ms["pos"].cpu(),
                    tr.cpu())
    (va, ea, ca, pa, ta), (vb, eb, cb, pb_, tb_) = out["cpu"], out["card"]
    diff = dict(valid_differ=int((va != vb).sum()),
                events_differ=int((ea != eb).sum()),
                counters_differ=int((ca != cb).sum()))
    both = va & vb
    pos_err = float((pa[both] - pb_[both]).abs().max()) if both.any() else 0.0
    tr_err = float((ta - tb_).abs().max())
    if any(diff.values()) or not (pos_err <= POS_ABS and tr_err <= POS_ABS):
        fail(f"media: CPU vs card: {diff}, positions by {pos_err}, "
             f"transmittance by {tr_err} (> {POS_ABS}?)")
    return dict(lanes=n, **diff, pos_max_abs_err=pos_err,
                transmittance_max_abs_err=tr_err,
                collisions=int(va.sum()),
                events={k: int((ea == i).sum()) for i, k in enumerate(
                    ("none", "absorb", "scatter", "null"))},
                lanes_by_medium=[int((host["mid"] == i).sum())
                                 for i in range(len(rt.scene.media))])


def media_phase(dev, wrappers, runs, bw):
    """Participating media through `Runtime.step` under `volpath`:
    `media_scene()` (the demo box on the Baldwin-Weber kernels with a
    scattering and an absorb-only homogeneous medium in glass spheres, a
    128^3 NanoVDB cloud under delta and ratio tracking and an emissive 64^3
    voxel grid): steps, a profiled step, the kernel-vs-plain means at
    512x512, the CPU-vs-card media functions and the gradient w.r.t.
    `medium_data` and `medium_shader`.  Adds the path's run to `runs` and
    emits the `media` line."""
    from ignis_tpu_torch.api import Runtime
    from ignis_tpu_torch.scenes import media_scene
    t0 = time.perf_counter()
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "media_scene")
    os.makedirs(d, exist_ok=True)
    rt = Runtime(media_scene(d), width=FILM, height=FILM, device=dev)
    t1 = time.perf_counter()
    steps = 1
    runs["media"] = timed_steps("media", rt, steps, 1, wrappers)
    t2 = time.perf_counter()
    prof = profiled_step(rt, 1)
    t3 = time.perf_counter()
    means = kernel_and_plain_means("media", rt, 1, dict(
        bw_closest=bw.bw_closest_plain, bw_any=bw.bw_any_plain), max_rel=0.0)
    t4 = time.perf_counter()
    check = media_cpu_vs_card(rt, N_RAYS, 21)
    t5 = time.perf_counter()
    grad = fwdbwd("media", rt, MEDIA_LANES, wrappers, lambda: bw_plain(bw),
                  ("medium_data", "medium_shader"), reps=1)
    emit("media", t0, **runs["media"], **prof, **means, cpu_vs_card=check,
         gradient=grad,
         kernel_launches_per_step={
             k: runs["media"]["launches"][k] / (steps + 1)
             for k in PATH_KERNELS["media"]},
         part_seconds=dict(scene=round(t1 - t0, 3), steps=round(t2 - t1, 3),
                           profile=round(t3 - t2, 3),
                           means=round(t4 - t3, 3),
                           checks=round(t5 - t4, 3),
                           grad=round(time.perf_counter() - t5, 3)),
         tris=int(rt.tables["tri_v0"].shape[0]),
         media=[dict(type=m["type"], method=m.get("method"),
                     shader=m.get("shader"),
                     interpolate=m.get("interpolate")) for m in rt.scene.media],
         grid_bytes={k: int(v.numel() * v.element_size())
                     for k, v in rt.tables.items() if k.startswith("vol")},
         max_depth=rt.scene.technique.max_depth)


def measured_phase(dev, wrappers, runs, pb):
    """Measured materials through `Runtime.step`: `measured_scene()` (the
    daylight room on the packet-BVH kernels, its window glazed by a Klems
    and a TensorTree pane, its 16 spheres in a Dupuy-Jakob BRDF): steps, a
    profiled step, the kernel-vs-plain means at 512x512 and the gradient
    w.r.t. `mat_colors`.  Adds the path's run to `runs` and emits the
    `measured` line."""
    from ignis_tpu_torch.api import Runtime
    from ignis_tpu_torch.scenes import measured_scene
    t0 = time.perf_counter()
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "measured_scene")
    os.makedirs(d, exist_ok=True)
    rt = Runtime(measured_scene(d), width=FILM, height=FILM, device=dev)
    t1 = time.perf_counter()
    steps = 2
    runs["measured"] = timed_steps("measured", rt, steps, 1, wrappers)
    t2 = time.perf_counter()
    prof = profiled_step(rt, 1)
    t3 = time.perf_counter()
    means = kernel_and_plain_means("measured", rt, 1, dict(
        packet_bvh_closest=pb.packet_bvh_closest_plain,
        packet_bvh_any=pb.packet_bvh_any_plain), max_rel=0.0)
    t4 = time.perf_counter()
    grad = fwdbwd("measured", rt, MEASURED_LANES, wrappers,
                  lambda: pb_plain(pb), ("mat_colors",), reps=1)
    emit("measured", t0, **runs["measured"], **prof, **means, gradient=grad,
         kernel_launches_per_step={
             k: runs["measured"]["launches"][k] / (steps + 1)
             for k in PATH_KERNELS["measured"]},
         part_seconds=dict(scene=round(t1 - t0, 3), steps=round(t2 - t1, 3),
                           profile=round(t3 - t2, 3),
                           means=round(t4 - t3, 3),
                           grad=round(time.perf_counter() - t4, 3)),
         tris=int(rt.tables["tri_v0"].shape[0]),
         bsdf_types=rt.scene.bsdf_types,
         klems_patches=[int(i["front_transmission_shape"][0])
                        for i in rt.scene.klems_info.values()],
         tensortree_nodes=[int(rt.tables[f"tt{m}_front_transmission_nodes"]
                               .shape[0]) for m in rt.scene.tensortree_info],
         djmeasured=[dict(n_theta=i["n_theta"], n_phi=i["n_phi"])
                     for i in rt.scene.djmeasured_info.values()])


# the demo scene under each of the techniques phase's paths: (path, the
# scene's changes, spi)
TECHNIQUE_PATHS = (
    ("ao", dict(technique={"type": "ao"}), 1),
    ("infobuffer", dict(technique={"type": "infobuffer"}), 1),
    ("wireframe", dict(technique={"type": "wireframe"}), 1),
    ("debug_normal", dict(technique={"type": "debug", "mode": "normal"}), 1),
    ("debug_prim_id", dict(technique={"type": "debug", "mode": "prim id"}),
     1),
    ("debug_albedo", dict(technique={"type": "debug", "mode": "albedo"}), 1),
    ("mjitt", dict(film={"sampler": "mjitt"}), 4),
    ("halton", dict(film={"sampler": "halton"}), 4),
    ("orthogonal", dict(camera={"type": "orthogonal", "scale": 1.2}), 4),
    ("hidden", dict(entities={"back": dict(camera_visible=False)}), 2),
)


def demo_variant(changes):
    """`demo_scene()` with `changes`: `technique` replaced, `film` and
    `camera` updated, `entities` updated by name."""
    from ignis_tpu_torch.scenes import demo_scene
    s = demo_scene()
    for key, val in changes.items():
        if key == "technique":
            s["technique"] = dict(val)
        elif key == "entities":
            s["entities"] = [dict(e, **val.get(e["name"], {}))
                             for e in s["entities"]]
        else:
            s[key] = dict(s.get(key, {}), **val)
    return s


def driver_steps(path, rt, steps, spi, wrappers):
    """Drive a path of the per-sample driver: counts to 0, a first step and
    `steps` timed steps, counts read.  Each tile of each sample traces one
    wave of `trace_wave`, tiles of the wave capacity: a single-intersection
    technique launches each kernel of the path once a wave, a path one at
    least once.  Returns what `timed_steps` does, with the waves."""
    if rt._wavefront_ok or rt.tile_size != N_RAYS:
        fail(f"{path}: not the per-sample driver over {N_RAYS}-lane tiles")
    reset_counts(wrappers)
    torch.cuda.synchronize()
    ta = time.perf_counter()
    rt.step(spi=spi)
    first = time.perf_counter() - ta
    ta = time.perf_counter()
    for _ in range(steps):
        rt.step(spi=spi)
    dt = (time.perf_counter() - ta) / steps
    launches = {f.__name__: f.launches for f in wrappers}
    img = rt.currentFrame()
    if img.shape != (rt.height, rt.width, 3) or not np.isfinite(img).all():
        fail(f"{path} frame is not finite (height, width, 3)")
    npix = rt.width * rt.height
    waves = -(-npix // N_RAYS) * spi * (steps + 1)
    simple = rt.scene.technique.type != "path"
    for k in PATH_KERNELS[path]:
        if launches[k] < waves or (simple and launches[k] != waves):
            fail(f"{path}: {launches[k]} launches of {k} in {waves} waves")
    return dict(
        steps=steps, spi=spi, film=[rt.width, rt.height],
        first_step_seconds=round(first, 4), step_seconds=round(dt, 4),
        msamples_per_s=round(npix * spi / dt / 1e6, 4), launches=launches,
        trace_waves=waves, mean=float(img.mean()))


def sampler_cpu_vs_card(n, seed, dev):
    """`sample_mjitt` and `sample_halton` (512x512 offsets) on the same `n`
    lanes on the CPU and on the card, sample indices past the Halton
    index's 2^32 wrap included: the same bits."""
    from ignis_tpu_torch.render import sampler
    r = np.random.default_rng(seed)
    host = dict(
        seed=torch.from_numpy(r.integers(0, 2**32, n).astype(np.int64)),
        ctr=torch.from_numpy(r.integers(0, 2**20, n).astype(np.int64)),
        index=torch.from_numpy(np.concatenate([
            r.integers(0, 64, n // 2),
            HALTON_PAST_WRAP + r.integers(0, 2**20, n - n // 2)])),
        x=torch.from_numpy(r.integers(0, FILM, n).astype(np.int32)),
        y=torch.from_numpy(r.integers(0, FILM, n).astype(np.int32)))
    setup = sampler.build_halton_offsets(FILM, FILM)
    offsets = torch.from_numpy(setup.pop("offsets"))
    out = {}
    for where, d in (("cpu", "cpu"), ("card", dev)):
        a = {k: v.to(d) for k, v in host.items()}
        mx, my, mc = sampler.sample_mjitt(a["seed"], a["ctr"], a["index"],
                                          a["x"], a["y"])
        hx, hy = sampler.sample_halton(setup, offsets.to(d), a["index"],
                                       a["x"], a["y"], FILM)
        out[where] = [t.cpu() for t in (mx, my, mc, hx, hy)]
    differ = [int((a != b).sum()) for a, b in zip(out["cpu"], out["card"])]
    if any(differ):
        fail(f"techniques: sampler draws differ CPU vs card: {differ} "
             "(mjitt x, y, counter, halton x, y)")
    return dict(lanes=n, mjitt_differ=differ[:3], halton_differ=differ[3:],
                halton_index_max=int(host["index"].max()))


def camera_cpu_vs_card(n, seed, dev):
    """Orthogonal and fishlens (circular, full, cropped) rays of the demo's
    camera on the same `n` film points on the CPU and on the card, within
    RAY_ABS."""
    from ignis_tpu_torch.render.camera import generate_rays
    from ignis_tpu_torch.scene.compile import load_and_compile
    r = np.random.default_rng(seed)
    nx = torch.from_numpy(r.uniform(-1, 1, n).astype(np.float32))
    ny = torch.from_numpy(r.uniform(-1, 1, n).astype(np.float32))
    errs = {}
    for name, cam in (("orthogonal", {"type": "orthogonal", "scale": 1.2}),
                      ("fishlens_circular", {"type": "fishlens"}),
                      ("fishlens_full", {"type": "fishlens", "mode": "full"}),
                      ("fishlens_cropped", {"type": "fishlens",
                                            "mode": "cropped"})):
        c = load_and_compile(demo_variant(dict(camera=cam)), FILM,
                             FILM // 2).camera
        a = generate_rays(c, nx, ny)
        b = generate_rays(c, nx.to(dev), ny.to(dev))
        errs[name] = max(float((u - v.cpu()).abs().max())
                         for u, v in zip(a, b))
    if not max(errs.values()) <= RAY_ABS:
        fail(f"techniques: camera rays CPU vs card {errs} (> {RAY_ABS})")
    return dict(lanes=n, max_abs_err=errs)


def glare_tail(rt):
    """`tonemap`, `imageinfo` and `evaluateGlare` on `rt`'s frame, seconds
    each; the DGP against the port's `evaluate_glare` on the CPU over the
    same frame (DGP_REL)."""
    from ignis_tpu_torch.render.glare import (
        GlareSettings, complete_settings, evaluate_glare_host,
    )
    t = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        ta = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t[name] = round(time.perf_counter() - ta, 4)
        return out

    tm = timed("tonemap", rt.tonemap)
    info = timed("imageinfo", lambda: rt.imageinfo(histogram=True,
                                                   percentile=True))
    out, heat, mask = timed("evaluateGlare", rt.evaluateGlare)
    frame = rt.currentFrame()
    ref, _, ref_mask = evaluate_glare_host(
        rt.scene.camera, frame, complete_settings(frame, GlareSettings()))
    rel = abs(out.dgp - ref.dgp) / abs(ref.dgp)
    if not (np.isfinite(out.dgp) and rel <= DGP_REL) or tm.shape != \
            frame.shape or int(info["histogram"].sum()) != frame.shape[0] \
            * frame.shape[1]:
        fail(f"techniques: DGP {out.dgp} on the card, {ref.dgp} on the CPU, "
             f"or tonemap / histogram of the wrong size")
    return dict(seconds=t, dgp=out.dgp, dgp_cpu=ref.dgp, dgp_rel_diff=rel,
                vertical_illuminance=out.vertical_illuminance,
                glare_pixels=out.num_pixels,
                mask_differ=int((mask != ref_mask).sum()),
                imageinfo={k: float(info[k]) for k in (
                    "min", "max", "avg", "median", "soft_max", "nan_count")})


def checkpoint_round_trip(dev, d):
    """Two steps of the demo, a checkpoint, two more; a fresh `Runtime`
    loads the checkpoint and takes two steps: the two frames must be
    bit-equal."""
    from ignis_tpu_torch.api import Runtime
    from ignis_tpu_torch.scenes import demo_scene
    path = os.path.join(d, "checkpoint.npz")
    a = Runtime(demo_scene(), width=FILM, height=FILM, seed=7, device=dev)
    for _ in range(2):
        a.step(spi=1)
    a.saveCheckpoint(path)
    for _ in range(2):
        a.step(spi=1)
    b = Runtime(demo_scene(), width=FILM, height=FILM, device=dev)
    b.loadCheckpoint(path)
    for _ in range(2):
        b.step(spi=1)
    fa, fb = a.currentFrame(), b.currentFrame()
    differ = int((fa.view(np.int32) != fb.view(np.int32)).sum())
    if differ or b.currentSampleCount() != 4:
        fail(f"techniques: the resumed frame differs on {differ} values")
    return dict(samples=b.currentSampleCount(), differ=differ,
                mean=float(fa.mean()))


def techniques_phase(dev, wrappers, runs, bw, pb):
    """The single-intersection techniques, the samplers, the orthogonal and
    fishlens cameras and the `Runtime` tail: the demo scene under `ao`,
    `infobuffer`, `wireframe`, three debug modes, the mjitt and Halton
    samplers, an orthogonal camera and an entity hidden from the camera (the
    per-sample driver), each at 512x512 with its steps, a profiled step and
    its mean held to the plain traversal's (rel 0.0); the samplers' draws
    and the cameras' rays CPU vs card; the daylight room under a circular
    fishlens camera on kernel 2 and the glare tail on its frame; the
    denoiser on a demo frame; a checkpoint round trip.  Adds the paths'
    runs to `runs` and emits the `techniques` line."""
    from ignis_tpu_torch.api import Runtime
    from ignis_tpu_torch.render.denoise import denoise_runtime
    from ignis_tpu_torch.scenes import daylight_scene
    t0 = time.perf_counter()
    bw_patch = dict(bw_closest=bw.bw_closest_plain, bw_any=bw.bw_any_plain)
    paths = {}
    rt_path = None
    for path, changes, spi in TECHNIQUE_PATHS:
        ta = time.perf_counter()
        rt = Runtime(demo_variant(changes), width=FILM, height=FILM,
                     device=dev)
        if rt._wavefront_ok:
            runs[path] = timed_steps(path, rt, 1, spi, wrappers)
        else:
            runs[path] = driver_steps(path, rt, 1, spi, wrappers)
        prof = profiled_step(rt, spi)
        means = kernel_and_plain_means(path, rt, spi, bw_patch, max_rel=0.0)
        paths[path] = dict(**runs[path], **prof, **means,
                           technique=rt.scene.technique.type,
                           sampler=rt.scene.sampler,
                           camera=rt.scene.camera.type,
                           wavefront=rt._wavefront_ok,
                           seconds=round(time.perf_counter() - ta, 3))
        if path == "mjitt":
            rt_path = rt
    t1 = time.perf_counter()
    checks = dict(samplers=sampler_cpu_vs_card(N_RAYS, 31, dev),
                  cameras=camera_cpu_vs_card(N_RAYS, 32, dev))
    t2 = time.perf_counter()
    s = daylight_scene()
    s["camera"] = dict(s["camera"], type="fishlens", mode="circular")
    rt = Runtime(s, width=FILM, height=FILM, device=dev)
    runs["fishlens"] = timed_steps("fishlens", rt, 2, 1, wrappers)
    prof = profiled_step(rt, 1)
    means = kernel_and_plain_means("fishlens", rt, 1, dict(
        packet_bvh_closest=pb.packet_bvh_closest_plain,
        packet_bvh_any=pb.packet_bvh_any_plain), max_rel=0.0)
    rt.reset()
    rt.step(spi=1)
    glare = glare_tail(rt)
    paths["fishlens"] = dict(**runs["fishlens"], **prof, **means,
                             camera="fishlens circular", glare=glare,
                             tris=int(rt.tables["tri_v0"].shape[0]))
    t3 = time.perf_counter()
    torch.cuda.synchronize()
    ta = time.perf_counter()
    den = denoise_runtime(rt_path)
    torch.cuda.synchronize()
    denoise = dict(seconds=round(time.perf_counter() - ta, 4),
                   film=list(den.shape[:2]), mean=float(den.mean()),
                   mean_before=float(rt_path.currentFrame().mean()))
    if not np.isfinite(den).all():
        fail("techniques: the denoised frame is not finite")
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "techniques")
    os.makedirs(d, exist_ok=True)
    ck = checkpoint_round_trip(dev, d)
    emit("techniques", t0, paths=paths, checks=checks, denoise=denoise,
         checkpoint=ck,
         kernel_launches_per_step={
             p: {k: runs[p]["launches"][k] / (runs[p]["steps"] + 1)
                 for k in PATH_KERNELS[p]}
             for p in [q for q, _, _ in TECHNIQUE_PATHS] + ["fishlens"]},
         part_seconds=dict(demo_paths=round(t1 - t0, 3),
                           checks=round(t2 - t1, 3),
                           fishlens=round(t3 - t2, 3),
                           tail=round(time.perf_counter() - t3, 3)))


def registry_change(rt, name, value, spi, m0):
    """Set a registry parameter and render the next frame (`render_mean`;
    `m0` is its mean before): the frame must change, and every table stay
    the same tensor in the same storage, all but `params` with the same bits
    (nothing rebuilt).  Restores the parameter."""
    before = {k: (v, v.data_ptr(), v.clone()) for k, v in rt.tables.items()
              if torch.is_tensor(v)}
    old = rt.getParameter(name)
    rt.setParameter(name, value)
    m1 = render_mean(rt, spi)
    for k, (obj, ptr, copy_) in before.items():
        t = rt.tables[k]
        if t is not obj or t.data_ptr() != ptr:
            fail(f"textured: setParameter replaced table {k}")
        if k != "params" and not torch.equal(t, copy_):
            fail(f"textured: setParameter changed table {k}")
    if m1 == m0:
        fail(f"textured: setParameter({name!r}) left the frame unchanged")
    rt.setParameter(name, old)
    return dict(parameter=name, mean_before=m0, mean_after=m1,
                tables_rebuilt=0)


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


# the transport phase: the light tracer on the demo box (kernel 1) and the
# daylight room (kernel 2), the photon mapper on the demo box (kernel 1)
LT_DEPTH = 6              # max_depth of the light-tracer paths
PPM_DEPTH = 6             # max_depth of the photon mapper's camera paths
LT_MEAN_REL = 1e-5        # light tracer vs plain traversal, frame mean: the
                          # splat's atomic sums are the only difference of
                          # order between the two


def light_path_steps(path, rt, steps, spi, wrappers, expect):
    """Drive a path of the light tracer or the photon mapper: counts to 0,
    a first step (its frame kept) and `steps` timed steps, counts read.
    Each kernel of `expect` must have launched `expect[name]` times a step.
    Returns (the dict of `driver_steps` with the peak memory, the first
    step's frame)."""
    reset_counts(wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ta = time.perf_counter()
    rt.step(spi=spi)
    first = time.perf_counter() - ta
    frame0 = rt.currentFrame()
    ta = time.perf_counter()
    for _ in range(steps):
        rt.step(spi=spi)
    dt = (time.perf_counter() - ta) / steps
    peak = torch.cuda.max_memory_allocated()
    launches = {f.__name__: f.launches for f in wrappers}
    img = rt.currentFrame()
    if img.shape != (rt.height, rt.width, 3) or not np.isfinite(img).all():
        fail(f"{path} frame is not finite (height, width, 3)")
    for k, per_step in expect.items():
        if launches[k] != per_step * (steps + 1):
            fail(f"{path}: {launches[k]} launches of {k} in {steps + 1} "
                 f"steps, not {per_step} a step")
    if rt.tile_size != N_RAYS:
        fail(f"{path}: tiles of {rt.tile_size} lanes, not {N_RAYS}")
    npix = rt.width * rt.height
    return dict(
        steps=steps, spi=spi, film=[rt.width, rt.height],
        first_step_seconds=round(first, 4), step_seconds=round(dt, 4),
        mpaths_per_s=round(npix * spi / dt / 1e6, 4), launches=launches,
        launches_per_step={k: v // (steps + 1) for k, v in launches.items()
                           if v}, peak_memory_bytes=int(peak),
        mean=float(img.mean())), frame0


def plain_frame(rt, spi, patches):
    """The frame of `rt`'s first iteration, rendered again with `patches`
    ({name in the integrator: plain version}) in the kernels' place."""
    from ignis_tpu_torch.render import integrator
    rt.reset()
    with mock.patch.multiple(integrator, **patches):
        rt.step(spi=spi)
    return rt.currentFrame()


def lt_against_plain(path, frame0, plain):
    """The light tracer's first frame against the plain traversal's: the
    means within LT_MEAN_REL."""
    m0, m1 = float(frame0.mean()), float(plain.mean())
    rel = abs(m0 - m1) / abs(m1)
    if not (np.isfinite(rel) and rel <= LT_MEAN_REL and m1 > 0):
        fail(f"{path}: frame mean {m0} with the kernels, {m1} with the plain "
             f"traversal (> {LT_MEAN_REL} relative?)")
    return dict(mean_kernel=m0, mean_plain=m1, rel_diff=rel,
                max_abs_pixel_diff=float(np.abs(frame0 - plain).max()),
                order="the splat's atomic sums differ in order")


def emission_cpu_vs_card(rt, n, seed):
    """`sample_light_emission` on the same `n` lanes of `rt`'s scene, every
    light picked uniformly, with its tables on the CPU and on the card: the
    same counters and `infinite`, positions and directions within DIR_ABS,
    reported for each light type."""
    from ignis_tpu_torch.convert import tables_from_numpy
    from ignis_tpu_torch.light.emission import sample_light_emission
    rng = np.random.default_rng(seed)
    host = dict(
        lidx=torch.from_numpy(rng.integers(0, rt.scene.num_lights, n)
                              .astype(np.int32)),
        seed=torch.from_numpy(rng.integers(0, 2**32, n).astype(np.int64)),
        ctr=torch.from_numpy(rng.integers(0, 2**20, n).astype(np.int64)),
        active=torch.from_numpy(rng.uniform(size=n) < 0.9))
    out = {}
    for where, tb in (("cpu", tables_from_numpy(rt.scene.tables, "cpu")),
                      ("card", rt.tables)):
        d = {k: v.to(rt.device if where == "card" else "cpu")
             for k, v in host.items()}
        em, c = sample_light_emission(rt.scene, tb, d["lidx"], d["seed"],
                                      d["ctr"], d["active"])
        out[where] = ({k: v.cpu() for k, v in em.items()}, c.cpu())
    (ea, ca), (eb, cb) = out["cpu"], out["card"]
    ltype = torch.from_numpy(np.asarray(rt.scene.tables["light_type"]))[
        host["lidx"].long()]
    per_type = {}
    for t in sorted(set(ltype.tolist())):
        m = ltype == t
        per_type[str(t)] = dict(
            lanes=int(m.sum()),
            pos_max_abs_err=float((ea["pos"][m] - eb["pos"][m]).abs().max()),
            dir_max_abs_err=float((ea["dir"][m] - eb["dir"][m]).abs().max()))
    ctr_diff = int((ca != cb).sum())
    inf_diff = int((ea["infinite"] != eb["infinite"]).sum())
    worst = max(max(v["pos_max_abs_err"], v["dir_max_abs_err"])
                for v in per_type.values())
    if ctr_diff or inf_diff or not worst <= DIR_ABS:
        fail(f"transport: emission CPU vs card: {ctr_diff} counters and "
             f"{inf_diff} infinite flags differ, positions or directions by "
             f"{worst} (> {DIR_ABS}?): {per_type}")
    return dict(lanes=n, counters_differ=ctr_diff, infinite_differ=inf_diff,
                by_light_type=per_type)


def same_photons(got, want):
    """Fails unless two photon buffers hold the same bits."""
    for k in ("pos", "in_dir", "power", "depth", "valid", "light"):
        a, b = got[k], want[k]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        n = int((a != b).sum())
        if n:
            fail(f"photonmapper: the photon buffer's {k} differs from the "
                 f"plain traversal's in {n} values")
    return int(got["valid"].shape[0])


def gather_launches(rt, grid, radius, nph):
    """Launches and device milliseconds of one `gather_photons` call on the
    first camera hits of one tile of N_RAYS lanes (the footprint radius, the
    lanes that gather as at depth 1), from one profiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ignis_tpu_torch.bsdf import prepare_surface
    from ignis_tpu_torch.core.vec import FLT_MAX
    from ignis_tpu_torch.render.integrator import (
        _emit_camera, _surface_at, _traverse_closest,
    )
    from ignis_tpu_torch.render.photonmapper import gather_photons
    idx = torch.arange(N_RAYS, dtype=torch.int32, device=rt.device)
    sc, tb = rt.scene, rt.tables
    with torch.no_grad():
        _, _, org, d, tmin, _ = _emit_camera(sc, idx % rt.width,
                                             idx // rt.width, 0, 0, 0,
                                             rt.seed, tables=tb)
        t, u, v, prim = _traverse_closest(sc, tb, org, d, tmin,
                                          torch.full_like(tmin, FLT_MAX),
                                          None)
        hit = prim >= 0
        surf = _surface_at(tb, prim.clamp_min(0), org, d,
                           torch.where(hit, t, torch.ones_like(t)), u, v)
        mat_type, spec = prepare_surface(sc, tb, surf, d, org)
        r = torch.clamp_max(t * float(np.float32(0.017455064)), radius)
        active = hit & ~spec & (surf["light_id"] < 0)

        def call():
            return gather_photons(sc, tb, grid, surf, mat_type, -d, r, 1,
                                  active, nph)
        ms = cuda_ms(call, 2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
    n, busy = 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU:
            n += 1
            busy += e.duration_ns()
    return dict(lanes=N_RAYS, gathering_lanes=int(active.sum()),
                launches=n, device_ms=round(busy / 1e6, 4),
                ms=round(ms, 4))


def photon_passes(rt, nph, radius):
    """The photon mapper's first iteration by its parts, each timed (host
    clock, closed by a synchronise): the photon pass, the grid, the camera
    pass.  Returns (seconds, photons, grid)."""
    from ignis_tpu_torch.render.photonmapper import (
        build_photon_grid, render_ppm, trace_photons,
    )
    sc, tb = rt.scene, rt.tables
    t = {}
    with torch.no_grad():
        torch.cuda.synchronize()
        ta = time.perf_counter()
        photons = trace_photons(sc, tb, nph, 0, 0, rt.seed, tile=N_RAYS)
        torch.cuda.synchronize()
        t["photon_pass"] = time.perf_counter() - ta
        ta = time.perf_counter()
        grid = build_photon_grid(sc, photons)
        torch.cuda.synchronize()
        t["grid"] = time.perf_counter() - ta
        ta = time.perf_counter()
        npix = rt.width * rt.height
        for start in range(0, npix, N_RAYS):
            idx = torch.arange(start, start + N_RAYS, dtype=torch.int32,
                               device=rt.device)
            render_ppm(sc, tb, grid, idx % rt.width, idx // rt.width, 0, 0,
                       0, rt.seed, radius, nph)
        torch.cuda.synchronize()
        t["camera_pass"] = time.perf_counter() - ta
    return {k: round(v, 4) for k, v in t.items()}, photons, grid


def transport_phase(dev, wrappers, runs, bw, pb):
    """The light tracer and the photon mapper through `Runtime.step` at
    512x512, spi 1: the demo box under `lighttracer` (kernel 1), the
    daylight room under `lighttracer` (kernel 2: the sun, the sky and 256
    spots emit) and the demo box under `photonmapper` with 1,000,000
    photons a step (kernel 1, closest hits only).  For each, steps and a
    profiled step; the light tracer's frames against the plain traversal's
    by mean (LT_MEAN_REL), the photon mapper's photon buffer and frame bit
    for bit; the photon mapper's passes timed apart and its gather's
    launches; light emission CPU vs card for every light type of both
    scenes.  Adds the paths' runs to `runs` and emits the `transport`
    line."""
    from ignis_tpu_torch.api import Runtime
    from ignis_tpu_torch.render import integrator
    from ignis_tpu_torch.render.photonmapper import (
        ppm_compute_radius, trace_photons,
    )
    from ignis_tpu_torch.scenes import daylight_scene
    t0 = time.perf_counter()
    bw_patch = dict(bw_closest=bw.bw_closest_plain, bw_any=bw.bw_any_plain)
    pb_patch = dict(packet_bvh_closest=pb.packet_bvh_closest_plain,
                    packet_bvh_any=pb.packet_bvh_any_plain)
    paths = {}
    tiles = FILM * FILM // N_RAYS

    # ---- the light tracer: the demo box and the daylight room
    room = daylight_scene()
    room["technique"] = dict(room["technique"], type="lighttracer",
                             max_depth=LT_DEPTH)
    for path, scene, names, patches in (
            ("lighttracer", demo_variant({"technique": {
                "type": "lighttracer", "max_depth": LT_DEPTH}}),
             ("bw_closest", "bw_any"), bw_patch),
            ("lighttracer_room", room,
             ("packet_bvh_closest", "packet_bvh_any"), pb_patch)):
        ta = time.perf_counter()
        rt = Runtime(scene, width=FILM, height=FILM, device=dev)
        expect = {names[0]: tiles * LT_DEPTH,
                  names[1]: tiles * (LT_DEPTH + 1)}
        runs[path], frame0 = light_path_steps(path, rt, 2, 1, wrappers,
                                              expect)
        prof = profiled_step(rt, 1)
        means = lt_against_plain(path, frame0, plain_frame(rt, 1, patches))
        paths[path] = dict(**runs[path], **prof, **means,
                           tris=int(rt.tables["tri_v0"].shape[0]),
                           lights=rt.scene.num_lights,
                           light_types=sorted({l.type
                                               for l in rt.scene.lights}),
                           emission=emission_cpu_vs_card(rt, N_RAYS, 41),
                           seconds=round(time.perf_counter() - ta, 3))

    # ---- the photon mapper on the demo box
    ta = time.perf_counter()
    rt = Runtime(demo_variant({"technique": {"type": "photonmapper",
                                             "max_depth": PPM_DEPTH}}),
                 width=FILM, height=FILM, device=dev)
    tech = rt.scene.technique
    nph = int(tech.photons)
    ptiles = -(-nph // N_RAYS)
    expect = {"bw_closest": ptiles * min(tech.max_light_depth, PPM_DEPTH)
              + tiles * PPM_DEPTH, "bw_any": 0}
    runs["photonmapper"], frame0 = light_path_steps(
        "photonmapper", rt, 2, 1, wrappers, expect)
    prof = profiled_step(rt, 1)
    radius = float(np.float32(ppm_compute_radius(
        tech.merge_radius * 2.0 * rt.scene.scene_radius(), 0)))
    parts, photons, grid = photon_passes(rt, nph, radius)
    gather = gather_launches(rt, grid, radius, nph)
    with torch.no_grad(), mock.patch.multiple(integrator, **bw_patch):
        plain_photons = trace_photons(rt.scene, rt.tables, nph, 0, 0,
                                      rt.seed, tile=N_RAYS)
    same_photons(photons, plain_photons)
    plain = plain_frame(rt, 1, bw_patch)
    differ = int((frame0.view(np.int32) != plain.view(np.int32)).sum())
    if differ:
        fail(f"photonmapper: the frame differs from the plain traversal's "
             f"in {differ} values")
    paths["photonmapper"] = dict(
        **runs["photonmapper"], **prof, part_seconds=parts,
        photons=nph, photon_tiles=ptiles, radius=radius,
        valid_photon_share=float(photons["valid"].float().mean()),
        photon_depths={str(k): int(v) for k, v in zip(*np.unique(
            photons["depth"][photons["valid"]].cpu().numpy(),
            return_counts=True))},
        gather=gather,
        gather_launches_per_camera_bounce=gather["launches"] * tiles,
        photon_buffer_vs_plain="bit-equal", frame_vs_plain="bit-equal",
        mean_kernel=float(frame0.mean()), mean_plain=float(plain.mean()),
        seconds=round(time.perf_counter() - ta, 3))
    emit("transport", t0, paths=paths,
         kernel_launches_per_step={
             p: {k: runs[p]["launches"][k] / (runs[p]["steps"] + 1)
                 for k in PATH_KERNELS[p]}
             for p in ("lighttracer", "lighttracer_room", "photonmapper")})


# ------------------------------------------------------------ the frontends
FRONT_SPP = 4             # igcli's samples a pixel on the demo box: one step
ROOM_PLAIN_FILM = 128     # the room's kernel-vs-plain igcli frames
FLY_POSES = "0,0,3.85;0.4,0.1,3.5,-0.1,0,-1;-0.3,-0.2,3.2,0.1,0.05,-1"
SHARDED_LANES = 1 << 18
RANK_TIMEOUT = 300        # seconds: a rank's rendezvous, collectives and join
STACK_T_REL = 1e-5        # the stack walk's t, card vs CPU


def cache_listing():
    """Entries of the run's asset cache by kind, and their bytes."""
    d = os.environ["IGNIS_TPU_TORCH_CACHE"]
    out = {}
    for name in os.listdir(d):
        kind = name.split("-")[0]
        n, b = out.get(kind, (0, 0))
        out[kind] = (n + 1, b + os.path.getsize(os.path.join(d, name)))
    return {k: dict(entries=n, bytes=b) for k, (n, b) in sorted(out.items())}


@contextlib.contextmanager
def recorded_runtimes():
    """Every `api.Runtime` the CLIs build while in the context (they look it
    up at call time), in a list."""
    from ignis_tpu_torch import api
    made = []

    class Recording(api.Runtime):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    with mock.patch.object(api, "Runtime", Recording):
        yield made


def drive_cli(path, main, argv, wrappers):
    """One run of a CLI's `main(argv)`, a main path: counts (kernel launches
    and the stack walk's calls) to 0 just before, read just after, with the
    host syncs of the run (`stack["host_syncs"]`).  Returns (its runtime,
    seconds, stdout, launches, stack)."""
    from ignis_tpu_torch.ops import bvh
    from ignis_tpu_torch.utils.stats import host_syncs
    buf = io.StringIO()
    with recorded_runtimes() as made:
        reset_counts(wrappers)
        for f in (bvh.bvh_closest, bvh.bvh_any):
            f.calls = 0
        syncs = host_syncs()
        torch.cuda.synchronize()
        ta = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            code = main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - ta
    launches = {f.__name__: f.launches for f in wrappers}
    stack = {f.__name__: dict(calls=f.calls)
             for f in (bvh.bvh_closest, bvh.bvh_any)}
    stack["host_syncs"] = host_syncs() - syncs
    if code != 0:
        fail(f"{path}: exit code {code}")
    return (made[0] if made else None), secs, buf.getvalue(), launches, stack


def wave_launches(path, rt, launches, names, stack=None):
    """The launches of `names` must each equal the wave iterations of `rt`
    (and, for `stack`, the stack walk's calls), every other count 0, and a
    wave must be N_RAYS wide.  Returns the wave iterations."""
    ds = rt._dev_stats.cpu().numpy()
    iters = int(ds[0] + ds[2])
    want = {k: (iters if k in names else 0) for k in launches}
    if iters <= 0 or launches != want:
        fail(f"{path}: launches {launches}, want {want} ({iters} wave "
             "iterations)")
    if stack is not None and any(stack[f]["calls"] != iters
                                 for f in ("bvh_closest", "bvh_any")):
        fail(f"{path}: stack walk calls {stack} vs {iters} wave iterations")
    if rt._dev_stats_capacity != N_RAYS:
        fail(f"{path}: a wave holds {rt._dev_stats_capacity} rays, not "
             f"{N_RAYS}")
    return iters


def frame_of(path, exr, film=None):
    """The EXR a frontend wrote: finite, (film, film, 3) (FILM by default)."""
    from ignis_tpu_torch.utils.exr import read_exr
    film = film or FILM
    img = read_exr(exr)
    if img.shape != (film, film, 3) or not np.isfinite(img).all():
        fail(f"{path}: frame {img.shape} is not finite ({film}, {film}, 3)")
    return img


def quiet(main, argv):
    """`main(argv)` with its printing captured."""
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


@contextlib.contextmanager
def tonemap_devices():
    """The devices of the frames `render.tonemap.tonemap` is given while in
    the context (the CLIs look it up at call time), in a list."""
    from ignis_tpu_torch.render import tonemap as tm
    seen, real = [], tm.tonemap

    def recording(image, *a, **k):
        seen.append(str(torch.as_tensor(image).device))
        return real(image, *a, **k)

    with mock.patch.object(tm, "tonemap", recording):
        yield seen


def check_tonemapped(path, devices, got, frame, dev):
    """A CLI's tonemapped EXR: tonemapped once, on the card, and equal to
    the ACES tonemap of its own frame on the card."""
    from ignis_tpu_torch.render.tonemap import METHODS, tonemap
    if len(devices) != 1 or not devices[0].startswith("cuda"):
        fail(f"{path}: tonemapped on {devices}, not once on the card")
    want = tonemap(torch.as_tensor(frame, device=dev),
                   method=METHODS["aces"]).cpu().numpy()
    if not np.array_equal(got, want):
        fail(f"{path}: the tonemapped EXR differs from the frame's tonemap")


def samples_line(text):
    return next((l for l in text.splitlines()
                 if l.startswith("Samples per second")), None)


def same_frame(path, got, want):
    if not np.array_equal(got.view(np.int32), want.view(np.int32)):
        fail(f"{path}: the frame with the kernels differs from the plain "
             f"traversal's on {int((got != want).any(-1).sum())} pixels")


def stack_cpu_vs_card(rt, dev):
    """`bvh_closest` / `bvh_any` on the card and on the CPU over the same
    N_RAYS camera rays and N_RAYS random rays of `rt`'s `bvh_*` tables: ids
    equal but for exact t ties, t within STACK_T_REL, occlusion equal; the
    card's milliseconds and host syncs a call."""
    from ignis_tpu_torch.ops import bvh
    from ignis_tpu_torch.utils.stats import host_syncs
    cpu = {k: v.cpu() for k, v in rt.tables.items()
           if k.startswith("bvh_")}
    side = int(round(N_RAYS ** 0.5))
    out = {}
    for name, rays in (("camera", camera_rays(rt, side, dev)),
                       ("random", random_rays(rt, N_RAYS, 41, dev))):
        org, d, tmin, tmax = rays
        got = bvh.bvh_closest(rt.tables, org, d, tmin, tmax)
        want = bvh.bvh_closest(cpu, *(a.cpu() for a in rays))
        gt, gi = got[0].cpu().numpy(), got[3].cpu().numpy()
        wt, wi = want[0].numpy(), want[3].numpy()
        differ = gi != wi
        tie = differ & (gi >= 0) & (wi >= 0) & (gt == wt)
        hit = (wi >= 0) & ~differ
        err = float(np.max(np.abs(gt[hit] - wt[hit])
                           / np.maximum(np.abs(wt[hit]), 1e-30),
                           initial=0.0))
        if (differ & ~tie).any() or err > STACK_T_REL:
            fail(f"stack walk {name} rays: card vs CPU ids differ on "
                 f"{int((differ & ~tie).sum())} rays, t rel err {err}")
        occ = bvh.bvh_any(rt.tables, org, d, tmin, torch.full_like(tmax, 2.0))
        occ_cpu = bvh.bvh_any(cpu, org.cpu(), d.cpu(), tmin.cpu(),
                              torch.full((org.shape[0],), 2.0))
        if not torch.equal(occ.cpu(), occ_cpu):
            fail(f"stack walk {name} rays: occlusion card vs CPU differs")
        syncs = host_syncs()
        ms = cuda_ms(lambda: bvh.bvh_closest(rt.tables, org, d, tmin, tmax),
                     3)
        syncs_per_call = (host_syncs() - syncs) / 4
        any_ms = cuda_ms(lambda: bvh.bvh_any(rt.tables, org, d, tmin, tmax),
                         3)
        out[name] = dict(rays=int(org.shape[0]), hits=int(hit.sum()),
                         ties=int(tie.sum()), t_rel_err=err,
                         closest_ms=round(ms, 3), any_ms=round(any_ms, 3),
                         closest_host_syncs_per_call=syncs_per_call,
                         occluded=int(occ.sum()))
    return out


def _sharded_rank(rank, world, store, out, lanes, film, device):
    """One rank of the sharded path (a spawned process): gloo over a
    FileStore, every rank on `device`; the demo box's render of `lanes`
    lanes over a film x film image and a train step, saved to `out`."""
    import torch.distributed as dist

    from ignis_tpu_torch.api import Runtime
    from ignis_tpu_torch.ops import bw_intersect as bw
    from ignis_tpu_torch.parallel import sharding
    from ignis_tpu_torch.scenes import demo_scene
    dev = torch.device(device)
    sharding.init_distributed(f"file://{store}", world, rank, backend="gloo",
                              timeout=RANK_TIMEOUT)
    mesh = sharding.make_mesh(world)
    rt = Runtime(demo_scene(), width=film, height=film, device=dev)
    sharding.replicate(mesh, rt.tables)
    x, y = lanes_over_film(lanes, film, dev)
    fn = sharding.sharded_render_fn(rt.scene, mesh)
    fn(rt.tables, x, y, 0, 0, 0, 0)                   # warm-up
    reset_counts((bw.bw_closest, bw.bw_any))
    torch.cuda.synchronize()
    ta = time.perf_counter()
    rad = fn(rt.tables, x, y, 0, 0, 0, 0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - ta
    launches = [bw.bw_closest.launches, bw.bw_any.launches]
    step = sharding.sharded_train_step(rt.scene, mesh, ("mat_colors",),
                                       lr=TRAIN_LR)
    torch.cuda.synchronize()
    ta = time.perf_counter()
    loss, new = step(rt.tables, x, y, 0, 0, 0, 0, rad * 0.8)
    torch.cuda.synchronize()
    np.savez(out, radiance=rad.cpu().numpy(), loss=loss.cpu().numpy(),
             mat_colors=new["mat_colors"].detach().cpu().numpy(),
             launches=np.asarray(launches), seconds=secs,
             train_seconds=time.perf_counter() - ta)
    dist.destroy_process_group()


def sharded_path(dev, rt, wrappers, d, bw):
    """The demo box's render of SHARDED_LANES lanes over two gloo ranks (two
    processes on cuda:0) and over NCCL at world size 1 (this process): each
    bit-equal to one process's `trace_wave` through the plain Baldwin-Weber
    traversal (as is one process's render through kernel 1, the one timed);
    the train step's loss and parameters within 1e-6 of one process's
    `train_step` through the plain traversal."""
    import multiprocessing as mp
    import torch.distributed as dist

    from ignis_tpu_torch.parallel import sharding
    from ignis_tpu_torch.render.integrator import trace_wave
    x, y = lanes_over_film(SHARDED_LANES, FILM, dev)
    with torch.no_grad():
        trace_wave(rt.scene, rt.tables, x, y, 0, 0, 0, 0)     # warm-up
        torch.cuda.synchronize()
        ta = time.perf_counter()
        one = trace_wave(rt.scene, rt.tables, x, y, 0, 0, 0, 0)
        torch.cuda.synchronize()
        one_secs = time.perf_counter() - ta
        with bw_plain(bw):
            want = trace_wave(rt.scene, rt.tables, x, y, 0, 0, 0, 0)
    same_bits("sharded one process", one, want)
    del one
    d = tempfile.mkdtemp(prefix="sharded_", dir=d)   # fresh stores
    ctx = mp.get_context("spawn")
    ta = time.perf_counter()
    procs = [ctx.Process(target=_sharded_rank, args=(
        r, 2, os.path.join(d, "gloo_store"), os.path.join(d, f"rank{r}.npz"),
        SHARDED_LANES, FILM, str(dev))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_TIMEOUT + 60)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    if hung or any(p.exitcode != 0 for p in procs):
        fail(f"sharded: ranks ended with {[p.exitcode for p in procs]} "
             f"({len(hung)} killed at the timeout)")
    spawn_secs = time.perf_counter() - ta
    ranks = [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(2)]
    want_np = want.cpu().numpy()
    for r in ranks:
        if not np.array_equal(r["radiance"].view(np.int32),
                              want_np.view(np.int32)):
            fail("sharded: the 2-rank gloo render differs from one "
                 "process's plain trace_wave")
    with bw_plain(bw):
        loss, new = sharding.train_step(rt.scene, rt.tables, x, y, 0, 0, 0,
                                        0, want * 0.8,
                                        param_keys=("mat_colors",),
                                        lr=TRAIN_LR)
    new = new["mat_colors"].detach().cpu().numpy()
    for r in ranks:
        if (abs(float(r["loss"]) - float(loss)) > 1e-6 * max(abs(float(loss)),
                                                             1.0)
                or np.abs(r["mat_colors"] - new).max() > 1e-6):
            fail(f"sharded: train step loss {float(r['loss'])} / params vs "
                 f"one process {float(loss)}")
    # NCCL at world size 1, in this process: counts to 0 just before
    sharding.init_distributed(f"file://{os.path.join(d, 'world1_store')}",
                              1, 0, backend="nccl", timeout=RANK_TIMEOUT)
    try:
        mesh = sharding.make_mesh(1)
        fn = sharding.sharded_render_fn(rt.scene, mesh)
        fn(rt.tables, x, y, 0, 0, 0, 0)                   # warm-up
        reset_counts(wrappers)
        torch.cuda.synchronize()
        ta = time.perf_counter()
        got = fn(rt.tables, x, y, 0, 0, 0, 0)
        torch.cuda.synchronize()
        nccl_secs = time.perf_counter() - ta
        launches = {f.__name__: f.launches for f in wrappers}
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    same_bits("sharded nccl", got, want)
    for r in ranks:
        launches["bw_closest"] += int(r["launches"][0])
        launches["bw_any"] += int(r["launches"][1])
    return dict(
        lanes=SHARDED_LANES, launches=launches, backend_world1=backend,
        one_process_seconds=round(one_secs, 4),
        gloo_2rank_render_seconds=[round(float(r["seconds"]), 4)
                                   for r in ranks],
        gloo_2rank_train_seconds=[round(float(r["train_seconds"]), 4)
                                  for r in ranks],
        gloo_2rank_launches=[r["launches"].tolist() for r in ranks],
        gloo_spawn_seconds=round(spawn_secs, 3),
        nccl_world1_seconds=round(nccl_secs, 4), loss=float(loss))


def frontends_phase(dev, wrappers, runs, rt_demo, bw, pb):
    """The port's frontends at 512x512, capacity 65,536, each a main path:
    igcli on the demo box with default flags (the stack walk, no kernel),
    with `--no-bvh` (kernel 1) and on the daylight room (kernel 2); igtrace
    on 65,536 rays; igview's `--fly` over three poses; the explicit work list
    (`render_wavefront(work_mode="tables")`); the sharded render and train
    step.  Adds the paths' runs to `runs` and emits the `frontends` line."""
    from ignis_tpu_torch.api import Runtime
    from ignis_tpu_torch.cli import igcli, igtrace, igview
    from ignis_tpu_torch.render import integrator
    from ignis_tpu_torch.render.integrator import render_wavefront
    from ignis_tpu_torch.scenes import daylight_scene, demo_scene
    t0 = time.perf_counter()
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "frontends")
    os.makedirs(d, exist_ok=True)
    demo_json, room_json = (os.path.join(d, n) for n in ("demo.json",
                                                        "room.json"))
    for p, s in ((demo_json, demo_scene()), (room_json, daylight_scene())):
        with open(p, "w") as f:
            json.dump(s, f)
    film = ["--width", str(FILM), "--height", str(FILM)]
    spp = ["--spp", str(FRONT_SPP), "--spi", str(FRONT_SPP)]
    exr = lambda n: os.path.join(d, n + ".exr")
    paths, seconds = {}, {}

    # ---- igcli, default flags: use_bvh=True, the stack walk, no kernel
    ta = time.perf_counter()
    rt, secs, text, launches, stack = drive_cli(
        "igcli", igcli.main, [demo_json, *film, *spp, "-o", exr("igcli")],
        wrappers)
    iters = wave_launches("igcli", rt, launches, (), stack)
    img = frame_of("igcli", exr("igcli"))
    syncs = stack["host_syncs"]
    runs["igcli"] = dict(launches=launches)
    paths["igcli"] = dict(
        seconds=round(secs, 3), samples=samples_line(text),
        launches=launches, wave_iterations=iters, stack_walk=stack,
        host_syncs_per_step=syncs,
        host_syncs_per_wave_iteration=round(syncs / iters, 2),
        mean=float(img.mean()),
        stack_cpu_vs_card=stack_cpu_vs_card(rt, dev),
        profiled_step=profiled_step(rt, FRONT_SPP))
    del rt
    seconds["igcli"] = time.perf_counter() - ta

    # ---- igcli --no-bvh: kernel 1, bit-equal to the plain traversal
    ta = time.perf_counter()
    rt, secs, text, launches, _ = drive_cli(
        "igcli_nobvh", igcli.main,
        [demo_json, *film, *spp, "--no-bvh", "-o", exr("igcli_nobvh")],
        wrappers)
    iters = wave_launches("igcli_nobvh", rt, launches,
                          PATH_KERNELS["igcli_nobvh"])
    prof = profiled_step(rt, FRONT_SPP)
    del rt
    img_k = frame_of("igcli_nobvh", exr("igcli_nobvh"))
    with tonemap_devices() as tm_devs, mock.patch.multiple(
            integrator, bw_closest=bw.bw_closest_plain,
            bw_any=bw.bw_any_plain):
        quiet(igcli.main, [demo_json, *film, *spp, "--no-bvh", "--tonemap",
                           "aces", "-o", exr("igcli_nobvh_plain")])
    img_p = frame_of("igcli_nobvh", exr("igcli_nobvh_plain"))
    same_frame("igcli_nobvh", img_k, img_p)
    check_tonemapped("igcli --tonemap", tm_devs,
                     frame_of("igcli --tonemap",
                              exr("igcli_nobvh_plain_tonemapped")),
                     img_p, dev)
    rel = abs(float(img.mean()) - float(img_k.mean())) / float(img_k.mean())
    if rel > MEAN_REL:
        fail(f"igcli: the stack walk's mean {img.mean()} vs kernel 1's "
             f"{img_k.mean()}")
    runs["igcli_nobvh"] = dict(launches=launches)
    paths["igcli_nobvh"] = dict(
        seconds=round(secs, 3), samples=samples_line(text),
        launches=launches, wave_iterations=iters, mean=float(img_k.mean()),
        stack_vs_kernel_mean_rel=rel, frame_bit_equal_to_plain=True,
        tonemap_devices=tm_devs, profiled_step=prof)
    seconds["igcli_nobvh"] = time.perf_counter() - ta

    # ---- igcli on the daylight room: bvh_* and pb_rows, kernel 2 first
    ta = time.perf_counter()
    rt, secs, text, launches, stack = drive_cli(
        "igcli_room", igcli.main,
        [room_json, *film, "--spp", "1", "-o", exr("igcli_room")], wrappers)
    iters = wave_launches("igcli_room", rt, launches,
                          PATH_KERNELS["igcli_room"])
    if "bvh_node_min" not in rt.tables or any(
            stack[f]["calls"] for f in ("bvh_closest", "bvh_any")):
        fail("igcli_room: the room must hold bvh_* tables and never walk "
             "them (the packet rows come first)")
    del rt
    img = frame_of("igcli_room", exr("igcli_room"))
    small = ["--width", str(ROOM_PLAIN_FILM), "--height",
             str(ROOM_PLAIN_FILM), "--spp", "1"]
    quiet(igcli.main, [room_json, *small, "-o", exr("room_small")])
    with mock.patch.multiple(integrator,
                             packet_bvh_closest=pb.packet_bvh_closest_plain,
                             packet_bvh_any=pb.packet_bvh_any_plain):
        quiet(igcli.main, [room_json, *small, "-o", exr("room_small_plain")])
    same_frame("igcli_room",
               frame_of("igcli_room", exr("room_small"), ROOM_PLAIN_FILM),
               frame_of("igcli_room", exr("room_small_plain"),
                        ROOM_PLAIN_FILM))
    runs["igcli_room"] = dict(launches=launches)
    paths["igcli_room"] = dict(
        seconds=round(secs, 3), samples=samples_line(text),
        launches=launches, wave_iterations=iters, mean=float(img.mean()),
        plain_film=[ROOM_PLAIN_FILM] * 2, frame_bit_equal_to_plain=True)
    seconds["igcli_room"] = time.perf_counter() - ta

    # ---- igtrace: N_RAYS rays from a file, against Runtime.trace
    ta = time.perf_counter()
    org, dirs, _, _ = random_rays(rt_demo, N_RAYS, 43, "cpu")
    ray_file, out_file = (os.path.join(d, n) for n in ("rays.txt",
                                                        "traced.txt"))
    np.savetxt(ray_file, np.concatenate([org.numpy(), dirs.numpy()], 1),
               fmt="%.9g")
    rt, secs, _, launches, _ = drive_cli(
        "igtrace", igtrace.main, [demo_json, "-i", ray_file, "-o", out_file],
        wrappers)
    want = {k: (launches[k] if k in PATH_KERNELS["igtrace"] else 0)
            for k in launches}
    if launches != want or min(launches[k]
                               for k in PATH_KERNELS["igtrace"]) <= 0:
        fail(f"igtrace: launches {launches}")
    with open(ray_file) as f:
        rays = igtrace.read_rays(f)
    colors = rt.trace(rays, spp=1)
    lines = "".join(f"{c[0]:e}\t{c[1]:e}\t{c[2]:e}\n" for c in colors)
    with open(out_file) as f:
        if f.read() != lines or len(rays) != N_RAYS:
            fail("igtrace: its lines differ from Runtime.trace's")
    runs["igtrace"] = dict(launches=launches)
    paths["igtrace"] = dict(seconds=round(secs, 3), rays=len(rays),
                            launches=launches, equal_to_runtime_trace=True,
                            mean=float(colors.mean()))
    del rt
    seconds["igtrace"] = time.perf_counter() - ta

    # ---- igview --fly: three poses, each EXR equal to a Runtime's frame
    ta = time.perf_counter()
    fly_dir = os.path.join(d, "fly")
    rt, secs, _, launches, _ = drive_cli(
        "igview", igview.main,
        [demo_json, *film, "--spi", "1", "--frames-spp", "1", "--fly",
         FLY_POSES, "--out", fly_dir], wrappers)
    iters = wave_launches("igview", rt, launches, PATH_KERNELS["igview"])
    del rt
    ref = Runtime(demo_json, width=FILM, height=FILM, device=dev)
    cam = ref.scene.camera
    o = igview.Orientation(cam.eye, cam.dir, cam.up)
    poses = [p for p in FLY_POSES.split(";") if p.strip()]
    for i, p in enumerate(poses):
        v = [float(t) for t in p.split(",")]
        o.eye = np.asarray(v[:3], np.float64)
        if len(v) >= 6:
            o.dir = np.asarray(v[3:6], np.float64)
            o.dir /= np.linalg.norm(o.dir)
        igview.apply_pose(ref, o)
        ref.step(spi=1)
        got = frame_of("igview", os.path.join(fly_dir, f"fly_{i:04d}.exr"))
        if not np.array_equal(got, ref.currentFrame()):
            fail(f"igview: pose {i}'s EXR differs from the Runtime's frame")
    with tonemap_devices() as tm_devs:
        igview._tonemapped(ref, 0, 1.0)
    if not tm_devs or not all(t.startswith("cuda") for t in tm_devs):
        fail(f"igview: tonemapped on {tm_devs}, not the card")
    del ref
    runs["igview"] = dict(launches=launches)
    paths["igview"] = dict(seconds=round(secs, 3), poses=len(poses),
                           launches=launches, wave_iterations=iters,
                           exrs_equal_to_runtime=True,
                           tonemap_devices=tm_devs)
    seconds["igview"] = time.perf_counter() - ta

    # ---- the explicit work list against the arithmetic one
    ta = time.perf_counter()
    npix = FILM * FILM
    idx = torch.from_numpy(np.random.default_rng(44).permutation(
        npix * FRONT_SPP)).to(dev)
    pix = idx % npix
    work = dict(work_x=pix % FILM, work_y=pix // FILM, work_sample=idx // npix)
    with torch.no_grad():
        render_wavefront(rt_demo.scene, rt_demo.tables, 0, 0, 0, N_RAYS,
                         spi=FRONT_SPP, work_mode="tables", **work)  # warm-up
        reset_counts(wrappers)
        torch.cuda.synchronize()
        tb = time.perf_counter()
        fb_t, st = render_wavefront(rt_demo.scene, rt_demo.tables, 0, 0, 0,
                                    N_RAYS, spi=FRONT_SPP,
                                    work_mode="tables", **work)
        torch.cuda.synchronize()
        secs = time.perf_counter() - tb
        launches = {f.__name__: f.launches for f in wrappers}
        tb = time.perf_counter()
        fb_a, _ = render_wavefront(rt_demo.scene, rt_demo.tables, 0, 0, 0,
                                   N_RAYS, spi=FRONT_SPP)
        torch.cuda.synchronize()
        arith_secs = time.perf_counter() - tb
    st = st.cpu().numpy()
    iters = int(st[0] + st[2])
    if any(launches[k] != (iters if k in PATH_KERNELS["work_list"] else 0)
           for k in launches):
        fail(f"work_list: launches {launches} vs {iters} wave iterations")
    fb_t, fb_a = fb_t.cpu().numpy(), fb_a.cpu().numpy()
    if not np.isfinite(fb_t).all() or not np.allclose(fb_t, fb_a, rtol=2e-4,
                                                      atol=2e-5):
        fail("work_list: the explicit work list's frame differs from the "
             "arithmetic one's beyond rtol 2e-4")
    runs["work_list"] = dict(launches=launches)
    paths["work_list"] = dict(
        seconds=round(secs, 4), arith_seconds=round(arith_secs, 4),
        work_items=int(idx.shape[0]), launches=launches,
        wave_iterations=iters,
        max_rel_diff_to_arith=float(np.max(np.abs(fb_t - fb_a)
                                           / np.maximum(np.abs(fb_a), 1e-6))))
    seconds["work_list"] = time.perf_counter() - ta

    # ---- the sharded render and train step
    ta = time.perf_counter()
    paths["sharded"] = sharded_path(dev, rt_demo, wrappers, d, bw)
    runs["sharded"] = dict(launches=paths["sharded"]["launches"])
    seconds["sharded"] = time.perf_counter() - ta
    emit("frontends", t0, paths=paths,
         part_seconds={k: round(v, 3) for k, v in seconds.items()})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs the port on a GPU "
              "and does not fall back to the CPU", file=sys.stderr)
        return 2
    # the port itself: without it beside this script nothing is printed
    from ignis_tpu_torch import native
    # a fresh asset cache for the run, so that every table is built once
    # here and `big`'s second load reads what its first one wrote
    os.makedirs(native.build_dir(), exist_ok=True)
    cache = tempfile.mkdtemp(prefix="asset_cache_", dir=native.build_dir())
    os.environ["IGNIS_TPU_TORCH_CACHE"] = cache
    try:
        return run(native)
    finally:
        shutil.rmtree(cache, ignore_errors=True)


def run(native):
    dev = torch.device("cuda", 0)
    from ignis_tpu_torch.api import Runtime
    from ignis_tpu_torch.ops import bw_intersect as bw
    from ignis_tpu_torch.ops import mt_intersect as mt
    from ignis_tpu_torch.ops import packet_bvh as pb
    from ignis_tpu_torch.ops import tlas
    from ignis_tpu_torch.scene.compile import load_and_compile
    from ignis_tpu_torch.scenes import (
        big_scene, demo_scene, instanced_scene, materials_scene,
        textured_scene,
    )

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
    t0b = time.perf_counter()
    rt_bw2 = Runtime(big_scene(**BW_SECOND), width=FILM, height=FILM,
                     device=dev)
    t1 = time.perf_counter()
    rt_big = Runtime(big_scene(**BIG_SCENE), width=FILM, height=FILM,
                     device=dev)
    sec = rt_big.stats.sections
    big_first_seconds = time.perf_counter() - t1
    # the second load reads the BVH and the packet rows from the asset cache
    tb = time.perf_counter()
    again = Runtime(big_scene(**BIG_SCENE), width=FILM, height=FILM,
                    device=dev)
    big_cached_seconds = time.perf_counter() - tb
    asec = again.stats.sections
    if "build_bvh" in asec or "build_traversal_tables" in asec:
        fail("big: the second load built its tables again")
    for k, v in rt_big.tables.items():
        w = again.tables[k]
        # bytes, not values: `pb_nodes` holds entry codes whose bits are NaNs
        if (torch.is_tensor(v) and not (
                v.dtype == w.dtype and v.shape == w.shape and torch.equal(
                    v.contiguous().view(torch.uint8),
                    w.contiguous().view(torch.uint8)))) or (
                not torch.is_tensor(v) and v != w):
            fail(f"big: the cached load's table {k} differs")
    del again
    tb = time.perf_counter()
    rt_big2 = Runtime(big_scene(**BIG_SECOND), width=FILM, height=FILM,
                      device=dev)
    big2_seconds = time.perf_counter() - tb
    t2 = time.perf_counter()
    rt_inst = Runtime(instanced_scene(), width=FILM, height=FILM, device=dev)
    isec = rt_inst.stats.sections
    rt_two = Runtime(instanced_scene(12, 3, second_subdiv=1), width=FILM,
                     height=FILM, device=dev)
    t3 = time.perf_counter()
    rt_sweep = sweep_runtime(FILM, dev)
    emit("scenes", t0, demo_seconds=round(t0b - t0, 3),
         bw_second_seconds=round(t1 - t0b, 3),
         instanced_seconds=round(t3 - t2, 3),
         instanced_compile_seconds=round(isec["loading"].total, 3),
         instanced_table_build_seconds=round(sum(
             isec[k].total for k in ("build_bvh", "build_traversal_tables",
                                     "build_tlas", "build_cluster_tree")
             if k in isec), 3),
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
         bw_ctree=list(rt_demo.tables["bw_ctree"].shape),
         bw_second_tris=int(rt_bw2.tables["tri_v0"].shape[0]),
         bw_second_ctree=list(rt_bw2.tables["bw_ctree"].shape),
         big_seconds=round(big_first_seconds, 3),
         big_cached_seconds=round(big_cached_seconds, 3),
         big_cached_compile_seconds=round(asec["loading"].total, 3),
         big_second_seconds=round(big2_seconds, 3),
         asset_cache=cache_listing(),
         big_compile_seconds=round(sec["loading"].total, 3),
         big_table_build_seconds=round(
             sec["build_bvh"].total + sec["build_traversal_tables"].total
             + sec["build_pb_nodes"].total, 3),
         big_build_bvh_seconds=round(sec["build_bvh"].total, 3),
         big_build_packet_rows_seconds=round(
             sec["build_traversal_tables"].total, 3),
         big_pb_nodes_seconds=round(sec["build_pb_nodes"].total, 4),
         big_tris=int(rt_big.tables["tri_v0"].shape[0]),
         pb_rows=list(rt_big.tables["pb_rows"].shape),
         pb_nodes=list(rt_big.tables["pb_nodes"].shape),
         pb_depth=int(rt_big.tables["pb_depth"]),
         big_second_tris=int(rt_big2.tables["tri_v0"].shape[0]))

    # ---- 3. kernels, each against its plain version on the card
    t0 = time.perf_counter()
    recs = {}
    recs.update(check_kernels(rt_demo, *bw_adapters(bw), dev, bw_bound,
                              tail=TAIL_RAYS))
    check_bw_extras(bw, rt_bw2, recs, dev)
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
    # start on the faces of its own boxes (kernel 1: clusters and tree nodes
    # of both table sets)
    for tb in (rt_demo.tables, rt_bw2.tables):
        check_float_rules(tb, bw_adapters(bw), torch.cat(
            [tb["bw_clusters"][:, :6], tb["bw_ctree"][1:, :6]]).cpu(), recs,
            dev)
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

    # ---- 3b. the backward of the parameter tables' row gathers
    t0 = time.perf_counter()
    scatter = row_scatter_phase(dev)
    emit("row_scatter", t0, cases=scatter)

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

    # ---- 8. materials: the rough, plastic, phong, principled and two-lobe
    # BSDFs and the constant normal modifier through Runtime.step (kernel 1)
    t0 = time.perf_counter()
    rt_mat = Runtime(materials_scene(), width=FILM, height=FILM, device=dev)
    runs["materials"] = timed_steps("materials", rt_mat, 2, 1, wrappers)
    means = kernel_and_plain_means("materials", rt_mat, 1, dict(
        bw_closest=bw.bw_closest_plain, bw_any=bw.bw_any_plain))
    emit("materials", t0, **runs["materials"], **means,
         tris=int(rt_mat.tables["tri_v0"].shape[0]),
         bsdf_types=rt_mat.scene.bsdf_types,
         bsdf_types_b=rt_mat.scene.bsdf_types_b,
         nmod_kinds=rt_mat.scene.nmod_kinds)

    # ---- 9. fwdbwd: the gradient of the summed differentiable render of the
    # demo scene with respect to mat_colors (the reference's phase_fwdbwd)
    t0 = time.perf_counter()
    runs["fwdbwd"] = fwdbwd("fwdbwd", rt_demo, FWDBWD_LANES, wrappers,
                            lambda: bw_plain(bw), ("mat_colors",), reps=2)
    emit("fwdbwd", t0, **runs["fwdbwd"])

    # ---- 10. train: SGD steps of parallel.sharding.train_step on the
    # materials scene, its contributions clamped
    t0 = time.perf_counter()
    scene = materials_scene()
    scene["technique"] = dict(scene["technique"], clamp=TRAIN_CLAMP)
    rt_train = Runtime(scene, width=FILM, height=FILM, device=dev)
    runs["train"] = train(rt_train, TRAIN_STEPS, TRAIN_LR, wrappers, bw)
    emit("train", t0, **runs["train"], clamp=TRAIN_CLAMP,
         film=[rt_train.width, rt_train.height])

    # ---- 11. textured: image, checkerboard, brick, noise and PExpr textures
    # on every kind of slot through Runtime.step (kernel 1), a registry
    # change, and the gradient w.r.t. texels and registry
    t0 = time.perf_counter()
    tex_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "textured_scene")
    os.makedirs(tex_dir, exist_ok=True)
    rt_tex = Runtime(textured_scene(tex_dir), width=FILM, height=FILM,
                     device=dev)
    runs["textured"] = timed_steps("textured", rt_tex, 2, 1, wrappers)
    t1 = time.perf_counter()
    means = kernel_and_plain_means("textured", rt_tex, 1, dict(
        bw_closest=bw.bw_closest_plain, bw_any=bw.bw_any_plain))
    t2 = time.perf_counter()
    prof = profiled_step(rt_tex, 1)
    t3 = time.perf_counter()
    reg = registry_change(rt_tex, "p_col1", [0.2, 0.9, 0.3], 1,
                          means["mean_kernel"])
    t4 = time.perf_counter()
    grad = fwdbwd("textured", rt_tex, TEXTURED_LANES, wrappers,
                  lambda: bw_plain(bw),
                  (rt_tex.scene.textures[0]["img_key"], "params"), reps=1)
    emit("textured", t0, **runs["textured"], **means,
         **prof, registry=reg, gradient=grad,
         part_seconds=dict(steps=round(t1 - t0, 3), means=round(t2 - t1, 3),
                           profile=round(t3 - t2, 3),
                           registry=round(t4 - t3, 3),
                           grad=round(time.perf_counter() - t4, 3)),
         tris=int(rt_tex.tables["tri_v0"].shape[0]),
         textures=[t["type"] for t in rt_tex.scene.textures],
         nmod_kinds=rt_tex.scene.nmod_kinds,
         env_texture=rt_tex.scene.lights[1].tex)

    # ---- 12. lights: the light breadth through Runtime.step
    lights_phase(dev, wrappers, runs, bw, pb)

    # ---- 13. media: volpath with homogeneous, NanoVDB and voxel-grid media
    media_phase(dev, wrappers, runs, bw)

    # ---- 14. measured: Klems, TensorTree and Dupuy-Jakob materials
    measured_phase(dev, wrappers, runs, pb)

    # ---- 15. techniques: the single-intersection techniques, samplers,
    # cameras, the per-sample driver and the Runtime tail
    techniques_phase(dev, wrappers, runs, bw, pb)

    # ---- 16. transport: the light tracer and the photon mapper
    transport_phase(dev, wrappers, runs, bw, pb)

    # ---- 17. frontends: the CLIs, the explicit work list, sharding
    frontends_phase(dev, wrappers, runs, rt_demo, bw, pb)

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
            launches_per_fwdbwd_call=runs["fwdbwd"]["launches_per_call"].get(
                name, 0),
            backward="none: traversal detached",
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            device_ms=r["device_ms"],
            coherent_ms=r["coherent_ms"], incoherent_ms=r["incoherent_ms"],
            rays_per_launch=r["rays_per_launch"],
            **{k: r[k] for k in ("tail_rays", "tail_ms", "tail_device_ms",
                                 "tail_bound_ms", "tail_bound_by",
                                 "bound_walk_ms", "bound_walk_by",
                                 "bound_dense_ms", "bound_dense_by",
                                 "second_ms", "second_device_ms",
                                 "second_bound_ms", "second_bound_by",
                                 "second_bound_dense_ms")
               if k in r}))
    scatters = {"fwdbwd": runs["fwdbwd"]["row_scatters_per_call"],
                "train": runs["train"]["row_scatters_per_step"]}
    if min(scatters.values()) <= 0:
        fail(f"row_scatter: {scatters} a call on the gradient paths")
    kernels.append(dict(
        name="row_scatter", route="cuda",
        source="ignis_tpu_torch/csrc/row_scatter.cu",
        replaces="none: the custom VJP of ignis_tpu/core/dgather.py (_bwd)",
        launches_per_call=scatters,
        backward="it is the backward of core.dgather.gather_rows",
        cases=scatter))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
