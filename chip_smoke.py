#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ignis_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

It builds the CUDA kernels from `ignis_tpu_torch/csrc/` with `nvcc`, holds
each kernel against its plain PyTorch version on the card, and drives the
port's main path (`Runtime.step` of the `path` technique) on the two headline
scenes: the demo box through the Baldwin-Weber kernels and the 512,002-triangle
field through the packet-BVH kernels.  Every phase prints one JSON line with
its seconds.  Any failed phase ends the run with a non-zero exit code; nothing
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
FILM = 512                # film width and height of both headline scenes
BIG_SCENE = dict(n_spheres=25, subdiv=5)   # 512,002 triangles
T_REL, UV_ABS = 1e-5, 1e-4  # kernel vs plain: |dt|/max(1,|t|), |du|, |dv|
MEAN_REL = 0.02           # kernel render vs plain render, image mean
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, outside the tensor cores
# float32 operations per test, counted from the kernels' sources
OPS_BOX, OPS_BW_TRI, OPS_MT_TRI = 25, 48, 54


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


def check_kernels(rt, closest, closest_plain, any_, any_plain, dev, bound_fn):
    """Hold one module's two kernels against their plain versions on coherent
    and incoherent rays under the camera, bounce and shadow masks, and time
    them.  Returns {kernel name: record}."""
    from ignis_tpu_torch.ops.packet_bvh import (MASK_BOUNCE, MASK_CAMERA,
                                                MASK_SHADOW)
    tb = rt.tables
    sets = {"coherent": camera_rays(rt, int(np.sqrt(N_RAYS)), dev),
            "incoherent": random_rays(rt, N_RAYS, 11, dev)}
    sets["secondary"] = secondary_rays(sets["coherent"], closest_plain, tb, 12)
    rec_c = dict(rays=0, checks=[], max_abs_err=0.0)
    rec_a = dict(rays=0, checks=[], max_abs_err=0.0)
    for sname, (org, d, tmin, tmax) in sets.items():
        for mname, mb in (("camera", MASK_CAMERA), ("bounce", MASK_BOUNCE),
                          ("shadow", MASK_SHADOW)):
            got = closest(tb, org, d, tmin, tmax, mask_bit=mb)
            ref = closest_plain(tb, org, d, tmin, tmax, mask_bit=mb)
            torch.cuda.synchronize()
            c = compare_closest(f"{closest.__name__}/{sname}/{mname}", got, ref)
            rec_c["rays"] += org.shape[0]
            rec_c["checks"].append(dict(rays=sname, mask=mname, **c))
            rec_c["max_abs_err"] = max(rec_c["max_abs_err"], c["max_abs_dt"],
                                       c["max_duv"])
            # occlusion: unnormalised segments of bounded length
            smax = torch.full_like(tmax, 4.0)
            occ = any_(tb, org, d, tmin, smax, mask_bit=mb)
            occ_ref = any_plain(tb, org, d, tmin, smax, mask_bit=mb)
            torch.cuda.synchronize()
            bad = int((occ != occ_ref).sum())
            if bad:
                fail(f"{any_.__name__}/{sname}/{mname}: {bad} rays disagree "
                     "with the plain version")
            rec_a["rays"] += org.shape[0]
            rec_a["checks"].append(dict(rays=sname, mask=mname, mismatch=bad,
                                        occluded=int(occ.sum())))
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
        out[fn.__name__] = rec
    return out


def bw_bound(rt, work, n, is_any):
    tb = rt.tables
    nbytes = (tb["bw_tris"].numel() + tb["bw_clusters"].numel()) * 4 \
        + n * 32 + n * (1 if is_any else 16)
    ops = work["box_tests"] * OPS_BOX + work["tri_tests"] * OPS_BW_TRI
    return _bound(nbytes, ops)


def pb_bound(rt, work, n, is_any):
    nbytes = work["rows_touched"] * 512 + n * 32 + n * (1 if is_any else 16)
    ops = (work["inner_visits"] * 8 * OPS_BOX
           + work["leaf_visits"] * 8 * OPS_MT_TRI)
    return _bound(nbytes, ops)


def _bound(nbytes, ops):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations",
                bound_bytes=int(nbytes), bound_operations=int(ops))


def reset_counts(fns):
    for f in fns:
        f.launches = 0


def render_mean(rt, spi):
    rt.reset()
    rt.step(spi=spi)
    img = rt.currentFrame()
    if not np.isfinite(img).all():
        fail("render holds non-finite values")
    return float(img.mean())


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
    from ignis_tpu_torch.ops import packet_bvh as pb
    from ignis_tpu_torch.render import integrator
    from ignis_tpu_torch.scene.compile import load_and_compile
    from ignis_tpu_torch.scenes import big_scene, demo_scene

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
                pb.packet_bvh_any)

    # ---- scenes: compile and build the tables once
    t0 = time.perf_counter()
    rt_demo = Runtime(demo_scene(), width=FILM, height=FILM, device=dev)
    t1 = time.perf_counter()
    rt_big = Runtime(big_scene(**BIG_SCENE), width=FILM, height=FILM,
                     device=dev)
    sec = rt_big.stats.sections
    emit("scenes", t0, demo_seconds=round(t1 - t0, 3),
         demo_tris=int(rt_demo.tables["tri_v0"].shape[0]),
         big_seconds=round(time.perf_counter() - t1, 3),
         big_compile_seconds=round(sec["loading"].total, 3),
         big_table_build_seconds=round(
             sec["build_bvh"].total + sec["build_traversal_tables"].total, 3),
         big_tris=int(rt_big.tables["tri_v0"].shape[0]),
         pb_rows=list(rt_big.tables["pb_rows"].shape),
         pb_depth=int(rt_big.tables["pb_depth"]))

    # ---- 3. kernels, each against its plain version on the card
    t0 = time.perf_counter()
    recs = {}
    recs.update(check_kernels(rt_demo, bw.bw_closest, bw.bw_closest_plain,
                              bw.bw_any, bw.bw_any_plain, dev, bw_bound))
    recs.update(check_kernels(rt_big, pb.packet_bvh_closest,
                              pb.packet_bvh_closest_plain, pb.packet_bvh_any,
                              pb.packet_bvh_any_plain, dev, pb_bound))
    emit("kernels", t0, tolerance=dict(t_rel=T_REL, uv_abs=UV_ABS),
         kernels=recs)

    # ---- 4. demo: the Baldwin-Weber path
    t0 = time.perf_counter()
    reset_counts(wrappers)
    torch.cuda.synchronize()
    ta = time.perf_counter()
    rt_demo.step(spi=4)
    first = time.perf_counter() - ta
    ta = time.perf_counter()
    rt_demo.step(spi=4)
    second = time.perf_counter() - ta
    demo_launches = {f.__name__: f.launches for f in wrappers}
    img = rt_demo.currentFrame()
    if img.shape != (FILM, FILM, 3) or not np.isfinite(img).all():
        fail("demo frame is not finite (FILM, FILM, 3)")
    ds = rt_demo._dev_stats.cpu().numpy()
    iters = int(ds[0] + ds[2])
    if not (demo_launches["bw_closest"] == demo_launches["bw_any"] == iters
            and iters > 0):
        fail(f"demo: launches {demo_launches} do not match {iters} wave "
             "iterations (one closest-hit and one any-hit launch each)")
    mean_kernel = render_mean(rt_demo, 4)
    with mock.patch.object(integrator, "bw_closest", bw.bw_closest_plain), \
            mock.patch.object(integrator, "bw_any", bw.bw_any_plain):
        mean_plain = render_mean(rt_demo, 4)
    rel = abs(mean_kernel - mean_plain) / abs(mean_plain)
    if rel > MEAN_REL:
        fail(f"demo: kernel render mean {mean_kernel} vs plain {mean_plain}")
    nsamp = FILM * FILM * 4
    emit("demo", t0, first_step_seconds=round(first, 4),
         step_seconds=round(second, 4),
         msamples_per_s=round(nsamp / second / 1e6, 4),
         first_step_msamples_per_s=round(nsamp / first / 1e6, 4),
         wave_iterations=int(ds[0]), tail_iterations=int(ds[2]),
         occupancy=float(ds[1] / max(ds[0] + ds[2], 1) / rt_demo._dev_stats_capacity),
         launches=demo_launches, mean_kernel=mean_kernel,
         mean_plain=mean_plain, rel_diff=rel, stats=rt_demo.dumpStats())

    # ---- 5. big: the packet-BVH path
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    rt_big.step(spi=1)                       # warm-up
    torch.cuda.synchronize()
    ta = time.perf_counter()
    for _ in range(3):
        rt_big.step(spi=1)
    dt = time.perf_counter() - ta
    big_launches = {f.__name__: f.launches for f in wrappers}
    img = rt_big.currentFrame()
    if img.shape != (FILM, FILM, 3) or not np.isfinite(img).all():
        fail("big frame is not finite (FILM, FILM, 3)")
    mean_kernel = float(img.mean())
    ds = rt_big._dev_stats.cpu().numpy()
    iters = int(ds[0] + ds[2])
    if not (big_launches["packet_bvh_closest"] == big_launches["packet_bvh_any"]
            == iters and iters > 0):
        fail(f"big: launches {big_launches} do not match {iters} wave "
             "iterations")
    peak = torch.cuda.max_memory_allocated()
    # the same scene at a quarter of the film size (128x128) through the plain traversal, on the card
    small = load_and_compile(big_scene(**BIG_SCENE), FILM // 4, FILM // 4)
    small_tables = dict(small.tables)
    # the traversal and shading tables do not depend on the film: reuse them
    for k in ("pb_rows", "pb_bounds", "pb_depth", "tri_shade"):
        v = rt_big.tables[k]
        small_tables[k] = v.cpu().numpy() if torch.is_tensor(v) else v
    rt_small = Runtime.from_compiled(small, small_tables, device=dev)
    with mock.patch.object(integrator, "packet_bvh_closest",
                           pb.packet_bvh_closest_plain), \
            mock.patch.object(integrator, "packet_bvh_any",
                              pb.packet_bvh_any_plain):
        mean_plain = render_mean(rt_small, 4)
    rel = abs(mean_kernel - mean_plain) / abs(mean_plain)
    if rel > MEAN_REL:
        fail(f"big: kernel render mean {mean_kernel} vs plain 128x128 render "
             f"{mean_plain}")
    emit("big", t0, steps=3, step_seconds=round(dt / 3, 4),
         msamples_per_s=round(FILM * FILM * 3 / dt / 1e6, 4),
         launches=big_launches, wave_iterations=int(ds[0]),
         tail_iterations=int(ds[2]), peak_memory_bytes=int(peak),
         mean_kernel=mean_kernel, mean_plain_128=mean_plain, rel_diff=rel)

    # ---- the kernels line: launches are those of the main path's runs
    main_launches = {**{k: v for k, v in demo_launches.items() if v},
                     **{k: v for k, v in big_launches.items() if v}}
    meta = {
        "bw_closest": ("ignis_tpu_torch/csrc/bw_intersect.cu",
                       "ignis_tpu/ops/bw_intersect.py:295"),
        "bw_any": ("ignis_tpu_torch/csrc/bw_intersect.cu",
                   "ignis_tpu/ops/bw_intersect.py:295"),
        "packet_bvh_closest": ("ignis_tpu_torch/csrc/packet_bvh.cu",
                               "ignis_tpu/ops/pallas_bvh.py:507"),
        "packet_bvh_any": ("ignis_tpu_torch/csrc/packet_bvh.cu",
                           "ignis_tpu/ops/pallas_bvh.py:507"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = recs[name]
        launches = main_launches.get(name, 0)
        if launches <= 0:
            fail(f"kernel {name} was not launched on the main path")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            device_ms=r["device_ms"],
            coherent_ms=r["coherent_ms"], incoherent_ms=r["incoherent_ms"],
            rays_per_launch=r["rays_per_launch"]))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
