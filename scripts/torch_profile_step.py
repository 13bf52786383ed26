#!/usr/bin/env python3
"""Where a `Runtime.step` of the PyTorch/CUDA port spends its time.

    python3 scripts/torch_profile_step.py \
        [demo|big|both|instanced|sweep|materials|textured|daylight|env|
         media|measured|all]

`both` is demo and big; `instanced` is the 1024-instance scene, `sweep` the
32,002-triangle scene with un-accelerated tables, `materials` the demo box
with the rough, plastic, phong, principled and two-lobe BSDFs, `textured` the
same box with image, checkerboard, brick, noise and PExpr textures (its
images written under `build/textured_scene/`), `daylight` the furnished room
under a sun, a Hosek sky and 256 spots (light hierarchy), `env` the demo box
under an SAT-sampled HDR environment and 64 points (its image written under
`build/env_scene/`), `media` the demo box with homogeneous, NanoVDB and
voxel-grid media under `volpath` (its grids written under
`build/media_scene/`), `measured` the room with a Klems and a TensorTree pane
and Dupuy-Jakob spheres (its files written under `build/measured_scene/`);
`all` is the ten.  Every
scene renders at 512x512.  Runs one warm-up step and then profiles one step
of the scene(s) with `torch.profiler` (CPU + CUDA activities) and prints, per
scene, one JSON line: the step's wall time (host clock closed by a
synchronise), the summed device time of all kernels, the device's idle share
(1 - device time / wall time), the number of kernels launched, the share of
the port's traversal kernels, each traversal kernel's device time and launch
count, the ten kernels with the most device time and the fifteen PyTorch
operators the host called most often.
Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


_TRAVERSAL_KERNELS = ("bw_kernel", "pbvh_kernel", "tlas_kernel", "mt_sweep",
                      "mt_finalize")


def profile_step(name, rt, spi):
    rt.step(spi=spi)                      # warm-up (builds the kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rt.step(spi=spi)                      # un-profiled wall time
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt.step(spi=spi)
        wall_prof = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0 and e.device_type.name != "CPU":
            rows.append((e.key, float(dev_us), int(e.count)))
    rows.sort(key=lambda r: -r[1])
    # the host's operator calls (each elementwise one a launch or more)
    ops = sorted(((e.key, int(e.count)) for e in prof.key_averages()
                  if e.key.startswith("aten::")), key=lambda r: -r[1])
    dev_s = sum(r[1] for r in rows) / 1e6
    trav_s = sum(r[1] for r in rows
                 if any(k in r[0] for k in _TRAVERSAL_KERNELS)) / 1e6
    ds = rt._dev_stats.cpu().numpy()
    print(json.dumps({
        "scene": name, "spi": spi, "step_wall_s": wall,
        "step_wall_profiled_s": wall_prof, "device_busy_s": dev_s,
        "device_idle_share": 1.0 - dev_s / wall_prof if dev_s else None,
        "kernel_launches": sum(r[2] for r in rows),
        "traversal_kernel_s": trav_s,
        "traversal_share_of_device": trav_s / dev_s if dev_s else None,
        "wave_iterations_total": int(ds[0] + ds[2]),
        "traversal_kernels": [
            dict(name=k[:80], device_ms=round(us / 1e3, 4), count=c)
            for k, us, c in rows if any(t in k for t in _TRAVERSAL_KERNELS)],
        "top_kernels": [dict(name=k[:80], device_ms=round(us / 1e3, 3),
                             count=c) for k, us, c in rows[:10]],
        "most_called_ops": dict(ops[:15]),
    }), flush=True)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    which = sys.argv[1] if len(sys.argv) > 1 else "both"
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    from ignis_tpu_torch.api import Runtime
    from ignis_tpu_torch.scenes import (
        big_scene, daylight_scene, demo_scene, env_scene, instanced_scene,
        materials_scene, measured_scene, media_scene, textured_scene,
    )
    if which not in ("demo", "big", "both", "instanced", "sweep",
                     "materials", "textured", "daylight", "env", "media",
                     "measured", "all"):
        print(f"unknown scene '{which}'", file=sys.stderr)
        return 2
    if which in ("demo", "both", "all"):
        profile_step("demo", Runtime(demo_scene(), width=512, height=512), 4)
    if which in ("big", "both", "all"):
        profile_step("big", Runtime(big_scene()), 1)
    if which in ("instanced", "all"):
        profile_step("instanced", Runtime(instanced_scene()), 1)
    if which in ("sweep", "all"):
        from ignis_tpu_torch.api import pack_tri_shade
        from ignis_tpu_torch.scene.compile import load_and_compile
        scene = load_and_compile(big_scene(n_spheres=25, subdiv=3), 512, 512)
        tables = dict(scene.tables)
        tables["tri_shade"] = pack_tri_shade(tables)
        profile_step("sweep", Runtime.from_compiled(scene, tables), 1)
    if which in ("materials", "all"):
        profile_step("materials",
                     Runtime(materials_scene(), width=512, height=512), 1)
    if which in ("textured", "all"):
        tex_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "build", "textured_scene")
        os.makedirs(tex_dir, exist_ok=True)
        profile_step("textured", Runtime(textured_scene(tex_dir), width=512,
                                         height=512), 1)
    if which in ("daylight", "all"):
        profile_step("daylight", Runtime(daylight_scene()), 1)
    if which in ("env", "all"):
        env_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "build", "env_scene")
        os.makedirs(env_dir, exist_ok=True)
        profile_step("env", Runtime(env_scene(env_dir)), 1)
    for name, make in (("media", media_scene), ("measured", measured_scene)):
        if which in (name, "all"):
            d = os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "build", f"{name}_scene")
            os.makedirs(d, exist_ok=True)
            profile_step(name, Runtime(make(d)), 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
