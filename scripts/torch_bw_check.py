#!/usr/bin/env python3
"""What the Baldwin-Weber kernel (`csrc/bw_intersect.cu`, kernel 1) does per
ray and per warp, counted on the card, and where it meets the packet-BVH
kernel (kernel 2) as soups grow.

    python3 scripts/torch_bw_check.py

Needs a CUDA device and `nvcc`.  Compiles a copy of `csrc/bw_intersect.cu`
with -DBW_COUNT (the diagnostic build: the same kernel plus counters) into
`build/bw_count/` and runs `bw_closest` (bounce mask) and `bw_any` (shadow
mask, segments of length 4) through it on two table sets, the demo scene's
(98 triangles, 13 clusters) and `big_scene(n_spheres=3, subdiv=3)`'s (3,842
triangles, 481 clusters), under the camera, secondary (bounce-like) and
incoherent rays of `chip_smoke.py`, at 65536 and at 4096 rays, and on the demo
also under the rays of every launch of one `Runtime.step(spi=1)` as the
integrator makes them (`wave<k>`, with their own masks and windows).  One JSON
line per case: per-ray means of node boxes and cluster boxes decided, clusters
entered and triangles tested; for each loop of the kernel (the box or tree
walk, the triangle step) the warp iterations and the SIMT efficiency (lanes
whose ray needed the step / (32 x warp iterations)); the most steps one ray
took; and the device time (CUDA-graph replay) of the regular build on the same
inputs.  With a cluster tree (`bw_ctree`) each case also runs `dense`, the
tree's header set to 0 levels (every cluster decided in order, eight lanes a
ray).

Then the threshold between the two kernels: the demo scene and
`big_scene(n, 3)` for n = 1, 2, 3, 4 (98 / 1,282 / 2,562 / 3,842 / 5,122
triangles), each with both table kinds built by the port's own builders, one
JSON line per soup with both kernels' `device_ms` on the same 65536 secondary
rays (closest and any) and camera rays (closest).

Bit-equality with the plain version is `chip_smoke.py`'s and the
`cuda`-marked tests' business; this script checks that both builds (and both
modes) return the same.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

COUNTS = ("rays", "node_boxes", "cluster_boxes", "clusters_entered",
          "triangles")
LOOPS = ("box_walk", "triangles")
N_COUNTS = 10
SECOND = dict(n_spheres=3, subdiv=3)      # 3,842 triangles, 481 clusters
THRESHOLD_SPHERES = (1, 2, 3, 4)          # big_scene(n, 3)


def counting_library(native):
    out = native.build_dir().parent / "bw_count"
    os.makedirs(out, exist_ok=True)
    so = out / "libbw_count.so"
    subprocess.run([native.find_nvcc(), *native.NVCC_FLAGS, "-DBW_COUNT",
                    "-shared", str(native.CSRC / "bw_intersect.cu"), "-o",
                    str(so)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    regular = native.library()
    lib.ignis_bw_intersect.argtypes = regular.ignis_bw_intersect.argtypes
    lib.ignis_bw_intersect.restype = regular.ignis_bw_intersect.restype
    lib.ignis_bw_counts.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.ignis_bw_counts.restype = ctypes.c_int
    return lib


def ray_sets(cs, rt, bw, dev):
    camera = cs.camera_rays(rt, int(np.sqrt(cs.N_RAYS)), dev)
    return {"camera": camera,
            "secondary": cs.secondary_rays(camera, bw.bw_closest_plain,
                                           rt.tables, 12),
            "incoherent": cs.random_rays(rt, cs.N_RAYS, 11, dev)}


def check_cases(cs, bw, rt, dev):
    """(rays, kernel, args, mask) of `chip_smoke.py`'s ray sets at 65536 and
    at 4096 rays: closest hits under the bounce mask, occlusion of segments
    of length 4 under the shadow mask."""
    cases = []
    for sname, full in ray_sets(cs, rt, bw, dev).items():
        tail = tuple(x[::cs.N_RAYS // cs.TAIL_RAYS].contiguous() for x in full)
        for rays in (full, tail):
            seg = rays[:3] + (torch.full_like(rays[3], 4.0),)
            cases += [(sname, bw.bw_closest, rays, 0x4),
                      (sname, bw.bw_any, seg, 0x8)]
    return cases


def wave_cases(bw, rt):
    """(rays, kernel, args, mask) of every launch of kernel 1 in one
    `Runtime.step(spi=1)` of `rt`, its inputs recorded as the integrator
    made them (`wave<k>`: the k-th launch of that kernel in the step)."""
    from ignis_tpu_torch.render import integrator
    seen = []

    def record(fn):
        def wrapper(tables, org, d, tmin, tmax, mask_bit=0xF):
            n = org.shape[0]
            full = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                             device=org.device).expand(n)
            seen.append((fn, tuple(x.contiguous().clone() for x in (
                org, d, full(tmin), full(tmax))), int(mask_bit)))
            return fn(tables, org, d, tmin, tmax, mask_bit)
        return wrapper
    with mock.patch.multiple(integrator, bw_closest=record(bw.bw_closest),
                             bw_any=record(bw.bw_any)):
        rt.step(spi=1)
    counts = {}
    cases = []
    for fn, args, mb in seen:
        k = counts[fn] = counts.get(fn, -1) + 1
        cases.append((f"wave{k}", fn, args, mb))
    return cases


def count_cases(cs, native, counting, name, tb, cases):
    modes = {"as_built": tb}
    if "bw_ctree" in tb:
        dense = tb["bw_ctree"].clone()
        dense[0] = 0.0                      # a header of 0 levels
        modes["dense"] = dict(tb, bw_ctree=dense)
    ok = True
    for sname, fn, args, mb in cases:
        ref = fn(tb, *args, mask_bit=mb)
        for mode, tables in modes.items():
            got = (ctypes.c_ulonglong * N_COUNTS)()
            with mock.patch.object(native, "library", lambda: counting):
                out = fn(tables, *args, mask_bit=mb)
                torch.cuda.synchronize()
                if counting.ignis_bw_counts(got):
                    raise RuntimeError("reading the counts failed")
            same = all(torch.equal(a, b) for a, b in zip(
                (out,) if torch.is_tensor(out) else out,
                (ref,) if torch.is_tensor(ref) else ref))
            ok &= same
            n = got[0]
            per_ray = {k: got[i] / max(n, 1)
                       for i, k in enumerate(COUNTS) if i}
            loops = {k: dict(warp_iterations=got[5 + 2 * i],
                             simt_efficiency=got[6 + 2 * i]
                             / max(32 * got[5 + 2 * i], 1))
                     for i, k in enumerate(LOOPS)}
            print(json.dumps(dict(
                tables=name, kernel=fn.__name__, rays=sname, mask=mb,
                mode=mode, n=int(n), per_ray=per_ray, loops=loops,
                longest_ray_steps=got[9], builds_agree=same,
                device_ms=cs.graph_ms(
                    lambda: fn(tables, *args, mask_bit=mb), 10))),
                flush=True)
    return ok


def threshold_runtime(cs, scene, dev):
    """`scene` with Baldwin-Weber AND packet-BVH tables, each built by
    `build_accel_tables` as it builds that kind."""
    from ignis_tpu_torch import api
    from ignis_tpu_torch.scene.compile import load_and_compile
    scene = load_and_compile(scene, cs.FILM, cs.FILM)
    tables = {}
    for threshold in (1 << 30, 0):
        with mock.patch.object(api, "_PB_MIN_TRIS", threshold):
            tables.update(api.build_accel_tables(scene.tables))
    return api.Runtime.from_compiled(scene, tables, device=dev)


def threshold_case(cs, bw, pb, scene, dev):
    rt = threshold_runtime(cs, scene, dev)
    tb = rt.tables
    sets = ray_sets(cs, rt, bw, dev)
    sec = sets["secondary"]
    seg = sec[:3] + (torch.full_like(sec[3], 4.0),)
    line = dict(triangles=int(tb["tri_v0"].shape[0]),
                clusters=int(tb["bw_clusters"].shape[0]),
                pb_rows=int(tb["pb_rows"].shape[0]))
    for tag, fn, args, mb in (
            ("closest_secondary", (bw.bw_closest, pb.packet_bvh_closest), sec,
             0x4),
            ("any_secondary", (bw.bw_any, pb.packet_bvh_any), seg, 0x8),
            ("closest_camera", (bw.bw_closest, pb.packet_bvh_closest),
             sets["camera"], 0x4)):
        for kname, f in zip(("bw", "pb"), fn):
            line[f"{kname}_{tag}_device_ms"] = cs.graph_ms(
                lambda: f(tb, *args, mask_bit=mb), 10)
        a, b = fn[0](tb, *args, mask_bit=mb), fn[1](tb, *args, mask_bit=mb)
        hit_a = (a if torch.is_tensor(a) else a[3] >= 0)
        hit_b = (b if torch.is_tensor(b) else b[3] >= 0)
        line[f"{tag}_hit_agreement"] = float((hit_a == hit_b).float().mean())
    print(json.dumps(line), flush=True)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ignis_tpu_torch import native
    from ignis_tpu_torch.api import Runtime
    from ignis_tpu_torch.ops import bw_intersect as bw
    from ignis_tpu_torch.ops import packet_bvh as pb
    from ignis_tpu_torch.scenes import big_scene, demo_scene
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    native.library()
    counting = counting_library(native)
    ok = True
    for name, scene in (("demo", demo_scene()),
                        ("second", big_scene(**SECOND))):
        rt = Runtime(scene, width=cs.FILM, height=cs.FILM, device=dev)
        cases = check_cases(cs, bw, rt, dev)
        if name == "demo":
            cases += wave_cases(bw, rt)
        ok &= count_cases(cs, native, counting, name, rt.tables, cases)
    for scene in [demo_scene()] + [big_scene(n_spheres=n, subdiv=3)
                                   for n in THRESHOLD_SPHERES]:
        threshold_case(cs, bw, pb, scene, dev)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
