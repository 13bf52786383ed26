#!/usr/bin/env python3
"""What the packet-BVH kernel (`csrc/packet_bvh.cu`) does per ray and per
warp, counted on the card.

    python3 scripts/torch_pb_check.py

Needs a CUDA device and `nvcc`.  Compiles a copy of `csrc/packet_bvh.cu` with
-DPB_COUNT (the diagnostic build: the same walk plus counters) into
`build/pb_count/`, runs `packet_bvh_closest` and `packet_bvh_any` through it
on the tables of `chip_smoke.py`'s `big` scene (512,002 triangles) under its
camera rays and its secondary (bounce-like) rays, at 65536 and at 4096 rays,
and prints one JSON line per case: per-ray means of inner rows and leaf rows
visited, boxes pushed and triangles tested; the deepest stack and the most
rows one ray visited (what a narrow tail wave waits for); for each loop of
the kernel (row visits, inner rows, leaf rows) the warp iterations and the
SIMT efficiency (active lanes / (32 x warp iterations)); and the device time
(CUDA-graph replay) of the regular build on the same inputs.  Bit-equality
with the plain version is `chip_smoke.py`'s and the `cuda`-marked tests'
business; this script checks that both builds return the same.
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

COUNTS = ("rays", "inner_rows", "leaf_rows", "boxes_pushed",
          "triangles_tested")
LOOPS = ("row_visits", "inner_rows", "leaf_rows")
N_COUNTS = 13


def counting_library(native):
    out = native.build_dir().parent / "pb_count"
    os.makedirs(out, exist_ok=True)
    so = out / "libpb_count.so"
    subprocess.run([native.find_nvcc(), *native.NVCC_FLAGS, "-DPB_COUNT",
                    "-shared", str(native.CSRC / "packet_bvh.cu"), "-o",
                    str(so)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    regular = native.library()
    for name in ("ignis_packet_bvh", "ignis_packet_bvh_stack_entries"):
        getattr(lib, name).argtypes = getattr(regular, name).argtypes
        getattr(lib, name).restype = getattr(regular, name).restype
    lib.ignis_packet_bvh_counts.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.ignis_packet_bvh_counts.restype = ctypes.c_int
    return lib


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ignis_tpu_torch import native
    from ignis_tpu_torch.api import Runtime
    from ignis_tpu_torch.ops import packet_bvh as pb
    from ignis_tpu_torch.scenes import big_scene
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    native.library()
    counting = counting_library(native)

    rt = Runtime(big_scene(**cs.BIG_SCENE), width=cs.FILM, height=cs.FILM,
                 device=dev)
    tb = rt.tables
    camera = cs.camera_rays(rt, int(np.sqrt(cs.N_RAYS)), dev)
    sets = {"camera": camera,
            "secondary": cs.secondary_rays(camera, pb.packet_bvh_closest_plain,
                                           tb, 12)}
    ok = True
    for sname, full in sets.items():
        tail = tuple(x[::cs.N_RAYS // cs.TAIL_RAYS].contiguous() for x in full)
        for rays in (full, tail):
            seg = rays[:3] + (torch.full_like(rays[3], 4.0),)
            for fn, args, mb in ((pb.packet_bvh_closest, rays, pb.MASK_BOUNCE),
                                 (pb.packet_bvh_any, seg, pb.MASK_SHADOW)):
                ref = fn(tb, *args, mask_bit=mb)
                got = (ctypes.c_ulonglong * N_COUNTS)()
                with mock.patch.object(native, "library", lambda: counting):
                    out = fn(tb, *args, mask_bit=mb)
                    torch.cuda.synchronize()
                    if counting.ignis_packet_bvh_counts(got):
                        raise RuntimeError("reading the counts failed")
                same = all(torch.equal(a, b) for a, b in zip(
                    (out,) if torch.is_tensor(out) else out,
                    (ref,) if torch.is_tensor(ref) else ref))
                ok &= same
                n = got[0]
                per_ray = {k: got[i] / max(n, 1)
                           for i, k in enumerate(COUNTS) if i}
                loops = {k: dict(warp_iterations=got[7 + 2 * i],
                                 simt_efficiency=got[8 + 2 * i]
                                 / max(32 * got[7 + 2 * i], 1))
                         for i, k in enumerate(LOOPS)}
                print(json.dumps(dict(
                    kernel=fn.__name__, rays=sname, n=int(n), per_ray=per_ray,
                    deepest_stack=got[5], longest_ray_rows=got[6],
                    loops=loops, builds_agree=same,
                    device_ms=cs.graph_ms(
                        lambda: fn(tb, *args, mask_bit=mb), 10))), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
