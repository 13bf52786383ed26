#!/usr/bin/env python3
"""What the two-level instanced kernel (`csrc/tlas.cu`) does per ray and per
warp, counted on the card.

    python3 scripts/torch_tlas_check.py

Needs a CUDA device and `nvcc`.  Compiles a copy of `csrc/tlas.cu` with
-DTLAS_COUNT (the diagnostic build: the same walk plus counters) into
`build/tlas_count/`, runs `tlas_closest` and `tlas_any` through it on the
`instanced` scene of `chip_smoke.py` under its secondary (bounce-like) rays,
at 65536 and at 4096 rays, and prints one JSON line per case: per-ray means
of top rows visited, instances entered, cluster-tree nodes and cluster boxes
decided, and triangles tested; for each loop of the kernel (top rows, leaf
slots, cluster walk, triangles) the warp iterations and the SIMT efficiency
(active lanes / (32 x warp iterations)); the most loop iterations one ray
took (what a narrow tail wave waits for); and the device time (CUDA-graph
replay) of the regular build on the same inputs.  Each case runs
twice: `walk` on the tables as built, `dense` with every instance's cluster
tree emptied (`tl_ctree` headers of 0 levels), which is the plain
cluster-by-cluster sweep.  Bit-equality with the plain version is
`chip_smoke.py`'s and the `cuda`-marked test's business; this script checks
that both builds and both modes return the same.
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

COUNTS = ("rays", "top_rows", "instances_entered", "tree_nodes",
          "cluster_boxes", "triangles")
LOOPS = ("top_rows", "leaf_slots", "cluster_walk", "triangles")


def counting_library(native):
    out = native.build_dir().parent / "tlas_count"
    os.makedirs(out, exist_ok=True)
    so = out / "libtlas_count.so"
    subprocess.run([native.find_nvcc(), *native.NVCC_FLAGS, "-DTLAS_COUNT",
                    "-shared", str(native.CSRC / "tlas.cu"), "-o", str(so)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    regular = native.library()
    for name in ("ignis_tlas", "ignis_tlas_stack_entries"):
        getattr(lib, name).argtypes = getattr(regular, name).argtypes
        getattr(lib, name).restype = getattr(regular, name).restype
    lib.ignis_tlas_counts.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.ignis_tlas_counts.restype = ctypes.c_int
    return lib


def dense_tables(tb):
    """The same tables with every instance's cluster tree emptied."""
    ctree = tb["tl_ctree"].clone()
    ctree[:tb["tl_inst"].shape[0]] = 0.0
    return dict(tb, tl_ctree=ctree)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ignis_tpu_torch import native
    from ignis_tpu_torch.api import Runtime
    from ignis_tpu_torch.ops import tlas
    from ignis_tpu_torch.ops.packet_bvh import MASK_BOUNCE, MASK_SHADOW
    from ignis_tpu_torch.scenes import instanced_scene
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    native.library()
    counting = counting_library(native)

    rt = Runtime(instanced_scene(), width=cs.FILM, height=cs.FILM, device=dev)
    tb = rt.tables
    closest_plain = cs.tlas_adapters(tlas)[1]
    full = cs.secondary_rays(cs.camera_rays(rt, int(np.sqrt(cs.N_RAYS)), dev),
                             closest_plain, tb, 12)
    tail = tuple(x[::cs.N_RAYS // cs.TAIL_RAYS].contiguous() for x in full)
    modes = {"walk": tb, "dense": dense_tables(tb)}
    ok = True
    for rays in (full, tail):
        seg = rays[:3] + (torch.full_like(rays[3], 4.0),)
        for fn, args, mb in ((tlas.tlas_closest, rays, MASK_BOUNCE),
                             (tlas.tlas_any, seg, MASK_SHADOW)):
            ref = fn(tb, *args, mask_bit=mb)
            for mode, tables in modes.items():
                got = (ctypes.c_ulonglong * 15)()
                with mock.patch.object(native, "library", lambda: counting):
                    out = fn(tables, *args, mask_bit=mb)
                    torch.cuda.synchronize()
                    if counting.ignis_tlas_counts(got):
                        raise RuntimeError("reading the counts failed")
                same = all(torch.equal(a, b) for a, b in zip(
                    (out,) if torch.is_tensor(out) else out,
                    (ref,) if torch.is_tensor(ref) else ref))
                ok &= same
                n = got[0]
                per_ray = {k: got[i] / max(n, 1)
                           for i, k in enumerate(COUNTS) if i}
                loops = {k: dict(warp_iterations=got[6 + 2 * i],
                                 simt_efficiency=got[7 + 2 * i]
                                 / max(32 * got[6 + 2 * i], 1))
                         for i, k in enumerate(LOOPS)}
                print(json.dumps(dict(
                    kernel=fn.__name__, mode=mode, rays=int(n),
                    per_ray=per_ray, loops=loops, longest_ray_steps=got[14],
                    builds_agree=same,
                    device_ms=cs.graph_ms(
                        lambda: fn(tables, *args, mask_bit=mb), 10))),
                    flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
