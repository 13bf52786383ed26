#!/usr/bin/env python3
"""How often the whole-soup Moeller-Trumbore kernel's early rejection lets a
pair through, counted on the card.

    python3 scripts/torch_mt_check.py

Needs a CUDA device and `nvcc`.  Compiles a copy of `csrc/mt_intersect.cu`
with -DMT_COUNT (the diagnostic build: the same loop plus three counters)
into `build/mt_count/`, runs `mt_closest` and `mt_any` through it, and prints
one JSON line per case: the pairs (rays x triangles), the pairs not rejected,
the warp iterations (a warp at one triangle: 128 pairs), those that entered
the full sequence for some lane, and the device time (CUDA-graph replay) of
the regular build on the same inputs.  The cases are the 32,002-triangle
scene of `chip_smoke.py` under bounce-like rays at 65536 and at 4096 rays,
and a soup of 32,002 large random triangles under 65536 random rays through
it.  Bit-equality with the plain version is `chip_smoke.py`'s and the
`cuda`-marked test's business; this script only checks that both builds
return the same.
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


def counting_library(native):
    out = native.build_dir().parent / "mt_count"
    os.makedirs(out, exist_ok=True)
    so = out / "libmt_count.so"
    subprocess.run([native.find_nvcc(), *native.NVCC_FLAGS, "-DMT_COUNT",
                    "-shared", str(native.CSRC / "mt_intersect.cu"), "-o",
                    str(so)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.ignis_mt_intersect.argtypes = native.MT_ARGTYPES
    lib.ignis_mt_intersect.restype = ctypes.c_int
    lib.ignis_mt_counts.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.ignis_mt_counts.restype = ctypes.c_int
    return lib


def random_soup(t, seed, dev):
    """Large triangles: vertices in [-2, 2]^3, edges up to 1 a coordinate."""
    r = np.random.default_rng(seed)
    f = lambda lo, hi: torch.from_numpy(
        r.uniform(lo, hi, (t, 3)).astype(np.float32)).to(dev)
    return f(-2, 2), f(-1, 1), f(-1, 1)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ignis_tpu_torch import native
    from ignis_tpu_torch.ops import mt_intersect as mt
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    native.library()
    counting = counting_library(native)

    rt = cs.sweep_runtime(cs.FILM, dev)
    tb = rt.tables
    scene = (tb["tri_v0"], tb["tri_e1"], tb["tri_e2"])
    full = cs.secondary_rays(
        cs.camera_rays(rt, int(np.sqrt(cs.N_RAYS)), dev),
        lambda tb_, *r: mt.mt_closest_plain(*r, *scene), tb, 12)
    tail = tuple(x[::cs.N_RAYS // cs.TAIL_RAYS].contiguous() for x in full)
    rnd = random_soup(scene[0].shape[0], 1, dev)
    r = np.random.default_rng(2)
    rnd_rays = (torch.from_numpy(r.uniform(-3, 3, (cs.N_RAYS, 3)).astype(
        np.float32)).to(dev), torch.nn.functional.normalize(torch.from_numpy(
            r.normal(0, 1, (cs.N_RAYS, 3)).astype(np.float32)).to(dev)),
        full[2], full[3])
    ok = True
    for soup_name, tris, rays in (("scene", scene, full), ("scene", scene, tail),
                                  ("large random", rnd, rnd_rays)):
        seg = rays[:3] + (torch.full_like(rays[3], 4.0),)
        for fn, args in ((mt.mt_closest, rays), (mt.mt_any, seg)):
            ref = fn(*args, *tris)
            got = (ctypes.c_ulonglong * 3)()
            with mock.patch.object(native, "library", lambda: counting):
                out = fn(*args, *tris)
                torch.cuda.synchronize()
                if counting.ignis_mt_counts(got):
                    raise RuntimeError("reading the counts failed")
            same = all(torch.equal(a, b) for a, b in zip(
                (out,) if torch.is_tensor(out) else out,
                (ref,) if torch.is_tensor(ref) else ref))
            ok &= same
            pairs = rays[0].shape[0] * tris[0].shape[0]
            print(json.dumps(dict(
                soup=soup_name, kernel=fn.__name__, rays=rays[0].shape[0],
                triangles=tris[0].shape[0], pairs=pairs,
                pairs_not_rejected=got[0], pair_share=got[0] / pairs,
                warp_iterations=got[2], warp_entries=got[1],
                warp_share=got[1] / max(got[2], 1), builds_agree=same,
                device_ms=cs.graph_ms(lambda: fn(*args, *tris), 10))),
                flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
