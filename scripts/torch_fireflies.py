#!/usr/bin/env python3
"""The lanes of the `train` phase's render that stand far above the rest.

    python3 scripts/torch_fireflies.py [--threshold 100] [--top 16]

Renders `materials_scene()` at 512x512 without a clamp, one lane a pixel,
sample, iteration, frame and seed 0: the render of `chip_smoke.py`'s `train`
phase before the phase clamps it.  It does so through
`trace_wave(differentiable=True)` on the CUDA device, with the true
parameters (the phase's target) and with the phase's perturbed start, and
prints for each the lanes whose largest channel exceeds `--threshold` (the
`--top` largest): pixel x, y and radiance.  Then it renders those pixels
again on the CPU through the same function and prints that radiance beside
the device's.  The same pixels through the JAX package are held to the CPU
values by `tests/test_torch_materials_render.py`.  Writes the result to
`chiprun_out/fireflies.json` too.  Needs a CUDA device; prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import FILM, lanes_over_film, perturbed_tables  # noqa: E402
from ignis_tpu_torch.api import Runtime  # noqa: E402
from ignis_tpu_torch.render.integrator import trace_wave  # noqa: E402
from ignis_tpu_torch.scenes import materials_scene  # noqa: E402


def render(rt, tables, x, y):
    return trace_wave(rt.scene, tables, x, y, 0, 0, 0, 0,
                      differentiable=True).detach()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--threshold", type=float, default=100.0)
    ap.add_argument("--top", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fireflies: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    rts = {dev: Runtime(materials_scene(), width=FILM, height=FILM,
                        device=dev) for dev in ("cuda", "cpu")}
    out = {}
    for which in ("target", "start"):
        tabs = {dev: (rt.tables if which == "target"
                      else perturbed_tables(rt)[0])
                for dev, rt in rts.items()}
        x, y = lanes_over_film(FILM * FILM, FILM, "cuda")
        color = render(rts["cuda"], tabs["cuda"], x, y)
        peak = color.amax(dim=-1)
        lanes = torch.nonzero(peak > args.threshold).flatten()
        lanes = lanes[torch.argsort(peak[lanes], descending=True)][:args.top]
        xs, ys = x[lanes].cpu(), y[lanes].cpu()
        cpu = render(rts["cpu"], tabs["cpu"], xs, ys)
        rows = [dict(x=int(a), y=int(b), cuda=c.tolist(), cpu=d.tolist())
                for a, b, c, d in zip(xs, ys, color[lanes].cpu(), cpu)]
        out[which] = dict(
            lanes_above=int((peak > args.threshold).sum()),
            image_mean=float(color.mean()),
            mean_without_them=float(color[peak <= args.threshold].mean()),
            fireflies=rows)
        print(json.dumps({which: out[which]}), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "fireflies.json"), "w") as f:
        json.dump(dict(threshold=args.threshold, **out), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
