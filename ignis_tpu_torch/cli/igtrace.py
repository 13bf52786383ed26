"""igtrace: the ray-list tracer.  Counterpart of ignis_tpu/cli/igtrace.py.

Reads rays "ox oy oz dx dy dz [tmin tmax]" one per line from a file or stdin
(up to the first empty line), traces them through the scene and writes the
per-ray RGB, tab-separated in scientific notation: the numerical comparison
oracle.  A `tmax` that is not above `tmin` means no limit.  It runs on the
CUDA device unless `--device` names another.

    python -m ignis_tpu_torch.cli.igtrace scene.json -i rays.txt -o out.txt
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def read_rays(stream):
    rays = []
    for line in stream:
        line = line.strip()
        if not line:
            break
        vals = [float(v) for v in line.split()]
        if len(vals) < 6:
            continue
        org = vals[0:3]
        d = vals[3:6]
        tmin = vals[6] if len(vals) > 6 else 0.0
        tmax = vals[7] if len(vals) > 7 else 0.0
        if tmax <= tmin:
            tmax = np.float32(3.4028235e38)
        rays.append((org, d, tmin, tmax))
    return rays


def main(argv=None):
    p = argparse.ArgumentParser(prog="igtrace-torch", description=__doc__)
    p.add_argument("scene")
    p.add_argument("-i", "--input", default=None,
                   help="ray file (default stdin)")
    p.add_argument("-o", "--output", default=None,
                   help="output file (default stdout)")
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)

    if args.input:
        with open(args.input) as f:
            rays = read_rays(f)
    else:
        rays = read_rays(sys.stdin)
    if not rays:
        print("No rays given", file=sys.stderr)
        return 1

    from ignis_tpu_torch.api import Runtime
    rt = Runtime(args.scene, seed=args.seed, device=args.device)
    colors = rt.trace(rays, spp=args.spp)

    lines = "".join(f"{c[0]:e}\t{c[1]:e}\t{c[2]:e}\n" for c in colors)
    if args.output:
        with open(args.output, "w") as out:
            out.write(lines)
    else:
        sys.stdout.write(lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
