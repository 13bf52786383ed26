"""Image conversion tools: exr2hdr, hdr2exr, exr2png, exr2jpg.
Counterpart of ignis_tpu/cli/imgutil.py.

    python -m ignis_tpu_torch.cli.imgutil exr2hdr in.exr [out.hdr]
    python -m ignis_tpu_torch.cli.imgutil hdr2exr in.hdr [out.exr]
    python -m ignis_tpu_torch.cli.imgutil exr2png in.exr [out.png]
        [--exposure E] [--tonemap none|reinhard|modified|aces|uncharted2]
        [--no-gamma]
    python -m ignis_tpu_torch.cli.imgutil exr2jpg ... (same flags)

The LDR conversions tonemap (`render.tonemap`, on the CUDA device unless
`--device` names another), apply a 1/2.2 gamma and write 8 bits through PIL.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def _write_hdr(path, img):
    """Radiance RGBE writer (uncompressed scanlines)."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        m = img.max(axis=-1)
        exp = np.zeros((h, w), np.int32)
        nz = m > 1e-32
        exp[nz] = np.frexp(m[nz])[1]
        scale = np.zeros((h, w), np.float32)
        scale[nz] = np.ldexp(1.0, -exp[nz]) * 256.0
        rgbe = np.zeros((h, w, 4), np.uint8)
        rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(
            np.uint8)
        rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
        f.write(rgbe.tobytes())


def _tonemap_ldr(img, method, exposure, gamma, device):
    """(H, W, 3) linear -> (H, W, 3) uint8, tonemapped on `device`."""
    import torch

    from ignis_tpu_torch.render.tonemap import METHODS, tonemap
    img = torch.as_tensor(np.asarray(img) * exposure, device=device)
    out = tonemap(img, method=METHODS[method]).cpu().numpy()
    out = np.clip(out, 0.0, 1.0)
    if gamma:
        out = np.power(out, 1.0 / 2.2)
    return (out * 255.0 + 0.5).astype(np.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="igimg-torch", description=__doc__)
    ap.add_argument("mode", choices=["exr2hdr", "hdr2exr", "exr2png",
                                     "exr2jpg"])
    ap.add_argument("input")
    ap.add_argument("output", nargs="?")
    ap.add_argument("--exposure", type=float, default=1.0)
    ap.add_argument("--tonemap", default="aces",
                    choices=["none", "reinhard", "modified", "aces",
                             "uncharted2"])
    ap.add_argument("--no-gamma", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the tonemap (default: the CUDA "
                         "device)")
    args = ap.parse_args(argv)

    from ignis_tpu_torch.texture.loader import _load_hdr
    from ignis_tpu_torch.utils.exr import read_exr, write_exr

    inp = Path(args.input)
    ext = {"exr2hdr": ".hdr", "hdr2exr": ".exr", "exr2png": ".png",
           "exr2jpg": ".jpg"}[args.mode]
    out = Path(args.output) if args.output else inp.with_suffix(ext)

    if args.mode == "exr2hdr":
        _write_hdr(out, read_exr(inp))
    elif args.mode == "hdr2exr":
        write_exr(out, _load_hdr(inp))  # _load_hdr returns file row order
    else:
        from ignis_tpu_torch.api import resolve_device
        img = read_exr(inp)
        ldr = _tonemap_ldr(img, args.tonemap, args.exposure,
                           not args.no_gamma, resolve_device(args.device))
        from PIL import Image
        Image.fromarray(ldr).save(out)
    print(f"{inp} -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
