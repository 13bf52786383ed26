"""igview: the interactive viewer, in the terminal.
Counterpart of ignis_tpu/cli/igview.py.

It renders progressively into the TERMINAL (24-bit ANSI half-block cells, 2
pixels per character row) and drives the camera through the parameter
registry (__camera_* keys), so a pose change rebuilds nothing.  It runs on
the CUDA device unless `--device` names another.

Controls (raw tty):
  w/a/s/d  move forward/left/back/right        q/e   move down/up
  arrows   look around                         r     reset accumulation
  +/-      exposure                            t     cycle tonemap operator
  v        cycle AOV view (Color/Normals/Albedo/Depth/Denoised)
  h        toggle luminance histogram pane
  1..9     save pose bookmark   F1..: use --poses file
  p        screenshot (EXR + tonemapped)       x     quit

Headless mode: --fly "x,y,z ..." renders a pose path to EXRs (used by the
tests, which cannot own a tty).

    python -m ignis_tpu_torch.cli.igview scene.json --fly "0,1,3;0,1,2"
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def _ansi_image(img, cols):
    """24-bit ANSI half-block rendering: 2 image rows per text row."""
    h, w, _ = img.shape
    step = max(1, w // cols)
    small = img[::step, ::step]
    if small.shape[0] % 2:
        small = small[:-1]
    top = small[0::2]
    bot = small[1::2]
    out = []
    for tr, br in zip(top, bot):
        line = []
        for t, b in zip(tr, br):
            line.append(f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m"
                        f"\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀")
        out.append("".join(line) + "\x1b[0m")
    return "\n".join(out)


_VIEWS = ("Color", "Normals", "Albedo", "Depth", "Denoised")


def _aov_frame(rt, mode):
    """AOV display frames: the infobuffer technique's Normals / Albedo /
    Depth buffers (camera rays of sample 0, seed 0) and the a-trous
    denoised color, mapped to displayable [0, 1] rgb (numpy)."""
    import torch

    from ignis_tpu_torch.render.techniques import infobuffer_aovs
    w, h = rt.scene.width, rt.scene.height
    idx = torch.arange(w * h, dtype=torch.int32, device=rt.device)
    with torch.no_grad():
        aov = infobuffer_aovs(rt.scene, rt.tables, idx % w, idx // w, 0, 0,
                              0, 0)
    aov = {k: v.cpu().numpy() for k, v in aov.items()}
    if mode == "Normals":
        img = aov["Normals"].reshape(h, w, 3) * 0.5 + 0.5
    elif mode == "Albedo":
        img = aov["Albedo"].reshape(h, w, 3)
    elif mode == "Depth":
        d = aov["Depth"].reshape(h, w)
        dmax = max(float(d[np.isfinite(d)].max(initial=0.0)), 1e-6)
        img = np.repeat((d / dmax)[..., None], 3, axis=-1)
    else:  # Denoised
        from ignis_tpu_torch.render.denoise import denoise_runtime
        img = denoise_runtime(rt)
    return np.clip(img, 0.0, 1.0)


def _histogram_pane(rt, cols, rows=6, bins=48):
    """Luminance histogram bar pane (data from `Runtime.imageinfo`)."""
    info = rt.imageinfo(bins=bins, histogram=True)
    hist = np.asarray(info["histogram"], np.float64)
    top = max(hist.max(), 1.0)
    blocks = " ▁▂▃▄▅▆▇█"
    # one text row of eighth-blocks per `rows` slice, oldest trick in tty
    lines = []
    for r in range(rows, 0, -1):
        lo, hi = (r - 1) / rows, r / rows
        cells = []
        for b in range(min(bins, cols)):
            f = hist[b] / top
            if f >= hi:
                cells.append(blocks[-1])
            elif f <= lo:
                cells.append(" ")
            else:
                cells.append(blocks[int((f - lo) / (hi - lo) * 8)])
        lines.append("".join(cells))
    lines.append(f"lum min={float(info['min']):.3g} "
                 f"avg={float(info['avg']):.3g} "
                 f"max={float(info['max']):.3g} (h hides)")
    return "\n".join(lines)


def _tonemapped(rt, method, exposure):
    import torch

    from ignis_tpu_torch.render.tonemap import tonemap
    img = torch.as_tensor(rt.currentFrame() * exposure, device=rt.device)
    ldr = tonemap(img, method=method).cpu().numpy()
    ldr = np.clip(ldr, 0.0, 1.0) ** (1 / 2.2)
    return (ldr * 255).astype(np.uint8)


class Orientation:
    """Camera eye / dir / up state."""

    def __init__(self, eye, d, up):
        self.eye = np.asarray(eye, np.float64)
        self.dir = np.asarray(d, np.float64)
        self.dir /= np.linalg.norm(self.dir)
        self.up = np.asarray(up, np.float64)

    @property
    def right(self):
        r = np.cross(self.dir, self.up)
        return r / max(np.linalg.norm(r), 1e-12)

    def move(self, f=0.0, r=0.0, u=0.0):
        self.eye = self.eye + self.dir * f + self.right * r + self.up * u

    def rotate(self, yaw=0.0, pitch=0.0):
        def rot(v, axis, ang):
            axis = axis / max(np.linalg.norm(axis), 1e-12)
            c, s = np.cos(ang), np.sin(ang)
            return (v * c + np.cross(axis, v) * s
                    + axis * np.dot(axis, v) * (1 - c))
        self.dir = rot(self.dir, self.up, yaw)
        self.dir = rot(self.dir, self.right, pitch)
        self.dir /= np.linalg.norm(self.dir)


def apply_pose(rt, o: Orientation):
    rt.setCameraOrientationParameter(o.eye, o.dir, o.up)
    rt.reset()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="igview-torch", description=__doc__)
    ap.add_argument("scene")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--spi", type=int, default=1)
    ap.add_argument("--cols", type=int, default=64,
                    help="terminal character columns")
    ap.add_argument("--fly", default=None,
                    help="headless: semicolon-separated eye poses "
                         "'x,y,z[,dx,dy,dz]' rendered to out/fly_####.exr")
    ap.add_argument("--frames-spp", type=int, default=8)
    ap.add_argument("--out", default="out")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from ignis_tpu_torch.api import Runtime
    from ignis_tpu_torch.utils.exr import write_exr
    rt = Runtime(args.scene, width=args.width, height=args.height,
                 device=args.device)
    cam = rt.scene.camera
    o = Orientation(cam.eye, cam.dir, cam.up)
    speed = max(rt.scene.scene_radius() * 0.05, 1e-3)

    if args.fly is not None:
        out = Path(args.out)
        out.mkdir(exist_ok=True)
        poses = [p for p in args.fly.split(";") if p.strip()]
        for i, p in enumerate(poses):
            v = [float(x) for x in p.split(",")]
            o.eye = np.asarray(v[:3], np.float64)
            if len(v) >= 6:
                o.dir = np.asarray(v[3:6], np.float64)
                o.dir /= np.linalg.norm(o.dir)
            apply_pose(rt, o)
            for _ in range(args.frames_spp // args.spi):
                rt.step(spi=args.spi)
            path = out / f"fly_{i:04d}.exr"
            write_exr(path, rt.currentFrame())
            print(f"pose {i}: eye={o.eye.round(3).tolist()} -> {path}")
        return 0

    # ---- interactive tty loop
    import select
    import termios
    import tty
    method = 3  # aces
    exposure = 1.0
    view = 0          # index into _VIEWS (v cycles)
    show_hist = False
    poses: dict = {}
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        print("\x1b[2J")  # clear
        apply_pose(rt, o)
        while True:
            rt.step(spi=args.spi)
            if _VIEWS[view] == "Color":
                ldr = _tonemapped(rt, method, exposure)
            else:
                ldr = (_aov_frame(rt, _VIEWS[view]) * 255).astype(np.uint8)
            sys.stdout.write("\x1b[H" + _ansi_image(ldr, args.cols))
            sys.stdout.write(
                f"\x1b[0m\n[{rt.currentSampleCount()} spp] "
                f"view={_VIEWS[view]} eye="
                f"{o.eye.round(2).tolist()} exp={exposure:.2f} "
                f"(wasdqe move, arrows look, v AOV, h hist, p shot, "
                f"x quit)  \n")
            if show_hist:
                sys.stdout.write(_histogram_pane(rt, args.cols) + "\n")
            sys.stdout.flush()
            if select.select([sys.stdin], [], [], 0.0)[0]:
                c = sys.stdin.read(1)
                if c == "x":
                    break
                elif c == "v":
                    view = (view + 1) % len(_VIEWS)
                    continue
                elif c == "h":
                    show_hist = not show_hist
                    sys.stdout.write("\x1b[2J")
                    continue
                elif c == "w":
                    o.move(f=speed)
                elif c == "s":
                    o.move(f=-speed)
                elif c == "a":
                    o.move(r=-speed)
                elif c == "d":
                    o.move(r=speed)
                elif c == "q":
                    o.move(u=-speed)
                elif c == "e":
                    o.move(u=speed)
                elif c == "r":
                    rt.reset()
                    continue
                elif c == "+":
                    exposure *= 1.25
                    continue
                elif c == "-":
                    exposure /= 1.25
                    continue
                elif c == "t":
                    method = (method + 1) % 5
                    continue
                elif c == "p":
                    Path(args.out).mkdir(exist_ok=True)
                    ts = int(time.time())
                    write_exr(Path(args.out) / f"shot_{ts}.exr",
                              rt.currentFrame())
                    continue
                elif c.isdigit():
                    poses[c] = (o.eye.copy(), o.dir.copy())
                    continue
                elif c == "\x1b":  # arrow keys
                    seq = sys.stdin.read(2)
                    if seq == "[A":
                        o.rotate(pitch=0.1)
                    elif seq == "[B":
                        o.rotate(pitch=-0.1)
                    elif seq == "[C":
                        o.rotate(yaw=-0.1)
                    elif seq == "[D":
                        o.rotate(yaw=0.1)
                    else:
                        continue
                else:
                    continue
                apply_pose(rt, o)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
    return 0


if __name__ == "__main__":
    sys.exit(main())
