"""Glare analysis: the daylight glare probability (DGP) of a rendered frame.
Counterpart of ignis_tpu/render/glare.py.

Every per-pixel quantity (luminance, solid angle, cos factor, glare mask) is
computed as one tensor pass over the frame and reduced with tensor sums:
  * luminance in lux = 179 (white efficiency) * Y of the sRGB pixel scaled by
    `scale`;
  * a pixel is a glare source when its luminance exceeds avg * mul * 179;
  * a pixel's solid angle is the spherical excess of the quad spanned by its
    four corner camera rays;
  * the position index is Guth's above the line of sight and Iwata's below,
    clamped to 16;
  * DGP = c1 E_v + c2 log10(1 + Ls^2 omega / (P^2 E_v^1.87)) + c3, with
    c1 = 5.87e-5, c2 = 0.0981, c3 = 0.16.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from ignis_tpu_torch.core.vec import device_const
from ignis_tpu_torch.render.camera import generate_rays, pixel_coord_from_xy
from ignis_tpu_torch.render.tonemap import srgb_to_xyY

WHITE_EFFICIENCY = 179.0  # standard illuminant E
_PI = math.pi


@dataclass
class GlareSettings:
    max: float = 1.0
    avg: float = 0.0
    mul: float = 6.0
    scale: float = 1.0
    vertical_illuminance: float = -1.0  # < 0: computed from the image


@dataclass
class GlareOutput:
    dgp: float
    vertical_illuminance: float
    avg_lum: float
    avg_omega: float
    num_pixels: int


_INFERNO = (
    (0.0002189403, 0.001651004, -0.01948089),
    (0.1065134, 0.5639564, 3.932712),
    (11.60249, -3.972853, -15.9424),
    (-41.70399, 17.43639, 44.35414),
    (77.16293, -33.40235, -81.80731),
    (-71.31942, 32.62606, 73.20951),
    (25.13112, -12.24266, -23.07032),
)


def _inferno(t):
    """Polynomial fit of matplotlib's inferno colormap."""
    t = torch.clamp(t, 0.0, 1.0)[..., None]
    c = device_const(_INFERNO, torch.float32, t.device)
    r = c[0] + t * (c[1] + t * (c[2] + t * (c[3] + t * (
        c[4] + t * (c[5] + t * c[6])))))
    return torch.clamp(r, 0.0, 1.0)


def _grid(w, h, device):
    xs = torch.arange(w, dtype=torch.float32, device=device)
    ys = torch.arange(h, dtype=torch.float32, device=device)
    return torch.meshgrid(xs, ys, indexing="xy")


def _corner_dirs(cam, w, h, device="cpu"):
    """Ray directions on the (w+1) x (h+1) grid of pixel corners."""
    gx, gy = _grid(w + 1, h + 1, device)
    nx, ny = pixel_coord_from_xy(gx.reshape(-1), gy.reshape(-1), w, h, 0.0,
                                 0.0)
    _, dirs, _, _ = generate_rays(cam, nx, ny)
    return dirs.reshape(h + 1, w + 1, 3)


def pixel_solid_angles(cam, w, h, device="cpu"):
    """Per-pixel solid angle (H, W), the spherical excess of each pixel's
    corner rays.  In float32, as the reference: four angles near pi less
    2 pi keep 2 pi's rounding (5e-7 a pixel, some 1 % of a 512x512 pixel's
    solid angle), so the last bit of `arccos`, which differs between the
    CPU and the card, reaches a frame's DGP at about 1e-5."""
    d = _corner_dirs(cam, w, h, device)
    r1 = d[:-1, :-1]   # (x,   y)
    r2 = d[1:, :-1]    # (x,   y+1)
    r3 = d[1:, 1:]     # (x+1, y+1)
    r4 = d[:-1, 1:]    # (x+1, y)

    def splane(a, b):
        n = torch.linalg.cross(a, b - a, dim=-1)
        l2 = torch.sum(n * n, dim=-1, keepdim=True)
        return torch.where(l2 > 0, n / torch.sqrt(torch.clamp_min(l2, 1e-30)),
                           torch.zeros_like(n))

    n1, n2, n3, n4 = (splane(r1, r2), splane(r2, r3), splane(r3, r4),
                      splane(r4, r1))

    def ang(a, b):
        dot = torch.clamp(torch.sum(a * b, dim=-1), -1.0, 1.0)
        return _PI - torch.abs(torch.arccos(dot))

    return (ang(n1, n2) + ang(n2, n3) + ang(n3, n4) + ang(n4, n1)
            - 2.0 * _PI)


def _position_index(cam, dir):
    """Position index of one view ray `dir` (3,): Guth's model, Iwata's
    below the line of sight."""
    dev = dir.device
    up = torch.as_tensor(cam.up, dtype=torch.float32, device=dev)
    d = torch.as_tensor(cam.dir, dtype=torch.float32, device=dev)
    right = torch.linalg.cross(d, up)
    right = right / torch.clamp_min(torch.linalg.norm(right), 1e-20)

    def acos_dot(a, b):
        return torch.arccos(torch.clamp(torch.dot(a, b), -1.0, 1.0))

    vangle = acos_dot(up, dir) - _PI / 2.0
    hangle = _PI / 2.0 - acos_dot(right, dir)
    sigma = acos_dot(d, dir)

    t = torch.cos(sigma)
    hv = dir / torch.where(torch.abs(t) < 1e-6, torch.full_like(t, 1e-6),
                           t) - dir
    hv = hv / torch.clamp_min(torch.linalg.norm(hv), 1e-20)
    tau = acos_dot(up, hv)

    deg = 180.0 / _PI
    phi = torch.where(vangle == 0.0, torch.full_like(vangle, 1e-5), vangle)
    theta = torch.where(hangle == 0.0, torch.full_like(hangle, 1e-4), hangle)
    sigma = torch.abs(sigma)
    tau_d = tau * deg
    sig_d = sigma * deg

    guth = torch.exp(
        (35.2 - 0.31889 * tau_d - 1.22 * torch.exp(-2.0 * tau_d / 9.0))
        / 1000.0 * sig_d
        + (21.0 + 0.26667 * tau_d - 0.002963 * tau_d * tau_d) / 100000.0
        * sig_d * sig_d)

    # Iwata's model below the line of sight
    dd = 1.0 / torch.tan(phi)
    s = torch.tan(theta) / torch.tan(phi)
    r = torch.sqrt(1.0 / (dd * dd) + s * s / (dd * dd))
    fact = torch.where(r > 0.6, torch.full_like(r, 1.2),
                       torch.full_like(r, 0.8))
    r = torch.clamp_max(r, 3.0)
    iwata = 1.0 + fact * r

    return torch.clamp_max(torch.where(phi < 0.0, iwata, guth), 16.0)


def evaluate_glare(cam, image, settings: GlareSettings):
    """DGP of a normalized, linear sRGB (H, W, 3) image tensor.

    Returns (dict of the GlareOutput fields as 0-d tensors, heatmap
    (H, W, 3), glare-source mask (H, W)), on the image's device."""
    h, w = image.shape[0], image.shape[1]
    dev = image.device
    img = torch.where(torch.isfinite(image), image, torch.zeros_like(image))
    lum = WHITE_EFFICIENCY * srgb_to_xyY(img * settings.scale)[..., 2]

    lum_max = WHITE_EFFICIENCY * settings.max
    lum_source = WHITE_EFFICIENCY * (settings.avg * settings.mul)

    omega = pixel_solid_angles(cam, w, h, dev)

    gx, gy = _grid(w, h, dev)
    nx, ny = pixel_coord_from_xy(gx.reshape(-1), gy.reshape(-1), w, h, 0.0,
                                 0.0)
    _, dirs, _, _ = generate_rays(cam, nx, ny)
    dirs = dirs.reshape(h, w, 3)
    cam_dir = torch.as_tensor(cam.dir, dtype=torch.float32, device=dev)
    cos_f = torch.abs(dirs @ cam_dir)

    if settings.vertical_illuminance < 0:
        e_v = torch.sum(lum * cos_f * omega)
    else:
        e_v = torch.tensor(float(np.float32(settings.vertical_illuminance)),
                           dtype=torch.float32, device=dev)

    mask = lum > lum_source
    zero = torch.zeros_like(omega)
    num_pixels = torch.sum(mask.to(torch.int32))
    glare_omega = torch.sum(torch.where(mask, omega, zero))
    safe_go = torch.clamp_min(glare_omega, 1e-20)
    glare_lum = torch.sum(torch.where(mask, lum * omega, zero)) / safe_go
    glare_x = torch.sum(torch.where(mask, gx * omega, zero)) / safe_go
    glare_y = torch.sum(torch.where(mask, gy * omega, zero)) / safe_go

    # the position index at the omega-weighted glare centroid
    cnx, cny = pixel_coord_from_xy(torch.floor(glare_x), torch.floor(glare_y),
                                   w, h, 0.0, 0.0)
    _, cdir, _, _ = generate_rays(cam, cnx[None], cny[None])
    posi = _position_index(cam, cdir[0])

    c1, c2, c3 = 5.87e-5, 0.0981, 0.16
    a1, a2, a3, a4, a5 = 2.0, 1.0, 1.87, 2.0, 1.0
    safe_ev = torch.clamp_min(e_v, 1e-20)
    dgp_acc = (torch.pow(glare_lum, a1) / torch.pow(posi, a4)
               * torch.pow(glare_omega, a2) / torch.pow(safe_ev, a3))
    source_dgp = torch.log10(1.0 + dgp_acc)
    base = c1 * torch.pow(safe_ev, a5)
    dgp = torch.where(glare_omega > 0, base + c2 * source_dgp + c3,
                      base + c3)

    # heatmap: the inferno ramp on the squared relative overshoot
    max_diff = max(1.1920929e-07, lum_max - lum_source)
    lerp = (lum - lum_source) / max_diff
    heat = _inferno(torch.clamp(lerp * lerp, 0.0, 1.0))

    out = {
        "dgp": dgp,
        "vertical_illuminance": e_v,
        "avg_lum": glare_lum,
        "avg_omega": glare_omega,
        "num_pixels": num_pixels,
    }
    return out, heat, mask


def complete_settings(image, settings: GlareSettings):
    """`settings` with `avg` / `max` set to the image's average / largest
    luminance (of its finite pixels) where they are not positive."""
    if settings.avg > 0 and settings.max > 0:
        return settings
    img = torch.as_tensor(image, dtype=torch.float32)
    y = srgb_to_xyY(img * settings.scale)[..., 2].cpu().numpy()
    y = y[np.isfinite(y)]
    if y.size == 0:
        y = np.zeros(1, np.float32)
    repl = {}
    if settings.avg <= 0:
        repl["avg"] = float(np.mean(y))
    if settings.max <= 0:
        repl["max"] = float(np.max(y))
    return dataclasses.replace(settings, **repl)


def evaluate_glare_host(cam, image, settings: GlareSettings):
    """`evaluate_glare` of an image (numpy, or a tensor on any device) with
    host outputs: (GlareOutput, heatmap numpy (H, W, 3), mask numpy
    (H, W))."""
    out, heat, mask = evaluate_glare(
        cam, torch.as_tensor(image, dtype=torch.float32), settings)
    return (
        GlareOutput(
            dgp=float(out["dgp"]),
            vertical_illuminance=float(out["vertical_illuminance"]),
            avg_lum=float(out["avg_lum"]),
            avg_omega=float(out["avg_omega"]),
            num_pixels=int(out["num_pixels"]),
        ),
        heat.cpu().numpy(),
        mask.cpu().numpy(),
    )
