"""Denoiser: the edge-avoiding a-trous wavelet filter (Dammertz et al. 2010).
Counterpart of ignis_tpu/render/denoise.py.

Iterated 5x5 B3-spline convolutions with taps spread 2^i pixels apart, each
tap weighted by the radiance, normal and depth differences to the centre:
the guides of the `infobuffer` technique.  With an albedo guide the filter
runs on the demodulated irradiance and multiplies the albedo back at the end.
Plain tensor code: four iterations of 25 taps are some 1,500 launches a
frame; no kernel stands behind it.
"""

from __future__ import annotations

import numpy as np
import torch

# 5-tap B3 spline kernel
_B3 = np.array([1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16], np.float32)


def _shift2(img, dy, dx):
    """Clamp-to-edge shift of an (H, W, C) image: out[y, x] =
    img[clip(y + dy), clip(x + dx)]."""
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    ys = torch.clamp(torch.arange(h, device=dev) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=dev) + dx, 0, w - 1)
    return img[ys][:, xs]


def atrous_denoise(color, normals=None, depth=None, albedo=None,
                   iterations=4, sigma_color=0.45, sigma_normal=0.25,
                   sigma_depth=0.5):
    """Denoise an (H, W, 3) radiance image; normals (H, W, 3), depth (H, W)
    and albedo (H, W, 3) are optional guides."""
    color = torch.as_tensor(color, dtype=torch.float32)
    dev = color.device

    def guide(a):
        return None if a is None else torch.as_tensor(
            a, dtype=torch.float32).to(dev)

    normals, depth, albedo = guide(normals), guide(depth), guide(albedo)
    out = color
    if albedo is not None:
        alb = torch.clamp_min(albedo, 1e-3)
        out = out / alb
    if depth is not None:
        dscale = torch.clamp_min(depth.max() - depth.min(), 1e-6)
        depth_n = ((depth - depth.min()) / dscale)[..., None]
    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(out)
        wacc = torch.zeros(out.shape[:2] + (1,), dtype=torch.float32,
                           device=dev)
        for iy in range(5):
            for ix in range(5):
                dy = (iy - 2) * step
                dx = (ix - 2) * step
                k = float(_B3[iy] * _B3[ix])
                q = _shift2(out, dy, dx)
                dc = torch.sum((q - out) ** 2, dim=-1)
                w = k * torch.exp(-dc / (sigma_color * sigma_color
                                         * float(step)))
                if normals is not None:
                    dn = torch.sum((_shift2(normals, dy, dx) - normals) ** 2,
                                   dim=-1)
                    w = w * torch.exp(-dn / (sigma_normal * sigma_normal))
                if depth is not None:
                    dd = (_shift2(depth_n, dy, dx) - depth_n)[..., 0] ** 2
                    w = w * torch.exp(-dd / (sigma_depth * sigma_depth))
                acc = acc + q * w[..., None]
                wacc = wacc + w[..., None]
        out = acc / torch.clamp_min(wacc, 1e-8)
    if albedo is not None:
        out = out * alb
    return out


def denoise_runtime(rt, iterations=4):
    """Denoise a Runtime's current frame with its own infobuffer AOVs (the
    camera rays of sample 0, iteration 0, frame 0).  Returns numpy
    (H, W, 3)."""
    from ignis_tpu_torch.render.techniques import infobuffer_aovs
    w, h = rt.scene.width, rt.scene.height
    idx = torch.arange(w * h, dtype=torch.int32, device=rt.device)
    with torch.no_grad():
        aovs = infobuffer_aovs(rt.scene, rt.tables, idx % w, idx // w, 0, 0,
                               0, rt.seed)
        out = atrous_denoise(
            rt._frame_tensor(),
            normals=aovs["Normals"].reshape(h, w, 3),
            depth=aovs["Depth"].reshape(h, w),
            albedo=aovs["Albedo"].reshape(h, w, 3),
            iterations=iterations)
    return out.cpu().numpy()
