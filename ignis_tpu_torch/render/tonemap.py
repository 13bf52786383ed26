"""Tonemapping and image statistics.  Counterpart of
ignis_tpu/render/tonemap.py.

Luminance-domain operators in xyY with false colours for NaN (cyan), Inf
(pink) and negative (orange) pixels, and the image statistics (min / max /
avg luminance, soft percentiles over 3x3 windows, an integer histogram and
the NaN / Inf / negative counts).  Every function takes and returns tensors
on the image's device.
"""

from __future__ import annotations

import torch

from ignis_tpu_torch.core.vec import device_const, to_int32

TONEMAP_NONE = 0
TONEMAP_REINHARD = 1
TONEMAP_REINHARD_MODIFIED = 2
TONEMAP_ACES = 3
TONEMAP_UNCHARTED2 = 4
METHODS = {"none": TONEMAP_NONE, "reinhard": TONEMAP_REINHARD,
           "modified": TONEMAP_REINHARD_MODIFIED, "aces": TONEMAP_ACES,
           "uncharted2": TONEMAP_UNCHARTED2}

_FLT_EPS = 1.1920928955078125e-07
_SRGB_TO_XYZ = ((0.4124564, 0.3575761, 0.1804375),
                (0.2126729, 0.7151522, 0.0721750),
                (0.0193339, 0.1191920, 0.9503041))
_XYZ_TO_SRGB = ((3.2404542, -1.5371385, -0.4985314),
                (-0.9692660, 1.8760108, 0.0415560),
                (0.0556434, -0.2040259, 1.0572252))


def _mat(m, like):
    return device_const(m, torch.float32, like.device)


def srgb_to_xyz(c):
    return c @ _mat(_SRGB_TO_XYZ, c).T


def xyz_to_srgb(c):
    return c @ _mat(_XYZ_TO_SRGB, c).T


def srgb_to_xyY(c):
    s = srgb_to_xyz(c)
    n = torch.sum(s, dim=-1, keepdim=True)
    safe = torch.clamp_min(n, _FLT_EPS)
    out = torch.cat([s[..., :2] / safe, s[..., 1:2]], dim=-1)
    return torch.where(n <= _FLT_EPS, torch.zeros_like(out), out)


def xyY_to_srgb(c):
    x, y, Y = c[..., 0], c[..., 1], c[..., 2]
    safe_y = torch.clamp_min(y, _FLT_EPS)
    X = x * Y / safe_y
    Z = (1.0 - x - y) * Y / safe_y
    rgb = xyz_to_srgb(torch.stack([X, Y, Z], dim=-1))
    return torch.where((y <= _FLT_EPS)[..., None], torch.zeros_like(rgb), rgb)


def srgb_gamma(x):
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(torch.clamp_min(x, 1e-12),
                                         0.416666667) - 0.055)


def srgb_invgamma(x):
    return torch.where(x <= 0.04045, x / 12.92,
                       (torch.pow(torch.clamp_min(x, 0.0), 2.4) + 0.055)
                       / 1.055)


def _reinhard(L):
    return L / (1.0 + L)


def _reinhard_modified(L):
    wp2 = 16.0
    return L * (1.0 + L / wp2) / (1.0 + L)


def _aces(L):
    return torch.clamp_min(L * (2.51 * L + 0.03)
                           / (L * (2.43 * L + 0.59) + 0.14), 0.0)


def _uncharted2(L):
    def f(x):
        a, b, c, d, e, fw = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
        return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * fw)
                - e / fw)
    return f(L) / f(11.2)


_OPERATORS = {
    TONEMAP_NONE: lambda l: l,
    TONEMAP_REINHARD: _reinhard,
    TONEMAP_REINHARD_MODIFIED: _reinhard_modified,
    TONEMAP_ACES: _aces,
    TONEMAP_UNCHARTED2: _uncharted2,
}


def tonemap(image, method=TONEMAP_ACES, scale=1.0, exposure_factor=1.0,
            exposure_offset=0.0, use_gamma=True):
    """(H, W, 3) linear -> (H, W, 3) in [0, 1], bad pixels false-coloured."""
    img = torch.as_tensor(image, dtype=torch.float32) * scale
    xyY = srgb_to_xyY(img)
    L = exposure_factor * xyY[..., 2] + exposure_offset
    nL = _OPERATORS[method](L)
    color = xyY_to_srgb(torch.stack([xyY[..., 0], xyY[..., 1], nL], dim=-1))
    if use_gamma:
        color = srgb_gamma(color)
    color = torch.clamp(color, 0.0, 1.0)

    lum = xyY[..., 2]
    is_nan = torch.isnan(lum)
    is_inf = ~torch.isfinite(lum) & ~is_nan
    is_neg = torch.any(img < 0.0, dim=-1)
    for mask, c in ((is_neg, (1.0, 1.0, 0.0)), (is_inf, (1.0, 0.0, 150 / 255)),
                    (is_nan, (0.0, 1.0, 1.0))):
        color = torch.where(mask[..., None],
                            device_const(c, torch.float32, img.device), color)
    return color


def image_info(image, scale=1.0, bins=64, histogram=False,
               percentile=False):
    """min / max / avg luminance and NaN / Inf / negative pixel counts (+ the
    soft percentiles of 3x3 windows over interior pixels, and a histogram of
    `bins` int32 counts).  Non-finite components count as 0 in the
    luminance.  Returns a dict of 0-d (histogram: 1-d) tensors."""
    img = torch.as_tensor(image, dtype=torch.float32)
    out_counts = {
        "nan_count": torch.isnan(img).any(dim=-1).sum(),
        "inf_count": torch.isinf(img).any(dim=-1).sum(),
        "neg_count": (img < 0).any(dim=-1).sum(),
    }
    safe = torch.where(torch.isfinite(img), img, torch.zeros_like(img)) * scale
    lum = srgb_to_xyY(safe)[..., 2]
    out = {"min": lum.min(), "max": lum.max(), "avg": lum.mean(),
           **out_counts}
    if percentile and lum.ndim == 2 and lum.shape[0] > 10 \
            and lum.shape[1] > 10:
        h, w = lum.shape
        windows = torch.stack([lum[1 + di:h - 1 + di, 1 + dj:w - 1 + dj]
                               for di in (-1, 0, 1) for dj in (-1, 0, 1)],
                              dim=-1)
        s = torch.sort(windows, dim=-1).values
        out["soft_min"] = s[..., 1].min()
        out["soft_max"] = s[..., 7].max()
        out["median"] = s[..., 4].mean()
    if histogram:
        lo = out["min"]
        hi = torch.maximum(out["max"], out["min"] + 1e-20)
        idx = torch.clamp(to_int32((lum - lo) / (hi - lo) * bins), 0,
                          bins - 1)
        out["histogram"] = torch.bincount(
            idx.reshape(-1).long(), minlength=bins).to(torch.int32)
    return out
