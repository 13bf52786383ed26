"""Environment-map CDF construction and sampling.

Counterpart of ignis_tpu/light/env_cdf.py.  The host builders (row-conditional
CDFs with a sin-premultiplied, MIS-compensated marginal, and the summed-area
variant) are copies of the JAX package's numpy code and give the same bits;
the device part (sampling, pdf, the env direction <-> uv maps) is torch.
"""

from __future__ import annotations

import numpy as np
import torch

from ignis_tpu_torch.core.vec import PI, clip, safe_div, to_int32


def build_cdf2d(img: np.ndarray, premultiply_sin=True, compensate=True):
    """img: (H, W, 3) — returns (marginal (H,), conditional (H, W))."""
    h, w = img.shape[0], img.shape[1]
    min_eps = 1e-5
    defect = np.zeros(3, np.float32)
    if compensate:
        defect = np.maximum(img, 0).mean(axis=(0, 1)).astype(np.float32)
    lum = np.maximum(img - defect, 0.0).mean(axis=2)  # (H, W)
    cond = np.cumsum(lum, axis=1)
    row_sum = cond[:, -1].copy()
    good = row_sum > min_eps
    cond = np.where(good[:, None], cond / np.maximum(row_sum[:, None], min_eps),
                    (np.arange(w, dtype=np.float32)[None, :] / (w - 1)))
    cond[:, -1] = 1.0

    marg = row_sum
    if premultiply_sin:
        marg = marg * np.sin(np.pi * (np.arange(h) + 0.5) / h)
    marg = np.cumsum(marg)
    if marg[-1] > min_eps:
        marg = marg / marg[-1]
    else:
        marg = np.arange(h, dtype=np.float32) / (h - 1)
    marg[-1] = 1.0
    return marg.astype(np.float32), cond.astype(np.float32)


def build_sat2d(img: np.ndarray, premultiply_sin=True, compensate=True):
    """Summed-area-table env CDF variant (CDF.cpp:135-193
    computeForImageSAT), selected by `cdf_method: "sat"` on env lights
    (EnvironmentLight.cpp:15).  Returns the normalized (H, W) SAT with
    the reference's exact weighting: sin premultiply per row, the MIS
    compensation defect subtracted per channel, channel-mean / 3."""
    h, w = img.shape[0], img.shape[1]
    min_eps = 1e-5
    defect = np.zeros(3, np.float32)
    if compensate:
        defect = np.maximum(img, 0).mean(axis=(0, 1)).astype(np.float32)
    val = np.maximum(img - defect, 0.0).sum(axis=2) / 3.0
    if premultiply_sin:
        val = val * np.sin(np.pi * (np.arange(h) + 0.5) / h)[:, None]
    sat = np.cumsum(np.cumsum(val, axis=0), axis=1)
    total = sat[-1, -1]
    if total > min_eps:
        sat = sat / total
    else:
        sat = (np.arange(h * w, dtype=np.float64) / (h * w - 1)).reshape(
            h, w)
    sat[-1, -1] = 1.0
    return sat.astype(np.float32)


def sat_to_cdf(sat: np.ndarray):
    """Derive the (marginal, conditional) sampling tables from a SAT —
    the induced distribution is identical (the SAT is just the 2D
    cumulative storage of the same weights), so the existing cdf2d
    sampler/pdf path applies unchanged."""
    h, w = sat.shape
    min_eps = 1e-5
    # per-cell mass via the 4-corner difference, then row cumsums
    cell = np.diff(np.diff(np.pad(sat, ((1, 0), (1, 0))), axis=0), axis=1)
    cell = np.maximum(cell, 0.0)
    cond = np.cumsum(cell, axis=1)
    row_sum = cond[:, -1].copy()
    good = row_sum > min_eps / max(h * w, 1)
    cond = np.where(good[:, None],
                    cond / np.maximum(row_sum[:, None], 1e-20),
                    (np.arange(w, dtype=np.float32)[None, :] / (w - 1)))
    cond[:, -1] = 1.0
    marg = np.cumsum(row_sum)
    if marg[-1] > min_eps:
        marg = marg / marg[-1]
    else:
        marg = np.arange(h, dtype=np.float32) / (h - 1)
    marg[-1] = 1.0
    return marg.astype(np.float32), cond.astype(np.float32)



def _cdf1d_sample(data, u):
    """data: inclusive cumsum [x1..1] with a virtual leading 0.
    Returns (off, rem, pos, pdf_cont)."""
    size = data.shape[-1]
    off = torch.clamp(torch.searchsorted(data, u, right=True), 0, size - 1)
    lo = torch.where(off == 0, torch.zeros_like(u),
                     data[torch.clamp_min(off - 1, 0)])
    pdf = data[off] - lo
    rem = safe_div(u - lo, pdf)
    pos = clip((off.to(torch.float32) + rem) / size, 0.0, 1.0)
    return off, rem, pos, pdf * size


def _row_lookup(conditional, rows, off):
    """(cdf value at `off`, cdf value before it, 0 at the row's start) of
    each lane's row `rows` of `conditional`, read from the flat table."""
    size = conditional.shape[-1]
    flat = conditional.reshape(-1)
    base = rows * size
    hi = flat[base + off]
    lo = torch.where(off == 0, torch.zeros_like(hi),
                     flat[base + torch.clamp_min(off - 1, 0)])
    return hi, lo


def _cdf1d_sample_rows(conditional, rows, u):
    """Per-lane row-conditional sampling in row `rows` of `conditional`
    (H, W).  The JAX package counts the entries of the gathered row that are
    <= u; the rows are non-decreasing, so `searchsorted(right=True)` over
    them gives the same offset."""
    size = conditional.shape[-1]
    off = torch.searchsorted(conditional[rows], u[:, None], right=True)[:, 0]
    off = torch.clamp(off, 0, size - 1)
    hi, lo = _row_lookup(conditional, rows, off)
    pdf = hi - lo
    rem = safe_div(u - lo, pdf)
    pos = clip((off.to(torch.float32) + rem) / size, 0.0, 1.0)
    return off, rem, pos, pdf * size


def _cdf1d_pdf(data, x):
    size = data.shape[-1]
    off = torch.clamp(to_int32(x * size), 0, size - 1).long()
    lo = torch.where(off == 0, torch.zeros_like(x),
                     data[torch.clamp_min(off - 1, 0)])
    return off, (data[off] - lo) * size


def cdf2d_sample(marginal, conditional, u, v):
    """(x ~ conditional, y ~ marginal).  Returns (pos (N, 2), pdf)."""
    yoff, _, ypos, ypdf = _cdf1d_sample(marginal, v)
    _, _, xpos, xpdf = _cdf1d_sample_rows(conditional, yoff, u)
    return torch.stack([xpos, ypos], dim=-1), ypdf * xpdf


def cdf2d_pdf(marginal, conditional, pos):
    yoff, ypdf = _cdf1d_pdf(marginal, pos[..., 1])
    size = conditional.shape[-1]
    xoff = torch.clamp(to_int32(pos[..., 0] * size), 0, size - 1).long()
    hi, lo = _row_lookup(conditional, yoff, xoff)
    return ypdf * ((hi - lo) * size)


# ---------------------------------------------------------------- mapping

def switch_env_up(v):
    """(x, y, z) <-> (x, z, y)."""
    return torch.stack([v[..., 0], v[..., 2], v[..., 1]], dim=-1)


def map_env_uv(d):
    """Z-up direction -> uv, with (0.5, 0.5) the Y-up direction."""
    theta = torch.arccos(clip(d[..., 2], -1.0, 1.0))
    phi = torch.atan2(d[..., 1], d[..., 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * PI, phi)
    v = theta / PI
    u = phi / (2.0 * PI)
    return torch.stack([torch.remainder(u + 0.25, 1.0), 1.0 - v], dim=-1)


def uv_to_dir(pos):
    """Inverse of the sampling map: a Z-up direction."""
    theta = (1.0 - pos[..., 1]) * PI
    phi = (pos[..., 0] - 0.25) * 2.0 * PI
    s = torch.sin(theta)
    return torch.stack([s * torch.cos(phi), s * torch.sin(phi),
                        torch.cos(theta)], dim=-1)


def sin_theta_of(d):
    return torch.sqrt(torch.clamp_min(1.0 - d[..., 2] * d[..., 2], 0.0))
