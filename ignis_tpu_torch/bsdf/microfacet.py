"""Batched microfacet distributions.

Counterpart of ignis_tpu/bsdf/microfacet.py: the VNDF-GGX distribution
(Heitz 2018 sampling) plus the GGX and Beckmann NDFs and the Smith / Walter
masking terms.  Directions are world-space; the local frame is passed as
(t, b, n).  The scene compiler sends alpha == 0 to the delta variants in
`union.py`, so these functions assume alpha > 1e-4.
"""

from __future__ import annotations

import torch

from ignis_tpu_torch.core.vec import (
    FLT_EPS, PI, absolute_cos, dot, ipow, maximum, normalize, safe_div,
    safe_sqrt, to_local, to_world, vec3,
)
from ignis_tpu_torch.core.warp import square_to_concentric_disk


def _frame(t, b, n, w):
    return dot(n, w), dot(t, w), dot(b, w)


def g1_smith(t, b, n, w, alpha_u, alpha_v):
    """Smith masking for GGX."""
    cos_z, cos_x, cos_y = _frame(t, b, n, w)
    kx = alpha_u * cos_x
    ky = alpha_v * cos_y
    a2 = kx * kx + ky * ky
    k2 = safe_div(a2, cos_z * cos_z)
    denom = 1.0 + torch.sqrt(1.0 + k2)
    out = torch.where(a2 <= FLT_EPS, torch.ones_like(denom), 2.0 / denom)
    return torch.where(torch.abs(cos_z) <= FLT_EPS, torch.zeros_like(out), out)


def g1_walter(t, b, n, w, alpha_u, alpha_v):
    """Walter's rational-fit masking for Beckmann."""
    cos_z, cos_x, cos_y = _frame(t, b, n, w)
    kx = alpha_u * cos_x
    ky = alpha_v * cos_y
    k2 = safe_div(kx * kx + ky * ky, cos_z * cos_z)
    a = safe_div(1.0, torch.sqrt(maximum(k2, 1e-30)))
    a2 = safe_div(1.0, maximum(k2, 1e-30))
    fit = (3.535 * a + 2.181 * a2) / (1.0 + 2.276 * a + 2.577 * a2)
    one = torch.ones_like(fit)
    out = torch.where(a >= 1.6, one, fit)
    out = torch.where(k2 <= FLT_EPS, one, out)
    return torch.where(torch.abs(cos_z) <= FLT_EPS, torch.zeros_like(out), out)


def ndf_ggx(t, b, n, m, alpha_u, alpha_v):
    cos_z, cos_x, cos_y = _frame(t, b, n, m)
    kx = cos_x / alpha_u
    ky = cos_y / alpha_v
    k = kx * kx + ky * ky + cos_z * cos_z
    return safe_div(1.0, PI * alpha_u * alpha_v * k * k)


def ndf_beckmann(t, b, n, m, alpha_u, alpha_v):
    cos_z, cos_x, cos_y = _frame(t, b, n, m)
    kx = cos_x / alpha_u
    ky = cos_y / alpha_v
    k2 = safe_div(kx * kx + ky * ky, cos_z * cos_z)
    return safe_div(torch.exp(-k2), PI * alpha_u * alpha_v * ipow(cos_z, 4))


def pdf_vndf_ggx(t, b, n, w, h, alpha_u, alpha_v):
    cos_z = absolute_cos(n, w)
    return safe_div(g1_smith(t, b, n, w, alpha_u, alpha_v)
                    * absolute_cos(w, h) * ndf_ggx(t, b, n, h, alpha_u,
                                                   alpha_v),
                    cos_z)


def _sample_vndf_ggx_11(u0, u1, cos_theta):
    px, py = square_to_concentric_disk(u0, u1)
    s = 0.5 * (1.0 + cos_theta)
    y = (1.0 - s) * safe_sqrt(1.0 - px * px) + s * py
    z = safe_sqrt(1.0 - y * y - px * px)
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    norm = safe_div(1.0, sin_theta * y + cos_theta * z)
    return (cos_theta * y - sin_theta * z) * norm, px * norm


def sample_vndf_ggx(u0, u1, t, b, n, w, alpha_u, alpha_v):
    """Heitz VNDF sampling; returns the half-vector in world space (2
    draws)."""
    vl = to_local(w, t, b, n)
    sl = normalize(vec3(alpha_u * vl[..., 0], alpha_v * vl[..., 1],
                        vl[..., 2]))
    sin2 = ipow(sl[..., 0], 2) + ipow(sl[..., 1], 2)
    inv_len = safe_div(1.0, torch.sqrt(maximum(sin2, 1e-30)))
    small = sin2 <= 1e-30
    cos_phi = torch.where(small, torch.ones_like(sin2), sl[..., 0] * inv_len)
    sin_phi = torch.where(small, torch.zeros_like(sin2), sl[..., 1] * inv_len)
    sx, sy = _sample_vndf_ggx_11(u0, u1, torch.abs(sl[..., 2]))
    s2x = (cos_phi * sx - sin_phi * sy) * alpha_u
    s2y = (sin_phi * sx + cos_phi * sy) * alpha_v
    bad = ~torch.isfinite(s2x)
    zero = torch.zeros_like(s2x)
    nh = normalize(vec3(torch.where(bad, zero, -s2x),
                        torch.where(bad, zero, -s2y),
                        torch.where(bad, torch.full_like(s2x, 1e-8),
                                    torch.ones_like(s2x))))
    return to_world(nh, t, b, n)


def halfway(a, bdir):
    return normalize(a + bdir)


def halfway_refractive(a, bdir, eta):
    return normalize(a + bdir * eta[..., None])


def reflective_jacobian(cos_h_o):
    """1 / (4 cos)."""
    return safe_div(1.0, 4.0 * cos_h_o)


def refractive_jacobian(eta, cos_h_i, cos_h_o):
    """eta^2 cos_h_i / (cos_h_i + eta cos_h_o)^2."""
    d = cos_h_i + eta * cos_h_o
    return safe_div(eta * eta * cos_h_i, d * d)
