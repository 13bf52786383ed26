"""Klems measured BSDF, batched.  Counterpart of
ignis_tpu/bsdf/klems_bsdf.py.

Per-material data lives in tables under the prefix `klems{mat_id}`; the
static totals and the `up` vector come from scene.klems_info[mat_id].

The frame is built from the un-flipped shading normal and the user `up`
vector (the Radiance convention), not the face-forwarded frame.  Sampling is
a cosine hemisphere with a reflection / transmission split by the
components' totals.
"""

from __future__ import annotations

import torch

from ignis_tpu_torch.core.vec import (
    FLT_EPS, cross, device_const, maximum, safe_div, safe_sqrt, to_local,
)
from ignis_tpu_torch.core.warp import (
    cosine_hemisphere_pdf, sample_cosine_hemisphere,
)
from ignis_tpu_torch.measured.klems import klems_eval_component

_FLIP = (1.0, 1.0, -1.0)


def _vec(v, like):
    return device_const(tuple(float(x) for x in v), torch.float32,
                        like.device)


def tt_frame(surf, up):
    """The (right, up, normal) frame of the un-flipped normal and `up`."""
    n = torch.where(surf["is_entering"][..., None], surf["n"], -surf["n"])
    upv = torch.broadcast_to(_vec(up, n), n.shape)
    right = cross(upv, n)
    l2 = torch.sum(right * right, dim=-1)
    degen = (l2 <= FLT_EPS)[..., None]
    ex, ey, ez = (_vec(e, n) for e in ((1, 0, 0), (0, 1, 0), (0, 0, 1)))
    right = torch.where(degen, ex, right * safe_div(
        1.0, safe_sqrt(maximum(l2, 1e-30)))[..., None])
    nup = cross(n, right)
    # degenerate: the identity frame
    nup = torch.where(degen, ey, nup)
    nn = torch.where(degen, ez, n)
    return right, nup, nn


def flip_z(v):
    return v * _vec(_FLIP, v)


def _local_eval(tables, prefix, info, base_color, wi, wo):
    in_front = wi[..., 2] >= 0
    out_front = wo[..., 2] >= 0
    totals = info["totals"]
    zero = torch.zeros(wi.shape[:-1], dtype=torch.float32, device=wi.device)
    f_rr = (klems_eval_component(tables, prefix, "front_reflection",
                                 wo * _vec((-1.0, -1.0, 1.0), wo), wi)
            if totals[0] > 0 else zero)
    f_tt = (klems_eval_component(tables, prefix, "front_transmission",
                                 wi, -wo)
            if totals[1] > 0 else zero)
    b_tt = (klems_eval_component(tables, prefix, "back_transmission",
                                 -wi, wo)
            if totals[3] > 0 else zero)
    b_rr = (klems_eval_component(tables, prefix, "back_reflection",
                                 -wo, flip_z(wi))
            if totals[2] > 0 else zero)
    factor = torch.where(in_front & out_front, f_rr,
                         torch.where(in_front & ~out_front, f_tt,
                                     torch.where(~in_front & out_front, b_tt,
                                                 b_rr)))
    return base_color * (factor * torch.abs(wi[..., 2]))[..., None]


def refl_prob(info, wo):
    """The reflection probability of the side `wo` lies on."""
    t = info["totals"]
    fp = t[0] / max(t[0] + t[3], 1e-20) if (t[0] + t[3]) > 0 else 0.0
    bp = t[2] / max(t[2] + t[1], 1e-20) if (t[2] + t[1]) > 0 else 0.0
    return torch.where(wo[..., 2] >= 0, _vec((fp,), wo)[0],
                       _vec((bp,), wo)[0])


def frame_pdf(info, surf, up, in_dir, out_dir):
    """The split cosine sampler's pdf (shared with the tensor tree)."""
    r, u, n = tt_frame(surf, up)
    wo = to_local(out_dir, r, u, n)
    wi = to_local(in_dir, r, u, n)
    rp = refl_prob(info, wo)
    same = (wo[..., 2] * wi[..., 2]) >= 0
    prob = torch.where(same, rp, 1.0 - rp)
    return prob * cosine_hemisphere_pdf(torch.abs(wi[..., 2]))


def split_sample(info, surf, up, u0, u1, u2, out_dir):
    """A cosine-hemisphere direction on the side the reflection / transmission
    split picks (3 draws).  Returns (frame, wo, wi, pdf, e_pdf)."""
    r, u, n = tt_frame(surf, up)
    wo = to_local(out_dir, r, u, n)
    local, pdf = sample_cosine_hemisphere(u0, u1)
    same = torch.where(torch.signbit(wo[..., 2])[..., None], flip_z(local),
                       local)
    rp = refl_prob(info, wo)
    is_refl = (rp > 0) & (u2 < rp)
    wi = torch.where(is_refl[..., None], same, -same)
    prob = torch.where(is_refl, rp, 1.0 - rp)
    return (r, u, n), wo, wi, pdf, prob * pdf


def klems_eval(tables, prefix, info, base_color, up, surf, in_dir, out_dir):
    r, u, n = tt_frame(surf, up)
    wo = to_local(out_dir, r, u, n)
    wi = to_local(in_dir, r, u, n)
    return _local_eval(tables, prefix, info, base_color, wi, wo)


def klems_pdf(tables, prefix, info, up, surf, in_dir, out_dir):
    return frame_pdf(info, surf, up, in_dir, out_dir)


def klems_sample(tables, prefix, info, base_color, up, surf, u0, u1, u2,
                 out_dir):
    """The split cosine-hemisphere sampler: 3 draws."""
    (r, u, n), wo, wi, pdf, e_pdf = split_sample(info, surf, up, u0, u1, u2,
                                                 out_dir)
    ev = _local_eval(tables, prefix, info, base_color, wi, wo)
    weight = ev * safe_div(1.0, e_pdf)[..., None]
    in_dir = r * wi[..., 0:1] + u * wi[..., 1:2] + n * wi[..., 2:3]
    valid = (pdf > FLT_EPS) & (e_pdf > FLT_EPS)
    return in_dir, e_pdf, weight, torch.ones_like(e_pdf), valid
