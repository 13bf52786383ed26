"""Tensor-tree measured BSDF, batched.  Counterpart of
ignis_tpu/bsdf/tensortree_bsdf.py: the Klems BSDF's up-vector frame and
split cosine sampler, evaluation by the flattened tree climb."""

from __future__ import annotations

import torch

from ignis_tpu_torch.bsdf.klems_bsdf import (
    flip_z, frame_pdf, split_sample, tt_frame,
)
from ignis_tpu_torch.core.vec import FLT_EPS, device_scalar, safe_div, to_local
from ignis_tpu_torch.measured.tensortree import tt_eval_component


def _make_positive(v):
    return torch.where(torch.signbit(v[..., 2])[..., None], flip_z(v), v)


def _tree_eval(tables, prefix, info, wi, wo):
    bad = (torch.abs(wi[..., 2]) <= FLT_EPS) | (torch.abs(wo[..., 2]) <= FLT_EPS)
    in_front = wi[..., 2] >= 0
    out_front = wo[..., 2] >= 0
    pos = _make_positive

    def neg(v):
        return -_make_positive(v)

    totals = info["totals"]
    zero = torch.zeros(wi.shape[:-1], dtype=torch.float32, device=wi.device)
    f_rr = (tt_eval_component(tables, prefix, "front_reflection", 0, info,
                              pos(wo), pos(wi)) if totals[0] > 0 else zero)
    f_tt = (tt_eval_component(tables, prefix, "front_transmission", 1, info,
                              pos(wi), neg(wo)) if totals[1] > 0 else zero)
    b_tt = (tt_eval_component(tables, prefix, "back_transmission", 3, info,
                              pos(wo), neg(wi)) if totals[3] > 0 else zero)
    b_rr = (tt_eval_component(tables, prefix, "back_reflection", 2, info,
                              neg(wo), neg(wi)) if totals[2] > 0 else zero)
    factor = torch.where(in_front & out_front, f_rr,
                         torch.where(in_front & ~out_front, f_tt,
                                     torch.where(~in_front & out_front, b_tt,
                                                 b_rr)))
    return torch.where(bad, device_scalar(0.0, wi.device),
                       factor * torch.abs(wi[..., 2]))


def tensortree_eval(tables, prefix, info, base_color, up, surf, in_dir,
                    out_dir):
    r, u, n = tt_frame(surf, up)
    wo = to_local(out_dir, r, u, n)
    wi = to_local(in_dir, r, u, n)
    return base_color * _tree_eval(tables, prefix, info, wi, wo)[..., None]


def tensortree_pdf(tables, prefix, info, up, surf, in_dir, out_dir):
    return frame_pdf(info, surf, up, in_dir, out_dir)


def tensortree_sample(tables, prefix, info, base_color, up, surf, u0, u1, u2,
                      out_dir):
    (r, u, n), wo, wi, pdf, e_pdf = split_sample(info, surf, up, u0, u1, u2,
                                                 out_dir)
    ev = base_color * safe_div(_tree_eval(tables, prefix, info, wi, wo),
                               e_pdf)[..., None]
    in_dir = r * wi[..., 0:1] + u * wi[..., 1:2] + n * wi[..., 2:3]
    valid = (pdf > FLT_EPS) & (e_pdf > FLT_EPS)
    return in_dir, e_pdf, ev, torch.ones_like(e_pdf), valid
