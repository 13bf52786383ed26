"""Participating media union: batched per-lane medium functions over the
scene's static medium list.

Counterpart of ignis_tpu/medium/union.py.  Homogeneous media use closed
forms; medium id -1 is vacuum.  Coefficients may be PExpr expressions
evaluated at the lane's shading context.  Heterogeneous media (`hetero_voxel`,
`hetero_density`) are sampled by delta tracking against the medium's global
majorant; their transmittance is a 32-step midpoint quadrature, or, for
`method: delta_tracking` with an RNG stream, a 32-flight ratio tracker on a
salted substream of the lane's seed.

Phase functions: Henyey-Greenstein and isotropic.  As in the JAX package (and
the reference renderer it follows), the anisotropic HG sampler returns the
direction in the canonical frame, not rotated about `out_dir`.

Every where-substitute that keeps a gradient finite in the JAX package is
kept: a masked lane's zero cotangent must not meet an infinite slope.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ignis_tpu_torch.core import rng
from ignis_tpu_torch.core.vec import (
    FLT_EPS, absolute_cos, clip, device_scalar, length, maximum, minimum,
    safe_div, safe_sqrt, vec3,
)
from ignis_tpu_torch.core.warp import sample_uniform_sphere
from ignis_tpu_torch.medium.volume import (
    apply_density_shader, grid_lookup, inside_unit, to_normalized_point,
)
from ignis_tpu_torch.utils.stats import MEDIUM_COUNTS, count_medium

# the sink slot of the ratio tracker's flights (`utils.stats.count_medium`)
_FLIGHTS = MEDIUM_COUNTS.index("RatioFlights")

_EPS = float(np.float32(1e-3))


def take_lanes(x, idx):
    """x[lanes, idx] for (n, 3) x and (n,) indices."""
    return torch.gather(x, 1, idx[:, None])[:, 0]


def medium_coefficients(scene, tables, medium_id, ctx):
    """Per-lane (sigma_a, sigma_s, g) for the lane's medium id (-1 -> 0).
    `ctx` is the PExpr lane context of expression-valued coefficients."""
    n = medium_id.shape[0]
    dev = medium_id.device
    sa = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    ss = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    g = torch.zeros((n,), dtype=torch.float32, device=dev)
    for mi, med in enumerate(scene.media):
        if med["type"] == "vacuum":
            continue
        m = medium_id == mi
        data = tables["medium_data"][mi]
        msa = torch.broadcast_to(data[0:3], (n, 3))
        mss = torch.broadcast_to(data[3:6], (n, 3))
        if med.get("sigma_a_expr") or med.get("sigma_s_expr"):
            from ignis_tpu_torch.texture.pexpr import eval_pexpr_color
            if med.get("sigma_a_expr"):
                msa = eval_pexpr_color(scene, tables, med["sigma_a_expr"],
                                       ctx["uv"], ctx)
            if med.get("sigma_s_expr"):
                mss = eval_pexpr_color(scene, tables, med["sigma_s_expr"],
                                       ctx["uv"], ctx)
        sa = torch.where(m[..., None], msa, sa)
        ss = torch.where(m[..., None], mss, ss)
        g = torch.where(m, data[6], g)
    return sa, ss, g


def _hetero_media(scene):
    return [(mi, m) for mi, m in enumerate(scene.media)
            if m["type"].startswith("hetero")]


def _hetero_props_at(scene, tables, mi, med, world_p):
    """(sigma_s, sigma_a, emission) of heterogeneous medium `mi` at world
    points (n, 3), through the medium's shader."""
    lpos = torch.clamp(to_normalized_point(tables, med["ref_entity"],
                                           world_p), 1e-5, 1.0 - 1e-5)
    interp = med.get("interpolate", False)
    row = tables["medium_shader"][mi]
    if med["type"] == "hetero_voxel":
        # the simple volume shader with scalar_density x scalar_* folded in
        ss = grid_lookup(tables[f"vol{mi}_sigma_s"], lpos, interp) \
            * (row[2:5] * row[0] * row[18])
        sa = grid_lookup(tables[f"vol{mi}_sigma_a"], lpos, interp) \
            * (row[5:8] * row[0] * row[17])
        em = grid_lookup(tables[f"vol{mi}_emission"], lpos, interp) \
            * (row[8:11] * row[0] * row[1])
        return ss, sa, em
    dens = grid_lookup(tables[f"vol{mi}_density"][..., None], lpos,
                       interp)[..., 0]
    temp = None
    if med.get("has_temperature"):
        temp = grid_lookup(tables[f"vol{mi}_temperature"][..., None], lpos,
                           interp)[..., 0]
    return apply_density_shader(med.get("shader", "monochromatic"), row,
                                dens, temp)


# quadrature resolution of the deterministic heterogeneous transmittance
_TR_STEPS = 32


def _hetero_transmittance(scene, tables, mi, med, p_start, p_end):
    """exp(-integral of sigma_t) along [p_start, p_end] by the midpoint
    rule, the sample points outside the volume masked."""
    seg = p_end - p_start
    dist = length(seg)
    ts = ((torch.arange(_TR_STEPS, dtype=torch.float32, device=seg.device)
           + 0.5) / _TR_STEPS)
    # (steps, n, 3) sample points
    pts = p_start[None] + seg[None] * ts[:, None, None]
    flat = pts.reshape(-1, 3)
    ss, sa, _ = _hetero_props_at(scene, tables, mi, med, flat)
    ext = (ss + sa).reshape(_TR_STEPS, -1, 3)
    lref = to_normalized_point(tables, med["ref_entity"], flat)
    inside = inside_unit(lref).reshape(_TR_STEPS, -1)
    ext = torch.where(inside[..., None], ext, device_scalar(0.0, ext.device))
    tau = ext.sum(dim=0) * (dist / _TR_STEPS)[..., None]
    return torch.exp(-tau)


# flights of the stochastic ratio tracker
_RT_FLIGHTS = 32
# salt of its independent RNG substream (seed ^ salt stays in [0, 2^32))
_RT_SALT = 0x9E3779B9


def _hetero_ratio_transmittance(scene, tables, mi, med, p_start, p_end,
                                seed, counter, lanes=None):
    """Ratio tracking: Tr ~ prod_k (1 - sigma_t(x_k) / mu) over majorant
    free flights, `_RT_FLIGHTS` of them, unrolled.  Draws from the salted
    seed; the lane's own counter does not move.  Where `lanes` (a mask) is
    given, the flights of those lanes that landed inside the segment are
    counted (`utils.stats.count_medium`, `RatioFlights`)."""
    seg = p_end - p_start
    dist = length(seg)
    dirn = seg * safe_div(1.0, dist)[..., None]
    maj = tables["medium_majorant"][mi]
    mu = maximum(torch.amax(maj), 1e-6)
    t = torch.zeros_like(dist)
    tr = torch.ones(p_start.shape[:-1] + (3,), dtype=torch.float32,
                    device=p_start.device)
    salted = seed ^ _RT_SALT
    c = counter
    taken = []
    for _k in range(_RT_FLIGHTS):
        u, c = rng.next_f32(salted, c)
        t = t - torch.log(maximum(1.0 - u * 0.99999, 1e-30)) / mu
        on = t < dist
        taken.append(on)
        pos = p_start + dirn * t[..., None]
        ss, sa, _ = _hetero_props_at(scene, tables, mi, med, pos)
        lref = to_normalized_point(tables, med["ref_entity"], pos)
        ext = torch.where(inside_unit(lref)[..., None], ss + sa,
                          device_scalar(0.0, pos.device))
        f = clip(1.0 - ext / mu, 0.0, 1.0)
        tr = torch.where(on[..., None], tr * f, tr)
    if lanes is not None:
        count_medium(_FLIGHTS,
                     lambda: (torch.stack(taken) & lanes).sum()[None])
    return tr


def medium_eval(scene, tables, medium_id, sigma_a, sigma_s, p_start, p_end,
                seed=None, counter=None):
    """Transmittance between two points: the closed form for homogeneous
    media; for heterogeneous ones the ratio tracker (`method:
    delta_tracking` with an RNG stream) or the quadrature (the default, and
    the differentiable path).  The ratio tracker's flights that landed
    inside their segment, on the lanes in its medium, are counted
    (`utils.stats.count_medium`, `RatioFlights`)."""
    sigma_t = sigma_a + sigma_s
    dist = length(p_end - p_start)
    one = device_scalar(1.0, dist.device)
    tr = torch.exp(-sigma_t * dist[..., None])
    tr = torch.where((medium_id >= 0)[..., None], tr, one)
    for mi, med in _hetero_media(scene):
        if (med.get("method") == "delta_tracking" and seed is not None
                and counter is not None):
            h = _hetero_ratio_transmittance(scene, tables, mi, med,
                                            p_start, p_end, seed, counter,
                                            lanes=medium_id == mi)
        else:
            h = _hetero_transmittance(scene, tables, mi, med, p_start,
                                      p_end)
        tr = torch.where((medium_id == mi)[..., None], h, tr)
    return tr


def medium_eval_inf(scene, tables, medium_id, sigma_a, sigma_s, p_start,
                    direction):
    """Transmittance to infinity: white iff the extinction is ~0; black in a
    heterogeneous medium (bounded by its entity)."""
    dev = medium_id.device
    zero, one = device_scalar(0.0, dev), device_scalar(1.0, dev)
    sigma_t = sigma_a + sigma_s
    black_t = torch.all(sigma_t <= 1e-4, dim=-1)
    val = torch.where(black_t[..., None], one, zero).expand(-1, 3)
    for mi, _med in _hetero_media(scene):
        val = torch.where((medium_id == mi)[..., None], zero, val)
    return torch.where((medium_id >= 0)[..., None], val, one)


def medium_sample(scene, tables, medium_id, sigma_a, sigma_s, seed, counter,
                  p_start, p_end, active):
    """Collision-distance sampling: closed-form free flight in homogeneous
    media, one delta-tracking flight against the global majorant in
    heterogeneous ones (the fictional collision continues as the volpath
    technique's null event).

    Returns dict(valid, pos, pdf, color, sigma_a, sigma_s, sigma_n,
    emission) and the counter, advanced by one on the lanes that draw:
    scattering homogeneous media and in-bounds heterogeneous media."""
    n = medium_id.shape[0]
    dev = medium_id.device
    zero, one = device_scalar(0.0, dev), device_scalar(1.0, dev)
    sigma_t = sigma_a + sigma_s
    has_scatter = torch.any(sigma_s > 1e-4, dim=-1) & (medium_id >= 0)
    # the first index on ties, as argmin over RGB in the JAX package
    sigma_ind = torch.argmin(sigma_t, dim=-1)
    sigma_t_p = take_lanes(sigma_t, sigma_ind)

    u, counter_next = rng.next_f32(seed, counter)
    one_m_u = 1.0 - u * 0.99999

    dir_u = p_end - p_start
    dist = length(dir_u)
    # where-substitute (not clamp) the zero-extinction lanes: d(L/sigma) /
    # d sigma would overflow and reach the gradient as 0 * inf
    sigma_t_s = torch.where(sigma_t_p > 1e-6, sigma_t_p, one)
    ndist = minimum(dist, -torch.log(maximum(one_m_u, 1e-30)) / sigma_t_s)
    valid = has_scatter & active & (torch.abs(dist - ndist) > _EPS)
    d = dir_u * safe_div(1.0, dist)[..., None]
    pos = p_start + d * ndist[..., None]
    tr = torch.exp(-sigma_t * ndist[..., None])
    pdf = take_lanes(tr, sigma_ind) * sigma_t_p
    big = pdf > 1e-20
    inv_pdf_s = torch.where(big, 1.0 / torch.where(big, pdf, one), zero)
    color = tr * inv_pdf_s[..., None]

    out_sa, out_ss = sigma_a, sigma_s
    out_sn = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    out_em = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    consumed = active & has_scatter

    for mi, med in _hetero_media(scene):
        m = medium_id == mi
        maj = tables["medium_majorant"][mi]
        mu_t_p = torch.amax(maj)
        lstart = to_normalized_point(tables, med["ref_entity"], p_start)
        draws = m & active & inside_unit(lstart)
        mu_t_s = torch.where(mu_t_p > 1e-6, mu_t_p, one)
        sampled = -torch.log(maximum(one_m_u, 1e-30)) / mu_t_s
        v_m = draws & (sampled < dist) & (mu_t_p > FLT_EPS)
        pos_m = p_start + d * sampled[..., None]
        ss_m, sa_m, em_m = _hetero_props_at(scene, tables, mi, med, pos_m)
        sn_m = maximum(maj - (ss_m + sa_m), 0.0)
        pdf_m = one_m_u * mu_t_p
        big_m = pdf_m > 1e-20
        inv_pm = torch.where(big_m, 1.0 / torch.where(big_m, pdf_m, one),
                             zero)
        color_m = torch.exp(-maj * sampled[..., None]) * inv_pm[..., None]

        mc = m[..., None]
        valid = torch.where(m, v_m, valid)
        pos = torch.where(mc, pos_m, pos)
        pdf = torch.where(m, pdf_m, pdf)
        color = torch.where(mc, color_m, color)
        out_sa = torch.where(mc, sa_m, out_sa)
        out_ss = torch.where(mc, ss_m, out_ss)
        out_sn = torch.where(mc, sn_m, out_sn)
        out_em = torch.where(mc, em_m, out_em)
        consumed = torch.where(m, draws, consumed)

    counter = torch.where(consumed, counter_next, counter)
    return dict(valid=valid, pos=pos, pdf=pdf, color=color,
                sigma_a=out_sa, sigma_s=out_ss, sigma_n=out_sn,
                emission=out_em), counter


def medium_events(ms, seed, counter):
    """The event at each valid sample of `medium_sample` (`ms`): one draw
    picks absorption, scattering or a null collision with the
    probabilities of the sample's homogenised coefficients (sigma_n is the
    fictional coefficient of a heterogeneous medium).  Returns dict(absorb,
    scatter, null, p_a, p_s, p_f) and the counter, advanced on the valid
    lanes."""
    zero = device_scalar(0.0, counter.device)
    ext_h = ms["sigma_a"] + ms["sigma_s"] + ms["sigma_n"]
    mu_ind = torch.argmax(ext_h, dim=-1)   # the first index on ties
    mu_t_p = maximum(take_lanes(ext_h, mu_ind), 1e-30)
    mu_a_p = take_lanes(ms["sigma_a"], mu_ind)
    mu_s_p = take_lanes(ms["sigma_s"], mu_ind)
    p_a = torch.where(mu_a_p <= FLT_EPS, zero, mu_a_p / mu_t_p)
    p_s = torch.where(mu_s_p <= FLT_EPS, zero, mu_s_p / mu_t_p)
    p_f = maximum(1.0 - p_a - p_s, 0.0)
    valid = ms["valid"]
    r_ev, counter_ev = rng.next_f32(seed, counter)
    counter = torch.where(valid, counter_ev, counter)
    absorb = valid & (r_ev < p_a)
    scatter = valid & ~absorb & (r_ev < p_a + p_s)
    return dict(absorb=absorb, scatter=scatter,
                null=valid & ~absorb & ~scatter,
                p_a=p_a, p_s=p_s, p_f=p_f), counter


def phase_sample(g, seed, counter, out_dir, active):
    """HG / isotropic sampling, 2 draws.  Returns (in_dir, pdf, weight,
    counter)."""
    dev = g.device
    u1, c = rng.next_f32(seed, counter)
    u2, c = rng.next_f32(seed, c)
    counter = torch.where(active, c, counter)

    iso_dir, iso_pdf = sample_uniform_sphere(u1, u2)

    # where-substitute g for the HG branch: a clamp would break negative g
    # and its slope would overflow on the isotropic lanes
    is_iso = torch.abs(g) <= 1e-3
    g_ = torch.where(is_iso, device_scalar(0.5, dev), g)
    den = 1.0 + g_ - 2.0 * g_ * u1
    den = torch.where(torch.abs(den) > 1e-6, den, device_scalar(1e-6, dev))
    sqr = (1.0 - g_ * g_) / den
    cos_t = -(1.0 + g_ * g_ - sqr * sqr) / (2.0 * g_)
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    phi = 2.0 * math.pi * u2
    hg_dir = vec3(sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)
    hg_pdf = _hg(g_, absolute_cos(hg_dir, out_dir))

    in_dir = torch.where(is_iso[..., None], iso_dir, hg_dir)
    pdf = torch.where(is_iso, iso_pdf, hg_pdf)
    return in_dir, pdf, torch.ones_like(pdf), counter


def phase_eval(g, in_dir, out_dir):
    iso = device_scalar(float(np.float32(1.0 / (4.0 * np.pi))), g.device)
    hg = _hg(g, absolute_cos(in_dir, out_dir))
    return torch.where(torch.abs(g) <= 1e-3, iso, hg)


def _hg(g, cos_theta):
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return safe_div(float(np.float32(1.0 / np.pi)) * (1.0 - g * g),
                    4.0 * denom * torch.sqrt(maximum(denom, 1e-20)))
