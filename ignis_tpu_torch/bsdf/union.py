"""Batched BSDF union: one switched evaluation over material types.

Counterpart of ignis_tpu/bsdf/union.py for the `diffuse`, `dielectric` (solid
and thin) and `conductor` (incl. `mirror`, which compiles to a conductor with
eta = 0, k = 1) types.  The small union of BSDF types present in the scene is
evaluated for all lanes with masked selects; only the types that appear in the
compiled scene (static `bsdf_types` list) are computed.

Conventions:
  * eval(in_dir, out_dir) returns reflectance WITH the cosine term applied.
  * sample returns (in_dir, pdf, weight, eta) with weight = eval/pdf, cosine
    applied.
  * out_dir points AWAY from the surface (toward the previous vertex);
    in_dir is the sampled/next direction.
"""

from __future__ import annotations

import torch

from ignis_tpu_torch.core import rng
from ignis_tpu_torch.core.dgather import gather_rows
from ignis_tpu_torch.core.vec import (
    FLT_EPS, INV_PI, absolute_cos, dot, mulf, normalize, positive_cos,
    reflect, refract, safe_div, to_world,
)
from ignis_tpu_torch.core.warp import (
    cosine_hemisphere_pdf, sample_cosine_hemisphere,
)
from ignis_tpu_torch.scene.compile import (
    BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_DIFFUSE, BSDF_DJMEASURED,
    BSDF_KLEMS, BSDF_PASSTHROUGH, BSDF_PHONG, BSDF_PLASTIC, BSDF_PRINCIPLED,
    BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIELECTRIC, BSDF_ROUGH_PLASTIC,
    BSDF_TENSORTREE,
)

# random draws consumed by each type's sample(), over the WHOLE union of the
# scene's types: every lane pre-draws the maximum and advances its counter by
# its own type's count, so the counts of unported types are kept too.
_SAMPLE_DRAWS = {
    BSDF_DIFFUSE: 2,
    BSDF_DIELECTRIC: 1,   # fresnel branch pick
    BSDF_CONDUCTOR: 0,
    BSDF_PHONG: 2,
    BSDF_PASSTHROUGH: 0,
    BSDF_ROUGH_CONDUCTOR: 2,
    BSDF_ROUGH_DIELECTRIC: 3,
    BSDF_PLASTIC: 3,
    BSDF_ROUGH_PLASTIC: 3,
    BSDF_PRINCIPLED: 3,
    BSDF_KLEMS: 3,
    BSDF_TENSORTREE: 3,
    BSDF_DJMEASURED: 2,
}

_SPECULAR = {BSDF_DIELECTRIC, BSDF_CONDUCTOR, BSDF_PASSTHROUGH}
_PORTED = {BSDF_DIFFUSE, BSDF_DIELECTRIC, BSDF_CONDUCTOR}


def _check_ported(bsdf_types):
    for t in set(bsdf_types):
        if t not in _PORTED:
            raise NotImplementedError(
                f"BSDF type id {t} is not ported to ignis_tpu_torch yet")


def sample_draw_counts(bsdf_types):
    return [_SAMPLE_DRAWS.get(t, 2) for t in bsdf_types]


def bsdf_specular_mask(bsdf_types, mat_type):
    """Per-lane is_specular."""
    mask = torch.zeros_like(mat_type, dtype=torch.bool)
    for t in set(bsdf_types):
        if t in _SPECULAR:
            mask = mask | (mat_type == t)
    return mask


def material_params(scene, tables, surf):
    """Per-lane material colors (N, 4, 3) and scalars (N, 16)."""
    if scene.textures:
        raise NotImplementedError(
            "textured material slots are not ported to ignis_tpu_torch yet")
    mat_id = surf["mat_id"]
    return (gather_rows(tables["mat_colors"], mat_id),
            gather_rows(tables["mat_scalars"], mat_id))


# ------------------------------------------------------------------ diffuse

def _diffuse_eval(colors, scalars, surf, in_dir, out_dir):
    # Reflect-only on either face: zero when in_dir is below the GEOMETRIC
    # horizon (falls back to the shading normal for synthetic surfs), as the
    # reference package does.
    kd = colors[:, 0]
    alpha = scalars[:, 0]
    n = surf["n"]
    ngc = surf.get("ng", n)
    hemi = (torch.sum(in_dir * ngc, dim=-1) > 0.0)[..., None]
    lam = mulf(kd, absolute_cos(in_dir, n) * INV_PI)
    # Oren-Nayar when alpha > 0
    a2 = alpha * alpha
    p1 = absolute_cos(in_dir, n)
    p2 = absolute_cos(out_dir, n)
    s = -p1 * p2 + positive_cos(out_dir, in_dir)
    t = torch.where(s <= FLT_EPS, torch.ones_like(s),
                    torch.clamp_min(torch.maximum(p1, p2), FLT_EPS))
    A = 1.0 - 0.5 * a2 / (a2 + 0.33)
    B = 0.45 * a2 / (a2 + 0.09)
    C = 0.17 * a2 / (a2 + 0.13)
    on = (mulf(kd, (A + B * s / t) * INV_PI)
          + kd * kd * (C * INV_PI)[..., None]) * p1[..., None]
    val = torch.where((alpha <= FLT_EPS)[..., None], lam, on)
    return torch.where(hemi, val, torch.zeros_like(val))


def _diffuse_pdf(colors, scalars, surf, in_dir, out_dir):
    return cosine_hemisphere_pdf(positive_cos(in_dir, surf["n"]))


def _diffuse_sample(colors, scalars, surf, u1, u2, out_dir):
    local, pdf = sample_cosine_hemisphere(u1, u2)
    gdir = to_world(local, surf["t"], surf["b"], surf["n"])
    kd = colors[:, 0]
    alpha = scalars[:, 0]
    # lambert fast path: weight = kd exactly (cos/pi/pdf == 1)
    ev = _diffuse_eval(colors, scalars, {"n": surf["n"]}, gdir, out_dir)
    w_on = ev * safe_div(1.0, pdf)[..., None]
    weight = torch.where((alpha <= FLT_EPS)[..., None], kd, w_on)
    eta = torch.ones_like(pdf)
    valid = pdf > 0
    return gdir, pdf, weight, eta, valid


# ---------------------------------------------------------------- dielectric

def _fresnel(eta, cos_i):
    """Returns (cos_t signed, factor, total-internal-reflection mask)."""
    neg = cos_i < 0.0
    eta2 = torch.where(neg, 1.0 / eta, eta)
    cos2_t = 1.0 - (1.0 - cos_i * cos_i) * eta2 * eta2
    total = cos2_t <= 0.0
    cos_t = torch.sqrt(torch.clamp_min(cos2_t, 0.0))
    cos_t_s = torch.where(neg, -cos_t, cos_t)
    aci = torch.abs(cos_i)
    r_s = safe_div(eta2 * aci - cos_t, eta2 * aci + cos_t)
    r_p = safe_div(aci - eta2 * cos_t, aci + eta2 * cos_t)
    factor = torch.clamp((r_s * r_s + r_p * r_p) * 0.5, 0.0, 1.0)
    factor = torch.where(total, torch.ones_like(factor), factor)
    return cos_t_s, factor, total


def _fresnel_dielectric(eta, cos_i):
    """Unpolarized fresnel for |cos| input."""
    return _fresnel(eta, cos_i)[1]


def _dielectric_sample(colors, scalars, surf, u1, out_dir, adjoint=False):
    """Smooth dielectric; the thin flag in scalars[3] switches to the
    thin-interface variant."""
    ks = colors[:, 0]
    kt = colors[:, 1]
    n1 = scalars[:, 1]
    n2 = scalars[:, 2]
    thin = scalars[:, 3] > 0.5
    n = surf["n"]

    # --- solid variant
    k = torch.where(surf["is_entering"], n1 / n2, n2 / n1)
    cos_o = dot(out_dir, n)
    cos_t, factor, _total = _fresnel(k, cos_o)
    refr = u1 > factor
    t_dir = refract(out_dir, n, k, cos_o, cos_t)
    one = torch.ones_like(k)
    adj = torch.where(refr, k * k, one) if adjoint else one
    d_solid = torch.where(refr[..., None], t_dir, reflect(out_dir, n))
    c_solid = torch.where(refr[..., None], kt * adj[..., None], ks)
    eta_solid = torch.where(refr, k, one)

    # --- thin variant
    kthin = n1 / n2
    cos_o_a = absolute_cos(out_dir, n)
    f_d = _fresnel_dielectric(kthin, cos_o_a)
    F = f_d + (1.0 - f_d) * f_d / (f_d + 1.0)
    refr_t = u1 > F
    d_thin = torch.where(refr_t[..., None], -out_dir,
                         normalize(reflect(out_dir, n)))
    c_thin = torch.where(refr_t[..., None], kt, ks)

    in_dir = torch.where(thin[..., None], d_thin, d_solid)
    weight = torch.where(thin[..., None], c_thin, c_solid)
    eta = torch.where(thin, one, eta_solid)
    pdf = torch.ones_like(eta)
    valid = torch.ones_like(eta, dtype=torch.bool)
    return in_dir, pdf, weight, eta, valid


# ---------------------------------------------------------------- conductor

def _conductor_factor(n, k, cos_i):
    f = n * n + k * k
    d1 = f * cos_i * cos_i
    d2 = 2.0 * n * cos_i
    r_s = safe_div(d1 - d2, d1 + d2)
    r_p = safe_div(f - d2 + cos_i * cos_i, f + d2 + cos_i * cos_i)
    return torch.clamp((r_s * r_s + r_p * r_p) * 0.5, 0.0, 1.0)


def _conductor_sample(colors, scalars, surf, out_dir):
    ks = colors[:, 0]
    eta = colors[:, 1]
    kap = colors[:, 2]
    n = surf["n"]
    cos_i = dot(out_dir, n)
    f = torch.stack([_conductor_factor(eta[:, c], kap[:, c], cos_i)
                     for c in range(3)], dim=-1)
    weight = ks * f
    in_dir = reflect(out_dir, n)
    pdf = torch.ones_like(cos_i)
    return (in_dir, pdf, weight, torch.ones_like(pdf),
            torch.ones_like(pdf, dtype=torch.bool))


# ------------------------------------------------------------------- union

def _params(tables, surf):
    if "colors" in surf:
        return surf["colors"], surf["scalars"]
    mat_id = surf["mat_id"]
    return (gather_rows(tables["mat_colors"], mat_id),
            gather_rows(tables["mat_scalars"], mat_id))


def bsdf_eval(scene, tables, mat_type, surf, in_dir, out_dir):
    _check_ported(scene.bsdf_types)
    colors, scalars = _params(tables, surf)
    out = torch.zeros_like(in_dir)
    if BSDF_DIFFUSE in scene.bsdf_types:
        v = _diffuse_eval(colors, scalars, surf, in_dir, out_dir)
        out = torch.where((mat_type == BSDF_DIFFUSE)[..., None], v, out)
    return out  # specular types eval to black


def bsdf_pdf(scene, tables, mat_type, surf, in_dir, out_dir):
    _check_ported(scene.bsdf_types)
    colors, scalars = _params(tables, surf)
    out = torch.zeros(mat_type.shape, dtype=torch.float32,
                      device=mat_type.device)
    if BSDF_DIFFUSE in scene.bsdf_types:
        v = _diffuse_pdf(colors, scalars, surf, in_dir, out_dir)
        out = torch.where(mat_type == BSDF_DIFFUSE, v, out)
    return out


def bsdf_sample(scene, tables, mat_type, surf, seed, counter, out_dir,
                active=None, adjoint=False):
    """Sample the union; advances counters by each lane's type draw count.

    Returns (in_dir, pdf, weight, eta, valid, new_counter).
    """
    bsdf_types = scene.bsdf_types
    _check_ported(bsdf_types)
    if active is None:
        active = torch.ones_like(mat_type, dtype=torch.bool)
    colors, scalars = _params(tables, surf)
    dev = out_dir.device
    shape = mat_type.shape

    # Pre-draw the max number of uniforms from each lane's counter base;
    # lanes advance only by their own type's draw count.
    max_draws = max([_SAMPLE_DRAWS.get(t, 2) for t in set(bsdf_types)] + [0])
    us = []
    c = counter
    for _ in range(max_draws):
        u, c = rng.next_f32(seed, c)
        us.append(u)
    while len(us) < 3:
        us.append(torch.zeros(shape, dtype=torch.float32, device=dev))

    in_dir = torch.zeros_like(out_dir)
    pdf = torch.zeros(shape, dtype=torch.float32, device=dev)
    weight = torch.zeros_like(out_dir)
    eta = torch.ones(shape, dtype=torch.float32, device=dev)
    valid = torch.zeros(shape, dtype=torch.bool, device=dev)
    draws = torch.zeros(shape, dtype=torch.int64, device=dev)

    for t in sorted(set(bsdf_types)):
        if t == BSDF_DIFFUSE:
            r = _diffuse_sample(colors, scalars, surf, us[0], us[1], out_dir)
        elif t == BSDF_DIELECTRIC:
            r = _dielectric_sample(colors, scalars, surf, us[0], out_dir,
                                   adjoint)
        else:  # BSDF_CONDUCTOR
            r = _conductor_sample(colors, scalars, surf, out_dir)
        m = mat_type == t
        mc = m[..., None]
        in_dir = torch.where(mc, r[0], in_dir)
        pdf = torch.where(m, r[1], pdf)
        weight = torch.where(mc, r[2], weight)
        eta = torch.where(m, r[3], eta)
        valid = torch.where(m, r[4], valid)
        draws = torch.where(m, torch.full_like(draws, _SAMPLE_DRAWS[t]),
                            draws)

    new_counter = torch.where(active, (counter + draws) & rng.M32, counter)
    valid = valid & active
    return in_dir, pdf, weight, eta, valid, new_counter
