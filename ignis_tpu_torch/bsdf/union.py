"""Batched BSDF union: one switched evaluation over material types.

Counterpart of ignis_tpu/bsdf/union.py for the `diffuse`, `dielectric`
(smooth, thin and rough), `conductor` (smooth and rough, incl. `mirror`,
which compiles to a conductor with eta = 0, k = 1), `phong`, `plastic`
(smooth and rough), `principled` and `passthrough` types, and the measured
`klems`, `tensortree` and `djmeasured` BSDFs (one table set a material,
`scene.klems_info` / `tensortree_info` / `djmeasured_info`; djmeasured's
eval carries no cosine term, as in the JAX package).  The small union of
BSDF types present in the scene is evaluated for all lanes with masked
selects; only the types that appear in the compiled scene (static
`bsdf_types` list) are computed.  `lobe="b"` evaluates a two-lobe material's
second lobe (`bsdf_types_b`, `mat_colors_b`, `mat_scalars_b`).

Conventions:
  * eval(in_dir, out_dir) returns reflectance WITH the cosine term applied.
  * sample returns (in_dir, pdf, weight, eta) with weight = eval/pdf, cosine
    applied.
  * out_dir points AWAY from the surface (toward the previous vertex);
    in_dir is the sampled/next direction.

Everything is differentiable tensor code: no in-place writes, and every
division that an unselected branch may take by zero goes through `safe_div`
where the reference uses it, so that no `0 * inf` reaches a gradient.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ignis_tpu_torch.bsdf import klems_bsdf, tensortree_bsdf
from ignis_tpu_torch.bsdf import microfacet as mf
from ignis_tpu_torch.core import rng
from ignis_tpu_torch.core.dgather import gather_rows
from ignis_tpu_torch.core.vec import (
    FLT_EPS, INV_PI, absolute_cos, clip, device_scalar, dot, ipow, maximum,
    mulf, normalize, orthonormal_basis, positive_cos, reflect, refract,
    safe_div, safe_sqrt, to_world,
)
from ignis_tpu_torch.core.warp import (
    cosine_hemisphere_pdf, cosine_power_hemisphere_pdf,
    sample_cosine_hemisphere, sample_cosine_power_hemisphere,
)
from ignis_tpu_torch.measured import djmeasured
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
    """Per-lane material colors (N, 4, 3) and scalars (N, 16), the textured
    color slots resolved at the lanes' uv."""
    mat_id = surf["mat_id"]
    colors = gather_rows(tables["mat_colors"], mat_id)
    scalars = gather_rows(tables["mat_scalars"], mat_id)
    if scene.textures:
        colors = resolve_slots(scene, tables, colors, "mat_tex", mat_id,
                               surf["tex"])
    return colors, scalars


def resolve_slots(scene, tables, colors, key, mat_id, uv):
    """`colors` (N, S, 3) with each slot that some material textures (the
    compiled `scene.tables[key]`, (M, S)) resolved per lane."""
    from ignis_tpu_torch.texture.eval import resolve_color, texture_ids
    slots_np = np.asarray(scene.tables[key])
    if not (slots_np >= 0).any():
        return colors
    tex_ids = gather_rows(tables[key], mat_id)
    cols = list(colors.unbind(1))
    for slot in range(slots_np.shape[1]):
        ids = texture_ids(slots_np[:, slot])
        if ids:
            cols[slot] = resolve_color(scene, tables, cols[slot],
                                       tex_ids[:, slot], uv, ids=ids)
    return torch.stack(cols, dim=1)


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
                    maximum(maximum(p1, p2), FLT_EPS))
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
    cos_t = safe_sqrt(cos2_t)
    cos_t_s = torch.where(neg, -cos_t, cos_t)
    aci = torch.abs(cos_i)
    r_s = safe_div(eta2 * aci - cos_t, eta2 * aci + cos_t)
    r_p = safe_div(aci - eta2 * cos_t, aci + eta2 * cos_t)
    factor = clip((r_s * r_s + r_p * r_p) * 0.5, 0.0, 1.0)
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
    return clip((r_s * r_s + r_p * r_p) * 0.5, 0.0, 1.0)


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


# ------------------------------------------------------------------- phong

def _phong_eval(colors, scalars, surf, in_dir, out_dir):
    ks = colors[:, 0]
    ex = scalars[:, 0]
    n = surf["n"]
    cos_i = absolute_cos(in_dir, n)
    cos_r = positive_cos(reflect(out_dir, n), in_dir)
    f = (torch.pow(cos_r, ex) * (ex + 2.0)
         * (1.0 / (2.0 * 3.14159265358979)) * cos_i)
    return mulf(ks, f)


def _phong_pdf(colors, scalars, surf, in_dir, out_dir):
    ex = scalars[:, 0]
    cos_r = positive_cos(reflect(out_dir, surf["n"]), in_dir)
    return cosine_power_hemisphere_pdf(cos_r, ex)


def _phong_sample(colors, scalars, surf, u1, u2, out_dir):
    ex = scalars[:, 0]
    r = normalize(reflect(out_dir, surf["n"]))
    local, pdf = sample_cosine_power_hemisphere(ex, u1, u2)
    t, b = orthonormal_basis(r)
    gdir = to_world(local, t, b, r)
    ev = _phong_eval(colors, scalars, surf, gdir, out_dir)
    weight = ev * safe_div(1.0, pdf)[..., None]
    valid = (pdf > FLT_EPS) & (dot(gdir, surf["n"]) > 0)
    return gdir, pdf, weight, torch.ones_like(pdf), valid


# ------------------------------------------------------- rough microfacet

def _mf_params(scalars):
    return scalars[:, 0], scalars[:, 4]  # alpha_u, alpha_v


def _flip_to(v, ref):
    """v, or -v where it points away from `ref`."""
    return torch.where(torch.signbit(dot(v, ref))[..., None], -v, v)


def _rough_conductor_eval(colors, scalars, surf, in_dir, out_dir):
    """Rough conductor (kd = 0)."""
    ks, eta, kap = colors[:, 0], colors[:, 1], colors[:, 2]
    au, av = _mf_params(scalars)
    t, b, n = surf["t"], surf["b"], surf["n"]
    cos_o = absolute_cos(out_dir, n)
    cos_i = absolute_cos(in_dir, n)
    H = mf.halfway(in_dir, out_dir)
    D = mf.ndf_ggx(t, b, n, H, au, av)
    G = (mf.g1_smith(t, b, n, in_dir, au, av)
         * mf.g1_smith(t, b, n, out_dir, au, av))
    cos_h = absolute_cos(out_dir, H)
    F = torch.stack([_conductor_factor(eta[:, c], kap[:, c], cos_h)
                     for c in range(3)], dim=-1)
    val = ks * F * safe_div(D * G, 4.0 * cos_o)[..., None]
    bad = (cos_o <= FLT_EPS) | (cos_i <= FLT_EPS)
    return torch.where(bad[..., None], torch.zeros_like(val), val)


def _rough_conductor_pdf(colors, scalars, surf, in_dir, out_dir):
    au, av = _mf_params(scalars)
    t, b, n = surf["t"], surf["b"], surf["n"]
    H = mf.halfway(in_dir, out_dir)
    cos_h_o = absolute_cos(out_dir, H)
    return (mf.pdf_vndf_ggx(t, b, n, out_dir, H, au, av)
            * mf.reflective_jacobian(cos_h_o))


def _rough_conductor_sample(colors, scalars, surf, u0, u1, out_dir):
    au, av = _mf_params(scalars)
    t, b, n = surf["t"], surf["b"], surf["n"]
    cos_o = absolute_cos(out_dir, n)
    H = _flip_to(mf.sample_vndf_ggx(u0, u1, t, b, n, out_dir, au, av),
                 out_dir)
    in_dir = reflect(out_dir, H)
    cos_i = absolute_cos(in_dir, n)
    cos_h_o = absolute_cos(out_dir, H)
    spdf = mf.pdf_vndf_ggx(t, b, n, out_dir, H, au, av)
    pdf = spdf * safe_div(1.0, 4.0 * cos_h_o)
    color = _rough_conductor_eval(colors, scalars, surf, in_dir, out_dir)
    weight = color * safe_div(1.0, pdf)[..., None]
    valid = (cos_o > FLT_EPS) & (cos_i > FLT_EPS) & (pdf > FLT_EPS)
    return in_dir, pdf, weight, torch.ones_like(pdf), valid


def _rough_dielectric_terms(colors, scalars, surf, in_dir, out_dir):
    """Pieces shared by the rough dielectric's eval and pdf."""
    n1, n2 = scalars[:, 1], scalars[:, 2]
    au, av = _mf_params(scalars)
    t, b, n = surf["t"], surf["b"], surf["n"]
    eta = torch.where(surf["is_entering"], n1 / n2, n2 / n1)
    cos_i = dot(n, in_dir)
    cos_o = dot(n, out_dir)
    is_trans = torch.signbit(cos_i * cos_o)
    H = torch.where(is_trans[..., None],
                    mf.halfway_refractive(in_dir, out_dir, eta),
                    mf.halfway(in_dir, out_dir))
    cos_h_i = dot(H, in_dir)
    cos_h_o = dot(H, out_dir)
    G = (mf.g1_smith(t, b, n, in_dir, au, av)
         * mf.g1_smith(t, b, n, out_dir, au, av))
    bad = ((torch.abs(cos_i * cos_o) <= 1e-5)
           | (torch.abs(cos_h_i * cos_h_o) <= 1e-5))
    return dict(ks=colors[:, 0], kt=colors[:, 1], eta=eta, cos_i=cos_i,
                cos_o=cos_o, is_trans=is_trans, H=H, cos_h_i=cos_h_i,
                cos_h_o=cos_h_o,
                fterm=_fresnel_dielectric(eta, torch.abs(cos_h_o)),
                D=mf.ndf_ggx(t, b, n, H, au, av), G=G, bad=bad, t=t, b=b,
                n=n, au=au, av=av)


def _rough_dielectric_eval(colors, scalars, surf, in_dir, out_dir):
    q = _rough_dielectric_terms(colors, scalars, surf, in_dir, out_dir)
    refl = q["ks"] * (q["fterm"] * q["D"] * q["G"] * torch.abs(
        mf.reflective_jacobian(q["cos_o"])))[..., None]
    jac = mf.refractive_jacobian(q["eta"], q["cos_h_i"], q["cos_h_o"])
    norm = torch.abs(safe_div(q["cos_h_o"] * jac, q["cos_o"]))
    trans = q["kt"] * ((1.0 - q["fterm"]) * q["D"] * q["G"] * norm)[..., None]
    val = torch.where(q["is_trans"][..., None], trans, refl)
    return torch.where(q["bad"][..., None], torch.zeros_like(val), val)


def _rough_dielectric_pdf(colors, scalars, surf, in_dir, out_dir):
    q = _rough_dielectric_terms(colors, scalars, surf, in_dir, out_dir)
    mpdf = mf.pdf_vndf_ggx(q["t"], q["b"], q["n"], out_dir, q["H"],
                           q["au"], q["av"])
    p_refl = q["fterm"] * mpdf * torch.abs(
        mf.reflective_jacobian(q["cos_h_o"]))
    p_trans = ((1.0 - q["fterm"]) * mpdf
               * torch.abs(mf.refractive_jacobian(q["eta"], q["cos_h_i"],
                                                  q["cos_h_o"])))
    val = torch.where(q["is_trans"], p_trans, p_refl)
    return torch.where(q["bad"] | (mpdf <= 1e-5), torch.zeros_like(val), val)


def _rough_dielectric_sample(colors, scalars, surf, u0, u1, u2, out_dir,
                             adjoint=False):
    """VNDF half-vector (u0, u1), then the Fresnel pick (u2)."""
    n1, n2 = scalars[:, 1], scalars[:, 2]
    au, av = _mf_params(scalars)
    t, b, n = surf["t"], surf["b"], surf["n"]
    eta = torch.where(surf["is_entering"], n1 / n2, n2 / n1)
    cos_o = dot(n, out_dir)

    H = _flip_to(mf.sample_vndf_ggx(u0, u1, t, b, n, out_dir, au, av),
                 out_dir)
    cos_h_o = dot(H, out_dir)
    spdf = mf.pdf_vndf_ggx(t, b, n, out_dir, H, au, av)

    cos_t, factor, _tot = _fresnel(eta, cos_h_o)
    refr = u2 > factor
    d_refr = normalize(refract(out_dir, H, eta, cos_h_o, cos_t))
    d_refl = normalize(reflect(out_dir, H))
    in_dir = torch.where(refr[..., None], d_refr, d_refl)
    jac_t = mf.refractive_jacobian(eta, dot(H, in_dir), cos_h_o)
    jac_r = mf.reflective_jacobian(cos_h_o)
    sel_pdf = torch.where(refr, (1.0 - factor) * torch.abs(jac_t),
                          factor * torch.abs(jac_r))
    cos_i = dot(n, in_dir)
    f_pdf = spdf * sel_pdf
    is_trans = torch.signbit(cos_i * cos_o)
    one = torch.ones_like(eta)
    adj = (torch.where(is_trans, 1.0 / (eta * eta), one) if adjoint
           else one)
    ev = _rough_dielectric_eval(colors, scalars, surf, in_dir, out_dir)
    weight = ev * safe_div(adj, f_pdf)[..., None]
    eta_out = torch.where(is_trans, eta, one)
    valid = ((torch.abs(cos_o) > 1e-5) & (spdf > 1e-5) & (f_pdf > 0)
             & (torch.abs(cos_h_o) > 1e-5))
    return in_dir, f_pdf, weight, eta_out, valid


# ------------------------------------------------------------------ plastic

def _fresnel_diffuse_factor(eta):
    """Two fits by IOR regime."""
    low = -1.4399 * eta * eta + 0.7099 * eta + 0.6681 + 0.0636 / eta
    ie = 1.0 / eta
    hi = (0.919317 - 3.4793 * ie + 6.75335 * ipow(ie, 2)
          - 7.80989 * ipow(ie, 3) + 4.98554 * ipow(ie, 4)
          - 1.36881 * ipow(ie, 5))
    return torch.where(eta < 1.0, low, hi)


def _plastic_parts(colors, scalars, surf, out_dir):
    kd, ks = colors[:, 0], colors[:, 1]
    eta = scalars[:, 1] / scalars[:, 2]
    fdr = _fresnel_diffuse_factor(eta)
    k = _fresnel_dielectric(eta, absolute_cos(out_dir, surf["n"]))
    return kd, ks, eta, fdr, k


def _plastic_scatter(eta, fdr, cos_i):
    fi = _fresnel_dielectric(eta, cos_i)
    return (1.0 - fi) * eta * eta / (1.0 - fdr)


def _spec_colors(ks):
    """The rough plastic's specular lobe as a conductor's color slots:
    ks, eta 0, kappa 1."""
    return torch.stack([ks, torch.zeros_like(ks), torch.ones_like(ks),
                        torch.zeros_like(ks)], dim=1)


def _plastic_eval(colors, scalars, surf, in_dir, out_dir, rough):
    kd, ks, eta, fdr, k = _plastic_parts(colors, scalars, surf, out_dir)
    cos_i = absolute_cos(in_dir, surf["n"])
    diff = (mulf(kd, cos_i * INV_PI)
            * _plastic_scatter(eta, fdr, cos_i)[..., None])
    if rough:
        spec = _rough_conductor_eval(_spec_colors(ks), scalars, surf, in_dir,
                                     out_dir)
    else:
        spec = torch.zeros_like(diff)
    return diff * (1.0 - k)[..., None] + spec * k[..., None]


def _plastic_pdf(colors, scalars, surf, in_dir, out_dir, rough):
    k = _plastic_parts(colors, scalars, surf, out_dir)[4]
    dp = cosine_hemisphere_pdf(positive_cos(in_dir, surf["n"]))
    if rough:
        sp = _rough_conductor_pdf(colors, scalars, surf, in_dir, out_dir)
    else:
        sp = torch.zeros_like(dp)
    return dp * (1.0 - k) + sp * k


def _plastic_sample(colors, scalars, surf, u0, u1, u2, out_dir, rough):
    """A two-lobe mix: u0 picks the lobe.  The diffuse lobe takes u1, u2,
    the rough specular lobe u1, u2 (VNDF), the smooth specular lobe none, so
    the lanes' draw counts differ and are returned."""
    kd, ks, eta, fdr, k = _plastic_parts(colors, scalars, surf, out_dir)
    n = surf["n"]
    pick_diffuse = u0 < (1.0 - k)
    kc = k[..., None]

    # --- diffuse lobe (scattering-scaled lambert)
    local, dpdf = sample_cosine_hemisphere(u1, u2)
    ddir = to_world(local, surf["t"], surf["b"], n)
    dcol = kd * _plastic_scatter(eta, fdr, absolute_cos(ddir, n))[..., None]

    def diffuse_at(sdir):
        cos_i_s = absolute_cos(sdir, n)
        return (cosine_hemisphere_pdf(positive_cos(sdir, n)),
                kd * _plastic_scatter(eta, fdr, cos_i_s)[..., None]
                * (cos_i_s * INV_PI)[..., None])

    if rough:
        spec = _spec_colors(ks)
        sdir, spdf, sweight, _e, svalid = _rough_conductor_sample(
            spec, scalars, surf, u1, u2, out_dir)
        # diffuse pick: combined with the non-specular second lobe
        p_d = dpdf * (1.0 - k) + _rough_conductor_pdf(
            spec, scalars, surf, ddir, out_dir) * k
        c_d = (dcol * dpdf[..., None] * (1.0 - kc)
               + _rough_conductor_eval(spec, scalars, surf, ddir, out_dir)
               * kc)
        w_d = c_d * safe_div(1.0, p_d)[..., None]
        # specular pick: combined with the diffuse lobe
        diff_pdf_s, diff_eval_s = diffuse_at(sdir)
        p_s = spdf * k + diff_pdf_s * (1.0 - k)
        c_s = sweight * spdf[..., None] * kc + diff_eval_s * (1.0 - kc)
        w_s = c_s * safe_div(1.0, p_s)[..., None]
        in_dir = torch.where(pick_diffuse[..., None], ddir, sdir)
        pdf = torch.where(pick_diffuse, p_d, dpdf * 0 + p_s)
        weight = torch.where(pick_diffuse[..., None], w_d, w_s)
        valid = torch.where(pick_diffuse, dpdf > 0, svalid & (p_s > 0))
        draws = torch.full(u0.shape, 3, dtype=torch.int64, device=u0.device)
    else:
        # smooth specular = a mirror scaled by ks; it is specular, so the
        # diffuse pick keeps its own sample as it is
        sdir = reflect(out_dir, n)
        s_pdf = torch.ones_like(u0)
        diff_pdf_s, diff_eval_s = diffuse_at(sdir)
        p_s = s_pdf * k + diff_pdf_s * (1.0 - k)
        c_s = ks * s_pdf[..., None] * kc + diff_eval_s * (1.0 - kc)
        w_s = c_s * safe_div(1.0, p_s)[..., None]
        in_dir = torch.where(pick_diffuse[..., None], ddir, sdir)
        pdf = torch.where(pick_diffuse, dpdf, p_s)
        weight = torch.where(pick_diffuse[..., None], dcol, w_s)
        valid = torch.where(pick_diffuse, dpdf > 0, p_s > 0)
        draws = torch.where(pick_diffuse, 3, 1).to(torch.int64)
    return in_dir, pdf, weight, torch.ones_like(pdf), valid, draws


def _passthrough_sample(out_dir):
    one = torch.ones_like(out_dir[:, 0])
    return (-out_dir, one, torch.ones_like(out_dir), one,
            torch.ones_like(one, dtype=torch.bool))


# ------------------------------------------------------------------- union

def _params(tables, surf, lobe="a"):
    if lobe == "b":
        if "colors_b" in surf:
            return surf["colors_b"], surf["scalars_b"]
        mat_id = surf["mat_id"]
        return (gather_rows(tables["mat_colors_b"], mat_id),
                gather_rows(tables["mat_scalars_b"], mat_id))
    if "colors" in surf:
        return surf["colors"], surf["scalars"]
    mat_id = surf["mat_id"]
    return (gather_rows(tables["mat_colors"], mat_id),
            gather_rows(tables["mat_scalars"], mat_id))


# Material parameters a type's branch reads on the lanes of OTHER types: one
# finite, harmless row.  Every branch runs on every lane and `torch.where`
# keeps only its own lanes, but the gradient of an unselected value is still
# multiplied through that branch's derivatives, and a diffuse row read as a
# plastic one gives eta = 0 / 0: one NaN there makes the whole table's
# gradient NaN.  The JAX package reads the other types' rows as they are,
# and its gradients are NaN on scenes that mix such types (ROADMAP.md,
# queue 3).  Values on a branch's own lanes are untouched.
_SAFE_COLOR = 0.5
_SAFE_SCALARS = (1.0, 1.0, 1.5, 0.0, 1.0) + (0.0,) * 11


@functools.lru_cache(maxsize=None)
def _safe_row(width, dtype, device):
    # made once for each table width, dtype and device: no copy from the
    # host on the hot path
    return torch.tensor(_SAFE_SCALARS[:width], dtype=dtype, device=device)


def _own(m, colors, scalars):
    """`colors`, `scalars` on the lanes of `m`, the safe row elsewhere."""
    safe = _safe_row(scalars.shape[-1], scalars.dtype, scalars.device)
    return (torch.where(m[:, None, None], colors,
                        device_scalar(_SAFE_COLOR, colors.device)),
            torch.where(m[:, None], scalars, safe))


def lobe_types(scene, lobe):
    """The BSDF types of lobe "a" (every material's first) or "b" (the
    second lobes of two-lobe materials)."""
    if lobe == "b":
        return [t for t in getattr(scene, "bsdf_types_b", []) if t >= 0]
    return list(scene.bsdf_types)


def _principled():
    from ignis_tpu_torch.bsdf import principled
    return principled


# measured types: the scene's static info of their materials, the table
# prefix, and eval / pdf / sample (djmeasured's take no `up` vector)
_MEASURED = {
    BSDF_KLEMS: ("klems_info", "klems", klems_bsdf.klems_eval,
                 klems_bsdf.klems_pdf, klems_bsdf.klems_sample),
    BSDF_TENSORTREE: ("tensortree_info", "tt",
                      tensortree_bsdf.tensortree_eval,
                      tensortree_bsdf.tensortree_pdf,
                      tensortree_bsdf.tensortree_sample),
    BSDF_DJMEASURED: ("djmeasured_info", "dj", djmeasured.dj_eval,
                      djmeasured.dj_pdf, djmeasured.dj_sample),
}


def _measured(scene, t, what):
    """(material id, static info, the type's eval (0), pdf (1) or sample
    (2), table prefix) for each material of measured type `t`."""
    key, prefix, *fns = _MEASURED[t]
    return [(mid, info, fns[what], f"{prefix}{mid}")
            for mid, info in getattr(scene, key, {}).items()]


def bsdf_eval(scene, tables, mat_type, surf, in_dir, out_dir, lobe="a"):
    bsdf_types = lobe_types(scene, lobe)
    colors, scalars = _params(tables, surf, lobe)
    out = torch.zeros_like(in_dir)
    for t in sorted(set(bsdf_types)):
        if t in _SPECULAR:
            continue  # specular types eval to black
        m = mat_type == t
        ct, sc = _own(m, colors, scalars)
        if t == BSDF_DIFFUSE:
            v = _diffuse_eval(ct, sc, surf, in_dir, out_dir)
        elif t == BSDF_PHONG:
            v = _phong_eval(ct, sc, surf, in_dir, out_dir)
        elif t == BSDF_ROUGH_CONDUCTOR:
            v = _rough_conductor_eval(ct, sc, surf, in_dir, out_dir)
        elif t == BSDF_ROUGH_DIELECTRIC:
            v = _rough_dielectric_eval(ct, sc, surf, in_dir, out_dir)
        elif t in (BSDF_PLASTIC, BSDF_ROUGH_PLASTIC):
            v = _plastic_eval(ct, sc, surf, in_dir, out_dir,
                              t == BSDF_ROUGH_PLASTIC)
        elif t == BSDF_PRINCIPLED:
            v = _principled().principled_eval(ct, sc, surf, in_dir, out_dir)
        else:
            v = torch.zeros_like(in_dir)
            for mid, info, fn, pre in _measured(scene, t, 0):
                if t == BSDF_DJMEASURED:
                    kv = fn(tables, pre, info, ct[:, 0], surf, in_dir,
                            out_dir)
                else:
                    kv = fn(tables, pre, info, ct[:, 0], info["up"], surf,
                            in_dir, out_dir)
                v = torch.where((surf["mat_id"] == mid)[..., None], kv, v)
        out = torch.where(m[..., None], v, out)
    return out


def bsdf_pdf(scene, tables, mat_type, surf, in_dir, out_dir, lobe="a"):
    bsdf_types = lobe_types(scene, lobe)
    colors, scalars = _params(tables, surf, lobe)
    out = torch.zeros(mat_type.shape, dtype=torch.float32,
                      device=mat_type.device)
    for t in sorted(set(bsdf_types)):
        if t in _SPECULAR:
            continue
        m = mat_type == t
        ct, sc = _own(m, colors, scalars)
        if t == BSDF_DIFFUSE:
            v = _diffuse_pdf(ct, sc, surf, in_dir, out_dir)
        elif t == BSDF_PHONG:
            v = _phong_pdf(ct, sc, surf, in_dir, out_dir)
        elif t == BSDF_ROUGH_CONDUCTOR:
            v = _rough_conductor_pdf(ct, sc, surf, in_dir, out_dir)
        elif t == BSDF_ROUGH_DIELECTRIC:
            v = _rough_dielectric_pdf(ct, sc, surf, in_dir, out_dir)
        elif t in (BSDF_PLASTIC, BSDF_ROUGH_PLASTIC):
            v = _plastic_pdf(ct, sc, surf, in_dir, out_dir,
                             t == BSDF_ROUGH_PLASTIC)
        elif t == BSDF_PRINCIPLED:
            v = _principled().principled_pdf(ct, sc, surf, in_dir, out_dir)
        else:
            v = torch.zeros_like(out)
            for mid, info, fn, pre in _measured(scene, t, 1):
                if t == BSDF_DJMEASURED:
                    kv = fn(tables, pre, info, surf, in_dir, out_dir)
                else:
                    kv = fn(tables, pre, info, info["up"], surf, in_dir,
                            out_dir)
                v = torch.where(surf["mat_id"] == mid, kv, v)
        out = torch.where(m, v, out)
    return out


def bsdf_sample(scene, tables, mat_type, surf, seed, counter, out_dir,
                active=None, adjoint=False, lobe="a"):
    """Sample the union; advances counters by each lane's draw count.

    Returns (in_dir, pdf, weight, eta, valid, new_counter).
    """
    bsdf_types = lobe_types(scene, lobe)
    if active is None:
        active = torch.ones_like(mat_type, dtype=torch.bool)
    colors, scalars = _params(tables, surf, lobe)
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
        m = mat_type == t
        ct, sc = _own(m, colors, scalars)
        if t == BSDF_DIFFUSE:
            r = _diffuse_sample(ct, sc, surf, us[0], us[1], out_dir)
        elif t == BSDF_DIELECTRIC:
            r = _dielectric_sample(ct, sc, surf, us[0], out_dir,
                                   adjoint)
        elif t == BSDF_CONDUCTOR:
            r = _conductor_sample(ct, sc, surf, out_dir)
        elif t == BSDF_PHONG:
            r = _phong_sample(ct, sc, surf, us[0], us[1], out_dir)
        elif t == BSDF_ROUGH_CONDUCTOR:
            r = _rough_conductor_sample(ct, sc, surf, us[0], us[1], out_dir)
        elif t == BSDF_ROUGH_DIELECTRIC:
            r = _rough_dielectric_sample(ct, sc, surf, us[0], us[1],
                                         us[2], out_dir, adjoint)
        elif t in (BSDF_PLASTIC, BSDF_ROUGH_PLASTIC):
            r = _plastic_sample(ct, sc, surf, us[0], us[1], us[2],
                                out_dir, t == BSDF_ROUGH_PLASTIC)
        elif t == BSDF_PRINCIPLED:
            r = _principled().principled_sample(ct, sc, surf, us[0], us[1],
                                                us[2], out_dir)
        elif t == BSDF_PASSTHROUGH:
            r = _passthrough_sample(out_dir)
        else:
            r = [torch.zeros_like(out_dir), torch.zeros_like(pdf),
                 torch.zeros_like(out_dir), torch.ones_like(pdf),
                 torch.zeros_like(valid)]
            for mid, info, fn, pre in _measured(scene, t, 2):
                if t == BSDF_DJMEASURED:
                    kr = fn(tables, pre, info, ct[:, 0], surf, us[0], us[1],
                            out_dir)
                else:
                    kr = fn(tables, pre, info, ct[:, 0], info["up"], surf,
                            us[0], us[1], us[2], out_dir)
                km = surf["mat_id"] == mid
                for i, x in enumerate(kr):
                    r[i] = torch.where(km[..., None] if x.ndim == 2 else km,
                                       x, r[i])
        mc = m[..., None]
        in_dir = torch.where(mc, r[0], in_dir)
        pdf = torch.where(m, r[1], pdf)
        weight = torch.where(mc, r[2], weight)
        eta = torch.where(m, r[3], eta)
        valid = torch.where(m, r[4], valid)
        lane_draws = (r[5] if len(r) > 5
                      else torch.full_like(draws, _SAMPLE_DRAWS[t]))
        draws = torch.where(m, lane_draws, draws)

    new_counter = torch.where(active, (counter + draws) & rng.M32, counter)
    valid = valid & active
    return in_dir, pdf, weight, eta, valid, new_counter
