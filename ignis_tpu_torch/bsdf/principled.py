"""Disney principled BSDF, batched.

Counterpart of ignis_tpu/bsdf/principled.py.

All directions are taken to the surface's local frame (z = the oriented
shading normal).  Lobe mixture, Fresnel, sheen, clearcoat, thin-surface
translucency and refraction follow the reference package line for line, with
its clamps as `clip` / `maximum` so that a gradient splits at a tie as there.

Parameter layout (mat_scalars, 16 slots for principled materials):
  [0]=roughness_u (alpha ax), [4]=roughness_v (ay), after compute_roughness,
  [1]=ior, [3]=thin, [5]=diffuse_transmission, [6]=specular_transmission,
  [7]=specular_tint, [8]=flatness, [9]=metallic, [10]=sheen, [11]=sheen_tint,
  [12]=clearcoat, [13]=clearcoat_gloss, [14]=clearcoat_roughness,
  [15]=clearcoat_top_only
base_color = mat_colors slot 0.  Textured parameters are not ported.
"""

from __future__ import annotations

import torch

from ignis_tpu_torch.bsdf import microfacet as mf
from ignis_tpu_torch.core.vec import (
    FLT_EPS, INV_PI, absolute_cos, clip, dot, ipow, maximum, normalize,
    safe_div, safe_sqrt, to_local, to_world,
)
from ignis_tpu_torch.core.warp import (
    cosine_hemisphere_pdf, sample_cosine_hemisphere,
)

_GRAZING_EPS = 1e-5
_MICRO_EPS = 1e-5


def _union():
    from ignis_tpu_torch.bsdf import union
    return union


def _idframe(like):
    """The local frame's (t, b, n), broadcast to the lanes of `like`."""
    eye = torch.eye(3, dtype=torch.float32, device=like.device)
    return tuple(eye[i].expand(like.shape) for i in range(3))


def _flip_z(v):
    return v * v.new_tensor([1.0, 1.0, -1.0])


def _luminance(c):
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


def _schlick_approx(c):
    """(1 - cos)^5"""
    k = clip(1.0 - c, 0.0, 1.0)
    return k * k * k * k * k


def _schlick_r0(eta):
    f = (eta - 1.0) / (eta + 1.0)
    return f * f


def _schlick(r0, c):
    return r0 + (1.0 - r0) * _schlick_approx(c)[..., None]


def _tint_color(c):
    lum = _luminance(c)
    return torch.where((lum <= FLT_EPS)[..., None], torch.ones_like(c),
                       c * safe_div(1.0, lum)[..., None])


def _fresnel_dielectric(eta, cos_i):
    return _union()._fresnel_dielectric(eta, cos_i)


class P:
    """Per-lane parameters unpacked from the material tables."""

    def __init__(self, colors, scalars, surf):
        self.base_color = colors[:, 0]
        self.ru = maximum(scalars[:, 0], 1e-3)
        self.rv = maximum(scalars[:, 4], 1e-3)
        self.ior = scalars[:, 1]
        self.thin = scalars[:, 3] > 0.5
        self.diff_trans = scalars[:, 5]
        self.spec_trans = scalars[:, 6]
        self.spec_tint = scalars[:, 7]
        self.flatness = scalars[:, 8]
        self.metallic = scalars[:, 9]
        self.sheen = scalars[:, 10]
        self.sheen_tint = scalars[:, 11]
        self.clearcoat = scalars[:, 12]
        self.cc_gloss = scalars[:, 13]
        self.cc_rough = scalars[:, 14]
        self.cc_top_only = scalars[:, 15] > 0.5
        self.eta = torch.where(surf["is_entering"] | self.thin,
                               1.0 / self.ior, self.ior)
        # thin refraction roughness remap
        f = clip(0.65 * self.ior - 0.35, 0.0, None)
        self.ru_refr = torch.where(self.thin, clip(f * self.ru, 0.0, 1.0),
                                   self.ru)
        self.rv_refr = torch.where(self.thin, clip(f * self.rv, 0.0, 1.0),
                                   self.rv)


def _same_hemi(a, b):
    return (a[..., 2] * b[..., 2]) >= 0.0


def _make_same_hemisphere(ref, v):
    """v with its z flipped into ref's hemisphere."""
    return torch.where(torch.signbit(ref[..., 2])[..., None], _flip_z(v), v)


def _make_positive(v):
    return torch.where(torch.signbit(v[..., 2])[..., None], _flip_z(v), v)


def _eval_fresnel_term(p, wo, wi, h):
    hdv = absolute_cos(wo, h)
    hdl = absolute_cos(wi, h)
    bad = hdv * hdl <= FLT_EPS
    f1 = _fresnel_dielectric(p.eta, hdv)[..., None].expand(-1, 3)
    color = _tint_color(p.base_color)
    a = (1.0 - p.spec_tint)[..., None] + color * p.spec_tint[..., None]
    r0 = (a * _schlick_r0(p.eta)[..., None] * (1.0 - p.metallic)[..., None]
          + p.base_color * p.metallic[..., None])
    f2 = _schlick(r0, hdl)
    out = f1 * (1.0 - p.metallic)[..., None] + f2 * p.metallic[..., None]
    return torch.where(bad[..., None], torch.zeros_like(out), out)


def _eval_diffuse(p, wo, wi):
    lk = _schlick_approx(torch.abs(wi[..., 2]))
    vk = _schlick_approx(torch.abs(wo[..., 2]))
    diff = (1.0 - 0.5 * lk) * (1.0 - 0.5 * vk)
    vdl = absolute_cos(wi, wo)
    rr = (vdl + 1.0) * (p.ru + p.rv) / 2.0
    retro = rr * (lk + vk + lk * vk * (rr - 1.0))
    # subsurface (thin flatness)
    r2 = p.ru * p.rv
    hdl2 = ipow(dot(wi, normalize(wi + wo)), 2)
    fss90 = hdl2 * r2
    andl = torch.abs(wi[..., 2])
    andv = torch.abs(wo[..., 2])
    fss = (1.0 - lk + fss90 * lk) * (1.0 - vk + fss90 * vk)
    sst = 1.25 * (fss * (1.0 / (andl + andv + 1e-5) - 0.5) + 0.5)
    ss = torch.where(p.thin, 1.0 - p.flatness + sst * p.flatness,
                     torch.ones_like(sst))
    return INV_PI * (diff + retro) * ss * andl


def _eval_translucent(p, wo, wi):
    lk = _schlick_approx(torch.abs(wi[..., 2]))
    vk = _schlick_approx(torch.abs(wo[..., 2]))
    return (INV_PI * (1.0 - 0.5 * lk) * (1.0 - 0.5 * vk)
            * torch.abs(wi[..., 2]))


def _eval_sheen(p, wi):
    lk = _schlick_approx(torch.abs(wi[..., 2]))
    tint = ((1.0 - p.sheen_tint)[..., None]
            + _tint_color(p.base_color) * p.sheen_tint[..., None])
    return tint * (p.sheen * lk * torch.abs(wi[..., 2]))[..., None]


def _micro(wo, wi, h, au, av):
    t, b, n = _idframe(wo)
    d = mf.ndf_ggx(t, b, n, h, au, av)
    g = (mf.g1_smith(t, b, n, wi, au, av)
         * mf.g1_smith(t, b, n, wo, au, av))
    return d, g


def _eval_reflection(p, wo, wi, h):
    f = _eval_fresnel_term(p, wo, wi, h)
    d, g = _micro(wo, wi, h, p.ru, p.rv)
    jac = safe_div(1.0, 4.0 * wo[..., 2])
    return f * torch.abs(d * g * jac)[..., None]


def _eval_refraction(p, wo, wi, h):
    # thin branch
    ft = _fresnel_dielectric(p.eta, torch.abs(wo[..., 2]))
    f_thin = ft + (1.0 - ft) * ft / (ft + 1.0)
    term_thin = 1.0 - f_thin
    # solid branch
    hdi = dot(wi, h)
    hdo = dot(wo, h)
    f = _fresnel_dielectric(p.eta, torch.abs(hdo))
    d, g = _micro(wo, wi, h, p.ru_refr, p.rv_refr)
    jac = mf.refractive_jacobian(p.eta, hdi, hdo)
    norm = torch.abs(safe_div(hdo * jac, wo[..., 2]))
    term_solid = (1.0 - f) * d * g * norm
    term = torch.where(p.thin, term_thin, term_solid)
    col = torch.where(p.thin[..., None],
                      safe_sqrt(p.base_color), p.base_color)
    return col * term[..., None]


def _eval_clearcoat(p, wo, wi, h):
    f0 = 0.04
    r = 0.25
    r2 = maximum(p.cc_rough * (1.0 - p.cc_gloss) + 0.01 * p.cc_gloss, 0.001)
    ahdl = absolute_cos(wi, h)
    t, b, n = _idframe(wo)
    d = mf.ndf_ggx(t, b, n, h, r2, r2)
    f = f0 + (1.0 - f0) * _schlick_approx(ahdl)
    rr = torch.full_like(ahdl, r)
    g = (mf.g1_smith(t, b, n, wi, rr, rr) * mf.g1_smith(t, b, n, wo, rr, rr))
    jac = safe_div(1.0, 4.0 * wo[..., 2])
    return torch.abs(r * d * f * g * jac * wi[..., 2])[..., None].expand(-1, 3)


def _lobes(p, wo):
    """The lobe distribution: (diffuse refl, diffuse trans, specular refl,
    specular trans) pick probabilities."""
    metallic = clip(p.metallic, 0.0, 1.0)
    dt = clip(p.diff_trans, 0.0, 1.0)
    st = clip(p.spec_trans, 0.0, 1.0)
    abs_gen = _luminance(p.base_color)
    abs_spec = 1.0 + p.spec_tint * (_luminance(_tint_color(p.base_color))
                                    - 1.0)
    diff_refl = clip(abs_gen * (1.0 - metallic) * (1.0 - st), 0.0, 1.0)
    f = _fresnel_dielectric(p.eta, torch.abs(wo[..., 2]))
    spec_refl = clip(abs_spec * (1.0 - f) + f, 0.0, 1.0)
    has_t = (dt > 0.0) | (st > 0.0)
    zero = torch.zeros_like(f)
    diff_t = torch.where(has_t, clip(abs_gen * dt * diff_refl, 0.0, 1.0),
                         zero)
    spec_t = torch.where(
        has_t, clip((1.0 - f) * abs_gen * (1.0 - metallic) * st, 0.0, 1.0),
        zero)
    norm = diff_refl + spec_refl + diff_t + spec_t
    bad = norm <= FLT_EPS
    normi = safe_div(1.0, torch.where(bad, torch.ones_like(norm), norm))
    return (torch.where(bad, torch.ones_like(norm), diff_refl * normi),
            torch.where(bad, zero, diff_t * normi),
            torch.where(bad, zero, spec_refl * normi),
            torch.where(bad, zero, spec_t * normi))


def _half_for(p, wo, wi):
    trans = ~_same_hemi(wo, wi)
    h_r = normalize(wi + wo)
    h_t = normalize(wi + wo * p.eta[..., None])
    h = torch.where(trans[..., None], h_t, h_r)
    return _make_same_hemisphere(wo, h)


def principled_eval(colors, scalars, surf, in_dir, out_dir):
    p = P(colors, scalars, surf)
    wo = to_local(out_dir, surf["t"], surf["b"], surf["n"])
    wi = to_local(in_dir, surf["t"], surf["b"], surf["n"])
    h = _half_for(p, wo, wi)
    trans = ~_same_hemi(wo, wi)
    andl = torch.abs(wi[..., 2])

    one = torch.ones_like(andl)
    diffuse_w = (torch.where(p.thin, one, 1.0 - clip(p.metallic, 0, 1))
                 * (1.0 - clip(p.spec_trans, 0, 1)))
    trans_w = (1.0 - clip(p.metallic, 0, 1)) * clip(p.spec_trans, 0, 1)

    refl = (p.base_color * (_eval_diffuse(p, wo, wi) * diffuse_w)[..., None]
            + _eval_sheen(p, wi) * diffuse_w[..., None]
            + _eval_reflection(p, wo, wi, h))
    # clearcoat (upper hemisphere gate when top_only)
    in_front = surf["is_entering"] == (wi[..., 2] >= 0)
    out_front = surf["is_entering"] == (wo[..., 2] >= 0)
    cc_ok = (~p.cc_top_only) | (in_front & out_front)
    cc = _eval_clearcoat(p, wo, wi, h) * p.clearcoat[..., None]
    refl = refl + torch.where(cc_ok[..., None], cc, torch.zeros_like(cc))

    tl = _eval_translucent(p, wo, wi) * p.diff_trans
    tl = torch.where(p.thin, tl, torch.zeros_like(tl))
    tr = (p.base_color * tl[..., None]
          + _eval_refraction(p, wo, wi, h) * trans_w[..., None])

    out = torch.where(trans[..., None], tr, refl)
    return torch.where((andl <= _GRAZING_EPS)[..., None],
                       torch.zeros_like(out), out)


def _spec_refl_pdf_local(p, wo, wi):
    pwo = _make_positive(wo)
    pwi = _make_positive(wi)
    h = normalize(pwo + pwi)
    cos_h_o = dot(pwo, h)
    t, b, n = _idframe(wo)
    mpdf = mf.pdf_vndf_ggx(t, b, n, pwo, h, p.ru, p.rv)
    mpdf = torch.where(mpdf <= _MICRO_EPS, torch.zeros_like(mpdf), mpdf)
    return torch.abs(mpdf * safe_div(1.0, 4.0 * cos_h_o))


def _spec_trans_pdf_local(p, wo, wi):
    pwo = _make_positive(wo)
    pwi = -_make_positive(wi)
    h = normalize(pwi + pwo * p.eta[..., None])
    cos_h_i = dot(pwi, h)
    cos_h_o = dot(pwo, h)
    t, b, n = _idframe(wo)
    mpdf = mf.pdf_vndf_ggx(t, b, n, pwo, h, p.ru_refr, p.rv_refr)
    mpdf = torch.where(mpdf <= _MICRO_EPS, torch.zeros_like(mpdf), mpdf)
    return torch.abs(mpdf * mf.refractive_jacobian(p.eta, cos_h_i, cos_h_o))


def principled_pdf(colors, scalars, surf, in_dir, out_dir):
    p = P(colors, scalars, surf)
    wo = to_local(out_dir, surf["t"], surf["b"], surf["n"])
    wi = to_local(in_dir, surf["t"], surf["b"], surf["n"])
    bad = ((torch.abs(wo[..., 2]) <= _GRAZING_EPS)
           | (torch.abs(wi[..., 2]) <= _GRAZING_EPS))
    dr, dt, sr, st = _lobes(p, wo)
    diff_pdf = cosine_hemisphere_pdf(torch.abs(wi[..., 2]))
    same = _same_hemi(wo, wi)
    v_same = dr * diff_pdf + sr * _spec_refl_pdf_local(p, wo, wi)
    v_thin = dt * diff_pdf + st
    v_solid = dt * diff_pdf + st * _spec_trans_pdf_local(p, wo, wi)
    out = torch.where(same, v_same, torch.where(p.thin, v_thin, v_solid))
    return torch.where(bad, torch.zeros_like(out), out)


def principled_sample(colors, scalars, surf, u0, u1, u2, out_dir):
    """Three draws (lobe pick + 2); thin specular transmission uses only the
    pick, so the per-lane draw count is returned."""
    p = P(colors, scalars, surf)
    wo = to_local(out_dir, surf["t"], surf["b"], surf["n"])
    ok_wo = torch.abs(wo[..., 2]) > _GRAZING_EPS
    dr, dt, sr, st = _lobes(p, wo)
    pick = u0

    t, b, n = _idframe(wo)

    # diffuse refl/trans candidate
    s_local, s_pdf = sample_cosine_hemisphere(u1, u2)
    wi_dr = _make_same_hemisphere(wo, s_local)
    pdf_dr = s_pdf * dr + _spec_refl_pdf_local(p, wo, wi_dr) * sr
    wi_dt = -wi_dr
    pdf_dt = s_pdf * dt + _spec_trans_pdf_local(p, wo, wi_dt) * st

    # spec refl candidate
    pwo = _make_positive(wo)
    oh_r = mf.sample_vndf_ggx(u1, u2, t, b, n, pwo, p.ru, p.rv)
    h_r = torch.where(torch.signbit(dot(oh_r, pwo))[..., None], -oh_r, oh_r)
    mpdf_r = mf.pdf_vndf_ggx(t, b, n, pwo, h_r, p.ru, p.rv)
    cos_h_o_r = dot(pwo, h_r)
    pwi_r = normalize(2.0 * cos_h_o_r[..., None] * h_r - pwo)
    ok_sr = (_same_hemi(pwo, pwi_r) & (cos_h_o_r > FLT_EPS)
             & (pwi_r[..., 2] > _GRAZING_EPS) & (mpdf_r > _MICRO_EPS))
    wi_sr = _make_same_hemisphere(wo, pwi_r)
    pdf_sr = (torch.abs(mpdf_r * safe_div(1.0, 4.0 * cos_h_o_r)) * sr
              + cosine_hemisphere_pdf(torch.abs(wi_sr[..., 2])) * dr)

    # spec trans candidate
    oh_t = mf.sample_vndf_ggx(u1, u2, t, b, n, pwo, p.ru_refr, p.rv_refr)
    h_t = torch.where(torch.signbit(dot(oh_t, pwo))[..., None], -oh_t, oh_t)
    mpdf_t = mf.pdf_vndf_ggx(t, b, n, pwo, h_t, p.ru_refr, p.rv_refr)
    cos_h_o_t = dot(pwo, h_t)
    cos_t, _factor, total = _union()._fresnel(p.eta, cos_h_o_t)
    # refraction direction (vec3_refract semantics)
    refr_dir = normalize(h_t * (p.eta * cos_h_o_t - cos_t)[..., None]
                         - pwo * p.eta[..., None])
    refl_dir = normalize(2.0 * cos_h_o_t[..., None] * h_t - pwo)
    ok_refr = (~_same_hemi(pwo, refr_dir) & (cos_h_o_t > FLT_EPS)
               & (-refr_dir[..., 2] > _GRAZING_EPS))
    ok_tirr = (_same_hemi(pwo, refl_dir) & (cos_h_o_t > FLT_EPS)
               & (refl_dir[..., 2] > _GRAZING_EPS))
    ok_st_solid = ((mpdf_t > _MICRO_EPS)
                   & torch.where(total, ok_tirr, ok_refr))
    wi_st_solid = torch.where(total[..., None],
                              _make_same_hemisphere(wo, refl_dir),
                              -_make_same_hemisphere(wo, refr_dir))
    jac_t = mf.refractive_jacobian(p.eta, dot(refr_dir, h_t), cos_h_o_t)
    diff_st = cosine_hemisphere_pdf(torch.abs(wi_st_solid[..., 2])) * dt
    pdf_st_refr = torch.abs(mpdf_t * jac_t) * st + diff_st
    pdf_st_tir = mpdf_t * safe_div(1.0, 4.0 * cos_h_o_t) * st + diff_st
    pdf_st_solid = torch.where(total, pdf_st_tir, pdf_st_refr)
    # thin: straight through
    wi_st = torch.where(p.thin[..., None], -wo, wi_st_solid)
    pdf_st = torch.where(p.thin, st, pdf_st_solid)
    ok_st = torch.where(p.thin, torch.ones_like(ok_st_solid), ok_st_solid)

    # --- pick the lobe
    is_dr = pick < dr
    is_dt = (~is_dr) & (pick < dr + dt)
    is_st = (~is_dr) & (~is_dt) & (pick < dr + dt + st)
    is_sr = ~(is_dr | is_dt | is_st)

    def pick3(a, b_, c, d):
        return torch.where(is_dr[..., None], a, torch.where(
            is_dt[..., None], b_, torch.where(is_st[..., None], c, d)))

    wi = pick3(wi_dr, wi_dt, wi_st, wi_sr)
    pdf = torch.where(is_dr, pdf_dr, torch.where(
        is_dt, pdf_dt, torch.where(is_st, pdf_st, pdf_sr)))
    ok = torch.where(is_st, ok_st, torch.where(is_sr, ok_sr, s_pdf > 0))
    valid = ok_wo & ok & (pdf > FLT_EPS)

    one = torch.ones_like(pdf)
    s_eta = torch.where(p.thin | _same_hemi(wo, wi), one, p.eta)
    in_dir = to_world(wi, surf["t"], surf["b"], surf["n"])
    ev = principled_eval(colors, scalars, surf, in_dir, out_dir)
    weight = ev * safe_div(1.0, pdf)[..., None]
    draws = torch.where(is_st & p.thin, 1, 3).to(torch.int64)
    return in_dir, pdf, weight, s_eta, valid, draws
