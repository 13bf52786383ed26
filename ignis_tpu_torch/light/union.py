"""Batched light union: selection, direct sampling, pdfs and emission.

Counterpart of ignis_tpu/light/union.py for every light type (point, spot,
directional, sun, plane / mesh / sphere area, constant, textured and sky
environments, the importance-sampled environment) and every selector
(`uniform`, `simple` / `cdf` with the flux CDF, `hierarchy`).  Every branch
reports its pdf both raw (`pdf_value`) and converted to solid angle
(`pdf_solid`), which is what the path technique consumes.  Draw order and
draw counts are the JAX package's, lane by lane, so that the counter-based
RNG stays aligned and paths replay.

Light parameter rows live in tables["light_data"] (N_lights, 32):
  POINT:       pos[0:3], intensity[3:6]
  AREA_PLANE:  origin[0:3], x_axis[3:6], y_axis[6:9], normal[9:12], area[12],
               radiance[13:16]
  AREA_MESH:   radiance[0:3], tri_offset[3], tri_count[4], entity[5]
  ENV:         radiance*scale[0:3] (the scale alone when textured),
               transform3x3[3:12]; a sky: ground terms from [12]
  ENV_CDF:     scale[0:3], transform3x3[3:12]
  DIRECTIONAL: dir[0:3], irradiance[3:6]
  SPOT:        pos[0:3], dir[3:6], intensity[6:9], cos_cutoff[9],
               cos_falloff[10]
  SUN:         dir[0:3], irradiance[3:6], cos_angle[9]
  AREA_SPHERE: radiance[0:3], radius[3], world center[4:7], entity[7],
               total area 4*pi*r^2 [8]
"""

from __future__ import annotations

import numpy as np
import torch

from ignis_tpu_torch.core import rng
from ignis_tpu_torch.core.dgather import gather_rows
from ignis_tpu_torch.core.vec import (
    FLT_EPS, FLT_MAX, PI, clip, cross, device_const, dot, length, maximum,
    orthonormal_basis, safe_div, signbit, to_world,
)
from ignis_tpu_torch.core.warp import (
    cosine_hemisphere_pdf, equal_area_sphere_pdf,
    equal_area_square_to_sphere, sample_cosine_hemisphere, sample_triangle,
    sample_uniform_cone,
)
from ignis_tpu_torch.light.env_cdf import (
    cdf2d_pdf, cdf2d_sample, map_env_uv, sin_theta_of, switch_env_up,
    uv_to_dir,
)
from ignis_tpu_torch.light.hierarchy import hierarchy_pdf, hierarchy_sample
from ignis_tpu_torch.scene.compile import (
    LIGHT_AREA_MESH, LIGHT_AREA_PLANE, LIGHT_AREA_SPHERE, LIGHT_DIRECTIONAL,
    LIGHT_ENV, LIGHT_ENV_CDF, LIGHT_POINT, LIGHT_SPOT, LIGHT_SUN,
)

# draw counts per light type (sample_direct)
_LIGHT_DRAWS = {
    LIGHT_POINT: 0, LIGHT_DIRECTIONAL: 0, LIGHT_SPOT: 0,
    LIGHT_AREA_PLANE: 2, LIGHT_AREA_MESH: 2, LIGHT_ENV: 2,
    LIGHT_ENV_CDF: 2, LIGHT_SUN: 2, LIGHT_AREA_SPHERE: 2,
}


def _ids(dev, ids):
    return device_const(tuple(ids), torch.int32, dev)


def _safe_len(v):
    """length with an epsilon floor (a coincident light/shading point would
    otherwise give an infinite derivative)."""
    return torch.sqrt(torch.clamp_min(torch.sum(v * v, dim=-1), 1e-24))


def _ldata(tables, light_idx):
    return gather_rows(tables["light_data"], light_idx)  # (N, 32)


def select_light_uniform(num_lights, seed, counter, active):
    """Uniform light selection.  Draws next_i32(0, n-1) only when n > 1.
    Returns (light_idx, select_pdf, counter)."""
    if num_lights <= 1:
        idx = torch.zeros(counter.shape, dtype=torch.int32,
                          device=counter.device)
        return idx, 1.0, counter
    idx, counter = rng.next_i32(seed, counter, 0, num_lights - 1, active)
    return idx, 1.0 / num_lights, counter


def select_light(scene, tables, seed, counter, active, from_pos=None):
    """Selector dispatch.  `simple` / `cdf` use the flux-weighted CDF over
    the finite lights, with a 0.5 infinite / finite split when both exist;
    `hierarchy` descends the light tree from the shading point `from_pos`.
    Returns (light_idx, select_pdf (per-lane), counter)."""
    kind = scene.technique.light_selector
    num_lights = scene.num_lights
    finite_ids = [i for i, l in enumerate(scene.lights) if not l.infinite]
    inf_ids = [i for i, l in enumerate(scene.lights) if l.infinite]
    dev = counter.device

    if (num_lights <= 1 or kind not in ("simple", "cdf", "hierarchy")
            or not finite_ids):
        idx, pdf, counter = select_light_uniform(num_lights, seed, counter,
                                                 active)
        return idx, torch.full(counter.shape, pdf, dtype=torch.float32,
                               device=dev), counter

    fin_map = _ids(dev, finite_ids)
    ratio = 0.5
    if inf_ids:
        q, counter_q = rng.next_f32(seed, counter)
        counter = torch.where(active, counter_q, counter)
        pick_inf = q < ratio
        if len(inf_ids) > 1:
            iidx, counter = rng.next_i32(seed, counter, 0, len(inf_ids) - 1,
                                         active & pick_inf)
        else:
            iidx = torch.zeros(counter.shape, dtype=torch.int32, device=dev)
        inf_light = _ids(dev, inf_ids)[iidx.long()]

    if (kind == "hierarchy" and "lh_child" in tables
            and from_pos is not None and len(finite_ids) >= 2):
        if inf_ids:
            loc, hpdf, counter = hierarchy_sample(
                tables, from_pos, seed, counter, active & ~pick_inf,
                scene.lh_depth)
            idx = torch.where(pick_inf, inf_light, fin_map[loc.long()])
            pdf = torch.where(pick_inf,
                              torch.full_like(hpdf, ratio / len(inf_ids)),
                              hpdf * (1.0 - ratio))
            return idx, pdf, counter
        loc, hpdf, counter = hierarchy_sample(
            tables, from_pos, seed, counter, active, scene.lh_depth)
        return fin_map[loc.long()], hpdf, counter

    cdf = tables["light_sel_cdf"]
    u, counter_f = rng.next_f32(seed, counter)
    off = torch.clamp(torch.searchsorted(cdf, u.contiguous(), right=True), 0,
                      cdf.shape[0] - 1)
    if inf_ids:
        counter = torch.where(active & ~pick_inf, counter_f, counter)
        idx = torch.where(pick_inf, inf_light, fin_map[off])
    else:
        counter = torch.where(active, counter_f, counter)
        idx = fin_map[off]
    return idx, tables["light_sel_pdf"][idx.long()], counter


def light_select_pdf(scene, tables, light_idx, from_pos):
    """Per-lane pdf of the selector choosing `light_idx` (global id) from
    `from_pos`: the static table for uniform and CDF selection, a replay of
    the descent for the hierarchy."""
    kind = scene.technique.light_selector
    finite_ids = [i for i, l in enumerate(scene.lights) if not l.infinite]
    inf_ids = [i for i, l in enumerate(scene.lights) if l.infinite]
    static = gather_rows(tables["light_sel_pdf"], light_idx)
    if (kind != "hierarchy" or "lh_child" not in tables
            or from_pos is None or len(finite_ids) < 2):
        return static
    loc = gather_rows(tables["light_fin_local"], light_idx)
    hpdf = hierarchy_pdf(tables, torch.clamp_min(loc, 0), from_pos,
                         scene.lh_depth)
    if inf_ids:
        hpdf = hpdf * 0.5
    # infinite lights keep the static split pdf
    return torch.where(loc >= 0, hpdf, static)


# ---------------------------------------------------------------- sampling

def _sample_point(data, from_point):
    pos = data[:, 0:3]
    intensity = data[:, 3:6]
    dir_ = pos - from_point
    dist = _safe_len(dir_)
    d = dir_ * safe_div(1.0, dist)[..., None]
    one = torch.ones_like(dist)
    return dict(dir=d, dist=dist, cos=one, pos=pos, intensity=intensity,
                pdf_value=one, pdf_solid=dist * dist)


def _sample_sun(data, from_point, u1, u2):
    """A uniform cone around the (scene-incoming) sun direction; delta
    pdf."""
    n = from_point.shape[0]
    sdir = data[:, 0:3]
    cos_angle = data[:, 9]
    color = data[:, 3:6]
    sun_radius = (torch.sqrt(maximum(1.0 - cos_angle * cos_angle, 0.0))
                  / maximum(cos_angle, 1e-8))
    sun_area = PI * sun_radius * sun_radius
    local, pdf = sample_uniform_cone(u1, u2, cos_angle)
    tb, bb = orthonormal_basis(sdir)
    wdir = to_world(local, tb, bb, sdir)
    intensity = color * safe_div(1.0, sun_area * pdf)[..., None]
    f32 = dict(dtype=torch.float32, device=from_point.device)
    one = torch.ones(n, **f32)
    return dict(dir=-wdir, dist=torch.full((n,), FLT_MAX, **f32),
                cos=local[..., 2], pos=torch.zeros((n, 3), **f32),
                intensity=intensity, pdf_value=one, pdf_solid=one)


def _sample_directional(data, from_point, scene_radius):
    d = -data[:, 0:3]  # the direction property points FROM the light
    irr = data[:, 3:6]
    dist = torch.full(from_point.shape[:-1], scene_radius,
                      dtype=torch.float32, device=from_point.device)
    one = torch.ones_like(dist)
    return dict(dir=d, dist=dist, cos=one, pos=from_point + d * scene_radius,
                intensity=irr, pdf_value=one, pdf_solid=one)


def _sample_spot(data, from_point):
    """Area-measure pdf 1 inside the cone (0 outside), the light-side cosine
    fed through to the solid-angle pdf, and a smoothstep falloff between the
    cutoff and falloff cosines."""
    pos = data[:, 0:3]
    ldir = data[:, 3:6]
    intensity = data[:, 6:9]
    cos_cutoff = data[:, 9]
    cos_falloff = data[:, 10]
    dir_ = pos - from_point
    dist = _safe_len(dir_)
    d = dir_ * safe_div(1.0, dist)[..., None]
    cos_a = dot(-d, ldir)   # angle of (light -> surface) to the spot axis
    blend = cos_falloff - cos_cutoff
    t = clip(safe_div(cos_a - cos_cutoff, blend), 0.0, 1.0)
    smooth = t * t * (3.0 - 2.0 * t)
    zero, one = torch.zeros_like(t), torch.ones_like(t)
    fall = torch.where(blend <= FLT_EPS,
                       torch.where(cos_a <= cos_cutoff, zero, one), smooth)
    pdf_value = torch.where(cos_a > cos_cutoff, one, zero)
    return dict(dir=d, dist=dist, cos=cos_a, pos=pos,
                intensity=intensity * fall[..., None],
                pdf_value=pdf_value,
                pdf_solid=pdf_value * safe_div(dist * dist, torch.abs(cos_a)))


def _compute_sq(origin, ex, ey, nrm, width, height, from_point):
    """Spherical-rectangle precomputation."""
    dirv = origin - from_point
    x0 = dot(dirv, ex)
    y0 = dot(dirv, ey)
    z0_ = dot(dirv, nrm)
    x1 = x0 + width
    y1 = y0 + height
    pos_side = ~signbit(z0_)
    z0 = torch.where(pos_side, -z0_, z0_)
    n = torch.where(pos_side[..., None], -nrm, nrm)

    v4 = torch.stack([x0, y1, x1, y0], dim=-1)
    w4 = torch.stack([x1, y0, x0, y1], dim=-1)
    diff = v4 - w4
    m4 = torch.stack([y0, x1, y1, x0], dim=-1)
    nz_ = m4 * diff
    denom = torch.sqrt(torch.clamp_min(diff * diff * (z0 * z0)[..., None]
                                       + nz_ * nz_, 1e-20))
    nz = nz_ / denom

    def sacos(a):
        # clamp strictly inside (-1, 1), as the reference does for its
        # backward pass
        return torch.arccos(torch.clamp(a, -1.0 + 1e-7, 1.0 - 1e-7))

    g0 = sacos(-nz[..., 0] * nz[..., 1])
    g1 = sacos(-nz[..., 1] * nz[..., 2])
    g2 = sacos(-nz[..., 2] * nz[..., 3])
    g3 = sacos(-nz[..., 3] * nz[..., 0])
    b0 = nz[..., 0]
    b1 = nz[..., 2]
    k = 2.0 * PI - g2 - g3
    s = g0 + g1 - k
    return dict(x0=x0, y0=y0, z0=z0, x1=x1, y1=y1, b0=b0, b1=b1, k=k, s=s,
                n=n)


def _plane_axes(data):
    origin = data[:, 0:3]
    xa = data[:, 3:6]
    ya = data[:, 6:9]
    nrm = data[:, 9:12]
    width = length(xa)
    height = length(ya)
    ex = xa * safe_div(1.0, width)[..., None]
    ey = ya * safe_div(1.0, height)[..., None]
    return origin, ex, ey, nrm, width, height


def _sample_area_plane(data, from_point, is_entering, u1, u2):
    """Urena spherical-rectangle sampling."""
    origin, ex, ey, nrm, width, height = _plane_axes(data)
    radiance = data[:, 13:16]
    sq = _compute_sq(origin, ex, ey, nrm, width, height, from_point)

    au = u1 * sq["s"] + sq["k"]
    sin_au = torch.sin(au)
    sin_au = torch.where(torch.abs(sin_au) < 1e-12,
                         torch.copysign(torch.full_like(sin_au, 1e-12),
                                        sin_au), sin_au)
    fu = (torch.cos(au) * sq["b0"] - sq["b1"]) / sin_au
    cu_d = torch.sqrt(torch.clamp_min(fu * fu + sq["b0"] * sq["b0"], 1e-20))
    cu = torch.clamp(torch.copysign(torch.ones_like(fu), fu) / cu_d,
                     -1.0, 1.0)
    xu = -(cu * sq["z0"]) / torch.sqrt(torch.clamp_min(1.0 - cu * cu, 1e-20))
    xu = torch.minimum(torch.maximum(xu, sq["x0"]), sq["x1"])
    d = torch.sqrt(torch.clamp_min(xu * xu + sq["z0"] * sq["z0"], 1e-20))
    h0 = sq["y0"] / torch.sqrt(torch.clamp_min(d * d + sq["y0"] * sq["y0"],
                                               1e-20))
    h1 = sq["y1"] / torch.sqrt(torch.clamp_min(d * d + sq["y1"] * sq["y1"],
                                               1e-20))
    hv = h0 + u2 * (h1 - h0)
    hv2 = hv * hv
    yv = torch.where(hv2 < 1.0 - 1e-6,
                     (hv * d) / torch.sqrt(torch.clamp_min(1.0 - hv2, 1e-20)),
                     sq["y1"])

    p = (from_point + ex * xu[..., None] + ey * yv[..., None]
         + sq["n"] * sq["z0"][..., None])
    pdf_s = safe_div(1.0, sq["s"])
    weight = sq["s"]

    dir_ = p - from_point
    dist = _safe_len(dir_)
    dirn = dir_ * safe_div(1.0, dist)[..., None]
    sgn = torch.where(is_entering, -1.0, 1.0).to(torch.float32)
    cos = dot(dirn, nrm) * sgn
    return dict(dir=dirn, dist=dist, cos=cos, pos=p,
                intensity=radiance * weight[..., None],
                pdf_value=pdf_s, pdf_solid=pdf_s)


def _sample_area_mesh(data, tables, from_point, is_entering, u1, u2):
    """Uniform-triangle mesh emitter; triangles are rows
    [tri_offset, tri_offset+count) of the global soup."""
    radiance = data[:, 0:3]
    tri_offset = data[:, 3].to(torch.int32)
    tri_count = data[:, 4]
    ux = u1 * tri_count
    f = torch.minimum(ux.to(torch.int32), tri_count.to(torch.int32) - 1)
    bu, bv = sample_triangle(ux - f.to(torch.float32), u2)
    # lanes whose selected light is no mesh light carry another layout in
    # `data`: clamp the row so the (masked-out) gather stays in bounds
    ntri = tables["tri_v0"].shape[0]
    t = torch.clamp(tri_offset + f, 0, ntri - 1).long()
    v0 = tables["tri_v0"][t]
    e1 = tables["tri_e1"][t]
    e2 = tables["tri_e2"][t]
    nraw = cross(e1, e2)
    nlen = _safe_len(nraw)
    area = 0.5 * nlen
    face_n = nraw * safe_div(1.0, nlen)[..., None]
    inv_area = safe_div(1.0, area)
    p = v0 + e1 * bu[..., None] + e2 * bv[..., None]
    pdfv = inv_area / tri_count
    weight = tri_count / torch.where(inv_area == 0, torch.ones_like(inv_area),
                                     inv_area)

    dir_ = p - from_point
    dist = _safe_len(dir_)
    dirn = dir_ * safe_div(1.0, dist)[..., None]
    sgn = torch.where(is_entering, -1.0, 1.0).to(torch.float32)
    cos = dot(dirn, face_n) * sgn
    d2 = dist * dist
    return dict(dir=dirn, dist=dist, cos=cos, pos=p,
                intensity=radiance * weight[..., None],
                pdf_value=pdfv,
                pdf_solid=pdfv * safe_div(d2, torch.abs(cos)))


def _sample_area_sphere(data, from_point, is_entering, u1, u2):
    """Analytic sphere emitter: an equal-area point on the sphere, flipped to
    the half VISIBLE from the shading point; the area pdf is 2/area for that
    half."""
    radiance = data[:, 0:3]
    r = data[:, 3]
    c = data[:, 4:7]
    area = data[:, 8]
    nrm = equal_area_square_to_sphere(u1, u2)
    p = c + nrm * r[..., None]
    # if the center is closer than the sampled point, mirror the point
    # through the center
    os2 = torch.sum((from_point - c) ** 2, dim=-1)
    ps2 = torch.sum((from_point - p) ** 2, dim=-1)
    flip = (ps2 > os2)[..., None]
    p = torch.where(flip, 2.0 * c - p, p)
    nrm = torch.where(flip, -nrm, nrm)
    pdfv = safe_div(2.0, area)
    weight = area * 0.5
    dir_ = p - from_point
    dist = _safe_len(dir_)
    dirn = dir_ * safe_div(1.0, dist)[..., None]
    sgn = torch.where(is_entering, -1.0, 1.0).to(torch.float32)
    cos = dot(dirn, nrm) * sgn
    d2 = dist * dist
    return dict(dir=dirn, dist=dist, cos=cos, pos=p,
                intensity=radiance * weight[..., None],
                pdf_value=pdfv,
                pdf_solid=pdfv * safe_div(d2, torch.abs(cos)))


def _env_radiance(scene, tables, info, data, uv):
    """scale * radiance at env uv: the texture's for a textured env (the
    row's base holds the scale alone), else the constant."""
    base = data[0:3]
    if getattr(info, "tex", -1) >= 0:
        from ignis_tpu_torch.texture.eval import eval_one
        tex = eval_one(scene, tables, scene.textures[info.tex], uv)
        return tex * base
    return torch.broadcast_to(base, uv.shape[:-1] + (3,))


def _cie_wmean(cos_theta, c1, c2):
    a = torch.pow(cos_theta + 1.01, 10.0)
    a2 = a * a
    f1 = (a2 / (a2 + 1.0))[..., None]
    f2 = (1.0 / (a2 + 1.0))[..., None]
    return c1 * f1 + c2 * f2


def _no_ground(sky, cos_theta, v):
    if sky["has_ground"]:
        return v
    return torch.where((cos_theta < 0)[..., None], torch.zeros_like(v), v)


def _arccos_inside(c):
    # clamped strictly inside (-1, 1), as the JAX package does for its
    # backward pass
    return torch.arccos(clip(c, -1.0 + 1e-7, 1.0 - 1e-7))


def _env_func_eval(scene, tables, info, data, ldir):
    """Radiance of a LIGHT-space direction (the transform applied): the
    constant or textured env, or one of the sky models (CIE uniform /
    cloudy / clear / intermediate, Perez)."""
    sky = getattr(info, "sky", None)
    if sky is None:
        uv = map_env_uv(switch_env_up(ldir))
        return _env_radiance(scene, tables, info, data, uv)
    cos_theta = ldir[..., 1]  # env lights use Y as up
    kind = sky["kind"]
    if kind in ("cie_uniform", "cie_cloudy"):
        zenith = data[0:3]
        ground = data[12:15]
        gb = data[15]
        cloudy = kind == "cie_cloudy"
        c1 = ((1.0 + 2.0 * cos_theta) / 3.0 if cloudy
              else torch.ones_like(cos_theta))
        c2 = 0.777777777 if cloudy else 1.0
        v = _cie_wmean(cos_theta, zenith * c1[..., None],
                       torch.broadcast_to(ground * gb * c2, ldir.shape))
        return _no_ground(sky, cos_theta, v)
    if kind == "cie_sunny":
        # zenith * zb and ground * gb * c2 are folded into the row
        zcol = data[0:3]
        gcol = data[12:15]
        sun_dir = device_const(tuple(np.float32(sky["sun_dir"]).tolist()),
                               torch.float32, ldir.device)
        cos_gamma = clip(torch.sum(ldir * sun_dir, dim=-1), -1.0, 1.0)
        gamma = _arccos_inside(cos_gamma)
        if sky["is_clear"]:
            ok = cos_theta >= 0.01
            ct_safe = torch.where(ok, cos_theta, torch.ones_like(cos_theta))
            horiz = torch.where(ok, 1.0 - torch.exp(-0.32 / ct_safe),
                                torch.ones_like(cos_theta))
            c1 = (0.91 + 10.0 * torch.exp(-3.0 * gamma)
                  + 0.45 * cos_gamma * cos_gamma) * horiz
        else:
            theta = _arccos_inside(cos_theta)
            stheta = float(np.arccos(np.clip(sky["sun_dir"][1], -1.0, 1.0)))
            # a float64 factor, rounded to float32 as the JAX package's
            # array arithmetic rounds it
            s_fac = float(np.float32(np.sin(4.396 - 2.6 * stheta)))
            c1 = (((1.35 * torch.sin(5.631 - 3.59 * theta) + 3.12)
                   * s_fac + 6.37 - theta) / 2.326
                  * torch.exp(gamma * (-0.563)
                              * ((2.629 - theta) * (1.562 - stheta)
                                 + 0.812)))
        v = _cie_wmean(cos_theta, zcol * c1[..., None],
                       torch.broadcast_to(gcol, ldir.shape))
        return _no_ground(sky, cos_theta, v)
    if kind == "perez":
        # lum is folded with the diffuse normalisation in the row
        lum = data[0:3]
        ground = data[12:15]
        sun_dir = device_const(tuple(np.float32(sky["sun_dir"]).tolist()),
                               torch.float32, ldir.device)
        a, b, c, d, e = sky["abcde"]
        sun_c = clip(torch.sum(ldir * sun_dir, dim=-1), -1.0, 1.0)
        sun_a = _arccos_inside(sun_c)
        A = 1.0 + a * torch.exp(b / maximum(0.01, cos_theta))
        B = 1.0 + c * torch.exp(d * sun_a) + e * sun_c * sun_c
        fac = A * B
        v = _cie_wmean(cos_theta, lum * fac[..., None],
                       torch.broadcast_to(ground, ldir.shape))
        return _no_ground(sky, cos_theta, v)
    return torch.broadcast_to(data[0:3], ldir.shape)


def _is_hemi(info):
    sky = getattr(info, "sky", None)
    return bool(sky and sky.get("hemi", not sky.get("has_ground", True)))


def _sample_env(scene, tables, info, data, from_point, scene_radius, u1, u2):
    """Environment light: a cosine hemisphere around Y-up in light space for
    a sky without ground, else equal-area sphere sampling."""
    trans = data[3:12].reshape(3, 3)
    full = dict(dtype=torch.float32, device=u1.device)
    if _is_hemi(info):
        sz, pdf = sample_cosine_hemisphere(u1, u2)
        ld = switch_env_up(sz)                    # Y-up light direction
        intensity = (_env_func_eval(scene, tables, info, data, ld)
                     * safe_div(1.0, pdf)[..., None])
        gdir = ld @ trans
        return dict(dir=gdir, dist=torch.full(u1.shape, scene_radius, **full),
                    cos=torch.ones_like(u1),
                    pos=from_point + gdir * scene_radius,
                    intensity=intensity, pdf_value=pdf, pdf_solid=pdf)
    d = equal_area_square_to_sphere(u1, u2)
    pdf = torch.full_like(u1, equal_area_sphere_pdf())
    ldir = d @ trans.T
    intensity = (_env_func_eval(scene, tables, info, data, ldir)
                 * safe_div(1.0, pdf)[..., None])
    return dict(dir=d, dist=torch.full(u1.shape, scene_radius, **full),
                cos=torch.ones_like(u1),
                pos=from_point + d * scene_radius,
                intensity=intensity, pdf_value=pdf, pdf_solid=pdf)


def _env_pdf_dir(pdf_uv, dz):
    """uv-measure pdf -> solid angle."""
    return safe_div(pdf_uv, sin_theta_of(dz) * 2.0 * PI * PI)


def _sample_env_cdf(scene, tables, info, data, lid, from_point, scene_radius,
                    u1, u2):
    """Textured environment sampled by its 2D CDF."""
    pos, pdf = cdf2d_sample(tables[f"light{lid}_cdf_m"],
                            tables[f"light{lid}_cdf_c"], u1, u2)
    intensity = _env_radiance(scene, tables, info, data, pos)
    dz = uv_to_dir(pos)
    pdf_dir = _env_pdf_dir(pdf, dz)
    trans = data[3:12].reshape(3, 3)
    wdir = switch_env_up(dz) @ trans
    return dict(dir=wdir,
                dist=torch.full(u1.shape, scene_radius, dtype=torch.float32,
                                device=u1.device),
                cos=torch.ones_like(u1),
                pos=from_point + wdir * scene_radius,
                intensity=intensity * safe_div(1.0, pdf_dir)[..., None],
                pdf_value=pdf_dir, pdf_solid=pdf_dir)


def _merge(out, r, m):
    for k in out:
        out[k] = torch.where(m[..., None] if out[k].ndim == 2 else m,
                             r[k], out[k])


def sample_light_direct(scene, tables, light_idx, from_point, is_entering,
                        seed, counter, active):
    """Dispatch sample_direct over the per-lane selected light.

    Returns (sample dict incl. infinite/delta masks, counter).
    """
    types_present = sorted({l.type for l in scene.lights})
    light_type = gather_rows(tables["light_type"], light_idx)
    data = _ldata(tables, light_idx)
    scene_radius = scene.scene_radius() * 1.01
    dev = from_point.device

    max_draws = max([_LIGHT_DRAWS[t] for t in types_present] + [0])
    us = []
    c = counter
    for _ in range(max_draws):
        u, c = rng.next_f32(seed, c)
        us.append(u)
    while len(us) < 2:
        us.append(torch.zeros(counter.shape, dtype=torch.float32, device=dev))

    n = from_point.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    out = dict(dir=torch.zeros((n, 3), **f32), dist=torch.zeros(n, **f32),
               cos=torch.zeros(n, **f32), pos=torch.zeros((n, 3), **f32),
               intensity=torch.zeros((n, 3), **f32),
               pdf_value=torch.zeros(n, **f32),
               pdf_solid=torch.zeros(n, **f32))
    draws = torch.zeros(n, dtype=torch.int64, device=dev)

    for t in types_present:
        if t in (LIGHT_ENV, LIGHT_ENV_CDF):
            # env lights carry their own textures / CDF tables: addressed
            # per light id
            for lid, info in enumerate(scene.lights):
                if info.type != t:
                    continue
                ld = tables["light_data"][lid]
                if t == LIGHT_ENV:
                    r = _sample_env(scene, tables, info, ld, from_point,
                                    scene_radius, us[0], us[1])
                else:
                    r = _sample_env_cdf(scene, tables, info, ld, lid,
                                        from_point, scene_radius, us[0],
                                        us[1])
                m = light_idx == lid
                _merge(out, r, m)
                draws = torch.where(m, torch.full_like(draws, 2), draws)
            continue
        if t == LIGHT_SUN:
            r = _sample_sun(data, from_point, us[0], us[1])
        elif t == LIGHT_POINT:
            r = _sample_point(data, from_point)
        elif t == LIGHT_AREA_PLANE:
            r = _sample_area_plane(data, from_point, is_entering,
                                   us[0], us[1])
        elif t == LIGHT_AREA_MESH:
            r = _sample_area_mesh(data, tables, from_point, is_entering,
                                  us[0], us[1])
        elif t == LIGHT_AREA_SPHERE:
            r = _sample_area_sphere(data, from_point, is_entering,
                                    us[0], us[1])
        elif t == LIGHT_DIRECTIONAL:
            r = _sample_directional(data, from_point, scene_radius)
        else:  # LIGHT_SPOT
            r = _sample_spot(data, from_point)
        m = light_type == t
        _merge(out, r, m)
        draws = torch.where(m, torch.full_like(draws, _LIGHT_DRAWS[t]), draws)

    out["infinite"] = gather_rows(tables["light_infinite"], light_idx)
    out["delta"] = gather_rows(tables["light_delta"], light_idx)
    counter = torch.where(active, (counter + draws) & rng.M32, counter)
    return out, counter


# ---------------------------------------------------------- pdfs & emission

def light_pdf_direct_solid(scene, tables, light_idx, ray_org, ray_dir,
                           hit_dist, hit_cos, prim_coords, valid):
    """pdf of NEE-sampling the given light toward the hit point, in solid
    angle (what on_hit's MIS needs).  `prim_coords` are the hit barycentrics;
    the mesh branch reuses sample()'s uv -> triangle mapping on them, as the
    reference does."""
    types_present = sorted({l.type for l in scene.lights})
    light_type = gather_rows(tables["light_type"], light_idx)
    data = _ldata(tables, light_idx)
    out = torch.zeros_like(hit_dist)
    d2 = hit_dist * hit_dist
    for t in types_present:
        if t == LIGHT_AREA_PLANE:
            origin, ex, ey, nrm, width, height = _plane_axes(data)
            sq = _compute_sq(origin, ex, ey, nrm, width, height, ray_org)
            v = safe_div(1.0, sq["s"])
        elif t == LIGHT_AREA_MESH:
            tri_offset = data[:, 3].to(torch.int32)
            tri_count = data[:, 4]
            ux = prim_coords[..., 0] * tri_count
            f = torch.minimum(
                ux.to(torch.int32),
                torch.clamp_min(tri_count.to(torch.int32) - 1, 0))
            ntri = tables["tri_e1"].shape[0]
            tt = torch.clamp(tri_offset + f, 0, ntri - 1).long()
            e1 = tables["tri_e1"][tt]
            e2 = tables["tri_e2"][tt]
            area = 0.5 * length(cross(e1, e2))
            pdf_area = safe_div(1.0, area) / torch.clamp_min(tri_count, 1.0)
            v = pdf_area * safe_div(d2, torch.abs(hit_cos))
        elif t == LIGHT_AREA_SPHERE:
            # 2/area in area measure, over the visible half
            v = safe_div(2.0, data[:, 8]) * safe_div(d2, torch.abs(hit_cos))
        elif t == LIGHT_ENV:
            v = torch.full_like(hit_dist, equal_area_sphere_pdf())
        else:
            v = torch.ones_like(hit_dist)  # delta lights: never hit
        out = torch.where(light_type == t, v, out)
    return torch.where(valid, out, torch.zeros_like(out))


def env_emission_and_pdf(scene, tables, light_id, ray_dir):
    """Emission + pdf_direct (solid) of one infinite light for escaped rays.
    light_id is a static python int."""
    info = scene.lights[light_id]
    data = tables["light_data"][light_id]
    shape = ray_dir.shape[:-1]
    if info.type == LIGHT_ENV:
        ldir = ray_dir @ data[3:12].reshape(3, 3).T
        color = _env_func_eval(scene, tables, info, data, ldir)
        if _is_hemi(info):
            # black, and a cosine pdf, above the horizon only
            above = ldir[..., 1] > 1.1920929e-07
            color = torch.where(above[..., None], color,
                                torch.zeros_like(color))
            pdf = torch.where(above, cosine_hemisphere_pdf(ldir[..., 1]),
                              torch.zeros_like(ldir[..., 1]))
            return color, pdf
        pdf = torch.full(shape, equal_area_sphere_pdf(), dtype=torch.float32,
                         device=ray_dir.device)
        return color, pdf
    if info.type == LIGHT_ENV_CDF:
        ldir = switch_env_up(ray_dir @ data[3:12].reshape(3, 3).T)
        uv = map_env_uv(ldir)
        color = _env_radiance(scene, tables, info, data, uv)
        pdf_uv = cdf2d_pdf(tables[f"light{light_id}_cdf_m"],
                           tables[f"light{light_id}_cdf_c"], uv)
        return color, _env_pdf_dir(pdf_uv, ldir)
    # delta infinite lights (directional, sun) are never hit by chance
    return (torch.zeros(ray_dir.shape, dtype=torch.float32,
                        device=ray_dir.device),
            torch.zeros(shape, dtype=torch.float32, device=ray_dir.device))
