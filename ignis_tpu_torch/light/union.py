"""Batched light union: selection, direct sampling, pdfs and emission.

Counterpart of ignis_tpu/light/union.py for point, plane-area, mesh-area,
analytic-sphere and constant or textured (uniformly sampled) environment
lights with the uniform light selector.  Every branch
reports its pdf both raw (`pdf_value`) and converted to solid angle
(`pdf_solid`), which is what the path technique consumes.

Light parameter rows live in tables["light_data"] (N_lights, 32):
  POINT:       pos[0:3], intensity[3:6]
  AREA_PLANE:  origin[0:3], x_axis[3:6], y_axis[6:9], normal[9:12], area[12],
               radiance[13:16]
  AREA_MESH:   radiance[0:3], tri_offset[3], tri_count[4], entity[5]
  ENV:         radiance*scale[0:3] (the scale alone when textured),
               transform3x3[3:12]
  AREA_SPHERE: radiance[0:3], radius[3], world center[4:7], entity[7],
               total area 4*pi*r^2 [8]
"""

from __future__ import annotations

import torch

from ignis_tpu_torch.core import rng
from ignis_tpu_torch.core.dgather import gather_rows
from ignis_tpu_torch.core.vec import (
    PI, cross, dot, length, safe_div, signbit,
)
from ignis_tpu_torch.core.warp import (
    equal_area_sphere_pdf, equal_area_square_to_sphere, sample_triangle,
)
from ignis_tpu_torch.scene.compile import (
    LIGHT_AREA_MESH, LIGHT_AREA_PLANE, LIGHT_AREA_SPHERE, LIGHT_ENV,
    LIGHT_POINT,
)

_PORTED = (LIGHT_POINT, LIGHT_AREA_PLANE, LIGHT_AREA_MESH, LIGHT_ENV,
           LIGHT_AREA_SPHERE)

# draw counts per light type (sample_direct)
_LIGHT_DRAWS = {LIGHT_POINT: 0, LIGHT_AREA_PLANE: 2, LIGHT_AREA_MESH: 2,
                LIGHT_ENV: 2, LIGHT_AREA_SPHERE: 2}


def _check_ported(scene):
    for l in scene.lights:
        if l.type not in _PORTED:
            raise NotImplementedError(
                f"light type id {l.type} is not ported to ignis_tpu_torch "
                "yet")
        # a textured env without its CDF is LIGHT_ENV with `tex` set: in
        # the slice; the CDF variant is a type of its own
        if l.type == LIGHT_ENV and getattr(l, "sky", None) is not None:
            raise NotImplementedError(
                "sky environment lights are not ported to ignis_tpu_torch "
                "yet")


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
    """Selector dispatch; only `uniform` is ported.
    Returns (light_idx, select_pdf (per-lane), counter)."""
    kind = scene.technique.light_selector
    finite_ids = [i for i, l in enumerate(scene.lights) if not l.infinite]
    if (scene.num_lights > 1 and kind in ("simple", "cdf", "hierarchy")
            and finite_ids):
        raise NotImplementedError(
            f"light selector '{kind}' is not ported to ignis_tpu_torch yet")
    idx, pdf, counter = select_light_uniform(scene.num_lights, seed, counter,
                                             active)
    return idx, torch.full(counter.shape, pdf, dtype=torch.float32,
                           device=counter.device), counter


def light_select_pdf(scene, tables, light_idx, from_pos):
    """Per-lane pdf of the selector choosing `light_idx` (static table)."""
    if scene.technique.light_selector == "hierarchy":
        raise NotImplementedError(
            "light selector 'hierarchy' is not ported to ignis_tpu_torch yet")
    return gather_rows(tables["light_sel_pdf"], light_idx)


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


def _switch_env_up(v):
    """(x, y, z) <-> (x, z, y)."""
    return torch.stack([v[..., 0], v[..., 2], v[..., 1]], dim=-1)


def _map_env_uv(d):
    """Z-up direction -> env uv, with (0.5, 0.5) the Y-up direction."""
    theta = torch.acos(torch.clamp(d[..., 2], -1.0, 1.0))
    phi = torch.atan2(d[..., 1], d[..., 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * PI, phi)
    v = theta / PI
    u = phi / (2.0 * PI)
    return torch.stack([torch.remainder(u + 0.25, 1.0), 1.0 - v], dim=-1)


def _env_radiance(scene, tables, info, data, d):
    """scale * radiance seen along world directions `d`: the texture at the
    light-space direction's uv for a textured env, else the constant."""
    base = data[0:3]
    if getattr(info, "tex", -1) >= 0:
        from ignis_tpu_torch.texture.eval import eval_one
        trans = data[3:12].reshape(3, 3)
        uv = _map_env_uv(_switch_env_up(d @ trans.T))
        tex = eval_one(scene, tables, scene.textures[info.tex], uv)
        return tex * base  # base holds the scale for a textured env
    return torch.broadcast_to(base, d.shape)


def _sample_env(scene, tables, info, data, from_point, scene_radius, u1, u2):
    """Environment light: equal-area sphere sampling."""
    d = equal_area_square_to_sphere(u1, u2)
    pdf = torch.full_like(u1, equal_area_sphere_pdf())
    radiance = _env_radiance(scene, tables, info, data, d)
    intensity = radiance * safe_div(1.0, pdf)[..., None]
    return dict(dir=d, dist=torch.full_like(u1, scene_radius),
                cos=torch.ones_like(u1),
                pos=from_point + d * scene_radius,
                intensity=intensity, pdf_value=pdf, pdf_solid=pdf)


def _merge(out, r, m):
    for k in out:
        out[k] = torch.where(m[..., None] if out[k].ndim == 2 else m,
                             r[k], out[k])


def sample_light_direct(scene, tables, light_idx, from_point, is_entering,
                        seed, counter, active):
    """Dispatch sample_direct over the per-lane selected light.

    Returns (sample dict incl. infinite/delta masks, counter).
    """
    _check_ported(scene)
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
        if t == LIGHT_ENV:
            # env lights are addressed per light id
            for lid, info in enumerate(scene.lights):
                if info.type != t:
                    continue
                r = _sample_env(scene, tables, info,
                                tables["light_data"][lid], from_point,
                                scene_radius, us[0], us[1])
                m = light_idx == lid
                _merge(out, r, m)
                draws = torch.where(m, torch.full_like(draws, 2), draws)
            continue
        if t == LIGHT_POINT:
            r = _sample_point(data, from_point)
        elif t == LIGHT_AREA_PLANE:
            r = _sample_area_plane(data, from_point, is_entering,
                                   us[0], us[1])
        elif t == LIGHT_AREA_MESH:
            r = _sample_area_mesh(data, tables, from_point, is_entering,
                                  us[0], us[1])
        else:  # LIGHT_AREA_SPHERE
            r = _sample_area_sphere(data, from_point, is_entering,
                                    us[0], us[1])
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
    _check_ported(scene)
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
    _check_ported(scene)
    info = scene.lights[light_id]
    if info.type != LIGHT_ENV:
        raise NotImplementedError(
            f"infinite light type id {info.type} is not ported to "
            "ignis_tpu_torch yet")
    data = tables["light_data"][light_id]
    color = _env_radiance(scene, tables, info, data, ray_dir)
    pdf = torch.full(ray_dir.shape[:-1], equal_area_sphere_pdf(),
                     dtype=torch.float32, device=ray_dir.device)
    return color, pdf
