"""Light emission sampling: the starting points of light paths and photons.
Counterpart of ignis_tpu/light/emission.py.

`sample_light_emission` samples an outgoing ray (position, direction,
intensity, cosine) on each lane's selected light, for every light type:
point, plane / mesh / sphere area lights, directional, spot, sun, and the
environments (uniform and CDF-sampled, both emitted along a uniform
equal-area direction).  Every active lane takes exactly four draws whatever
its light's type, so the counters stay aligned across the union.

`intensity` is already divided by the position and direction pdfs.  `le_area`
(the radiance over the area pdf; 0 for delta and infinite emitters) and `nrm`
(the emitting face's normal) serve the light tracer's depth-0 camera
connection.

The reference package loops over the lights one by one; here the lanes of
every finite light type are computed at once from their gathered
`light_data` rows (the same arithmetic on the same values, so the same
floats), and the environments, which carry their own images, one light at a
time.  A scene with 256 spots then costs one spot evaluation, not 256.
"""

from __future__ import annotations

import numpy as np
import torch

from ignis_tpu_torch.core import rng
from ignis_tpu_torch.core.dgather import gather_rows
from ignis_tpu_torch.core.vec import (
    PI, cross, length, orthonormal_basis, safe_div, to_int32, to_world,
)
from ignis_tpu_torch.core.warp import (
    sample_cosine_hemisphere, sample_equal_area_sphere, sample_triangle,
    sample_uniform_cone, sample_uniform_sphere, square_to_concentric_disk,
)
from ignis_tpu_torch.light.union import env_emission_and_pdf
from ignis_tpu_torch.scene.compile import (
    LIGHT_AREA_MESH, LIGHT_AREA_PLANE, LIGHT_AREA_SPHERE, LIGHT_DIRECTIONAL,
    LIGHT_ENV, LIGHT_ENV_CDF, LIGHT_POINT, LIGHT_SPOT,
)

_ENV_TYPES = (LIGHT_ENV, LIGHT_ENV_CDF)


def _env_sample_pos(u1, u2, out_dir, center, radius):
    """A position on the scene-bounding disk behind an infinite light, and
    its pdf; `out_dir` points toward the light.  `center` is a (3,) tensor,
    `radius` a float holding a float32 value."""
    x, y = square_to_concentric_disk(u1, u2)
    t, b = orthonormal_basis(out_dir)
    pos = (center + out_dir * radius
           + t * (x * radius)[..., None] + b * (y * radius)[..., None])
    r32 = np.float32(radius)
    pdf = np.float32(1.0) / (np.float32(PI) * r32 * r32)
    return pos, torch.full_like(u1, float(pdf))


def _emit_type(t, data, tables, u, n, center, radius):
    """One finite light type's emission on all lanes, from their gathered
    (N, 32) `data` rows.  Returns (pos, dir, intensity, cos, le_area, nrm)."""
    u1, u2, u3, u4 = u
    dev = u1.device
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    zeros3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    if t == LIGHT_POINT:
        sd, sp = sample_uniform_sphere(u1, u2)
        i_l = data[:, 3:6] * safe_div(1.0, sp)[..., None]
        return data[:, 0:3], sd, i_l, ones, zeros3, sd
    if t == LIGHT_AREA_PLANE:
        origin, xa, ya, nrm = (data[:, 0:3], data[:, 3:6], data[:, 6:9],
                               data[:, 9:12])
        area, radiance = data[:, 12], data[:, 13:16]
        p_l = origin + xa * u1[..., None] + ya * u2[..., None]
        local, cpdf = sample_cosine_hemisphere(u3, u4)
        tt, bb = orthonormal_basis(nrm)
        sd = to_world(local, tt, bb, nrm)
        i_l = radiance * safe_div(area, cpdf)[..., None]
        return p_l, sd, i_l, local[..., 2], radiance * area[..., None], nrm
    if t == LIGHT_AREA_MESH:
        radiance = data[:, 0:3]
        toff = to_int32(data[:, 3])
        tcount = data[:, 4]
        ux = u1 * tcount
        f = torch.minimum(to_int32(ux), to_int32(tcount) - 1)
        bu, bv = sample_triangle(ux - f.to(torch.float32), u2)
        # lanes of other types carry another layout: clamp the masked rows
        ti = torch.clamp(toff + f, 0, tables["tri_v0"].shape[0] - 1).long()
        v0, e1, e2 = tables["tri_v0"][ti], tables["tri_e1"][ti], \
            tables["tri_e2"][ti]
        nraw = cross(e1, e2)
        nlen = torch.clamp_min(length(nraw), 1e-20)
        fn = nraw / nlen[..., None]
        pdfv = safe_div(1.0, 0.5 * nlen) / torch.clamp_min(tcount, 1.0)
        p_l = v0 + e1 * bu[..., None] + e2 * bv[..., None]
        local, cpdf = sample_cosine_hemisphere(u3, u4)
        tt, bb = orthonormal_basis(fn)
        sd = to_world(local, tt, bb, fn)
        i_l = radiance * safe_div(1.0, pdfv * cpdf)[..., None]
        return p_l, sd, i_l, local[..., 2], i_l * cpdf[..., None], fn
    if t == LIGHT_AREA_SPHERE:
        radiance, r_s, c_s, area_s = (data[:, 0:3], data[:, 3], data[:, 4:7],
                                      data[:, 8])
        outward, _ = sample_equal_area_sphere(u1, u2)
        p_l = c_s + outward * r_s[..., None]
        local, cpdf = sample_cosine_hemisphere(u3, u4)
        tt, bb = orthonormal_basis(outward)
        sd = to_world(local, tt, bb, outward)
        pdfv = safe_div(1.0, area_s)
        i_l = radiance * safe_div(1.0, pdfv * cpdf)[..., None]
        return p_l, sd, i_l, local[..., 2], i_l * cpdf[..., None], outward
    if t == LIGHT_DIRECTIONAL:
        prop = data[:, 0:3]   # the way the light travels, into the scene
        p_l, ppdf = _env_sample_pos(u1, u2, -prop, center, radius)
        i_l = data[:, 3:6] * safe_div(1.0, ppdf)[..., None]
        return p_l, prop, i_l, ones, zeros3, prop
    if t == LIGHT_SPOT:
        axis = data[:, 3:6]
        cos_cut, cos_fall = data[:, 9], data[:, 10]
        local, _ = sample_uniform_cone(u1, u2, cos_cut)
        tt, bb = orthonormal_basis(axis)
        sd = to_world(local, tt, bb, axis)
        blend = cos_fall - cos_cut
        ca = local[..., 2]
        s = torch.clamp(safe_div(ca - cos_cut, blend), 0.0, 1.0)
        smooth = s * s * (3.0 - 2.0 * s)
        hard = torch.where(ca <= cos_cut, torch.zeros_like(ca),
                           torch.ones_like(ca))
        fall = torch.where(blend <= 1e-6, hard, smooth)
        # the spot's area times its uniform cone pdf is 1
        return data[:, 0:3], sd, data[:, 6:9] * fall[..., None], ca, zeros3, sd
    # LIGHT_SUN: a direction in the sun's cone, a position on the disk
    sdir = data[:, 0:3]   # toward the sun
    local, cpdf = sample_uniform_cone(u1, u2, data[:, 9])
    tt, bb = orthonormal_basis(sdir)
    outward = to_world(local, tt, bb, sdir)
    p_l, ppdf = _env_sample_pos(u3, u4, outward, center, radius)
    i_l = data[:, 3:6] * safe_div(1.0, ppdf * cpdf)[..., None]
    return p_l, -outward, i_l, ones, zeros3, -outward


def sample_light_emission(scene, tables, light_idx, seed, counter, active):
    """Sample an outgoing ray on each lane's light `light_idx` (global ids).

    Returns (dict(pos, dir, intensity, cos, infinite, le_area, nrm), counter);
    the counter of every active lane moves by four."""
    n = light_idx.shape[0]
    dev = light_idx.device
    u1, c = rng.next_f32(seed, counter)
    u2, c = rng.next_f32(seed, c)
    u3, c = rng.next_f32(seed, c)
    u4, c = rng.next_f32(seed, c)
    counter = torch.where(active, c, counter)
    u = (u1, u2, u3, u4)

    center = torch.as_tensor(np.asarray(scene.scene_center(), np.float32),
                             device=dev)
    radius = float(np.float32(scene.scene_radius()))

    f32 = dict(dtype=torch.float32, device=dev)
    pos = torch.zeros((n, 3), **f32)
    d = torch.cat([torch.zeros((n, 2), **f32), torch.ones((n, 1), **f32)], 1)
    inten = torch.zeros((n, 3), **f32)
    cos = torch.ones(n, **f32)
    infinite = torch.zeros(n, dtype=torch.bool, device=dev)
    le_area = torch.zeros((n, 3), **f32)
    nrm = torch.zeros((n, 3), **f32)

    def merge(m, out):
        nonlocal pos, d, inten, cos, le_area, nrm
        p_l, sd, i_l, c_l, la, ln = out
        mc = m[..., None]
        pos = torch.where(mc, p_l, pos)
        d = torch.where(mc, sd, d)
        inten = torch.where(mc, i_l, inten)
        cos = torch.where(m, c_l, cos)
        le_area = torch.where(mc, la, le_area)
        nrm = torch.where(mc, ln, nrm)

    types = sorted({l.type for l in scene.lights} - set(_ENV_TYPES))
    if types:
        data = gather_rows(tables["light_data"], light_idx)
        ltype = gather_rows(tables["light_type"], light_idx)
        for t in types:
            merge(ltype == t,
                  _emit_type(t, data, tables, u, n, center, radius))
    for lid, info in enumerate(scene.lights):
        if info.type not in _ENV_TYPES:
            continue
        # an equal-area direction, a position on the disk behind it; the
        # CDF-sampled environment takes the same estimator here
        outward, dpdf = sample_equal_area_sphere(u1, u2)
        rad, _ = env_emission_and_pdf(scene, tables, lid, outward)
        p_l, ppdf = _env_sample_pos(u3, u4, outward, center, radius)
        i_l = rad * safe_div(1.0, ppdf * dpdf)[..., None]
        ones = torch.ones(n, **f32)
        merge(light_idx == lid, (p_l, -outward, i_l, ones,
                                 torch.zeros((n, 3), **f32), -outward))
    if scene.lights:
        infinite = gather_rows(tables["light_infinite"], light_idx)
    return dict(pos=pos, dir=d, intensity=inten, cos=cos, infinite=infinite,
                le_area=le_area, nrm=nrm), counter
