"""The light tracer technique.  Counterpart of
ignis_tpu/render/lighttracer.py.

Paths start on the lights (`light.emission`), bounce through the scene, and at
every non-specular vertex connect to the camera: an occlusion ray toward the
eye and a splat at the projected pixel.  The emission vertex itself is
connected too (the depth-0 splat), so that directly visible area lights
render; the reference renderer drops that vertex, the JAX package keeps it.

The `n_paths` paths of a step are traced in tiles of `tile` lanes.  A lane's
seed is built from its path index alone, so every lane traces the JAX
package's path; only the order of the splat's sums differs (`index_add_`
into the (npix, 3) framebuffer, atomic on the card).  Every tile runs
`max_depth` bounces, a fixed loop with no host sync, as the JAX package's
`fori_loop` does.

As in the JAX package, the BSDF is sampled in radiance convention (no
adjoint eta^2 factor on refraction); the camera connection evaluates it in
adjoint order, the light-side direction passed as `in`.
"""

from __future__ import annotations

import torch

from ignis_tpu_torch.bsdf import bsdf_eval, bsdf_sample, prepare_surface
from ignis_tpu_torch.core import rng
from ignis_tpu_torch.core.vec import (
    FLT_EPS, FLT_MAX, dot, normalize, safe_div, to_int32,
)
from ignis_tpu_torch.light import select_light
from ignis_tpu_torch.light.emission import sample_light_emission
from ignis_tpu_torch.render.camera import sample_pixel
from ignis_tpu_torch.render.integrator import (
    OFFSET, RAY_BOUNCE, RAY_SHADOW, _flags_trivial, _handle_color,
    _surface_at, _traverse_any, _traverse_closest, _tri_mask_for,
)


def path_lanes(start, tile, total, dev):
    """The lane indices of one tile, [start, start + tile), and the mask of
    those below `total` (a last tile's padding lanes are inactive)."""
    idx = torch.arange(start, start + tile, dtype=torch.int64, device=dev)
    return idx, idx < total


def film_pixel(cs, w, h):
    """Row of the (npix, 3) framebuffer that a camera connection `cs`
    (`camera.sample_pixel`) lands on; the float -> int cast saturates as
    XLA's does."""
    px = torch.clamp(to_int32((cs["nx"] + 1.0) * 0.5 * w), 0, w - 1)
    py = torch.clamp(to_int32((1.0 - cs["ny"]) * 0.5 * h), 0, h - 1)
    return (py * w + px).long()


def _shadow_ray(scene, tables, org, d, mask):
    """Any hit on the segment org -> org + d (the camera connection)."""
    n = org.shape[0]
    f32 = dict(dtype=torch.float32, device=org.device)
    return _traverse_any(scene, tables, org, d,
                         torch.full((n,), OFFSET, **f32),
                         torch.full((n,), 1.0 - OFFSET, **f32), mask)


def _trace_tile(scene, tables, idx, active, iteration, frame, user_seed, fb):
    """Trace the light paths of one tile and splat into `fb` in place."""
    tech = scene.technique
    w, h = scene.width, scene.height
    npix = w * h
    n = idx.shape[0]
    dev = idx.device
    f32 = dict(dtype=torch.float32, device=dev)
    clamp = tech.clamp

    seed = rng.create_seed(idx // npix, iteration, frame, idx % w,
                           (idx // w) % h, user_seed)
    counter = torch.ones_like(seed)
    lsel, sel_pdf, counter = select_light(scene, tables, seed, counter,
                                          active)
    em, counter = sample_light_emission(scene, tables, lsel, seed, counter,
                                        active)
    contrib = em["intensity"] * safe_div(torch.abs(em["cos"]),
                                         sel_pdf)[..., None]
    org, d = em["pos"], em["dir"]
    tmin = torch.where(em["infinite"], torch.zeros(n, **f32),
                       torch.full((n,), OFFSET, **f32))

    trav_mask = (None if _flags_trivial(scene)
                 else _tri_mask_for(tables, RAY_BOUNCE))
    shadow_mask = (None if _flags_trivial(scene, RAY_SHADOW)
                   else _tri_mask_for(tables, RAY_SHADOW))
    zeros3 = torch.zeros((n, 3), **f32)

    # depth 0: the emission vertex seen by the camera
    cs0 = sample_pixel(scene.camera, org)
    cos_e = dot(normalize(cs0["dir"]), em["nrm"])
    has_le = torch.amax(em["le_area"], dim=-1) > 0.0
    can0 = (active & ~em["infinite"] & has_le & cs0["valid"]
            & (cos_e > FLT_EPS))
    d2_0 = torch.clamp_min(dot(cs0["dir"], cs0["dir"]), 1e-12)
    occ0 = _shadow_ray(scene, tables, org, cs0["dir"], shadow_mask)
    splat0 = _handle_color(
        em["le_area"] * safe_div(1.0, sel_pdf)[..., None]
        * (cs0["weight"] * cos_e / d2_0)[..., None], clamp)
    fb.index_add_(0, film_pixel(cs0, w, h),
                  torch.where((can0 & ~occ0)[..., None], splat0, zeros3))

    alive = active
    eta = torch.ones(n, **f32)
    tmax = torch.full((n,), FLT_MAX, **f32)
    for depth in range(1, tech.max_depth + 1):
        t, u, v, prim = _traverse_closest(scene, tables, org, d, tmin, tmax,
                                          trav_mask)
        hit = alive & (prim >= 0)
        t_safe = torch.where(hit, t, torch.ones_like(t))
        surf = _surface_at(tables, torch.clamp_min(prim, 0), org, d, t_safe,
                           u, v)
        mat_type, specular = prepare_surface(scene, tables, surf, d, org)
        out_dir = -d
        more = depth + 1 <= tech.max_depth

        # the camera connection
        cs = sample_pixel(scene.camera, surf["point"])
        in_dir = normalize(cs["dir"])
        cos_o = dot(out_dir, surf["n"])
        cos_i = dot(in_dir, surf["n"])
        can_connect = (hit & ~specular & cs["valid"]
                       & (cos_o * cos_i > FLT_EPS) & more)
        d2 = torch.clamp_min(dot(cs["dir"], cs["dir"]), 1e-12)
        factor = safe_div(cos_i, cos_o * d2)
        # adjoint order: the light-side direction is `in`, so the eval's
        # cosine is cos_o, and `factor` turns it into cos_i / d^2
        f = bsdf_eval(scene, tables, mat_type, surf, out_dir, in_dir)
        splat = _handle_color(contrib * f * (cs["weight"] * factor)[..., None],
                              clamp)
        occ = _shadow_ray(scene, tables, surf["point"], cs["dir"],
                          shadow_mask)
        fb.index_add_(0, film_pixel(cs, w, h),
                      torch.where((can_connect & ~occ)[..., None], splat,
                                  zeros3))

        # the bounce; russian roulette with no minimum depth
        can_bounce = hit & more
        bdir, _pdf, b_weight, b_eta, b_valid, counter = bsdf_sample(
            scene, tables, mat_type, surf, seed, counter, out_dir,
            active=can_bounce)
        new_contrib = contrib * b_weight
        drew = can_bounce & b_valid
        eta = eta * torch.where(drew, b_eta, torch.ones_like(b_eta))
        rr = torch.where(specular, torch.ones_like(eta), torch.clamp(
            torch.amax(new_contrib * (eta * eta)[..., None], dim=-1),
            0.05, 0.95))
        u_rr, c_rr = rng.next_f32(seed, counter)
        counter = torch.where(drew, c_rr, counter)
        alive = drew & (u_rr < rr)
        an = alive[..., None]
        org = torch.where(an, surf["point"], org)
        d = torch.where(an, bdir, d)
        tmin = torch.full((n,), OFFSET, **f32)
        contrib = torch.where(an, new_contrib * safe_div(1.0, rr)[..., None],
                              contrib)


def render_lighttracer(scene, tables, n_paths, iteration, frame, user_seed,
                       tile=1 << 16):
    """Trace `n_paths` light paths in tiles of `tile` lanes; returns the
    unnormalised framebuffer sum (npix, 3) of this iteration.  `iteration`,
    `frame` and `user_seed` are Python ints."""
    npix = scene.width * scene.height
    dev = tables["tri_v0"].device
    fb = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    tile = int(min(tile, n_paths))
    for start in range(0, n_paths, tile):
        idx, active = path_lanes(start, tile, n_paths, dev)
        _trace_tile(scene, tables, idx, active, iteration, frame, user_seed,
                    fb)
    return fb
