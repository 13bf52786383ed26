"""Single-intersection techniques: debug, ao, wireframe, lightvisibility,
camera_check, infobuffer.  Counterpart of ignis_tpu/render/techniques.py.

Each traces one closest hit a lane (camera rays, or a ray list) and shades
it; `ao` adds one any-hit ray.  Gathers that XLA clamps (the prim id table
for sphere and pool hits, whose ids lie past the soup, and the entity's
medium tables) clamp their index first here.
"""

from __future__ import annotations

import numpy as np
import torch

from ignis_tpu_torch.core import rng
from ignis_tpu_torch.core.vec import (
    FLT_MAX, cross, device_const, length, safe_div, to_world,
)
from ignis_tpu_torch.core.warp import sample_cosine_hemisphere

# DebugMode enum values in scene-name order
DEBUG_MODES = [
    "normal", "tangent", "bitangent", "geometric normal", "local normal",
    "local tangent", "local bitangent", "local geometric normal",
    "texture coords", "prim coords", "point", "local point",
    "generated coords", "hit distance", "area", "raw prim id", "prim id",
    "raw entity id", "entity id", "raw material id", "material id",
    "is emissive", "is specular", "is entering", "check bsdf", "albedo",
    "medium inner", "medium outer",
]

# the debug tracer's color map, one entry per id mod 23
_COLOR_MAP = np.array([
    [0.450000, 0.376630, 0.112500], [0.112500, 0.450000, 0.405978],
    [0.112500, 0.450000, 0.229891], [0.450000, 0.112500, 0.376630],
    [0.435326, 0.450000, 0.112500], [0.112500, 0.141848, 0.450000],
    [0.435326, 0.112500, 0.450000], [0.112500, 0.450000, 0.141848],
    [0.347283, 0.450000, 0.112500], [0.450000, 0.112500, 0.200543],
    [0.112500, 0.229891, 0.450000], [0.450000, 0.288587, 0.112500],
    [0.347283, 0.112500, 0.450000], [0.450000, 0.112500, 0.288587],
    [0.450000, 0.112500, 0.112500], [0.450000, 0.200543, 0.112500],
    [0.171196, 0.450000, 0.112500], [0.112500, 0.450000, 0.317935],
    [0.259239, 0.450000, 0.112500], [0.259239, 0.112500, 0.450000],
    [0.112500, 0.405978, 0.450000], [0.171196, 0.112500, 0.450000],
    [0.112500, 0.317935, 0.450000],
], np.float32)

_GREEN = (0.0, 1.0, 0.0)
_RED = (1.0, 0.0, 0.0)


def _color_map(ids):
    table = device_const(tuple(map(tuple, _COLOR_MAP.tolist())),
                         torch.float32, ids.device)
    return table[(ids % 23).long()]


def _clamped(table, idx):
    """`table[idx]` with the index clamped into range, as XLA gathers."""
    return table[torch.clamp(idx.long(), 0, table.shape[0] - 1)]


def _first_hit(scene, tables, x, y, sample, iteration, frame, user_seed,
               org, direction, tmin, tmax):
    """Camera (or list) rays, their closest hits under the camera mask and
    the hit surfaces.  Returns (seed, counter, org, dir, t, u, v, hit,
    prim_s, surf)."""
    from ignis_tpu_torch.render.integrator import (
        _emit_camera, _surface_at, _traverse_closest,
    )
    n = x.shape[0]
    dev = x.device
    if org is None:
        seed, counter, org, direction, tmin, tmax = _emit_camera(
            scene, x, y, sample, iteration, frame, user_seed, tables)
    else:
        seed = rng.create_seed(sample, iteration, frame, x, y, user_seed)
        counter = torch.ones_like(seed)
        f32 = dict(dtype=torch.float32, device=dev)
        tmin = torch.broadcast_to(torch.as_tensor(tmin, **f32), (n,))
        tmax = torch.broadcast_to(torch.as_tensor(tmax, **f32), (n,))
    t, u, v, prim = _traverse_closest(scene, tables, org, direction, tmin,
                                      tmax, None, mask_bit=0x1)
    hit = prim >= 0
    prim_s = torch.clamp_min(prim, 0)
    surf = _surface_at(tables, prim_s, org, direction, t, u, v)
    return seed, counter, org, direction, t, u, v, hit, prim_s, surf


def simple_technique_wave(scene, tables, x, y, sample, iteration, frame,
                          user_seed, org=None, direction=None, tmin=None,
                          tmax=None):
    """One-intersection techniques; returns per-lane color (N, 3)."""
    from ignis_tpu_torch.bsdf import bsdf_specular_mask
    from ignis_tpu_torch.bsdf.union import material_params
    from ignis_tpu_torch.render.integrator import (
        OFFSET, _gather_mat_type, _traverse_any,
    )

    tech = scene.technique
    n = x.shape[0]
    seed, counter, org, direction, t, u, v, hit, prim_s, surf = _first_hit(
        scene, tables, x, y, sample, iteration, frame, user_seed, org,
        direction, tmin, tmax)
    dev = t.device
    f32 = dict(dtype=torch.float32, device=dev)
    black = torch.zeros((n, 3), **f32)
    hit3 = hit[..., None]

    def flag_color(mask):
        return torch.where(mask[..., None],
                           device_const(_GREEN, torch.float32, dev),
                           device_const(_RED, torch.float32, dev))

    if tech.type == "ao":
        # one cosine-hemisphere occlusion ray
        u1, counter = rng.next_f32(seed, counter)
        u2, counter = rng.next_f32(seed, counter)
        local, _pdf = sample_cosine_hemisphere(u1, u2)
        gdir = to_world(local, surf["t"], surf["b"], surf["n"])
        occ = _traverse_any(scene, tables, surf["point"], gdir,
                            torch.full((n,), OFFSET, **f32),
                            torch.full((n,), FLT_MAX, **f32), None)
        return (hit & ~occ).to(torch.float32)[..., None].expand(n, 3)

    if tech.type == "wireframe":
        # edge detection on the first hit
        from ignis_tpu_torch.render.camera import camera_frame
        right, up, _ = camera_frame(scene.camera, dev)
        sw, sh = float(scene.camera.scale[0]), float(scene.camera.scale[1])
        footprint_u = length(cross(right * sw, up * sh))
        edge_t = torch.minimum(torch.minimum(u, v),
                               torch.clamp(1.0 - u - v, 0.0, 1.0))
        footprint = t * footprint_u
        cond = 0.01 * footprint * torch.sqrt(
            torch.clamp_min(surf["inv_area"], 0.0))
        is_edge = hit & (edge_t <= cond)
        shade = torch.clamp(1.0 - edge_t, 0.0, 1.0)
        return torch.where(is_edge[..., None], shade[..., None], black)

    if tech.type in ("lightvisibility", "camera_check"):
        # a plain hit check
        return hit.to(torch.float32)[..., None].expand(n, 3).contiguous()

    if tech.type == "infobuffer":
        # the framebuffer gets the shading normals; AOVs come separately
        return torch.where(hit3, torch.abs(surf["n"]), black)

    # ---- debug
    mode = tech.debug_mode if tech.debug_mode in DEBUG_MODES else "normal"
    mat_type = _gather_mat_type(scene, tables, surf["mat_id"])
    zeros = torch.zeros_like(u)
    if mode == "normal":
        val = torch.abs(surf["n"])
    elif mode == "tangent":
        val = torch.abs(surf["t"])
    elif mode == "bitangent":
        val = torch.abs(surf["b"])
    elif mode == "geometric normal":
        val = torch.abs(surf["ng"])
    elif mode == "texture coords":
        val = torch.cat([torch.abs(surf["tex"]), zeros[..., None]], dim=-1)
    elif mode == "prim coords":
        val = torch.stack([torch.abs(u), torch.abs(v), zeros], dim=-1)
    elif mode == "point":
        val = surf["point"]
    elif mode == "hit distance":
        val = t[..., None].expand(n, 3)
    elif mode == "area":
        val = safe_div(1.0, torch.clamp_min(surf["inv_area"], 1e-20))[
            ..., None].expand(n, 3)
    elif mode in ("raw prim id", "prim id"):
        pid = _clamped(tables["tri_prim"], prim_s)
        val = (_color_map(pid) if mode == "prim id"
               else pid.to(torch.float32)[..., None].expand(n, 3))
    elif mode in ("raw entity id", "entity id"):
        eid = surf["ent"]
        val = (_color_map(eid) if mode == "entity id"
               else eid.to(torch.float32)[..., None].expand(n, 3))
    elif mode in ("raw material id", "material id"):
        mid = surf["mat_id"]
        val = (_color_map(mid) if mode == "material id"
               else mid.to(torch.float32)[..., None].expand(n, 3))
    elif mode == "is emissive":
        val = flag_color(surf["light_id"] >= 0)
    elif mode == "is specular":
        val = flag_color(bsdf_specular_mask(scene.bsdf_types, mat_type))
    elif mode == "is entering":
        val = flag_color(surf["is_entering"])
    elif mode == "albedo":
        val = material_params(scene, tables, surf)[0][:, 0]
    elif mode in ("medium inner", "medium outer"):
        key = ("ent_inner_medium" if mode == "medium inner"
               else "ent_outer_medium")
        mid = _clamped(tables[key], surf["ent"])
        val = torch.where((mid >= 0)[..., None],
                          _color_map(torch.clamp_min(mid, 0)), black)
    else:
        # the modes without a branch of their own
        val = torch.abs(surf["n"])
    return torch.where(hit3, val, black)


def infobuffer_aovs(scene, tables, x, y, sample, iteration, frame, user_seed):
    """Normals / albedo / depth AOVs of the camera rays' first hits (the
    denoiser's guides)."""
    from ignis_tpu_torch.bsdf.union import material_params
    n = x.shape[0]
    _, _, _, _, t, _, _, hit, _, surf = _first_hit(
        scene, tables, x, y, sample, iteration, frame, user_seed, None, None,
        None, None)
    colors, _ = material_params(scene, tables, surf)
    zero = torch.zeros((n, 3), dtype=torch.float32, device=t.device)
    hit3 = hit[..., None]
    return {
        "Normals": torch.where(hit3, surf["n"], zero),
        "Albedo": torch.where(hit3, colors[:, 0], zero),
        "Depth": torch.where(hit, t, torch.zeros_like(t)),
    }
