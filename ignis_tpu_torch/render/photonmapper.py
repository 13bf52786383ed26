"""Progressive photon mapping.  Counterpart of
ignis_tpu/render/photonmapper.py.

Two passes an iteration:

1. The photon pass (`trace_photons`): photons start on the lights, bounce
   only through specular surfaces and are stored at their first diffuse
   vertex (LS*D paths).  A fixed photon count, traced in tiles of lanes.
2. The camera pass (`render_ppm`): a path tracer without NEE that gathers the
   stored photons at every diffuse vertex within a progressively shrinking
   radius, weighted by the Simpson kernel; emitters and the environment
   count only on specular-only camera paths.

The photon map (`build_photon_grid`) sorts the photons by their cell of a
GRID^3 grid over the scene's bounds (a stable sort, as the JAX package's);
a gather looks up each of the 3x3x3 cells around a point by two binary
searches and reads at most CELL_CAP photons of each.  Photons past the cap
in a crowded cell are left out of the estimate, as in the JAX package.

`gather_photons` reads a cell's CELL_CAP slots of every lane at once: one
batched BSDF evaluation on the lanes x CELL_CAP (lane, photon) pairs a cell,
27 a camera bounce, reduced over the slot axis with no host sync (the JAX
package folds the slots one by one; the sums differ in order within a cell
only).
"""

from __future__ import annotations

import numpy as np
import torch

from ignis_tpu_torch.bsdf import bsdf_eval, bsdf_sample, prepare_surface
from ignis_tpu_torch.core import rng
from ignis_tpu_torch.core.vec import (
    FLT_EPS, FLT_MAX, device_const, dot, safe_div, to_int32,
)
from ignis_tpu_torch.light import env_emission_and_pdf, select_light
from ignis_tpu_torch.light.emission import sample_light_emission
from ignis_tpu_torch.render.integrator import (
    OFFSET, RAY_BOUNCE, _area_light_radiance, _emit_camera, _flags_trivial,
    _handle_color, _surface_at, _traverse_closest, _tri_mask_for,
)
from ignis_tpu_torch.render.lighttracer import path_lanes

GRID = 32          # cells of the photon grid per axis
CELL_CAP = 64      # photons read of each cell by a gather
# (lane, photon) pairs of one batched BSDF evaluation: a cell's gather on
# more lanes than GATHER_PAIRS / CELL_CAP (65,536 at these values, one
# camera tile) runs in chunks of that many lanes
GATHER_PAIRS = 1 << 22


def ppm_compute_radius(max_radius: float, it: int) -> float:
    """The progressive radius of iteration `it` (host floats)."""
    contract = 0.8
    r = max_radius
    for i in range(it):
        r *= (i + 1 + contract) / (i + 2)
    return max(r, 1e-5)


def _cell_of(pos, bbox_min, inv_ext):
    q = torch.clamp((pos - bbox_min) * inv_ext * 0.99, 0.0, 0.999999)
    return to_int32(q * GRID)


def _cell_id(idx):
    return (idx[..., 2] * GRID + idx[..., 1]) * GRID + idx[..., 0]


def _trace_photon_tile(scene, tables, idx, active, iteration, frame,
                       user_seed):
    tech = scene.technique
    w = scene.width
    n = idx.shape[0]
    dev = idx.device
    f32 = dict(dtype=torch.float32, device=dev)

    # photon ids hash like pixel work: sample 0, x = id % w, y = id // w
    seed = rng.create_seed(0, iteration, frame, idx % w, idx // w, user_seed)
    counter = torch.ones_like(seed)
    lsel, sel_pdf, counter = select_light(scene, tables, seed, counter,
                                          active)
    em, counter = sample_light_emission(scene, tables, lsel, seed, counter,
                                        active)
    contrib = em["intensity"] * safe_div(torch.abs(em["cos"]),
                                         sel_pdf)[..., None]
    trav_mask = (None if _flags_trivial(scene)
                 else _tri_mask_for(tables, RAY_BOUNCE))

    org, d = em["pos"], em["dir"]
    tmin = torch.where(em["infinite"], torch.zeros(n, **f32),
                       torch.full((n,), OFFSET, **f32))
    tmax = torch.full((n,), FLT_MAX, **f32)
    alive = active
    p_pos = torch.zeros((n, 3), **f32)
    p_dir = torch.zeros((n, 3), **f32)
    p_pow = torch.zeros((n, 3), **f32)
    p_depth = torch.zeros(n, dtype=torch.int32, device=dev)
    p_valid = torch.zeros(n, dtype=torch.bool, device=dev)
    max_light_depth = min(tech.max_light_depth, tech.max_depth)
    for depth in range(1, max_light_depth + 1):
        t, u, v, prim = _traverse_closest(scene, tables, org, d, tmin, tmax,
                                          trav_mask)
        hit = alive & (prim >= 0)
        surf = _surface_at(tables, torch.clamp_min(prim, 0), org, d,
                           torch.where(hit, t, torch.ones_like(t)), u, v)
        mat_type, specular = prepare_surface(scene, tables, surf, d, org)
        emissive = surf["light_id"] >= 0
        out_dir = -d
        cos_o = dot(out_dir, surf["n"])

        # store at the first diffuse vertex
        store = hit & ~emissive & ~specular & (cos_o > FLT_EPS) & ~p_valid
        sc = store[..., None]
        p_pos = torch.where(sc, surf["point"], p_pos)
        p_dir = torch.where(sc, out_dir, p_dir)
        p_pow = torch.where(sc, contrib, p_pow)
        p_depth = torch.where(store, torch.full_like(p_depth, depth), p_depth)
        p_valid = p_valid | store

        # go on only through specular surfaces
        can_bounce = hit & specular & (depth + 2 <= max_light_depth)
        bdir, _pdf, b_weight, _eta, b_valid, counter = bsdf_sample(
            scene, tables, mat_type, surf, seed, counter, out_dir,
            active=can_bounce)
        new_contrib = contrib * b_weight
        nonzero = torch.amax(new_contrib, dim=-1) > FLT_EPS
        alive = can_bounce & b_valid & nonzero
        an = alive[..., None]
        org = torch.where(an, surf["point"], org)
        d = torch.where(an, bdir, d)
        tmin = torch.full((n,), OFFSET, **f32)
        contrib = torch.where(an, new_contrib, contrib)
    return dict(pos=p_pos, in_dir=p_dir, power=p_pow, depth=p_depth,
                valid=p_valid, light=lsel)


def trace_photons(scene, tables, n_photons, iteration, frame, user_seed,
                  tile=1 << 16):
    """The photon pass: `n_photons` photons in tiles of `tile` lanes.
    Returns a dict of (n_photons, ...) arrays: pos, in_dir, power, depth,
    valid, light."""
    dev = tables["tri_v0"].device
    tile = int(min(tile, n_photons))
    parts = []
    for start in range(0, n_photons, tile):
        idx, active = path_lanes(start, tile, n_photons, dev)
        parts.append(_trace_photon_tile(scene, tables, idx, active,
                                        iteration, frame, user_seed))
    return {k: torch.cat([p[k] for p in parts])[:n_photons]
            for k in parts[0]}


def build_photon_grid(scene, photons):
    """Sort the photons by grid cell (stable; dead photons last)."""
    dev = photons["pos"].device
    bbox_min = torch.as_tensor(np.asarray(scene.bbox_min, np.float32),
                               device=dev)
    ext = torch.as_tensor(np.asarray(scene.bbox_max - scene.bbox_min,
                                     np.float32), device=dev)
    inv_ext = safe_div(1.0, torch.clamp_min(ext, 1e-20))
    cid = _cell_id(_cell_of(photons["pos"], bbox_min, inv_ext))
    cid = torch.where(photons["valid"], cid,
                      torch.full_like(cid, GRID * GRID * GRID))
    order = torch.argsort(cid, stable=True)
    out = {k: photons[k][order]
           for k in ("pos", "in_dir", "power", "depth", "valid")}
    return dict(out, cell_sorted=cid[order].contiguous(), bbox_min=bbox_min,
                inv_ext=inv_ext)


def _lane_rows(surf, n, rows):
    """`rows(v)` of every per-lane entry of `surf` (n lanes)."""
    return {key: (rows(v) if torch.is_tensor(v) and v.ndim
                  and v.shape[0] == n else v) for key, v in surf.items()}


def _gather_chunk(scene, tables, grid, surf, mat_type, out_dir, radius,
                  cam_depth, active):
    """`gather_photons` on one chunk of lanes, before the division by the
    photon count."""
    max_depth = scene.technique.max_depth
    n = out_dir.shape[0]
    dev = out_dir.device
    pos = surf["point"]
    r2 = radius * radius
    ir2 = safe_div(1.0, r2)
    cos_o = dot(out_dir, surf["n"])
    csort = grid["cell_sorted"]
    last = csort.shape[0] - 1
    slots = torch.arange(CELL_CAP, dtype=torch.int64, device=dev)
    # every lane's surface, once per slot: the BSDF's rows of all pairs
    surf_k = _lane_rows(surf, n,
                        lambda v: v.repeat_interleave(CELL_CAP, dim=0))
    mat_k = mat_type.repeat_interleave(CELL_CAP)
    out_k = out_dir.repeat_interleave(CELL_CAP, dim=0)
    n_k = surf["n"][:, None, :]

    lo = _cell_of(pos - radius[..., None], grid["bbox_min"], grid["inv_ext"])
    contrib = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    inv_pi = float(np.float32(1.0 / np.pi))
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                idx = lo + device_const((dx, dy, dz), torch.int32, dev)
                ok_cell = torch.all(idx < GRID, dim=-1) & active
                cell = _cell_id(torch.clamp(idx, 0, GRID - 1)).contiguous()
                start = torch.searchsorted(csort, cell)
                end = torch.searchsorted(csort, cell + 1)
                count = torch.clamp_max(end - start, CELL_CAP)
                # (lanes, CELL_CAP): the slots of the cell, as the JAX
                # package's loop reads them one by one
                pi = torch.clamp_max(start[:, None] + slots, last)
                in_range = (slots < count[:, None]) & ok_cell[:, None]
                ppos = grid["pos"][pi]
                d2 = torch.sum((pos[:, None, :] - ppos) ** 2, dim=-1)
                pdir = grid["in_dir"][pi]
                cos_i = dot(pdir, n_k)
                depth_ok = cam_depth + grid["depth"][pi] <= max_depth
                use = (in_range & (d2 <= r2[:, None]) & depth_ok
                       & ((cos_o[:, None] * cos_i) > FLT_EPS))
                # the Simpson kernel
                term = 1.0 - d2 * ir2[:, None]
                kern = term * term * 3.0 * ir2[:, None] * inv_pi
                f = bsdf_eval(scene, tables, mat_k, surf_k,
                              pdir.reshape(-1, 3), out_k).reshape(n, CELL_CAP,
                                                                  3)
                # strip the eval's cos_i: the photon's power already holds
                # the projection on the light side
                wgt = safe_div(kern, torch.abs(cos_i))
                add = grid["power"][pi] * f * wgt[..., None]
                contrib = contrib + torch.sum(
                    torch.where(use[..., None], add, torch.zeros_like(add)),
                    dim=1)
    return contrib


def gather_photons(scene, tables, grid, surf, mat_type, out_dir, radius,
                   cam_depth, active, max_count):
    """The density estimate at each lane's surface: the Simpson-weighted BSDF
    response of the photons within `radius` (per lane), over `max_count`,
    the photon count.  `cam_depth` is the camera path's depth (a Python
    int).  Lanes go through in chunks of GATHER_PAIRS // CELL_CAP."""
    n = out_dir.shape[0]
    chunk = GATHER_PAIRS // CELL_CAP
    parts = [_gather_chunk(scene, tables, grid,
                           _lane_rows(surf, n, lambda v: v[s:s + chunk]),
                           mat_type[s:s + chunk], out_dir[s:s + chunk],
                           radius[s:s + chunk], cam_depth,
                           active[s:s + chunk])
             for s in range(0, n, chunk)]
    contrib = parts[0] if len(parts) == 1 else torch.cat(parts)
    return contrib / float(np.float32(max_count))


def render_ppm(scene, tables, grid, work_x, work_y, work_sample, iteration,
               frame, user_seed, radius, max_count):
    """The camera pass over one work list (pixel coordinates, a sample
    index); returns each lane's radiance sum (N, 3).  `radius` is the
    iteration's gather radius (a float), `max_count` the photon count."""
    tech = scene.technique
    n = work_x.shape[0]
    dev = work_x.device
    f32 = dict(dtype=torch.float32, device=dev)
    clamp = tech.clamp
    seed, counter, org, d, tmin, tmax = _emit_camera(
        scene, work_x, work_y, work_sample, iteration, frame, user_seed,
        tables=tables)
    trav_mask = (None if _flags_trivial(scene)
                 else _tri_mask_for(tables, RAY_BOUNCE))
    inf_ids = [i for i, l in enumerate(scene.lights)
               if l.infinite and not l.delta]

    alive = torch.ones(n, dtype=torch.bool, device=dev)
    contrib = torch.ones((n, 3), **f32)
    eta = torch.ones(n, **f32)
    path_type = torch.zeros(n, dtype=torch.int32, device=dev)
    r_path = torch.zeros(n, **f32)
    fb = torch.zeros((n, 3), **f32)
    zeros3 = torch.zeros((n, 3), **f32)
    far = torch.full((n,), FLT_MAX, **f32)
    for depth in range(1, tech.max_depth + 1):
        t, u, v, prim = _traverse_closest(scene, tables, org, d, tmin, far,
                                          trav_mask)
        hit = alive & (prim >= 0)
        miss = alive & ~hit
        t_safe = torch.where(hit, t, torch.ones_like(t))
        surf = _surface_at(tables, torch.clamp_min(prim, 0), org, d, t_safe,
                           u, v)
        mat_type, specular = prepare_surface(scene, tables, surf, d, org)
        out_dir = -d
        specular_only = path_type == 0
        splat = zeros3

        # an escaped ray sees the environment on specular-only paths
        if inf_ids:
            mc = zeros3
            for lid in inf_ids:
                emit, _ = env_emission_and_pdf(scene, tables, lid, d)
                mc = mc + _handle_color(contrib * emit, clamp)
            splat = splat + torch.where((miss & specular_only)[..., None],
                                        mc, zeros3)

        # an emitter hit, likewise (LS*E paths)
        is_emissive = surf["light_id"] >= 0
        dot_n = -dot(d, surf["n"])
        radiance = _area_light_radiance(
            scene, tables, torch.clamp_min(surf["light_id"], 0))
        emit_ok = (hit & is_emissive & surf["is_entering"]
                   & (dot_n > FLT_EPS) & specular_only)
        splat = splat + torch.where(emit_ok[..., None],
                                    _handle_color(contrib * radiance, clamp),
                                    zeros3)

        # the gather at diffuse vertices, within the footprint radius taken
        # at the first hit
        if depth > 1:
            r_here = r_path
        else:
            r_here = torch.clamp_max(t_safe * float(np.float32(0.017455064)),
                                     radius)
        gather_ok = (hit & ~is_emissive & ~specular
                     & (depth + 1 <= tech.max_depth)
                     & (torch.abs(dot(out_dir, surf["n"])) > FLT_EPS))
        g = gather_photons(scene, tables, grid, surf, mat_type, out_dir,
                           r_here, depth, gather_ok, max_count)
        splat = splat + torch.where(gather_ok[..., None],
                                    _handle_color(contrib * g, clamp), zeros3)
        fb = fb + torch.where(alive[..., None], splat, zeros3)

        # the bounce; russian roulette past `min_depth`
        can_bounce = hit & (depth + 1 <= tech.max_depth)
        bdir, _pdf, b_weight, b_eta, b_valid, counter = bsdf_sample(
            scene, tables, mat_type, surf, seed, counter, out_dir,
            active=can_bounce)
        new_contrib = contrib * b_weight
        drew = can_bounce & b_valid
        eta = eta * torch.where(drew, b_eta, torch.ones_like(b_eta))
        if depth + 1 > tech.min_depth:
            rr = torch.clamp(torch.amax(new_contrib * (eta * eta)[..., None],
                                        dim=-1), 0.05, 0.95)
        else:
            rr = torch.ones_like(eta)
        u_rr, c_rr = rng.next_f32(seed, counter)
        counter = torch.where(drew, c_rr, counter)
        alive = drew & (u_rr < rr)
        an = alive[..., None]
        org = torch.where(an, surf["point"], org)
        d = torch.where(an, bdir, d)
        tmin = torch.full((n,), OFFSET, **f32)
        contrib = torch.where(an, new_contrib * safe_div(1.0, rr)[..., None],
                              contrib)
        path_type = torch.where(alive & ~specular,
                                torch.ones_like(path_type), path_type)
        r_path = torch.where(alive, r_here, r_path)
    return fb
