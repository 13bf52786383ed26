"""Wavefront path tracer (the `path` and `volpath` techniques), and the
dispatch of the single-intersection techniques (`render/techniques.py`).

Counterpart of ignis_tpu/render/integrator.py.  Every bounce processes a
fixed-capacity ray wave with masked lanes.  Technique logic (NEE, MIS
weights, russian roulette, payload layout) and the per-lane RNG draw order
follow the reference package exactly, so a lane's sample sequence is
bit-identical and paths replay.

Two entry points share the same bounce core:

* `trace_wave`: one ray per lane traced to completion (camera rays from
  pixel coordinates, or a ray list given as `org` / `direction`).  Under
  the light tracer and the photon mapper, whose steps run in
  `render/lighttracer.py` and `render/photonmapper.py`, it traces camera
  paths with this bounce, as the JAX package's does (`Runtime.trace`).
* `render_wavefront`: the production camera path.  Dead lanes are refilled
  with fresh (pixel, sample) work every bounce; radiance is added into a
  per-work-item slot buffer.

The bounce loops are Python loops on `alive.any()`: one host sync per bounce
(plus one in the light selector's rejection loop when the scene has more than
one light), each read through `utils.stats.host_item`, which counts it.
`trace_wave(differentiable=True)` runs a fixed number of bounces instead, for
autograd.  Under a profiler each loop iteration is a `wave` span, with
`emit`, `bounce`, `traverse` and `accum` spans inside (`utils.stats.span`);
under `volpath` the media's work of a bounce (coefficients, transmittance,
distance sample and event) is in `medium` spans inside `bounce`, and the
events are counted on the device (`utils.stats.count_medium`).

Traversal dispatch for the world-space soup, in the reference's order:
`pb_rows` in the tables -> the packet-BVH kernel; `bvh_node_min` -> the
per-lane stack walk of `ops.bvh` (tensor code, no kernel: the reference's
XLA path, which `Runtime(use_bvh=True)` and igcli's default select);
`bw_tris` -> the Baldwin-Weber kernel; none of them -> the whole-soup
Moeller-Trumbore sweep, `ops.mt_intersect`'s kernel on the card and
`ops.intersect` (plain torch) on the CPU.  Its result is combined with
the instanced pool's (`tl_inst` -> `ops.tlas`) and the analytic spheres'
(`sph_rows` -> `ops.spheres`): the nearer hit wins, and pool and sphere hits
travel in the prim id past the soup's range.  The kernel wrappers launch CUDA
for tensors on the card and run their plain versions for tensors on the CPU.

Payload: inv_pdf, contrib, depth (starts at 1), eta; under `volpath` also
the lane's medium (-1 vacuum), its volume depth and the null-flight flag.  A
negative `inv_pdf` (-1) marks a vertex in a medium: every surface bounce
writes +0.0, never -0.0.
"""

from __future__ import annotations

import numpy as np
import torch

from ignis_tpu_torch.bsdf import (
    bsdf_eval, bsdf_pdf, bsdf_sample, prepare_surface,
)
from ignis_tpu_torch.core import rng
from ignis_tpu_torch.core.dgather import gather_rows
from ignis_tpu_torch.core.vec import (
    FLT_EPS, FLT_MAX, cross, device_const, device_scalar, dot, length,
    maximum, normalize, orthonormal_basis, safe_div, transform_normal,
    transform_point, transform_vector,
)
from ignis_tpu_torch.light import (
    env_emission_and_pdf, light_pdf_direct_solid, light_select_pdf,
    sample_light_direct, select_light,
)
from ignis_tpu_torch.medium import (
    medium_coefficients, medium_eval, medium_eval_inf, medium_events,
    medium_sample, phase_sample,
)
from ignis_tpu_torch.ops.bvh import bvh_any, bvh_closest
from ignis_tpu_torch.ops.bw_intersect import bw_any, bw_closest
from ignis_tpu_torch.ops.intersect import intersect_any, intersect_closest
from ignis_tpu_torch.ops.mt_intersect import mt_any, mt_closest
from ignis_tpu_torch.ops.packet_bvh import (
    MASK_BOUNCE, MASK_CAMERA, MASK_SHADOW, packet_bvh_any, packet_bvh_closest,
)
from ignis_tpu_torch.ops.spheres import sphere_any, sphere_closest
from ignis_tpu_torch.ops.tlas import tlas_any, tlas_closest
from ignis_tpu_torch.render.camera import generate_rays, pixel_coord_from_xy
from ignis_tpu_torch.render.sampler import sample_pixel
from ignis_tpu_torch.scene.compile import LIGHT_AREA_PLANE
from ignis_tpu_torch.utils.stats import count_medium, host_item, span

OFFSET = float(np.float32(0.001))  # ray offset

RAY_CAMERA = 0x1
RAY_LIGHT = 0x2
RAY_BOUNCE = 0x4
RAY_SHADOW = 0x8

# techniques of one intersection a ray, traced by `trace_wave` alone
SIMPLE_TECHNIQUES = ("debug", "ao", "wireframe", "lightvisibility",
                     "camera_check", "infobuffer")

# the `wave` spans' attributes: an iteration of the full-width loop or of
# the narrow tail
_WIDE = {"tail": False}
_TAIL = {"tail": True}


def _handle_color(c, clamp_value):
    if clamp_value > 0:
        return torch.clamp_max(c, float(np.float32(clamp_value)))
    return c


def _tri_mask_for(tables, flag_bit):
    ent_flags = tables["ent_flags"]
    return (ent_flags[tables["tri_ent"].long()] & flag_bit) != 0


def _flags_trivial(scene, bit=None):
    ent_flags = np.asarray(scene.tables["ent_flags"])
    if bit is None:
        return bool((ent_flags == 0xF).all())
    return bool(((ent_flags & bit) != 0).all())


def sphere_prim_base(tables):
    """First prim id of the analytic-sphere range: past the soup and the
    instanced pool (see the combines of `_traverse_closest` and
    `_surface_at`)."""
    base = tables["tri_v0"].shape[0]
    if "tl_inst" in tables:
        base += tables["tl_inst"].shape[0] * tables["tl_tris"].shape[0]
    return base


def _nearer(pick_ok, t1, u1, v1, enc, out):
    """Combine a second traversal's hits into `out` = (t, u, v, prim): taken
    where it hit and is nearer, or where `out` missed."""
    t0, u0, v0, p0 = out
    pick = pick_ok & ((t1 < t0) | (p0 < 0))
    return (torch.where(pick, t1, t0), torch.where(pick, u1, u0),
            torch.where(pick, v1, v0), torch.where(pick, enc, p0))


def _traverse_closest(scene, tables, org, d, tmin, tmax, tri_mask,
                      mask_bit=None):
    """Closest-hit dispatch: packet BVH > stack BVH > Baldwin-Weber brute >
    MT sweep for the soup, then the instanced pool and the analytic spheres.

    `tri_mask` is the per-triangle visibility array for the stack BVH and
    the MT sweep; `mask_bit` the equivalent ray-class bit for the other
    traversals, whose tables carry packed visibility bits.  Traversal is
    detached: hit results are piecewise constant in the differentiable
    parameters.
    """
    with span("traverse"):
        org, d, tmin, tmax = (x.detach() for x in (org, d, tmin, tmax))
        mb = MASK_BOUNCE if mask_bit is None else mask_bit
        base = tables["tri_v0"].shape[0]
        if "pb_rows" in tables:
            out = packet_bvh_closest(tables, org, d, tmin, tmax, mask_bit=mb)
        elif "bvh_node_min" in tables:
            out = bvh_closest(tables, org, d, tmin, tmax, tri_mask=tri_mask)
        elif "bw_tris" in tables:
            out = bw_closest(tables, org, d, tmin, tmax, mask_bit=mb)
        elif base == 0:
            # no soup (every entity instanced or analytic): every ray misses it
            out = (tmax.clone(), torch.zeros_like(tmax),
                   torch.zeros_like(tmax),
                   torch.full(tmax.shape, -1, dtype=torch.int32,
                              device=tmax.device))
        else:
            sweep = mt_closest if org.is_cuda else intersect_closest
            out = sweep(org, d, tmin, tmax, tables["tri_v0"], tables["tri_e1"],
                        tables["tri_e2"], tri_mask=tri_mask)
        if "tl_inst" in tables:
            # pool hits are encoded past the soup's id range as
            # base + instance * pool_rows + pool_row, so the instance binding
            # survives the (t, u, v, prim) plumbing
            tt, tu, tv, ti, te = tlas_closest(tables, org, d, tmin, tmax,
                                              mask_bit=mb)
            enc = base + te * tables["tl_tris"].shape[0] + ti
            out = _nearer(ti >= 0, tt, tu, tv, enc, out)
        if "sph_rows" in tables:
            st_, su, sv, si = sphere_closest(tables, org, d, tmin, tmax,
                                             mask_bit=mb)
            out = _nearer(si >= 0, st_, su, sv, sphere_prim_base(tables) + si,
                          out)
        return out


def _traverse_any(scene, tables, org, d, tmin, tmax, tri_mask,
                  mask_bit=None):
    """Any-hit dispatch; detached like `_traverse_closest`."""
    with span("traverse"):
        org, d, tmin, tmax = (x.detach() for x in (org, d, tmin, tmax))
        mb = MASK_SHADOW if mask_bit is None else mask_bit
        if "pb_rows" in tables:
            occ = packet_bvh_any(tables, org, d, tmin, tmax, mask_bit=mb)
        elif "bvh_node_min" in tables:
            occ = bvh_any(tables, org, d, tmin, tmax, tri_mask=tri_mask)
        elif "bw_tris" in tables:
            occ = bw_any(tables, org, d, tmin, tmax, mask_bit=mb)
        elif tables["tri_v0"].shape[0] == 0:
            occ = torch.zeros(tmax.shape, dtype=torch.bool, device=tmax.device)
        else:
            sweep = mt_any if org.is_cuda else intersect_any
            occ = sweep(org, d, tmin, tmax, tables["tri_v0"], tables["tri_e1"],
                        tables["tri_e2"], tri_mask=tri_mask)
        if "tl_inst" in tables:
            occ = occ | tlas_any(tables, org, d, tmin, tmax, mask_bit=mb)
        if "sph_rows" in tables:
            occ = occ | sphere_any(tables, org, d, tmin, tmax, mask_bit=mb)
        return occ


def _surface_at(tables, prim, org, direction, t, u, v):
    """Surface element for hit lanes.  Per-triangle attributes of the soup
    come from one gather of the packed (T, 28) `tri_shade` row when the
    tables carry it (`api.pack_tri_shade`), else from the separate tables.
    Pooled (instanced) hits fetch LOCAL attributes from the shared pool and
    lift them to world space with the instance's transform; analytic sphere
    hits take normal and area from the sphere.  `prim` must be >= 0 (the
    caller clamps miss lanes to 0)."""
    prim = prim.long()
    n = prim.shape[0]
    dev = prim.device
    base = tables["tri_v0"].shape[0]
    if "tri_shade" in tables:
        row = tables["tri_shade"][torch.clamp_max(prim, base - 1)]
        v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        n0, n1, n2 = row[:, 9:12], row[:, 12:15], row[:, 15:18]
        uv0, uv1, uv2 = row[:, 18:20], row[:, 20:22], row[:, 22:24]
        # ids are stored as float32: exact below 2^24
        ent = row[:, 24].to(torch.int32)
        mat_id = row[:, 25].to(torch.int32)
        light_id = row[:, 26].to(torch.int32)
    elif base == 0:
        # no soup: every hit is pooled or a sphere and overwrites these
        v0 = e1 = e2 = n0 = n1 = n2 = torch.zeros((n, 3), dtype=torch.float32,
                                                  device=dev)
        uv0 = uv1 = uv2 = torch.zeros((n, 2), dtype=torch.float32, device=dev)
        ent = mat_id = torch.zeros(n, dtype=torch.int32, device=dev)
        light_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    else:
        sp = torch.clamp_max(prim, base - 1)
        v0 = tables["tri_v0"][sp]
        e1 = tables["tri_e1"][sp]
        e2 = tables["tri_e2"][sp]
        n0 = tables["tri_n0"][sp]
        n1 = tables["tri_n1"][sp]
        n2 = tables["tri_n2"][sp]
        uv0 = tables["tri_uv0"][sp]
        uv1 = tables["tri_uv1"][sp]
        uv2 = tables["tri_uv2"][sp]
        ent = tables["tri_ent"][sp]
        mat_id = tables["ent_mat"][ent.long()]
        light_id = tables["ent_light"][ent.long()]
    if "tl_inst" in tables:
        # decode instance and pool row; normals go through the inverse
        # transpose, edges through toWorld, so the shared cross-product math
        # below yields the world face normal AND area
        pool_rows = tables["tl_tris"].shape[0]
        ninst = tables["tl_inst"].shape[0]
        pooled = (prim >= base) & (prim < base + ninst * pool_rows)
        enc = torch.clamp_min(prim - base, 0)
        inst = torch.clamp_max(enc // pool_rows, ninst - 1)
        prow = tables["tl_shade"][enc % pool_rows]
        irow = tables["tl_inst"][inst]
        nrow = tables["tl_norm"][inst]
        nm = nrow[:, 0:9].reshape(-1, 3, 3)
        tw = nrow[:, 10:22].reshape(-1, 3, 4)
        sel = pooled[..., None]
        v0 = torch.where(sel, transform_point(tw, prow[:, 0:3]), v0)
        e1 = torch.where(sel, transform_vector(tw, prow[:, 3:6]), e1)
        e2 = torch.where(sel, transform_vector(tw, prow[:, 6:9]), e2)
        n0 = torch.where(sel, normalize(transform_normal(nm, prow[:, 9:12])),
                         n0)
        n1 = torch.where(sel, normalize(transform_normal(nm, prow[:, 12:15])),
                         n1)
        n2 = torch.where(sel, normalize(transform_normal(nm, prow[:, 15:18])),
                         n2)
        uv0 = torch.where(sel, prow[:, 18:20], uv0)
        uv1 = torch.where(sel, prow[:, 20:22], uv1)
        uv2 = torch.where(sel, prow[:, 22:24], uv2)
        p_ent = irow[:, 22].to(torch.int32)
        ent = torch.where(pooled, p_ent, ent)
        mat_id = torch.where(pooled, tables["ent_mat"][p_ent.long()], mat_id)
        # the pool is non-emissive: emitters stay baked
        light_id = torch.where(pooled, torch.full_like(light_id, -1),
                               light_id)
    nraw = cross(e1, e2)
    nlen = length(nraw)
    face_n = nraw * safe_div(1.0, nlen)[..., None]
    inv_area = safe_div(1.0, 0.5 * nlen)
    w = (1.0 - u - v)[..., None]
    ns = normalize(n0 * w + n1 * u[..., None] + n2 * v[..., None])
    point = org + direction * t[..., None]
    tex = uv0 * w + uv1 * u[..., None] + uv2 * v[..., None]
    if "sph_rows" in tables:
        # analytic sphere hits: normal straight from the center, uv carried
        # in (u, v) by the traversal
        sbase = sphere_prim_base(tables)
        issph = prim >= sbase
        srows = tables["sph_rows"].shape[0]
        srow = tables["sph_rows"][torch.clamp(prim - sbase, 0, srows - 1)]
        sr = torch.clamp_min(srow[:, 3], 1e-30)
        s_ent = srow[:, 4].to(torch.int32)
        n_out = normalize((point - srow[:, 0:3]) / sr[:, None])
        sel = issph[..., None]
        face_n = torch.where(sel, n_out, face_n)
        ns = torch.where(sel, n_out, ns)
        inv_area = torch.where(issph, 1.0 / (4.0 * np.pi * sr * sr), inv_area)
        tex = torch.where(sel, torch.stack([u, v], dim=-1), tex)
        ent = torch.where(issph, s_ent, ent)
        mat_id = torch.where(issph, tables["ent_mat"][s_ent.long()], mat_id)
        light_id = torch.where(issph, tables["ent_light"][s_ent.long()],
                               light_id)
    entering = dot(direction, face_n) <= 0.0
    sgn = torch.where(entering, 1.0, -1.0).to(torch.float32)[..., None]
    ns = ns * sgn
    face_n = face_n * sgn
    tb, bb = orthonormal_basis(ns)
    return dict(point=point, n=ns, ng=face_n, is_entering=entering,
                inv_area=inv_area, tex=tex, t=tb, b=bb,
                ent=ent, mat_id=mat_id, light_id=light_id,
                prim_coords=torch.stack([u, v], dim=-1))


def _pexpr_ctx(tables, surf, org, d):
    """Lane context of PExpr-valued properties: the surface's uv, position
    (world and normalised object space), normals, view and entity."""
    ent = surf["ent"].long()
    lm = gather_rows(tables["ent_local_mat"], ent)  # (N, 3, 4)
    lp = torch.einsum("nij,nj->ni", lm[:, :, :3], surf["point"]) + lm[:, :, 3]
    lo = gather_rows(tables["ent_lbbox_min"], ent)
    hi = gather_rows(tables["ent_lbbox_max"], ent)
    ext = hi - lo
    flat = ext == 0
    np_ = torch.where(flat, device_scalar(0.0, ext.device),
                      (lp - lo) / torch.where(flat, device_scalar(
                          1.0, ext.device), ext))
    tex = surf["tex"]
    return dict(uv=tex,
                uvw=torch.cat([tex, torch.zeros(tex.shape[:-1] + (1,),
                                                dtype=torch.float32,
                                                device=tex.device)], dim=-1),
                prim_coords=surf["prim_coords"], P=surf["point"], Np=np_,
                V=-d, Ro=org, N=surf["n"], Ng=surf["ng"], Nx=surf["t"],
                Ny=surf["b"], frontside=surf["is_entering"],
                entity_id=surf["ent"])


def _count(mask):
    return torch.sum(mask.to(torch.float32))


def _bounce_core(scene, tables, st, tri_mask, shadow_mask, mask_bit=None):
    """One wavefront bounce for all lanes of `st`.

    st keys: org, dir, tmin, tmax, alive, seed, counter, inv_pdf, contrib,
    depth, eta, medium, voldepth, nullfl.  Returns (splat (N,3), st_next,
    quants): splat holds this bounce's radiance contributions (miss /
    emissive / NEE) for alive lanes, quants the per-bounce counters [hits,
    misses, shadow rays, occluded shadow rays, bounce continuations].

    Under `volpath` the bounce also carries medium transport: transmittance
    on every contribution, distance-sampled absorption, scatter and null
    events, and the medium-interface crossing on transmissive surface
    bounces.
    """
    tech = scene.technique
    is_vol = tech.type == "volpath"
    num_lights = scene.num_lights
    inf_ids = [i for i, l in enumerate(scene.lights)
               if l.infinite and not l.delta]

    org, d = st["org"], st["dir"]
    alive = st["alive"]
    seed = st["seed"]
    counter = st["counter"]
    contrib = st["contrib"]
    inv_pdf = st["inv_pdf"]
    depth = st["depth"]
    eta = st["eta"]
    n = org.shape[0]
    dev = org.device
    zeros3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    t, u, v, prim = _traverse_closest(scene, tables, org, d, st["tmin"],
                                      st["tmax"], tri_mask, mask_bit=mask_bit)
    hit = alive & (prim >= 0)
    miss = alive & ~hit
    splat = zeros3

    # ---- surface for hit lanes (miss lanes: prim -1 -> row 0, t -> 1 so the
    # masked-lane surface stays finite and the gathers stay in range)
    prim_s = torch.clamp_min(prim, 0)
    t_safe = torch.where(hit, t, torch.ones_like(t))
    surf = _surface_at(tables, prim_s, org, d, t_safe, u, v)
    mat_type, specular = prepare_surface(scene, tables, surf, d, org)

    # ---- the coefficients of each lane's current medium (volpath)
    if is_vol:
        med = st["medium"]
        with span("medium"):
            mctx = _pexpr_ctx(tables, surf, org, d)
            m_sa, m_ss, m_g = medium_coefficients(scene, tables, med, mctx)
            hitvol = medium_eval(scene, tables, med, m_sa, m_ss, org,
                                 surf["point"], seed=seed, counter=counter)
            inf_tr = medium_eval_inf(scene, tables, med, m_sa, m_ss, org, d)
        was_medium = torch.signbit(inv_pdf)
        inv_pdf_eff = maximum(inv_pdf, 0.0)
        # lanes continuing a null flight re-trace the same segment: the
        # surface, miss and NEE splats fired at its first arrival
        nullfl = st["nullfl"]
        fresh = ~nullfl
    else:
        inv_pdf_eff = inv_pdf

    # ---- on_miss: infinite, non-delta lights
    if inf_ids:
        miss_color = zeros3
        for lid in inf_ids:
            emit, pdf_s = env_emission_and_pdf(scene, tables, lid, d)
            if tech.enable_nee and num_lights > 0:
                lpdf = tables["light_sel_pdf"][lid]
                mis = 1.0 / (1.0 + inv_pdf_eff * lpdf * pdf_s)
            else:
                mis = torch.ones(n, dtype=torch.float32, device=dev)
            em = contrib * emit * inf_tr if is_vol else contrib * emit
            miss_color = miss_color + _handle_color(em * mis[..., None],
                                                    tech.clamp)
        on_miss = miss & fresh if is_vol else miss
        splat = splat + torch.where(on_miss[..., None], miss_color, zeros3)

    # ---- on_hit: emissive surfaces
    if any(l.type in (1, 2, 8) for l in scene.lights):
        is_emissive = surf["light_id"] >= 0
        dot_n = -dot(d, surf["n"])
        # non-emissive lanes carry light_id -1: clamp for the gathers
        lidx = torch.clamp_min(surf["light_id"], 0)
        pdf_s = light_pdf_direct_solid(
            scene, tables, lidx, org, d, t_safe, -dot(d, surf["ng"]),
            surf["prim_coords"], is_emissive)
        radiance = _area_light_radiance(scene, tables, lidx)
        if tech.enable_nee:
            lpdf = light_select_pdf(scene, tables, lidx, org)
            mis = 1.0 / (1.0 + inv_pdf_eff * lpdf * pdf_s)
        else:
            mis = torch.ones(n, dtype=torch.float32, device=dev)
        emit_ok = (hit & is_emissive & surf["is_entering"]
                   & (dot_n > FLT_EPS))
        em = contrib * radiance
        if is_vol:
            emit_ok = emit_ok & fresh
            em = em * hitvol
        ec = _handle_color(em * mis[..., None], tech.clamp)
        splat = splat + torch.where(emit_ok[..., None], ec, zeros3)

    # ---- on_shadow: NEE
    do_nee = (tech.enable_nee and num_lights > 0)
    if do_nee:
        nee_active = hit & ~specular & (depth + 1 <= tech.max_depth)
        if is_vol:
            nee_active = nee_active & fresh
        lsel, sel_pdf, counter = select_light(
            scene, tables, seed, counter, nee_active,
            from_pos=surf["point"])
        ls, counter = sample_light_direct(
            scene, tables, lsel, surf["point"], surf["is_entering"],
            seed, counter, nee_active)
        pdf_l_s = ls["pdf_solid"] * sel_pdf
        out_dir = -d
        pdf_e_s = bsdf_pdf(scene, tables, mat_type, surf, ls["dir"], out_dir)
        no_mis = ls["delta"] | was_medium if is_vol else ls["delta"]
        mis = torch.where(no_mis, torch.ones_like(pdf_e_s),
                          1.0 / (1.0 + safe_div(pdf_e_s, pdf_l_s)))
        factor = safe_div(ls["pdf_value"], pdf_l_s)
        bsdf_c = bsdf_eval(scene, tables, mat_type, surf, ls["dir"], out_dir)
        sc = _handle_color(
            ls["intensity"] * contrib * bsdf_c * (mis * factor)[..., None],
            tech.clamp)
        if is_vol:
            # attenuated by the transmittance to this hit and toward the
            # light
            with span("medium"):
                seg_fin = medium_eval(scene, tables, med, m_sa, m_ss,
                                      surf["point"], ls["pos"], seed=seed,
                                      counter=counter)
                seg_inf = medium_eval_inf(scene, tables, med, m_sa, m_ss,
                                          surf["point"], ls["dir"])
            seg = torch.where(ls["infinite"][..., None], seg_inf, seg_fin)
            sc = sc * hitvol * seg
        shadow_valid = (nee_active & (pdf_l_s > FLT_EPS)
                        & (ls["cos"] > FLT_EPS))
        shadow_contrib = torch.where(shadow_valid[..., None], sc, zeros3)
        s_org = surf["point"]
        finite_dir = ls["pos"] - surf["point"]
        s_dir = torch.where(ls["infinite"][..., None], ls["dir"], finite_dir)
        s_tmax = torch.where(ls["infinite"],
                             torch.full_like(t, FLT_MAX),
                             torch.full_like(t, 1.0 - OFFSET))

    # ---- on_bounce
    can_bounce = hit & (depth + 1 <= tech.max_depth)
    out_dir = -d
    if is_vol:
        bounce = _volpath_bounce(scene, tables, st, surf, mat_type, specular,
                                 can_bounce, counter, m_sa, m_ss, m_g, hitvol)
        counter = bounce.pop("counter")
        splat = splat + bounce.pop("splat")
        alive_next = bounce["alive"]
    else:
        in_dir, b_pdf, b_weight, b_eta, b_valid, counter = bsdf_sample(
            scene, tables, mat_type, surf, seed, counter, out_dir,
            active=can_bounce)
        new_contrib = contrib * b_weight
        # russian roulette (pbrt v4 variant); detached: a sampling decision,
        # not part of the integrand
        rr_base = torch.amax(new_contrib * (eta * eta)[..., None], dim=-1)
        rr_prob = torch.where(depth + 1 > tech.min_depth,
                              torch.clamp(rr_base, 0.05, 0.95),
                              torch.ones_like(rr_base)).detach()
        u_rr, counter_rr = rng.next_f32(seed, counter)
        rr_draw = can_bounce & b_valid
        counter = torch.where(rr_draw, counter_rr, counter)
        survive = u_rr < rr_prob
        alive_next = rr_draw & survive
        bounce = dict(
            org=surf["point"], dir=in_dir,
            tmin=torch.full_like(t, OFFSET),
            contrib=new_contrib * safe_div(1.0, rr_prob)[..., None],
            inv_pdf=torch.where(specular, torch.zeros_like(b_pdf),
                                safe_div(1.0, b_pdf)),
            depth=depth + 1, eta=eta * b_eta)

    # ---- trace shadow rays & splat
    if do_nee:
        occ = _traverse_any(scene, tables, s_org, s_dir,
                            torch.full_like(t, OFFSET), s_tmax, shadow_mask)
        splat = splat + torch.where((shadow_valid & ~occ)[..., None],
                                    shadow_contrib, zeros3)
        n_shadow = _count(shadow_valid)
        n_shadow_hit = _count(shadow_valid & occ)
    else:
        n_shadow = torch.zeros((), dtype=torch.float32, device=dev)
        n_shadow_hit = torch.zeros((), dtype=torch.float32, device=dev)

    quants = torch.stack([_count(hit), _count(miss), n_shadow, n_shadow_hit,
                          _count(alive_next)])

    an = alive_next
    anc = alive_next[..., None]
    st_next = dict(
        org=torch.where(anc, bounce["org"], org),
        dir=torch.where(anc, bounce["dir"], d),
        tmin=torch.where(an, bounce["tmin"], st["tmin"]),
        tmax=torch.where(an, torch.full_like(t, FLT_MAX), st["tmax"]),
        alive=alive_next,
        seed=seed,
        counter=counter,
        inv_pdf=torch.where(an, bounce["inv_pdf"], inv_pdf),
        contrib=torch.where(anc, bounce["contrib"], contrib),
        depth=torch.where(an, bounce["depth"], depth),
        eta=torch.where(an, bounce["eta"], eta),
    )
    if is_vol:
        st_next["medium"] = torch.where(an, bounce["medium"], st["medium"])
        st_next["voldepth"] = torch.where(an, bounce["voldepth"],
                                          st["voldepth"])
        st_next["nullfl"] = bounce["nullfl"] & an
    else:
        # a path lane never enters a medium: the keys pass through
        for k in _VOL_KEYS:
            if k in st:
                st_next[k] = st[k]
    return splat, st_next, quants


def _absorb_only_mask(scene, med):
    """Lanes in a homogeneous medium that only absorbs (no sigma_s, no
    expressions): their transmittance is taken in closed form (`hitvol`)
    instead of sampling absorption events: the same in expectation, and
    pathwise differentiable w.r.t. sigma_a."""
    absorb_only = tuple(
        m["type"] in ("homogeneous", "constant")
        and not m.get("sigma_s_expr") and not m.get("sigma_a_expr")
        and float(np.asarray(scene.tables["medium_data"][mi, 3:6]).max())
        == 0.0
        for mi, m in enumerate(scene.media))
    if not any(absorb_only):
        return torch.zeros(med.shape, dtype=torch.bool, device=med.device)
    table = device_const(absorb_only, torch.bool, med.device)
    return table[torch.clamp_min(med, 0).long()] & (med >= 0)


def _volpath_bounce(scene, tables, st, surf, mat_type, specular, can_bounce,
                    counter, m_sa, m_ss, m_g, hitvol):
    """The volpath technique's on_bounce: a distance sample in the lane's
    medium, then an absorption (emission splat), scatter (phase sample and
    russian roulette) or null event (continue forward, reweighted), else the
    surface's BSDF sample, crossing into the entity's inner or outer medium
    on transmission.  Returns the next payload of the lanes that go on, the
    splat and the counter."""
    tech = scene.technique
    seed, contrib, depth, eta = st["seed"], st["contrib"], st["depth"], st["eta"]
    org, d = st["org"], st["dir"]
    med, voldepth = st["medium"], st["voldepth"]
    dev = d.device
    zero, one = device_scalar(0.0, dev), device_scalar(1.0, dev)
    out_dir = -d
    max_scat = max([m.get("max_scattering", 8) for m in scene.media] + [8])
    allow_medium = ((voldepth + 1 <= max_scat)
                    & ~_absorb_only_mask(scene, med))
    with span("medium"):
        ms, counter = medium_sample(scene, tables, med, m_sa, m_ss, seed,
                                    counter, org, surf["point"],
                                    can_bounce & allow_medium)
        ev, counter = medium_events(ms, seed, counter)
        count_medium(0, lambda: torch.stack(
            [ev["null"].sum(), ev["scatter"].sum(), ev["absorb"].sum()]))
    medium_event = ms["valid"]
    absorb, scatter, null_ev = ev["absorb"], ev["scatter"], ev["null"]
    p_a, p_s, p_f = ev["p_a"], ev["p_s"], ev["p_f"]

    def inv(p):
        # where-substitute: 1 / max(p, eps) has a slope that overflows and
        # reaches masked lanes' zero cotangents as NaN
        ok = p > 1e-6
        return torch.where(ok, 1.0 / torch.where(ok, p, one), zero)

    # absorption event: the medium's emission
    em_c = (contrib * ms["color"] * ms["sigma_a"] * ms["emission"]
            * inv(p_a)[..., None])
    splat = torch.where(absorb[..., None], _handle_color(em_c, tech.clamp),
                        zero)

    # scatter event: phase sample and russian roulette
    ph_dir, _ph_pdf, ph_w, counter = phase_sample(m_g, seed, counter,
                                                  out_dir, scatter)
    contrib_m = contrib * (ms["color"] * ms["sigma_s"] * inv(p_s)[..., None]
                           * ph_w[..., None])
    rr_m = torch.clamp(torch.amax(contrib_m * (eta * eta)[..., None],
                                  dim=-1), 0.05, 0.95).detach()
    u_rr_m, c_rr_m = rng.next_f32(seed, counter)
    counter = torch.where(scatter, c_rr_m, counter)
    scatter_alive = scatter & (u_rr_m < rr_m)

    # surface event: attenuated by the closed-form transmittance where the
    # medium was not sampled
    surf_branch = can_bounce & ~medium_event
    in_dir, b_pdf, b_weight, b_eta, b_valid, counter = bsdf_sample(
        scene, tables, mat_type, surf, seed, counter, out_dir,
        active=surf_branch)
    vol_trans = torch.where(allow_medium[..., None], one, hitvol)
    contrib_s = contrib * vol_trans * b_weight
    rr_s = torch.where(specular, one, torch.clamp(
        torch.amax(contrib_s * (eta * eta)[..., None], dim=-1), 0.05,
        0.95)).detach()
    u_rr_s, c_rr_s = rng.next_f32(seed, counter)
    counter = torch.where(surf_branch & b_valid, c_rr_s, counter)
    surf_alive = surf_branch & b_valid & (u_rr_s < rr_s)
    # the medium interface: a transmitted ray enters the entity's inner
    # medium, or leaves into its outer one
    is_transmission = torch.signbit(dot(surf["n"], in_dir))
    inner = gather_rows(tables["ent_inner_medium"], surf["ent"])
    outer = gather_rows(tables["ent_outer_medium"], surf["ent"])
    picked = torch.where(surf["is_entering"], inner, outer)
    med_s = torch.where(is_transmission, picked, med)
    depth_s = torch.where(is_transmission, depth, depth + 1)
    voldepth_s = torch.where(is_transmission, torch.zeros_like(voldepth),
                             voldepth)

    # null event: continue forward from the fictional collision
    null_contrib = contrib * ms["color"] * ms["sigma_n"] * inv(p_f)[..., None]

    alive = scatter_alive | surf_alive | null_ev
    sc_c = scatter_alive[..., None]
    nl_c = null_ev[..., None]
    med_ev = scatter_alive | null_ev
    contrib_next = torch.where(
        sc_c, contrib_m * safe_div(1.0, rr_m)[..., None],
        torch.where(nl_c, null_contrib,
                    contrib_s * safe_div(1.0, rr_s)[..., None]))
    inv_pdf_s = torch.where(specular, torch.zeros_like(b_pdf),
                            safe_div(1.0, b_pdf))
    return dict(
        counter=counter, splat=splat, alive=alive,
        org=torch.where(med_ev[..., None], ms["pos"], surf["point"]),
        dir=torch.where(sc_c, ph_dir, torch.where(nl_c, d, in_dir)),
        tmin=torch.where(med_ev, zero, device_scalar(OFFSET, dev)),
        contrib=contrib_next,
        inv_pdf=torch.where(med_ev, device_scalar(-1.0, dev), inv_pdf_s),
        depth=torch.where(med_ev, depth, depth_s),
        eta=torch.where(med_ev, eta, eta * b_eta),
        medium=torch.where(med_ev, med, med_s),
        voldepth=torch.where(scatter_alive, voldepth + 1,
                             torch.where(null_ev, voldepth, voldepth_s)),
        nullfl=null_ev)


def _emit_camera(scene, x, y, sample, iteration, frame, user_seed,
                 tables=None, spi=1):
    """Camera emitter: seed, sampler draws, ray.  `sample` may be a per-lane
    tensor; `iteration`, `frame`, `user_seed` are Python ints.  The
    low-discrepancy samplers read the sample index iteration * spi + sample."""
    seed = rng.create_seed(sample, iteration, frame, x, y, user_seed)
    counter = torch.ones_like(seed)
    spp_index = iteration * spi + sample
    rx, ry, counter = sample_pixel(scene, tables, seed, counter, spp_index,
                                   x, y)
    nx, ny = pixel_coord_from_xy(x, y, scene.width, scene.height, rx, ry)
    # camera pose from the parameter registry (__camera_* keys), so pose
    # changes take effect between steps
    dyn = None
    reg = getattr(scene, "param_registry", None)
    if tables is not None and reg and "__camera_eye" in reg \
            and "params" in tables:
        p = tables["params"]

        def _sl(nm):
            _, off, sz = reg[nm]
            return p[off:off + sz]
        dyn = (_sl("__camera_eye"), _sl("__camera_dir"), _sl("__camera_up"))
    lens_uv = None
    if scene.camera.aperture_radius > 0.0:
        u1, counter = rng.next_f32(seed, counter)
        u2, counter = rng.next_f32(seed, counter)
        lens_uv = (u1, u2)
    org, direction, tmin, tmax = generate_rays(scene.camera, nx, ny, dyn=dyn,
                                               lens_uv=lens_uv)
    return seed, counter, org, direction, tmin, tmax


def _fresh_state(n, dev, **over):
    f32 = dict(dtype=torch.float32, device=dev)
    st = dict(
        org=torch.zeros((n, 3), **f32),
        dir=torch.cat([torch.zeros((n, 2), **f32), torch.ones((n, 1), **f32)],
                      dim=1),
        tmin=torch.zeros(n, **f32),
        tmax=torch.zeros(n, **f32),
        alive=torch.zeros(n, dtype=torch.bool, device=dev),
        seed=torch.zeros(n, dtype=torch.int64, device=dev),
        counter=torch.ones(n, dtype=torch.int64, device=dev),
        inv_pdf=torch.zeros(n, **f32),
        contrib=torch.ones((n, 3), **f32),
        depth=torch.ones(n, dtype=torch.int32, device=dev),
        eta=torch.ones(n, **f32),
        medium=torch.full((n,), -1, dtype=torch.int32, device=dev),
        voldepth=torch.zeros(n, dtype=torch.int32, device=dev),
        nullfl=torch.zeros(n, dtype=torch.bool, device=dev),
    )
    st.update(over)
    return st


_VOL_KEYS = ("medium", "voldepth", "nullfl")
_LANE_KEYS = ("org", "dir", "tmin", "tmax", "alive", "seed", "counter",
              "inv_pdf", "contrib", "depth", "eta") + _VOL_KEYS


def _compact(state, tail_cap, extra=()):
    """Alive lanes first (stable), cut to `tail_cap` lanes."""
    order = torch.argsort((~state["alive"]).to(torch.int8),
                          stable=True)[:tail_cap]
    return order, {k: state[k][order] for k in _LANE_KEYS + tuple(extra)}


def trace_wave(scene, tables, x, y, sample, iteration, frame, user_seed,
               org=None, direction=None, tmin=None, tmax=None,
               differentiable=False):
    """Trace one wave of rays to completion; returns per-lane radiance (N, 3).

    x, y: (N,) integer tensors; their device is the device of the run.
    If org/direction are given, acts as the list emitter: no pixel-sampler
    draws, rays used as provided.  The single-intersection techniques
    (`SIMPLE_TECHNIQUES`) go to `techniques.simple_technique_wave` under
    either emitter.

    differentiable=True runs a fixed `min(max_depth, 64)` bounces over every
    lane, dead lanes masked, with no host sync and no tail cascade (the
    reference's `lax.scan`), so that `backward()` runs through the result
    to any table given as a tensor that requires grad.  Every lane ends
    within `max_depth` bounces, so the radiance is the same as the
    non-differentiable loop's.  Traversal stays off the tape.
    """
    n = x.shape[0]
    dev = x.device

    if scene.technique.type in SIMPLE_TECHNIQUES:
        from ignis_tpu_torch.render.techniques import simple_technique_wave
        return simple_technique_wave(scene, tables, x, y, sample, iteration,
                                     frame, user_seed, org, direction, tmin,
                                     tmax)

    if org is None:
        # the camera emitter is called without `spi` here, as in the
        # reference: its low-discrepancy index is iteration + sample
        with span("emit"):
            seed, counter, org, direction, tmin, tmax = _emit_camera(
                scene, x, y, sample, iteration, frame, user_seed, tables)
    else:
        seed = rng.create_seed(sample, iteration, frame, x, y, user_seed)
        counter = torch.ones_like(seed)
        f32 = dict(dtype=torch.float32, device=dev)
        tmin = torch.broadcast_to(torch.as_tensor(tmin, **f32), (n,))
        tmax = torch.broadcast_to(torch.as_tensor(tmax, **f32), (n,))

    state = _fresh_state(n, dev, org=org, dir=direction, tmin=tmin, tmax=tmax,
                         alive=torch.ones(n, dtype=torch.bool, device=dev),
                         seed=seed, counter=counter)
    accum = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    trivial = _flags_trivial(scene)
    mask_cam = None if trivial else _tri_mask_for(tables, RAY_CAMERA)
    mask_bounce = None if trivial else _tri_mask_for(tables, RAY_BOUNCE)
    shadow_mask = (None if _flags_trivial(scene, RAY_SHADOW)
                   else _tri_mask_for(tables, RAY_SHADOW))

    def bounce(state, accum, first):
        tri_mask = mask_cam if first else mask_bounce
        mbit = MASK_CAMERA if first else MASK_BOUNCE
        with span("bounce"):
            splat, st_next, _q = _bounce_core(scene, tables, state, tri_mask,
                                              shadow_mask, mask_bit=mbit)
        return st_next, accum + splat

    if differentiable:
        for i in range(min(scene.technique.max_depth, 64)):
            with span("wave", _WIDE):
                state, accum = bounce(state, accum, i == 0)
        return accum

    tail_cap = 2048
    first = True
    if n <= tail_cap * 2:
        while host_item(state["alive"].any()):
            with span("wave", _WIDE):
                state, accum = bounce(state, accum, first)
            first = False
        return accum

    # tail cascade: full-width waves while busy, then compact the survivors
    # into a narrow wave and add their radiance back per lane
    while host_item(state["alive"].sum()) > tail_cap:
        with span("wave", _WIDE):
            state, accum = bounce(state, accum, first)
        first = False
    order, tail = _compact(state, tail_cap)
    tail_accum = torch.zeros((tail_cap, 3), dtype=torch.float32, device=dev)
    while host_item(tail["alive"].any()):
        with span("wave", _TAIL):
            tail, tail_accum = bounce(tail, tail_accum, first)
        first = False
    # in place: `order` holds distinct lanes
    accum.index_add_(0, order, tail_accum)
    return accum


def render_wavefront(scene, tables, iteration, frame, user_seed, capacity,
                     spi=1, tail_capacity=4096, work_mode="arith",
                     work_x=None, work_y=None, work_sample=None):
    """Render a work list through a fixed-capacity regenerating wave.

    Returns (framebuffer sum (H*W, 3) for this iteration, stats (9,)).  Dead
    lanes immediately pick up fresh camera work, so tail bounces of long
    paths do not run at low occupancy.

    work_mode="arith" (the default, the Runtime's): the work list is the
    canonical pixel x sample enumeration of `spi` samples, derived
    arithmetically from the work id, and radiance lands in a per-work-item
    slot buffer (`work_*` unused).  work_mode="tables": the explicit work
    list, (W,) integer tensors `work_x`, `work_y` (the pixel) and
    `work_sample` (its sample index), gathered per work item; radiance is
    added straight into the (H*W, 3) framebuffer, where lanes of one pixel
    collide (`index_add_`, whose sums on the card are atomic, in no fixed
    order).

    Tail cascade: once the work list is exhausted and the survivor count fits
    `tail_capacity`, the alive lanes are compacted into a narrow wave.

    stats: [wave iters, alive-lane visits, tail iters, camera rays emitted,
    hits, misses, shadow rays, occluded shadows, bounce continuations].
    """
    if work_mode not in ("arith", "tables"):
        raise ValueError(f"unknown work_mode '{work_mode}' (arith, tables)")
    arith = work_mode == "arith"
    npix = scene.width * scene.height
    c = int(capacity)
    dev = tables["tri_v0"].device
    f32 = dict(dtype=torch.float32, device=dev)
    is_vol = scene.technique.type == "volpath"
    if arith:
        w_total = npix * spi
    else:
        work_x, work_y, work_sample = (
            torch.as_tensor(a, device=dev).long()
            for a in (work_x, work_y, work_sample))
        w_total = work_x.shape[0]

    trivial = _flags_trivial(scene)
    # mixed camera/bounce lanes per wave: exact per-ray visibility needs
    # camera == bounce masks (the Runtime runs scenes that differ through
    # the per-sample driver)
    prim_mask = None if trivial else _tri_mask_for(tables, RAY_BOUNCE)
    shadow_mask = (None if _flags_trivial(scene, RAY_SHADOW)
                   else _tri_mask_for(tables, RAY_SHADOW))

    state = _fresh_state(c, dev)
    if arith:
        # `pixel` holds the framebuffer row of the lane: its work-item id.
        # Idle lanes park on the c spare rows past the end of `fb`, one
        # each, so `index_add_` never goes out of range.
        state["pixel"] = w_total + torch.arange(c, dtype=torch.int64,
                                                device=dev)
        fb = torch.zeros((w_total + c, 3), **f32)
    else:
        # `pixel` is the lane's pixel; idle lanes add zeros to pixel 0
        state["pixel"] = torch.zeros(c, dtype=torch.int64, device=dev)
        fb = torch.zeros((npix, 3), **f32)
    stats = torch.zeros(9, **f32)
    next_work = 0
    zero = torch.zeros((), **f32)
    one = torch.ones((), **f32)

    def splat_into_fb(st, splat):
        # in place: fb is the largest buffer of the step
        with span("accum"):
            fb.index_add_(0, st["pixel"],
                          torch.where(st["alive"][..., None], splat,
                                      torch.zeros_like(splat)))

    def body(st, next_work):
        # ---- regenerate: dead lanes pull the next work items
        dead = ~st["alive"]
        rank = torch.cumsum(dead.to(torch.int64), dim=0) - 1
        wid = next_work + rank
        take = dead & (wid < w_total)
        wid_c = torch.clamp(wid, 0, w_total - 1)
        if arith:
            pix = wid_c % npix
            gx = pix % scene.width
            gy = pix // scene.width
            gs = wid_c // npix
        else:
            gx, gy, gs = work_x[wid_c], work_y[wid_c], work_sample[wid_c]
        with span("emit"):
            seed_n, counter_n, org_n, dir_n, tmin_n, tmax_n = _emit_camera(
                scene, gx, gy, gs, iteration, frame, user_seed, tables, spi)

        sel = take[..., None]
        st = dict(st)
        st["org"] = torch.where(sel, org_n, st["org"])
        st["dir"] = torch.where(sel, dir_n, st["dir"])
        st["tmin"] = torch.where(take, tmin_n, st["tmin"])
        st["tmax"] = torch.where(take, tmax_n, st["tmax"])
        st["seed"] = torch.where(take, seed_n, st["seed"])
        st["counter"] = torch.where(take, counter_n, st["counter"])
        st["inv_pdf"] = torch.where(take, torch.zeros_like(st["inv_pdf"]),
                                    st["inv_pdf"])
        st["contrib"] = torch.where(sel, torch.ones_like(st["contrib"]),
                                    st["contrib"])
        st["depth"] = torch.where(take, torch.ones_like(st["depth"]),
                                  st["depth"])
        st["eta"] = torch.where(take, torch.ones_like(st["eta"]), st["eta"])
        if is_vol:
            st["medium"] = torch.where(take, torch.full_like(st["medium"], -1),
                                       st["medium"])
            st["voldepth"] = torch.where(
                take, torch.zeros_like(st["voldepth"]), st["voldepth"])
            st["nullfl"] = st["nullfl"] & ~take
        st["pixel"] = torch.where(take, wid_c if arith
                                  else gy * scene.width + gx, st["pixel"])
        st["alive"] = st["alive"] | take
        n_take = _count(take)

        # ---- one bounce for the whole wave
        with span("bounce"):
            splat, st_next, q = _bounce_core(scene, tables, st, prim_mask,
                                             shadow_mask)
        splat_into_fb(st, splat)
        st_next["pixel"] = st["pixel"]
        inc = torch.cat([torch.stack([one, _count(st["alive"]), zero,
                                      n_take]), q])
        return st_next, inc, n_take

    def fb_out():
        if not arith:
            return fb
        # per-work-item slots -> per-pixel sums
        return fb[:w_total].reshape(spi, npix, 3).sum(dim=0)

    tail_cap = int(min(tail_capacity, c))
    wide_only = tail_cap >= c
    while True:
        if next_work >= w_total:
            n_alive = host_item(state["alive"].sum())
            if n_alive == 0 or (not wide_only and n_alive <= tail_cap):
                break
        with span("wave", _WIDE):
            state, inc, n_take = body(state, next_work)
            stats = stats + inc
            if next_work < w_total:
                next_work += int(host_item(n_take))
    if wide_only:
        return fb_out(), stats

    # ---- compact survivors into the narrow tail wave (alive lanes first)
    _, tail = _compact(state, tail_cap, extra=("pixel",))
    while host_item(tail["alive"].any()):
        with span("wave", _TAIL):
            with span("bounce"):
                splat, st_next, q = _bounce_core(scene, tables, tail,
                                                 prim_mask, shadow_mask)
            splat_into_fb(tail, splat)
            st_next["pixel"] = tail["pixel"]
            stats = stats + torch.cat(
                [torch.stack([zero, _count(tail["alive"]), one, zero]), q])
            tail = st_next
    return fb_out(), stats


def _gather_mat_type(scene, tables, mat_id):
    """BSDF type id of each lane's material."""
    types = device_const(tuple(scene.bsdf_types), torch.int32, mat_id.device)
    return gather_rows(types, mat_id)


def _area_light_radiance(scene, tables, light_idx):
    """Radiance color of area lights by id (layout per light type)."""
    data = gather_rows(tables["light_data"], light_idx)
    ltype = gather_rows(tables["light_type"], light_idx)
    return torch.where((ltype == LIGHT_AREA_PLANE)[..., None],
                       data[:, 13:16], data[:, 0:3])
