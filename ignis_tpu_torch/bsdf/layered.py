"""Two-lobe materials, the constant normal modifier, and the BSDF entry points
the path technique calls.  Counterpart of ignis_tpu/bsdf/layered.py.

The scene compiler flattens wrapper chains (mix/blend/add/mask/cutoff,
normal modifiers, twosided) into at most two leaf lobes per material plus one
normal modifier; this module applies them with masked per-lane selects, so
scenes without wrappers take the single-lobe path.

  * eval  = lerp(evalA, evalB, k); `add` sums the two.
  * pdf   = lerp(pdfA,  pdfB,  k); `add` takes lobe A's unless it is
    specular.
  * sample: u < 1-k -> lobe A else B, then the one-sample MIS combine with
    the other lobe unless that one is specular; `add` samples lobe A only.
  * is_specular = specA & specB.
Normal modifiers: a strength-lerped normal map (kind 1), forward-difference
bump gradients at delta 1e-3 (kind 2), a constant normal and optional
tangent (kind 3) and a PExpr normal evaluated with the full shading context
(kind 4); the shading frame is rotated by the minimal rotation taking the old
normal to the new one.  Mix weights and lobe B's color slots may be textured.
"""

from __future__ import annotations

import numpy as np
import torch

from ignis_tpu_torch.bsdf import union
from ignis_tpu_torch.core import rng
from ignis_tpu_torch.core.dgather import gather_rows
from ignis_tpu_torch.core.vec import (
    FLT_EPS, clip, cross, device_const, dot, maximum, normalize, safe_div,
)
from ignis_tpu_torch.texture.eval import (
    eval_texture_stack, resolve_color, texture_ids,
)


def scene_has_lobes(scene) -> bool:
    return any(t >= 0 for t in getattr(scene, "bsdf_types_b", []))


def scene_has_nmod(scene) -> bool:
    return any(getattr(scene, "nmod_kinds", []))


# ------------------------------------------------------------ normal mods
def _align_rotation_apply(a, b, x):
    """Rotate x by the minimal rotation taking unit vector a to unit b."""
    v = cross(a, b)
    c = dot(a, b)
    # Rodrigues; the antiparallel case falls back to about the identity
    # (apply_normal_mod keeps the new normal in the view's hemisphere)
    f = safe_div(1.0, maximum(1.0 + c, 1e-6))
    return (x * c[..., None] + cross(v, x)
            + v * (dot(v, x) * f)[..., None])


def apply_normal_mod(scene, tables, surf, d, org=None):
    """Perturb the shading frame by the material's normal modifier.  `org`
    (the rays' origins) is read by PExpr normals only."""
    if not scene_has_nmod(scene):
        return surf
    mat_id = surf["mat_id"].long()
    kind = tables["mat_nmod_kind"][mat_id]          # (N,)
    f = tables["mat_nmod_f"][mat_id]                # (N, 8)
    tex = tables["mat_nmod_tex"][mat_id]            # (N,)
    uv = surf["tex"]
    n, t, b = surf["n"], surf["t"], surf["b"]
    strength = f[:, 0]

    kinds_present = set(scene.nmod_kinds)
    nmod_tex = scene.tables["mat_nmod_tex"]

    def ids(k):
        # the textures of kind-k materials: the only ones a lane of kind k
        # reads, and only those lanes keep the result
        return texture_ids(nmod_tex, np.asarray(scene.nmod_kinds) == k)

    n_new = n
    if 1 in kinds_present:  # normal map
        c = resolve_color(scene, tables, f[:, 1:4], tex, uv, ids=ids(1))
        local = normalize(2.0 * c - 1.0)
        o_n = t * local[:, 0:1] + b * local[:, 1:2] + n * local[:, 2:3]
        nm = normalize(n + (o_n - n) * strength[..., None])
        n_new = torch.where((kind == 1)[..., None], nm, n_new)
    if 2 in kinds_present:  # bump map: forward differences, delta 1e-3
        step_u = device_const((1e-3, 0.0), torch.float32, uv.device)
        step_v = device_const((0.0, 1e-3), torch.float32, uv.device)
        i2 = ids(2)
        h0 = eval_texture_stack(scene, tables, tex, uv, ids=i2)[:, 0]
        hx = eval_texture_stack(scene, tables, tex, uv + step_u,
                                ids=i2)[:, 0]
        hy = eval_texture_stack(scene, tables, tex, uv + step_v,
                                ids=i2)[:, 0]
        delta = float(np.float32(1e-3))
        dx = (hx - h0) / delta
        dy = (hy - h0) / delta
        nb = normalize(n - (t * dx[..., None] + b * dy[..., None])
                       * strength[..., None])
        n_new = torch.where((kind == 2)[..., None], nb, n_new)
    if 3 in kinds_present:  # the normal (and tangent) set
        n_new = torch.where((kind == 3)[..., None], normalize(f[:, 1:4]),
                            n_new)
    if 4 in kinds_present:  # a PExpr normal
        # the expression sees the full shading context, so that bump() and
        # ensure_valid_reflection() read the real N, Nx, Ny, Ng and V
        from ignis_tpu_torch.render.integrator import _pexpr_ctx
        ctx = _pexpr_ctx(tables, surf,
                         surf["point"] - d if org is None else org, d)
        c = eval_texture_stack(scene, tables, tex, uv, ctx, ids=ids(4))
        n_new = torch.where((kind == 4)[..., None], normalize(c), n_new)

    # reject perturbations that put the view below the shading horizon
    ok = dot(-d, n_new) > FLT_EPS
    n_new = torch.where(ok[..., None], n_new, n)

    t_new = normalize(_align_rotation_apply(n, n_new, t))
    b_new = normalize(_align_rotation_apply(n, n_new, b))
    if 3 in kinds_present:
        sel = ((kind == 3) & (f[:, 7] > 0.5))[..., None]
        tan = normalize(f[:, 4:7])
        t_new = torch.where(sel, tan, t_new)
        b_new = torch.where(sel, normalize(cross(tan, n_new)), b_new)
    surf["n"] = n_new
    surf["t"] = t_new
    surf["b"] = b_new
    return surf


# ---------------------------------------------------------------- prepare
def prepare_surface(scene, tables, surf, d, org=None):
    """Normal modifier, lobe parameters and per-lane mix weights.

    Returns (mat_type, specular_mask); adds colors and scalars to surf in
    place, and for two-lobe scenes colors_b, scalars_b, mix_k, mix_kind and
    mat_type_b.  `org` (the rays' origins) is read by PExpr normals."""
    apply_normal_mod(scene, tables, surf, d, org)
    dev = d.device
    mat_id = surf["mat_id"].long()
    types = device_const(tuple(scene.bsdf_types), torch.int32, dev)
    mat_type = types[mat_id]
    surf["colors"], surf["scalars"] = union.material_params(
        scene, tables, surf)
    spec = union.bsdf_specular_mask(scene.bsdf_types, mat_type)
    if not scene_has_lobes(scene):
        return mat_type, spec

    types_b = device_const(tuple(max(t, 0) for t in scene.bsdf_types_b),
                           torch.int32, dev)
    mat_type_b = types_b[mat_id]
    surf["mat_type_b"] = mat_type_b
    surf["mix_kind"] = tables["mat_mix_kind"][mat_id]
    colors_b = gather_rows(tables["mat_colors_b"], mat_id)
    if scene.textures:
        colors_b = union.resolve_slots(scene, tables, colors_b, "mat_tex_b",
                                       mat_id, surf["tex"])
    surf["colors_b"] = colors_b
    surf["scalars_b"] = gather_rows(tables["mat_scalars_b"], mat_id)

    # mix weight k (the weight of lobe B), optionally textured, then the
    # cutoff
    wf = tables["mat_wrap_f"][mat_id]
    k = wf[:, 0]
    wrap_ids = texture_ids(scene.tables["mat_wrap_tex"])
    if wrap_ids:
        ktex = resolve_color(scene, tables, k[..., None].repeat(1, 3),
                             tables["mat_wrap_tex"][mat_id], surf["tex"],
                             ids=wrap_ids)
        k = ktex[:, 0]
    cut = wf[:, 1]
    k = torch.where(cut >= 0.0, torch.where(k < cut, torch.zeros_like(k),
                                            torch.ones_like(k)), k)
    surf["mix_k"] = clip(k, 0.0, 1.0)

    spec_b = union.bsdf_specular_mask(union.lobe_types(scene, "b"),
                                      mat_type_b)
    return mat_type, torch.where(surf["mix_kind"] > 0, spec & spec_b, spec)


def _two_lobe(scene, surf):
    return scene_has_lobes(scene) and "mat_type_b" in surf


# ------------------------------------------------------------- eval / pdf
def bsdf_eval(scene, tables, mat_type, surf, in_dir, out_dir):
    ea = union.bsdf_eval(scene, tables, mat_type, surf, in_dir, out_dir)
    if not _two_lobe(scene, surf):
        return ea
    eb = union.bsdf_eval(scene, tables, surf["mat_type_b"], surf, in_dir,
                         out_dir, lobe="b")
    k = surf["mix_k"][..., None]
    kind = surf["mix_kind"]
    mixed = torch.where((kind == 2)[..., None], ea + eb,
                        ea * (1.0 - k) + eb * k)
    return torch.where((kind > 0)[..., None], mixed, ea)


def bsdf_pdf(scene, tables, mat_type, surf, in_dir, out_dir):
    pa = union.bsdf_pdf(scene, tables, mat_type, surf, in_dir, out_dir)
    if not _two_lobe(scene, surf):
        return pa
    pb = union.bsdf_pdf(scene, tables, surf["mat_type_b"], surf, in_dir,
                        out_dir, lobe="b")
    k = surf["mix_k"]
    kind = surf["mix_kind"]
    spec_a = union.bsdf_specular_mask(scene.bsdf_types, mat_type)
    # add: the first lobe's pdf unless it is specular
    add_pdf = torch.where(spec_a, pb, pa)
    mixed = torch.where(kind == 2, add_pdf, pa * (1.0 - k) + pb * k)
    return torch.where(kind > 0, mixed, pa)


# ----------------------------------------------------------------- sample
def bsdf_sample(scene, tables, mat_type, surf, seed, counter, out_dir,
                active=None, adjoint=False):
    if not _two_lobe(scene, surf):
        return union.bsdf_sample(scene, tables, mat_type, surf, seed,
                                 counter, out_dir, active=active,
                                 adjoint=adjoint)
    if active is None:
        active = torch.ones_like(mat_type, dtype=torch.bool)
    kind = surf["mix_kind"]
    k = surf["mix_k"]
    is_mix = (kind == 1) & active

    # As in the reference package, a lane whose chosen lobe gives an invalid
    # sample dies rather than retrying with the other lobe.
    # The lobe pick draws from mix lanes only.
    u_pick, c_pick = rng.next_f32(seed, counter)
    c0 = torch.where(is_mix, c_pick, counter)
    pick_b = is_mix & (u_pick >= 1.0 - k)

    mat_type_b = surf["mat_type_b"]
    ra = union.bsdf_sample(scene, tables, mat_type, surf, seed, c0, out_dir,
                           active=active & ~pick_b, adjoint=adjoint)
    rb = union.bsdf_sample(scene, tables, mat_type_b, surf, seed, c0,
                           out_dir, active=pick_b, adjoint=adjoint, lobe="b")
    pb_c = pick_b[..., None]
    in_dir = torch.where(pb_c, rb[0], ra[0])
    pdf = torch.where(pick_b, rb[1], ra[1])
    weight = torch.where(pb_c, rb[2], ra[2])
    eta = torch.where(pick_b, rb[3], ra[3])
    valid = torch.where(pick_b, rb[4], ra[4])
    new_counter = torch.where(pick_b, rb[5], ra[5])

    # one-sample MIS combine against the unchosen lobe, skipped when that
    # lobe is specular
    spec_a = union.bsdf_specular_mask(scene.bsdf_types, mat_type)
    spec_b = union.bsdf_specular_mask(union.lobe_types(scene, "b"),
                                      mat_type_b)
    other_spec = torch.where(pick_b, spec_a, spec_b)
    do_mis = is_mix & valid & ~other_spec
    ea = union.bsdf_eval(scene, tables, mat_type, surf, in_dir, out_dir)
    eb = union.bsdf_eval(scene, tables, mat_type_b, surf, in_dir, out_dir,
                         lobe="b")
    pa = union.bsdf_pdf(scene, tables, mat_type, surf, in_dir, out_dir)
    pb = union.bsdf_pdf(scene, tables, mat_type_b, surf, in_dir, out_dir,
                        lobe="b")
    # the chosen lobe's sampled pdf and eval stand for its own
    pa_m = torch.where(pick_b, pa, pdf)
    pb_m = torch.where(pick_b, pdf, pb)
    chosen = weight * pdf[..., None]
    ea_m = torch.where(pb_c, ea, chosen)
    eb_m = torch.where(pb_c, chosen, eb)
    p_mix = pa_m * (1.0 - k) + pb_m * k
    c_mix = ea_m * (1.0 - k)[..., None] + eb_m * k[..., None]
    w_mix = c_mix * safe_div(1.0, p_mix)[..., None]
    ok = do_mis & (p_mix > 0.0)
    pdf = torch.where(ok, p_mix, pdf)
    weight = torch.where(ok[..., None], w_mix, weight)
    return in_dir, pdf, weight, eta, valid, new_counter
