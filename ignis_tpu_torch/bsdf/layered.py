"""Surface preparation and the BSDF entry points the path technique calls.

Counterpart of ignis_tpu/bsdf/layered.py for materials with a single lobe and
no normal modifier: `prepare_surface`, `bsdf_eval`, `bsdf_pdf`, `bsdf_sample`
pass straight to the union.  Two-lobe wrappers (mix/add/mask/cutoff) and
normal modifiers (bumpmap/normalmap/transform) raise.
"""

from __future__ import annotations

import torch

from ignis_tpu_torch.bsdf import union


def scene_has_lobes(scene) -> bool:
    return any(t >= 0 for t in getattr(scene, "bsdf_types_b", []))


def scene_has_nmod(scene) -> bool:
    return any(getattr(scene, "nmod_kinds", []))


def _check(scene):
    if scene_has_nmod(scene):
        raise NotImplementedError(
            "normal modifiers are not ported to ignis_tpu_torch yet")
    if scene_has_lobes(scene):
        raise NotImplementedError(
            "two-lobe BSDFs are not ported to ignis_tpu_torch yet")


def prepare_surface(scene, tables, surf, d, org=None):
    """Resolve per-lane material parameters.

    Returns (mat_type, specular_mask); adds `colors` and `scalars` to surf
    in place."""
    _check(scene)
    types = torch.as_tensor(scene.bsdf_types, dtype=torch.int32,
                            device=d.device)
    mat_type = types[surf["mat_id"].long()]
    surf["colors"], surf["scalars"] = union.material_params(
        scene, tables, surf)
    spec = union.bsdf_specular_mask(scene.bsdf_types, mat_type)
    return mat_type, spec


def bsdf_eval(scene, tables, mat_type, surf, in_dir, out_dir):
    return union.bsdf_eval(scene, tables, mat_type, surf, in_dir, out_dir)


def bsdf_pdf(scene, tables, mat_type, surf, in_dir, out_dir):
    return union.bsdf_pdf(scene, tables, mat_type, surf, in_dir, out_dir)


def bsdf_sample(scene, tables, mat_type, surf, seed, counter, out_dir,
                active=None, adjoint=False):
    return union.bsdf_sample(scene, tables, mat_type, surf, seed, counter,
                             out_dir, active=active, adjoint=adjoint)
