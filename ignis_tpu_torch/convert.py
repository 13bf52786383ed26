"""Table and metadata conversion between numpy and the port's tensors.

`tables_from_numpy` is how every compiled table reaches the device;
`params_from_numpy` does the same and makes the named tables parameters of a
gradient (float32 leaves that require grad).
`runtime_from_jax_tables` builds a `Runtime` from tables and scene metadata
compiled elsewhere (the JAX package's `Runtime`), so that tests can put the
very same state through both packages; the normal entry points use the port's
own compiler.  Nothing here imports the JAX package: callers hand over numpy
arrays and a metadata object, read by attribute.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ignis_tpu_torch.scene.compile import (
    CameraConfig, CompiledScene, LightInfo, TechniqueConfig,
)


def tables_from_numpy(tables, device):
    """dict[str, array-like] -> dict[str, torch.Tensor | int | float].

    dtypes are kept (float32, int32, int64, bool); unsigned 32-bit seeds and
    counters go to the port's integer carrier, int64.  0-d entries (e.g.
    `pb_depth`, `bw_ntris`) become Python scalars: they are sizes, read on
    the host."""
    out = {}
    for k, v in tables.items():
        a = np.asarray(v)
        if a.ndim == 0:
            out[k] = a.item()
            continue
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        elif a.dtype == np.float64:
            a = a.astype(np.float32)
        # a copy: the tables are written in place (setParameter) and must
        # not alias the compiled scene's arrays; one copy only, the move to
        # a CUDA device's (a medium's grid may take gigabytes)
        if not (a.flags.c_contiguous and a.flags.writeable):
            a = np.array(a, order="C")
        out[k] = torch.from_numpy(a).to(device, copy=True)
    return out


def params_from_numpy(tables, keys, device):
    """`tables_from_numpy`, with the tables named in `keys` made float32
    leaf tensors with `requires_grad=True`: the parameters of
    `trace_wave(differentiable=True)` and of `parallel.sharding.train_step`.
    Any float table can be one: material and light rows, an image texture
    (`tex{i}_img`, (H, W, 3)) or the registry (`params`), which textures and
    PExpr expressions read at shading time.

        tables = params_from_numpy(scene.tables, ("mat_colors",), "cuda")
        trace_wave(scene, tables, x, y, 0, 0, 0, 0,
                   differentiable=True).sum().backward()
        tables["mat_colors"].grad
    """
    out = tables_from_numpy(tables, device)
    for k in keys:
        out[k] = out[k].to(torch.float32).requires_grad_(True)
    return out


def tables_to_numpy(tables):
    """Inverse of `tables_from_numpy` (scalars become 0-d arrays)."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in tables.items()}


def _copy_dataclass(cls, src, **extra):
    kw = {}
    for f in dataclasses.fields(cls):
        if hasattr(src, f.name):
            kw[f.name] = getattr(src, f.name)
    kw.update(extra)
    return cls(**kw)


def scene_from_metadata(meta) -> CompiledScene:
    """The port's `CompiledScene` from any object that carries the metadata
    the integrator reads: width, height, sampler, camera, technique,
    bsdf_types, lights (with a sky's parameters), lh_depth, param_registry,
    bbox_min/max, textures, media, the measured materials' info and the
    compiled numpy `tables`."""
    cam = _copy_dataclass(CameraConfig, meta.camera)
    for extra in ("auto_frame", "fov", "fov_vertical", "aspect"):
        if hasattr(meta.camera, extra):
            setattr(cam, extra, getattr(meta.camera, extra))
    tech = _copy_dataclass(TechniqueConfig, meta.technique)
    lights = []
    for l in meta.lights:
        li = _copy_dataclass(LightInfo, l)
        if getattr(l, "sky", None) is not None:
            li.sky = l.sky
        lights.append(li)
    cs = CompiledScene(
        width=int(meta.width), height=int(meta.height), sampler=meta.sampler,
        camera=cam, technique=tech, bsdf_types=list(meta.bsdf_types),
        lights=lights, num_entities=int(getattr(meta, "num_entities", 0)),
        tables={k: np.asarray(v) for k, v in meta.tables.items()},
        bbox_min=np.asarray(meta.bbox_min), bbox_max=np.asarray(meta.bbox_max),
        entity_names=list(getattr(meta, "entity_names", [])),
        material_names=list(getattr(meta, "material_names", [])),
        textures=list(getattr(meta, "textures", [])),
        media=list(getattr(meta, "media", [])))
    cs.bsdf_types_b = list(getattr(meta, "bsdf_types_b",
                                   [-1] * len(cs.bsdf_types)))
    cs.mix_kinds = list(getattr(meta, "mix_kinds", [0] * len(cs.bsdf_types)))
    cs.nmod_kinds = list(getattr(meta, "nmod_kinds",
                                 [0] * len(cs.bsdf_types)))
    cs.halton_setup = getattr(meta, "halton_setup", None)
    # the light hierarchy's descent length, set after construction
    cs.lh_depth = int(getattr(meta, "lh_depth", 0))
    cs.param_registry = dict(getattr(meta, "param_registry", {}) or {})
    cs.parameter_values = dict(getattr(meta, "parameter_values", {}) or {})
    cs.instanced = getattr(meta, "instanced", None)
    # the measured materials' static info (totals, up vector, slice counts),
    # copied: the port keeps derived facts (a tree's depth) beside them
    for key in ("klems_info", "tensortree_info", "djmeasured_info"):
        setattr(cs, key, copy.deepcopy(dict(getattr(meta, key, {}) or {})))
    return cs


def runtime_from_jax_tables(meta, tables, device=None, seed=0,
                            tile_size=None):
    """A port `Runtime` over tables compiled by the JAX package.

    meta:   its compiled scene (metadata read by attribute, see
            `scene_from_metadata`).
    tables: its runtime tables as numpy arrays, `bw_*` / `pb_*` /
            `tri_shade` / `tl_*` / `sph_rows` included when present; they
            are used as they are, nothing is rebuilt.
    """
    from ignis_tpu_torch.api import Runtime
    scene = scene_from_metadata(meta)
    kw = {} if tile_size is None else dict(tile_size=tile_size)
    return Runtime.from_compiled(scene, {k: np.asarray(v)
                                         for k, v in tables.items()},
                                 device=device, seed=seed, **kw)
