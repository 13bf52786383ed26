"""Batched texture evaluation.  Counterpart of ignis_tpu/texture/eval.py.

`eval_texture_stack` dispatches per-lane texture ids over the scene's static
texture list with masked selects: every texture is evaluated on every lane,
as in the JAX package.  Float -> int casts saturate as XLA's do
(`core.vec.to_int32`); the noise hash runs in the int64 carrier of
`core.rng` (32-bit values, masked after every multiply).
"""

from __future__ import annotations

import numpy as np
import torch

from ignis_tpu_torch.core.rng import M32, _u32, mul_u32
from ignis_tpu_torch.core.vec import device_const, device_scalar, to_int32
from ignis_tpu_torch.texture.loader import (
    FILTER_NEAREST, TEX_BRICK, TEX_CHECKERBOARD, TEX_EXPR, TEX_IMAGE,
    TEX_NOISE, WRAP_MIRROR, WRAP_REPEAT,
)


def _tuples(x):
    return tuple(map(_tuples, x)) if isinstance(x, list) else x


def _const(a, device):
    """A numpy constant of a texture record as a cached device tensor."""
    return device_const(_tuples(np.asarray(a, np.float32).tolist()),
                        torch.float32, device)


def _wrap(x, w, mode):
    if mode == WRAP_REPEAT:
        t = torch.remainder(x, w)
        return torch.where(t < 0, t + w, t)
    if mode == WRAP_MIRROR:
        t = torch.where(x < 0, -1 - x, x)
        i = torch.div(t, w, rounding_mode="floor")
        k = t - i * w
        return torch.where((i & 1) == 0, w - 1 - k, k)
    return torch.clamp(x, 0, w - 1)


def _transform_uv(tex, uv):
    m = _const(tex["transform"], uv.device)
    return uv @ m[:, :2].T + m[:, 2]


def _sample_image(img, uv, filt, wrap_u, wrap_v):
    h, w = img.shape[0], img.shape[1]
    if filt == FILTER_NEAREST:
        ix = to_int32(torch.floor(uv[..., 0] * w))
        iy = to_int32(torch.floor(uv[..., 1] * h))
        return img[_wrap(iy, h, wrap_v).long(), _wrap(ix, w, wrap_u).long()]
    # bilinear (bicubic falls back to bilinear, as in the JAX package)
    u = uv[..., 0] * w - 0.5
    v = uv[..., 1] * h - 0.5
    fu, fv = torch.floor(u), torch.floor(v)
    ix = to_int32(fu)
    iy = to_int32(fv)
    fx = (u - fu)[..., None]
    fy = (v - fv)[..., None]
    x0 = _wrap(ix, w, wrap_u).long()
    x1 = _wrap(ix + 1, w, wrap_u).long()
    y0 = _wrap(iy, h, wrap_v).long()
    y1 = _wrap(iy + 1, h, wrap_v).long()
    p00 = img[y0, x0]
    p10 = img[y0, x1]
    p01 = img[y1, x0]
    p11 = img[y1, x1]
    return ((p00 * (1 - fx) + p10 * fx) * (1 - fy)
            + (p01 * (1 - fx) + p11 * fx) * fy)


def _wrapf(x, lo, hi):
    """math::wrap for floats."""
    d = hi - lo
    t = torch.remainder(x - lo, d)
    return torch.where(t < 0, t + d, t) + lo


def _checkerboard(scene, tables, tex, uv, ctx=None):
    dev = uv.device

    def _dyn(key, const, color=False):
        """Constant or PExpr-string property (registry params etc.)."""
        ref = tex.get(key + "_ref")
        if ref is None:
            return _const(const, dev)
        from ignis_tpu_torch.texture.pexpr import eval_pexpr
        kind, val = eval_pexpr(scene, tables, ref,
                               {"uv": uv} if ctx is None else ctx)
        val = val.to(torch.float32)
        if color:
            if kind in ("num", "int", "bool"):
                val = val[..., None] * torch.ones(3, dtype=torch.float32,
                                                  device=dev)
            elif kind == "vec4":
                val = val[..., :3]
            elif kind == "vec2":
                val = torch.cat([val, torch.zeros(
                    val.shape[:-1] + (1,), dtype=torch.float32, device=dev)],
                    -1)
        return val

    uv2 = _transform_uv(tex, uv)
    sx = _dyn("scale_x", tex["scale"][0])
    sy = _dyn("scale_y", tex["scale"][1])
    suv = uv2 * torch.stack(torch.broadcast_tensors(sx, sy), dim=-1)
    px = torch.remainder(to_int32(_wrapf(suv[..., 0], 0.0, 2.0)), 2) == 0
    py = torch.remainder(to_int32(_wrapf(suv[..., 1], 0.0, 2.0)), 2) == 0
    sel = px ^ py
    return torch.where(sel[..., None], _dyn("color0", tex["color0"], True),
                       _dyn("color1", tex["color1"], True))


def _brick(tex, uv):
    """Running-bond bricks; body -> color1, gap -> color0 (the body is where
    x <= 1 - gap)."""
    dev = uv.device
    uv2 = _transform_uv(tex, uv)
    suv = uv2 * _const(tex["scale"], dev)
    # the thresholds as the JAX package rounds them: in Python, then to f32
    tx = float(np.float32(1.0 - float(tex["gap"][0])))
    ty = float(np.float32(1.0 - float(tex["gap"][1])))
    fy = suv[..., 1] * 0.5 - torch.floor(suv[..., 1] * 0.5)
    xs = torch.where(fy > 0.5, suv[..., 0] + 0.5, suv[..., 0])
    x = xs - torch.floor(xs)
    y = suv[..., 1] - torch.floor(suv[..., 1])
    zero, one = device_scalar(0.0, dev), device_scalar(1.0, dev)
    bx = torch.where(tx < x, zero, one)
    by = torch.where(ty < y, zero, one)
    k = (bx * by)[..., None]
    c0 = _const(tex["color0"], dev)
    c1 = _const(tex["color1"], dev)
    return c0 * (1.0 - k) + c1 * k


def _hash2(ix, iy, seed):
    h = mul_u32(ix, 0x85EBCA6B) ^ mul_u32(iy, 0xC2B2AE35) ^ (seed & M32)
    h = h ^ (h >> 13)
    h = mul_u32(h, 0x27D4EB2F)
    h = h ^ (h >> 15)
    return h


def _unit(h):
    return (h & 0xFFFFFF).to(torch.float32) / float(0x1000000)


def noise2(p, seed):
    """Value noise with smooth interpolation."""
    fpx, fpy = torch.floor(p[..., 0]), torch.floor(p[..., 1])
    ix = _u32(to_int32(fpx))
    iy = _u32(to_int32(fpy))
    fx = p[..., 0] - fpx
    fy = p[..., 1] - fpy

    def val(dx, dy):
        return _unit(_hash2((ix + dx) & M32, (iy + dy) & M32, seed))

    sx = fx * fx * (3.0 - 2.0 * fx)
    sy = fy * fy * (3.0 - 2.0 * fy)
    a = val(0, 0) * (1 - sx) + val(1, 0) * sx
    b = val(0, 1) * (1 - sx) + val(1, 1) * sx
    return a * (1 - sy) + b * sy


def _noise(tex, uv):
    dev = uv.device
    p = uv * _const([tex["scale_x"], tex["scale_y"]], dev)
    variant = tex["variant"]
    seed = tex["seed"]
    if variant in ("fbm",):
        v = torch.zeros(uv.shape[:-1], dtype=torch.float32, device=dev)
        amp, freq = 0.5, 1.0
        for o in range(4):
            v = v + amp * noise2(p * freq, seed + o)
            amp *= 0.5
            freq *= 2.0
    elif variant in ("cellnoise", "voronoi"):
        ix = _u32(to_int32(torch.floor(p[..., 0])))
        iy = _u32(to_int32(torch.floor(p[..., 1])))
        v = _unit(_hash2(ix, iy, seed))
    else:  # noise / perlin / pnoise -> smooth value noise
        v = noise2(p, seed)
    return _const(tex["color"], dev) * v[..., None]


def eval_one(scene, tables, tex, uv, ctx=None):
    t = tex["type"]
    if t == TEX_IMAGE:
        return _sample_image(tables[tex["img_key"]], _transform_uv(tex, uv),
                             tex["filter"], tex["wrap_u"], tex["wrap_v"])
    if t == TEX_CHECKERBOARD:
        return _checkerboard(scene, tables, tex, uv, ctx)
    if t == TEX_NOISE:
        return _noise(tex, uv)
    if t == TEX_BRICK:
        return _brick(tex, uv)
    if t == TEX_EXPR:
        from ignis_tpu_torch.texture.pexpr import eval_pexpr_color
        return eval_pexpr_color(scene, tables, tex["expr"], uv, ctx)
    return torch.broadcast_to(device_const((1.0, 0.0, 1.0), torch.float32,
                                           uv.device), uv.shape[:-1] + (3,))


def eval_texture_stack(scene, tables, tex_id, uv, ctx=None, ids=None):
    """Per-lane texture eval: tex_id (N,) int32 (-1 = none -> black).

    `ids`, when given, is the set of texture ids `tex_id` can hold (read
    from the compiled tables by the caller): the other textures are not
    evaluated, as no lane would select them, so every value is the one the
    whole stack gives."""
    out = torch.zeros(uv.shape[:-1] + (3,), dtype=torch.float32,
                      device=uv.device)
    for i, tex in enumerate(scene.textures):
        if tex.get("_unused", False) or (ids is not None and i not in ids):
            continue
        v = eval_one(scene, tables, tex, uv, ctx)
        out = torch.where((tex_id == i)[..., None], v, out)
    return out


def resolve_color(scene, tables, const_colors, tex_ids, uv, ctx=None,
                  ids=None):
    """Constant-or-texture color: lanes with tex_ids >= 0 take the texture.

    const_colors: (N, 3); tex_ids: (N,); `ids` as for
    `eval_texture_stack`."""
    if not scene.textures:
        return const_colors
    tex = eval_texture_stack(scene, tables, tex_ids, uv, ctx, ids)
    return torch.where((tex_ids >= 0)[..., None], tex, const_colors)


def texture_ids(table, where=None):
    """The texture ids a compiled id table (numpy) holds, over the rows
    `where` selects (all rows by default)."""
    t = np.asarray(table)
    if where is not None:
        t = t[np.asarray(where, bool)]
    return {int(i) for i in np.unique(t) if i >= 0}
