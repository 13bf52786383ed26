"""The port's texture layer (`texture/eval.py`, `texture/loader.py`'s EXR
path, `utils/exr.py`, `scene/compile._bake_texture`, `api.Runtime.bake`)
against the JAX package's.

Inputs are made with numpy from a seed; uv lanes run past [0, 1] on both
sides so that every wrap mode wraps.  Tolerances: image, checkerboard,
brick and noise textures bit for bit (the same float32 operations in the
same order, the casts saturating as XLA's), except where a uv transform or
a PExpr property goes through a matrix product or a transcendental
function: there 1e-6 absolute and relative.  EXR files: equal.
"""

import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.texture import eval as jeval
from ignis_tpu.texture import loader as jloader
from ignis_tpu.utils import exr as jexr
from ignis_tpu_torch.core.vec import to_int32
from ignis_tpu_torch.texture import eval as teval
from ignis_tpu_torch.texture import loader as tloader
from ignis_tpu_torch.utils import exr as texr

TOL = dict(rtol=1e-6, atol=1e-6)


def _uv(n=512, seed=0, lo=-1.7, hi=2.3):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 2)).astype(
        np.float32)


class _Scene:
    def __init__(self, textures, registry=None, values=None):
        self.textures = textures
        self.param_registry = registry or {}
        self.parameter_values = values or {}


def _both(scene, tables, fn, *args):
    jt = {k: jnp.asarray(v) for k, v in tables.items()}
    tt = {k: torch.from_numpy(np.asarray(v)) for k, v in tables.items()}
    conv = [(jnp.asarray(a), torch.from_numpy(a)) if isinstance(a, np.ndarray)
            else (a, a) for a in args]
    ref = getattr(jeval, fn)(scene, jt, *[c[0] for c in conv])
    got = getattr(teval, fn)(scene, tt, *[c[1] for c in conv])
    return np.asarray(ref), got.numpy()


def _image(h=5, w=7, seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(
        np.float32)


def _image_tex(filt, wrap, transform=None):
    t = np.eye(2, 3, dtype=np.float32) if transform is None else transform
    return dict(type=tloader.TEX_IMAGE, name="img", img_key="tex0_img",
                filter=filt, wrap_u=wrap, wrap_v=wrap, transform=t,
                linear=False)


# --------------------------------------------------------------- the cast
def test_to_int32_saturates_as_xla():
    x = np.float32([np.nan, 3e9, -3e9, np.inf, -np.inf, 2.5, -2.5, -0.5,
                    2147483520.0, 2147483648.0, -2147483648.0, 7.99])
    ref = np.asarray(jnp.asarray(x).astype(jnp.int32))
    got = to_int32(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(ref[:5], [0, 2147483647, -2147483648,
                                            2147483647, -2147483648])


# ------------------------------------------------------------ image / eval
@pytest.mark.parametrize("filt", [tloader.FILTER_NEAREST,
                                  tloader.FILTER_BILINEAR,
                                  tloader.FILTER_BICUBIC])
@pytest.mark.parametrize("wrap", [tloader.WRAP_REPEAT, tloader.WRAP_MIRROR,
                                  tloader.WRAP_CLAMP])
def test_image_texture_matches_jax(filt, wrap):
    tex = _image_tex(filt, wrap)
    uv = _uv(seed=filt * 3 + wrap)
    uv[:4] = np.float32([[np.nan, 0.5], [np.inf, -np.inf], [3e9, -3e9],
                         [1.0, 0.0]])
    ref, got = _both(_Scene([tex]), {"tex0_img": _image()}, "eval_one", tex,
                     uv)
    assert got.shape == (uv.shape[0], 3)
    np.testing.assert_array_equal(got, ref)


def test_image_texture_transform_matches_jax():
    m = np.float32([[2.0, 0.5, 0.1], [-0.3, 1.5, 0.25]])
    tex = _image_tex(tloader.FILTER_BILINEAR, tloader.WRAP_REPEAT, m)
    ref, got = _both(_Scene([tex]), {"tex0_img": _image()}, "eval_one", tex,
                     _uv(seed=9))
    np.testing.assert_allclose(got, ref, **TOL)


def _checker(**kw):
    d = dict(type=tloader.TEX_CHECKERBOARD, name="check",
             color0=np.float32([0.1, 0.2, 0.3]),
             color1=np.float32([0.9, 0.8, 0.7]), scale=np.float32([3, 5]),
             transform=np.eye(2, 3, dtype=np.float32))
    d.update(kw)
    return d


def _brick(**kw):
    d = dict(type=tloader.TEX_BRICK, name="brick",
             color0=np.float32([0.2, 0.2, 0.2]),
             color1=np.float32([0.7, 0.3, 0.2]), scale=np.float32([3, 6]),
             gap=np.float32([0.05, 0.1]),
             transform=np.eye(2, 3, dtype=np.float32))
    d.update(kw)
    return d


def _noise(variant, seed=0):
    return dict(type=tloader.TEX_NOISE, name=variant, variant=variant,
                color=np.float32([0.9, 0.6, 0.3]), colored=False,
                scale_x=7.5, scale_y=11.0, seed=seed)


PATTERNS = {
    "checkerboard": _checker(),
    "checkerboard transformed": _checker(transform=np.float32(
        [[1.0, 0.0, 0.3], [0.0, 1.0, -0.2]])),
    "brick": _brick(),
    "noise": _noise("noise"), "perlin": _noise("perlin", 4),
    "pnoise": _noise("pnoise"), "fbm": _noise("fbm", 2),
    "cellnoise": _noise("cellnoise", 7), "voronoi": _noise("voronoi"),
    "expr": dict(type=tloader.TEX_EXPR, name="e",
                 expr="vec3(uv.x * 2, fract(uv.y * 3), 0.25)", obj={}),
    "unknown": dict(type=99, name="bad"),
}


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_pattern_texture_matches_jax(name):
    tex = PATTERNS[name]
    uv = _uv(seed=len(name))
    ref, got = _both(_Scene([tex]), {}, "eval_one", tex, uv)
    assert np.broadcast_to(got, (uv.shape[0], 3)).shape == (uv.shape[0], 3)
    if name in ("checkerboard", "brick") or name in ("noise", "perlin",
                                                     "pnoise", "fbm",
                                                     "cellnoise", "voronoi"):
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, **TOL)


def test_checkerboard_registry_properties_match_jax():
    """Scale and colors as PExpr strings: registry reads from `params`."""
    tex = _checker(scale_x_ref="p_scale", scale_y_ref="p_scale * 2",
                   color0_ref="p_col0", color1_ref="vec3(uv.x, 0.5, 1)")
    reg = {"p_scale": ("num", 0, 1), "p_col0": ("vec4", 1, 4)}
    params = np.float32([4.0, 0.3, 0.6, 0.9, 1.0])
    scene = _Scene([tex], reg)
    ref, got = _both(scene, {"params": params}, "eval_one", tex,
                     _uv(seed=3, lo=0.0, hi=1.0))
    np.testing.assert_allclose(got, ref, **TOL)
    assert set(np.unique(got[:, 1]).tolist()) >= {0.5, float(np.float32(0.6))}


def test_texture_stack_and_resolve_color_match_jax():
    texs = [_image_tex(tloader.FILTER_BILINEAR, tloader.WRAP_MIRROR),
            _checker(), _brick(), _noise("fbm"), PATTERNS["expr"],
            dict(_noise("cellnoise"), _unused=True)]
    scene = _Scene(texs)
    rng = np.random.default_rng(4)
    uv = _uv(seed=5)
    ids = rng.integers(-1, len(texs), uv.shape[0]).astype(np.int32)
    tables = {"tex0_img": _image()}
    ref, got = _both(scene, tables, "eval_texture_stack", ids, uv)
    np.testing.assert_allclose(got, ref, **TOL)
    assert (got[ids == len(texs) - 1] == 0).all()
    const = rng.uniform(0, 1, (uv.shape[0], 3)).astype(np.float32)
    ref, got = _both(scene, tables, "resolve_color", const, ids, uv)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_array_equal(got[ids < 0], const[ids < 0])
    # evaluating only the textures the ids can hold changes no value
    sub = {int(i) for i in ids if i >= 0 and i % 2 == 0}
    ids_sub = np.where(np.isin(ids, list(sub)), ids, -1).astype(np.int32)
    tt = {"tex0_img": torch.from_numpy(tables["tex0_img"])}
    full = teval.eval_texture_stack(scene, tt, torch.from_numpy(ids_sub),
                                    torch.from_numpy(uv))
    part = teval.eval_texture_stack(scene, tt, torch.from_numpy(ids_sub),
                                    torch.from_numpy(uv), ids=sub)
    np.testing.assert_array_equal(full.numpy(), part.numpy())


def test_noise_hash_matches_jax_bit_for_bit():
    rng = np.random.default_rng(6)
    p = rng.uniform(-3e4, 3e4, (4096, 2)).astype(np.float32)
    p[:3] = np.float32([[np.nan, 1.0], [3e9, -3e9], [-0.5, 2147483520.0]])
    for seed in (0, 5, 0xFFFFFFFF):
        ref = np.asarray(jeval._noise2(jnp.asarray(p), seed))
        got = teval.noise2(torch.from_numpy(p), seed).numpy()
        np.testing.assert_array_equal(got, ref)
    ix = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    iy = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    ref = np.asarray(jeval._hash2(jnp.asarray(ix.astype(np.uint32)),
                                  jnp.asarray(iy.astype(np.uint32)), 77))
    got = teval._hash2(torch.from_numpy(ix.astype(np.int64)),
                       torch.from_numpy(iy.astype(np.int64)), 77).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


# -------------------------------------------------------------------- EXR
def _zips_exr(path, img, comp=2):
    """A ZIPS (2) / ZIP (3) scanline EXR of float32 R, G, B, written here
    (neither package writes compressed files)."""
    h, w, _ = img.shape
    chans = ["B", "G", "R"]
    chl = b"".join(c.encode() + b"\0" + struct.pack("<iBBBBii", 2, 0, 0, 0,
                                                    0, 1, 1)
                   for c in chans) + b"\0"

    def attr(n, t, d):
        return n.encode() + b"\0" + t.encode() + b"\0" + struct.pack(
            "<i", len(d)) + d
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    head = (attr("channels", "chlist", chl)
            + attr("compression", "compression", bytes([comp]))
            + attr("dataWindow", "box2i", box)
            + attr("displayWindow", "box2i", box)
            + attr("lineOrder", "lineOrder", b"\0") + b"\0")
    rows = 1 if comp == 2 else 16
    pre = struct.pack("<ii", 20000630, 2) + head
    nblk = (h + rows - 1) // rows
    off = len(pre) + 8 * nblk
    blocks, offs = [], []
    for y0 in range(0, h, rows):
        raw = b"".join(img[y, :, {"B": 2, "G": 1, "R": 0}[c]].tobytes()
                       for y in range(y0, min(h, y0 + rows)) for c in chans)
        b = np.frombuffer(raw, np.uint8)
        inter = np.concatenate([b[0::2], b[1::2]]).astype(np.int32)
        pred = inter.copy()
        pred[1:] = (inter[1:] - inter[:-1] + 128) & 0xFF
        data = zlib.compress(pred.astype(np.uint8).tobytes())
        blk = struct.pack("<ii", y0, len(data)) + data
        offs.append(off)
        off += len(blk)
        blocks.append(blk)
    with open(path, "wb") as f:
        f.write(pre + struct.pack(f"<{nblk}q", *offs) + b"".join(blocks))


def test_exr_write_and_read_match_jax(tmp_path):
    img = np.random.default_rng(7).uniform(-1, 5, (19, 23, 3)).astype(
        np.float32)
    p_t, p_j = str(tmp_path / "t.exr"), str(tmp_path / "j.exr")
    texr.write_exr(p_t, img)
    jexr.write_exr(p_j, img)
    assert open(p_t, "rb").read() == open(p_j, "rb").read()
    np.testing.assert_array_equal(texr.read_exr(p_t), img)
    for comp in (2, 3):
        p = str(tmp_path / f"z{comp}.exr")
        _zips_exr(p, img, comp)
        np.testing.assert_array_equal(texr.read_exr(p), jexr.read_exr(p))
        np.testing.assert_array_equal(texr.read_exr(p), img)
    # the loader flips rows as the JAX loader does
    np.testing.assert_array_equal(tloader.load_image_rgb(p_t),
                                  jloader.load_image_rgb(p_t))


def test_exr_compression_not_read_raises(tmp_path):
    """A file that says PIZ but holds ZIPS blocks: the OpenEXR shim cannot
    read it (or is absent), and both packages raise the same ValueError."""
    p = str(tmp_path / "piz.exr")
    _zips_exr(p, np.zeros((2, 2, 3), np.float32), comp=4)
    with pytest.raises(ValueError) as want:
        jexr.read_exr(p)
    with pytest.raises(ValueError, match="Unsupported EXR compression 4") \
            as got:
        texr.read_exr(p)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ baking
def test_bake_texture_matches_jax():
    from ignis_tpu.scene.compile import _bake_texture as jbake
    from ignis_tpu_torch.scene.compile import _bake_texture as tbake
    texs = [_image_tex(tloader.FILTER_BILINEAR, tloader.WRAP_REPEAT),
            _checker(), _noise("fbm"),
            dict(type=tloader.TEX_EXPR, name="c", expr="0.25", obj={})]
    imgs = {"tex0_img": _image()}
    for tid in range(len(texs)):
        ref = jbake(texs, imgs, tid, 64, 32)
        got = tbake(texs, imgs, tid, 64, 32)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, **TOL)


def _bake_scene():
    return {
        "technique": {"type": "path", "max_depth": 2},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": {"translate": [0, 0, -3]}},
        "film": {"size": [16, 16]},
        "textures": [{"type": "checkerboard", "name": "check",
                      "color0": 1.0, "color1": 0.0}],
        "bsdfs": [{"type": "diffuse", "name": "m", "reflectance": "check"}],
        "shapes": [{"type": "rectangle", "name": "sq", "width": 2,
                    "height": 2}],
        "entities": [{"name": "sq", "shape": "sq", "bsdf": "m"}],
        "lights": [{"type": "env", "name": "sky", "radiance": 1.0}],
    }


def test_runtime_bake_texture_and_expr():
    """tests/test_parameters.py's bake checks through the port, and the
    bakes equal to the JAX package's."""
    from ignis_tpu.api import Runtime as JRuntime
    from ignis_tpu_torch.api import Runtime
    rt = Runtime(_bake_scene(), device="cpu")
    img = rt.bake("check", 32, 16)
    assert img.shape == (16, 32, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.9 and img.min() < 0.1
    expr = rt.bake("vec3(uv.x, uv.y, 0.5)", 16, 8)
    assert expr.shape == (8, 16, 3)
    np.testing.assert_allclose(expr[0, -1, 0], 1.0, atol=1e-5)
    np.testing.assert_allclose(expr[-1, 0, 1], 1.0, atol=1e-5)
    jrt = JRuntime(_bake_scene())
    np.testing.assert_array_equal(img, jrt.bake("check", 32, 16))
    np.testing.assert_allclose(expr, jrt.bake("vec3(uv.x, uv.y, 0.5)", 16,
                                              8), **TOL)
