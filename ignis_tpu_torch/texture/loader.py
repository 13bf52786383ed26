"""Texture/pattern loading: scene `textures` section → static texture list.

Counterpart of src/runtime/pattern/ (ImagePattern, CheckerBoardPattern,
NoisePattern, ...) and src/runtime/Image.cpp: LDR images are converted to
linear floats with the stb gamma-2.2 curve and flipped vertically
(Image.cpp:559-562), matching the reference's texel addressing.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

TEX_IMAGE = 0
TEX_CHECKERBOARD = 1
TEX_NOISE = 2
TEX_BRICK = 3
TEX_EXPR = 4
TEX_TRANSFORM = 5

FILTER_NEAREST = 0
FILTER_BILINEAR = 1
FILTER_BICUBIC = 2

WRAP_REPEAT = 0
WRAP_MIRROR = 1
WRAP_CLAMP = 2


def _srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """Piecewise sRGB EOTF (Image.cpp:30-37 srgb_invgamma)."""
    return np.where(c <= 0.04045, c / 12.92,
                    np.power((c + 0.055) / 1.055, 2.4)).astype(np.float32)


def load_image_rgb(path: str | Path, linear: bool = False) -> np.ndarray:
    """(H, W, 3) float32 linear, row 0 = BOTTOM of the image (flipY).

    `linear=True` keeps LDR bytes as-is (normal maps, data textures) —
    Image.cpp:565-640 packs without the sRGB decode in that case.  HDR
    formats (.exr/.hdr) are linear by definition."""
    path = Path(path)
    ext = path.suffix.lower()
    if ext == ".exr":
        from ignis_tpu_torch.utils.exr import read_exr
        img = read_exr(path)
    elif ext == ".hdr":
        img = _load_hdr(path)
    else:
        from PIL import Image as PILImage
        with PILImage.open(path) as im:
            im = im.convert("RGB")
            arr = np.asarray(im, dtype=np.float32) / 255.0
        img = arr if linear else _srgb_to_linear(arr)
    return np.ascontiguousarray(img[::-1].astype(np.float32))


def _load_hdr(path) -> np.ndarray:
    """Radiance .hdr reader (RLE RGBE)."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("Not a Radiance HDR file")
    pos = data.index(b"\n\n") + 2
    eol = data.index(b"\n", pos)
    dims = data[pos:eol].split()
    h, w = int(dims[1]), int(dims[3])
    pos = eol + 1
    rgbe = np.zeros((h, w, 4), np.uint8)
    for y in range(h):
        if (data[pos], data[pos + 1]) == (2, 2) and (data[pos + 2] << 8 | data[pos + 3]) == w:
            pos += 4
            row = np.zeros((4, w), np.uint8)
            for c in range(4):
                x = 0
                while x < w:
                    count = data[pos]
                    pos += 1
                    if count > 128:
                        row[c, x:x + count - 128] = data[pos]
                        pos += 1
                        x += count - 128
                    else:
                        row[c, x:x + count] = np.frombuffer(
                            data, np.uint8, count, pos)
                        pos += count
                        x += count
            rgbe[y] = row.T
        else:
            flat = np.frombuffer(data, np.uint8, w * 4, pos)
            rgbe[y] = flat.reshape(w, 4)
            pos += w * 4
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]


_WRAPS = {"repeat": WRAP_REPEAT, "mirror": WRAP_MIRROR, "clamp": WRAP_CLAMP}
_FILTERS = {"nearest": FILTER_NEAREST, "bilinear": FILTER_BILINEAR,
            "bicubic": FILTER_BICUBIC, "trilinear": FILTER_BICUBIC}


def compile_textures(scene) -> tuple[list, dict]:
    """Returns (texture list, image-table dict).  Each texture is a static
    dict; image data goes to tables as tex{i}_img."""
    textures = []
    img_tables = {}
    from ignis_tpu_torch.scene.transforms import parse_transform
    for i, name in enumerate(scene.textures_order):
        obj = scene.textures[name]
        ttype = obj.get("type", "image")
        if ttype in ("image", "bitmap"):
            try:
                img = load_image_rgb(scene.resolve_path(obj["filename"]),
                                     linear=bool(obj.get("linear", False)))
            except (FileNotFoundError, OSError, ValueError) as e:
                import warnings
                warnings.warn(f"Could not load texture '{obj['filename']}': "
                              f"{e}; using signal pink")
                img = np.tile(np.float32([1, 0, 1]), (2, 2, 1))
            key = f"tex{i}_img"
            img_tables[key] = img
            t34 = parse_transform(obj.get("transform")) if "transform" in obj else np.eye(4)
            textures.append(dict(
                type=TEX_IMAGE, name=name, img_key=key,
                filter=_FILTERS.get(obj.get("filter_type", "bicubic"),
                                    FILTER_BICUBIC),
                wrap_u=_WRAPS.get(obj.get("wrap_mode_u",
                                          obj.get("wrap_mode", "repeat")),
                                  WRAP_REPEAT),
                wrap_v=_WRAPS.get(obj.get("wrap_mode_v",
                                          obj.get("wrap_mode", "repeat")),
                                  WRAP_REPEAT),
                transform=t34[:2, (0, 1, 3)].astype(np.float32),
                linear=bool(obj.get("linear", False))))
        elif ttype == "checkerboard":
            t34 = parse_transform(obj.get("transform")) if "transform" in obj else np.eye(4)

            def _cprop(key, default):
                """Constant color, or a PExpr/param string kept as a
                runtime-resolved reference (ShadingTree string path)."""
                v = obj.get(key, default)
                if isinstance(v, str):
                    return np.asarray(default, np.float32), v
                a = np.asarray(v, np.float32)
                if a.size == 1:
                    a = np.full(3, float(a), np.float32)
                return a, None

            def _nprop(key, default):
                v = obj.get(key, default)
                if isinstance(v, str):
                    return float(default), v
                return float(v), None

            c0, c0_ref = _cprop("color0", [0, 0, 0])
            c1, c1_ref = _cprop("color1", [1, 1, 1])
            sx, sx_ref = _nprop("scale_x", 2.0)
            sy, sy_ref = _nprop("scale_y", 2.0)
            textures.append(dict(
                type=TEX_CHECKERBOARD, name=name,
                color0=c0, color1=c1,
                color0_ref=c0_ref, color1_ref=c1_ref,
                scale_x_ref=sx_ref, scale_y_ref=sy_ref,
                scale=np.asarray([sx, sy], np.float32),
                transform=t34[:2, (0, 1, 3)].astype(np.float32)))
        elif ttype == "brick":
            # BrickPattern.cpp:17-33 defaults; texture/brick.art semantics
            t34 = parse_transform(obj.get("transform")) if "transform" in obj else np.eye(4)
            c0, _ = _c3(obj.get("color0", [0, 0, 0]))
            c1, _ = _c3(obj.get("color1", [1, 1, 1]))
            textures.append(dict(
                type=TEX_BRICK, name=name, color0=c0, color1=c1,
                scale=np.asarray([float(obj.get("scale_x", 3.0)),
                                  float(obj.get("scale_y", 6.0))], np.float32),
                gap=np.asarray([float(obj.get("gap_x", 0.05)),
                                float(obj.get("gap_y", 0.1))], np.float32),
                transform=t34[:2, (0, 1, 3)].astype(np.float32)))
        elif ttype in ("noise", "cellnoise", "fbm", "perlin", "pnoise",
                       "voronoi"):
            c, _ = _c3(obj.get("color", [1, 1, 1]))
            textures.append(dict(
                type=TEX_NOISE, name=name, variant=ttype, color=c,
                colored=bool(obj.get("colored", False)),
                scale_x=float(obj.get("scale_x", 20.0 if ttype != "noise" else 1.0)),
                scale_y=float(obj.get("scale_y", 20.0 if ttype != "noise" else 1.0)),
                seed=int(obj.get("seed", 0))))
        elif ttype == "expr":
            textures.append(dict(type=TEX_EXPR, name=name,
                                 expr=obj.get("expr", "0"), obj=obj))
        else:
            # unknown pattern: signal pink (InvalidPattern.cpp)
            textures.append(dict(type=TEX_CHECKERBOARD, name=name,
                                 color0=np.float32([1, 0, 1]),
                                 color1=np.float32([1, 0, 1]),
                                 scale=np.float32([2, 2]),
                                 transform=np.eye(2, 3, dtype=np.float32)))
    return textures, img_tables


def _c3(v):
    if isinstance(v, (int, float)):
        return np.full(3, float(v), np.float32), -1
    return np.asarray(v[:3], np.float32), -1
