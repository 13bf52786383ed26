"""Heterogeneous volume data: grids, lookups, the point mapper and the
density shaders.

Counterpart of ignis_tpu/medium/volume.py.  Every heterogeneous medium is a
set of dense (D, H, W, C) tensors: raw per-voxel coefficients (the "voxel"
kind, the uniform-grid `.bin` format) or a scalar density (and optional
temperature) field (the "density" kind, read from NanoVDB by
`medium.nanovdb`).  A lookup is one gather per corner; its gradient is an
`index_put_` with accumulate, atomic on the card.

Coordinates: a world point is mapped into the medium's reference entity's
local space and normalised by that shape's local bounding box; voxel
(i, j, k) spans [i/W, (i+1)/W) x ... and the `.bin` file stores x fastest.
"""

from __future__ import annotations

import math
import struct
from pathlib import Path

import numpy as np
import torch

from ignis_tpu_torch.core.vec import (
    device_const, device_scalar, maximum, to_int32,
)
from ignis_tpu_torch.utils.stats import count_grid_lookup

DENSITY_EPS = 1e-4


def load_voxel_grid_bin(path) -> dict:
    """Uniform voxel-grid `.bin`: a u32 x 4 header (W, H, D, 0), then
    W*H*D voxels of 12 f32 (sigma_a.xyz0 | sigma_s.xyz0 | emission.xyz0),
    x fastest.  Returns (D, H, W, 3) float32 numpy arrays."""
    raw = Path(path).read_bytes()
    w, h, d, _ = struct.unpack_from("4I", raw, 0)
    n = w * h * d
    data = np.frombuffer(raw, dtype=np.float32, offset=16,
                         count=n * 12).reshape(d, h, w, 12)
    return dict(kind="voxel", width=w, height=h, depth=d,
                sigma_a=np.ascontiguousarray(data[..., 0:3]),
                sigma_s=np.ascontiguousarray(data[..., 4:7]),
                emission=np.ascontiguousarray(data[..., 8:11]))


def write_voxel_grid_bin(path, sigma_a, sigma_s, emission):
    """Write (D, H, W, 3) coefficient fields as a `.bin` voxel grid (the
    inverse of `load_voxel_grid_bin`)."""
    sa = np.asarray(sigma_a, np.float32)
    d, h, w = sa.shape[:3]
    vox = np.zeros((d, h, w, 12), np.float32)
    vox[..., 0:3] = sa
    vox[..., 4:7] = np.asarray(sigma_s, np.float32)
    vox[..., 8:11] = np.asarray(emission, np.float32)
    with open(path, "wb") as f:
        f.write(struct.pack("4I", w, h, d, 0))
        f.write(vox.tobytes())


def grid_lookup(grid, lpos, interpolate=False):
    """Gather grid (D, H, W, C) at normalised local positions (n, 3) in
    [0, 1]^3: the nearest voxel, indices clamped to the grid, or trilinear
    over voxel centers.  Each call counts one in
    `utils.stats.grid_lookups()`."""
    count_grid_lookup()
    d, h, w = grid.shape[0], grid.shape[1], grid.shape[2]
    dims = device_const((float(w), float(h), float(d)), torch.float32,
                        lpos.device)
    if not interpolate:
        idx = to_int32(torch.floor(lpos * dims)).long()
        ix = torch.clamp(idx[..., 0], 0, w - 1)
        iy = torch.clamp(idx[..., 1], 0, h - 1)
        iz = torch.clamp(idx[..., 2], 0, d - 1)
        return grid[iz, iy, ix]
    p = lpos * dims - 0.5
    i0 = to_int32(torch.floor(p))
    f = p - i0
    i0 = i0.long()
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ix = torch.clamp(i0[..., 0] + dx, 0, w - 1)
                iy = torch.clamp(i0[..., 1] + dy, 0, h - 1)
                iz = torch.clamp(i0[..., 2] + dz, 0, d - 1)
                wx = f[..., 0] if dx else 1.0 - f[..., 0]
                wy = f[..., 1] if dy else 1.0 - f[..., 1]
                wz = f[..., 2] if dz else 1.0 - f[..., 2]
                out = out + grid[iz, iy, ix] * (wx * wy * wz)[..., None]
    return out


def to_normalized_point(tables, ref_ent, world_p):
    """World points -> [0, 1]^3 local volume coordinates of the reference
    entity `ref_ent` (a Python int)."""
    m = tables["ent_local_mat"][ref_ent]  # (3, 4)
    lp = world_p @ m[:, :3].T + m[:, 3]
    bmin = tables["ent_lbbox_min"][ref_ent]
    ext = tables["ent_lbbox_max"][ref_ent] - bmin
    return (lp - bmin) / maximum(ext, 1e-20)


def inside_unit(lpos, eps=1e-5):
    """Inside the slightly expanded unit cube."""
    return torch.all((lpos >= -eps) & (lpos <= 1.0 + eps), dim=-1)


# ---------------------------------------------------------------------------
# Volume shaders: map stored voxel values to (sigma_s, sigma_a, emission).
# Shader parameters live in the `medium_shader` table so they stay
# differentiable.  Row layout (20 floats):
#   0 scalar_density | 1 scalar_emission | 2:5 color_scattering
#   | 5:8 color_absorption | 8:11 color_emission | 11:14 color_blackbody
#   | 14 scalar_blackbody | 15 scalar_temperature | 16 offset_temperature
#   | 17 scalar_absorption | 18 scalar_scattering | 19 pad
# ---------------------------------------------------------------------------

SHADER_ROW = 20


def shader_row_from_props(mobj: dict) -> np.ndarray:
    """Build the shader-parameter row from medium JSON properties
    (HeterogeneousMedium.cpp:92-153 parameter defaults)."""
    def num(k, dv):
        return float(mobj.get(k, dv))

    def col(k, dv):
        v = mobj.get(k, dv)
        if isinstance(v, (int, float)):
            v = [v, v, v]
        return np.asarray(v[:3], np.float32)

    row = np.zeros(SHADER_ROW, np.float32)
    row[0] = num("scalar_density", 1.0)
    row[1] = num("scalar_emission", 0.0)
    shader = mobj.get("shader", "monochromatic")
    if shader == "principled_volume":
        row[2:5] = col("color_scattering", [0.5, 0.5, 0.5])
        row[5:8] = col("color_absorption", [0.8, 0.8, 0.8])
    else:
        row[2:5] = col("color_scattering", [1.0, 1.0, 1.0])
        row[5:8] = col("color_absorption", [1.0, 1.0, 1.0])
    row[8:11] = col("color_emission", [1.0, 1.0, 1.0])
    row[11:14] = col("color_blackbody", [0.0, 0.0, 0.0])
    row[14] = min(max(num("scalar_blackbody", 1.0), 0.0), 1.0)
    row[15] = num("scalar_temperature", 0.0)
    cutoff = num("cutoff_temperature", 0.0)
    row[16] = num("offset_temperature", cutoff)
    row[17] = num("scalar_absorption", 1.0)
    row[18] = num("scalar_scattering", 1.0)
    return row


def _blackbody_rgb(temp):
    """Planckian locus -> linear sRGB approximation.  temp (n,) in Kelvin,
    clamped >= 1000."""
    t = maximum(temp, 1000.0)
    # Krystek-style rational fits of the Planckian locus in CIE xy
    u = ((0.860117757 + 1.54118254e-4 * t + 1.28641212e-7 * t * t)
         / (1.0 + 8.42420235e-4 * t + 7.08145163e-7 * t * t))
    v = ((0.317398726 + 4.22806245e-5 * t + 4.20481691e-8 * t * t)
         / (1.0 - 2.89741816e-5 * t + 1.61456053e-7 * t * t))
    x = 3.0 * u / (2.0 * u - 8.0 * v + 4.0)
    y = 2.0 * v / (2.0 * u - 8.0 * v + 4.0)
    z = 1.0 - x - y
    sy = 1.0
    X = sy / maximum(y, 1e-6) * x
    Z = sy / maximum(y, 1e-6) * z
    r = 3.2404542 * X - 1.5371385 * sy - 0.4985314 * Z
    g = -0.9692660 * X + 1.8760108 * sy + 0.0415560 * Z
    b = 0.0556434 * X - 0.2040259 * sy + 1.0572252 * Z
    return maximum(torch.stack([r, g, b], dim=-1), 0.0)


def apply_density_shader(shader_type: str, row, density, temperature=None):
    """Density (and temperature) -> (sigma_s, sigma_a, emission), each
    (n, 3): the `monochromatic`, `pbrt_volume` and `principled_volume`
    shaders.  `row` is the medium's shader row; numpy inputs are taken as
    CPU tensors (the compiler's majorant)."""
    row = torch.as_tensor(row)
    density = torch.as_tensor(density)
    dev = density.device
    zero = device_scalar(0.0, dev)
    dens = torch.where(density > DENSITY_EPS, density * row[0],
                       zero)[..., None]
    if temperature is not None:
        temperature = torch.as_tensor(temperature)
    if shader_type == "pbrt_volume":
        ss = row[2:5] * dens
        sa = row[5:8] * dens
        if temperature is not None:
            vt = (temperature - row[16]) * row[15]
            em = torch.where((vt > 100.0)[..., None],
                             _blackbody_rgb(vt) * row[1], zero)
        else:
            em = torch.broadcast_to(row[8:11] * row[1], ss.shape)
        em = torch.where(row[1] > 0.0, em, torch.zeros_like(em))
        return ss, sa, em
    if shader_type == "principled_volume":
        ss = row[2:5] * dens
        sa = (1.0 - row[2:5]) * (1.0 - row[5:8]) * dens
        em = torch.broadcast_to(row[8:11] * row[1], ss.shape)
        em = torch.where(row[1] > 0.0, em, torch.zeros_like(em))
        if temperature is not None:
            # Stefan-Boltzmann blackbody term
            lt = row[15] * temperature
            lt4 = (lt * lt) * (lt * lt)
            intensity = (5.670373 / math.pi) * (
                (1.0 + (lt4 - 1.0) * row[14]) / 1e14)
            bb = (_blackbody_rgb(lt) * row[11:14]
                  * intensity[..., None])
            bb = torch.where((lt >= 1000.0)[..., None], bb, zero)
            em = em + torch.where((row[14] > 0.0) & (row[15] > 0.0),
                                  bb, torch.zeros_like(bb))
        return ss, sa, em
    # monochromatic (gray): density * scalar_{scattering,absorption}
    shape = dens.shape[:-1] + (3,)
    ss = torch.broadcast_to(dens * row[18], shape)
    sa = torch.broadcast_to(dens * row[17], shape)
    return ss, sa, torch.zeros_like(ss)
