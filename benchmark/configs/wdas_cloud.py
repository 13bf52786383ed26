"""The WDAS cloud: a seeded cloud-shaped density on the set's half-size grid
in a passthrough box, under `volpath` with delta tracking.

The density (`cloud_density`) is soft spheres standing on a flat base,
eroded by fractal value noise, scaled so that its largest value is 1; it is
made on the run's device a slab of z-slices at a time, from the
configuration's own seed (not `--seed`).  The grid is written once as a
NanoVDB file under the checkout's `build/benchmark/wdas_cloud/`, named by a
digest of what makes it (the grid's parameters, its size, the device's
kind), through a temporary file and `os.replace`; a file of that name is
taken as it is.  The scene names the file as a user's scene does.  The
reference reads the same raw grid (`raw["grid"]`), not the file.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from benchmark.scenes import BUILD, box, lookat, write_ply

SLAB = 32          # z-slices of the grid made at a time


def grid_dims(cfg, device):
    """(x, y, z) voxels of the grid a run on `device` takes."""
    return tuple(int(v) for v in (cfg["dims"] if torch.device(device).type
                                  == "cuda" else cfg["cpu_dims"]))


def majorant_depth(cfg, device):
    """The majorant times the box's longest edge, for a run on `device`."""
    return float(cfg["medium"]["majorant_depth"]
                 if torch.device(device).type == "cuda"
                 else cfg["cpu_majorant_depth"])


def _value_noise(lattice, fx, fy, fz):
    """Trilinear value noise with smoothstep weights: `lattice` (Z, Y, X)
    at lattice coordinates fz (z, 1, 1), fy (1, y, 1), fx (1, 1, x)."""
    out = 0.0
    i = [torch.floor(f) for f in (fz, fy, fx)]
    t = [f - k for f, k in zip((fz, fy, fx), i)]
    t = [a * a * (3.0 - 2.0 * a) for a in t]
    i = [k.long() for k in i]
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = ((t[0] if dz else 1.0 - t[0]) * (t[1] if dy else 1.0 - t[1])
                     * (t[2] if dx else 1.0 - t[2]))
                out = out + lattice[i[0] + dz, i[1] + dy, i[2] + dx] * w
    return out


def cloud_density(g, dims, device):
    """The (z, y, x) float32 density on `device`: in coordinates of voxel
    centres over the grid's longest side, the union of soft spheres
    (1 at a centre, 0 at the radius) cut flat below `base_y`, less
    `erosion` x fractal value noise (`octaves` of `noise_cells` lattice
    cells a side and up, amplitudes `persistence`^k, normalised to
    [0, 1]), clamped at 0 and divided by its largest value."""
    w, h, d = dims
    scale = float(max(dims))
    rng = np.random.default_rng(int(g["seed"]))
    n = int(g["spheres"])
    ext = np.asarray(dims, np.float64) / scale
    r = rng.uniform(*g["radius"], n)
    cx = rng.uniform(*g["centre_x"], n) * ext[0]
    cz = rng.uniform(*g["centre_z"], n) * ext[2]
    cy = g["base_y"] + r * rng.uniform(0.1, 0.8, n)
    lattices = []
    for k in range(int(g["octaves"])):
        cells = int(g["noise_cells"]) * 2 ** k
        lattices.append(torch.from_numpy(rng.random(
            (cells + 2,) * 3, dtype=np.float32)).to(device))
    amp = [float(g["persistence"]) ** k for k in range(len(lattices))]
    f32 = dict(dtype=torch.float32, device=device)
    ys = ((torch.arange(h, **f32) + 0.5) / scale)[None, :, None]
    xs = ((torch.arange(w, **f32) + 0.5) / scale)[None, None, :]
    base = torch.clamp((ys - g["base_y"]) / g["base_soft"], 0.0, 1.0)
    out = torch.empty((d, h, w), **f32)
    for z0 in range(0, d, SLAB):
        zs = ((torch.arange(z0, min(z0 + SLAB, d), **f32) + 0.5)
              / scale)[:, None, None]
        shape = torch.zeros((zs.shape[0], h, w), **f32)
        for k in range(n):
            dist = torch.sqrt((xs - cx[k]) ** 2 + (ys - cy[k]) ** 2
                              + (zs - cz[k]) ** 2)
            shape = torch.maximum(shape, 1.0 - dist / r[k])
        fbm = 0.0
        for lat, a in zip(lattices, amp):
            cells = lat.shape[0] - 2
            fbm = fbm + a * _value_noise(lat, xs * cells, ys * cells,
                                         zs * cells)
        fbm = fbm / sum(amp)
        out[z0:z0 + zs.shape[0]] = torch.clamp(
            shape * base - g["erosion"] * fbm, min=0.0)
    out /= out.max()
    return out


def grid_file(cfg, dims, device):
    """The grid's NanoVDB path, named by a digest of what makes it."""
    key = json.dumps([cfg["grid"], list(dims), torch.device(device).type],
                     sort_keys=True).encode()
    tag = hashlib.sha256(key).hexdigest()[:16]
    return BUILD / cfg["name"] / f"cloud-{tag}.nvdb"


def write_grid(path, dense):
    """The grid as NanoVDB at `path`, written once: through a temporary
    file and `os.replace`, and not at all where the file is there."""
    from ignis_tpu_torch.medium.nanovdb import write_nvdb_grid
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    write_nvdb_grid(tmp, dense, "density")
    os.replace(tmp, path)
    return path


def write_scene(cfg, scene):
    """The scene as a JSON file beside the grid, named by a digest of its
    text, written once through a temporary file and `os.replace`."""
    text = json.dumps(scene, indent=1, sort_keys=True)
    tag = hashlib.sha256(text.encode()).hexdigest()[:16]
    path = BUILD / cfg["name"] / f"scene-{tag}.json"
    if not path.exists():
        tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
        tmp.write_text(text)
        os.replace(tmp, path)
    return path


def build(cfg, film, max_depth, device="cpu"):
    """The program's scene (the path of a scene file naming the `.nvdb`, as
    a user's) and the reference's raw description: the box, the grid, the
    medium, lights and camera."""
    dims = grid_dims(cfg, device)
    dense = cloud_density(cfg["grid"], dims, device).cpu().numpy()
    path = write_grid(grid_file(cfg, dims, device), dense)
    # the box: the grid's voxels at `voxel_size`, on y = 0, centred in x, z
    half = 0.5 * np.asarray(cfg["dims"], np.float64) * cfg["voxel_size"]
    lo = np.asarray([-half[0], 0.0, -half[2]])
    hi = np.asarray([half[0], 2.0 * half[1], half[2]])
    mat = np.zeros((3, 4))
    mat[:, :3] = np.diag(0.5 * (hi - lo))
    mat[:, 3] = 0.5 * (hi + lo)
    verts, faces = box(mat.reshape(-1))
    verts = verts.astype(np.float32)
    ply = write_ply(BUILD / cfg["name"] / "box.ply", verts, faces)
    med = cfg["medium"]
    longest = float((verts.max(0) - verts.min(0)).max())
    density = majorant_depth(cfg, device) / longest / (
        med["scalar_scattering"] + med["scalar_absorption"])
    cam = cfg["camera"]
    eye, d, up = lookat(cam["eye"], cam["target"], cam["up"])
    side = np.cross(up, d)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = side, up, d, eye
    lights = []
    for i, light in enumerate(cfg["lights"]):
        if light["type"] == "directional":
            lights.append({"type": "directional", "name": f"light{i}",
                           "direction": light["direction"],
                           "irradiance": light["irradiance"]})
        else:
            lights.append({"type": "constant", "name": f"light{i}",
                           "radiance": light["radiance"]})
    scene = {
        "technique": {"type": "volpath", "max_depth": int(max_depth)},
        "camera": {"type": "perspective", "fov": float(cam["fov"]),
                   "transform": [float(x) for x in m.reshape(-1)]},
        "film": {"size": [int(film[0]), int(film[1])]},
        "bsdfs": [{"type": "passthrough", "name": "null"}],
        "shapes": [{"type": "ply", "name": "cloud_box", "filename": str(ply),
                    "face_normals": True}],
        "entities": [{"name": "cloud_box", "shape": "cloud_box",
                      "bsdf": "null", "inner_medium": "cloud"}],
        "media": [{"type": "heterogeneous", "name": "cloud",
                   "filename": str(path), "shader": "monochromatic",
                   "scalar_density": float(density),
                   "scalar_scattering": med["scalar_scattering"],
                   "scalar_absorption": med["scalar_absorption"],
                   "g": med["g"], "interpolate": bool(med["interpolate"]),
                   "method": med["method"],
                   "max_scattering": int(med["max_scattering"])}],
        "lights": lights,
    }
    raw = dict(vertices=verts, faces=faces, grid=dense,
               box_min=verts.min(0), box_max=verts.max(0),
               scalar_density=float(density),
               scalar_scattering=med["scalar_scattering"],
               scalar_absorption=med["scalar_absorption"], g=med["g"],
               max_scattering=int(med["max_scattering"]),
               lights=cfg["lights"],
               camera=dict(eye=eye, dir=d, up=up, fov=cam["fov"]))
    return write_scene(cfg, scene), raw
