"""Scene files from a configuration's raw geometry: binary PLY meshes under
the checkout's `build/benchmark/`, written once and atomically, and the
scene dictionary the program loads.  A configuration's builder
(`configs/<name>.py`) makes the raw geometry; the reference reads the same
raw geometry (`reference.pathtracer.RefScene.from_raw`)."""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "build" / "benchmark"


def write_ply(path, vertices, faces):
    """A binary little-endian PLY of float32 vertices and int32 triangles,
    written only when `path` does not hold those bytes already."""
    vertices = np.ascontiguousarray(vertices, "<f4")
    faces = np.ascontiguousarray(faces, "<i4")
    head = (f"ply\nformat binary_little_endian 1.0\n"
            f"element vertex {vertices.shape[0]}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {faces.shape[0]}\n"
            "property list uchar int vertex_indices\nend_header\n").encode()
    rec = np.zeros(faces.shape[0], dtype=[("n", "u1"), ("i", "<i4", (3,))])
    rec["n"], rec["i"] = 3, faces
    body = head + vertices.tobytes() + rec.tobytes()
    path = Path(path)
    if path.exists() and path.stat().st_size == len(body) \
            and path.read_bytes() == body:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    tmp.write_bytes(body)
    os.replace(tmp, path)
    return path


def quad(origin, a, b):
    """A parallelogram as two triangles: corners o, o + a, o + a + b,
    o + b; its face normal is a x b."""
    o, a, b = (np.asarray(v, np.float64) for v in (origin, a, b))
    return (np.stack([o, o + a, o + a + b, o + b]),
            np.array([[0, 1, 2], [0, 2, 3]], np.int64))


def box(matrix):
    """The cube [-1, 1]^3 under a 3x4 affine matrix, six quads."""
    m = np.asarray(matrix, np.float64).reshape(3, 4)
    verts, faces = [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            u, v = (axis + 1) % 3, (axis + 2) % 3
            c = np.zeros(3)
            c[axis] = sign
            du, dv = np.zeros(3), np.zeros(3)
            du[u], dv[v] = 2.0, 2.0
            if sign < 0:
                du, dv = dv, du
            corners, f = quad(c - du / 2 - dv / 2, du, dv)
            faces.append(f + 4 * len(verts))
            verts.append(corners @ m[:, :3].T + m[:, 3])
    return np.concatenate(verts), np.concatenate(faces)


def lookat(eye, target, up):
    """Camera position, unit viewing direction and the up vector made
    orthogonal to it."""
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    d = target - eye
    d /= np.linalg.norm(d)
    u = up - d * np.dot(up, d)
    u /= np.linalg.norm(u)
    return eye, d, u


def program_scene(cfg, parts, film, camera, max_depth):
    """The scene dictionary for the program: one PLY entity a part, its
    diffuse material, the lights, the camera as a matrix whose columns 1-3
    are up, direction and position."""
    eye, d, up = camera["eye"], camera["dir"], camera["up"]
    side = np.cross(up, d)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = side, up, d, eye
    scene = {
        "technique": {"type": "path", "max_depth": int(max_depth)},
        "camera": {"type": "perspective", "fov": float(camera["fov"]),
                   "transform": [float(x) for x in m.reshape(-1)]},
        "film": {"size": [int(film[0]), int(film[1])]},
        "bsdfs": [{"type": "diffuse", "name": name,
                   "reflectance": [float(c) for c in kd]}
                  for name, kd in cfg["materials"].items()],
        "shapes": [], "entities": [], "lights": [],
    }
    for part in parts:
        scene["shapes"].append({"type": "ply", "name": part["name"],
                                "filename": str(part["file"]),
                                "face_normals": True})
        scene["entities"].append({"name": part["name"], "shape": part["name"],
                                  "bsdf": part["material"]})
    for i, light in enumerate(cfg["lights"]):
        if light["type"] == "plane":
            scene["lights"].append({"type": "area", "name": f"light{i}",
                                    "entity": light["part"],
                                    "radiance": light["radiance"]})
        elif light["type"] == "point":
            scene["lights"].append({"type": "point", "name": f"light{i}",
                                    "position": light["position"],
                                    "intensity": light["intensity"]})
        else:
            scene["lights"].append({"type": "constant", "name": f"light{i}",
                                    "radiance": light["radiance"]})
    return scene


def assemble(cfg, parts, film, camera, max_depth, levels=0):
    """The program's scene and the reference's raw geometry from parts
    (dicts of name, material, vertices, faces): each part's PLY is written,
    and the raw geometry concatenates the parts in order."""
    mats = list(cfg["materials"])
    verts, faces, tri_mat, offsets = [], [], [], {}
    nv = nf = 0
    for part in parts:
        v = np.asarray(part["vertices"], np.float32)
        f = np.asarray(part["faces"], np.int64)
        part["file"] = write_ply(BUILD / cfg["name"] / f"{part['name']}.ply",
                                 v, f)
        offsets[part["name"]] = np.arange(nf, nf + f.shape[0])
        verts.append(v)
        faces.append(f + nv)
        tri_mat.append(np.full(f.shape[0], mats.index(part["material"])))
        nv, nf = nv + v.shape[0], nf + f.shape[0]
    lights = []
    for light in cfg["lights"]:
        light = dict(light)
        if light["type"] == "plane":
            light["faces"] = offsets[light["part"]]
        lights.append(light)
    cam = dict(eye=camera["eye"], dir=camera["dir"], up=camera["up"],
               fov=camera["fov"])
    raw = dict(vertices=np.concatenate(verts), faces=np.concatenate(faces),
               tri_mat=np.concatenate(tri_mat),
               kd=np.asarray([cfg["materials"][m] for m in mats], np.float32),
               lights=lights, camera=cam, levels=levels)
    return program_scene(cfg, parts, film, cam, max_depth), raw
