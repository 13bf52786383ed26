"""The SPD tetra pyramid: a regular tetrahedron replaced `size_factor`
times by its four half-size corner tetrahedra, 4^n leaves of 4 triangles.
Leaf l is numbered by its base-4 path from the root (first digit most
significant), and its triangles are 4 l .. 4 l + 3, the order in which the
reference's walk of the same recursion finds them."""

import numpy as np

from benchmark.reference.geometry import LEAF_FACES, PARITY_EVEN
from benchmark.scenes import assemble, lookat


def tetra_mesh(levels):
    """Vertices (4 a leaf) and triangles of the pyramid in [-1, 1]^3."""
    n = int(levels)
    leaf = np.arange(4 ** n, dtype=np.int64)
    signs = np.asarray(PARITY_EVEN, np.float64)
    center = np.zeros((leaf.shape[0], 3))
    for k in range(1, n + 1):
        digit = (leaf >> (2 * (n - k))) & 3
        center += 2.0 ** -k * signs[digit]
    verts = (center[:, None, :] + 2.0 ** -n * signs[None]).reshape(-1, 3)
    faces = (4 * leaf[:, None, None]
             + np.asarray(LEAF_FACES, np.int64)[None]).reshape(-1, 3)
    return verts.astype(np.float32), faces


def build(cfg, film, max_depth):
    v, f = tetra_mesh(cfg["size_factor"])
    parts = [dict(name="tetra", material="tetra", vertices=v, faces=f)]
    cam = cfg["camera"]
    eye, d, up = lookat(cam["eye"], cam["target"], cam["up"])
    camera = dict(eye=eye, dir=d, up=up, fov=cam["fov"])
    return assemble(cfg, parts, film, camera, max_depth,
                    levels=cfg["size_factor"])
