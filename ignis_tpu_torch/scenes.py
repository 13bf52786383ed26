"""Self-contained scene dictionaries: the two headline scenes of the port.

They are the port's own copies of the scenes the JAX package's bench scripts
build (`__graft_entry__._demo_scene` and `_big_bench.make_scene`); those
scripts import JAX, so the dictionaries are kept here.
"""

from __future__ import annotations

import numpy as np


def demo_scene():
    """Cornell-like box, about 100 triangles, depth 6: diffuse walls, a
    dielectric cube, a gold icosphere, a plane area light and a constant
    environment: the whole material and light union of the ported slice."""
    return {
        "technique": {"type": "path", "max_depth": 6},
        "camera": {
            "type": "perspective", "fov": 40,
            "transform": [-1, 0, 0, 0, 0, 1, 0, 0, 0, 0, -1, 3.85,
                          0, 0, 0, 1],
        },
        "film": {"size": [64, 64]},
        "bsdfs": [
            {"type": "diffuse", "name": "white", "reflectance": [0.8, 0.8, 0.8]},
            {"type": "diffuse", "name": "blue",
             "reflectance": [0.106, 0.195, 0.8]},
            {"type": "dielectric", "name": "glass", "int_ior": 2.3},
            {"type": "conductor", "name": "metal", "material": "gold"},
        ],
        "shapes": [
            {"type": "rectangle", "name": "light",
             "transform": [{"translate": [0, 0.95, 0]}, {"rotate": [90, 0, 0]},
                           {"scale": 0.25}]},
            {"type": "rectangle", "name": "floor", "width": 2, "height": 2,
             "transform": [{"translate": [0, -1, 0]}, {"rotate": [-90, 0, 0]}]},
            {"type": "rectangle", "name": "back", "width": 2, "height": 2,
             "transform": [{"translate": [0, 0, 1]}, {"rotate": [180, 0, 0]}]},
            {"type": "cube", "name": "box", "width": 0.5, "height": 0.5,
             "depth": 0.5},
            {"type": "icosphere", "name": "ball", "radius": 0.3,
             "subdivisions": 1, "transform": [{"translate": [0.6, -0.6, 0]}]},
        ],
        "entities": [
            {"name": "light", "shape": "light", "bsdf": "white"},
            {"name": "floor", "shape": "floor", "bsdf": "white"},
            {"name": "back", "shape": "back", "bsdf": "blue"},
            {"name": "box", "shape": "box", "bsdf": "glass"},
            {"name": "ball", "shape": "ball", "bsdf": "metal"},
        ],
        "lights": [
            {"type": "area", "name": "light", "entity": "light",
             "radiance": [20, 20, 20]},
            {"type": "env", "name": "env", "radiance": [0.1, 0.1, 0.15]},
        ],
    }


def big_scene(n_spheres=25, subdiv=5):
    """A field of icospheres over a floor under a constant environment,
    depth 4, 512x512 film.  The defaults give 512,002 triangles."""
    rng = np.random.default_rng(7)
    bsdfs = [{"type": "diffuse", "name": "white", "reflectance": [0.7, 0.7, 0.7]}]
    shapes, entities = [], []
    grid = int(np.ceil(np.sqrt(n_spheres)))
    for i in range(n_spheres):
        gx, gz = i % grid, i // grid
        c = [float(gx * 2.2 - grid), float(rng.uniform(0, 0.5)),
             float(gz * 2.2 - grid)]
        shapes.append({"type": "icosphere", "name": f"s{i}", "center": c,
                       "radius": 0.9, "subdivisions": subdiv})
        entities.append({"name": f"s{i}", "shape": f"s{i}", "bsdf": "white"})
    shapes.append({"type": "rectangle", "name": "floor", "width": 60,
                   "height": 60,
                   "transform": {"rotate": [-90, 0, 0],
                                 "translate": [0, -1, 0]}})
    entities.append({"name": "floor", "shape": "floor", "bsdf": "white"})
    return {
        "technique": {"type": "path", "max_depth": 4},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": {"rotate": [25, 0, 0],
                                 "translate": [0, 8, -14]}},
        "film": {"size": [512, 512]},
        "bsdfs": bsdfs, "shapes": shapes, "entities": entities,
        "lights": [{"type": "env", "name": "sky",
                    "radiance": [1.0, 1.0, 1.0]}],
    }
