"""Self-contained scene dictionaries: the headline scenes of the port.

`demo_scene` and `big_scene` are the port's own copies of the scenes the JAX
package's bench scripts build (`__graft_entry__._demo_scene` and
`_big_bench.make_scene`); those scripts import JAX, so the dictionaries are
kept here.  `instanced_scene` is the deployment instancing exists for: many
copies of one mesh.  `materials_scene` and `textured_scene` put the port's
BSDFs and textures in the demo's box; `daylight_scene` and `env_scene` the
light breadth (sun, sky, spots under the light hierarchy; an HDR environment
sampled by its table, many point lights under the flux CDF).
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


def materials_scene():
    """The demo box with one material of each kind the port shades beyond
    the demo's: a rough conductor, a rough dielectric, smooth and rough
    plastic, a principled BSDF (metallic and specular transmission set), a
    phong lobe, a `blend` of diffuse and the rough conductor at weight 0.4
    and a `transform` normal modifier over a diffuse wall, seen through the
    box's open side, lit by a point lamp and the environment.  Depth 6, 434 triangles: the Baldwin-Weber tables serve
    it."""
    scene = demo_scene()
    scene["camera"] = dict(scene["camera"], transform=[
        1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -3.85, 0, 0, 0, 1])
    scene["bsdfs"] = [
        {"type": "diffuse", "name": "white", "reflectance": [0.8, 0.8, 0.8]},
        {"type": "diffuse", "name": "blue",
         "reflectance": [0.106, 0.195, 0.8]},
        {"type": "roughconductor", "name": "brushed", "material": "gold",
         "roughness": 0.25},
        {"type": "roughdielectric", "name": "frosted", "int_ior": 1.5,
         "roughness": 0.2},
        {"type": "plastic", "name": "plastic",
         "diffuse_reflectance": [0.7, 0.15, 0.1]},
        {"type": "roughplastic", "name": "rough_plastic",
         "diffuse_reflectance": [0.15, 0.6, 0.2], "roughness": 0.3},
        {"type": "principled", "name": "principled",
         "base_color": [0.8, 0.6, 0.3], "metallic": 0.3,
         "specular_transmission": 0.5, "roughness": 0.4},
        {"type": "phong", "name": "phong",
         "specular_reflectance": [0.6, 0.6, 0.7], "exponent": 20},
        {"type": "blend", "name": "blend", "first": "white",
         "second": "brushed", "weight": 0.4},
        {"type": "transform", "name": "tilted", "bsdf": "blue",
         "normal": [0.25, 0.2, -1.0]},
    ]
    scene["shapes"] += [
        {"type": "icosphere", "name": "ball2", "radius": 0.3,
         "subdivisions": 2,
         "transform": [{"translate": [-0.55, -0.65, -0.3]}]},
        {"type": "rectangle", "name": "left", "width": 2, "height": 2,
         "transform": [{"translate": [-1, 0, 0]}, {"rotate": [0, 90, 0]}]},
        {"type": "rectangle", "name": "right", "width": 2, "height": 2,
         "transform": [{"translate": [1, 0, 0]}, {"rotate": [0, -90, 0]}]},
        {"type": "cube", "name": "block", "width": 0.35, "height": 0.35,
         "depth": 0.35, "transform": [{"translate": [0.1, -0.8, -0.6]}]},
    ]
    mats = dict(light="white", floor="plastic", back="tilted", box="frosted",
                ball="brushed", ball2="principled", left="rough_plastic",
                right="phong", block="blend")
    scene["entities"] = [dict(name=k, shape=k, bsdf=v)
                         for k, v in mats.items()]
    # a point lamp under the ceiling panel: an area light's corner, edges
    # and normal sit in `light_data` beside its emitting triangles, so a
    # gradient step on `light_data` would move the sampled quad off the
    # traced one, and the shadow rays of the walls near it would hit it
    scene["lights"] = [
        {"type": "point", "name": "lamp", "position": [0.1, 0.55, -0.1],
         "intensity": [2, 2, 2]},
        {"type": "env", "name": "env", "radiance": [0.1, 0.1, 0.15]},
    ]
    return scene


def _textured_images(dirpath, seed):
    """The EXR images of `textured_scene`, made from a numpy seed: an albedo
    (1024 x 1024), a tangent-space normal map (256 x 256) and an
    environment (512 x 256).  Returns their paths."""
    import os

    from ignis_tpu_torch.utils.exr import write_exr
    rng = np.random.default_rng(seed)
    # albedo: smooth colored waves over coarse random cells
    n = 1024
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) / n
    cells = rng.uniform(0.15, 0.9, (16, 16, 3)).astype(np.float32)
    cell = cells[(yy * 16).astype(int), (xx * 16).astype(int)]
    waves = 0.5 + 0.5 * np.sin(2 * np.pi * np.stack(
        [3 * xx + yy, 5 * yy, 2 * (xx - yy)], -1)).astype(np.float32)
    albedo = (0.6 * cell + 0.4 * waves).astype(np.float32)
    # normal map: random slopes of a few bumps, encoded as (n + 1) / 2
    m = 256
    yy, xx = np.mgrid[0:m, 0:m].astype(np.float32) / m
    sx = np.zeros((m, m), np.float32)
    sy = np.zeros((m, m), np.float32)
    for cx, cy, r in rng.uniform((0, 0, 0.05), (1, 1, 0.2), (12, 3)):
        dx, dy = xx - cx, yy - cy
        g = np.exp(-(dx * dx + dy * dy) / (r * r))
        sx += (dx / r) * g
        sy += (dy / r) * g
    nrm = np.stack([sx, sy, np.ones_like(sx)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    normals = (0.5 * (nrm + 1.0)).astype(np.float32)
    # environment: a blue-to-white sky over a dark ground and a warm sun
    ew, eh = 512, 256
    v = (np.arange(eh, dtype=np.float32) + 0.5) / eh
    u = (np.arange(ew, dtype=np.float32) + 0.5) / ew
    vv, uu = np.meshgrid(v, u, indexing="ij")
    sky = np.where(vv[..., None] > 0.5,
                   np.stack([0.3 + 0.5 * vv, 0.45 + 0.4 * vv,
                             0.9 + 0.0 * vv], -1),
                   np.stack([0.1 + 0.0 * vv] * 3, -1))
    sun = np.exp(-((uu - 0.3) ** 2 + (vv - 0.8) ** 2) / 0.002)
    sky = (sky + sun[..., None] * np.float32([8.0, 6.0, 3.5])
           + rng.uniform(0, 0.02, (eh, ew, 3))).astype(np.float32)
    paths = {}
    for name, img in (("albedo", albedo), ("normals", normals),
                      ("sky", sky)):
        paths[name] = os.path.join(str(dirpath), f"{name}.exr")
        write_exr(paths[name], img)
    return paths


def textured_scene(dirpath, seed=5):
    """`materials_scene()`'s box with textures on every kind of slot the
    port reads them from: a diffuse wall under a bilinear, repeat-wrapped
    1024 x 1024 image; a checkerboard whose scale and colors are registry
    `parameters`, as the weight of a blend; brick and fbm noise textures; a
    plastic whose reflectance is a PExpr mixing a texture call, `noise`,
    `hsvtorgb` and `lookup`; a normal map from a second, linear image; a bump
    map from the noise texture; a `transform` whose normal is a PExpr calling
    `bump(...)` and `ensure_valid_reflection(...)`; the demo's area light
    and an environment whose radiance is a third image, sampled uniformly
    (`"cdf": false`).  The images are written into `dirpath` as EXR, made
    from the numpy `seed`.  Depth 6, 434 triangles: the Baldwin-Weber tables
    serve it."""
    paths = _textured_images(dirpath, seed)
    scene = materials_scene()
    scene["parameters"] = [
        {"type": "number", "name": "p_scale", "value": 6},
        {"type": "color", "name": "p_col0", "value": [0.1, 0.1, 0.12]},
        {"type": "color", "name": "p_col1", "value": [0.9, 0.85, 0.8]},
    ]
    scene["textures"] = [
        {"type": "image", "name": "albedo", "filename": paths["albedo"],
         "filter_type": "bilinear", "wrap_mode": "repeat"},
        {"type": "image", "name": "normals", "filename": paths["normals"],
         "filter_type": "bilinear", "linear": True},
        {"type": "image", "name": "sky", "filename": paths["sky"],
         "filter_type": "bilinear"},
        {"type": "checkerboard", "name": "checker", "scale_x": "p_scale",
         "scale_y": "p_scale", "color0": "p_col0", "color1": "p_col1"},
        {"type": "brick", "name": "bricks", "color0": [0.25, 0.25, 0.25],
         "color1": [0.7, 0.3, 0.2], "scale_x": 4, "scale_y": 8},
        {"type": "fbm", "name": "clouds", "scale_x": 6, "scale_y": 6,
         "color": [0.9, 0.9, 0.9], "seed": 3},
    ]
    glaze = ("mix(bricks(uv * 2).rgb, hsvtorgb(color(lookup('linear', false, "
             "noise(uv * 8), vec2(0, 0.05), vec2(1, 0.6)), 0.6, 0.8)).rgb, "
             "0.5)")
    relief = ("ensure_valid_reflection(Ng, V, bump(N, Nx, Ny, 0.2, "
              "noise(uv * 12) - 0.5, noise(uv * 12 + 7.3) - 0.5))")
    scene["bsdfs"] = [
        {"type": "diffuse", "name": "white", "reflectance": [0.8, 0.8, 0.8]},
        {"type": "diffuse", "name": "albedo_wall", "reflectance": "albedo"},
        {"type": "diffuse", "name": "brick_wall", "reflectance": "bricks"},
        {"type": "normalmap", "name": "mapped", "bsdf": "brick_wall",
         "map": "normals", "strength": 0.8},
        {"type": "diffuse", "name": "grey", "reflectance": [0.6, 0.6, 0.7]},
        {"type": "bumpmap", "name": "bumped", "bsdf": "grey",
         "map": "clouds", "strength": 0.5},
        {"type": "plastic", "name": "glaze", "diffuse_reflectance": glaze},
        {"type": "roughconductor", "name": "brushed", "material": "gold",
         "roughness": 0.25},
        {"type": "blend", "name": "checkered", "first": "white",
         "second": "brushed", "weight": "checker"},
        {"type": "roughplastic", "name": "cloudy",
         "diffuse_reflectance": "clouds", "roughness": 0.3},
        {"type": "transform", "name": "relief", "bsdf": "cloudy",
         "normal": relief},
        {"type": "principled", "name": "painted", "base_color": "albedo",
         "roughness": 0.4},
    ]
    mats = dict(light="white", floor="checkered", back="albedo_wall",
                box="glaze", ball="relief", ball2="painted", left="mapped",
                right="bumped", block="brick_wall")
    scene["entities"] = [dict(name=k, shape=k, bsdf=v)
                         for k, v in mats.items()]
    scene["lights"] = [
        {"type": "area", "name": "light", "entity": "light",
         "radiance": [20, 20, 20]},
        {"type": "env", "name": "env", "radiance": "sky", "scale": 0.5,
         "cdf": False},
    ]
    return scene


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


def instanced_scene(n_side=32, subdiv=3, second_subdiv=None):
    """`n_side * n_side` entities that share ONE icosphere shape, each with
    its own scale, rotation and translation and one of three materials in
    turn (diffuse, conductor, dielectric), over a floor under a plane area
    light and a constant environment, plus four analytic spheres under a
    uniform scale, one of them emissive.  Depth 4, 512x512 film.  With the
    defaults 1024 instances stand for 1.31 M triangles while the pool holds
    the mesh's 1280.  With `second_subdiv`, every other entity shares a
    second icosphere of that subdivision instead (two shapes in the pool)."""
    rng = np.random.default_rng(11)
    pitch = 1.25
    half = 0.5 * pitch * (n_side - 1)
    bsdfs = [
        {"type": "diffuse", "name": "white", "reflectance": [0.7, 0.7, 0.7]},
        {"type": "diffuse", "name": "clay", "reflectance": [0.8, 0.35, 0.2]},
        {"type": "conductor", "name": "gold", "material": "gold"},
        {"type": "dielectric", "name": "glass", "int_ior": 1.5},
    ]
    span = 2.0 * half + 8.0
    shapes = [
        {"type": "icosphere", "name": "ball", "radius": 0.5,
         "subdivisions": subdiv},
        *([] if second_subdiv is None else [
            {"type": "icosphere", "name": "pebble", "radius": 0.5,
             "subdivisions": second_subdiv}]),
        {"type": "rectangle", "name": "floor", "width": span, "height": span,
         "transform": [{"translate": [0, -1, 0]}, {"rotate": [-90, 0, 0]}]},
        {"type": "rectangle", "name": "lamp", "width": 0.5 * span,
         "height": 0.5 * span,
         "transform": [{"translate": [0, 0.45 * span, 0]},
                       {"rotate": [90, 0, 0]}]},
    ]
    entities = [
        {"name": "floor", "shape": "floor", "bsdf": "white"},
        {"name": "lamp", "shape": "lamp", "bsdf": "white"},
    ]
    mats = ("clay", "gold", "glass")
    for i in range(n_side * n_side):
        gx, gz = i % n_side, i // n_side
        scale = float(rng.uniform(0.7, 1.1))
        entities.append({
            "name": f"b{i}",
            "shape": "pebble" if second_subdiv is not None and i % 2 else "ball",
            "bsdf": mats[i % 3],
            "transform": [
                {"translate": [gx * pitch - half, 0.5 * scale - 1.0,
                               gz * pitch - half]},
                {"rotate": [float(a) for a in rng.uniform(0, 360, 3)]},
                {"scale": scale}]})
    lights = [
        {"type": "area", "name": "lamp", "entity": "lamp",
         "radiance": [6, 6, 6]},
        {"type": "env", "name": "sky", "radiance": [0.4, 0.45, 0.5]},
    ]
    for k in range(4):
        ang = 0.5 * np.pi * k + 0.4
        shapes.append({"type": "sphere", "name": f"orb{k}", "radius": 1.0})
        entities.append({
            "name": f"orb{k}", "shape": f"orb{k}",
            "bsdf": ("white", "gold", "glass", "white")[k],
            "transform": [
                {"translate": [float(0.45 * half * np.cos(ang)), 2.5 + 0.5 * k,
                               float(0.45 * half * np.sin(ang))]},
                {"rotate": [0, 40.0 * k, 0]},
                {"scale": 1.0 + 0.25 * k}]})
    lights.append({"type": "area", "name": "orb3", "entity": "orb3",
                   "radiance": [8, 6, 4]})
    return {
        "technique": {"type": "path", "max_depth": 4},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": {"lookat": {
                       "origin": [0, 0.45 * half + 2.0, -1.15 * half - 3.0],
                       "target": [0, -1, -0.2 * half], "up": [0, 1, 0]}}},
        "film": {"size": [512, 512]},
        "bsdfs": bsdfs, "shapes": shapes, "entities": entities,
        "lights": lights,
    }


def _room_walls(width, height, depth, window):
    """Rectangles (shape dicts) of a closed width x height x depth room over
    x in [-w/2, w/2], y in [0, h], z in [-d/2, d/2], every normal pointing
    in, with a `window` = (w, h, sill height) opening centred in the wall at
    z = +d/2, made of four rectangles around the hole."""
    w2, d2 = 0.5 * width, 0.5 * depth
    ww, wh, sill = window
    top = sill + wh
    rects = [
        ("floor", width, depth, [0, 0, 0], [-90, 0, 0]),
        ("ceiling", width, depth, [0, height, 0], [90, 0, 0]),
        ("wall_left", depth, height, [-w2, 0.5 * height, 0], [0, 90, 0]),
        ("wall_right", depth, height, [w2, 0.5 * height, 0], [0, -90, 0]),
        ("wall_back", width, height, [0, 0.5 * height, -d2], [0, 0, 0]),
        # the window wall, around the opening
        ("win_left", w2 - 0.5 * ww, height,
         [-0.5 * (w2 + 0.5 * ww), 0.5 * height, d2], [0, 180, 0]),
        ("win_right", w2 - 0.5 * ww, height,
         [0.5 * (w2 + 0.5 * ww), 0.5 * height, d2], [0, 180, 0]),
        ("win_sill", ww, sill, [0, 0.5 * sill, d2], [0, 180, 0]),
        ("win_lintel", ww, height - top, [0, 0.5 * (height + top), d2],
         [0, 180, 0]),
    ]
    return [{"type": "rectangle", "name": n, "width": float(a),
             "height": float(b),
             "transform": [{"translate": [float(v) for v in t]},
                           {"rotate": r}]}
            for n, a, b, t, r in rects]


def daylight_scene(sun_elevation=0.6, sun_azimuth=0.3):
    """A furnished 6 x 3 x 8 m room under a sun and a Hosek-Wilkie sky,
    through a 2 x 1.5 m window, and 256 spot lights in a 16 x 16 grid under
    its ceiling: what a daylight / glare analysis renders (sun and sky
    through a window) in an interior lit by many fixtures.  The walls are
    rectangles around the window's opening; 16 icospheres of subdivision 3
    (1,280 triangles each) stand on the floor: 20,500 triangles, so the
    packet-BVH tables serve it.  Diffuse walls; among the spheres a
    conductor and a dielectric.  The sun and the sky share elevation and
    azimuth (radians); the sky (turbidity 3, ground albedo 0.8) is baked to
    an image and sampled by its 2D CDF.  The spots are given by `power`
    (cutoff 40 degrees, falloff 30).  Light selector: `hierarchy`.  Depth 6,
    512x512 film."""
    rng = np.random.default_rng(19)
    width, height, depth = 6.0, 3.0, 8.0
    shapes = _room_walls(width, height, depth, (2.0, 1.5, 0.9))
    walls = [s["name"] for s in shapes]
    bsdfs = [
        {"type": "diffuse", "name": "plaster", "reflectance": [0.75, 0.73, 0.7]},
        {"type": "diffuse", "name": "oak", "reflectance": [0.45, 0.3, 0.18]},
        {"type": "conductor", "name": "steel", "material": "aluminum"},
        {"type": "dielectric", "name": "glass", "int_ior": 1.5},
    ]
    entities = [{"name": n, "shape": n,
                 "bsdf": "oak" if n == "floor" else "plaster"} for n in walls]
    for i in range(16):
        gx, gz = i % 4, i // 4
        r = float(rng.uniform(0.25, 0.4))
        c = [float(-2.1 + 1.4 * gx + rng.uniform(-0.2, 0.2)), r,
             float(-2.4 + 1.6 * gz + rng.uniform(-0.2, 0.2))]
        shapes.append({"type": "icosphere", "name": f"ball{i}", "center": c,
                       "radius": r, "subdivisions": 3})
        if i == 5:
            mat = "steel"
        elif i == 10:
            mat = "glass"
        else:
            mat = f"paint{i}"
            bsdfs.append({"type": "diffuse", "name": mat, "reflectance": [
                float(v) for v in rng.uniform(0.2, 0.85, 3)]})
        entities.append({"name": f"ball{i}", "shape": f"ball{i}",
                         "bsdf": mat})
    lights = [
        {"type": "sun", "name": "sun", "elevation": sun_elevation,
         "azimuth": sun_azimuth, "irradiance": [6.0, 5.7, 5.2]},
        {"type": "sky", "name": "sky", "elevation": sun_elevation,
         "azimuth": sun_azimuth, "turbidity": 3.0,
         "ground": [0.8, 0.8, 0.8]},
    ]
    for i in range(256):
        gx, gz = i % 16, i // 16
        lights.append({
            "type": "spot", "name": f"spot{i}",
            "position": [float(-2.7 + 0.36 * gx), 2.9,
                         float(-3.7 + 0.4933 * gz)],
            "direction": [0.0, -1.0, 0.0],
            "power": [float(rng.uniform(0.5, 1.5))] * 3,
            "cutoff": 40.0, "falloff": 30.0})
    return {
        "technique": {"type": "path", "max_depth": 6,
                      "light_selector": "hierarchy"},
        "camera": {"type": "perspective", "fov": 70,
                   "transform": {"lookat": {
                       "origin": [0.0, 1.6, -3.6], "target": [0.0, 1.2, 4.0],
                       "up": [0, 1, 0]}}},
        "film": {"size": [512, 512]},
        "bsdfs": bsdfs, "shapes": shapes, "entities": entities,
        "lights": lights,
    }


def _env_image(path, seed, width=1024, height=512):
    """An HDR environment for `env_scene`, made from a numpy seed: a
    blue-to-white sky with soft clouds, a dark ground and a small bright sun.
    Written to `path` as EXR."""
    from ignis_tpu_torch.utils.exr import write_exr
    rng = np.random.default_rng(seed)
    v = (np.arange(height, dtype=np.float32) + 0.5) / height
    u = (np.arange(width, dtype=np.float32) + 0.5) / width
    vv, uu = np.meshgrid(v, u, indexing="ij")
    sky = np.where(vv[..., None] > 0.5,
                   np.stack([0.25 + 0.6 * vv, 0.4 + 0.5 * vv,
                             0.95 + 0.0 * vv], -1),
                   np.stack([0.08 + 0.04 * vv] * 3, -1))
    clouds = np.zeros((height, width), np.float32)
    for cu, cv, r in rng.uniform((0, 0.55, 0.02), (1, 0.95, 0.08), (24, 3)):
        du = np.minimum(np.abs(uu - cu), 1.0 - np.abs(uu - cu))
        clouds += np.exp(-(du * du + (vv - cv) ** 2) / (r * r))
    sun = np.exp(-((uu - 0.62) ** 2 + (vv - 0.78) ** 2) / 2e-4)
    img = (sky + 0.5 * np.minimum(clouds, 1.0)[..., None]
           + sun[..., None] * np.float32([60.0, 52.0, 40.0])
           + rng.uniform(0, 0.02, (height, width, 3))).astype(np.float32)
    write_exr(path, img)


def env_scene(dirpath, seed=7):
    """The demo box (98 triangles: the Baldwin-Weber tables serve it)
    relit by a 1024 x 512 HDR environment sampled by its summed-area table
    (`"cdf_method": "sat"`), 64 point lights in an 8 x 8 grid and the demo's
    plane area light, under the `cdf` light selector: a product shot under
    an HDR environment map, seen from the box's open side.  The EXR is written into `dirpath`, made from
    the numpy `seed`.  Depth 6."""
    import os
    path = os.path.join(str(dirpath), "env.exr")
    _env_image(path, seed)
    rng = np.random.default_rng(seed)
    scene = demo_scene()
    # from the open side of the box, as `materials_scene` looks in, wider
    scene["camera"] = dict(scene["camera"], fov=60, transform=[
        1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -3.85, 0, 0, 0, 1])
    scene["film"] = {"size": [512, 512]}
    scene["technique"] = dict(scene["technique"], light_selector="cdf")
    scene["textures"] = [{"type": "image", "name": "env", "filename": path,
                          "filter_type": "bilinear"}]
    lights = [scene["lights"][0],
              {"type": "env", "name": "env", "radiance": "env", "scale": 0.8,
               "cdf_method": "sat", "transform": {"rotate": [0, 30, 0]}}]
    for i in range(64):
        gx, gz = i % 8, i // 8
        lights.append({"type": "point", "name": f"pt{i}",
                       "position": [float(-0.84 + 0.24 * gx), 0.7,
                                    float(-0.84 + 0.24 * gz)],
                       "intensity": [float(x) for x in
                                     rng.uniform(0.01, 0.08, 3)]})
    scene["lights"] = lights
    return scene


def _smooth_noise(rng, shape, passes):
    """Uniform noise box-blurred `passes` times along each axis, rescaled to
    [0, 1]: a smooth random field."""
    a = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    for _ in range(passes):
        for ax in range(len(shape)):
            a = (a + np.roll(a, 1, ax) + np.roll(a, -1, ax)) / 3.0
    a -= a.min()
    return (a / max(float(a.max()), 1e-12)).astype(np.float32)


def _media_grids(dirpath, seed, cloud_res=128, glow_res=64):
    """The two heterogeneous media of `media_scene`, made from a numpy seed
    and written into `dirpath`: a cloud_res^3 NanoVDB density cloud (a
    smooth noise field under a spherical falloff, zero outside it) and a
    glow_res^3 `.bin` voxel grid of absorption, scattering and emission.
    Returns the two paths."""
    import os
    from ignis_tpu_torch.medium.nanovdb import write_nvdb_grid
    from ignis_tpu_torch.medium.volume import write_voxel_grid_bin
    rng = np.random.default_rng(seed)
    c = (np.arange(cloud_res, dtype=np.float32) + 0.5) / cloud_res - 0.5
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z) / 0.5
    falloff = np.clip(1.0 - r, 0.0, 1.0) ** 0.5
    noise = _smooth_noise(rng, (cloud_res,) * 3, 4)
    cloud = np.clip(1.6 * noise * falloff - 0.25, 0.0, None).astype(np.float32)
    cloud_path = os.path.join(str(dirpath), "cloud.nvdb")
    write_nvdb_grid(cloud_path, cloud, "density")

    g = (np.arange(glow_res, dtype=np.float32) + 0.5) / glow_res - 0.5
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    core = np.exp(-(x * x + y * y + z * z) / 0.04)
    field = _smooth_noise(rng, (glow_res,) * 3, 3)
    sigma_a = (0.5 + 4.0 * field * core)[..., None] * np.float32(
        [1.0, 1.0, 1.0])
    sigma_s = (0.3 * field)[..., None] * np.float32([1.0, 0.9, 0.8])
    emission = (core * (0.5 + field))[..., None] * np.float32([4.0, 1.6, 0.4])
    glow_path = os.path.join(str(dirpath), "glow.bin")
    write_voxel_grid_bin(glow_path, sigma_a, sigma_s, emission)
    return cloud_path, glow_path


def media_scene(dirpath, seed=11, cloud_res=128, glow_res=64):
    """The demo box (Baldwin-Weber tables: 670 triangles) filled with
    participating media, under the `volpath` technique: a dielectric sphere
    holding a homogeneous scattering medium (sigma_a 0.05, sigma_s 0.8,
    g 0.3); a tinted glass sphere holding an absorb-only medium (the glTF
    attenuation case); a passthrough cube holding a cloud_res^3 NanoVDB
    density cloud (`pbrt_volume` shader, trilinear, delta tracking with ratio
    tracking for its transmittance); and a passthrough cube holding an
    emissive glow_res^3 voxel grid (`method: regular`).  The grids are
    written into `dirpath` from the numpy `seed`.  The demo's plane light
    and constant environment, seen from the box's open side; depth 8,
    512x512 film."""
    cloud_path, glow_path = _media_grids(dirpath, seed, cloud_res, glow_res)
    scene = demo_scene()
    scene["technique"] = {"type": "volpath", "max_depth": 8}
    # from the open side of the box, as `env_scene` looks in, closer
    scene["camera"] = dict(scene["camera"], fov=38, transform=[
        1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -3.85, 0, 0, 0, 1])
    scene["film"] = {"size": [512, 512]}
    scene["bsdfs"] = scene["bsdfs"][:2] + [
        {"type": "dielectric", "name": "glass", "int_ior": 1.5},
        {"type": "dielectric", "name": "tinted", "int_ior": 1.45},
        {"type": "passthrough", "name": "null"},
    ]
    keep = ("light", "floor", "back")
    scene["shapes"] = [s for s in scene["shapes"] if s["name"] in keep] + [
        {"type": "icosphere", "name": "fog_ball", "center": [-0.5, -0.6, 0.1],
         "radius": 0.4, "subdivisions": 2},
        {"type": "icosphere", "name": "tint_ball",
         "center": [0.55, -0.72, -0.25], "radius": 0.28, "subdivisions": 2},
        {"type": "cube", "name": "cloud_box", "width": 0.8, "height": 0.8,
         "depth": 0.8, "transform": [{"translate": [-0.15, 0.35, 0.35]}]},
        {"type": "cube", "name": "glow_box", "width": 0.45, "height": 0.45,
         "depth": 0.45, "transform": [{"translate": [0.6, -0.05, -0.3]}]},
    ]
    scene["entities"] = [e for e in scene["entities"] if e["name"] in keep] + [
        {"name": "fog_ball", "shape": "fog_ball", "bsdf": "glass",
         "inner_medium": "fog"},
        {"name": "tint_ball", "shape": "tint_ball", "bsdf": "tinted",
         "inner_medium": "tint"},
        {"name": "cloud_box", "shape": "cloud_box", "bsdf": "null",
         "inner_medium": "cloud"},
        {"name": "glow_box", "shape": "glow_box", "bsdf": "null",
         "inner_medium": "glow"},
    ]
    scene["media"] = [
        {"type": "homogeneous", "name": "fog", "sigma_a": [0.05, 0.05, 0.05],
         "sigma_s": [0.8, 0.8, 0.8], "g": 0.3},
        {"type": "homogeneous", "name": "tint", "sigma_a": [0.2, 0.9, 1.6],
         "sigma_s": [0.0, 0.0, 0.0]},
        {"type": "heterogeneous", "name": "cloud", "filename": cloud_path,
         "shader": "pbrt_volume", "scalar_density": 6.0,
         "color_scattering": [0.9, 0.9, 0.9],
         "color_absorption": [0.1, 0.1, 0.1], "interpolate": True,
         "method": "delta_tracking", "g": 0.2},
        {"type": "heterogeneous", "name": "glow", "filename": glow_path,
         "method": "regular", "g": 0.0},
    ]
    return scene


# the LBNL "Klems Full" angle basis: (theta center, lower, upper, phi count)
# of its 9 bands, 145 patches
KLEMS_FULL = ((0.0, 0.0, 5.0, 1), (10.0, 5.0, 15.0, 8), (20.0, 15.0, 25.0, 16),
              (30.0, 25.0, 35.0, 20), (40.0, 35.0, 45.0, 24),
              (50.0, 45.0, 55.0, 24), (60.0, 55.0, 65.0, 24),
              (70.0, 65.0, 75.0, 16), (82.5, 75.0, 90.0, 12))


def write_klems_xml(path, seed, basis=KLEMS_FULL, tau=0.7, rho=0.08):
    """A glazing's Klems BSDF as a WINDOW / Radiance XML file, made from a
    numpy `seed`: four components (transmission and reflection, front and
    back) over one angle `basis` (default "LBNL/Klems Full", 145 patches).
    Transmission is a direct peak (`tau` of the light through the patch it
    came from) over a seeded diffuse haze; reflection a small seeded diffuse
    part (`rho`) with a specular diagonal.  Values are BSDF values (1/sr),
    the direct terms divided by each patch's projected solid angle."""
    rng = np.random.default_rng(seed)
    lo = np.deg2rad([b[1] for b in basis])
    hi = np.deg2rad([b[2] for b in basis])
    nphi = np.asarray([b[3] for b in basis])
    n = int(nphi.sum())
    lam = np.repeat((np.cos(lo) ** 2 - np.cos(hi) ** 2) * np.pi / nphi, nphi)
    blocks = "".join(
        f"<AngleBasisBlock><Theta>{c}</Theta><nPhis>{k}</nPhis>"
        f"<ThetaBounds><LowerTheta>{a}</LowerTheta>"
        f"<UpperTheta>{b}</UpperTheta></ThetaBounds></AngleBasisBlock>"
        for c, a, b, k in basis)
    comps = []
    for direction, kind in (("Transmission Front", "t"),
                            ("Transmission Back", "t"),
                            ("Reflection Front", "r"),
                            ("Reflection Back", "r")):
        haze = rng.uniform(0.5, 1.5, (n, n)) / np.pi
        if kind == "t":
            m = 0.04 * haze + np.diag(tau / lam)
        else:
            m = rho * haze + np.diag(0.04 / lam)
        data = " ".join(f"{v:.6g}" for v in m.astype(np.float32).ravel())
        comps.append(
            "<WavelengthData><LayerNumber>System</LayerNumber>"
            "<Wavelength unit=\"Integral\">Visible</Wavelength>"
            "<WavelengthDataBlock>"
            f"<WavelengthDataDirection>{direction}</WavelengthDataDirection>"
            "<ColumnAngleBasis>LBNL/Klems Full</ColumnAngleBasis>"
            "<RowAngleBasis>LBNL/Klems Full</RowAngleBasis>"
            f"<ScatteringDataType>BTDF</ScatteringDataType>"
            f"<ScatteringData>{data}</ScatteringData>"
            "</WavelengthDataBlock></WavelengthData>")
    xml = ("<?xml version=\"1.0\"?>"
           "<WindowElement xmlns=\"http://windows.lbl.gov\"><Optical><Layer>"
           "<DataDefinition>"
           "<IncidentDataStructure>Columns</IncidentDataStructure>"
           "<AngleBasis><AngleBasisName>LBNL/Klems Full</AngleBasisName>"
           f"{blocks}</AngleBasis></DataDefinition>"
           + "".join(comps) + "</Layer></Optical></WindowElement>")
    with open(path, "w") as f:
        f.write(xml)


def write_tensortree_xml(path, seed, depth=4, peak=6.0):
    """A glazing's isotropic tensor-tree BSDF (TensorTree3) as a Radiance
    XML file, made from a numpy `seed`: each of the four components is a
    seeded smooth base over (incident radius, outgoing x, y) plus a peak at
    the outgoing disk's center, the tree refined down to `depth` levels
    only where the peak varies (the rest stays single-value leaves)."""
    rng = np.random.default_rng(seed)

    def write_node(lo, size, level, f, tol):
        # a leaf of 8 values, one at each half-cell's center (the first
        # dimension in the highest bit), or 8 children (the first dimension
        # in the lowest bit)
        vals = [f(lo + (np.asarray([(k >> 2) & 1, (k >> 1) & 1, k & 1])
                        + 0.5) * 0.5 * size) for k in range(8)]
        spread = max(vals + [f(lo + 0.5 * size)]) - min(vals)
        if level >= depth or spread < tol:
            if np.ptp(vals) < 1e-3 * tol:
                return "{ %.6g }" % vals[0]
            return "{ " + " ".join("%.6g" % v for v in vals) + " }"
        kids = []
        for k in range(8):
            bits = np.asarray([k & 1, (k >> 1) & 1, (k >> 2) & 1])
            kids.append(write_node(lo + bits * 0.5 * size, 0.5 * size,
                                   level + 1, f, tol))
        return "{ " + " ".join(kids) + " }"

    comps = []
    for direction, scale in (("Transmission Front", 1.0),
                             ("Transmission Back", 1.0),
                             ("Reflection Front", 0.1),
                             ("Reflection Back", 0.1)):
        a, b, w = rng.uniform(0.05, 0.2), rng.uniform(-0.05, 0.05), \
            rng.uniform(0.08, 0.15)

        def f(p, a=a, b=b, w=w, scale=scale):
            r2 = (p[1] - 0.5) ** 2 + (p[2] - 0.5) ** 2
            return scale * (a + b * p[0] + peak * np.exp(-r2 / (w * w)))
        tree = write_node(np.zeros(3), 1.0, 1, f, 0.05 * peak * scale)
        comps.append(
            "<WavelengthData><LayerNumber>System</LayerNumber>"
            "<Wavelength unit=\"Integral\">Visible</Wavelength>"
            "<WavelengthDataBlock>"
            f"<WavelengthDataDirection>{direction}</WavelengthDataDirection>"
            "<AngleBasis>LBNL/Shirley-Chiu</AngleBasis>"
            "<ScatteringDataType>BTDF</ScatteringDataType>"
            f"<ScatteringData>{{ {tree} }}</ScatteringData>"
            "</WavelengthDataBlock></WavelengthData>")
    xml = ("<?xml version=\"1.0\"?>"
           "<WindowElement xmlns=\"http://windows.lbl.gov\"><Optical><Layer>"
           "<DataDefinition>"
           "<IncidentDataStructure>TensorTree3</IncidentDataStructure>"
           "</DataDefinition>"
           + "".join(comps) + "</Layer></Optical></WindowElement>")
    with open(path, "w") as f:
        f.write(xml)


def _smooth_field(rng, shape):
    """Seeded uniform noise + 0.2, box-blurred once along the last two axes:
    the Dupuy-Jakob fields' generator of tests/test_djmeasured.py."""
    a = rng.random(shape).astype(np.float32) + 0.2
    for ax in (-1, -2):
        a = (a + np.roll(a, 1, ax) + np.roll(a, -1, ax)) / 3.0
    return a.astype(np.float32)


def write_dj_bsdf(path, seed, nphi=1, ntheta=11, res=64, lres=32):
    """A synthetic but valid isotropic Dupuy-Jakob `tensor_file` (ndf,
    sigma, vndf, luminance and rgb fields of smooth seeded noise over
    `ntheta` incident elevations).  Returns the fields."""
    from ignis_tpu_torch.measured.djmeasured import write_tensor_file
    rng = np.random.default_rng(seed)
    fields = {
        "theta_i": np.linspace(0.0, 1.5, ntheta).astype(np.float32),
        "phi_i": np.zeros(nphi, np.float32),
        "ndf": _smooth_field(rng, (res, res)),
        "sigma": _smooth_field(rng, (res, res)),
        "vndf": _smooth_field(rng, (nphi, ntheta, res, res)),
        "luminance": _smooth_field(rng, (nphi, ntheta, lres, lres)),
        "rgb": _smooth_field(rng, (nphi, ntheta, 3, lres, lres)),
        "description": np.frombuffer(b"synthetic", np.uint8),
        "jacobian": np.zeros(1, np.uint8),
    }
    write_tensor_file(path, fields)
    return fields


def measured_scene(dirpath, seed=13):
    """`daylight_scene()`'s room (20,498 triangles: the packet-BVH tables)
    with measured materials: the window opening glazed by two panes, one a
    Klems BSDF over the "LBNL/Klems Full" basis (145 patches, four 145 x 145
    matrices), one a TensorTree3 BSDF; the 16 icospheres in one
    Dupuy-Jakob (djmeasured) BRDF of 11 incident elevations, 64 x 64 NDF /
    VNDF and 32 x 32 luminance / RGB fields.  Every file is written into
    `dirpath` from the numpy `seed`; the sizes are chosen, not those of a
    published measurement.  The sun, the sky and the 256 spots under the
    light hierarchy; depth 6, 512x512 film."""
    import os
    d = str(dirpath)
    klems = os.path.join(d, "glazing_klems.xml")
    tree = os.path.join(d, "glazing_tt.xml")
    dj = os.path.join(d, "paint.bsdf")
    write_klems_xml(klems, seed)
    write_tensortree_xml(tree, seed + 1)
    write_dj_bsdf(dj, seed + 2)
    scene = daylight_scene()
    scene["bsdfs"] = [b for b in scene["bsdfs"]
                      if not b["name"].startswith("paint")] + [
        {"type": "klems", "name": "pane_klems", "filename": klems,
         "up": [0, 1, 0]},
        {"type": "tensortree", "name": "pane_tt", "filename": tree,
         "up": [0, 1, 0]},
        {"type": "djmeasured", "name": "measured_paint", "filename": dj},
    ]
    for e in scene["entities"]:
        if e["bsdf"].startswith("paint"):
            e["bsdf"] = "measured_paint"
    # two 1 x 1.5 m panes in the 2 x 1.5 m window at z = +4, sill 0.9 m
    for name, x in (("pane_klems", -0.5), ("pane_tt", 0.5)):
        scene["shapes"].append({
            "type": "rectangle", "name": name, "width": 1.0, "height": 1.5,
            "transform": [{"translate": [x, 1.65, 4.0]},
                          {"rotate": [0, 180, 0]}]})
        scene["entities"].append({"name": name, "shape": name, "bsdf": name})
    return scene
