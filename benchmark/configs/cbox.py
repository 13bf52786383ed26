"""The Cornell box: walls and the light as quads, the blocks as transformed
cubes, one PLY a part."""

from benchmark.scenes import assemble, box, lookat, quad


def build(cfg, film, max_depth):
    parts = []
    for p in cfg["parts"]:
        v, f = quad(*p["quad"]) if "quad" in p else box(p["box"])
        parts.append(dict(name=p["name"], material=p["material"],
                          vertices=v, faces=f))
    cam = cfg["camera"]
    eye, d, up = lookat(cam["eye"], cam["target"], cam["up"])
    camera = dict(eye=eye, dir=d, up=up, fov=cam["fov"])
    return assemble(cfg, parts, film, camera, max_depth)
