"""Gradients of the port's differentiable render with respect to the light
rows (`light_data`) and the texels of an importance-sampled environment,
against `jax.grad` of the same loss on the same tables.

The scene: the flat test scene's plane beside a sphere, lit by a 4 x 4 grid
of spot lights under the `hierarchy` selector, a sun and a textured
environment sampled by its 2D CDF; depth 2 (a `jax.grad` through a deeper
bounce scan takes minutes to compile on the CPU).  Tolerance: 1e-4 relative
(1e-9 absolute) on the JAX gradient's finite entries, the same nonzero
entries.  Helpers: tests/test_torch_gradients.py.
"""

import copy

import numpy as np
import pytest

from conftest import create_flat_scene
from ignis_tpu_torch.utils.exr import write_exr
from test_torch_gradients import Loss, _compile, _hold_to_jax

TOL = dict(rtol=1e-4, atol=1e-9)


def light_grid_scene(env_path, cdf_method="cdf"):
    """The flat plane and an icosphere in front of it under 16 spots (a
    4 x 4 grid, `hierarchy`), a sun and an env image with its CDF."""
    s = copy.deepcopy(create_flat_scene())
    s["technique"] = {"type": "path", "max_depth": 2,
                      "light_selector": "hierarchy"}
    s["textures"] = [{"type": "image", "name": "sky", "filename": env_path,
                      "filter_type": "bilinear"}]
    s["shapes"].append({"type": "icosphere", "name": "ball", "radius": 0.25,
                        "subdivisions": 1, "center": [0.3, -0.2, -0.3]})
    s["bsdfs"].append({"type": "diffuse", "name": "clay",
                       "reflectance": [0.8, 0.4, 0.3]})
    s["entities"].append({"name": "ball", "shape": "ball", "bsdf": "clay"})
    rng = np.random.default_rng(8)
    lights = [
        {"type": "sun", "name": "sun", "direction": [0.3, -0.4, 1.0],
         "irradiance": [2.0, 1.8, 1.5]},
        {"type": "env", "name": "sky", "radiance": "sky", "scale": 0.7,
         "cdf_method": cdf_method, "transform": {"rotate": [0, 25, 0]}},
    ]
    for i in range(16):
        gx, gy = i % 4, i // 4
        lights.append({
            "type": "spot", "name": f"spot{i}",
            "position": [-0.75 + 0.5 * gx, -0.75 + 0.5 * gy, -1.2],
            "direction": [float(v) for v in rng.uniform(-0.3, 0.3, 2)]
            + [1.0],
            "intensity": [float(v) for v in rng.uniform(0.2, 1.0, 3)],
            "cutoff": 40.0, "falloff": 30.0})
    s["lights"] = lights
    return s


def env_image(path, seed=4, h=8, w=16):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.05, 1.5, (h, w, 3)).astype(np.float32)
    img[2, 5] = [9.0, 7.0, 5.0]
    write_exr(str(path), img)
    return str(path)


@pytest.mark.parametrize("cdf_method", ["cdf", "sat"])
def test_grad_light_data_and_env_texels(tmp_path, cdf_method):
    sd = light_grid_scene(env_image(tmp_path / "sky.exr"), cdf_method)
    js, ts = _compile(sd, size=16)
    assert ts.lh_depth >= 4 and ts.lights[1].type == 4
    keys = ("light_data", "tex0_img")
    loss = Loss(js, ts, keys, n=256)
    jv, jg = loss.jax_grad()
    tv, tg = loss.port_grad()
    assert abs(tv - jv) <= 1e-5 * abs(jv)
    for k in keys:
        fin = _hold_to_jax(tg[k], jg[k], TOL, finite_only=True)
        assert (tg[k][fin] != 0).any(), k
    # every light kind of the scene reaches the gradient: the sun's and a
    # spot's irradiance / intensity, and the env's scale
    ld = tg["light_data"]
    assert (ld[0, 3:6] != 0).any() and (ld[1, 0:3] != 0).any()
    assert (ld[2:, 6:9] != 0).any()
