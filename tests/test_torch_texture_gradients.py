"""Gradients of the port's differentiable render with respect to texels and
registry parameters: tests/test_gradients_fd.py's `test_grad_texture_texel`
and `test_grad_registry_param` through the port, against `jax.grad` of the
same loss on the same tables (rel 1e-3, abs 1e-6 per entry at depth 2, the
same nonzero entries) and against central differences with the reference
tests' eps and rel.  Helpers: tests/test_torch_gradients.py.
"""

import numpy as np
import pytest
import torch

from conftest import create_flat_scene
from ignis_tpu_torch.utils.exr import write_exr
from test_torch_gradients import SHALLOW, Loss, _check_fd, _compile, _hold_to_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops on these small inputs run faster on one intra-op
    thread, and the test workers sharing the CPU then do not oversubscribe
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_grad_texture_texel(tmp_path):
    """d radiance / d texel of an image texture driving reflectance."""
    img = np.full((4, 4, 3), 0.5, np.float32)
    img[1, 2] = [0.9, 0.3, 0.1]
    path = tmp_path / "tex.exr"
    write_exr(str(path), img)
    sd = create_flat_scene()
    sd["textures"] = [{"type": "image", "name": "tex",
                       "filename": str(path)}]
    sd["bsdfs"][0]["reflectance"] = "tex"
    sd["lights"] = [{"type": "point", "name": "l",
                     "position": [0, 0, -2], "intensity": [1, 1, 1]}]
    js, ts = _compile(sd)
    key = [k for k in ts.tables if k.endswith("_img")]
    assert key == ["tex0_img"], sorted(ts.tables)
    loss = Loss(js, ts, tuple(key), center=True)
    jv, jg = loss.jax_grad()
    tv, tg = loss.port_grad()
    assert abs(tv - jv) <= 1e-5 * abs(jv)
    g = tg[key[0]]
    _hold_to_jax(g, jg[key[0]], SHALLOW)
    nz = [tuple(i) for i in np.argwhere(np.abs(g) > 1e-7)]
    assert nz, "no texel received gradient"
    _check_fd(loss, key[0], ts.tables[key[0]], g, nz[:3], eps=1e-2,
              rel=3e-2)


def test_grad_registry_param():
    """d radiance / d registry parameter (scene `parameters` section)."""
    sd = create_flat_scene()
    sd["parameters"] = [{"type": "number", "name": "bright", "value": 0.7}]
    sd["bsdfs"][0]["reflectance"] = "vec3(bright, bright, bright)"
    sd["lights"] = [{"type": "point", "name": "l", "position": [0, 0, -2],
                     "intensity": [1, 1, 1]}]
    js, ts = _compile(sd)
    assert "bright" in ts.param_registry
    loss = Loss(js, ts, ("params",))
    jv, jg = loss.jax_grad()
    tv, tg = loss.port_grad()
    assert abs(tv - jv) <= 1e-5 * abs(jv)
    _hold_to_jax(tg["params"], jg["params"], SHALLOW)
    _, off, _ = ts.param_registry["bright"]
    assert tg["params"][off] != 0
    _check_fd(loss, "params", ts.tables["params"], tg["params"], [off],
              eps=1e-3)


def test_grad_textured_scene_fd(tmp_path):
    """`scenes.textured_scene()` at depth 2: the gradient with respect to
    its albedo texels and its registry (the checker colors weight a blend)
    is finite and agrees with central differences of the port's forward on
    the largest entries."""
    from ignis_tpu_torch.scenes import textured_scene
    sd = textured_scene(tmp_path)
    sd["technique"] = dict(sd["technique"], max_depth=2)
    _, ts = _compile(sd, size=20)
    keys = ("tex0_img", "params")
    loss = Loss(ts, ts, keys, n=400)
    _, g = loss.port_grad()
    for k in keys:
        assert np.isfinite(g[k]).all() and (g[k] != 0).any(), k
    top = np.argsort(-np.abs(g["tex0_img"]).reshape(-1))[:3]
    slots = [np.unravel_index(i, g["tex0_img"].shape) for i in top]
    _check_fd(loss, "tex0_img", ts.tables["tex0_img"], g["tex0_img"], slots,
              eps=1e-2, rel=3e-2)
    _, off, _ = ts.param_registry["p_col1"]
    _check_fd(loss, "params", ts.tables["params"], g["params"], [off],
              eps=1e-3)
