"""Gradients of the differentiable `volpath` render
(`trace_wave(differentiable=True)`) against `jax.grad` of the JAX package's:
the homogeneous absorbing box of tests/test_gradients_fd.py
(`test_grad_sigma_a_homogeneous`, w.r.t. `medium_data`) and a NanoVDB cloud
(w.r.t. its shader row, `medium_shader`).

Tolerance: the losses within 1e-5 (relative), the gradients within 1e-4
(relative to the largest entry) on the JAX gradient's finite entries (the
JAX package's gradient may be NaN where the port's is finite, see
`ROADMAP.md`, queue 3), and the port's finite everywhere.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ignis_tpu.render.integrator import trace_wave as j_trace
from ignis_tpu.scene.compile import load_and_compile as j_compile
from ignis_tpu_torch.convert import params_from_numpy, scene_from_metadata
from ignis_tpu_torch.render.integrator import trace_wave


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fog_box():
    """tests/test_gradients_fd.py's scene: camera rays cross an absorbing
    fog box to a lit wall."""
    return {
        "technique": {"type": "volpath", "max_depth": 4},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -2]},
        "film": {"size": [16, 16]},
        "media": [{"type": "homogeneous", "name": "fog",
                   "sigma_a": [0.8, 0.5, 0.2], "sigma_s": [0, 0, 0]}],
        "bsdfs": [
            {"type": "passthrough", "name": "null"},
            {"type": "diffuse", "name": "wall",
             "reflectance": [0.8, 0.8, 0.8]},
        ],
        "shapes": [
            {"type": "cube", "name": "box", "width": 1, "height": 1,
             "depth": 1},
            {"type": "rectangle", "name": "back", "width": 6, "height": 6,
             "transform": [{"translate": [0, 0, 1.5]},
                           {"rotate": [180, 0, 0]}]},
        ],
        "entities": [
            {"name": "box", "shape": "box", "bsdf": "null",
             "inner_medium": "fog"},
            {"name": "back", "shape": "back", "bsdf": "wall"},
        ],
        "lights": [{"type": "point", "name": "l", "position": [0, 4, 1.3],
                    "intensity": [30, 30, 30]}],
    }


def _cloud(d):
    """The fog box holding an emissive NanoVDB cloud under the
    `pbrt_volume` shader (trilinear).  Delta tracking's events carry no
    pathwise derivative of the density (its ratios cancel), so the
    gradient reaches the shader row through the emission of absorption
    events."""
    from ignis_tpu_torch.medium.nanovdb import write_nvdb_grid
    rng = np.random.default_rng(4)
    write_nvdb_grid(str(d / "c.nvdb"),
                    rng.uniform(0.1, 1.0, (6, 5, 7)).astype(np.float32))
    s = _fog_box()
    s["technique"]["max_depth"] = 2
    s["media"] = [{"type": "heterogeneous", "name": "fog",
                   "filename": str(d / "c.nvdb"), "shader": "pbrt_volume",
                   "interpolate": True, "scalar_density": 1.5,
                   "color_scattering": [0.4, 0.3, 0.2],
                   "color_absorption": [0.5, 0.7, 0.9], "g": 0.3,
                   "scalar_emission": 2.0,
                   "color_emission": [1.0, 0.6, 0.3]}]
    return s


def _grads(sd, key, n=64):
    scene = j_compile(sd)
    tables = {k: jnp.asarray(v) for k, v in scene.tables.items()}
    idx = np.arange(n, dtype=np.int32) + (scene.width * scene.height // 2
                                          - n // 2)
    x, y = idx % scene.width, idx // scene.width % scene.height

    def loss(val):
        t = dict(tables)
        t[key] = val
        return jnp.mean(j_trace(scene, t, jnp.asarray(x), jnp.asarray(y),
                                jnp.uint32(0), jnp.uint32(0), jnp.uint32(0),
                                0, differentiable=True))
    jl, jg = jax.value_and_grad(loss)(tables[key])
    ts = scene_from_metadata(scene)
    tt = params_from_numpy(scene.tables, (key,), "cpu")
    c = trace_wave(ts, tt, torch.from_numpy(x), torch.from_numpy(y), 0, 0, 0,
                   0, differentiable=True)
    tl = c.mean()
    tl.backward()
    return (float(jl), np.asarray(jg)), (float(tl.detach()),
                                         tt[key].grad.numpy())


def _held(j, t):
    (jl, jg), (tl, tg) = j, t
    assert tl == pytest.approx(jl, rel=1e-5)
    assert np.isfinite(tg).all()
    ok = np.isfinite(jg)
    assert ok.any() and np.abs(jg[ok]).max() > 0
    np.testing.assert_allclose(tg[ok], jg[ok], rtol=0,
                               atol=1e-4 * np.abs(jg[ok]).max())


def test_grad_sigma_a_homogeneous():
    j, t = _grads(_fog_box(), "medium_data")
    _held(j, t)
    # sigma_a of the fog's three channels all carry signal
    assert (np.abs(t[1][0, 0:3]) > 1e-6).all()


def test_grad_cloud_shader_row(tmp_path):
    j, t = _grads(_cloud(tmp_path), "medium_shader")
    _held(j, t)
    # scalar_emission and the emission color reach the render
    g = t[1][0]
    assert abs(g[1]) > 0 and (np.abs(g[8:11]) > 0).all()
