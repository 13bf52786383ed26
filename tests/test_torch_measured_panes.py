"""Three measured materials (a Klems pane and a TensorTree pane, each lit
from behind through the glazing, and a Dupuy-Jakob floor) under a point
light and a sky, through both packages: by image mean at depth 4 (2 %, the
port's `Runtime` on the JAX package's tables) and the gradient of the
differentiable render w.r.t. `mat_colors` at depth 2 against `jax.grad`
(the losses within 1e-4 relative, the gradients within 1e-4 of the largest
entry on the JAX gradient's finite entries, the port's finite
everywhere)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ignis_tpu.api import Runtime as JRuntime
from ignis_tpu.render.integrator import trace_wave as j_trace
from ignis_tpu.scene.compile import load_and_compile as j_compile
from ignis_tpu_torch.convert import (
    params_from_numpy, runtime_from_jax_tables, scene_from_metadata,
)
from ignis_tpu_torch.render.integrator import trace_wave
from ignis_tpu_torch.scenes import (
    write_dj_bsdf, write_klems_xml, write_tensortree_xml,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def panes(d, depth):
    """Three quads under a point light and a sky: a Klems pane and a
    TensorTree pane (each lit from behind through the glazing) and a
    Dupuy-Jakob floor."""
    write_klems_xml(d / "k.xml", 1, basis=((0.0, 0.0, 20.0, 1),
                                           (35.0, 20.0, 50.0, 6),
                                           (70.0, 50.0, 90.0, 8)))
    write_tensortree_xml(d / "t.xml", 2, depth=3)
    write_dj_bsdf(d / "p.bsdf", 3, ntheta=5, res=16, lres=8)
    quad = {"type": "rectangle", "width": 1.2, "height": 1.2}
    return {
        "technique": {"type": "path", "max_depth": depth},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": {"translate": [0, 0.3, -3]}},
        "film": {"size": [16, 16]},
        "bsdfs": [{"type": "klems", "name": "k", "filename": str(d / "k.xml"),
                   "up": [0, 1, 0]},
                  {"type": "tensortree", "name": "t",
                   "filename": str(d / "t.xml"), "up": [0, 1, 0]},
                  {"type": "djmeasured", "name": "p",
                   "filename": str(d / "p.bsdf"), "tint": [1, 0.8, 0.6]}],
        "shapes": [dict(quad, name="a", transform={"translate": [-0.7, 0.4,
                                                                 0]}),
                   dict(quad, name="b", transform={"translate": [0.7, 0.4,
                                                                 0]}),
                   dict(quad, name="f", width=4, height=4,
                        transform=[{"translate": [0, -0.4, 0]},
                                   {"rotate": [-90, 0, 0]}])],
        "entities": [{"name": "a", "shape": "a", "bsdf": "k"},
                     {"name": "b", "shape": "b", "bsdf": "t"},
                     {"name": "f", "shape": "f", "bsdf": "p"}],
        "lights": [{"type": "point", "name": "l", "position": [0.3, 1.5, -1],
                    "intensity": [4, 4, 4]},
                   {"type": "constant", "name": "sky",
                    "radiance": [0.4, 0.5, 0.6]}],
    }


def test_measured_materials_by_mean_depth4(tmp_path):
    jrt = JRuntime(panes(tmp_path, 4), width=16, height=16, seed=1)
    jrt.step(spi=2)
    rt = runtime_from_jax_tables(jrt.scene, jrt.tables, device="cpu",
                                 seed=1)
    rt.step(spi=2)
    ref, got = np.asarray(jrt.currentFrame()), rt.currentFrame()
    assert np.isfinite(got).all() and ref.mean() > 0
    assert abs(got.mean() - ref.mean()) <= 0.02 * ref.mean()


def test_measured_materials_gradient(tmp_path):
    scene = j_compile(panes(tmp_path, 2))
    tables = {k: jnp.asarray(v) for k, v in scene.tables.items()}
    n = 256
    x = np.arange(n, dtype=np.int32) % 16
    y = np.arange(n, dtype=np.int32) // 16

    def loss(val):
        t = dict(tables)
        t["mat_colors"] = val
        return jnp.mean(j_trace(scene, t, jnp.asarray(x), jnp.asarray(y),
                                jnp.uint32(0), jnp.uint32(0), jnp.uint32(0),
                                0, differentiable=True))
    jl, jg = jax.value_and_grad(loss)(tables["mat_colors"])
    tt = params_from_numpy(scene.tables, ("mat_colors",), "cpu")
    c = trace_wave(scene_from_metadata(scene), tt, torch.from_numpy(x),
                   torch.from_numpy(y), 0, 0, 0, 0, differentiable=True)
    tl = c.mean()
    tl.backward()
    tg, jg = tt["mat_colors"].grad.numpy(), np.asarray(jg)
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-4)
    assert np.isfinite(tg).all()
    ok = np.isfinite(jg)
    np.testing.assert_allclose(tg[ok], jg[ok], rtol=0,
                               atol=1e-4 * np.abs(jg[ok]).max())
    # each measured material's tint reaches the render
    assert (np.abs(tg[:3, 0]).max(axis=-1) > 0).all()
