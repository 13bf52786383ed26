"""The port's `parallel.sharding.train_step` against the JAX package's
`sharded_train_step` on a one-device CPU mesh: three SGD steps from the same
tables, target, lanes and seed.

Tolerances: losses rel 1e-4; updated parameters rel 1e-4, abs 1e-6 (the
demo at depth 2, where both gradients agree per entry to well within that:
tests/test_torch_gradients.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.parallel.sharding import make_mesh, sharded_train_step
from ignis_tpu.scene.compile import load_and_compile as j_compile
from ignis_tpu_torch.convert import params_from_numpy, tables_from_numpy
from ignis_tpu_torch.parallel.sharding import train_step
from ignis_tpu_torch.render.integrator import trace_wave
from ignis_tpu_torch.scene.compile import load_and_compile as t_compile
from ignis_tpu_torch.scenes import demo_scene, materials_scene

KEYS = ("mat_colors", "light_data")
LR = 0.5
N = 256


def _scene(fn, depth=2, size=16):
    s = fn()
    s["film"] = {"size": [size, size]}
    s["technique"] = dict(s["technique"], max_depth=depth)
    return s


def _start(tables):
    """The true tables with every material color scaled by 0.7."""
    t = dict(tables)
    t["mat_colors"] = np.asarray(tables["mat_colors"]) * np.float32(0.7)
    return t


def test_three_steps_match_sharded_train_step():
    scene = _scene(demo_scene)
    js, ts = j_compile(scene), t_compile(scene)
    idx = np.arange(N, dtype=np.int32)
    x, y = idx % ts.width, idx // ts.width % ts.height
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    # the target: the render of the true tables
    target = trace_wave(ts, tables_from_numpy(ts.tables, "cpu"), tx, ty,
                        0, 0, 0, 0)

    mesh = make_mesh(1, devices=jax.devices()[:1])
    jstep = sharded_train_step(js, mesh, param_keys=KEYS, lr=LR)
    jt = {k: jnp.asarray(v) for k, v in _start(js.tables).items()}
    tt = params_from_numpy(_start(ts.tables), KEYS, "cpu")
    soup = tt["tri_v0"]
    jtarget = jnp.asarray(target.numpy())
    losses = []
    for _ in range(3):
        jloss, jt = jstep(jt, jnp.asarray(x), jnp.asarray(y), jnp.uint32(0),
                          jnp.uint32(0), jnp.uint32(0), 0, jtarget)
        loss, tt = train_step(ts, tt, tx, ty, 0, 0, 0, 0, target,
                              param_keys=KEYS, lr=LR)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
        losses.append(float(loss))
        for k in KEYS:
            assert tt[k].is_leaf and tt[k].requires_grad
            np.testing.assert_allclose(tt[k].detach().numpy(),
                                       np.asarray(jt[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    assert losses[0] > 0 and losses[2] < losses[0]
    # the tables that are not parameters are passed through as they are
    assert tt["tri_v0"] is soup


def test_materials_train_step_descends():
    """The chip_smoke.py `train` phase at a small size on the CPU: the
    technique's contributions clamped at 10, colors scaled by 0.7 and
    roughness slots moved by +0.1, then five steps with mat_colors,
    mat_scalars and light_data as parameters; every loss finite, the fifth
    below the first."""
    scene = _scene(materials_scene, depth=6)
    scene["technique"] = dict(scene["technique"], clamp=10.0)
    ts = t_compile(scene)
    idx = np.arange(ts.width * ts.height, dtype=np.int32)
    tx = torch.from_numpy(idx % ts.width)
    ty = torch.from_numpy(idx // ts.width)
    target = trace_wave(ts, tables_from_numpy(ts.tables, "cpu"), tx, ty,
                        0, 0, 0, 0)
    start = _start(ts.tables)
    sc = np.array(ts.tables["mat_scalars"])
    rough = [ts.material_names.index(m) for m in ("brushed", "frosted",
                                                  "rough_plastic")]
    sc[rough, 0] += 0.1
    sc[rough, 4] += 0.1
    start["mat_scalars"] = sc
    keys = ("mat_colors", "mat_scalars", "light_data")
    tt = params_from_numpy(start, keys, "cpu")
    losses = []
    for _ in range(5):
        loss, tt = train_step(ts, tt, tx, ty, 0, 0, 0, 0, target,
                              param_keys=keys, lr=LR)
        losses.append(float(loss))
    assert np.isfinite(losses).all(), losses
    assert losses[4] < losses[0], losses
