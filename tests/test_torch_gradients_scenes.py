"""Gradients of the port's differentiable render on the headline scenes:
`mat_colors`, `light_data` and `mat_scalars` on `demo_scene()` against
`jax.grad`, and on `materials_scene()` against central differences.

The helpers, the tolerances and the reason the JAX package's gradient is NaN
on the materials scene are those of test_torch_gradients.py (its
docstring): per entry rel 1e-3 / abs 1e-6 at max_depth <= 2, rel 2e-2 deeper;
the demo's `mat_scalars` on the entries where the JAX gradient is finite.
"""

import numpy as np
import pytest

from ignis_tpu_torch.scenes import demo_scene, materials_scene
from test_torch_gradients import (
    DEEP, SHALLOW, Loss, _check_fd, _compile, _hold_to_jax,
)

# ------------------------------------------------------------ the headlines
KEYS = ("mat_colors", "light_data", "mat_scalars")


@pytest.mark.parametrize("depth", [2, None])
def test_demo_gradients_match_jax(depth):
    """All three tables at once on the demo scene, 256 lanes: per entry
    against `jax.grad` (mat_scalars where the JAX one is finite)."""
    js, ts = _compile(demo_scene(), depth=depth)
    loss = Loss(js, ts, KEYS, n=256)
    jval, jg = loss.jax_grad()
    val, g = loss.port_grad()
    assert val == pytest.approx(jval, rel=1e-4)
    tol = SHALLOW if depth == 2 else DEEP
    for k in ("mat_colors", "light_data"):
        _hold_to_jax(g[k], jg[k], tol)
        assert np.abs(g[k]).max() > 0, k
    fin = _hold_to_jax(g["mat_scalars"], jg["mat_scalars"], tol,
                       finite_only=True)
    assert set(np.argwhere(~fin)[:, 1]) <= {1, 2}


@pytest.fixture(scope="module")
def materials_grads():
    js, ts = _compile(materials_scene(), depth=2)
    loss = Loss(js, ts, KEYS, n=256)
    return loss, loss.port_grad()


def test_materials_gradients_finite_and_nonzero():
    """At full depth, every material of the scene that a lane sees gets a
    finite, nonzero color gradient; the light and the roughness slots get
    one too."""
    js, ts = _compile(materials_scene())
    loss = Loss(js, ts, KEYS, n=256)
    val, g = loss.port_grad()
    assert np.isfinite(val) and val > 0
    for k in KEYS:
        assert np.isfinite(g[k]).all(), k
    names = loss.ts.material_names
    seen = [names.index(m) for m in ("plastic", "rough_plastic", "brushed",
                                     "principled", "phong", "blend",
                                     "tilted", "frosted")]
    colors = g["mat_colors"]
    assert all(np.abs(colors[m]).max() > 0 for m in seen)
    assert np.abs(g["light_data"][0, 0:6]).min() > 0   # lamp position, power
    sc = g["mat_scalars"]
    assert np.abs(sc[names.index("brushed"), 0]).max() > 0
    assert np.abs(sc[names.index("rough_plastic"), 0]).max() > 0


@pytest.mark.parametrize("key,slots,eps", [
    ("mat_colors", (("plastic", 0, 0), ("rough_plastic", 0, 1),
                    ("tilted", 0, 2)), 1e-3),
    ("light_data", ((0, 3), (0, 4)), 1e-2),
    ("mat_scalars", (("brushed", 0), ("rough_plastic", 0)), 1e-2),
])
def test_materials_gradients_match_central_differences(materials_grads, key,
                                                       slots, eps):
    """Slots that steer no sampling decision (a diffuse albedo, the point
    lamp's intensity, a microfacet roughness), so that the central
    difference is smooth at depth 2."""
    loss, (_val, g) = materials_grads
    names = loss.ts.material_names
    slots = [tuple(names.index(s) if isinstance(s, str) else s for s in sl)
             for sl in slots]
    _check_fd(loss, key, np.asarray(loss.ts.tables[key]), g[key], slots,
              eps=eps, rel=5e-2)
