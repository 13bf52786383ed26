"""Gradients of the port's differentiable render,
`trace_wave(differentiable=True)`, against `jax.grad` of the same loss on the
same tables, and against central differences.

The checks of tests/test_gradients.py (point-light reflectance, area-light
radiance) and tests/test_gradients_fd.py (env radiance, rough-conductor
roughness, multi-bounce indirect) run through the port, with the same scenes,
lanes and slots.  test_torch_gradients_scenes.py holds the gradients with
respect to `mat_colors`, `light_data` and `mat_scalars` on `demo_scene()` and
`materials_scene()` with the helpers of this file.

Both packages get the raw compiled tables, so both trace with the
Moeller-Trumbore sweep.  Tolerances: per entry rel 1e-3 and abs 1e-6 at
max_depth <= 2; rel 2e-2 (abs 1e-6) deeper, where a last-ulp difference may
flip a Fresnel or russian-roulette pick in one package only.  The set of
nonzero entries must be equal.  Central differences: the reference tests'
eps and rel, through the port's own forward (which test_torch_path.py and
test_torch_bsdf_breadth.py hold to the JAX package's).

Where the JAX package's gradient is NaN the port's is finite: its union
evaluates every BSDF type on every lane with the other types' parameter rows
(a diffuse row read as a dielectric or plastic one gives eta = 0 / 0), and
its Fresnel term's sqrt(max(cos2_t, 0)) has a NaN slope under total internal
reflection.  One NaN anywhere spreads to every entry of the table it reaches
(ROADMAP.md, queue 3).  So the demo's `mat_scalars` gradient is compared on
the entries where the JAX one is finite (all but the IOR slots 1 and 2), and
the materials scene's, where the JAX gradient is NaN almost everywhere, is
held to central differences only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import create_flat_scene
from ignis_tpu.render.integrator import trace_wave as j_trace_wave
from ignis_tpu.scene.compile import load_and_compile as j_compile
from ignis_tpu_torch.convert import params_from_numpy
from ignis_tpu_torch.render.integrator import trace_wave
from ignis_tpu_torch.scene.compile import load_and_compile as t_compile

SHALLOW = dict(rtol=1e-3, atol=1e-6)   # max_depth <= 2
DEEP = dict(rtol=2e-2, atol=1e-6)


def _compile(scene_dict, size=16, depth=None):
    scene_dict = dict(scene_dict)
    scene_dict["film"] = {"size": [size, size]}
    if depth is not None:
        scene_dict["technique"] = dict(scene_dict["technique"],
                                       max_depth=depth)
    return j_compile(scene_dict), t_compile(scene_dict)


def _lanes(scene, n, center=False):
    idx = np.arange(n, dtype=np.int32)
    if center:  # lanes over the middle rows of the film
        idx = idx + (scene.width * scene.height // 2 - n // 2)
    return idx % scene.width, idx // scene.width % scene.height


class Loss:
    """mean(trace_wave(...)) over `n` lanes, in both packages, as a function
    of the tables named in `keys`."""

    def __init__(self, js, ts, keys, n=64, center=False):
        self.js, self.ts, self.keys = js, ts, keys
        self.x, self.y = _lanes(ts, n, center)
        self.jt = {k: jnp.asarray(v) for k, v in js.tables.items()}

    def jax_grad(self):
        x, y = jnp.asarray(self.x), jnp.asarray(self.y)

        def loss(p):
            t = dict(self.jt)
            t.update(p)
            return jnp.mean(j_trace_wave(self.js, t, x, y, jnp.uint32(0),
                                         jnp.uint32(0), jnp.uint32(0), 0,
                                         differentiable=True))
        val, g = jax.value_and_grad(loss)({k: self.jt[k] for k in self.keys})
        return float(val), {k: np.asarray(v) for k, v in g.items()}

    def port_grad(self):
        """(loss, gradients) of the port; the tables of `keys` are leaves
        that require grad."""
        tt = params_from_numpy(self.ts.tables, self.keys, "cpu")
        loss = trace_wave(self.ts, tt, torch.from_numpy(self.x),
                          torch.from_numpy(self.y), 0, 0, 0, 0,
                          differentiable=True).mean()
        loss.backward()
        return (float(loss.detach()),
                {k: tt[k].grad.numpy() for k in self.keys})

    def port_value(self, key, val):
        """The loss with table `key` set to `val`, reduced in float64 so
        that the rounding of the mean does not swamp a central
        difference."""
        with torch.no_grad():
            tabs = dict(self.ts.tables, **{key: val})
            tt = params_from_numpy(tabs, (), "cpu")
            c = trace_wave(self.ts, tt, torch.from_numpy(self.x),
                           torch.from_numpy(self.y), 0, 0, 0, 0,
                           differentiable=True)
            return float(c.double().mean())


def _hold_to_jax(got, ref, tol, finite_only=False):
    """Port gradient == JAX gradient per entry, same nonzero set."""
    assert np.isfinite(got).all()
    fin = np.isfinite(ref) if finite_only else np.ones(ref.shape, bool)
    assert np.isfinite(ref[fin]).all()
    np.testing.assert_array_equal(got[fin] != 0, ref[fin] != 0)
    np.testing.assert_allclose(got[fin], ref[fin], **tol)
    return fin


def _check_fd(loss, key, val, g, slots, eps=1e-3, rel=2e-2):
    """The port's gradient `g` against central differences of the port's
    loss, as tests/test_gradients_fd.py's `_check_fd` does."""
    checked = 0
    for slot in slots:
        up, dn = val.copy(), val.copy()
        up[slot] += eps
        dn[slot] -= eps
        fd = (loss.port_value(key, up) - loss.port_value(key, dn)) / (2 * eps)
        an = float(g[slot])
        if abs(fd) < 1e-7 and abs(an) < 1e-7:
            continue
        assert fd == pytest.approx(an, rel=rel, abs=1e-6), (slot, fd, an)
        checked += 1
    assert checked > 0, "no slot produced signal"


# ------------------------------------------- tests/test_gradients.py, ported
def test_grad_wrt_diffuse_reflectance_point_light():
    sd = create_flat_scene()
    sd["lights"].append({"type": "point", "name": "_l",
                         "position": [0, 0, -2], "intensity": [1, 1, 1]})
    js, ts = _compile(sd)
    loss = Loss(js, ts, ("mat_colors",))
    jval, jg = loss.jax_grad()
    val, g = loss.port_grad()
    assert val == pytest.approx(jval, rel=1e-5)
    g = g["mat_colors"]
    # point-light NEE radiance is linear in kd: positive on slot 0
    assert np.all(g[0, 0] > 0), g
    _hold_to_jax(g, jg["mat_colors"], SHALLOW)
    mc = np.asarray(ts.tables["mat_colors"])
    _check_fd(loss, "mat_colors", mc, g, [(0, 0, c) for c in range(3)],
              eps=1e-3, rel=5e-3)


def test_grad_wrt_area_light_radiance():
    sd = {
        "technique": {"type": "path", "max_depth": 3},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -2]},
        "film": {"size": [16, 16]},
        "bsdfs": [{"type": "diffuse", "name": "g",
                   "reflectance": [0.5, 0.5, 0.5]}],
        "shapes": [
            {"type": "rectangle", "name": "floor", "width": 2, "height": 2,
             "flip_normals": True},
            {"type": "rectangle", "name": "lamp", "width": 0.2,
             "height": 0.2, "transform": [{"translate": [0, 0, -1.0]}]},
        ],
        "entities": [
            {"name": "floor", "shape": "floor", "bsdf": "g"},
            {"name": "lamp", "shape": "lamp", "bsdf": "g"},
        ],
        "lights": [{"type": "area", "name": "al", "entity": "lamp",
                    "radiance": [2, 2, 2]}],
    }
    js, ts = _compile(sd)
    loss = Loss(js, ts, ("light_data",), n=js.width * js.height)
    _jv, jg = loss.jax_grad()
    _v, g = loss.port_grad()
    g = g["light_data"]
    # the radiance slots of the plane area light (cols 13:16) matter
    assert np.any(np.abs(g[0, 13:16]) > 0), g[0]
    _hold_to_jax(g, jg["light_data"], DEEP)
    _check_fd(loss, "light_data", np.asarray(ts.tables["light_data"]), g,
              [(0, 13)], eps=1e-2, rel=1e-2)


# ---------------------------------------- tests/test_gradients_fd.py, ported
def test_grad_env_radiance():
    sd = create_flat_scene()
    sd["lights"] = [{"type": "env", "name": "sky",
                     "radiance": [0.6, 0.7, 0.8]}]
    js, ts = _compile(sd)
    loss = Loss(js, ts, ("light_data",))
    _jv, jg = loss.jax_grad()
    _v, g = loss.port_grad()
    g = g["light_data"]
    _hold_to_jax(g, jg["light_data"], SHALLOW)
    ld = np.asarray(ts.tables["light_data"])
    slots = [(0, c) for c in range(8) if abs(ld[0, c]) > 0.05]
    _check_fd(loss, "light_data", ld, g, slots, eps=1e-2)


def test_grad_roughness_roughconductor():
    sd = create_flat_scene()
    sd["bsdfs"] = [{"type": "roughconductor", "name": "ground",
                    "material": "gold", "roughness": 0.4}]
    sd["lights"] = [{"type": "point", "name": "l",
                     "position": [0.3, 0.2, -2], "intensity": [2, 2, 2]}]
    js, ts = _compile(sd)
    loss = Loss(js, ts, ("mat_scalars",))
    _jv, jg = loss.jax_grad()
    _v, g = loss.port_grad()
    g = g["mat_scalars"]
    _hold_to_jax(g, jg["mat_scalars"], SHALLOW)
    nz = [tuple(i) for i in np.argwhere(np.abs(g) > 1e-6)]
    assert nz, "roughness produced no gradient"
    _check_fd(loss, "mat_scalars", np.asarray(ts.tables["mat_scalars"]), g,
              nz[:3], eps=1e-3, rel=5e-2)


def test_grad_multibounce_indirect():
    """Gradient flows through a 3-bounce indirect path (the red wall is seen
    only via one diffuse bounce)."""
    sd = {
        "technique": {"type": "path", "max_depth": 4, "min_depth": 4},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -2]},
        "film": {"size": [16, 16]},
        "bsdfs": [
            {"type": "diffuse", "name": "floor",
             "reflectance": [0.8, 0.8, 0.8]},
            {"type": "diffuse", "name": "red",
             "reflectance": [0.9, 0.1, 0.1]},
        ],
        "shapes": [
            {"type": "rectangle", "name": "fl", "width": 4, "height": 4,
             "flip_normals": True},
            {"type": "rectangle", "name": "side", "width": 4, "height": 4,
             "transform": [{"rotate": [0, -90, 0]},
                           {"translate": [1.5, 0, 0]}]},
        ],
        "entities": [
            {"name": "fl", "shape": "fl", "bsdf": "floor"},
            {"name": "side", "shape": "side", "bsdf": "red"},
        ],
        "lights": [{"type": "point", "name": "l",
                    "position": [0, 0, -1.5], "intensity": [4, 4, 4]}],
    }
    js, ts = _compile(sd)
    loss = Loss(js, ts, ("mat_colors",), n=256)
    _jv, jg = loss.jax_grad()
    _v, g = loss.port_grad()
    g = g["mat_colors"]
    # the red wall (mat 1) is never directly visible, but its color gets
    # gradient through the indirect bounce
    assert np.any(np.abs(g[1, 0]) > 1e-8), g[1]
    _hold_to_jax(g, jg["mat_colors"], DEEP)
    _check_fd(loss, "mat_colors", np.asarray(ts.tables["mat_colors"]), g,
              [(1, 0, 0)], eps=1e-2, rel=5e-2)
