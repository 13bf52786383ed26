"""`materials_scene()` rendered through both packages: per lane at depth 2
and by image mean at full depth, as test_torch_path.py holds the demo.

Tolerances: per lane 1e-4 with at most 0.5 % of the lanes flipped (a
last-ulp difference may flip a Fresnel, lobe or russian-roulette pick), image
means 1 %; the BSDFs themselves are held one by one in
test_torch_bsdf_breadth.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.render.integrator import trace_wave as j_trace_wave
from ignis_tpu.scene.compile import load_and_compile as j_compile
from ignis_tpu_torch.api import Runtime
from ignis_tpu_torch.convert import tables_from_numpy
from ignis_tpu_torch.render.integrator import trace_wave
from ignis_tpu_torch.scene.compile import load_and_compile as t_compile
from ignis_tpu_torch.scenes import materials_scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops on these small inputs run faster on one intra-op
    thread, and the test workers sharing the CPU then do not oversubscribe
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pixels(w, h):
    idx = np.arange(w * h, dtype=np.int32)
    return idx % w, idx // w


def _both_trace(scene, w, h, sample=0, seed=0):
    js, ts = j_compile(scene, w, h), t_compile(scene, w, h)
    x, y = _pixels(w, h)
    ref = np.asarray(j_trace_wave(
        js, {k: jnp.asarray(v) for k, v in js.tables.items()},
        jnp.asarray(x), jnp.asarray(y), jnp.uint32(sample), jnp.uint32(0),
        jnp.uint32(0), seed))
    got = trace_wave(ts, tables_from_numpy(ts.tables, "cpu"),
                     torch.from_numpy(x), torch.from_numpy(y), sample, 0, 0,
                     seed).numpy()
    return ref, got


def test_materials_scene_per_lane_depth2():
    """Both packages through the Moeller-Trumbore sweep (raw tables): per
    lane 1e-4 with at most 0.5 % of the lanes flipped, as
    test_torch_path.py holds the demo."""
    scene = materials_scene()
    scene["technique"] = dict(scene["technique"], max_depth=2)
    ref, got = _both_trace(scene, 24, 24)
    assert np.isfinite(got).all() and ref.mean() > 0
    ok = np.isclose(got, ref, rtol=1e-4, atol=1e-4).all(axis=-1)
    assert ok.mean() >= 0.995, (~ok).sum()
    assert abs(got.mean() - ref.mean()) <= 2e-3 * ref.mean()


def test_materials_runtime_full_depth_by_mean():
    """`Runtime(materials_scene())` renders on the CPU through its
    Baldwin-Weber tables; its frame is held to the JAX package's render of
    the same samples by image mean (1 %), and most pixels agree one by
    one."""
    ref, got_t = _both_trace(materials_scene(), 16, 16, seed=3)
    rt = Runtime(materials_scene(), width=16, height=16, seed=3,
                 device="cpu")
    assert "bw_tris" in rt.tables
    rt.step(spi=1)
    img = rt.currentFrame().reshape(-1, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    assert abs(img.mean() - ref.mean()) <= 1e-2 * ref.mean()
    assert abs(got_t.mean() - ref.mean()) <= 1e-2 * ref.mean()
    ok = np.isclose(img, ref, rtol=1e-3, atol=1e-3).all(axis=-1)
    assert ok.mean() >= 0.95
