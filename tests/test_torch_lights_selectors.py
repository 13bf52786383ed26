"""The reference's light hierarchy checks (tests/test_light_hierarchy.py,
its non-slow tests) through the port's `Runtime`, and each selector beside a
sun and a sky through both packages' `Runtime.step` on the JAX tables (per
lane at depth 2, 1e-4 on at least 99.5 % of the lanes; helpers and the
tolerance's reason in tests/test_torch_lights_render.py)."""

import json

import numpy as np
import pytest
import torch

from ignis_tpu_torch.api import Runtime
from test_torch_lights_render import _frames, _one_torch_thread, _per_lane  # noqa: F401


def _grid_light_scene(selector, nl=16):
    """4x4 grid of point lights over a diffuse floor."""
    from test_light_hierarchy import _grid_light_scene as ref
    return ref(selector, nl)


def _port_render(scene_dict, spi, iters, seed=0, size=32):
    rt = Runtime(json.loads(json.dumps(scene_dict)), width=size,
                 height=size, seed=seed, device="cpu")
    for _ in range(iters):
        rt.step(spi=spi)
    img = rt.currentFrame()
    assert np.isfinite(img).all()
    return img


def test_hierarchy_tables_built():
    rt = Runtime(_grid_light_scene("hierarchy"), device="cpu")
    assert "lh_child" in rt.tables
    assert rt.scene.lh_depth >= 4  # 16 lights -> depth 5 tree
    codes = rt.tables["lh_codes"].numpy()
    assert len(set(codes.tolist())) == len(codes)


def test_sample_pdf_consistency():
    """The replay's pdf equals the sampler's, and the pdfs over all lights
    sum to 1 at any point, on the port's tables."""
    from ignis_tpu_torch.light.hierarchy import hierarchy_pdf, hierarchy_sample
    rt = Runtime(_grid_light_scene("hierarchy"), device="cpu")
    t = rt.tables
    n = 512
    pos = torch.from_numpy(
        np.random.RandomState(0).uniform(-3, 3, (n, 3)).astype(np.float32))
    seed = torch.arange(n, dtype=torch.int64) * 7919
    counter = torch.ones(n, dtype=torch.int64)
    act = torch.ones(n, dtype=torch.bool)
    loc, pdf, _ = hierarchy_sample(t, pos, seed, counter, act,
                                   rt.scene.lh_depth)
    pdf2 = hierarchy_pdf(t, loc, pos, rt.scene.lh_depth)
    np.testing.assert_allclose(pdf.numpy(), pdf2.numpy(), rtol=1e-5)
    nl = t["lh_codes"].shape[0]
    tot = sum(hierarchy_pdf(t, torch.full((n,), i, dtype=torch.int32), pos,
                            rt.scene.lh_depth).numpy() for i in range(nl))
    np.testing.assert_allclose(tot, 1.0, rtol=1e-4)


def test_hierarchy_unbiased_vs_cdf():
    imgs = {sel: _port_render(_grid_light_scene(sel), spi=4, iters=8)
            for sel in ("cdf", "hierarchy")}
    assert abs(imgs["hierarchy"].mean() - imgs["cdf"].mean()) \
        < 0.05 * imgs["cdf"].mean()


def test_hierarchy_lower_variance_many_lights():
    var = {}
    for sel in ("cdf", "hierarchy"):
        renders = np.stack([_port_render(_grid_light_scene(sel), 1, 1,
                                         seed=s) for s in range(6)])
        var[sel] = float(np.mean(np.var(renders, axis=0)))
    assert var["hierarchy"] < var["cdf"], var


@pytest.mark.parametrize("selector", ["simple", "cdf", "hierarchy"])
def test_selector_scene_per_lane(selector):
    """The grid of point lights beside a sun and a sky under each selector,
    the JAX tables through the port (`lh_depth` travels with the scene's
    metadata), and the port's own compile rendering the same frame."""
    s = _grid_light_scene(selector)
    s["lights"] += [
        {"type": "sun", "name": "sun", "direction": [0.3, -1.0, 0.2],
         "irradiance": [1.5, 1.4, 1.2]},
        {"type": "sky", "name": "sky", "elevation": 0.7, "azimuth": 1.0}]
    ref, got, rt = _frames(s, 24, depth=2)
    _per_lane(ref, got)
    assert ("lh_child" in rt.tables) == (selector == "hierarchy")
    if selector == "hierarchy":
        assert rt.scene.lh_depth == 5
    own = Runtime(s, width=24, height=24, device="cpu")
    own.step(spi=1)
    np.testing.assert_array_equal(own.currentFrame(), got)
