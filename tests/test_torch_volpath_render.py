"""`volpath` scenes through both packages' `Runtime.step`, per lane at
depth 2: tests/test_media.py's scenes (a constant voxel grid against its
homogeneous twin, an emissive grid, a NanoVDB cloud, ratio tracking) and
dielectric spheres holding a scattering and an absorb-only medium (the
medium-interface crossing).  tests/test_torch_volpath_render_mean.py holds
the same scenes by image mean at depth 4.

The port renders the JAX package's own tables (`runtime_from_jax_tables`):
1e-4 (rtol and atol) with at most 0.5 % of the lanes apart (a last-bit
difference can flip a branch), as the other render tests hold a scene.
`media_scene()` is held in tests/test_torch_media_scene.py.
"""

import copy

import numpy as np
import pytest
import torch

from ignis_tpu.api import Runtime as JRuntime
from ignis_tpu_torch.convert import runtime_from_jax_tables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops on these small films run faster on one intra-op
    thread, and the test workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _glass_media(d):
    """Two dielectric spheres, one holding a scattering medium (g 0.3), one
    an absorb-only medium, in front of a lit diffuse wall."""
    return {
        "technique": {"type": "volpath", "max_depth": 4},
        "camera": {"type": "perspective", "fov": 50,
                   "transform": {"translate": [0, 0, -3]}},
        "film": {"size": [16, 16]},
        "bsdfs": [{"type": "dielectric", "name": "glass", "int_ior": 1.5},
                  {"type": "diffuse", "name": "wall",
                   "reflectance": [0.7, 0.7, 0.7]}],
        "shapes": [
            {"type": "icosphere", "name": "a", "center": [-0.5, 0, 0],
             "radius": 0.45, "subdivisions": 2},
            {"type": "icosphere", "name": "b", "center": [0.5, 0.1, 0.2],
             "radius": 0.4, "subdivisions": 2},
            {"type": "rectangle", "name": "back", "width": 6, "height": 6,
             "transform": [{"translate": [0, 0, 1.5]},
                           {"rotate": [180, 0, 0]}]}],
        "entities": [
            {"name": "a", "shape": "a", "bsdf": "glass",
             "inner_medium": "fog"},
            {"name": "b", "shape": "b", "bsdf": "glass",
             "inner_medium": "tint"},
            {"name": "back", "shape": "back", "bsdf": "wall"}],
        "lights": [{"type": "point", "name": "l", "position": [0, 2, -1],
                    "intensity": [8, 8, 8]},
                   {"type": "constant", "name": "sky",
                    "radiance": [0.3, 0.3, 0.4]}],
        "media": [{"type": "homogeneous", "name": "fog",
                   "sigma_a": [0.05, 0.05, 0.05],
                   "sigma_s": [1.5, 1.2, 0.9], "g": 0.3},
                  {"type": "homogeneous", "name": "tint",
                   "sigma_a": [0.3, 1.2, 2.0], "sigma_s": [0, 0, 0]}],
    }


def _reference_media(kind):
    """tests/test_media.py's scenes."""
    def make(d):
        import test_media as tm
        from ignis_tpu_torch.medium.nanovdb import write_nvdb_grid
        if kind == "emissive grid":
            s = tm._hetero_scene(d, [3.0, 3.0, 3.0], [0, 0, 0],
                                 emission=(5.0, 5.0, 5.0))
            s["lights"] = []
            return s
        sa, ss = [0.1, 0.1, 0.1], [0.8, 0.8, 0.8]
        if kind == "ratio tracking":
            sa, ss = [0.4, 0.9, 1.4], [0.3, 0.2, 0.1]
        s = tm._hetero_scene(d, sa, ss, g=0.3)
        if kind == "ratio tracking":
            s["media"][0]["method"] = "delta_tracking"
        elif kind == "homogeneous twin":
            s["media"] = [{"type": "homogeneous", "name": "Med",
                           "sigma_a": sa, "sigma_s": ss, "g": 0.3}]
        elif kind == "nanovdb":
            write_nvdb_grid(str(d / "cloud.nvdb"),
                            np.full((8, 8, 8), 0.8, np.float32), "density")
            s["media"] = [{"type": "heterogeneous", "name": "Med",
                           "filename": str(d / "cloud.nvdb"),
                           "shader": "monochromatic", "scalar_density": 1.0,
                           "scalar_scattering": 1.0,
                           "scalar_absorption": 0.2, "g": 0.0}]
        return s
    return make


SCENES = {**{k: _reference_media(k) for k in (
    "constant grid", "homogeneous twin", "emissive grid", "nanovdb",
    "ratio tracking")}, "glass media": _glass_media}


def frames(scene, size, spi=2, seed=0, depth=None):
    """(JAX frame, the port's frame on the JAX tables)."""
    scene = copy.deepcopy(scene)
    if depth is not None:
        scene["technique"] = dict(scene["technique"], max_depth=depth)
    jrt = JRuntime(scene, width=size, height=size, seed=seed)
    jrt.step(spi=spi)
    rt = runtime_from_jax_tables(jrt.scene, jrt.tables, device="cpu",
                                 seed=seed)
    rt.step(spi=spi)
    return np.asarray(jrt.currentFrame()), rt.currentFrame()


def per_lane(ref, got):
    assert np.isfinite(got).all() and got.shape == ref.shape
    ok = np.isclose(got, ref, rtol=1e-4, atol=1e-4).all(axis=-1)
    assert ok.mean() >= 0.995, (~ok).sum()


@pytest.mark.parametrize("what", sorted(SCENES))
def test_volpath_scene_per_lane_depth2(what, tmp_path):
    ref, got = frames(SCENES[what](tmp_path), 16, depth=2)
    per_lane(ref, got)
    assert ref.mean() > 0



def test_surface_bounces_write_plus_zero_inv_pdf(tmp_path):
    """`inv_pdf` = -1 marks a vertex in a medium (read by its sign bit):
    every other value a bounce writes, +0.0 after a specular surface
    included, has a clear sign bit."""
    from ignis_tpu_torch.render import integrator as ti
    jrt = JRuntime(_glass_media(tmp_path), width=16, height=16)
    rt = runtime_from_jax_tables(jrt.scene, jrt.tables, device="cpu")
    n = 256
    idx = torch.arange(n)
    seed, counter, org, d, tmin, tmax = ti._emit_camera(
        rt.scene, idx % 16, idx // 16, 0, 0, 0, 0, rt.tables)
    st = ti._fresh_state(n, "cpu", org=org, dir=d, tmin=tmin, tmax=tmax,
                         alive=torch.ones(n, dtype=torch.bool), seed=seed,
                         counter=counter)
    medium_vertices = 0
    for _ in range(4):
        _, st, _ = ti._bounce_core(rt.scene, rt.tables, st, None, None)
        ip = st["inv_pdf"]
        medium_vertices += int((ip == -1.0).sum())
        assert not (torch.signbit(ip) & (ip != -1.0)).any()
    assert medium_vertices > 0
