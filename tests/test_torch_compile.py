"""The port's host layer against the JAX package's: scene compiler,
the acceleration tables and the numpy <-> tensor conversion.

Everything here is numpy on the host and must be EQUAL (tolerance 0): both
packages have to start from identical tables for the per-lane comparisons of
the other test files to mean anything.
"""

import copy

import numpy as np
import pytest
import torch

from conftest import create_flat_scene
from ignis_tpu.api import Runtime as JRuntime
from ignis_tpu.scene.compile import load_and_compile as j_compile
from ignis_tpu_torch import api as tapi
from ignis_tpu_torch.convert import (
    scene_from_metadata, tables_from_numpy, tables_to_numpy,
)
from ignis_tpu_torch.scene.compile import check_slice
from ignis_tpu_torch.scene.compile import load_and_compile as t_compile
from ignis_tpu_torch.scenes import big_scene, demo_scene


def _graft_demo():
    import __graft_entry__
    return __graft_entry__._demo_scene()


def ico_scene():
    """5120-triangle icosphere over a floor: takes the packet-BVH path."""
    return big_scene(n_spheres=1, subdiv=4)


def dof_scene():
    s = demo_scene()
    s["camera"] = dict(s["camera"], aperture_radius=0.05, focal_length=3.0)
    return s


def lights_scene():
    """Point + mesh-area + plane-area + constant env lights."""
    s = demo_scene()
    s["lights"] = [
        {"type": "point", "name": "pt", "position": [0.3, 0.5, 0.2],
         "intensity": [2, 1.5, 1]},
        {"type": "area", "name": "ball_light", "entity": "ball",
         "radiance": [3, 3, 2]},
        {"type": "area", "name": "light", "entity": "light",
         "radiance": [20, 20, 20]},
        {"type": "env", "name": "env", "radiance": [0.1, 0.1, 0.15]},
    ]
    return s


SCENES = {"demo": demo_scene, "flat": create_flat_scene, "ico": ico_scene,
          "dof": dof_scene, "lights": lights_scene}


def _assert_tables_equal(a, b, keys=None):
    for k in (keys if keys is not None else a.keys()):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        # 0-d entries (sizes) travel as Python ints in the port
        assert x.shape == y.shape and (x.dtype == y.dtype or x.ndim == 0), \
            (k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_scene_copies_equal_the_originals():
    import _big_bench
    assert demo_scene() == _graft_demo()
    assert big_scene() == _big_bench.make_scene()
    assert big_scene(2, 3) == _big_bench.make_scene(2, 3)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_compiled_tables_equal(name):
    a, b = j_compile(SCENES[name](), 32, 32), t_compile(SCENES[name](), 32, 32)
    check_slice(b)
    assert a.tables.keys() == b.tables.keys()
    _assert_tables_equal(a.tables, b.tables)
    assert a.bsdf_types == b.bsdf_types
    assert a.bsdf_types_b == b.bsdf_types_b and a.nmod_kinds == b.nmod_kinds
    assert [(l.type, l.name, l.infinite, l.delta, l.entity, l.tri_offset,
             l.tri_count, l.tex) for l in a.lights] == \
           [(l.type, l.name, l.infinite, l.delta, l.entity, l.tri_offset,
             l.tri_count, l.tex) for l in b.lights]
    assert a.param_registry == b.param_registry
    assert (a.width, a.height, a.sampler) == (b.width, b.height, b.sampler)
    for f in ("eye", "dir", "up", "scale"):
        np.testing.assert_array_equal(getattr(a.camera, f),
                                      getattr(b.camera, f))
    assert (a.camera.type, a.camera.tmin, a.camera.tmax,
            a.camera.aperture_radius, a.camera.focal_length) == \
           (b.camera.type, b.camera.tmin, b.camera.tmax,
            b.camera.aperture_radius, b.camera.focal_length)
    assert vars(a.technique) == vars(b.technique)
    assert a.scene_radius() == b.scene_radius()
    np.testing.assert_array_equal(a.bbox_min, b.bbox_min)


def test_type_constants_keep_their_values():
    import ignis_tpu.scene.compile as jc
    import ignis_tpu_torch.scene.compile as tc
    for name in dir(jc):
        if name.startswith(("BSDF_", "LIGHT_")):
            assert getattr(jc, name) == getattr(tc, name), name


@pytest.mark.parametrize("name", ["demo", "flat", "ico"])
def test_runtime_tables_equal(name):
    """bw_tables / build_bvh / build_packet_bvh / pack_tri_shade as the two
    Runtimes build them."""
    scene = SCENES[name]()
    jrt = JRuntime(scene, width=16, height=16)
    jt = {k: np.asarray(v) for k, v in jrt.tables.items()}
    trt = tapi.Runtime(scene, width=16, height=16, device="cpu")
    tt = tables_to_numpy(trt.tables)
    ntris = jt["tri_v0"].shape[0]
    if ntris < 4096:
        assert jt.keys() == tt.keys()
        assert "bw_tris" in tt and "pb_rows" not in tt
    else:
        # the reference also keeps Baldwin-Weber tables up to 16384
        # triangles; the port builds one kind only, and beside the packet
        # rows the kernel's copy of them, derived from the rows alone
        assert set(tt) - {"pb_nodes"} <= set(jt)
        assert "pb_rows" in tt and "bw_tris" not in tt
        from ignis_tpu_torch.ops.packet_bvh import build_pb_nodes
        np.testing.assert_array_equal(
            tt["pb_nodes"].view(np.int32),
            build_pb_nodes(jt["pb_rows"]).view(np.int32))
    assert "tri_shade" in tt
    _assert_tables_equal(jt, tt, keys=set(tt) - {"pb_nodes"})


def test_pack_tri_shade_equal():
    cs = t_compile(demo_scene(), 16, 16)
    np.testing.assert_array_equal(JRuntime._pack_tri_shade(cs.tables),
                                  tapi.pack_tri_shade(cs.tables))


def test_tables_from_numpy_round_trip():
    jrt = JRuntime(demo_scene(), width=16, height=16)
    src = {k: np.asarray(v) for k, v in jrt.tables.items()}
    src["u32_seed"] = np.array([0, 1, 0xFFFFFFFF], np.uint32)
    t = tables_from_numpy(src, "cpu")
    assert t["u32_seed"].dtype == torch.int64
    assert t["u32_seed"].tolist() == [0, 1, 0xFFFFFFFF]
    assert isinstance(t["bw_ntris"], int)
    assert t["tri_v0"].dtype == torch.float32
    assert t["tri_ent"].dtype == torch.int32
    assert t["light_infinite"].dtype == torch.bool
    back = tables_to_numpy(t)
    for k, v in src.items():
        if k == "u32_seed":
            continue
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype or v.ndim == 0, k


def test_scene_from_metadata_copies_what_the_integrator_reads():
    a = j_compile(lights_scene(), 24, 16)
    b = scene_from_metadata(a)
    check_slice(b)
    assert type(b).__module__.startswith("ignis_tpu_torch")
    assert type(b.camera).__module__.startswith("ignis_tpu_torch")
    assert (b.width, b.height, b.num_lights) == (24, 16, 4)
    assert b.bsdf_types == a.bsdf_types
    assert [l.type for l in b.lights] == [l.type for l in a.lights]
    assert b.param_registry == a.param_registry
    assert b.scene_radius() == a.scene_radius()
    assert vars(b.technique) == vars(a.technique)


def _flat_with(**over):
    s = copy.deepcopy(create_flat_scene())
    s["film"] = {"size": [8, 8]}
    for k, v in over.items():
        s[k] = v
    return s


def _flat_plus(section, item):
    s = _flat_with()
    s[section] = list(s[section]) + [item]
    return s


def _flat_entity(**props):
    s = _flat_with()
    s["entities"] = [dict(s["entities"][0], **props)]
    return s


def _flat_bsdf(bsdf):
    s = _flat_with()
    s["bsdfs"] = [dict(bsdf, name="ground")]
    return s


OUT_OF_SLICE = {
    "technique ao": lambda: _flat_with(technique={"type": "ao"}),
    "technique volpath": lambda: _flat_with(technique={"type": "volpath"}),
    "light selector": lambda: _flat_with(
        technique={"type": "path", "light_selector": "simple"}),
    "sampler halton": lambda: _flat_with(
        film={"size": [8, 8], "sampler": "halton"}),
    "sampler mjitt": lambda: _flat_with(
        film={"size": [8, 8], "sampler": "mjitt"}),
    "camera orthogonal": lambda: _flat_with(
        camera=dict(create_flat_scene()["camera"], type="orthogonal")),
    "bsdf principled": lambda: _flat_bsdf({"type": "principled"}),
    "bsdf roughconductor": lambda: _flat_bsdf(
        {"type": "conductor", "roughness": 0.3}),
    "bsdf plastic": lambda: _flat_bsdf({"type": "plastic"}),
    "bsdf phong": lambda: _flat_bsdf({"type": "phong"}),
    "bsdf texture color": lambda: _flat_bsdf(
        {"type": "diffuse", "reflectance": "checker"}),
    "bsdf pexpr number": lambda: _flat_bsdf(
        {"type": "dielectric", "int_ior": "1.2 + 0.3"}),
    "bsdf blend": lambda: _flat_plus("bsdfs", {
        "type": "blend", "name": "mixed", "first": "ground",
        "second": "ground", "weight": 0.5}),
    "bsdf normalmap": lambda: _flat_plus("bsdfs", {
        "type": "transform", "name": "nm", "bsdf": "ground",
        "normal": [0, 1, 0]}),
    "textures": lambda: _flat_with(textures=[
        {"type": "checkerboard", "name": "checker"}]),
    "media": lambda: _flat_with(media=[
        {"type": "homogeneous", "name": "fog", "sigma_s": [1, 1, 1]}]),
    "light spot": lambda: _flat_with(lights=[
        {"type": "spot", "name": "l", "position": [0, 0, 1]}]),
    "light directional": lambda: _flat_with(lights=[
        {"type": "directional", "name": "l", "direction": [0, 0, -1]}]),
    "light sun": lambda: _flat_with(lights=[{"type": "sun", "name": "l"}]),
    "light sky": lambda: _flat_with(lights=[{"type": "sky", "name": "l"}]),
    "light perez": lambda: _flat_with(lights=[{"type": "perez", "name": "l"}]),
    "light cie": lambda: _flat_with(lights=[
        {"type": "cie_uniform", "name": "l"}]),
    "light env texture": lambda: _flat_with(lights=[
        {"type": "env", "name": "l", "radiance": "sky.exr"}]),
    "camera != bounce visibility": lambda: _flat_entity(camera_visible=False),
}

# what raised while the slice was narrower and is inside it now: held to
# compile, build its tables and render instead
MOVED_INTO_SLICE = {
    "analytic sphere": lambda: dict(
        _flat_with(), shapes=[{"type": "sphere", "name": "Bottom"}]),
    "instancing": lambda: _flat_plus("entities", {
        "name": "Second", "shape": "Bottom", "bsdf": "ground",
        "transform": {"translate": [0, 0, 1]}}),
}


@pytest.mark.parametrize("what", sorted(OUT_OF_SLICE))
def test_out_of_slice_scene_raises(what):
    scene = OUT_OF_SLICE[what]()
    with pytest.raises(NotImplementedError, match="not ported"):
        tapi.Runtime(scene, device="cpu")


@pytest.mark.parametrize("what", sorted(MOVED_INTO_SLICE))
def test_moved_into_slice_scene_renders(what):
    rt = tapi.Runtime(MOVED_INTO_SLICE[what](), device="cpu")
    assert ("sph_rows" if what == "analytic sphere" else "tl_inst") \
        in rt.tables
    rt.step()
    assert np.isfinite(rt.currentFrame()).all()


def test_shadow_only_flags_stay_in_the_slice():
    # shadow_visible may differ from camera/bounce: the wavefront handles it
    tapi.Runtime(_flat_entity(shadow_visible=False), device="cpu")


def test_gltf_and_exr_raise():
    from ignis_tpu_torch.scene.parser import load_scene_file
    from ignis_tpu_torch.texture.loader import load_image_rgb
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "a.gltf")
        open(p, "w").write("{}")
        with pytest.raises(NotImplementedError):
            load_scene_file(p)
        with pytest.raises(NotImplementedError):
            load_image_rgb(os.path.join(d, "a.exr"))
