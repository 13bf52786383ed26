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
from ignis_tpu_torch.scenes import (
    big_scene, daylight_scene, demo_scene, env_scene, measured_scene,
    media_scene, textured_scene,
)


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


def param_scene(_dir):
    from test_parameters import _param_scene
    return _param_scene()


def features_scene(d):
    """Every texture kind on the flat scene at once: textured slots of both
    lobes, a textured blend weight, normal-modifier kinds 1, 2 and 4 on
    three materials, and a textured uniform env."""
    import test_torch_textured_render as r
    s = copy.deepcopy(create_flat_scene())
    sky = r._sky(d)
    s["textures"] = [r.CHECKER, r.CLOUDS, sky]
    s["bsdfs"] = [
        {"type": "diffuse", "name": "a", "reflectance": "clouds"},
        {"type": "roughconductor", "name": "b", "roughness": 0.3,
         "specular_reflectance": "checker"},
        {"type": "blend", "name": "ground", "first": "a", "second": "b",
         "weight": "checker"},
        {"type": "normalmap", "name": "nm", "bsdf": "a", "map": "checker"},
        {"type": "bumpmap", "name": "bm", "bsdf": "a", "map": "clouds"},
        {"type": "transform", "name": "pn", "bsdf": "a",
         "normal": r.RELIEF},
    ]
    s["shapes"] += [
        {"type": "rectangle", "name": f"q{i}", "width": 0.5, "height": 0.5,
         "transform": {"translate": [0.6 * i - 0.6, 0, -0.3]}}
        for i in range(3)]
    s["entities"] += [{"name": f"q{i}", "shape": f"q{i}", "bsdf": m}
                      for i, m in enumerate(("nm", "bm", "pn"))]
    s["lights"] = [{"type": "env", "name": "sky", "radiance": "sky",
                    "cdf": False}]
    return s


def _flat_lit(lights, selector="uniform"):
    s = copy.deepcopy(create_flat_scene())
    s["technique"] = dict(s["technique"], light_selector=selector)
    s["lights"] = lights
    return s


_SPOTS = [{"type": "spot", "name": f"s{i}", "position": [0.4 * i - 0.6, 0.2,
                                                         -1.0 - 0.1 * i],
           "direction": [0, 0, 1], "power": [1 + i, 1, 1]} for i in range(4)]
_SUN = {"type": "sun", "name": "sun", "elevation": 0.5, "azimuth": 2.0}
_SKY = {"type": "sky", "name": "sky", "elevation": 0.5, "azimuth": 2.0}
# one case for each light type and each selector beyond the tables above
LIGHTS = {
    "light sun": lambda: _flat_lit([_SUN]),
    "light directional": lambda: _flat_lit([
        {"type": "directional", "name": "d", "direction": [0.1, 0.2, 1]}]),
    "light spot": lambda: _flat_lit(_SPOTS[:1]),
    "light sky": lambda: _flat_lit([_SKY]),
    "light cie": lambda: _flat_lit([
        {"type": "cie_cloudy", "name": "c", "has_ground": False},
        {"type": "cie_clear", "name": "k", "elevation": 0.4},
        {"type": "cie_intermediate", "name": "i", "azimuth": 1.0}]),
    "light perez": lambda: _flat_lit([
        {"type": "perez", "name": "p", "direct_irradiance": 500.0,
         "diffuse_irradiance": 120.0}]),
    "selector simple": lambda: _flat_lit(_SPOTS, "simple"),
    "selector cdf": lambda: _flat_lit(_SPOTS + [_SUN, _SKY], "cdf"),
    "selector hierarchy": lambda: _flat_lit(_SPOTS + [_SUN, _SKY],
                                            "hierarchy"),
}


def env_cdf_scene(d):
    """Textured environments with the default 2D CDF and with the SAT."""
    import test_torch_textured_render as r
    s = _flat_lit([{"type": "env", "name": "e", "radiance": "sky"},
                   {"type": "env", "name": "f", "radiance": "sky",
                    "cdf_method": "sat", "scale": 0.5}])
    s["textures"] = [r._sky(d)]
    return s


def halton_scene():
    s = copy.deepcopy(create_flat_scene())
    s["film"] = {"size": [8, 8], "sampler": "halton"}
    return s


SCENES = {"demo": demo_scene, "flat": create_flat_scene, "ico": ico_scene,
          "dof": dof_scene, "lights": lights_scene, "daylight": daylight_scene,
          "halton": halton_scene, **LIGHTS}
# scenes that write their images into a directory first
TEXTURED = {"textured": textured_scene, "parameters": param_scene,
            "features": features_scene, "light env cdf": env_cdf_scene,
            "env": env_scene}


def _media_test(kind):
    """tests/test_media.py's scenes: a constant voxel grid (scattering,
    emissive), ratio tracking, a NanoVDB cloud, the homogeneous twin."""
    def make(d):
        import test_media as tm
        from ignis_tpu_torch.medium.nanovdb import write_nvdb_grid
        if kind == "emissive":
            s = tm._hetero_scene(d, [3.0, 3.0, 3.0], [0, 0, 0],
                                 emission=(5.0, 5.0, 5.0))
            s["lights"] = []
            return s
        s = tm._hetero_scene(d, [0.4, 0.9, 1.4], [0.3, 0.2, 0.1], g=0.4)
        if kind == "ratio":
            s["media"][0]["method"] = "delta_tracking"
        elif kind == "homogeneous":
            s["media"] = [{"type": "homogeneous", "name": "Med",
                           "sigma_a": [0.4, 0.9, 1.4],
                           "sigma_s": [0.3, 0.2, 0.1], "g": 0.4}]
        elif kind == "nvdb":
            dense = np.random.default_rng(2).uniform(
                0, 1, (8, 6, 10)).astype(np.float32)
            write_nvdb_grid(str(d / "c.nvdb"), dense, "density")
            s["media"] = [{"type": "heterogeneous", "name": "Med",
                           "filename": str(d / "c.nvdb"),
                           "shader": "principled_volume",
                           "scalar_density": 2.0, "interpolate": True,
                           "method": "delta_tracking"}]
        return s
    return make


# scenes with participating media, written into a directory first: the
# reference's media tests and the port's `media_scene()` (its 128^3 cloud
# and 64^3 voxel grid)
MEDIA = {"media scene": media_scene,
         **{f"media {k}": _media_test(k) for k in (
             "grid", "emissive", "ratio", "homogeneous", "nvdb")}}
# measured materials, their files written into a directory first
MEASURED = {"measured scene": measured_scene}


def _scene(name, tmp_path):
    if name in TEXTURED:
        return TEXTURED[name](tmp_path)
    if name in MEDIA:
        return MEDIA[name](tmp_path)
    if name in MEASURED:
        return MEASURED[name](tmp_path)
    return SCENES[name]()


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


def _same_info(a, b):
    """Static per-material info dicts (lists, numpy arrays, numbers)."""
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].keys() == b[k].keys(), k
        for f in a[k]:
            np.testing.assert_array_equal(np.asarray(a[k][f]),
                                          np.asarray(b[k][f]), err_msg=f)


@pytest.mark.parametrize("name", sorted(SCENES) + sorted(TEXTURED)
                         + sorted(MEDIA) + sorted(MEASURED))
def test_compiled_tables_equal(name, tmp_path):
    a = j_compile(_scene(name, tmp_path), 32, 32)
    b = t_compile(_scene(name, tmp_path), 32, 32)
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
    assert a.lh_depth == b.lh_depth
    assert [getattr(l, "sky", None) for l in a.lights] == \
           [getattr(l, "sky", None) for l in b.lights]
    # the media records: type, method, shader, interpolation, reference
    # entity
    assert a.media == b.media
    for key in ("klems_info", "tensortree_info", "djmeasured_info"):
        _same_info(getattr(a, key), getattr(b, key))


def test_type_constants_keep_their_values():
    import ignis_tpu.scene.compile as jc
    import ignis_tpu_torch.scene.compile as tc
    for name in dir(jc):
        if name.startswith(("BSDF_", "LIGHT_")):
            assert getattr(jc, name) == getattr(tc, name), name


@pytest.mark.parametrize("name", ["demo", "flat", "ico", "halton"]
                         + sorted(TEXTURED)
                         + sorted(LIGHTS) + ["media scene", "measured scene"])
def test_runtime_tables_equal(name, tmp_path):
    """bw_tables / build_bvh / build_packet_bvh / pack_tri_shade as the two
    Runtimes build them; for the textured scenes also the image tables
    (`*_img`), `params`, `mat_tex*`, `mat_wrap_tex` and `mat_nmod_*`."""
    scene = _scene(name, tmp_path)
    jrt = JRuntime(scene, width=16, height=16)
    jt = {k: np.asarray(v) for k, v in jrt.tables.items()}
    trt = tapi.Runtime(scene, width=16, height=16, device="cpu")
    tt = tables_to_numpy(trt.tables)
    ntris = jt["tri_v0"].shape[0]
    if ntris < 4096:
        # beside the Baldwin-Weber rows the kernel's cluster tree, derived
        # from the reference's clusters alone
        assert set(tt) - {"bw_ctree"} == set(jt)
        assert "bw_tris" in tt and "pb_rows" not in tt
        from ignis_tpu_torch.ops.bw_intersect import build_bw_ctree
        np.testing.assert_array_equal(tt["bw_ctree"],
                                      build_bw_ctree(jt["bw_clusters"]))
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
    # the light tree's codes are uint32, and the halton offsets int32 in the
    # reference (without x64): the port carries both in int64
    _assert_tables_equal(jt, tt, keys=set(tt) - {"pb_nodes", "bw_ctree",
                                                 "lh_codes", "halton_offsets"})
    for k in ("lh_codes", "halton_offsets"):
        if k in tt:
            assert tt[k].dtype == np.int64
            np.testing.assert_array_equal(tt[k], jt[k])
    assert ("halton_offsets" in tt) == (name == "halton")
    if name in MEDIA:
        assert {"medium_data", "medium_shader", "medium_majorant",
                "ent_inner_medium", "ent_outer_medium", "vol2_density",
                "vol3_sigma_a"} <= set(tt)
        return
    if name in MEASURED:
        assert {"klems4_front_transmission_mat", "tt5_back_reflection_nodes",
                "dj6_vndf_cond"} <= set(tt)
        return
    if name in LIGHTS or name in ("light env cdf", "env"):
        assert trt.scene.lh_depth == jrt.scene.lh_depth
        assert ("lh_child" in tt) == (name == "selector hierarchy")
        return
    if name in TEXTURED:
        held = {k for k in tt if k.endswith("_img") or k == "params"
                or k.startswith(("mat_tex", "mat_wrap_tex", "mat_nmod_"))}
        assert {"params", "mat_tex", "mat_tex_b", "mat_wrap_tex",
                "mat_nmod_kind", "mat_nmod_f", "mat_nmod_tex"} <= held
        assert any(k.endswith("_img") for k in held) or name == "parameters"
        assert (tt["mat_tex"] >= 0).any()


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


def test_scene_from_metadata_carries_the_measured_info(tmp_path):
    """The measured materials' static info travels with the metadata, as a
    copy (the port adds derived facts to it)."""
    a = j_compile(measured_scene(tmp_path), 16, 16)
    b = scene_from_metadata(a)
    check_slice(b)
    for key in ("klems_info", "tensortree_info", "djmeasured_info"):
        _same_info(getattr(a, key), getattr(b, key))
        assert getattr(b, key) and getattr(b, key) is not getattr(a, key)


def test_scene_from_metadata_carries_the_light_state():
    """`lh_depth` (set on the compiled scene after construction) and each
    sky's parameters travel with the metadata: a hierarchy compiled by the
    JAX package descends as deep in the port."""
    a = j_compile(LIGHTS["selector hierarchy"](), 16, 16)
    b = scene_from_metadata(a)
    check_slice(b)
    assert a.lh_depth >= 3 and b.lh_depth == a.lh_depth
    assert [getattr(l, "sky", None) for l in b.lights] == \
           [getattr(l, "sky", None) for l in a.lights]
    assert scene_from_metadata(j_compile(demo_scene(), 16, 16)).lh_depth == 0


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


def _flat_material(*bsdfs):
    """The flat scene under a white sky, its ground shaded by the last of
    `bsdfs` (named "ground"); the others are what it refers to."""
    s = _flat_with(bsdfs=list(bsdfs[:-1]) + [dict(bsdfs[-1],
                                                  name="ground")])
    s["lights"] = [{"type": "env", "name": "e", "radiance": [1, 1, 1]}]
    return s


def _with_checker(s):
    s["textures"] = [{"type": "checkerboard", "name": "checker"}]
    return s


# what raised while the slice was narrower and is inside it now: held to
# compile, build its tables and render instead.  Each case's predicate
# (Runtime, index of the "ground" material) says what the compiled scene
# must hold.
# a point light between the camera and the flat scene's plane
_FLAT_POINT = [{"type": "point", "name": "p", "position": [0, 0, -0.5]}]

MOVED_INTO_SLICE = {
    # the light tracer and the photon mapper, at the flat scene's depth of
    # 2 (both run every one of `max_depth` bounces, 64 by default) and with
    # a small photon count
    "technique lighttracer": (lambda: _flat_with(
        technique={"type": "lighttracer", "max_depth": 2},
        lights=_FLAT_POINT),
        lambda rt, g: rt.scene.technique.type == "lighttracer"),
    "technique photonmapper": (lambda: _flat_with(
        technique={"type": "photonmapper", "max_depth": 2,
                   "photons": 10000}, lights=_FLAT_POINT),
        lambda rt, g: rt.scene.technique.photons == 10000),
    # the single-intersection techniques, the samplers and cameras beside
    # the perspective one, and the per-sample driver
    "technique ao": (lambda: _flat_with(technique={"type": "ao"}),
                     lambda rt, g: rt.scene.technique.type == "ao"
                     and not rt._wavefront_ok),
    "sampler halton": (lambda: _flat_with(
        film={"size": [8, 8], "sampler": "halton"}),
        lambda rt, g: tuple(rt.tables["halton_offsets"].shape) == (64,)
        and rt.scene.halton_setup["stride"] == 8 * 9),
    "sampler mjitt": (lambda: _flat_with(
        film={"size": [8, 8], "sampler": "mjitt"}),
        lambda rt, g: rt.scene.sampler == "mjitt"),
    "camera orthogonal": (lambda: _flat_with(
        camera=dict(create_flat_scene()["camera"], type="orthogonal")),
        lambda rt, g: rt.scene.camera.type == "orthogonal"),
    "camera != bounce visibility": (
        lambda: _flat_entity(camera_visible=False),
        lambda rt, g: int(rt.tables["ent_flags"][0]) == 0xE
        and not rt._wavefront_ok),
    # participating media and the volpath technique: the flat scene's
    # entity holds a medium (the ground material stays diffuse)
    "technique volpath": (lambda: _flat_with(technique={"type": "volpath"}),
                          lambda rt, g: rt.scene.technique.type == "volpath"),
    "media": (lambda: _flat_with(
        technique={"type": "volpath"},
        entities=[dict(create_flat_scene()["entities"][0],
                       inner_medium="fog")],
        media=[{"type": "homogeneous", "name": "fog",
                "sigma_s": [1, 1, 1]}]),
        lambda rt, g: rt.scene.media[0]["type"] == "homogeneous"
        and int(rt.tables["ent_inner_medium"][0]) == 0),
    "analytic sphere": (lambda: dict(
        _flat_with(), shapes=[{"type": "sphere", "name": "Bottom"}]),
        lambda rt, g: "sph_rows" in rt.tables),
    "instancing": (lambda: _flat_plus("entities", {
        "name": "Second", "shape": "Bottom", "bsdf": "ground",
        "transform": {"translate": [0, 0, 1]}}),
        lambda rt, g: "tl_inst" in rt.tables),
    "bsdf principled": (lambda: _flat_material({"type": "principled"}),
                        lambda rt, g: rt.scene.bsdf_types[g] == 5),
    "bsdf roughconductor": (lambda: _flat_material(
        {"type": "conductor", "roughness": 0.3}),
        lambda rt, g: rt.scene.bsdf_types[g] == 11),
    "bsdf plastic": (lambda: _flat_material({"type": "plastic"}),
                     lambda rt, g: rt.scene.bsdf_types[g] == 4),
    "bsdf phong": (lambda: _flat_material({"type": "phong"}),
                   lambda rt, g: rt.scene.bsdf_types[g] == 3),
    "bsdf blend": (lambda: _flat_material(
        {"type": "diffuse", "name": "a"},
        {"type": "conductor", "name": "b", "roughness": 0.2},
        {"type": "blend", "first": "a", "second": "b", "weight": 0.5}),
        lambda rt, g: rt.scene.bsdf_types_b[g] == 11),
    "bsdf normalmap": (lambda: _flat_material(
        {"type": "diffuse", "name": "a"},
        {"type": "transform", "bsdf": "a", "normal": [0, 0.3, -1]}),
        lambda rt, g: rt.scene.nmod_kinds[g] == 3),
    # the six texture cases: the scenes that named a texture ("checker")
    # they did not define now define it, so that they render
    "bsdf texture color": (lambda: _with_checker(_flat_material(
        {"type": "diffuse", "reflectance": "checker"})),
        lambda rt, g: rt.scene.tables["mat_tex"][g, 0] == 0),
    "bsdf pexpr number": (lambda: _flat_material(
        {"type": "dielectric", "int_ior": "1.2 + 0.3"}),
        lambda rt, g: rt.scene.tables["mat_scalars"][g, 2]
        == np.float32(1.2) + np.float32(0.3)),
    "bsdf blend textured weight": (lambda: _with_checker(_flat_material(
        {"type": "diffuse", "name": "a"},
        {"type": "blend", "first": "a", "second": "a",
         "weight": "checker"})),
        lambda rt, g: rt.scene.tables["mat_wrap_tex"][g] == 0),
    "bsdf normalmap texture": (lambda: _with_checker(_flat_material(
        {"type": "diffuse", "name": "a"},
        {"type": "normalmap", "bsdf": "a", "map": "checker"})),
        lambda rt, g: rt.scene.nmod_kinds[g] == 1
        and rt.scene.tables["mat_nmod_tex"][g] == 0),
    "bsdf transform pexpr normal": (lambda: _flat_material(
        {"type": "diffuse", "name": "a"},
        {"type": "transform", "bsdf": "a", "normal": "vec3(0, 0.3, -1)"}),
        lambda rt, g: rt.scene.nmod_kinds[g] == 4),
    "textures": (lambda: _with_checker(_flat_material(
        {"type": "diffuse"})),
        lambda rt, g: [t["name"] for t in rt.scene.textures] == ["checker"]),
    # the light breadth.  The scenes light the plane: the spot, the
    # directional light and the sun now point at it, the selector case has
    # lights to select from, the Perez sky has a clear sky's coefficients
    # (the all-ones defaults overflow exp() in both packages) and the env
    # texture case defines the texture it names (an undefined name is a
    # PExpr with an unknown variable, which raises PExprError in both
    # packages: test_env_texture_of_undefined_name_raises)
    "light selector": (lambda: _flat_with(
        technique={"type": "path", "light_selector": "simple"},
        lights=[{"type": "point", "name": "a", "position": [0.3, 0, -1]},
                {"type": "point", "name": "b", "position": [-0.3, 0, -1],
                 "intensity": [3, 3, 3]},
                {"type": "env", "name": "e", "radiance": [0.5, 0.5, 0.5]}]),
        lambda rt, g: rt.scene.technique.light_selector == "simple"
        and rt.tables["light_sel_cdf"].shape[0] == 2
        and float(rt.tables["light_sel_pdf"][2]) == 0.5),
    "light spot": (lambda: _flat_with(lights=[
        {"type": "spot", "name": "l", "position": [0, 0, -1],
         "direction": [0, 0, 1]}]),
        lambda rt, g: int(rt.tables["light_type"][0]) == 6),
    "light directional": (lambda: _flat_with(lights=[
        {"type": "directional", "name": "l", "direction": [0, 0, 1]}]),
        lambda rt, g: int(rt.tables["light_type"][0]) == 5),
    "light sun": (lambda: _flat_with(lights=[
        {"type": "sun", "name": "l", "direction": [0.2, 0.1, 1]}]),
        lambda rt, g: int(rt.tables["light_type"][0]) == 7),
    "light sky": (lambda: _flat_with(lights=[{"type": "sky", "name": "l"}]),
                  lambda rt, g: int(rt.tables["light_type"][0]) == 4
                  and tuple(rt.tables["light0_sky_img"].shape)
                  == (256, 512, 3)),
    "light perez": (lambda: _flat_with(lights=[
        {"type": "perez", "name": "l", "clearness": 3.0,
         "brightness": 0.3}]),
        lambda rt, g: rt.scene.lights[0].sky["kind"] == "perez"),
    "light cie": (lambda: _flat_with(lights=[
        {"type": "cie_uniform", "name": "l"}]),
        lambda rt, g: rt.scene.lights[0].sky["kind"] == "cie_uniform"),
    "light env texture": (lambda: _with_checker(_flat_with(lights=[
        {"type": "env", "name": "l", "radiance": "checker"}])),
        lambda rt, g: int(rt.tables["light_type"][0]) == 4
        and tuple(rt.tables["light0_cdf_c"].shape) == (512, 1024)),
}


@pytest.mark.parametrize("what", sorted(MOVED_INTO_SLICE))
def test_moved_into_slice_scene_renders(what):
    scene_fn, holds = MOVED_INTO_SLICE[what]
    scene = scene_fn()
    rt = tapi.Runtime(scene, device="cpu")
    assert holds(rt, rt.scene.material_names.index("ground"))
    rt.step()
    img = rt.currentFrame()
    assert np.isfinite(img).all()
    if scene.get("lights"):
        assert img.mean() > 0


def test_env_texture_of_undefined_name_raises():
    """An env radiance naming no texture is a PExpr whose variable is
    unknown: its CDF bake raises PExprError, as in the JAX package."""
    from ignis_tpu.texture.pexpr import PExprError as JPExprError
    from ignis_tpu_torch.texture.pexpr import PExprError
    scene = _flat_with(lights=[{"type": "env", "name": "l",
                                "radiance": "sky.exr"}])
    with pytest.raises(JPExprError, match="sky"):
        j_compile(copy.deepcopy(scene))
    with pytest.raises(PExprError, match="sky"):
        tapi.Runtime(scene, device="cpu")


def test_shadow_only_flags_stay_in_the_slice():
    # shadow_visible may differ from camera/bounce: the wavefront handles it
    tapi.Runtime(_flat_entity(shadow_visible=False), device="cpu")


def test_gltf_and_exr_raise():
    """An empty glTF file loads as in the JAX package (a scene with only
    the default environment); an EXR image the readers cannot decode (it
    says PIZ but holds ZIPS blocks) raises the JAX package's ValueError."""
    from ignis_tpu.scene.parser import load_scene_file as j_load_scene_file
    from ignis_tpu_torch.scene.parser import load_scene_file
    from ignis_tpu_torch.texture.loader import load_image_rgb
    from test_torch_textures import _zips_exr
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "a.gltf")
        open(p, "w").write("{}")
        got, want = load_scene_file(p), j_load_scene_file(p)
        assert vars(got) == vars(want)
        assert list(got.lights) == ["__env"]
        p = os.path.join(d, "a.exr")
        _zips_exr(p, np.zeros((2, 2, 3), np.float32), comp=4)
        from ignis_tpu.texture.loader import load_image_rgb as j_load
        with pytest.raises(ValueError) as want:
            j_load(p)
        with pytest.raises(ValueError, match="Unsupported EXR compression") \
                as got:
            load_image_rgb(p)
        assert str(got.value) == str(want.value)
