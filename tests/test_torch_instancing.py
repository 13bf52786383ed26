"""Instanced and analytic-sphere scenes through the port as a whole, against
the JAX package: `_surface_at`'s pooled and sphere branches, `trace_wave` and
`Runtime.step`.

How the two sides are put on the same footing: on the CPU the JAX integrator
runs Moeller-Trumbore for the soup and `tlas_traverse_xla` for the pool.  The
per-lane comparisons give the port the JAX Runtime's own tables with the
`bw_*` rows taken out, so its soup goes through Moeller-Trumbore too; the pool
goes through the plain version of the port's kernel, the spheres through
`ops/spheres.py`.

Tolerances (those of tests/test_torch_path.py): `_surface_at` per lane to
1e-5; radiance per lane to 1e-4 at depth <= 2 with at most 1 % of the lanes
allowed to take another, equally valid path (a last-ulp difference that flips
an edge hit, a Fresnel or a russian-roulette decision); image means to 1 % at
full depth, 2 % where the two sides also differ in the soup's hit predicate.
Instanced against baked inside the port: rtol = atol = 2e-3 per pixel, as
tests/test_instancing.py holds the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.api import Runtime as JRuntime
from ignis_tpu.render.integrator import _surface_at as j_surface_at
from ignis_tpu.render.integrator import trace_wave as j_trace_wave
from ignis_tpu_torch.api import Runtime, build_accel_tables
from ignis_tpu_torch.convert import (
    runtime_from_jax_tables, scene_from_metadata, tables_from_numpy,
)
from ignis_tpu_torch.render import integrator
from ignis_tpu_torch.render.integrator import trace_wave
from ignis_tpu_torch.scene.compile import (
    LIGHT_AREA_SPHERE, check_slice, load_and_compile,
)
from ignis_tpu_torch.scenes import instanced_scene
from test_instancing import _scene
from test_torch_spheres import sphere_scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops on these small inputs run faster on one intra-op
    thread, and the test workers sharing the CPU then do not oversubscribe
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32 = np.float32
MIXED = ["red", "gold", "white"]


def _with_depth(scene, depth):
    return dict(scene, technique=dict(scene["technique"], max_depth=depth))


def _np_tables(jrt, drop=()):
    return {k: np.asarray(v) for k, v in jrt.tables.items()
            if not k.startswith(tuple(drop))}


def _lanes_close(got, ref, tol=1e-4):
    return np.isclose(got, ref, rtol=tol, atol=tol).all(axis=-1)


# ------------------------------------------------------------ _surface_at
@pytest.fixture(scope="module")
def mixed_runtime():
    """Soup (floor, lamp), a pool of 9 instances and 4 spheres."""
    return JRuntime(instanced_scene(3, 1), width=16, height=16)


def _surface_inputs(tab, n, seed, kinds):
    rng = np.random.default_rng(seed)
    base = tab["tri_v0"].shape[0]
    pool, ninst = tab["tl_tris"].shape[0], tab["tl_inst"].shape[0]
    # real pool rows only: a shape's padding rows are never hit
    real = np.flatnonzero(tab["tl_tris"][:, 12] > 0)
    choice = {
        "soup": rng.integers(0, base, n),
        "pool": base + rng.integers(0, ninst, n) * pool + rng.choice(real, n),
        "sphere": base + ninst * pool
        + rng.integers(0, tab["sph_rows"].shape[0], n),
    }
    which = rng.integers(0, len(kinds), n)
    prim = np.select([which == i for i in range(len(kinds))],
                     [choice[k] for k in kinds]).astype(np.int32)
    u = rng.uniform(0, 1, n).astype(F32)
    v = (rng.uniform(0, 1, n) * (1 - u)).astype(F32)
    org = rng.uniform(-3, 3, (n, 3)).astype(F32)
    d = rng.normal(size=(n, 3)).astype(F32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(0.5, 6, n).astype(F32)
    return prim, org, d, t, u, v


@pytest.mark.parametrize("kinds", [("pool",), ("sphere",),
                                   ("soup", "pool", "sphere")])
def test_surface_at_per_lane(mixed_runtime, kinds):
    tab = _np_tables(mixed_runtime)
    args = _surface_inputs(tab, 512, len(kinds), kinds)
    ref = j_surface_at(mixed_runtime.tables, *(jnp.asarray(a) for a in args))
    got = integrator._surface_at(tables_from_numpy(tab, "cpu"),
                                 *(torch.from_numpy(a) for a in args))
    assert ref.keys() == got.keys()
    for k in ref:
        g, r = got[k].numpy(), np.asarray(ref[k])
        if g.dtype.kind in "bi":
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5, err_msg=k)
    if kinds == ("pool",):
        assert (got["light_id"] == -1).all()
        ents = set(got["ent"].tolist())
        assert len(ents) == 9 and min(ents) >= 2
        assert len(set(got["mat_id"].tolist())) == 3
    if kinds == ("sphere",):
        assert (got["light_id"] >= 0).any() and (got["light_id"] < 0).any()
        np.testing.assert_allclose(got["tex"].numpy(),
                                   np.stack([args[4], args[5]], -1))


def _no_soup_scene():
    """Two instances of one mesh and an analytic sphere: nothing is baked, so
    the compiled soup is the compiler's one degenerate triangle."""
    s = _scene(True, n=2, ball_bsdf=["red", "gold"])
    s["shapes"] = s["shapes"][1:] + [
        {"type": "sphere", "name": "orb", "radius": 0.4}]
    s["entities"] = s["entities"][1:] + [
        {"name": "orb", "shape": "orb", "bsdf": "white",
         "transform": [{"translate": [0, 0.9, 0]}]}]
    return s


def _strip_soup(tables):
    """The same tables with a soup of ZERO triangles (base = 0): what a
    caller of `Runtime.from_compiled` may hand over."""
    out = {k: v for k, v in tables.items()
           if not k.startswith(("bw_", "tri_shade"))}
    for k in out:
        if k.startswith("tri_"):
            out[k] = out[k][:0]
    return out


def test_surface_at_without_a_soup():
    """Every entity instanced: the pooled decode with base 0 (no soup, no
    `tri_shade`) equals the decode beside the degenerate one-triangle soup."""
    cs = load_and_compile(_no_soup_scene(), 16, 16)
    check_slice(cs)
    tab = build_accel_tables(cs.tables, instanced=cs.instanced)
    assert tab["tri_v0"].shape[0] == 1 and tab["tl_inst"].shape[0] == 2
    bare = _strip_soup(tab)
    assert bare["tri_v0"].shape[0] == 0 and "tri_shade" not in bare
    pool = tab["tl_tris"].shape[0]
    rng = np.random.default_rng(3)
    enc = rng.integers(0, 2, 256) * pool + rng.integers(0, 320, 256)
    enc[::5] = 2 * pool                     # the sphere
    _, org, d, t, u, v = _surface_inputs(tab, 256, 4, ("pool",))
    a = integrator._surface_at(
        tables_from_numpy(bare, "cpu"), torch.from_numpy(enc),
        *(torch.from_numpy(x) for x in (org, d, t, u, v)))
    b = integrator._surface_at(
        tables_from_numpy(tab, "cpu"), torch.from_numpy(enc + 1),
        *(torch.from_numpy(x) for x in (org, d, t, u, v)))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert set(a["ent"].tolist()) == {0, 1, 2}


# ------------------------------------------------------------- trace_wave
def _both_trace(scene, w=32, h=32, sample=0, iteration=0, seed=0):
    """trace_wave over every pixel through both packages on the JAX
    Runtime's tables (the port without the `bw_*` rows)."""
    jrt = JRuntime(scene, width=w, height=h)
    idx = np.arange(w * h, dtype=np.int32)
    x, y = idx % w, idx // w
    ref = np.asarray(j_trace_wave(
        jrt.scene, jrt.tables, jnp.asarray(x), jnp.asarray(y),
        jnp.uint32(sample), jnp.uint32(iteration), jnp.uint32(0), seed))
    ts = scene_from_metadata(jrt.scene)
    check_slice(ts)
    got = trace_wave(ts, tables_from_numpy(_np_tables(jrt, drop=("bw_",)),
                                           "cpu"),
                     torch.from_numpy(x), torch.from_numpy(y), sample,
                     iteration, 0, seed).numpy()
    return ref, got


PER_LANE = {
    "three instances": lambda: _scene(True, n=3, ball_bsdf=MIXED),
    "spheres": sphere_scene,
    "pool + spheres + lights": lambda: instanced_scene(3, 1),
}


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("name", sorted(PER_LANE))
def test_trace_wave_per_lane(name, depth):
    ref, got = _both_trace(_with_depth(PER_LANE[name](), depth))
    assert np.isfinite(got).all() and got.shape == ref.shape
    ok = _lanes_close(got, ref)
    assert ok.mean() >= 0.99, (name, (~ok).sum())
    assert ref.mean() > 0
    assert abs(got.mean() - ref.mean()) <= 5e-3 * ref.mean()


@pytest.mark.parametrize("name", sorted(PER_LANE))
def test_trace_wave_full_depth_by_mean(name):
    ref, got = _both_trace(PER_LANE[name](), sample=1, iteration=2, seed=5)
    assert np.isfinite(got).all()
    assert abs(got.mean() - ref.mean()) <= 1e-2 * ref.mean()
    assert _lanes_close(got, ref, 1e-3).mean() >= 0.97


# ------------------------------------------------------------ Runtime.step
@pytest.fixture(scope="module")
def step_frames():
    """Runtime.step at 48x48, spi 2, of the instanced scene with three
    materials: the JAX Runtime, the port on its own compile, and the port on
    the baked twin of the scene."""
    scene = _scene(True, n=3, ball_bsdf=MIXED)
    jrt = JRuntime(scene, seed=3)
    jrt.step(spi=2)
    trt = Runtime(scene, seed=3, device="cpu")
    trt.step(spi=2)
    baked = Runtime(_scene(False, n=3, ball_bsdf=MIXED), seed=3, device="cpu")
    baked.step(spi=2)
    return jrt, trt, baked


def test_runtime_step_instanced_matches_jax(step_frames):
    """The port's soup goes through its Baldwin-Weber sweep here and the JAX
    package's through Moeller-Trumbore, so floor-edge hits may differ."""
    jrt, trt, _ = step_frames
    assert trt.scene.instanced and trt.tables["tl_inst"].shape[0] == 3
    for k in ("tl_tris", "tl_clust", "tl_shade", "tl_inst", "tl_norm",
              "tl_top"):
        np.testing.assert_array_equal(trt.tables[k].numpy(),
                                      np.asarray(jrt.tables[k]), err_msg=k)
    ref, got = jrt.currentFrame(), trt.currentFrame()
    assert got.shape == (48, 48, 3) and np.isfinite(got).all()
    assert _lanes_close(got.reshape(-1, 3), ref.reshape(-1, 3)).mean() >= 0.98
    assert abs(got.mean() - ref.mean()) <= 2e-2 * ref.mean()
    jrt.dumpStats()
    trt.dumpStats()
    for key in ("WaveIterations", "CameraRayCount(device)"):
        assert trt.stats.quantities[key] == jrt.stats.quantities[key], key
    assert "build_tlas" in trt.stats.sections


def test_instanced_render_matches_baked_in_the_port(step_frames):
    _, trt, baked = step_frames
    assert baked.scene.instanced is None and "tl_inst" not in baked.tables
    soup_i = trt.tables["tri_v0"].shape[0]
    soup_b = baked.tables["tri_v0"].shape[0]
    assert trt.tables["tl_tris"].shape[0] < 2 * (soup_b - soup_i) // 3
    a, b = trt.currentFrame(), baked.currentFrame()
    np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3)
    # the three materials are told apart: gold is not red is not white
    assert len(set(trt.tables["ent_mat"][trt.tables["tl_inst"][:, 22].long()]
                   .tolist())) == 3


def test_runtime_from_jax_tables_carries_pool_and_spheres():
    """The JAX Runtime's own `tl_*` and `sph_rows` tables through the port:
    the same frame as the port's own compile, bit for bit."""
    scene = instanced_scene(3, 1)
    jrt = JRuntime(scene, width=24, height=24)
    rt = runtime_from_jax_tables(jrt.scene, _np_tables(jrt), device="cpu",
                                 seed=1)
    for k, dt in (("tl_top", torch.float32), ("tl_inst", torch.float32),
                  ("tl_norm", torch.float32), ("tl_shade", torch.float32),
                  ("sph_rows", torch.float32), ("bw_tris", torch.float32)):
        assert rt.tables[k].dtype == dt, k
    # the reference's tables carry no depth: the Runtime derives it once
    assert "tl_depth" not in _np_tables(jrt) and rt.scene.instanced
    assert rt.tables["tl_depth"] == 2
    own = Runtime(scene, width=24, height=24, device="cpu", seed=1)
    assert own.tables["tl_depth"] == 2
    # and the kernel's cluster tree, derived from the pool's own tables
    assert "tl_ctree" not in _np_tables(jrt)
    assert torch.equal(rt.tables["tl_ctree"], own.tables["tl_ctree"])
    rt.step(spi=1)
    own.step(spi=1)
    np.testing.assert_array_equal(rt.currentFrame(), own.currentFrame())


def test_scene_without_a_soup_renders():
    """Nothing baked.  The compiler's degenerate one-triangle soup against the
    JAX Runtime, and tables with NO soup at all (base = 0) through
    `Runtime.from_compiled` against that: the same frame."""
    scene = _no_soup_scene()
    one = Runtime(scene, width=32, height=32, device="cpu")
    assert one.tables["tri_v0"].shape[0] == 1
    one.step(spi=2)
    img = one.currentFrame()
    assert np.isfinite(img).all() and img.mean() > 0
    jrt = JRuntime(scene, width=32, height=32)
    jrt.step(spi=2)
    ref = jrt.currentFrame()
    assert _lanes_close(img.reshape(-1, 3), ref.reshape(-1, 3)).mean() >= 0.98
    assert abs(img.mean() - ref.mean()) <= 1e-2 * ref.mean()
    cs = load_and_compile(scene, 32, 32)
    bare = Runtime.from_compiled(cs, _strip_soup(build_accel_tables(
        cs.tables, instanced=cs.instanced)), device="cpu")
    assert bare.tables["tri_v0"].shape[0] == 0
    bare.step(spi=2)
    np.testing.assert_array_equal(bare.currentFrame(), img)
    rays = [((0, 0.9, -4), (0, 0, 1)), ((-0.8, 0, -4), (0, 0, 1)),
            ((0, 5, -4), (0, 1, 0))]
    np.testing.assert_array_equal(bare.trace(rays, spp=2),
                                  one.trace(rays, spp=2))


def test_instanced_scene_is_what_it_says():
    """The headline scene at full size: 1024 instances of one 1280-triangle
    mesh, four analytic spheres, one of them a light; compiled, not
    rendered."""
    cs = load_and_compile(instanced_scene(), 64, 64)
    check_slice(cs)
    assert len(cs.instanced["shapes"]) == 1
    assert len(cs.instanced["records"]) == 1024
    assert cs.instanced["shapes"][0]["v0"].shape == (1280, 3)
    assert cs.tables["tri_v0"].shape[0] == 4           # floor and lamp
    assert cs.tables["sph_rows"].shape == (4, 16)
    assert sorted(l.type for l in cs.lights).count(LIGHT_AREA_SPHERE) == 1
    assert len({r[4] for r in cs.instanced["records"]}) == 1024
    mats = cs.tables["ent_mat"][[r[4] for r in cs.instanced["records"]]]
    assert len(set(mats.tolist())) == 3
    tab = build_accel_tables(cs.tables, instanced=cs.instanced)
    assert tab["tl_tris"].shape == (1280, 16) and tab["tl_depth"] == 4
    assert tab["tl_inst"].shape == (1024, 32) and "bw_tris" in tab
    # 160 clusters: 20 nodes of 8 clusters, 3 of 64 over them
    assert tab["tl_ctree"].shape == (1024 + 20 + 3, 8)
    assert (tab["tl_ctree"][:1024, 0:3] == [2, 1024, 1044]).all()


@pytest.mark.cuda
def test_instanced_step_on_the_card_matches_the_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no interpret "
                    "mode")
    from ignis_tpu_torch.ops import tlas
    rt = Runtime(instanced_scene(8, 2), width=64, height=64)
    before = tlas.tlas_closest.launches
    rt.step(spi=2)
    assert tlas.tlas_closest.launches > before
    cpu = Runtime(instanced_scene(8, 2), width=64, height=64, device="cpu")
    cpu.step(spi=2)
    a, b = rt.currentFrame(), cpu.currentFrame()
    assert _lanes_close(a.reshape(-1, 3), b.reshape(-1, 3)).mean() >= 0.98
