"""The ported slice as a whole against the JAX package: `trace_wave`,
`render_wavefront` and `Runtime.step`.

How the two sides are put on the same footing: on the CPU the JAX integrator
never reaches its Pallas kernels and runs the Moeller-Trumbore sweep, so the
per-lane comparisons give BOTH packages the raw compiled tables (no `bw_*` /
`pb_*`), which sends both through Moeller-Trumbore.  With the port's
Baldwin-Weber or packet-BVH tables the hit predicate differs at triangle
edges, so those runs are held per pixel on the pixels that agree and by image
mean overall.

Tolerances: the RNG state is bit-equal, so two lanes differ only by float
rounding (XLA contracts multiply-adds, eager torch does not) until a last-ulp
difference flips a russian-roulette, Fresnel or edge-hit decision; from there
the lane is a different, equally valid path.  So: per lane 1e-4 at depth <= 2
with at most 0.5 % of the lanes allowed to flip, and image means to 1 % at
full depth.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import create_flat_scene
from ignis_tpu.api import Runtime as JRuntime
from ignis_tpu.render.integrator import trace_wave as j_trace_wave
from ignis_tpu.scene.compile import load_and_compile as j_compile
from ignis_tpu_torch.api import Runtime, build_accel_tables
from ignis_tpu_torch.convert import runtime_from_jax_tables, tables_from_numpy
from ignis_tpu_torch.render.integrator import render_wavefront, trace_wave
from ignis_tpu_torch.scene.compile import load_and_compile as t_compile
from ignis_tpu_torch.scenes import big_scene, demo_scene
from test_torch_compile import dof_scene, ico_scene, lights_scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops on these small inputs run faster on one intra-op
    thread, and the test workers sharing the CPU then do not oversubscribe
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_depth(scene, depth):
    scene = dict(scene)
    scene["technique"] = dict(scene["technique"], max_depth=depth)
    return scene


def _pixels(w, h):
    idx = np.arange(w * h, dtype=np.int32)
    return idx % w, idx // w


def _both_trace(scene, w=32, h=32, sample=0, iteration=0, seed=0):
    """trace_wave over every pixel through both packages, raw tables."""
    js, ts = j_compile(scene, w, h), t_compile(scene, w, h)
    x, y = _pixels(w, h)
    ref = np.asarray(j_trace_wave(
        js, {k: jnp.asarray(v) for k, v in js.tables.items()},
        jnp.asarray(x), jnp.asarray(y), jnp.uint32(sample),
        jnp.uint32(iteration), jnp.uint32(0), seed))
    got = trace_wave(ts, tables_from_numpy(ts.tables, "cpu"),
                     torch.from_numpy(x), torch.from_numpy(y), sample,
                     iteration, 0, seed).numpy()
    return ref, got


def _lanes_close(got, ref, tol=1e-4):
    return np.isclose(got, ref, rtol=tol, atol=tol).all(axis=-1)


@pytest.mark.parametrize("name,scene_fn", [
    ("demo", demo_scene), ("lights", lights_scene), ("dof", dof_scene)])
def test_trace_wave_per_lane_depth2(name, scene_fn):
    ref, got = _both_trace(_with_depth(scene_fn(), 2))
    assert np.isfinite(got).all() and got.shape == ref.shape
    ok = _lanes_close(got, ref)
    assert ok.mean() >= 0.995, (name, (~ok).sum())
    assert ref.mean() > 0
    assert abs(got.mean() - ref.mean()) <= 2e-3 * ref.mean()


def test_trace_wave_flat_scene_per_lane():
    scene = create_flat_scene()
    scene["lights"] = [{"type": "env", "name": "e", "radiance": [1, 1, 1]}]
    ref, got = _both_trace(scene)
    assert _lanes_close(got, ref).mean() >= 0.995
    # a white floor under a white sky: every pixel sees radiance 1
    assert abs(got.mean() - 1.0) < 0.05


def test_trace_wave_full_depth_by_mean():
    ref, got = _both_trace(demo_scene(), sample=1, iteration=3, seed=7)
    assert np.isfinite(got).all()
    assert abs(got.mean() - ref.mean()) <= 1e-2 * ref.mean()
    # most lanes still agree one by one at depth 6
    assert _lanes_close(got, ref, 1e-3).mean() >= 0.98


def test_trace_wave_ray_list_form():
    """org / direction given: no pixel-sampler draws, rays used as they are."""
    scene = demo_scene()
    js, ts = j_compile(scene, 64, 1), t_compile(scene, 64, 1)
    r = np.random.default_rng(0)
    n = 64
    org = np.tile(np.float32([0, 0, 3.5]), (n, 1))
    d = np.float32([0, 0, -1]) + r.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, np.float32(3.4028235e38), np.float32)
    tmax[-4:] = 0.0                      # dead rays
    x, y = np.arange(n, dtype=np.int32), np.zeros(n, np.int32)
    ref = np.asarray(j_trace_wave(
        js, {k: jnp.asarray(v) for k, v in js.tables.items()},
        jnp.asarray(x), jnp.asarray(y), jnp.uint32(0), jnp.uint32(2),
        jnp.uint32(0), 0, org=jnp.asarray(org), direction=jnp.asarray(d),
        tmin=jnp.asarray(tmin), tmax=jnp.asarray(tmax)))
    got = trace_wave(ts, tables_from_numpy(ts.tables, "cpu"),
                     torch.from_numpy(x), torch.from_numpy(y), 0, 2, 0, 0,
                     org=torch.from_numpy(org), direction=torch.from_numpy(d),
                     tmin=torch.from_numpy(tmin),
                     tmax=torch.from_numpy(tmax)).numpy()
    assert _lanes_close(got, ref, 1e-3).mean() >= 0.95
    assert abs(got.mean() - ref.mean()) <= 2e-2 * ref.mean()


def test_trace_wave_differentiable_raises():
    """`differentiable=True` raised while the gradient path was not ported.
    Now it runs a fixed `max_depth` bounces over every lane; at up to 4096
    lanes the other loop runs no tail cascade, every lane ends within
    `max_depth` bounces, so the radiance is the same bit for bit, and it
    carries a graph back to the parameter tables."""
    ts = t_compile(demo_scene(), 64, 64)
    tables = tables_from_numpy(build_accel_tables(ts.tables), "cpu")
    x, y = (torch.from_numpy(a) for a in _pixels(64, 64))
    plain = trace_wave(ts, tables, x, y, 0, 1, 0, 2)
    tables["mat_colors"].requires_grad_(True)
    diff = trace_wave(ts, tables, x, y, 0, 1, 0, 2, differentiable=True)
    assert diff.requires_grad and not plain.requires_grad
    np.testing.assert_array_equal(diff.detach().numpy(), plain.numpy())


@pytest.fixture(scope="module")
def step_frames():
    """Runtime.step at 32x32, spi 2, through both packages (the JAX side
    compiles its wavefront once for the module)."""
    jrt = JRuntime(demo_scene(), width=32, height=32, seed=3)
    jrt.step(spi=2)
    trt = Runtime(demo_scene(), width=32, height=32, seed=3, device="cpu")
    trt.step(spi=2)
    return jrt, trt


def test_runtime_step_frame_matches_jax(step_frames):
    """The port runs its Baldwin-Weber sweep, JAX on the CPU runs
    Moeller-Trumbore: pixels agree except where an edge hit differs."""
    jrt, trt = step_frames
    ref, got = jrt.currentFrame(), trt.currentFrame()
    assert got.shape == (32, 32, 3) and np.isfinite(got).all()
    assert _lanes_close(got.reshape(-1, 3), ref.reshape(-1, 3)).mean() >= 0.99
    assert abs(got.mean() - ref.mean()) <= 1e-2 * ref.mean()
    assert trt.currentSampleCount() == jrt.currentSampleCount() == 2
    np.testing.assert_allclose(trt.rawFramebuffer(), got * 2, rtol=1e-6)


def test_runtime_statistics_match_jax(step_frames):
    jrt, trt = step_frames
    jrt.dumpStats()
    text = trt.dumpStats()
    assert "WaveOccupancy" in text and "first step" in text
    for key in ("WaveIterations", "TailIterations", "CameraRayCount(device)"):
        assert trt.stats.quantities[key] == jrt.stats.quantities[key], key
    # ray counts may differ by the few lanes whose edge hit differs
    for key in ("RayHitCount", "ShadowRayCount", "BounceRayCount"):
        a, b = trt.stats.quantities[key], jrt.stats.quantities[key]
        assert abs(a - b) <= 0.01 * b, key


def test_runtime_from_jax_tables_same_state(step_frames):
    """The JAX Runtime's own tables (bw_* and tri_shade included) through the
    port: same frame as the port's own compile."""
    jrt, trt = step_frames
    rt = runtime_from_jax_tables(
        jrt.scene, {k: np.asarray(v) for k, v in jrt.tables.items()},
        device="cpu", seed=3)
    assert "bw_tris" in rt.tables and "tri_shade" in rt.tables
    rt.step(spi=2)
    np.testing.assert_array_equal(rt.currentFrame(), trt.currentFrame())


def test_runtime_from_jax_tables_beside_the_binary_bvh(tmp_path, monkeypatch):
    """Over 8192 triangles the JAX Runtime adds its binary-BVH tables
    (`bvh_*`) beside the packet rows; the dispatch never reads them there,
    so they go through the port as they are: same frame as the port's own
    Runtime on the same scene and seed.  Without the packet rows the
    dispatch walks them (`ops.bvh`, the reference's per-lane stack walk):
    the same frame again."""
    from ignis_tpu_torch.ops.bvh import bvh_closest
    monkeypatch.setenv("IGNIS_TPU_CACHE", str(tmp_path))
    scene = big_scene(n_spheres=8, subdiv=3)
    jrt = JRuntime(scene, width=16, height=16, seed=5)
    tables = {k: np.asarray(v) for k, v in jrt.tables.items()}
    assert jrt.tables["tri_v0"].shape[0] == 10242
    assert "bvh_node_min" in tables and "pb_rows" in tables
    rt = runtime_from_jax_tables(jrt.scene, tables, device="cpu", seed=5)
    rt.step(spi=1)
    trt = Runtime(scene, width=16, height=16, seed=5, device="cpu")
    trt.step(spi=1)
    got, ref = rt.currentFrame(), trt.currentFrame()
    assert np.isfinite(got).all() and got.mean() > 0
    assert _lanes_close(got.reshape(-1, 3), ref.reshape(-1, 3)).mean() >= 0.99
    assert abs(got.mean() - ref.mean()) <= 1e-2 * ref.mean()
    no_rows = {k: v for k, v in tables.items() if not k.startswith("pb_")}
    calls = bvh_closest.calls
    walk = runtime_from_jax_tables(jrt.scene, no_rows, device="cpu", seed=5)
    walk.step(spi=1)
    assert bvh_closest.calls > calls
    got2 = walk.currentFrame()
    assert _lanes_close(got2.reshape(-1, 3), got.reshape(-1, 3)).mean() >= 0.99
    assert abs(got2.mean() - got.mean()) <= 1e-2 * got.mean()


def test_runtime_reset_and_replay_bitwise(step_frames):
    _, trt = step_frames
    first = trt.currentFrame().copy()
    trt.reset()
    assert trt.currentSampleCount() == 0
    assert not trt.rawFramebuffer().any()
    trt.step(spi=2)
    np.testing.assert_array_equal(trt.currentFrame(), first)
    other = Runtime(demo_scene(), width=32, height=32, seed=3, device="cpu")
    other.step(spi=2)
    np.testing.assert_array_equal(other.currentFrame(), first)
    other.step(spi=1)                     # a new iteration: new samples
    assert other.currentSampleCount() == 3
    assert not np.array_equal(other.currentFrame(), first)


def test_wavefront_equals_trace_wave_per_pixel():
    """The regenerating wavefront and one-ray-per-lane tracing give a pixel
    the same sample: same seed, same draws, same arithmetic."""
    ts = t_compile(demo_scene(), 24, 24)
    tables = tables_from_numpy(build_accel_tables(ts.tables), "cpu")
    x, y = (torch.from_numpy(a) for a in _pixels(24, 24))
    per_lane = sum(trace_wave(ts, tables, x, y, s, 5, 0, 9) for s in (0, 1))
    # capacity below the work size: lanes regenerate mid-wave
    fb, stats = render_wavefront(ts, tables, 5, 0, 9, capacity=256, spi=2)
    np.testing.assert_allclose(fb.numpy(), per_lane.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert int(stats[3]) == 24 * 24 * 2          # camera rays emitted


def test_wavefront_tail_cascade_and_work_tables():
    """The tail cascade changes the schedule, not the image; neither does
    the explicit work list (`work_mode="tables"`) of the same pixel x sample
    enumeration."""
    ts = t_compile(demo_scene(), 16, 16)
    tables = tables_from_numpy(build_accel_tables(ts.tables), "cpu")
    kw = dict(capacity=128, spi=1)
    wide, s_wide = render_wavefront(ts, tables, 1, 0, 4, tail_capacity=128,
                                    **kw)
    tail_iters = []
    for cap in (16, 64, 100, 120):
        casc, s_casc = render_wavefront(ts, tables, 1, 0, 4,
                                        tail_capacity=cap, **kw)
        np.testing.assert_allclose(casc.numpy(), wide.numpy(), rtol=1e-6,
                                   atol=1e-7)
        tail_iters.append(int(s_casc[2]))
        # lane visits are the same whatever the schedule
        assert int(s_casc[1]) == int(s_wide[1])
    assert int(s_wide[2]) == 0 and max(tail_iters) > 0    # tail iterations
    idx = torch.arange(16 * 16)
    listed, s_list = render_wavefront(
        ts, tables, 1, 0, 4, work_mode="tables", work_x=idx % 16,
        work_y=idx // 16, work_sample=torch.zeros_like(idx), **kw)
    np.testing.assert_allclose(listed.numpy(), wide.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert int(s_list[1]) == int(s_wide[1])


def test_trace_wave_tail_cascade():
    """More than 4096 lanes: survivors are compacted into a narrow wave and
    their radiance added back per lane."""
    w, h = 65, 64
    ts = t_compile(demo_scene(), w, h)
    tables = tables_from_numpy(build_accel_tables(ts.tables), "cpu")
    x, y = (torch.from_numpy(a) for a in _pixels(w, h))
    whole = trace_wave(ts, tables, x, y, 0, 0, 0, 0).numpy()
    half = w * h // 2
    parts = np.concatenate([
        trace_wave(ts, tables, x[:half], y[:half], 0, 0, 0, 0).numpy(),
        trace_wave(ts, tables, x[half:], y[half:], 0, 0, 0, 0).numpy()])
    np.testing.assert_allclose(whole, parts, rtol=1e-6, atol=1e-7)


def test_packet_bvh_scene_through_runtime():
    """A 5120-triangle icosphere takes the packet-BVH tables; held against the
    JAX Runtime by mean and per pixel."""
    jrt = JRuntime(ico_scene(), width=24, height=24)
    jrt.step(spi=1)
    trt = Runtime(ico_scene(), width=24, height=24, device="cpu")
    assert "pb_rows" in trt.tables and "bw_tris" not in trt.tables
    trt.step(spi=1)
    ref, got = jrt.currentFrame(), trt.currentFrame()
    assert np.isfinite(got).all()
    assert _lanes_close(got.reshape(-1, 3), ref.reshape(-1, 3)).mean() >= 0.98
    assert abs(got.mean() - ref.mean()) <= 1e-2 * ref.mean()


def test_runtime_trace_matches_jax():
    rays = [((0, 0, 3.5), (0, 0, -1)), ((0, 0, 3.5), (0.1, -0.2, -1)),
            ((0, 0.5, 3.5), (0, -0.3, -1), 0.0, 10.0)]
    jrt = JRuntime(demo_scene(), width=8, height=8)
    trt = Runtime(demo_scene(), width=8, height=8, device="cpu")
    ref, got = jrt.trace(rays, spp=4), trt.trace(rays, spp=4)
    assert got.shape == (3, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=5e-2, atol=1e-3)


def test_camera_parameters_move_the_camera():
    trt = Runtime(demo_scene(), width=16, height=16, device="cpu")
    jrt = JRuntime(demo_scene(), width=16, height=16)
    np.testing.assert_array_equal(trt.getParameter("__camera_eye"),
                                  jrt.getParameter("__camera_eye"))
    trt.step()
    before = trt.currentFrame().copy()
    trt.reset()
    trt.setCameraOrientationParameter([0.5, 0.2, 3.0], [0, 0, -1], [0, 1, 0])
    np.testing.assert_allclose(trt.getParameter("__camera_eye"),
                               [0.5, 0.2, 3.0])
    trt.step()
    assert not np.allclose(trt.currentFrame(), before)
    # the compiled scene's own table is not written through
    assert float(trt.scene.tables["params"][0]) != 0.5
    with pytest.raises(KeyError):
        trt.setParameter("nope", 1.0)


def test_runtime_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Runtime(demo_scene(), width=8, height=8)


def test_raw_tables_raise_on_the_card_and_sweep_on_the_cpu(monkeypatch):
    """Tables without `bw_tris` / `pb_rows` go through the Moeller-Trumbore
    sweep: `ops/intersect.py` on the CPU, the sweep's CUDA kernel on the card
    (they raised there before that kernel was ported).  The condition is the
    tensor's device, checked here with a stand-in for a CUDA tensor.  An
    empty soup misses everywhere, on either device, without a sweep."""
    from types import SimpleNamespace
    from ignis_tpu_torch.render import integrator

    class OnCard(SimpleNamespace):
        def detach(self):
            return self
    on_card = OnCard(is_cuda=True)
    some = {k: torch.zeros(3, 3) for k in ("tri_v0", "tri_e1", "tri_e2")}
    t1 = torch.zeros(1)
    assert not hasattr(integrator, "_check_mt_sweep")
    monkeypatch.setattr(integrator, "mt_closest", lambda *a, **k: "kernel")
    monkeypatch.setattr(integrator, "mt_any", lambda *a, **k: "kernel")
    for name in ("intersect_closest", "intersect_any"):
        sweep = getattr(integrator, name)
        monkeypatch.setattr(integrator, name,
                            lambda *a, _f=sweep, **k: ("cpu", _f(*a, **k)))
    for traverse in (integrator._traverse_closest, integrator._traverse_any):
        assert traverse(None, some, on_card, on_card, t1, t1, None) == "kernel"
        assert traverse(None, some, torch.zeros(1, 3), torch.ones(1, 3), t1,
                        t1, None)[0] == "cpu"
    monkeypatch.undo()
    empty = {k: torch.zeros(0, 3) for k in ("tri_v0", "tri_e1", "tri_e2")}
    org = torch.zeros(5, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(5, 1)
    tmin, tmax = torch.zeros(5), torch.full((5,), 10.0)
    assert (integrator._traverse_closest(None, some, org, d, tmin, tmax,
                                         None)[3] == -1).all()
    prim = integrator._traverse_closest(None, empty, org, d, tmin, tmax,
                                        None)[3]
    assert (prim == -1).all()
    assert not integrator._traverse_any(None, empty, org, d, tmin, tmax,
                                        None).any()


def test_package_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pkgutil, importlib, ignis_tpu_torch\n"
        "for m in pkgutil.walk_packages(ignis_tpu_torch.__path__, "
        "'ignis_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'ignis_tpu' or m.startswith('ignis_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('clean', len([m for m in sys.modules if "
        "m.startswith('ignis_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(__import__("pathlib").Path(
                             __file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root = __import__("pathlib").Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(root / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=str(root))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    src = (root / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from ignis_tpu " not in src \
        and "import ignis_tpu\n" not in src
