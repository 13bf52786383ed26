"""`render_wavefront(work_mode="tables")`, the explicit work list: each work
item's pixel and sample gathered from `work_x` / `work_y` / `work_sample`,
radiance added straight into the (H*W, 3) framebuffer where lanes of one
pixel collide.

It is held to the port's own `trace_wave` summed per pixel (rtol 2e-4,
atol 2e-5, as tests/test_determinism.py holds the JAX package's two
drivers), to the JAX package's `render_wavefront(work_mode="tables")` on the
same tables and work list (the same tolerance: the sums run in another
order), and, on the canonical pixel x sample list, to the port's default
`work_mode="arith"`.  The work list is shuffled and repeats some items, so
lanes of one pixel meet in one wave.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.api import Runtime as JRuntime
from ignis_tpu.render.integrator import render_wavefront as j_render_wavefront
from ignis_tpu_torch.convert import runtime_from_jax_tables
from ignis_tpu_torch.render.integrator import render_wavefront, trace_wave
from ignis_tpu_torch.scenes import demo_scene

FILM = (12, 10)
SPI = 2
CAPACITY = 256
TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runtimes():
    s = demo_scene()
    s["technique"] = dict(s["technique"], max_depth=4)
    jrt = JRuntime(copy.deepcopy(s), width=FILM[0], height=FILM[1], seed=5)
    trt = runtime_from_jax_tables(
        jrt.scene, {k: np.asarray(v) for k, v in jrt.tables.items()},
        device="cpu", seed=5)
    return jrt, trt


def _work_list(npix, w):
    """Every pixel x sample once, shuffled, plus 40 repeated items."""
    rng = np.random.default_rng(17)
    idx = np.arange(npix * SPI)
    idx = np.concatenate([rng.permutation(idx), rng.choice(idx, 40)])
    pix = idx % npix
    return ((pix % w).astype(np.int32), (pix // w).astype(np.int32),
            (idx // npix).astype(np.uint32))


def _tables_mode(trt, work, tail_capacity=4096):
    x, y, s = (torch.from_numpy(a.astype(np.int64)) for a in work)
    with torch.no_grad():
        fb, stats = render_wavefront(
            trt.scene, trt.tables, 3, 0, trt.seed, CAPACITY, spi=SPI,
            tail_capacity=tail_capacity, work_mode="tables", work_x=x,
            work_y=y, work_sample=s)
    return fb.numpy(), stats.numpy()


def _trace_wave_sum(trt, work):
    npix = trt.width * trt.height
    x, y, s = work
    acc = np.zeros((npix, 3), np.float32)
    with torch.no_grad():
        for smp in np.unique(s):
            sel = s == smp
            lane = trace_wave(trt.scene, trt.tables,
                              torch.from_numpy(x[sel].astype(np.int64)),
                              torch.from_numpy(y[sel].astype(np.int64)),
                              int(smp), 3, 0, trt.seed)
            np.add.at(acc, y[sel] * trt.width + x[sel], lane.numpy())
    return acc


@pytest.mark.parametrize("tail_capacity", [4096, 64])
def test_tables_mode_equals_trace_wave_sum(runtimes, tail_capacity):
    _, trt = runtimes
    work = _work_list(trt.width * trt.height, trt.width)
    fb, stats = _tables_mode(trt, work, tail_capacity)
    np.testing.assert_allclose(fb, _trace_wave_sum(trt, work), **TOL)
    assert fb.mean() > 0
    assert stats[3] == work[0].shape[0]          # camera rays emitted
    assert (stats[2] > 0) == (tail_capacity < CAPACITY)


def test_tables_mode_matches_jax(runtimes):
    jrt, trt = runtimes
    work = _work_list(trt.width * trt.height, trt.width)
    ref, jstats = j_render_wavefront(
        jrt.scene, jrt.tables, *(jnp.asarray(a) for a in work),
        jnp.uint32(3), jnp.uint32(0), jrt.seed, capacity=CAPACITY, spi=SPI,
        work_mode="tables")
    fb, stats = _tables_mode(trt, work)
    np.testing.assert_allclose(fb, np.asarray(ref), **TOL)
    np.testing.assert_array_equal(stats[[0, 3]], np.asarray(jstats)[[0, 3]])


def test_tables_mode_equals_arith_on_the_canonical_list(runtimes):
    _, trt = runtimes
    npix = trt.width * trt.height
    idx = np.arange(npix * SPI)
    pix = idx % npix
    work = ((pix % trt.width).astype(np.int32),
            (pix // trt.width).astype(np.int32),
            (idx // npix).astype(np.uint32))
    fb, _ = _tables_mode(trt, work)
    with torch.no_grad():
        ref, _ = render_wavefront(trt.scene, trt.tables, 3, 0, trt.seed,
                                  CAPACITY, spi=SPI)
    np.testing.assert_allclose(fb, ref.numpy(), **TOL)


def test_unknown_work_mode_raises(runtimes):
    _, trt = runtimes
    with pytest.raises(ValueError, match="work_mode"):
        render_wavefront(trt.scene, trt.tables, 0, 0, 0, CAPACITY,
                         work_mode="list")
