"""The pixel samplers (`render/sampler.py`) against the JAX package's.

`_permute_element` (a power-of-two length, run as one round, and a length of
5, run as the host loop), `sample_mjitt`, the radical inverse and
`sample_halton` on 4096 lanes: bit-equal (the port's uint32 values in the
int64 carrier of `core/rng.py`), with sample indices past both of the Halton
index's 32-bit wraps at 512x512.  `build_halton_offsets` equal.  A path
render under each sampler per lane at depth 2 (1e-4, both packages on the
Moeller-Trumbore sweep), and the Halton sampler's `spi` index through both
`Runtime`s by image mean (1e-5).

The JAX package's mjitt sampler runs only outside `jax.jit` (its
`_permute_element` calls `int()` on a traced length) and only with a
per-lane sample index (a scalar one changes the shape of its `while_loop`
carry): its side is called eagerly here, with the sample given per lane.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.render import sampler as js
from ignis_tpu.render.integrator import trace_wave as j_trace_wave
from ignis_tpu.scene.compile import load_and_compile as j_compile
from ignis_tpu_torch.convert import runtime_from_jax_tables
from ignis_tpu_torch.core.rng import mul_u32
from ignis_tpu_torch.render import sampler as ts
from ignis_tpu_torch.render.integrator import trace_wave
from ignis_tpu_torch.scenes import demo_scene

N = 4096
# 512x512: stride 2^9 * 3^6 = 373,248; index * stride passes 2^31 after
# 5,754 samples and 2^32 after 11,507
HALTON_INDICES = (0, 1, 7, 5753, 5754, 11506, 11507, 11508, 40000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u32(rng, n=N):
    return rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_mul_u32_is_the_low_word():
    r = np.random.default_rng(0)
    a, c = _u32(r), _u32(r)
    want = (a.astype(np.uint64) * c.astype(np.uint64)) & 0xFFFFFFFF
    np.testing.assert_array_equal(mul_u32(_t(a), _t(c)).numpy(),
                                  want.astype(np.int64))
    np.testing.assert_array_equal(mul_u32(_t(a), 0xE170893D).numpy(),
                                  ((a.astype(np.uint64) * 0xE170893D)
                                   & 0xFFFFFFFF).astype(np.int64))


@pytest.mark.parametrize("l", [1, 4, 5])
def test_permute_element_bit_equal(l):
    r = np.random.default_rng(l)
    i = r.integers(0, l, N).astype(np.uint32)
    seed = _u32(r)
    ref = np.asarray(js._permute_element(jnp.asarray(i), l,
                                         jnp.asarray(seed)))
    got = ts._permute_element(_t(i), l, _t(seed))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    assert got.min() >= 0 and got.max() < l


def test_sample_mjitt_bit_equal():
    r = np.random.default_rng(1)
    seed, counter = _u32(r), _u32(r)
    index = np.concatenate([np.arange(N // 2),
                            r.integers(0, 2 ** 31, N // 2)]).astype(np.int32)
    x = r.integers(0, 512, N).astype(np.int32)
    y = r.integers(0, 512, N).astype(np.int32)
    rx, ry, c = js.sample_mjitt(jnp.asarray(seed), jnp.asarray(counter),
                                jnp.asarray(index), jnp.asarray(x),
                                jnp.asarray(y))
    gx, gy, gc = ts.sample_mjitt(_t(seed), _t(counter), _t(index),
                                 torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(ry))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(c).astype(np.int64))


@pytest.mark.parametrize("base", [2, 3])
def test_radical_inverse_bit_equal(base):
    r = np.random.default_rng(base)
    idx = np.concatenate([np.arange(64), [0xFFFFFFFF, 0xFFFFFFFE],
                          _u32(r, N - 66)]).astype(np.uint32)
    ref = np.asarray(js._radical_inverse_jnp(jnp.asarray(idx), base))
    got = ts._radical_inverse(_t(idx), base).numpy()
    np.testing.assert_array_equal(got, ref)
    # and the host version on a few indices
    for i in (0, 1, 5, 12345, 0xFFFFFFFF):
        assert ts._radical_inverse_np(i, base) == js._radical_inverse_np(
            i, base)


@pytest.mark.parametrize("size", [(1, 1), (16, 9), (512, 512)])
def test_build_halton_offsets_equal(size):
    a, b = js.build_halton_offsets(*size), ts.build_halton_offsets(*size)
    assert a.keys() == b.keys()
    np.testing.assert_array_equal(a.pop("offsets"), b.pop("offsets"))
    assert a == b


def test_sample_halton_bit_equal_past_the_wraps():
    w = h = 512
    setup = ts.build_halton_offsets(w, h)
    assert setup["stride"] == 373248
    offsets = setup.pop("offsets")
    r = np.random.default_rng(2)
    x = r.integers(0, w, N).astype(np.int32)
    y = r.integers(0, h, N).astype(np.int32)
    index = np.resize(np.asarray(HALTON_INDICES, np.int32), N)
    assert (index.astype(np.int64) * setup["stride"] >= 2 ** 32).any()
    rx, ry = js.sample_halton(setup, jnp.asarray(offsets), jnp.asarray(index),
                              jnp.asarray(x), jnp.asarray(y), w)
    gx, gy = ts.sample_halton(setup, torch.from_numpy(offsets),
                              _t(index), torch.from_numpy(x),
                              torch.from_numpy(y), w)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(ry))
    assert 0 <= gx.min() and gx.max() < 1 and 0 <= gy.min() and gy.max() < 1


def _sampler_scene(sampler, depth=2):
    s = demo_scene()
    s["film"] = dict(s.get("film", {}), size=[16, 12], sampler=sampler)
    s["technique"] = dict(s["technique"], max_depth=depth)
    return s


@pytest.mark.parametrize("sampler", ["mjitt", "halton"])
def test_path_render_per_lane(sampler):
    """`trace_wave` of every pixel under the sampler, sample 1 of iteration
    2 (the per-sample driver's index iteration + sample), per lane."""
    jsc = j_compile(_sampler_scene(sampler), 16, 12)
    assert (sampler != "halton") or "halton_offsets" in jsc.tables
    trt = runtime_from_jax_tables(jsc, jsc.tables, device="cpu")
    idx = np.arange(16 * 12, dtype=np.int32)
    x, y = idx % 16, idx // 16
    ref = np.asarray(j_trace_wave(
        jsc, {k: jnp.asarray(v) for k, v in jsc.tables.items()},
        jnp.asarray(x), jnp.asarray(y), jnp.full(x.shape, 1, jnp.uint32),
        jnp.uint32(2), jnp.uint32(0), 3))
    got = trace_wave(trt.scene, trt.tables, torch.from_numpy(x),
                     torch.from_numpy(y), 1, 2, 0, 3).numpy()
    ok = np.isclose(got, ref, rtol=1e-4, atol=1e-4).all(axis=-1)
    assert ok.mean() >= 0.995, (~ok).sum()
    assert ref.mean() > 0


def test_halton_runtime_by_mean():
    """`Runtime.step(spi=2)` under the Halton sampler (the wavefront's index
    iteration * spi + sample) through both packages, their tables the JAX
    compiler's."""
    from ignis_tpu.api import Runtime as JRuntime
    scene = _sampler_scene("halton", depth=1)
    jrt = JRuntime(copy.deepcopy(scene))
    jrt.step(spi=2)
    jrt.step(spi=2)
    tables = {k: np.asarray(v) for k, v in jrt.tables.items()}
    trt = runtime_from_jax_tables(jrt.scene, tables, device="cpu")
    trt.step(spi=2)
    trt.step(spi=2)
    a, b = jrt.currentFrame(), trt.currentFrame()
    assert abs(a.mean() - b.mean()) <= 1e-5 * a.mean()
    assert a.mean() > 0


def test_mjitt_runtime_renders():
    """The port's `Runtime` under the mjitt sampler (the JAX package's
    raises under `jax.jit`)."""
    from ignis_tpu_torch.api import Runtime
    rt = Runtime(_sampler_scene("mjitt"), device="cpu")
    rt.step(spi=2)
    img = rt.currentFrame()
    assert np.isfinite(img).all() and img.mean() > 0
