"""The port's counter RNG against the JAX package's, bit for bit.

Same numpy-seeded inputs through `ignis_tpu.core.rng` and
`ignis_tpu_torch.core.rng`; integer state and the floats built from it must be
identical (tolerance 0: both are exact integer arithmetic mod 2^32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.core import rng as jrng
from ignis_tpu_torch.core import rng as trng


def _u32s(n, seed):
    r = np.random.default_rng(seed)
    return r.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_create_seed_bit_equal():
    x, y = _u32s(512, 0) % 4096, _u32s(512, 1) % 4096
    s = _u32s(512, 2) % 64
    ref = np.asarray(jrng.create_seed(jnp.asarray(s), jnp.uint32(7),
                                      jnp.uint32(3), jnp.asarray(x),
                                      jnp.asarray(y), jnp.uint32(42)))
    got = trng.create_seed(_t(s), 7, 3, _t(x), _t(y), 42).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


def test_create_seed_accepts_int32_lanes():
    # pixel coordinates arrive as int32 tensors from the callers
    x = torch.arange(100, dtype=torch.int32)
    y = torch.zeros(100, dtype=torch.int32)
    ref = np.asarray(jrng.create_seed(jnp.uint32(0), jnp.uint32(0),
                                      jnp.uint32(0), jnp.arange(100),
                                      jnp.zeros(100, jnp.int32),
                                      jnp.uint32(0)))
    got = trng.create_seed(0, 0, 0, x, y, 0).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


def test_sample_tea_bit_equal():
    v0, v1 = _u32s(4096, 3), _u32s(4096, 4)
    ref = np.asarray(jrng.sample_tea_u32(v0, v1))
    got = trng.sample_tea_u32(_t(v0), _t(v1)).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


def test_next_f32_sequence_bit_equal():
    seed, ctr = _u32s(1024, 5), np.ones(1024, np.uint32)
    js, jc = jnp.asarray(seed), jnp.asarray(ctr)
    ts, tc = _t(seed), _t(ctr)
    for _ in range(8):
        jf, jc = jrng.next_f32(js, jc)
        tf, tc = trng.next_f32(ts, tc)
        assert tf.dtype == torch.float32
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tc.numpy(),
                                      np.asarray(jc).astype(np.int64))
    assert float(tf.min()) >= 0.0 and float(tf.max()) < 1.0


def test_counter_wraps_at_2_32():
    seed = _u32s(4, 6)
    ctr = np.full(4, 0xFFFFFFFF, np.uint32)
    _, jc = jrng.next_f32(jnp.asarray(seed), jnp.asarray(ctr))
    _, tc = trng.next_f32(_t(seed), _t(ctr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
    assert int(tc[0]) == 0


@pytest.mark.parametrize("hi", [1, 4, 6, 1000, 2**31 - 1])
def test_next_i32_bit_equal(hi):
    seed, ctr = _u32s(2000, 7 + hi % 5), np.ones(2000, np.uint32)
    active = np.random.default_rng(8).uniform(size=2000) < 0.7
    jv, jc = jrng.next_i32(jnp.asarray(seed), jnp.asarray(ctr), 0, hi,
                           jnp.asarray(active))
    tv, tc = trng.next_i32(_t(seed), _t(ctr), 0, hi,
                           torch.from_numpy(active))
    assert tv.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
    # inactive lanes: counter untouched, value 0
    assert (tc.numpy()[~active] == 1).all() and (tv.numpy()[~active] == 0).all()


def test_next_u32_range_redraws_match():
    # a range just above 2^31 rejects almost half of the draws: the redraw
    # loop runs several rounds and must advance counters as the reference
    seed, ctr = _u32s(512, 9), np.ones(512, np.uint32)
    rr = np.uint32(2**31 + 5)
    jv, jc = jrng.next_u32_range(jnp.asarray(seed), jnp.asarray(ctr), rr)
    tv, tc = trng.next_u32_range(_t(seed), _t(ctr), int(rr))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv).astype(np.int64))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
    assert int(tc.max()) > 2


def test_next_u32_range_full_range():
    seed, ctr = _u32s(64, 10), np.ones(64, np.uint32)
    jv, jc = jrng.next_u32_range(jnp.asarray(seed), jnp.asarray(ctr),
                                 np.uint32(0xFFFFFFFF))
    tv, tc = trng.next_u32_range(_t(seed), _t(ctr), 0xFFFFFFFF)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv).astype(np.int64))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))


def test_hash_rndf_bit_equal():
    f = np.random.default_rng(11).uniform(-10, 10, 256).astype(np.float32)
    ref = np.asarray(jrng.hash_rndf(jnp.asarray(f)))
    got = trng.hash_rndf(torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(got, ref)
