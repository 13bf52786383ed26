"""Counter-based RNG: FNV-1a seed + 4-round TEA, bit-identical to
ignis_tpu/core/rng.py (and to the reference renderer's core/random.art).

Each ray is seeded with an FNV-1a hash of (sample, iter, frame, x, y,
user_seed) and draws numbers with a 4-round TEA block cipher over
(seed, counter++).  The counter persists per ray across bounces, which is what
makes bit-stable path replay possible.

torch has no usable uint32 arithmetic, so 32-bit state is carried in int64
tensors holding values in [0, 2^32); every add/multiply/shift is followed by
`& 0xFFFFFFFF`.  Floats are built by viewing an int32 bit pattern as float32.
"""

from __future__ import annotations

import torch

from ignis_tpu_torch.utils.stats import host_item

M32 = 0xFFFFFFFF
_FNV_INIT = 0x811C9DC5
_FNV_PRIME = 16777619


def _u32(x):
    """uint32 value(s) of x in the int64 carrier (python ints stay ints)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return int(x) & M32


def mul_u32(a, c):
    """(a * c) mod 2^32 for uint32 values a and c (int64 carrier; `c` a
    tensor or a Python int), in 16-bit halves of `c` so that no product
    leaves int64: a full 32 x 32-bit product would need 64 bits unsigned."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def hash_init():
    return _FNV_INIT


def hash_combine(h, d):
    """FNV-1a over the 4 bytes of d (little-endian byte order)."""
    h = _u32(h)
    d = _u32(d)
    h = ((h * _FNV_PRIME) & M32) ^ (d & 0xFF)
    h = ((h * _FNV_PRIME) & M32) ^ ((d >> 8) & 0xFF)
    h = ((h * _FNV_PRIME) & M32) ^ ((d >> 16) & 0xFF)
    h = ((h * _FNV_PRIME) & M32) ^ ((d >> 24) & 0xFF)
    return h


def create_seed(sample, iteration, frame, x, y, user):
    """Per-ray seed: FNV-1a of (sample, iter, frame, x, y, user)."""
    h = hash_init()
    for d in (sample, iteration, frame, x, y, user):
        h = hash_combine(h, d)
    return h


def sample_tea_u32(v0, v1):
    """4-round TEA; returns v1."""
    v0 = _u32(v0)
    v1 = _u32(v1)
    total = 0
    # The low 32 bits of a sum or an xor depend only on the low 32 bits of
    # its operands, so one mask per update is enough; only the right shifts
    # need v0 / v1 to be true 32-bit values, and those are masked.
    for _ in range(4):
        total = (total + 0x9E3779B9) & M32
        v0 = (v0 + (((v1 << 4) + 0xA341316C)
                    ^ (v1 + total)
                    ^ ((v1 >> 5) + 0xC8013EA4))) & M32
        v1 = (v1 + (((v0 << 4) + 0xAD90777D)
                    ^ (v0 + total)
                    ^ ((v0 >> 5) + 0x7E95761E))) & M32
    return v1


def next_u32(seed, counter):
    """Draw raw 32 bits; returns (bits, counter + 1)."""
    bits = sample_tea_u32(seed, counter)
    return bits, (_u32(counter) + 1) & M32


def u32_to_f32(bits):
    """[0, 1) float: a float in [1, 2) from 23 mantissa bits, minus 1."""
    mant = (bits & 0x7FFFFF) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def next_f32(seed, counter):
    bits, counter = next_u32(seed, counter)
    return u32_to_f32(bits), counter


def next_f32_n(seed, counter, n):
    """Draw n consecutive floats; returns (tuple of floats, counter)."""
    outs = []
    for _ in range(n):
        f, counter = next_f32(seed, counter)
        outs.append(f)
    return tuple(outs), counter


def next_u32_range(seed, counter, rng_range, active=None):
    """Uniform integer in [0, rng_range] inclusive, rejection-sampled.

    Scaling-division with a redraw loop on the biased tail.  Lanes that have
    accepted stop advancing their counter; `active` masks lanes that do not
    draw at all (counter untouched, result 0).  The redraw loop is a Python
    loop that ends on `not pending.any()`: one host sync per round
    (`utils.stats.host_item`), almost always one round.
    """
    counter = _u32(counter)
    rng_range = _u32(rng_range)
    if not isinstance(rng_range, torch.Tensor):
        rng_range = torch.full_like(counter, rng_range)
    if active is None:
        active = torch.ones_like(counter, dtype=torch.bool)

    full = rng_range == M32
    erange = (rng_range + 1) & M32  # wraps to 0 when full; guarded below
    safe_erange = torch.where(full, torch.ones_like(erange), erange)
    scaling = torch.div(torch.full_like(erange, M32), safe_erange,
                        rounding_mode="floor")
    past = (safe_erange * scaling) & M32

    ret = torch.zeros_like(counter)
    pending = active
    while True:
        bits = sample_tea_u32(seed, counter)
        ret = torch.where(pending, bits, ret)
        counter = torch.where(pending, (counter + 1) & M32, counter)
        pending = pending & ~full & (ret >= past)
        if not host_item(pending.any()):
            break
    value = torch.where(full, ret,
                        torch.div(ret, scaling, rounding_mode="floor"))
    return torch.where(active, value, torch.zeros_like(value)), counter


def next_i32(seed, counter, lo, hi, active=None):
    """Uniform int32 in [lo, hi] inclusive."""
    v, counter = next_u32_range(seed, counter, (int(hi) - int(lo)) & M32,
                                active)
    # uint32 -> int32 reinterpretation, then the (wrapping) offset
    v = ((v + int(lo)) & M32)
    v = torch.where(v >= 0x80000000, v - 0x100000000, v)
    return v.to(torch.int32), counter


def hash_rndf(seed_f32):
    """Deterministic [0,1) float keyed on a float32 tensor."""
    bits = seed_f32.to(torch.float32).view(torch.int32).to(torch.int64) & M32
    seed = hash_combine(hash_init(), bits)
    f, _ = next_f32(seed, torch.ones_like(bits))
    return f
