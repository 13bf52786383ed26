"""Pixel samplers.  Counterpart of ignis_tpu/render/sampler.py.

independent (uniform), mjitt (4x4 correlated multi-jitter) and halton
(per-pixel scrambled radical inverse), batched over pixel lanes.  The halton
per-pixel offset table is built on the host per film size
(`build_halton_offsets`).

uint32 values travel in the int64 carrier of `core/rng.py`; a 32-bit product
goes through `rng.mul_u32`, and every result is masked back to 32 bits, so
the draws are the reference's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ignis_tpu_torch.core import rng
from ignis_tpu_torch.core.rng import M32, mul_u32
from ignis_tpu_torch.utils.stats import host_item

_F1 = 0xA511E9B3
_F2 = 0x63D83595
_ONE_MINUS_EPS = float(np.float32(1.0) - np.float32(1.1920929e-07))

MJITT = ("mjitt", "multijitt", "multijittered")


def _permute_round(ii, seed, w):
    """One round of the correlated permutation's hash."""
    ii = ii ^ seed
    ii = mul_u32(ii, 0xE170893D)
    ii = ii ^ (seed >> 16)
    ii = ii ^ ((ii & w) >> 4)
    ii = ii ^ (seed >> 8)
    ii = mul_u32(ii, 0x0929EB3F)
    ii = ii ^ (seed >> 23)
    ii = ii ^ ((ii & w) >> 1)
    ii = mul_u32(ii, 1 | (seed >> 27))
    ii = mul_u32(ii, 0x6935FA69)
    ii = ii ^ ((ii & w) >> 11)
    ii = mul_u32(ii, 0x74DCB303)
    ii = ii ^ ((ii & w) >> 2)
    ii = mul_u32(ii, 0x9E501CC3)
    ii = ii ^ ((ii & w) >> 2)
    ii = mul_u32(ii, 0xC860A3DF)
    ii = ii & w
    return ii ^ (ii >> 5)


def _permute_element(i, l, seed):
    """Correlated permutation of i in [0, l) (int64 carrier).

    The reference redraws until every lane is below `l`.  For a power-of-two
    `l` the mask `w` is `l - 1` and a round ends in `ii & w`, then
    `ii ^ (ii >> 5)`, which stays within `w`'s bits: every lane is done after
    exactly one round, so that case runs one round with no host sync.  Any
    other `l` loops on the host, one sync a round."""
    seed = rng._u32(seed)
    i = rng._u32(i)
    if not isinstance(i, torch.Tensor):
        # one index for every lane (the per-sample driver's)
        i = torch.full_like(seed, i)
    l = int(l)
    if l - 1 == 0:
        return torch.zeros_like(i)
    w = l - 1
    for shift in (1, 2, 4, 8, 16):
        w |= w >> shift
    if l & (l - 1) == 0:
        cur = _permute_round(i, seed, w)
    else:
        cur = i
        pending = torch.ones(i.shape, dtype=torch.bool, device=i.device)
        while True:
            cur = torch.where(pending, _permute_round(cur, seed, w), cur)
            pending = pending & (cur >= l)
            if not host_item(pending.any()):
                break
    return ((cur + seed) & M32) % l


def sample_mjitt(seed, counter, index, x, y, bins=(4, 4)):
    """Correlated multi-jittered pixel sample; two draws of the lane's
    counter.  Returns (rx, ry, counter)."""
    bx, by = bins
    h = rng.hash_combine(rng.hash_combine(rng.hash_init(), x), y)
    idx = rng._u32(index)
    sx = _permute_element(idx % bx, bx, mul_u32(h, _F1)).to(torch.float32)
    sy = _permute_element(idx // bx, by, mul_u32(h, _F2)).to(torch.float32)
    jx, counter = rng.next_f32(seed, counter)
    jy, counter = rng.next_f32(seed, counter)
    rx = (sx + (sy + jx) / by) / bx
    ry = (sy + (sx + jy) / bx) / by
    return rx, ry, counter


# ------------------------------------------------------------------- halton

def _radical_inverse_np(index, base):
    inv_base = 1.0 / base
    inv_base_n = 1.0
    rev = 0
    limit = 0xFFFFFFFF // base - base
    while index != 0 and rev < limit:
        nxt = index // base
        digit = index - nxt * base
        rev = rev * base + digit
        inv_base_n *= inv_base
        index = nxt
    return min(rev * inv_base_n, 1.0 - 1.1920929e-07)


def _inverse_radical_inverse(inv, base, digits):
    index = 0
    for _ in range(digits):
        digit = inv % base
        inv //= base
        index = index * base + digit
    return index


def _halton_base_info(dim, base):
    scale, exp = 1, 0
    while scale < dim:
        scale *= base
        exp += 1
    return scale, exp


def _mult_inverse(a, n):
    def egcd(a, b):
        if b == 0:
            return 1, 0
        x, y = egcd(b, a % b)
        return y, x - (a // b) * y
    x, _ = egcd(a, n)
    return x % n


def build_halton_offsets(width, height):
    """Per-pixel halton index offsets and the sampler's constants."""
    b1, b2 = 2, 3
    sx, ex = _halton_base_info(width, b1)
    sy, ey = _halton_base_info(height, b2)
    mix = _mult_inverse(sx, sy)
    miy = _mult_inverse(sy, sx)
    stride = sx * sy
    out = np.zeros((height, width), np.int64)
    if stride > 1:
        xs = np.array([_inverse_radical_inverse(x, b1, ex)
                       for x in range(width)], np.int64)
        ys = np.array([_inverse_radical_inverse(y, b2, ey)
                       for y in range(height)], np.int64)
        out = ((xs[None, :] * (stride // sx) * mix
                + ys[:, None] * (stride // sy) * miy) % stride)
    return dict(offsets=out.astype(np.int64).reshape(-1),
                base=(b1, b2), base_scale=(sx, sy), base_exponent=(ex, ey),
                stride=stride)


def _radical_inverse(index, base):
    """Radical inverse of uint32 `index` (int64 carrier) over a fixed number
    of digit rounds (32 for base 2, 21 for any other base)."""
    idx = rng._u32(index)
    inv_base = float(np.float32(1.0 / base))
    limit = 0xFFFFFFFF // base - base
    rev = torch.zeros_like(idx)
    scale = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    for _ in range(32 if base == 2 else 21):
        active = (idx != 0) & (rev < limit)
        nxt = idx // base
        digit = idx - nxt * base
        # rev < limit keeps rev * base + digit below 2^32
        rev = torch.where(active, rev * base + digit, rev)
        scale = torch.where(active, scale * inv_base, scale)
        idx = torch.where(active, nxt, idx)
    return torch.clamp_max(rev.to(torch.float32) * scale, _ONE_MINUS_EPS)


def sample_halton(setup, offsets, index, x, y, width):
    """Halton pixel sample; no draws of the lane's counter.  The sample's
    index is taken mod 2^32, as the reference's 32-bit product wraps."""
    lin = (y.to(torch.int64) * width + x.to(torch.int64))
    hindex = (offsets[lin] + rng._u32(index) * int(setup["stride"])) & M32
    rx = _radical_inverse(hindex >> setup["base_exponent"][0],
                          setup["base"][0])
    ry = _radical_inverse(hindex // setup["base_scale"][1], setup["base"][1])
    return rx, ry


def sample_pixel(scene, tables, seed, counter, spp_index, x, y):
    """The scene's pixel sampler at sample `spp_index` of pixel (x, y):
    mjitt, halton (independent draws when the tables carry no
    `halton_offsets`, as in the reference), else independent.  Returns
    (rx, ry, counter)."""
    if scene.sampler in MJITT:
        return sample_mjitt(seed, counter, spp_index, x, y)
    if scene.sampler == "halton" and tables is not None \
            and "halton_offsets" in tables:
        rx, ry = sample_halton(scene.halton_setup, tables["halton_offsets"],
                               spp_index, x, y, scene.width)
        return rx, ry, counter
    rx, counter = rng.next_f32(seed, counter)
    ry, counter = rng.next_f32(seed, counter)
    return rx, ry, counter
