"""Counter-based random numbers of the renderer, written out again for the
reference: an FNV-1a hash of (sample, iteration, frame, x, y, user seed)
seeds each path, and a 4-round TEA block cipher over (seed, counter) draws
its numbers, the counter advancing by one a draw.  These are the published
rules of Ignis (`core/random.art`), which the program under test follows;
nothing here is imported from it.

uint32 values travel in int64 tensors, masked after every operation.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_FNV_INIT = 0x811C9DC5
_FNV_PRIME = 16777619


def u32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return int(x) & M32


def _fnv(h, d):
    h, d = u32(h), u32(d)
    for shift in (0, 8, 16, 24):
        h = ((h * _FNV_PRIME) & M32) ^ ((d >> shift) & 0xFF)
    return h


def path_seed(sample, iteration, frame, x, y, user):
    h = _FNV_INIT
    for d in (sample, iteration, frame, x, y, user):
        h = _fnv(h, d)
    return h


def tea(v0, v1):
    v0, v1 = u32(v0), u32(v1)
    total = 0
    for _ in range(4):
        total = (total + 0x9E3779B9) & M32
        v0 = (v0 + (((v1 << 4) + 0xA341316C) ^ (v1 + total)
                    ^ ((v1 >> 5) + 0xC8013EA4))) & M32
        v1 = (v1 + (((v0 << 4) + 0xAD90777D) ^ (v0 + total)
                    ^ ((v0 >> 5) + 0x7E95761E))) & M32
    return v1


def uniform(seed, counter):
    """A float in [0, 1) from 23 bits, and the next counter."""
    bits = tea(seed, counter)
    f = ((bits & 0x7FFFFF) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    return f, (counter + 1) & M32


def uniform_int(seed, counter, hi, active):
    """A uniform integer in [0, hi] by scaled division with redraws on the
    biased tail; lanes outside `active` draw nothing and read 0."""
    erange = hi + 1
    scaling = M32 // erange
    past = (erange * scaling) & M32
    ret = torch.zeros_like(counter)
    pending = active
    while True:
        bits = tea(seed, counter)
        ret = torch.where(pending, bits, ret)
        counter = torch.where(pending, (counter + 1) & M32, counter)
        pending = pending & (ret >= past)
        if not bool(pending.any()):
            break
    return torch.where(active, ret // scaling, torch.zeros_like(ret)), counter
