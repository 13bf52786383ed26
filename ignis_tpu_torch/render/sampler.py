"""Pixel samplers.  Counterpart of ignis_tpu/render/sampler.py; only the
independent (uniform) sampler is ported, `mjitt` and `halton` raise."""

from __future__ import annotations

from ignis_tpu_torch.core import rng

INDEPENDENT = ("independent", "uniform")


def sample_pixel(sampler, seed, counter):
    """Two pixel-jitter draws; returns (rx, ry, counter)."""
    if sampler not in INDEPENDENT:
        raise NotImplementedError(
            f"sampler '{sampler}' is not ported to ignis_tpu_torch yet")
    rx, counter = rng.next_f32(seed, counter)
    ry, counter = rng.next_f32(seed, counter)
    return rx, ry, counter
