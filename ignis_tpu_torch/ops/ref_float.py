"""How the JAX package's traversal kernels compare floats, in PyTorch.

XLA on the CPU flushes subnormal floats to zero and a TPU has none, so where
a JAX kernel tests a float against 0 (a direction component before its
reciprocal, the Moeller-Trumbore determinant, the Baldwin-Weber k) a
subnormal counts as 0.  Eager PyTorch keeps subnormals, so the port's plain
versions make only those tests see them as 0: |x| < FLT_MIN, as the kernels
do (`csrc/ref_float.cuh`).  The slab tests keep NaN with `torch.minimum` /
`torch.maximum`, as `jnp.minimum` / `jnp.maximum` do: a box whose chain holds
a NaN is rejected.
"""

from __future__ import annotations

import numpy as np
import torch

FLT_MIN = float(np.finfo(np.float32).tiny)   # smallest normal float32


def is_zero(x):
    """True where x counts as 0 for the reference: zero or subnormal."""
    return x.abs() < FLT_MIN


def safe_inv(x):
    """1/x with the reference's guard: 1e30 where x counts as 0."""
    z = is_zero(x)
    return torch.where(z, torch.full_like(x, 1e30),
                       1.0 / torch.where(z, torch.ones_like(x), x))
