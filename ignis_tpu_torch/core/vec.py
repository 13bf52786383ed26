"""Vector helpers over stacked tensors of shape (..., 3) / (..., 2).

Counterpart of ignis_tpu/core/vec.py: the last axis is the component axis and
every leading axis is a ray/sample lane.  Constants are Python floats holding
exact float32 values, so `tensor * CONST` rounds as the reference does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ignis_tpu_torch.utils.stats import host_tensor

FLT_EPS = float(np.float32(1.1920928955078125e-07))  # 2^-23
FLT_MAX = float(np.float32(3.4028234663852886e38))
FLT_INF = float("inf")
PI = float(np.float32(3.14159265358979323846))
INV_PI = float(np.float32(1.0 / 3.14159265358979323846))


def _as_f32(x, like):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _stack(*comps):
    like = next(c for c in comps if isinstance(c, torch.Tensor))
    comps = torch.broadcast_tensors(*[_as_f32(c, like) for c in comps])
    return torch.stack(comps, dim=-1)


def vec3(x, y, z):
    return _stack(x, y, z)


def vec2(x, y):
    return _stack(x, y)


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def length2(a):
    return dot(a, a)


def _sqrt_or_zero(a):
    """sqrt(a) where a > 0, else 0: the value of sqrt(max(a, 0)), with a
    zero gradient where a <= 0.  A plain sqrt's infinite slope at 0 (or the
    clamp's 0 times it) would reach the gradient as NaN, also from lanes
    that a `where` drops."""
    pos = ~(a <= 0)  # NaN stays NaN
    root = torch.sqrt(torch.where(pos, a, device_scalar(1.0, a.device)))
    return torch.where(pos, root, device_scalar(0.0, a.device))


def length(a):
    return _sqrt_or_zero(length2(a))


def normalize(a):
    return a * safe_div(1.0, length(a))[..., None]


def safe_div(a, b):
    """a/b with 0 where b == 0."""
    zero = b == 0
    return torch.where(zero, torch.zeros_like(b),
                       a / torch.where(zero, torch.ones_like(b), b))


def safe_sqrt(a):
    return _sqrt_or_zero(a)


def signbit(a):
    return torch.signbit(a)


def reflect(v, n):
    """Mirror v at n; v points away from the surface."""
    return 2.0 * dot(n, v)[..., None] * n - v


def refract(v, n, eta, cos_i, cos_t):
    """Refraction direction given precomputed cosines; v points away from the
    surface, eta = n1/n2 on the v side, cos_t is the signed transmitted
    cosine from `fresnel`."""
    return n * (eta * cos_i - cos_t)[..., None] - v * eta[..., None]


def lerp2(a, b, c, u, v):
    """Barycentric interpolation a*(1-u-v) + b*u + c*v."""
    w = (1.0 - u - v)[..., None]
    return a * w + b * u[..., None] + c * v[..., None]


def mulf(a, f):
    return a * f[..., None]


def luminance(c):
    return (c[..., 0] * float(np.float32(0.2126))
            + c[..., 1] * float(np.float32(0.7152))
            + c[..., 2] * float(np.float32(0.0722)))


def max_component(c):
    return torch.amax(c, dim=-1)


def orthonormal_basis(n):
    """Duff et al. branchless ONB.  Returns (t, b) with columns (t, b, n)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0, 1.0, -1.0).to(torch.float32)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = vec3(1.0 + sign * nx * nx * a, sign * b, -sign * nx)
    bt = vec3(b, sign + ny * ny * a, -ny)
    return t, bt


def to_world(local_dir, t, b, n):
    """Transform a local (tangent-space) direction to world given ONB columns."""
    return (t * local_dir[..., 0:1]
            + b * local_dir[..., 1:2]
            + n * local_dir[..., 2:3])


def to_local(world_dir, t, b, n):
    return vec3(dot(world_dir, t), dot(world_dir, b), dot(world_dir, n))


def positive_cos(a, b):
    return torch.clamp_min(dot(a, b), 0.0)


def absolute_cos(a, b):
    return torch.abs(dot(a, b))


def transform_point(m, p):
    """Apply (..., 3, 4) affine matrix to points (..., 3)."""
    return torch.einsum('...ij,...j->...i', m[..., :3], p) + m[..., 3]


def transform_vector(m, v):
    return torch.einsum('...ij,...j->...i', m[..., :3], v)


def transform_normal(nm, n):
    """Apply (..., 3, 3) normal matrix (inverse-transpose of linear part)."""
    return torch.einsum('...ij,...j->...i', nm, n)


@functools.lru_cache(maxsize=None)
def device_const(x, dtype, device):
    """A tensor of `x` (a number or nested tuples) on `device`, made once: a
    Python number given to `torch.where` is made on the device anew (a
    launch) at every call, and a table made per call reaches a CUDA device
    by a blocking copy, a host sync, every time (`utils.stats.host_tensor`
    counts the one made here)."""
    return host_tensor(x, dtype, device)


def device_scalar(x, device):
    """A 0-d float32 `device_const`."""
    return device_const(x, torch.float32, device)


_I32_MAX = 2147483647
_F32_BELOW_2_31 = 2147483520.0  # the largest float32 below 2^31


def to_int32(x):
    """float -> int32 as XLA converts: NaN -> 0, truncation toward zero,
    saturating at the int32 range (a plain `.to(torch.int32)` is undefined
    outside it and gives -2^31 on the CPU for NaN and +-inf alike)."""
    xs = torch.nan_to_num(x, nan=0.0, posinf=_F32_BELOW_2_31,
                          neginf=-2147483648.0)
    xs = torch.clamp(xs, -2147483648.0, _F32_BELOW_2_31)
    return torch.where(x >= 2147483648.0,
                       device_const(_I32_MAX, torch.int32, x.device),
                       xs.to(torch.int32))


@functools.lru_cache(maxsize=None)
def _host_scalar(x):
    return torch.tensor(x, dtype=torch.float32)


def _operand(x):
    # a Python number becomes a 0-d float32 tensor on the host, which PyTorch
    # takes as a scalar beside a tensor on any device: no launch, no copy
    if isinstance(x, torch.Tensor):
        return x
    return _host_scalar(float(x))


def maximum(a, b):
    """Elementwise max whose gradient splits at a tie, as `jnp.maximum`'s
    does (`torch.clamp_min` routes all of it to the input)."""
    return torch.maximum(_operand(a), _operand(b))


def minimum(a, b):
    """Elementwise min, gradient split at a tie (`jnp.minimum`)."""
    return torch.minimum(_operand(a), _operand(b))


def clip(x, lo=None, hi=None):
    """`jnp.clip`: max with `lo`, then min with `hi`, each tie split."""
    if lo is not None:
        x = maximum(x, lo)
    if hi is not None:
        x = minimum(x, hi)
    return x


def ipow(x, n):
    """x ** n for a positive integer n by the square-and-multiply order of
    XLA's `integer_pow`, so the rounding is the JAX package's."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc
