"""Analytic sphere primitives: exact hit and UV, no tessellation.

Counterpart of ignis_tpu/ops/spheres.py, which is plain array code there as
well (no kernel): scenes carry a handful of analytic spheres (the compiler
promotes at most 64), so the sweep is a dense (rays, spheres) quadratic.  The
results are combined with the mesh traversal like the instanced pool's
(`render.integrator._traverse_closest`).

Table layout `sph_rows` (S, 16) f32, built by scene/compile.py:
  [0:3] world center, [3] world radius, [4] entity id, [5] visibility
  maskbits, [6:15] world->local rotation (row-major, for UV orientation),
  [15] pad.

The predicate includes the reference's behind-origin rejection: S < 0, the
center behind the ray origin, is a miss.
"""

from __future__ import annotations

import numpy as np
import torch

_TWO_PI = 2 * np.pi


def sphere_map_uv(dirs):
    """UV from the unit direction: spherical angles of (y, -x, z)."""
    x = dirs[..., 1]
    y = -dirs[..., 0]
    z = dirs[..., 2]
    theta = torch.arccos(torch.clamp(z, -1.0, 1.0))
    phi = torch.atan2(y, x)
    phi = torch.where(phi < 0, phi + _TWO_PI, phi)
    return phi / _TWO_PI, theta / np.pi


def sphere_unmap_uv(u, v):
    """Inverse of `sphere_map_uv`."""
    theta = v * np.pi
    phi = u * _TWO_PI
    st = torch.sin(theta)
    x = st * torch.cos(phi)
    y = st * torch.sin(phi)
    z = torch.cos(theta)
    # spherical gives (x, y, z); the map used (y, -x, z)
    return torch.stack([-y, x, z], dim=-1)


def _hits(tables, org, d, tmin, tmax, mask_bit):
    """(n, S) candidate hit t (inf = miss)."""
    sph = tables["sph_rows"]
    c = sph[:, 0:3]
    r = sph[:, 3]
    vis = (sph[:, 5].to(torch.int32) & int(mask_bit)) != 0       # (S,)

    L = c[None, :, :] - org[:, None, :]                 # (n, S, 3)
    S_ = torch.sum(L * d[:, None, :], dim=-1)           # -dot(org-c, d)
    D2 = torch.sum(d * d, dim=-1)[:, None]
    L2 = torch.sum(L * L, dim=-1)
    R2 = (r * r)[None, :] * D2
    M2 = L2 * D2 - S_ * S_
    miss = (S_ < 0) | (M2 > R2)
    Q = torch.sqrt(torch.clamp_min(R2 - M2, 0.0))
    invD2 = 1.0 / torch.clamp_min(D2, 1e-30)
    t0 = (S_ - Q) * invD2
    t1 = (S_ + Q) * invD2
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    tm = tmin[:, None]
    tcand = torch.where(lo < tm, hi, lo)
    ok = (~miss) & vis[None, :] & (tcand >= tm) & (tcand <= tmax[:, None])
    return torch.where(ok, tcand, torch.full_like(tcand, float("inf")))


_CHUNK = 1 << 16   # dense (rays, spheres) sweep: bound the temporaries


def _ray_args(org, d, tmin, tmax):
    n = org.shape[0]
    f32 = dict(dtype=torch.float32, device=org.device)
    return (org.detach(), d.detach(),
            torch.broadcast_to(torch.as_tensor(tmin, **f32), (n,)).detach(),
            torch.broadcast_to(torch.as_tensor(tmax, **f32), (n,)).detach())


def sphere_closest(tables, org, d, tmin, tmax, mask_bit=0xF):
    """Best sphere hit per ray: (t, u, v, idx); idx = -1 on miss."""
    org, d, tmin, tmax = _ray_args(org, d, tmin, tmax)
    n = org.shape[0]
    if n > _CHUNK:
        outs = [sphere_closest(tables, org[i:i + _CHUNK], d[i:i + _CHUNK],
                               tmin[i:i + _CHUNK], tmax[i:i + _CHUNK],
                               mask_bit)
                for i in range(0, n, _CHUNK)]
        return tuple(torch.cat([o[k] for o in outs]) for k in range(4))
    tc = _hits(tables, org, d, tmin, tmax, mask_bit)
    bt, j = torch.min(tc, dim=1)
    hit = torch.isfinite(bt)
    sph = tables["sph_rows"][j]
    c = sph[:, 0:3]
    r = torch.clamp_min(sph[:, 3], 1e-30)
    rot = sph[:, 6:15].reshape(-1, 3, 3)
    t_safe = torch.where(hit, bt, torch.ones_like(bt))
    p = org + d * t_safe[:, None]
    nrm = (p - c) / r[:, None]
    # UV in SHAPE-LOCAL orientation (the rotation part of the entity
    # transform undone), so textures do not spin with the entity
    nl = torch.einsum("nij,nj->ni", rot, nrm)
    u, v = sphere_map_uv(nl)
    zero = torch.zeros_like(bt)
    return (torch.where(hit, bt, tmax), torch.where(hit, u, zero),
            torch.where(hit, v, zero),
            torch.where(hit, j.to(torch.int32),
                        torch.full_like(j, -1, dtype=torch.int32)))


def sphere_any(tables, org, d, tmin, tmax, mask_bit=0xF):
    """True where any visible sphere blocks the segment."""
    org, d, tmin, tmax = _ray_args(org, d, tmin, tmax)
    n = org.shape[0]
    if n > _CHUNK:
        return torch.cat(
            [sphere_any(tables, org[i:i + _CHUNK], d[i:i + _CHUNK],
                        tmin[i:i + _CHUNK], tmax[i:i + _CHUNK], mask_bit)
             for i in range(0, n, _CHUNK)])
    tc = _hits(tables, org, d, tmin, tmax, mask_bit)
    return torch.isfinite(tc).any(dim=1)


def sphere_area(radius):
    return 4.0 * np.pi * float(radius) ** 2
