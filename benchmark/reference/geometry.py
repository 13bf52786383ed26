"""Ray queries of the reference: the closest hit and occlusion of rays
against a triangle soup, written plainly (Moeller-Trumbore) and with no
acceleration structure of the program under test.

`SoupGeometry` tests every ray against every triangle.  `SierpinskiGeometry`
walks the tetra pyramid's own recursion (each cube of the octree holds its
tetrahedron's four half-size corner tetrahedra in four of its eight
octants) level by level, pairs of (ray, cube) that pass a slab test, and
tests the four triangles of each leaf cube it reaches.  Both take rays of
any float dtype and answer in that dtype; `closest` returns (t, u, v, prim)
with prim -1 on a miss, `occluded` a bool per ray.
"""

from __future__ import annotations

import torch

EDGE_TOL = 1.1920928955078125e-07   # barycentric slack at edges (FLT_EPS)
RAY_CHUNK = 1 << 15


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    return (a * b).sum(-1)


def moeller_trumbore(org, d, v0, e1, e2, tmin, tmax):
    """Rays (..., 3) against triangles (..., 3), broadcast: (hit, t, u, v)."""
    p = _cross(d, e2)
    det = _dot(e1, p)
    ok = det != 0
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    s = org - v0
    u = _dot(s, p) * inv
    q = _cross(s, e1)
    v = _dot(d, q) * inv
    t = _dot(e2, q) * inv
    hit = (ok & (u >= -EDGE_TOL) & (v >= -EDGE_TOL)
           & (u + v <= 1.0 + EDGE_TOL) & (t >= tmin) & (t <= tmax))
    return hit, t, u, v


def _pick_closest(hit, t, u, v, prim):
    """Per ray (rows of `hit`), the nearest hit and its lowest prim id."""
    inf = torch.full_like(t, float("inf"))
    tt = torch.where(hit, t, inf)
    best = tt.min(dim=1, keepdim=True).values
    first = (tt == best) & hit
    idx = torch.where(first, prim, torch.full_like(prim, 1 << 62))
    k = idx.argmin(dim=1, keepdim=True)
    any_hit = hit.any(dim=1)
    take = lambda a: a.gather(1, k)[:, 0]
    return (any_hit, take(tt), take(u), take(v),
            torch.where(any_hit, take(idx), torch.full_like(any_hit, -1,
                                                            dtype=torch.int64)))


class SoupGeometry:
    """Every ray against every triangle: for soups of a few dozen."""

    def __init__(self, v0, e1, e2):
        self.v0, self.e1, self.e2 = v0, e1, e2

    def to(self, device, dtype):
        return SoupGeometry(*(a.to(device=device, dtype=dtype)
                              for a in (self.v0, self.e1, self.e2)))

    def closest(self, org, d, tmin, tmax):
        outs = [self._closest(*(a[i:i + RAY_CHUNK] for a in (org, d, tmin,
                                                              tmax)))
                for i in range(0, org.shape[0], RAY_CHUNK)]
        return tuple(torch.cat(x) for x in zip(*outs))

    def _closest(self, org, d, tmin, tmax):
        n = org.shape[0]
        hit, t, u, v = moeller_trumbore(
            org[:, None], d[:, None], self.v0[None], self.e1[None],
            self.e2[None], tmin[:, None], tmax[:, None])
        prim = torch.arange(self.v0.shape[0], device=org.device)[None].expand(
            n, -1)
        ok, bt, bu, bv, bi = _pick_closest(hit, t, u, v, prim)
        return torch.where(ok, bt, tmax), bu, bv, bi

    def occluded(self, org, d, tmin, tmax):
        return torch.cat([
            moeller_trumbore(o[:, None], dd[:, None], self.v0[None],
                             self.e1[None], self.e2[None], a[:, None],
                             b[:, None])[0].any(dim=1)
            for o, dd, a, b in (
                (x[i:i + RAY_CHUNK] for x in (org, d, tmin, tmax))
                for i in range(0, org.shape[0], RAY_CHUNK))])


# the four octants of a cube that hold its corner tetrahedra, and so the
# four corners of a leaf tetrahedron: the even-parity signs
PARITY_EVEN = ((1, 1, 1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1))
LEAF_FACES = ((0, 1, 2), (0, 3, 1), (0, 2, 3), (1, 3, 2))


class SierpinskiGeometry:
    """The tetra pyramid of `levels` levels inside the cube [-1, 1]^3: leaf
    `l`, numbered by its base-4 path from the root (first digit most
    significant), holds triangles 4 l .. 4 l + 3 of (v0, e1, e2)."""

    def __init__(self, v0, e1, e2, levels):
        self.v0, self.e1, self.e2 = v0, e1, e2
        self.levels = int(levels)

    def to(self, device, dtype):
        return SierpinskiGeometry(*(a.to(device=device, dtype=dtype)
                                    for a in (self.v0, self.e1, self.e2)),
                                  self.levels)

    def _leaf_pairs(self, org, d, tmin, tmax):
        """(ray, leaf) pairs whose cube the ray's window crosses.  The cubes
        are tested in float32, padded by a relative 1e-6, whatever the
        dtype of the triangle tests."""
        dev = org.device
        o32, d32 = org.float(), d.float()
        inv = 1.0 / torch.where(d32 == 0, torch.full_like(d32, 1e-30), d32)
        lo_t, hi_t = tmin.float(), tmax.float()
        signs = torch.tensor(PARITY_EVEN, dtype=torch.float32, device=dev)
        ray = torch.arange(org.shape[0], device=dev)
        leaf = torch.zeros_like(ray)
        center = torch.zeros((org.shape[0], 3), device=dev)
        half = 1.0

        def crosses(ray, center, half):
            ext = half * (1.0 + 1e-6)
            t0 = (center - ext - o32[ray]) * inv[ray]
            t1 = (center + ext - o32[ray]) * inv[ray]
            near = torch.maximum(torch.minimum(t0, t1).amax(-1), lo_t[ray])
            far = torch.minimum(torch.maximum(t0, t1).amin(-1), hi_t[ray])
            return near <= far

        keep = crosses(ray, center, half)
        ray, leaf, center = ray[keep], leaf[keep], center[keep]
        for _ in range(self.levels):
            half *= 0.5
            ray = ray.repeat_interleave(4)
            leaf = (leaf.repeat_interleave(4) * 4
                    + torch.arange(4, device=dev).repeat(leaf.shape[0]))
            center = (center.repeat_interleave(4, dim=0)
                      + half * signs.repeat(center.shape[0], 1))
            keep = crosses(ray, center, half)
            ray, leaf, center = ray[keep], leaf[keep], center[keep]
        return ray, leaf

    def _pair_tests(self, org, d, tmin, tmax):
        ray, leaf = self._leaf_pairs(org, d, tmin, tmax)
        ray = ray.repeat_interleave(4)
        prim = (leaf.repeat_interleave(4) * 4
                + torch.arange(4, device=org.device).repeat(leaf.shape[0]))
        hit, t, u, v = moeller_trumbore(org[ray], d[ray], self.v0[prim],
                                        self.e1[prim], self.e2[prim],
                                        tmin[ray], tmax[ray])
        return ray[hit], prim[hit], t[hit], u[hit], v[hit]

    def closest(self, org, d, tmin, tmax):
        outs = [self._closest(*(a[i:i + RAY_CHUNK] for a in (org, d, tmin,
                                                              tmax)))
                for i in range(0, org.shape[0], RAY_CHUNK)]
        return tuple(torch.cat(x) for x in zip(*outs))

    def _closest(self, org, d, tmin, tmax):
        n = org.shape[0]
        ray, prim, t, u, v = self._pair_tests(org, d, tmin, tmax)
        inf = torch.full((n,), float("inf"), dtype=t.dtype, device=t.device)
        best = inf.scatter_reduce(0, ray, t, "amin")
        first = t == best[ray]
        big = torch.full((n,), 1 << 62, dtype=torch.int64, device=t.device)
        pid = big.scatter_reduce(0, ray[first], prim[first], "amin")
        won = first & (prim == pid[ray])
        out_t = tmax.clone()
        out_u = torch.zeros_like(tmax)
        out_v = torch.zeros_like(tmax)
        out_i = torch.full((n,), -1, dtype=torch.int64, device=t.device)
        out_t[ray[won]] = t[won]
        out_u[ray[won]] = u[won]
        out_v[ray[won]] = v[won]
        out_i[ray[won]] = prim[won]
        return out_t, out_u, out_v, out_i

    def occluded(self, org, d, tmin, tmax):
        occ = []
        for i in range(0, org.shape[0], RAY_CHUNK):
            o, dd, a, b = (x[i:i + RAY_CHUNK] for x in (org, d, tmin, tmax))
            ray = self._pair_tests(o, dd, a, b)[0]
            hit = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
            hit[ray] = True
            occ.append(hit)
        return torch.cat(occ)
