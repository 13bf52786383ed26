"""The plain reference of the `volpath` technique over a heterogeneous medium
in a passthrough box, lit by a constant sky and a directional sun: what the
`wdas_cloud` configuration renders.

It follows the estimator that the program under test implements, Ignis's
`volpath` technique with delta tracking: camera rays through a uniformly
jittered pixel position; at each vertex in the medium one free flight
against the medium's global majorant (Woodcock / delta tracking), then one
draw that picks absorption, scattering or a null collision with the
probabilities of the density there (Kutz et al. 2017's spectral tracking
weights, here one channel); Henyey-Greenstein scattering; Russian
roulette after each scattering on the largest component of the
throughput, clamped to [0.05, 0.95]; at most `max_scattering` scatterings
a path, after which the path runs to the box's wall with its
transmittance estimated by ratio tracking (Novak et al. 2014, 32 flights
on a salted stream); paths that leave the box see the sky.  Density is
the trilinear interpolation of the raw grid at voxel centres, scaled by
the shader's `scalar_density` (0 below 1e-4).  Each path draws its numbers
from its own counter-based stream (`rng.py`) in the order the program
draws them, so a path here and the same path in the program see the same
numbers, and the two agree path by path up to rounding.

Departures from the published description, each the program's:

* The program samples lights at non-specular surface vertices only.  The
  scene's one surface is the passthrough box, which is specular, so no
  path samples a light: the sun (a delta light) reaches no path, and the
  sky only through paths that leave the box.  `VolScene.from_raw` refuses
  a scene with another surface.
* The Henyey-Greenstein sample is a direction in the world frame, not
  rotated about the direction the path arrived from.
* A null collision ends a wave iteration of the program; its emission and
  sky terms are not added again on the segment's re-trace.  The reference
  traces the same vertices.
* A medium's `max_scattering` below 8 counts as 8: the program takes the
  largest of its media's and 8.
* The ratio tracker's stream is the path's seed xor 0x9E3779B9, starting
  at the path's counter at the start of the vertex; the path's own counter
  does not move.

Everything is plain PyTorch in the dtype given (float32, or bfloat16 for
the control), with TF32 off, and builds on nothing of the program: the
box's triangles and the medium's coefficients are worked out again from
the configuration's raw description (`VolScene.from_raw`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from benchmark.reference import rng
from benchmark.reference.geometry import SoupGeometry
from benchmark.reference.pathtracer import (
    FLT_EPS, OFFSET, SPHERE_PDF, camera_frame, camera_rays, dot, length,
    safe_div,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DENSITY_EPS = 1e-4          # density below which the shader gives 0
RT_FLIGHTS = 32             # flights of the ratio tracker
RT_SALT = 0x9E3779B9        # salt of its stream
LPOS_EPS = 1e-5             # the lookup's margin inside the unit cube
INSIDE_EPS = 1e-5           # the unit cube's margin of "inside"


@dataclass
class VolScene:
    geometry: object
    face_n: torch.Tensor        # (T, 3) unit face normals
    grid: torch.Tensor          # (D, H, W) raw density
    box_min: torch.Tensor
    box_ext: torch.Tensor
    density: float              # scalar_density
    scat: float                 # scalar_scattering
    absorb: float               # scalar_absorption
    majorant: torch.Tensor      # (3,)
    g: float
    max_scattering: int
    max_depth: int
    sky: torch.Tensor           # (3,) the constant sky's radiance
    n_lights: int
    camera: dict
    width: int
    height: int

    @classmethod
    def from_raw(cls, raw, width, height, max_depth):
        verts = np.asarray(raw["vertices"], np.float32)
        faces = np.asarray(raw["faces"], np.int64)
        p0, p1, p2 = (verts[faces[:, k]] for k in range(3))
        v0, e1, e2 = p0, p1 - p0, p2 - p0
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        kinds = [light["type"] for light in raw["lights"]]
        if set(kinds) - {"directional", "env"} or kinds.count("env") != 1:
            raise ValueError("the reference takes one sky and suns only")
        sky = next(light for light in raw["lights"]
                   if light["type"] == "env")["radiance"]
        f32 = lambda v: float(np.float32(v))
        grid = np.asarray(raw["grid"], np.float32)
        # the majorant: the shader at the grid's largest value
        dmax = np.float32(grid.max())
        dens = (dmax * np.float32(raw["scalar_density"])
                if dmax > DENSITY_EPS else np.float32(0.0))
        maj = np.full(3, dens * np.float32(raw["scalar_scattering"])
                      + dens * np.float32(raw["scalar_absorption"]),
                      np.float32)
        bmin = np.asarray(raw["box_min"], np.float32)
        ext = np.asarray(raw["box_max"], np.float32) - bmin
        return cls(geometry=SoupGeometry(t(v0), t(e1), t(e2)),
                   face_n=_unit(t(np.cross(e1, e2))),
                   grid=t(grid), box_min=t(bmin), box_ext=t(ext),
                   density=f32(raw["scalar_density"]),
                   scat=f32(raw["scalar_scattering"]),
                   absorb=f32(raw["scalar_absorption"]),
                   majorant=t(maj), g=f32(raw["g"]),
                   max_scattering=max(int(raw["max_scattering"]), 8),
                   max_depth=int(max_depth),
                   sky=torch.tensor(sky, dtype=torch.float32),
                   n_lights=len(kinds),
                   camera=camera_frame(raw["camera"], width, height),
                   width=int(width), height=int(height))

    def to(self, device, dtype=torch.float32):
        f = lambda a: a.to(device=device, dtype=dtype)
        return replace(self, geometry=self.geometry.to(device, dtype),
                       face_n=f(self.face_n), grid=f(self.grid),
                       box_min=f(self.box_min), box_ext=f(self.box_ext),
                       majorant=f(self.majorant), sky=f(self.sky))


def _unit(v):
    return v * safe_div(1.0, length(v))[..., None]


# ---------------------------------------------------------------- the medium
def local(sc, p):
    """World points -> the box's unit cube."""
    return (p - sc.box_min) / torch.clamp_min(sc.box_ext, 1e-20)


def inside(lp):
    return torch.all((lp >= -INSIDE_EPS) & (lp <= 1.0 + INSIDE_EPS), dim=-1)


def lookup(sc, lp):
    """Trilinear density at unit-cube points, over voxel centres, indices
    clamped to the grid."""
    d, h, w = sc.grid.shape
    dims = torch.tensor([w, h, d], dtype=lp.dtype, device=lp.device)
    p = lp * dims - 0.5
    i0 = torch.floor(p)
    f = p - i0
    i0 = i0.long()
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ix = torch.clamp(i0[..., 0] + dx, 0, w - 1)
                iy = torch.clamp(i0[..., 1] + dy, 0, h - 1)
                iz = torch.clamp(i0[..., 2] + dz, 0, d - 1)
                wx = f[..., 0] if dx else 1.0 - f[..., 0]
                wy = f[..., 1] if dy else 1.0 - f[..., 1]
                wz = f[..., 2] if dz else 1.0 - f[..., 2]
                out = out + sc.grid[iz, iy, ix] * (wx * wy * wz)
    return out


def coefficients(sc, p):
    """(sigma_s, sigma_a), each (n,), of the medium at world points: the
    monochromatic shader on the interpolated density."""
    lp = torch.clamp(local(sc, p), LPOS_EPS, 1.0 - LPOS_EPS)
    dens = lookup(sc, lp)
    dens = torch.where(dens > DENSITY_EPS, dens * sc.density,
                       torch.zeros_like(dens))
    return dens * sc.scat, dens * sc.absorb


def ratio_transmittance(sc, p0, p1, seed, counter):
    """Ratio tracking along [p0, p1] on the path's salted stream."""
    seg = p1 - p0
    dist = length(seg)
    dirn = seg * safe_div(1.0, dist)[..., None]
    mu = torch.clamp_min(sc.majorant.max(), 1e-6)
    t = torch.zeros_like(dist)
    tr = torch.ones_like(p0)
    salted = seed ^ RT_SALT
    c = counter
    for _ in range(RT_FLIGHTS):
        u, c = rng.uniform(salted, c)
        u = u.to(dist.dtype)
        t = t - torch.log(torch.clamp_min(1.0 - u * 0.99999, 1e-30)) / mu
        on = t < dist
        pos = p0 + dirn * t[..., None]
        ss, sa = coefficients(sc, pos)
        ext = torch.where(inside(local(sc, pos)), ss + sa,
                          torch.zeros_like(ss))
        f = torch.clamp(1.0 - ext / mu, 0.0, 1.0)
        tr = torch.where(on[..., None], tr * f[..., None], tr)
    return tr


def hg_sample(g, u1, u2):
    """A Henyey-Greenstein direction about +z of the world frame (`g` a
    0-d tensor of the dtype)."""
    den = 1.0 + g - 2.0 * g * u1
    den = torch.where(torch.abs(den) > 1e-6, den, torch.full_like(den, 1e-6))
    sqr = (1.0 - g * g) / den
    cos_t = -(1.0 + g * g - sqr * sqr) / (2.0 * g)
    s2 = 1.0 - cos_t * cos_t
    sin_t = torch.where(s2 > 0, torch.sqrt(torch.clamp_min(s2, 0.0)),
                        torch.zeros_like(s2))
    phi = 2.0 * math.pi * u2
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], -1)


def _inv(p):
    ok = p > 1e-6
    return torch.where(ok, 1.0 / torch.where(ok, p, torch.ones_like(p)),
                       torch.zeros_like(p))


# ---------------------------------------------------------------- the path
def _vertex(sc, st):
    """One vertex of every lane of `st`: the radiance it adds, and the next
    state."""
    org, d, alive = st["org"], st["dir"], st["alive"]
    seed, counter = st["seed"], st["counter"]
    contrib, inv_pdf, med = st["contrib"], st["inv_pdf"], st["medium"]
    voldepth, fresh = st["voldepth"], ~st["nullfl"]
    dt = org.dtype
    zero = torch.zeros((), dtype=dt, device=org.device)

    with torch.no_grad():
        t, _u, _v, prim = sc.geometry.closest(org, d, st["tmin"], st["tmax"])
    hit = alive & (prim >= 0)
    miss = alive & ~hit
    t_safe = torch.where(hit, t, torch.ones_like(t))
    point = org + d * t_safe[..., None]
    face_n = sc.face_n[torch.clamp_min(prim, 0)]
    entering = dot(d, face_n) <= 0.0
    in_med = med >= 0

    # leaving for the sky: outside the medium only (in it the
    # transmittance to infinity is 0)
    mis = 1.0 / (1.0 + torch.clamp_min(inv_pdf, 0.0)
                 * (1.0 / sc.n_lights) * SPHERE_PDF)
    sky = contrib * sc.sky * mis[..., None]
    splat = torch.where((miss & fresh & ~in_med)[..., None], sky, zero)

    # a free flight against the majorant, from inside the box
    can = hit & (st["depth"] + 1 <= sc.max_depth)
    allow = voldepth + 1 <= sc.max_scattering
    u, c_u = rng.uniform(seed, counter)
    one_m_u = 1.0 - u.to(dt) * 0.99999
    seg = point - org
    dist = length(seg)
    dunit = seg * safe_div(1.0, dist)[..., None]
    mu = sc.majorant.max()
    draws = in_med & can & allow & inside(local(sc, org))
    sampled = -torch.log(torch.clamp_min(one_m_u, 1e-30)) / mu
    valid = draws & (sampled < dist) & (mu > FLT_EPS)
    counter = torch.where(draws, c_u, counter)
    pos = org + dunit * sampled[..., None]
    ss, sa = coefficients(sc, pos)
    sn = torch.clamp_min(mu - (ss + sa), 0.0)
    pdf = one_m_u * mu
    color = torch.exp(-mu * sampled) * torch.where(
        pdf > 1e-20, 1.0 / torch.where(pdf > 1e-20, pdf, 1.0), zero)

    # the event: absorption, scattering or a null collision
    mu_t = torch.clamp_min(sa + ss + sn, 1e-30)
    p_a = torch.where(sa <= FLT_EPS, zero, sa / mu_t)
    p_s = torch.where(ss <= FLT_EPS, zero, ss / mu_t)
    p_f = torch.clamp_min(1.0 - p_a - p_s, 0.0)
    r_ev, c_ev = rng.uniform(seed, counter)
    r_ev = r_ev.to(dt)
    counter = torch.where(valid, c_ev, counter)
    absorb = valid & (r_ev < p_a)
    scatter = valid & ~absorb & (r_ev < p_a + p_s)
    null = valid & ~absorb & ~scatter

    # scattering: a Henyey-Greenstein direction, then Russian roulette
    u1, c1 = rng.uniform(seed, counter)
    u2, c2 = rng.uniform(seed, c1)
    counter = torch.where(scatter, c2, counter)
    g = torch.tensor(sc.g, dtype=dt, device=org.device)
    ph_dir = hg_sample(g, u1.to(dt), u2.to(dt))
    contrib_m = contrib * (color * ss * _inv(p_s))[..., None]
    rr = torch.clamp(torch.amax(contrib_m, dim=-1), 0.05, 0.95)
    u_rr, c_rr = rng.uniform(seed, counter)
    counter = torch.where(scatter, c_rr, counter)
    scatter_alive = scatter & (u_rr.to(dt) < rr)

    # the wall: straight through, into the box's medium or out of it; a
    # path past its last scattering carries the transmittance to the wall
    wall = can & ~valid
    tr = torch.ones_like(contrib)
    late = wall & in_med & ~allow
    if bool(late.any()):
        k = late.nonzero()[:, 0]
        tr[k] = ratio_transmittance(sc, org[k], point[k], seed[k],
                                    st["counter"][k])
    contrib_s = contrib * tr
    # the wall's roulette: a specular surface keeps the path with
    # probability 1, but takes its number
    _u_s, c_s = rng.uniform(seed, counter)
    counter = torch.where(wall, c_s, counter)
    med_s = torch.where(entering, torch.zeros_like(med),
                        torch.full_like(med, -1))

    null_contrib = (contrib * color[..., None] * sn[..., None]
                    * _inv(p_f)[..., None])
    alive_next = scatter_alive | wall | null
    med_ev = scatter_alive | null
    an, anc = alive_next, alive_next[..., None]
    contrib_next = torch.where(
        scatter_alive[..., None], contrib_m * safe_div(1.0, rr)[..., None],
        torch.where(null[..., None], null_contrib, contrib_s))
    dir_next = torch.where(scatter_alive[..., None], ph_dir, d)
    nxt = dict(
        org=torch.where(anc, torch.where(med_ev[..., None], pos, point), org),
        dir=torch.where(anc, dir_next, d),
        tmin=torch.where(an, torch.where(med_ev, zero, OFFSET), st["tmin"]),
        tmax=torch.where(an, torch.full_like(t, torch.finfo(dt).max),
                         st["tmax"]),
        alive=an, seed=seed, counter=counter,
        inv_pdf=torch.where(an, torch.where(med_ev, -1.0, 0.0).to(dt),
                            inv_pdf),
        contrib=torch.where(anc, contrib_next, contrib),
        depth=st["depth"],
        medium=torch.where(an & ~med_ev, med_s, med),
        voldepth=torch.where(
            an, torch.where(scatter_alive, voldepth + 1,
                            torch.where(null, voldepth,
                                        torch.zeros_like(voldepth))),
            voldepth),
        nullfl=null & an)
    return torch.where(alive[..., None], splat, zero), nxt


def radiance(sc, x, y, iteration, user_seed, sample=0, frame=0,
             dtype=torch.float32):
    """Per-lane radiance of the camera paths through pixels (x, y), each
    traced until it ends; ended lanes are dropped as they go."""
    n = x.shape[0]
    dev = x.device
    seed, counter, org, d = camera_rays(sc, x, y, sample, iteration, frame,
                                        user_seed, dtype)
    st = dict(org=org, dir=d, tmin=torch.zeros(n, dtype=dtype, device=dev),
              tmax=torch.full((n,), torch.finfo(dtype).max, dtype=dtype,
                              device=dev),
              alive=torch.ones(n, dtype=torch.bool, device=dev),
              seed=seed, counter=counter,
              inv_pdf=torch.zeros(n, dtype=dtype, device=dev),
              contrib=torch.ones((n, 3), dtype=dtype, device=dev),
              depth=torch.ones(n, dtype=torch.int64, device=dev),
              medium=torch.full((n,), -1, dtype=torch.int64, device=dev),
              voldepth=torch.zeros(n, dtype=torch.int64, device=dev),
              nullfl=torch.zeros(n, dtype=torch.bool, device=dev))
    accum = torch.zeros((n, 3), dtype=dtype, device=dev)
    lane = torch.arange(n, device=dev)
    with torch.no_grad():
        while True:
            alive = st["alive"]
            n_alive = int(alive.sum())
            if n_alive == 0:
                return accum
            if n_alive * 2 < lane.shape[0]:
                keep = alive.nonzero()[:, 0]
                st = {k: v[keep] for k, v in st.items()}
                lane = lane[keep]
            splat, st = _vertex(sc, st)
            accum.index_add_(0, lane, splat)
