"""The plain reference of the `path` technique over diffuse triangle soups
lit by a rectangular area light, point lights and a constant environment:
what the benchmark's configurations use.

It follows the published Ignis `path` technique (`technique/path.art`), the
estimator that the program under test implements: camera rays through a
uniformly jittered pixel position; at each hit, emission weighted by the
balance heuristic against next-event estimation; next-event estimation of
one light chosen uniformly (spherical-rectangle sampling for a rectangle,
Urena et al. 2013; the point itself for a point light; equal-area sphere
directions for the environment) with a shadow ray; a cosine-weighted
diffuse bounce; Russian roulette after `min_depth` on the largest component
of the throughput, clamped to [0.05, 0.95].  Each path draws its numbers
from its own counter-based stream (`rng.py`) in the order that technique
draws them, so a path here and the same path in the program see the same
numbers, and the two agree path by path up to rounding.

Everything is plain PyTorch in the dtype given (float32, or bfloat16 for
the control) and builds on nothing of the program: the triangles, normals,
light frame and camera frame are worked out again from the configuration's
raw geometry (`RefScene.from_raw`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from benchmark.reference import rng
from benchmark.reference.geometry import SierpinskiGeometry, SoupGeometry

FLT_EPS = float(np.float32(1.1920928955078125e-07))
PI = float(np.float32(math.pi))
INV_PI = float(np.float32(1.0 / math.pi))
INV_PI64 = 1.0 / 3.14159265358979323846
SPHERE_PDF = 1.0 / (4.0 * 3.14159265358979323846)
OFFSET = float(np.float32(0.001))     # ray origin offset of every bounce
PLANE, POINT, ENV = "plane", "point", "env"
# random numbers a light's direct sample takes
LIGHT_DRAWS = {PLANE: 2, POINT: 0, ENV: 2}


# ------------------------------------------------------------ vector helpers
def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _sqrt0(a):
    pos = ~(a <= 0)
    one = torch.ones((), dtype=a.dtype, device=a.device)
    return torch.where(pos, torch.sqrt(torch.where(pos, a, one)),
                       torch.zeros((), dtype=a.dtype, device=a.device))


def length(a):
    return _sqrt0(dot(a, a))


def safe_div(a, b):
    zero = b == 0
    return torch.where(zero, torch.zeros_like(b),
                       a / torch.where(zero, torch.ones_like(b), b))


def normalize(a):
    return a * safe_div(1.0, length(a))[..., None]


def safe_len(v):
    return torch.sqrt(torch.clamp_min(torch.sum(v * v, dim=-1), 1e-24))


def onb(n):
    """Duff et al.'s branchless frame around the unit vector n."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], -1)
    return t, bt


# ------------------------------------------------------------------ scene
@dataclass
class RefScene:
    geometry: object
    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    tri_mat: torch.Tensor
    tri_light: torch.Tensor
    kd: torch.Tensor            # (M, 3) diffuse reflectances
    light_data: torch.Tensor    # (L, 32) rows, laid out as documented below
    light_types: tuple
    camera: dict
    width: int
    height: int
    max_depth: int
    min_depth: int
    scene_radius: float

    # light rows: plane = origin[0:3], x axis[3:6], y axis[6:9],
    # normal[9:12], area[12], radiance[13:16]; point = position[0:3],
    # intensity[3:6]; env = radiance[0:3], identity[3:12]

    @classmethod
    def from_raw(cls, raw, width, height, max_depth):
        """The scene from a configuration's raw geometry (`raw`: the
        builder's `reference` dict of numpy arrays and numbers)."""
        verts = np.asarray(raw["vertices"], np.float32)
        faces = np.asarray(raw["faces"], np.int64)
        p0, p1, p2 = (verts[faces[:, k]] for k in range(3))
        v0, e1, e2 = p0, p1 - p0, p2 - p0
        # flat normals, normalised once from the cross product and twice
        # more, as a mesh loader that renormalises what it is given does
        fn = np.cross(e1, e2)
        for _ in range(3):
            ln = np.linalg.norm(fn, axis=-1, keepdims=True)
            fn = np.where(ln < 1e-20, np.float32([0, 0, 1]),
                          fn / np.maximum(ln, 1e-20)).astype(np.float32)
        lights, types = [], []
        for light in raw["lights"]:
            row = np.zeros(32, np.float32)
            if light["type"] == PLANE:
                quad = verts[faces[light["faces"]].reshape(-1)]
                o, xa, ya, nrm, area = detect_plane(quad)
                row[0:3], row[3:6], row[6:9], row[9:12] = o, xa, ya, nrm
                row[12], row[13:16] = area, light["radiance"]
            elif light["type"] == POINT:
                row[0:3], row[3:6] = light["position"], light["intensity"]
            else:
                row[0:3] = light["radiance"]
                row[3:12] = np.eye(3, dtype=np.float32).reshape(-1)
            lights.append(row)
            types.append(light["type"])
        tri_light = np.full(faces.shape[0], -1, np.int64)
        for i, light in enumerate(raw["lights"]):
            if light["type"] == PLANE:
                tri_light[np.asarray(light["faces"])] = i
        pts = np.concatenate([v0, v0 + e1, v0 + e2])
        radius = float(np.linalg.norm(pts.max(0) - pts.min(0)) * 0.5)
        t = lambda a, dt=torch.float32: torch.from_numpy(
            np.ascontiguousarray(a)).to(dt)
        geo = (SierpinskiGeometry(t(v0), t(e1), t(e2), raw["levels"])
               if raw.get("levels") else SoupGeometry(t(v0), t(e1), t(e2)))
        return cls(geometry=geo, v0=t(v0), e1=t(e1), e2=t(e2), n0=t(fn),
                   n1=t(fn), n2=t(fn), tri_mat=t(raw["tri_mat"], torch.int64),
                   tri_light=t(tri_light, torch.int64),
                   kd=t(np.asarray(raw["kd"], np.float32)),
                   light_data=t(np.stack(lights)), light_types=tuple(types),
                   camera=camera_frame(raw["camera"], width, height),
                   width=int(width), height=int(height),
                   max_depth=int(max_depth), min_depth=2,
                   scene_radius=radius)

    def to(self, device, dtype=torch.float32):
        f = lambda a: a.to(device=device, dtype=dtype)
        return replace(self, geometry=self.geometry.to(device, dtype),
                       v0=f(self.v0), e1=f(self.e1), e2=f(self.e2),
                       n0=f(self.n0), n1=f(self.n1), n2=f(self.n2),
                       tri_mat=self.tri_mat.to(device),
                       tri_light=self.tri_light.to(device),
                       kd=f(self.kd), light_data=f(self.light_data))


def detect_plane(quad):
    """Origin, axes, unit normal and area of the parallelogram given as two
    triangles (6 corners): the origin is the first corner the triangles do
    not share, the axes run to the shared diagonal, the normal faces as the
    first triangle's, and the frame stays right-handed."""
    counts = {}
    for p in quad:
        key = np.round(p, 6).tobytes()
        counts[key] = counts.get(key, 0) + 1
    shared = [np.frombuffer(k, dtype=quad.dtype) for k, c in counts.items()
              if c == 2]
    single = [np.frombuffer(k, dtype=quad.dtype) for k, c in counts.items()
              if c == 1]
    o, far = single
    xa, ya = shared[0] - o, shared[1] - o
    tol = 1e-4 * (1 + np.abs(far).max())
    if not np.allclose(o + xa + ya, far, atol=tol):
        xa, ya = ya, xa
    n = np.cross(xa, ya)
    area = float(np.linalg.norm(n))
    n = n / area
    fn = np.cross(quad[1] - quad[0], quad[2] - quad[0])
    if np.dot(fn, n) < 0:
        n = -n
        xa, ya = ya, xa
    return (o.astype(np.float32), xa.astype(np.float32),
            ya.astype(np.float32), n.astype(np.float32), area)


def camera_frame(cam, width, height):
    """A pinhole camera from its position, viewing direction and up vector
    and its horizontal field of view in degrees."""
    d = np.float32(cam["dir"]).astype(np.float64)
    up = np.float32(cam["up"]).astype(np.float64)
    right = np.cross(d, up)
    right = right / max(np.linalg.norm(right), 1e-20)
    sw = math.tan(float(cam["fov"]) * (math.pi / 180.0) / 2)
    sh = sw / (width / height)
    return dict(eye=np.float32(cam["eye"]), dir=np.float32(d),
                up=np.float32(up), right=np.float32(right),
                sw=float(np.float32(sw)), sh=float(np.float32(sh)))


# ------------------------------------------------------------------ lights
def _plane_sq(data, from_point):
    """Spherical-rectangle set-up of a rectangle light seen from a point."""
    origin, xa, ya, nrm = data[:, 0:3], data[:, 3:6], data[:, 6:9], \
        data[:, 9:12]
    width, height = length(xa), length(ya)
    ex = xa * safe_div(1.0, width)[..., None]
    ey = ya * safe_div(1.0, height)[..., None]
    dirv = origin - from_point
    x0, y0, z0_ = dot(dirv, ex), dot(dirv, ey), dot(dirv, nrm)
    x1, y1 = x0 + width, y0 + height
    pos_side = ~torch.signbit(z0_)
    z0 = torch.where(pos_side, -z0_, z0_)
    n = torch.where(pos_side[..., None], -nrm, nrm)
    v4 = torch.stack([x0, y1, x1, y0], dim=-1)
    w4 = torch.stack([x1, y0, x0, y1], dim=-1)
    diff = v4 - w4
    m4 = torch.stack([y0, x1, y1, x0], dim=-1)
    nz_ = m4 * diff
    nz = nz_ / torch.sqrt(torch.clamp_min(diff * diff * (z0 * z0)[..., None]
                                          + nz_ * nz_, 1e-20))
    acos = lambda a: torch.arccos(torch.clamp(a, -1.0 + 1e-7, 1.0 - 1e-7))
    g0 = acos(-nz[..., 0] * nz[..., 1])
    g1 = acos(-nz[..., 1] * nz[..., 2])
    g2 = acos(-nz[..., 2] * nz[..., 3])
    g3 = acos(-nz[..., 3] * nz[..., 0])
    k = 2.0 * PI - g2 - g3
    return dict(x0=x0, y0=y0, z0=z0, x1=x1, y1=y1, b0=nz[..., 0],
                b1=nz[..., 2], k=k, s=g0 + g1 - k, n=n, ex=ex, ey=ey,
                nrm=nrm)


def _sample_plane(data, p, entering, u1, u2):
    sq = _plane_sq(data, p)
    au = u1 * sq["s"] + sq["k"]
    sin_au = torch.sin(au)
    sin_au = torch.where(torch.abs(sin_au) < 1e-12,
                         torch.copysign(torch.full_like(sin_au, 1e-12),
                                        sin_au), sin_au)
    fu = (torch.cos(au) * sq["b0"] - sq["b1"]) / sin_au
    cu_d = torch.sqrt(torch.clamp_min(fu * fu + sq["b0"] * sq["b0"], 1e-20))
    cu = torch.clamp(torch.copysign(torch.ones_like(fu), fu) / cu_d, -1.0,
                     1.0)
    xu = -(cu * sq["z0"]) / torch.sqrt(torch.clamp_min(1.0 - cu * cu, 1e-20))
    xu = torch.minimum(torch.maximum(xu, sq["x0"]), sq["x1"])
    d = torch.sqrt(torch.clamp_min(xu * xu + sq["z0"] * sq["z0"], 1e-20))
    h0 = sq["y0"] / torch.sqrt(torch.clamp_min(d * d + sq["y0"] * sq["y0"],
                                               1e-20))
    h1 = sq["y1"] / torch.sqrt(torch.clamp_min(d * d + sq["y1"] * sq["y1"],
                                               1e-20))
    hv = h0 + u2 * (h1 - h0)
    hv2 = hv * hv
    yv = torch.where(hv2 < 1.0 - 1e-6,
                     (hv * d) / torch.sqrt(torch.clamp_min(1.0 - hv2, 1e-20)),
                     sq["y1"])
    pos = (p + sq["ex"] * xu[..., None] + sq["ey"] * yv[..., None]
           + sq["n"] * sq["z0"][..., None])
    pdf = safe_div(1.0, sq["s"])
    dir_ = pos - p
    dist = safe_len(dir_)
    dirn = dir_ * safe_div(1.0, dist)[..., None]
    sgn = torch.where(entering, -1.0, 1.0).to(p.dtype)
    return dict(dir=dirn, cos=dot(dirn, sq["nrm"]) * sgn, pos=pos,
                intensity=data[:, 13:16] * sq["s"][..., None],
                pdf_value=pdf, pdf_solid=pdf)


def _sample_point(data, p):
    pos = data[:, 0:3]
    dir_ = pos - p
    dist = safe_len(dir_)
    one = torch.ones_like(dist)
    return dict(dir=dir_ * safe_div(1.0, dist)[..., None], cos=one, pos=pos,
                intensity=data[:, 3:6], pdf_value=one, pdf_solid=dist * dist)


def sphere_from_square(px, py):
    """Clarberg's equal-area map of the unit square onto the sphere."""
    u, v = 2.0 * px - 1.0, 2.0 * py - 1.0
    au, av = torch.abs(u), torch.abs(v)
    sd = 1.0 - (au + av)
    r = 1.0 - torch.abs(sd)
    rz = r == 0.0
    one = torch.ones_like(r)
    phi = torch.where(rz, one, (av - au) / torch.where(rz, one, r) + 1.0) \
        * (PI / 4.0)
    cos_t = torch.copysign(1.0 - r * r, sd)
    sin_t = _sqrt0(2.0 - r * r) * r
    return torch.stack([torch.copysign(torch.cos(phi), u) * sin_t,
                        torch.copysign(torch.sin(phi), v) * sin_t, cos_t], -1)


def _sample_env(row, p, radius, u1, u2):
    d = sphere_from_square(u1, u2)
    pdf = torch.full_like(u1, SPHERE_PDF)
    return dict(dir=d, cos=torch.ones_like(u1), pos=p + d * radius,
                intensity=torch.broadcast_to(row[0:3], p.shape)
                * safe_div(1.0, pdf)[..., None],
                pdf_value=pdf, pdf_solid=pdf)


def sample_light(sc, lidx, p, entering, seed, counter, active):
    """Direct sample of each lane's light; every lane draws the largest
    count of the scene's light types, and advances by its own light's."""
    types = sc.light_types
    present = sorted(set(types))
    ndraw = max(LIGHT_DRAWS[t] for t in present)
    us, c = [], counter
    for _ in range(ndraw):
        u, c = rng.uniform(seed, c)
        us.append(u.to(p.dtype))
    while len(us) < 2:
        us.append(torch.zeros(counter.shape, dtype=p.dtype, device=p.device))
    data = sc.light_data[lidx]
    out = None
    draws = torch.zeros_like(counter)
    for i, t in enumerate(types):
        if t == PLANE:
            r = _sample_plane(data, p, entering, us[0], us[1])
        elif t == POINT:
            r = _sample_point(data, p)
        else:
            r = _sample_env(sc.light_data[i], p, sc.scene_radius * 1.01,
                            us[0], us[1])
        m = lidx == i
        r["infinite"] = torch.full_like(m, t == ENV)
        r["delta"] = torch.full_like(m, t == POINT)
        if out is None:
            out = r
        else:
            out = {k: torch.where(m[..., None] if v.ndim == 2 else m, v,
                                  out[k]) for k, v in r.items()}
        draws = torch.where(m, torch.full_like(draws, LIGHT_DRAWS[t]), draws)
    counter = torch.where(active, (counter + draws) & rng.M32, counter)
    return out, counter


# ---------------------------------------------------------------- the path
def camera_rays(sc, x, y, sample, iteration, frame, user_seed, dtype):
    seed = rng.path_seed(sample, iteration, frame, x, y, user_seed)
    counter = torch.ones_like(seed)
    rx, counter = rng.uniform(seed, counter)
    ry, counter = rng.uniform(seed, counter)
    cam = sc.camera
    dev = x.device
    nx = 2.0 * (x.to(dtype) + rx.to(dtype)) / sc.width - 1.0
    ny = 1.0 - 2.0 * (y.to(dtype) + ry.to(dtype)) / sc.height
    vec = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    world = (vec(cam["right"])[None, :] * (cam["sw"] * nx)[..., None]
             + vec(cam["up"])[None, :] * (cam["sh"] * ny)[..., None]
             + vec(cam["dir"])[None, :])
    org = torch.broadcast_to(vec(cam["eye"]), world.shape).contiguous()
    return seed, counter, org, normalize(world)


def _bounce(sc, st):
    """One bounce of every lane of `st`: the radiance it adds, and the next
    state."""
    org, d, alive = st["org"], st["dir"], st["alive"]
    seed, counter = st["seed"], st["counter"]
    contrib, inv_pdf, depth = st["contrib"], st["inv_pdf"], st["depth"]
    eta = st["eta"]
    dt = org.dtype
    nl = len(sc.light_types)
    sel_pdf = 1.0 / nl
    zeros3 = torch.zeros_like(org)

    with torch.no_grad():
        t, u, v, prim = sc.geometry.closest(org.detach(), d.detach(),
                                            st["tmin"], st["tmax"])
    hit = alive & (prim >= 0)
    miss = alive & ~hit
    pr = torch.clamp_min(prim, 0)
    t_safe = torch.where(hit, t, torch.ones_like(t))
    e1, e2 = sc.e1[pr], sc.e2[pr]
    nraw = cross(e1, e2)
    face_n = nraw * safe_div(1.0, length(nraw))[..., None]
    w = (1.0 - u - v)[..., None]
    ns = normalize(sc.n0[pr] * w + sc.n1[pr] * u[..., None]
                   + sc.n2[pr] * v[..., None])
    point = org + d * t_safe[..., None]
    entering = dot(d, face_n) <= 0.0
    sgn = torch.where(entering, 1.0, -1.0).to(dt)[..., None]
    ns, face_n = ns * sgn, face_n * sgn
    tb, bb = onb(ns)
    kd = sc.kd[sc.tri_mat[pr]]
    light_id = sc.tri_light[pr]
    splat = zeros3

    # escaped paths: the environment, against its direct sample
    for i, lt in enumerate(sc.light_types):
        if lt == ENV:
            mis = 1.0 / (1.0 + inv_pdf * sel_pdf * SPHERE_PDF)
            em = contrib * sc.light_data[i, 0:3] * mis[..., None]
            splat = splat + torch.where(miss[..., None], em, zeros3)

    # emitters hit, against their direct sample
    if PLANE in sc.light_types:
        is_em = light_id >= 0
        lidx = torch.clamp_min(light_id, 0)
        data = sc.light_data[lidx]
        pdf_s = torch.where(is_em, safe_div(1.0, _plane_sq(data, org)["s"]),
                            torch.zeros_like(t))
        mis = 1.0 / (1.0 + inv_pdf * sel_pdf * pdf_s)
        ok = hit & is_em & entering & (-dot(d, ns) > FLT_EPS)
        em = contrib * data[:, 13:16] * mis[..., None]
        splat = splat + torch.where(ok[..., None], em, zeros3)

    # next-event estimation
    nee = hit & (depth + 1 <= sc.max_depth)
    if nl > 1:
        lsel, counter = rng.uniform_int(seed, counter, nl - 1, nee)
    else:
        lsel = torch.zeros_like(counter)
    ls, counter = sample_light(sc, lsel, point, entering, seed, counter, nee)
    pdf_l = ls["pdf_solid"] * sel_pdf
    pdf_e = torch.clamp_min(dot(ls["dir"], ns), 0.0) * INV_PI64
    mis = torch.where(ls["delta"], torch.ones_like(pdf_e),
                      1.0 / (1.0 + safe_div(pdf_e, pdf_l)))
    factor = safe_div(ls["pdf_value"], pdf_l)
    above = (torch.sum(ls["dir"] * face_n, dim=-1) > 0.0)[..., None]
    f = torch.where(above, kd * (torch.abs(dot(ls["dir"], ns)) * INV_PI)[
        ..., None], zeros3)
    shadow = ls["intensity"] * contrib * f * (mis * factor)[..., None]
    shadow_ok = nee & (pdf_l > FLT_EPS) & (ls["cos"] > FLT_EPS)
    s_dir = torch.where(ls["infinite"][..., None], ls["dir"],
                        ls["pos"] - point)
    far = torch.finfo(dt).max       # FLT_MAX in float32
    s_tmax = torch.where(ls["infinite"], torch.full_like(t, far),
                         torch.full_like(t, 1.0 - OFFSET))

    # the diffuse bounce and Russian roulette
    can = hit & (depth + 1 <= sc.max_depth)
    u1, c1 = rng.uniform(seed, counter)
    u2, _ = rng.uniform(seed, c1)
    u1, u2 = u1.to(dt), u2.to(dt)
    c, s = _sqrt0(u2), _sqrt0(1.0 - u2)
    phi = 2.0 * PI * u1
    pdf = c * INV_PI64
    in_dir = (tb * (s * torch.cos(phi))[..., None]
              + bb * (s * torch.sin(phi))[..., None] + ns * c[..., None])
    valid = (pdf > 0) & can
    counter = torch.where(can, (counter + 2) & rng.M32, counter)
    new_contrib = contrib * kd
    rr_base = torch.amax(new_contrib * (eta * eta)[..., None], dim=-1)
    rr = torch.where(depth + 1 > sc.min_depth, torch.clamp(rr_base, 0.05, 0.95),
                     torch.ones_like(rr_base)).detach()
    u_rr, c_rr = rng.uniform(seed, counter)
    draw = can & valid
    counter = torch.where(draw, c_rr, counter)
    an = draw & (u_rr.to(dt) < rr)

    with torch.no_grad():
        occ = sc.geometry.occluded(point.detach(), s_dir.detach(),
                                   torch.full_like(t, OFFSET), s_tmax)
    splat = splat + torch.where((shadow_ok & ~occ)[..., None], shadow, zeros3)
    anc = an[..., None]
    nxt = dict(
        org=torch.where(anc, point, org), dir=torch.where(anc, in_dir, d),
        tmin=torch.where(an, torch.full_like(t, OFFSET), st["tmin"]),
        tmax=torch.where(an, torch.full_like(t, far), st["tmax"]),
        alive=an, seed=seed, counter=counter,
        inv_pdf=torch.where(an, safe_div(1.0, pdf), inv_pdf),
        contrib=torch.where(anc, new_contrib * safe_div(1.0, rr)[..., None],
                            contrib),
        depth=torch.where(an, depth + 1, depth), eta=eta)
    return torch.where(alive[..., None], splat, zeros3), nxt


def radiance(sc, x, y, iteration, user_seed, sample=0, frame=0,
             bounces=None, dtype=torch.float32):
    """Per-lane radiance of the camera paths through pixels (x, y).
    `bounces=None` traces each path until it ends, dropping ended lanes
    as it goes; a number runs that many bounces over every lane, as the
    differentiable render does, so that autograd reaches `sc.kd` and
    `sc.light_data` through every bounce."""
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
              eta=torch.ones(n, dtype=dtype, device=dev))
    accum = torch.zeros((n, 3), dtype=dtype, device=dev)
    if bounces is not None:
        for _ in range(bounces):
            splat, st = _bounce(sc, st)
            accum = accum + splat
        return accum
    lane = torch.arange(n, device=dev)
    while True:
        alive = st["alive"]
        n_alive = int(alive.sum())
        if n_alive == 0:
            return accum
        if n_alive * 2 < lane.shape[0]:
            keep = alive.nonzero()[:, 0]
            st = {k: v[keep] for k, v in st.items()}
            lane = lane[keep]
        splat, st = _bounce(sc, st)
        accum.index_add_(0, lane, splat)
