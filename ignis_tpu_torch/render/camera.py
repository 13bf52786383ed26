"""Camera ray generation.  Counterpart of ignis_tpu/render/camera.py:
perspective (pinhole and thin-lens depth of field), orthogonal and fishlens
cameras, and `sample_pixel`, the inverse map from world points to the film
that the light tracer connects through."""

from __future__ import annotations

import math

import numpy as np
import torch

from ignis_tpu_torch.core.vec import normalize


def pixel_coord_from_xy(x, y, w, h, sx, sy):
    """nx, ny in [-1, 1], y flipped."""
    nx = 2.0 * (x.to(torch.float32) + sx) / w - 1.0
    ny = 1.0 - 2.0 * (y.to(torch.float32) + sy) / h
    return nx, ny


def camera_frame(cam, device, dyn=None):
    """View matrix columns (right, up, dir).

    dyn: optional (eye, dir, up) tensors from the parameter registry
    (__camera_* keys) so the pose can change between steps."""
    if dyn is not None:
        _, d, up = dyn
        right = torch.linalg.cross(d, up)
        right = right / torch.clamp_min(
            torch.sqrt(torch.sum(right * right)), 1e-20)
        return right, up, d
    d = np.asarray(cam.dir, dtype=np.float64)
    up = np.asarray(cam.up, dtype=np.float64)
    right = np.cross(d, up)
    right = right / max(np.linalg.norm(right), 1e-20)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.as_tensor(right, **f32), torch.as_tensor(cam.up, **f32),
            torch.as_tensor(cam.dir, **f32))


def generate_rays(cam, nx, ny, dyn=None, lens_uv=None):
    """Camera rays: perspective (+ thin-lens DoF when `lens_uv` is given and
    cam.aperture_radius > 0), orthogonal, fishlens.  Returns
    (org, dir, tmin, tmax)."""
    dev = nx.device
    right, up, d = camera_frame(cam, dev, dyn)
    eye = (torch.as_tensor(cam.eye, dtype=torch.float32, device=dev)
           if dyn is None else dyn[0].to(torch.float32))
    # far_clip defaults to a double just above the float32 maximum: round it
    # to float32 first, as the reference's array constructor does
    tmin = torch.full(nx.shape, float(np.float32(cam.tmin)),
                      dtype=torch.float32, device=dev)
    tmax = torch.full(nx.shape, float(np.float32(cam.tmax)),
                      dtype=torch.float32, device=dev)

    if cam.type == "orthogonal":
        # pos = view @ (sw * nx, sh * ny, 0) + eye, the direction fixed
        sw, sh = float(cam.scale[0]), float(cam.scale[1])
        org = (right[None, :] * (sw * nx)[..., None]
               + up[None, :] * (sh * ny)[..., None]
               + eye[None, :])
        dirs = torch.broadcast_to(d, org.shape)
        return org, dirs, tmin, tmax

    if cam.type == "fishlens":
        return _fishlens_rays(cam, nx, ny, right, up, d, eye) + (tmin, tmax)

    # perspective (any other type name renders as one, as in the reference)
    sw, sh = float(cam.scale[0]), float(cam.scale[1])
    world = (right[None, :] * (sw * nx)[..., None]
             + up[None, :] * (sh * ny)[..., None]
             + d[None, :])
    dirs = normalize(world)
    if cam.aperture_radius > 0.0 and lens_uv is not None:
        # thin lens: focus point along the pinhole dir at focal_length;
        # origin jittered on the concentric-disk aperture
        from ignis_tpu_torch.core.warp import square_to_concentric_disk
        ax, ay = square_to_concentric_disk(lens_uv[0], lens_uv[1])
        ar = float(np.float32(cam.aperture_radius))
        ap = (right[None, :] * (ax * ar)[..., None]
              + up[None, :] * (ay * ar)[..., None])
        focus = dirs * float(np.float32(cam.focal_length))
        dirs = normalize(focus - ap)
        org = eye[None, :] + ap
        return org, dirs, tmin, tmax
    org = torch.broadcast_to(eye, dirs.shape)
    return org, dirs, tmin, tmax


def _fishlens_rays(cam, nx, ny, right, up, d, eye):
    """Equidistant fisheye in its `cropped`, `full` and `circular` aspect
    modes; the film's width and height travel in `cam.scale`."""
    w, h = float(cam.scale[0]), float(cam.scale[1])
    asp = w / h
    mode = cam.fishlens_mode
    if mode == "cropped":
        xasp = 1.0 / asp if asp < 1 else 1.0
        yasp = 1.0 / asp if asp > 1 else 1.0
    elif mode == "full":
        diameter = math.sqrt(asp * asp + 1.0) * h
        f = diameter / min(w, h)
        xasp = f if asp < 1 else f / asp
        yasp = f if asp > 1 else f * asp
    else:  # circular
        xasp = 1.0 if asp < 1 else asp
        yasp = 1.0 if asp > 1 else asp
    # the reference multiplies by these doubles rounded to float32
    fnx = nx * float(np.float32(xasp))
    fny = ny * float(np.float32(yasp))
    r = torch.sqrt(fnx * fnx + fny * fny)
    theta = r * float(np.float32(3.14159265)) / 2.0
    st, ct = torch.sin(theta), torch.cos(theta)
    small = r < float(np.float32(1.1920929e-07))
    zero = torch.zeros_like(r)
    safe_r = torch.where(small, torch.ones_like(r), r)
    sp = torch.where(small, zero, fny / safe_r)
    cp = torch.where(small, zero, fnx / safe_r)
    local = torch.stack([st * cp, st * sp, ct], dim=-1)
    world = (right[None, :] * local[..., 0:1]
             + up[None, :] * local[..., 1:2] + d[None, :] * local[..., 2:3])
    dirs = normalize(world)
    return torch.broadcast_to(eye, dirs.shape), dirs


def sample_pixel(cam, pos):
    """Connect world points `pos` (N, 3) to the camera (light-tracer
    splats).  Returns dict(valid, nx, ny, dir (the unnormalised point -> eye
    vector), weight), as the reference: `weight` is the pinhole's importance,
      perspective: W = 1 / (4 sw sh cos^3 theta)   (film at unit distance)
      orthogonal:  W = depth^2 / (4 sw sh)
    and a fishlens camera has no inverse map (every lane invalid)."""
    dev = pos.device
    right, up, d = camera_frame(cam, dev)
    eye = torch.as_tensor(cam.eye, dtype=torch.float32, device=dev)
    n = pos.shape[0]
    if cam.type == "fishlens":
        z = torch.zeros(n, dtype=torch.float32, device=dev)
        return dict(valid=torch.zeros(n, dtype=torch.bool, device=dev),
                    nx=z, ny=z, dir=torch.zeros((n, 3), dtype=torch.float32,
                                                device=dev), weight=z)
    sw, sh = float(cam.scale[0]), float(cam.scale[1])
    area4 = float(np.float32(4.0 * sw * sh))
    rel = pos - eye
    if cam.type == "orthogonal":
        nx = (rel @ right) / sw
        ny = (rel @ up) / sh
        depth = rel @ d
        valid = ((nx >= -1) & (nx <= 1) & (ny >= -1) & (ny <= 1)
                 & (depth > 0))
        return dict(valid=valid, nx=nx, ny=ny, dir=-d * depth[..., None],
                    weight=depth * depth / area4)
    un_x = rel @ right
    un_y = rel @ up
    un_z = rel @ d
    safe_z = torch.where(torch.abs(un_z) < 1e-12,
                         torch.full_like(un_z, 1e-12), un_z)
    nx = un_x / (safe_z * sw)
    ny = un_y / (safe_z * sh)
    valid = (nx >= -1) & (nx <= 1) & (ny >= -1) & (ny <= 1) & (un_z > 0)
    dist = torch.sqrt(torch.clamp_min(torch.sum(rel * rel, dim=-1), 1e-20))
    cos_t = torch.clamp(un_z / dist, 1e-6, 1.0)
    weight = 1.0 / (area4 * cos_t * cos_t * cos_t)
    return dict(valid=valid, nx=nx, ny=ny, dir=eye - pos, weight=weight)
