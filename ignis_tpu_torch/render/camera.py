"""Camera ray generation.  Counterpart of ignis_tpu/render/camera.py for the
perspective camera (pinhole and thin-lens depth of field); other camera types
raise."""

from __future__ import annotations

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
    """Perspective camera rays (+ thin-lens DoF when `lens_uv` is given and
    cam.aperture_radius > 0).  Returns (org, dir, tmin, tmax)."""
    if cam.type != "perspective":
        raise NotImplementedError(
            f"camera type '{cam.type}' is not ported to ignis_tpu_torch yet")
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
