"""Sampling warps, batched.  Counterpart of ignis_tpu/core/warp.py."""

from __future__ import annotations

import torch

from ignis_tpu_torch.core.vec import (
    PI, maximum, minimum, safe_div, safe_sqrt, vec2, vec3,
)

_PI64 = 3.14159265358979323846


def sample_triangle(u, v):
    """Uniform point on the unit triangle."""
    flip = (u + v) > 1.0
    return torch.where(flip, 1.0 - u, u), torch.where(flip, 1.0 - v, v)


def uniform_sphere_pdf():
    return 1.0 / (4.0 * _PI64)


def sample_uniform_sphere(u, v):
    c = 2.0 * v - 1.0
    s = safe_sqrt(1.0 - c * c)
    phi = 2.0 * PI * u
    return (vec3(s * torch.cos(phi), s * torch.sin(phi), c),
            torch.full_like(u, uniform_sphere_pdf()))


def cosine_hemisphere_pdf(c):
    return c * (1.0 / _PI64)


def sample_cosine_hemisphere(u, v):
    """Z-up cosine hemisphere."""
    c = safe_sqrt(v)
    s = safe_sqrt(1.0 - v)
    phi = 2.0 * PI * u
    return (vec3(s * torch.cos(phi), s * torch.sin(phi), c),
            cosine_hemisphere_pdf(c))


def cosine_power_hemisphere_pdf(c, k):
    return (torch.pow(maximum(c, 0.0), k) * (k + 1.0)
            * (1.0 / (2.0 * _PI64)))


def sample_cosine_power_hemisphere(k, u, v):
    """Z-up cosine-power lobe of exponent k."""
    c = minimum(torch.pow(v, 1.0 / (k + 1.0)), 1.0)
    s = safe_sqrt(1.0 - c * c)
    phi = 2.0 * PI * u
    nz = c != 0.0
    pow_c_k = torch.where(nz, v / torch.where(nz, c, torch.ones_like(c)),
                          torch.zeros_like(c))
    pdf = pow_c_k * (k + 1.0) * (1.0 / (2.0 * _PI64))
    return vec3(s * torch.cos(phi), s * torch.sin(phi), c), pdf


def square_to_concentric_disk(px, py):
    """Concentric disk map."""
    a = 2.0 * px - 1.0
    b = 2.0 * py - 1.0
    zero = (a == 0.0) & (b == 0.0)
    top = a * a > b * b
    sa = torch.where(top, a, b)
    phi = torch.where(top,
                      (PI / 4.0) * safe_div(b, a),
                      (PI / 2.0) - (PI / 4.0) * safe_div(a, b))
    x = torch.cos(phi) * sa
    y = torch.sin(phi) * sa
    z = torch.zeros_like(x)
    return torch.where(zero, z, x), torch.where(zero, z, y)


def uniform_cone_pdf(cos_angle):
    denom = 2.0 * PI * (1.0 - cos_angle)
    nz = denom != 0.0
    one = torch.ones_like(denom)
    return torch.where(nz, 1.0 / torch.where(nz, denom, one), one)


def sample_uniform_cone(u, v, cos_angle):
    """Z-up cone of half-angle acos(cos_angle), through the concentric
    disk."""
    c1 = 1.0 - cos_angle
    px, py = square_to_concentric_disk(u, v)
    n2 = px * px + py * py
    z = cos_angle + c1 * (1.0 - n2)
    f = safe_sqrt(c1 * (2.0 - c1 * n2))
    return (vec3(px * f, py * f, z),
            torch.broadcast_to(uniform_cone_pdf(cos_angle), u.shape))


def equal_area_square_to_sphere(px, py):
    """Clarberg equal-area square->sphere; (0.5, 0.5) -> +Z."""
    u = 2.0 * px - 1.0
    v = 2.0 * py - 1.0
    au = torch.abs(u)
    av = torch.abs(v)
    signed_distance = 1.0 - (au + av)
    d = torch.abs(signed_distance)
    r = 1.0 - d
    rz = r == 0.0
    one = torch.ones_like(r)
    phi = torch.where(rz, one, (av - au) / torch.where(rz, one, r) + 1.0) \
        * (PI / 4.0)
    cos_theta = torch.copysign(1.0 - r * r, signed_distance)
    sin_theta = safe_sqrt(2.0 - r * r) * r
    cos_phi = torch.copysign(torch.cos(phi), u)
    sin_phi = torch.copysign(torch.sin(phi), v)
    return vec3(cos_phi * sin_theta, sin_phi * sin_theta, cos_theta)


def equal_area_sphere_to_square(d):
    """Inverse of `equal_area_square_to_sphere`."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    r = safe_sqrt(1.0 - az)
    a = torch.maximum(ax, ay)
    b_ = torch.minimum(ax, ay)
    b = safe_div(b_, a)
    phi_ = torch.arctan(b) * (2.0 / _PI64)
    phi = torch.where(ax < ay, 1.0 - phi_, phi_)
    v_ = phi * r
    u_ = r - v_
    u = torch.where(z < 0.0, 1.0 - v_, u_)
    v = torch.where(z < 0.0, 1.0 - u_, v_)
    cu = torch.copysign(u, x)
    cv = torch.copysign(v, y)
    return vec2(0.5 * (cu + 1.0), 0.5 * (cv + 1.0))


def equal_area_sphere_pdf():
    return uniform_sphere_pdf()


def sample_equal_area_sphere(u, v):
    return (equal_area_square_to_sphere(u, v),
            torch.full_like(u, equal_area_sphere_pdf()))
