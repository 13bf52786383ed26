"""Transform property parsing → 4x4 numpy matrices.

Mirrors src/runtime/loader/Parser.cpp:95-235: a transform property is either a
row-major 16/12/9-number array or a list of op objects
({translate/scale/rotate/qrotate/lookat/matrix}).  Ops compose left-to-right
with RIGHT multiplication (the last entry applies first to a point), matching
Eigen's `Transform::translate`/`rotate` semantics used by the reference.
"""

from __future__ import annotations

import math

import numpy as np

DEG2RAD = math.pi / 180.0


def _mat_from_flat(vals) -> np.ndarray:
    vals = [float(v) for v in vals]
    m = np.eye(4, dtype=np.float64)
    if len(vals) == 16:
        m = np.array(vals, dtype=np.float64).reshape(4, 4)
    elif len(vals) == 12:
        m[:3, :] = np.array(vals, dtype=np.float64).reshape(3, 4)
    elif len(vals) == 9:
        m[:3, :3] = np.array(vals, dtype=np.float64).reshape(3, 3)
    else:
        raise ValueError(f"Transform matrix must have 9, 12 or 16 entries, got {len(vals)}")
    return m


def _translate(v):
    m = np.eye(4)
    m[:3, 3] = v
    return m


def _scale(v):
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def _rot_axis(angle_rad: float, axis: int) -> np.ndarray:
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    m = np.eye(4)
    i, j = (1, 2) if axis == 0 else (2, 0) if axis == 1 else (0, 1)
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def _quat(w, x, y, z) -> np.ndarray:
    n = math.sqrt(w * w + x * x + y * y + z * z)
    if n == 0:
        return np.eye(4)
    w, x, y, z = w / n, x / n, y / n, z / n
    m = np.eye(4)
    m[:3, :3] = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
    return m


def _lookat(origin, target, up) -> np.ndarray:
    """Column-frame lookat (Parser.cpp:141-168): cols = (s, u, f, eye)."""
    origin = np.asarray(origin, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    f = target - origin
    fl = np.linalg.norm(f)
    f = f / fl if fl > 1e-8 else np.array([0.0, 0.0, 1.0])
    u = up / max(np.linalg.norm(up), 1e-20)
    s = np.cross(f, u)
    sl = np.linalg.norm(s)
    if sl > 1e-8:
        s = s / sl
    u = np.cross(s, f)
    if np.dot(u, u) <= 1e-8:
        # degenerate: build any frame around f (Tangent::frame)
        s, u = _any_frame(f)
    m = np.eye(4)
    m[:3, 0] = s
    m[:3, 1] = u
    m[:3, 2] = f
    m[:3, 3] = origin
    return m


def _any_frame(n):
    sign = 1.0 if n[2] >= 0 else -1.0
    a = -1.0 / (sign + n[2])
    b = n[0] * n[1] * a
    t = np.array([1 + sign * n[0] * n[0] * a, sign * b, -sign * n[0]])
    bt = np.array([b, sign + n[1] * n[1] * a, -n[1]])
    return t, bt


def _apply_ops(obj: dict) -> np.ndarray:
    m = np.eye(4)
    for key, value in obj.items():
        if key == "translate":
            m = m @ _translate([float(v) for v in value])
        elif key == "scale":
            if isinstance(value, (int, float)):
                m = m @ _scale([float(value)] * 3)
            else:
                m = m @ _scale([float(v) for v in value])
        elif key == "rotate":
            ax, ay, az = [float(v) * DEG2RAD for v in value]
            m = m @ _rot_axis(ax, 0) @ _rot_axis(ay, 1) @ _rot_axis(az, 2)
        elif key == "qrotate":
            m = m @ _quat(*[float(v) for v in value])
        elif key == "lookat":
            if not isinstance(value, dict):
                raise ValueError("lookat must be an object")
            origin = value.get("origin", [0.0, 0.0, 0.0])
            up = value.get("up", [0.0, 0.0, 1.0])
            if "direction" in value:
                target = (np.asarray(value["direction"], dtype=np.float64)
                          + np.asarray(origin, dtype=np.float64))
            else:
                target = value.get("target", [0.0, 1.0, 0.0])
            m = m @ _lookat(origin, target, up)
        elif key == "matrix":
            m = m @ _mat_from_flat(value)
        else:
            raise ValueError(f"Unknown transform op '{key}'")
    return m


def parse_transform(prop, default: np.ndarray | None = None) -> np.ndarray:
    """Parse a scene 'transform' property into a 4x4 float64 matrix."""
    if prop is None:
        return np.eye(4) if default is None else default
    if isinstance(prop, dict):
        return _apply_ops(prop)
    if isinstance(prop, list):
        if len(prop) > 0 and isinstance(prop[0], dict):
            m = np.eye(4)
            for op in prop:
                m = m @ _apply_ops(op)
            return m
        return _mat_from_flat(prop)
    raise ValueError(f"Invalid transform property: {prop!r}")


def normal_matrix(m: np.ndarray) -> np.ndarray:
    """Inverse-transpose of the linear part (for transforming normals)."""
    return np.linalg.inv(m[:3, :3]).T
