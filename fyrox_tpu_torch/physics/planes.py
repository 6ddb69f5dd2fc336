"""Plane-form geometry: a vec3 is a tuple of three same-shape tensors, a
quaternion four, a 3x3 matrix nine (row-major). The slab step keeps its
per-contact data in this form so every op is elementwise over [W, K]
tensors, as in ``fyrox_tpu.physics.planes``.
"""
from __future__ import annotations

import torch

__all__ = ["splat", "add3", "sub3", "neg3", "scale3", "dot3", "cross3",
           "norm3", "normalize3", "where3", "where_n", "qmul", "qrotate",
           "q_to_rot9", "rot9_apply", "rot9_apply_t", "rot9_col"]


def splat(val, like):
    return torch.full_like(like, val)


def add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def neg3(a):
    return (-a[0], -a[1], -a[2])


def scale3(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def norm3(a):
    return torch.sqrt(dot3(a, a))


def normalize3(a, eps=1e-9, fallback=(0.0, 1.0, 0.0)):
    n = norm3(a)
    inv = 1.0 / torch.clamp(n, min=eps)
    ok = n > eps
    return tuple(torch.where(ok, a[i] * inv, torch.full_like(n, fallback[i]))
                 for i in range(3)), n


def where3(c, a, b):
    return tuple(torch.where(c, a[i], b[i]) for i in range(3))


def where_n(c, a, b):
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


def qmul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return (aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz)


def qrotate(q, v):
    u = (q[0], q[1], q[2])
    w = q[3]
    uv = cross3(u, v)
    uuv = cross3(u, uv)
    return (v[0] + 2.0 * (w * uv[0] + uuv[0]),
            v[1] + 2.0 * (w * uv[1] + uuv[1]),
            v[2] + 2.0 * (w * uv[2] + uuv[2]))


def q_to_rot9(q):
    x, y, z, w = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy))


def rot9_apply(r, v):
    """R @ v (local → world)."""
    return (r[0] * v[0] + r[1] * v[1] + r[2] * v[2],
            r[3] * v[0] + r[4] * v[1] + r[5] * v[2],
            r[6] * v[0] + r[7] * v[1] + r[8] * v[2])


def rot9_apply_t(r, v):
    """Rᵀ @ v (world → local)."""
    return (r[0] * v[0] + r[3] * v[1] + r[6] * v[2],
            r[1] * v[0] + r[4] * v[1] + r[7] * v[2],
            r[2] * v[0] + r[5] * v[1] + r[8] * v[2])


def rot9_col(r, j):
    """Column j of R: the world direction of local axis j."""
    return (r[j], r[3 + j], r[6 + j])
