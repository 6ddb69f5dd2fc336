"""Batched quaternion math on tensors.

Layout is ``(x, y, z, w)`` (vector part first), matching nalgebra's
``UnitQuaternion`` storage and ``fyrox_tpu.core.quat``. Every function
broadcasts over leading batch dimensions; the last axis is 4 (quaternion)
or 3 (vector).
"""
from __future__ import annotations

import torch

from fyrox_tpu_torch._util import resolve_device

__all__ = ["identity", "normalize", "conjugate", "inverse", "mul", "rotate",
           "from_axis_angle", "from_euler", "to_mat3", "from_mat3", "nlerp",
           "slerp", "dot", "face_towards", "angle", "mv", "mtv", "mvb",
           "sandwich_inv_inertia"]


def identity(shape=(), dtype=torch.float32, device="cuda"):
    """The identity quaternion, [*shape, 4], on the card unless `device`
    says otherwise."""
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype,
                    device=resolve_device(device))
    q[..., 3] = 1.0
    return q


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def normalize(q, eps=1e-12):
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def conjugate(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def inverse(q):
    """Inverse of a unit quaternion (its conjugate)."""
    return conjugate(q)


def mul(a, b):
    """Hamilton product a*b: rotation b applied first, then a."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def rotate(q, v):
    """Rotate v by unit quaternion q: v + 2w(u×v) + 2 u×(u×v)."""
    u = q[..., :3]
    w = q[..., 3:4]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    uuv = torch.linalg.cross(u, uv, dim=-1)
    return v + 2.0 * (w * uv + uuv)


def from_axis_angle(axis, angle_rad):
    """Unit quaternion from a unit axis [..., 3] and an angle in radians
    (a tensor [...] or a float)."""
    angle_rad = torch.as_tensor(angle_rad, dtype=axis.dtype,
                                device=axis.device)
    half = 0.5 * angle_rad[..., None]
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def from_euler(roll, pitch, yaw):
    """nalgebra ``from_euler_angles(roll, pitch, yaw)``:
    q = Rz(yaw) * Ry(pitch) * Rx(roll)."""
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ], dim=-1)


def to_mat3(q):
    """Rotation matrix [..., 3, 3] from a unit quaternion."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def from_mat3(m):
    """Unit quaternion from a rotation matrix [..., 3, 3]: branch-free
    Shepperd's method (all four pivots computed, the largest selected)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-20))

    sw = safe_sqrt(1.0 + tr)
    qw0 = torch.stack([m21 - m12, m02 - m20, m10 - m01, sw * sw], -1) \
        / (2.0 * sw[..., None])
    sx = safe_sqrt(1.0 + m00 - m11 - m22)
    qx0 = torch.stack([sx * sx, m01 + m10, m02 + m20, m21 - m12], -1) \
        / (2.0 * sx[..., None])
    sy = safe_sqrt(1.0 - m00 + m11 - m22)
    qy0 = torch.stack([m01 + m10, sy * sy, m12 + m21, m02 - m20], -1) \
        / (2.0 * sy[..., None])
    sz = safe_sqrt(1.0 - m00 - m11 + m22)
    qz0 = torch.stack([m02 + m20, m12 + m21, sz * sz, m10 - m01], -1) \
        / (2.0 * sz[..., None])
    cond_w = (tr > 0.0)[..., None]
    cond_x = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond_y = (m11 >= m22)[..., None]
    q = torch.where(cond_w, qw0,
                    torch.where(cond_x, qx0, torch.where(cond_y, qy0, qz0)))
    return normalize(q)


def nlerp(a, b, t):
    """Normalized lerp with the shortest-path sign fix (the pose blend of
    fyrox-animation's ``blend_with``). t broadcasts against a[..., :1]."""
    if t.dim() == a.dim() - 1:
        t = t[..., None]
    sign = torch.where(dot(a, b) < 0.0, -1.0, 1.0)[..., None]
    return normalize(a + (sign * b - a) * t)


def slerp(a, b, t, eps=1e-6):
    """Spherical lerp along the shorter arc; nlerp's weights where the
    two are nearly parallel. t is a tensor or a float."""
    t = torch.as_tensor(t, dtype=a.dtype, device=a.device)
    if t.dim() == a.dim() - 1:
        t = t[..., None]
    d = dot(a, b)
    sign = torch.where(d < 0.0, -1.0, 1.0)
    b = b * sign[..., None]
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    theta = torch.arccos(d)[..., None]
    sin_theta = torch.sin(theta)
    near = sin_theta < eps
    safe = torch.where(near, torch.ones_like(sin_theta), sin_theta)
    wa = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    wb = torch.where(near, t, torch.sin(t * theta) / safe)
    return normalize(wa * a + wb * b)


def angle(q):
    """Rotation angle in [0, pi] of a unit quaternion."""
    return 2.0 * torch.arccos(torch.clamp(torch.abs(q[..., 3]), 0.0, 1.0))


def face_towards(direction, up):
    """nalgebra ``UnitQuaternion::face_towards(dir, up)``: the rotation
    that maps +Z to `direction` (the look-at of cameras and lights)."""
    z = direction / torch.clamp(torch.linalg.norm(direction, dim=-1,
                                                  keepdim=True), min=1e-12)
    up = torch.broadcast_to(up, z.shape)
    x = torch.linalg.cross(up, z, dim=-1)
    x = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                        min=1e-12)
    y = torch.linalg.cross(z, x, dim=-1)
    return from_mat3(torch.stack([x, y, z], dim=-1))       # columns


def mv(m, v):
    """[..., i, j] @ [..., j] → [..., i]."""
    return torch.sum(m * v[..., None, :], -1)


def mtv(m, v):
    """mᵀ @ v: [..., j, i], [..., j] → [..., i]."""
    return torch.sum(m * v[..., :, None], -2)


def mvb(m, v):
    """[..., i, j] applied to a batch of points [..., k, j] → [..., k,
    i]."""
    return torch.sum(m[..., None, :, :] * v[..., None, :], -1)


def sandwich_inv_inertia(rmat, inv_inertia_local):
    """R @ I⁻¹_local @ Rᵀ for [..., 3, 3] rotations."""
    tmp = torch.sum(rmat[..., :, :, None] * inv_inertia_local[..., None, :, :],
                    -2)
    return torch.sum(tmp[..., :, None, :] * rmat[..., None, :, :], -1)
