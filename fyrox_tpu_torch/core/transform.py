"""Batched node transforms (fyrox-impl scene/transform.rs:421).

Closed form of the reference's local transform:

    linear      = Rtot @ diag(s),   Rtot = Rpre @ R @ Rpost⁻¹
    translation = Rtot @ (soff + sp - s*sp - rp) + t + roff + rp
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fyrox_tpu_torch._util import resolve_device
from fyrox_tpu_torch.core import quat

__all__ = ["Transform", "local_matrix", "compose_trs", "mat4_mul",
           "mat4_identity", "make_translation", "make_scale",
           "decompose_mat4", "invert_affine", "transform_point",
           "transform_vector"]


class Transform(NamedTuple):
    position: torch.Tensor
    rotation: torch.Tensor
    scale: torch.Tensor
    pre_rotation: Optional[torch.Tensor] = None
    post_rotation: Optional[torch.Tensor] = None
    rotation_offset: Optional[torch.Tensor] = None
    rotation_pivot: Optional[torch.Tensor] = None
    scaling_offset: Optional[torch.Tensor] = None
    scaling_pivot: Optional[torch.Tensor] = None


def mat4_identity(shape=(), dtype=torch.float32, device="cuda"):
    """[*shape, 4, 4] identities (a broadcast view), on the card unless
    `device` says otherwise."""
    eye = torch.eye(4, dtype=dtype, device=resolve_device(device))
    return torch.broadcast_to(eye, tuple(shape) + (4, 4))


def make_translation(t):
    """[..., 4, 4] translations by t [..., 3]."""
    m = mat4_identity(t.shape[:-1], t.dtype, t.device).clone()
    m[..., :3, 3] = t
    return m


def make_scale(s):
    """[..., 4, 4] axis scales by s [..., 3]."""
    m = mat4_identity(s.shape[:-1], s.dtype, s.device).clone()
    for i in range(3):
        m[..., i, i] = s[..., i]
    return m


def mat4_mul(a, b):
    """Batched 4x4 product a @ b (explicit multiply-sum, full f32)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], -2)


def _assemble(linear, translation):
    """[..., 3, 3] + [..., 3] → [..., 4, 4] affine matrix."""
    top = torch.cat([linear, translation[..., None]], dim=-1)
    bottom = torch.zeros(linear.shape[:-2] + (1, 4), dtype=linear.dtype,
                         device=linear.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def compose_trs(position, rotation, scale):
    """Plain T*R*S local matrix."""
    linear = quat.to_mat3(rotation) * scale[..., None, :]
    return _assemble(linear, position)


def local_matrix(t: Transform):
    if (t.pre_rotation is None and t.post_rotation is None
            and t.rotation_offset is None and t.rotation_pivot is None
            and t.scaling_offset is None and t.scaling_pivot is None):
        return compose_trs(t.position, t.rotation, t.scale)
    zeros = torch.zeros_like(t.position)

    def _v(x):
        return zeros if x is None else x

    # the 3-term products are summed in index order, not by torch.sum,
    # whose reduction order differs between the card and the CPU: a scene
    # graph pass with pivot terms is then bit-equal on both
    rot = quat.to_mat3(t.rotation)
    if t.pre_rotation is not None:
        rot = _mat3_mul(quat.to_mat3(t.pre_rotation), rot)
    if t.post_rotation is not None:
        # the reference stores inverse(post_rotation) (transform.rs:160)
        rot = _mat3_mul(rot, quat.to_mat3(t.post_rotation).transpose(-1, -2))
    rp, roff = _v(t.rotation_pivot), _v(t.rotation_offset)
    sp, soff = _v(t.scaling_pivot), _v(t.scaling_offset)
    s = t.scale
    linear = rot * s[..., None, :]
    inner = (soff + sp - s * sp - rp)[..., None, :]
    translation = (rot[..., 0] * inner[..., 0] + rot[..., 1] * inner[..., 1]
                   + rot[..., 2] * inner[..., 2]) + t.position + roff + rp
    return _assemble(linear, translation)


def _mat3_mul(a, b):
    """a @ b for [..., 3, 3], each entry summed in index order."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def transform_point(m, p):
    """Apply affine [...,4,4] to points [...,3]."""
    return torch.sum(m[..., :3, :3] * p[..., None, :], -1) + m[..., :3, 3]


def transform_vector(m, v):
    """Apply the linear part of an affine [...,4,4] to vectors [...,3]."""
    return torch.sum(m[..., :3, :3] * v[..., None, :], -1)


def invert_affine(m):
    """Inverse of an affine (rotation*scale + translation) transform."""
    # inv_ex reads no error code back to the host (a CUDA graph capture
    # refuses that read); a singular block gives inf / nan, as
    # jnp.linalg.inv does
    inv_lin = torch.linalg.inv_ex(m[..., :3, :3]).inverse
    inv_t = -torch.sum(inv_lin * m[..., :3, 3][..., None, :], -1)
    return _assemble(inv_lin, inv_t)


def decompose_mat4(m):
    """(position, rotation quat, scale) of an affine matrix without shear
    (physics/mod.rs:1447-1475 decomposition)."""
    position = m[..., :3, 3]
    lin = m[..., :3, :3]
    scale = torch.linalg.norm(lin, dim=-2)
    r = lin / torch.clamp(scale[..., None, :], min=1e-12)
    return position, quat.from_mat3(r), scale
