"""Camera matrices (the port's copy of ``fyrox_tpu.scene.camera``).

Conventions of the reference (fyrox-impl/src/scene/camera.rs):
  * view = look_at_rh(pos, pos + look, up) (camera.rs:459), look/up the +Z
    and +Y basis columns of the node's global transform;
  * perspective = nalgebra new_perspective (RH, NDC z in [-1, 1], vertical
    fov; camera.rs:89-105);
  * ortho = new_orthographic(-vs*aspect, vs*aspect, -vs, vs, zn, zf).
Matrices are row-major float32; scalar arguments are Python floats.
"""
from __future__ import annotations

import torch

__all__ = ["perspective", "orthographic", "look_at_rh", "view_matrix"]


def perspective(fov_y, aspect, z_near, z_far, device="cpu"):
    """[4, 4] RH perspective with [-1, 1] depth, computed in float32."""
    f32 = torch.float32
    fov_y, aspect, z_near, z_far = (torch.tensor(float(x), dtype=f32)
                                    for x in (fov_y, aspect, z_near, z_far))
    f = 1.0 / torch.tan(0.5 * fov_y)
    m = torch.zeros((4, 4), dtype=f32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (z_far + z_near) / (z_near - z_far)
    m[2, 3] = 2.0 * z_far * z_near / (z_near - z_far)
    m[3, 2] = -1.0
    return m.to(device)


def orthographic(vertical_size, aspect, z_near, z_far, device="cpu"):
    """[4, 4] RH orthographic, symmetric about the view axis
    (camera.rs:139-170), computed in float32."""
    f32 = torch.float32
    vs, aspect, z_near, z_far = (torch.tensor(float(x), dtype=f32)
                                 for x in (vertical_size, aspect, z_near,
                                           z_far))
    m = torch.zeros((4, 4), dtype=f32)
    m[0, 0] = 1.0 / (vs * aspect)
    m[1, 1] = 1.0 / vs
    m[2, 2] = -2.0 / (z_far - z_near)
    m[2, 3] = -(z_far + z_near) / (z_far - z_near)
    m[3, 3] = 1.0
    return m.to(device)


def look_at_rh(eye, target, up):
    """[..., 4, 4] row-major RH look-at view matrices (nalgebra)."""
    f = target - eye
    f = f / torch.clamp(torch.linalg.norm(f, dim=-1, keepdim=True),
                        min=1e-12)
    up = torch.broadcast_to(up, f.shape)
    s = torch.linalg.cross(f, up, dim=-1)
    s = s / torch.clamp(torch.linalg.norm(s, dim=-1, keepdim=True),
                        min=1e-12)
    u = torch.linalg.cross(s, f, dim=-1)
    m = torch.zeros(f.shape[:-1] + (4, 4), dtype=f.dtype, device=f.device)
    m[..., 0, :3] = s
    m[..., 1, :3] = u
    m[..., 2, :3] = -f
    m[..., 0, 3] = -torch.sum(s * eye, -1)
    m[..., 1, 3] = -torch.sum(u * eye, -1)
    m[..., 2, 3] = torch.sum(f * eye, -1)
    m[..., 3, 3] = 1.0
    return m


def view_matrix(global_transform):
    """View matrix of a camera node from its global transform
    (Camera::calculate_matrices, camera.rs:454-460)."""
    pos = global_transform[..., :3, 3]
    look = global_transform[..., :3, 2]
    up = global_transform[..., :3, 1]
    return look_at_rh(pos, pos + look, up)
