"""Cube-textured skybox (the port's copy of ``fyrox_tpu.render.skybox``,
with the nearest-texel cube lookup of ``render/probe.py``).

Equivalent of the reference's SkyBox (fyrox-impl/src/scene/skybox.rs:638:
six textures on a unit cube drawn behind all geometry). The background
pixels sample the face set directly by camera ray direction; batched over
worlds.
"""
from __future__ import annotations

import numpy as np
import torch

from fyrox_tpu_torch._util import const, value_const

__all__ = ["SkyBox", "pixel_ray_dirs", "apply_skybox", "gradient_faces",
           "face_texel_dirs", "sample_cube"]

# face → (forward, right, up) for texel directions (``probe.py:89``)
_CUBE_AXES = {
    0: ((1, 0, 0), (0, 0, -1), (0, 1, 0)),
    1: ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),
    2: ((0, 1, 0), (1, 0, 0), (0, 0, -1)),
    3: ((0, -1, 0), (1, 0, 0), (0, 0, 1)),
    4: ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
    5: ((0, 0, -1), (-1, 0, 0), (0, 1, 0)),
}
_AXES = np.asarray([_CUBE_AXES[f] for f in range(6)], np.float32)  # [6,3,3]


class SkyBox:
    """Six [S, S, 3] faces ordered +X, -X, +Y, -Y, +Z, -Z (skybox.rs field
    order right / left / top / bottom / front / back), kept on the host
    and copied to a device once."""

    def __init__(self, faces):
        faces = np.asarray(faces, np.float32)
        if faces.ndim != 4 or faces.shape[0] != 6:
            raise ValueError(f"SkyBox: faces {faces.shape}, want [6, S, S, C]")
        self.faces = faces

    def sample(self, dirs):
        return sample_cube(const(self.faces, dirs.device), dirs)


def face_texel_dirs(size):
    """[6, S, S, 3] unit direction of every cube-face texel (numpy;
    ``probe.py:100``)."""
    u = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    out = np.zeros((6, size, size, 3), np.float32)
    for f, (fwd, right, up) in _CUBE_AXES.items():
        fwd, right, up = (np.asarray(v, np.float32) for v in (fwd, right, up))
        d = (fwd[None, None] + u[None, :, None] * right[None, None]
             - u[:, None, None] * up[None, None])
        out[f] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return out


def sample_cube(faces, dirs):
    """Nearest-texel cube lookup (``probe.py:148``): faces [6, S, S, C],
    dirs [..., 3] → [..., C]; the face is picked by the dominant axis (the
    first on a tie)."""
    s = faces.shape[1]
    d = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                           min=1e-8)
    dom = torch.argmax(torch.abs(d), -1)
    face = torch.where(
        dom == 0, torch.where(d[..., 0] >= 0, 0, 1),
        torch.where(dom == 1, torch.where(d[..., 1] >= 0, 2, 3),
                    torch.where(d[..., 2] >= 0, 4, 5)))
    axes = const(_AXES, dirs.device)[face]                     # [..., 3, 3]
    denom = torch.clamp(torch.sum(d * axes[..., 0, :], -1), min=1e-6)
    pu = torch.sum(d * axes[..., 1, :], -1) / denom
    pv = -torch.sum(d * axes[..., 2, :], -1) / denom
    ui = torch.clamp(((pu * 0.5 + 0.5) * s).to(torch.int32), 0, s - 1)
    vi = torch.clamp(((pv * 0.5 + 0.5) * s).to(torch.int32), 0, s - 1)
    return faces[face, vi.long(), ui.long()]


def gradient_faces(zenith, horizon, size=16):
    """Procedural skybox: a vertical gradient baked into faces (numpy)."""
    dirs = face_texel_dirs(size)
    t = 1.0 - np.clip(dirs[..., 1], 0.0, 1.0)   # 0 at zenith, 1 below
    z = np.asarray(zenith, np.float32)
    h = np.asarray(horizon, np.float32)
    return (z[None, None, None] * (1 - t[..., None])
            + h[None, None, None] * t[..., None])


def pixel_ray_dirs(cam_global, fov_y, aspect, height, width):
    """[W, H, Wd, 3] world-space view ray per pixel from the cameras'
    global matrices [W, 4, 4] (columns = right / up / -forward)."""
    dev = cam_global.device
    ty = torch.tan(value_const(0.5 * fov_y, dev))
    tx = ty * aspect
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) \
        / width * 2.0 - 1.0
    ys = 1.0 - (torch.arange(height, dtype=torch.float32, device=dev)
                + 0.5) / height * 2.0
    right = cam_global[:, None, None, :3, 0]
    up = cam_global[:, None, None, :3, 1]
    fwd = -cam_global[:, None, None, :3, 2]
    d = (fwd + xs[None, None, :, None] * tx * right
         + ys[None, :, None, None] * ty * up)
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                           min=1e-8)


def apply_skybox(color, mask, skybox: SkyBox, cam_global, fov_y, aspect):
    """Fill the uncovered pixels of color [W, H, Wd, 3] with the skybox
    sampled along the view rays (``skybox.py:59``)."""
    h, w = color.shape[-3:-1]
    sky = skybox.sample(pixel_ray_dirs(cam_global, fov_y, aspect, h, w))
    return torch.where(mask[..., None], color, sky)
