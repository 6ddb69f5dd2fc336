"""Terrain: a heightmap node with its render mesh, height sampling and
ball contacts, the port of ``fyrox_tpu/scene/terrain.py`` (the reference's
Terrain node, fyrox-impl/src/scene/terrain/, one chunk).

A terrain steps in physics as a HEIGHTFIELD collider
(``PhysicsBuilder.add_collider(..., shapes.HEIGHTFIELD, heights=...,
size=...)``); this module samples the same heights for game code on the
device of the query's tensors. Chunked terrain with per-chunk LOD
(``add_chunked_terrain``) needs LOD groups, which the port's renderer
does not have.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fyrox_tpu_torch.render.mesh import MeshData

__all__ = ["Terrain", "sample_height", "terrain_normal",
           "terrain_ball_contacts"]


@dataclass
class Terrain:
    """Heights [Hz, Hx] over a world-aligned rectangle (x in [0, size_x],
    z in [0, size_z]) from `origin`, the reference's chunk layout."""
    heights: np.ndarray
    size_x: float = 32.0
    size_z: float = 32.0
    origin: tuple = (0.0, 0.0, 0.0)

    @property
    def resolution(self):
        return self.heights.shape[1], self.heights.shape[0]

    def to_mesh(self, albedo=(0.4, 0.5, 0.3)) -> MeshData:
        """Triangulated render mesh with central-difference normals."""
        h = np.asarray(self.heights, np.float32)
        hz, hx = h.shape
        xs = np.linspace(0, self.size_x, hx, dtype=np.float32)
        zs = np.linspace(0, self.size_z, hz, dtype=np.float32)
        px, pz = np.meshgrid(xs, zs)
        pos = np.stack([px + self.origin[0], h + self.origin[1],
                        pz + self.origin[2]], -1).reshape(-1, 3)
        dx = np.gradient(h, xs[1] - xs[0], axis=1)
        dz = np.gradient(h, zs[1] - zs[0], axis=0)
        n = np.stack([-dx, np.ones_like(h), -dz], -1)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        uv = np.stack([px / self.size_x, pz / self.size_z], -1).reshape(-1, 2)
        a = (np.arange(hz - 1)[:, None] * hx + np.arange(hx - 1)[None]
             ).reshape(-1)
        tris = np.stack([a, a + 1, a + hx, a + 1, a + hx + 1, a + hx],
                        1).reshape(-1, 3)
        return MeshData(pos, n.reshape(-1, 3).astype(np.float32),
                        uv.astype(np.float32), tris.astype(np.int32),
                        albedo=albedo)


def sample_height(terrain: Terrain, x, z):
    """Bilinear height at world (x, z) tensors (any shape); outside the
    terrain the border clamps."""
    h = torch.as_tensor(np.asarray(terrain.heights, np.float32),
                        device=x.device)
    hz, hx = h.shape

    def f32(v):       # a division by a tensor is IEEE on both devices
        return torch.tensor(np.float32(v), device=x.device)

    u = (x - terrain.origin[0]) / f32(terrain.size_x) * (hx - 1)
    v = (z - terrain.origin[2]) / f32(terrain.size_z) * (hz - 1)
    u = torch.clamp(u, 0.0, hx - 1.0)
    v = torch.clamp(v, 0.0, hz - 1.0)
    i0 = torch.clamp(torch.floor(u).long(), 0, hx - 2)
    j0 = torch.clamp(torch.floor(v).long(), 0, hz - 2)
    fu = u - i0
    fv = v - j0
    h00, h10 = h[j0, i0], h[j0, i0 + 1]
    h01, h11 = h[j0 + 1, i0], h[j0 + 1, i0 + 1]
    return ((h00 * (1 - fu) + h10 * fu) * (1 - fv)
            + (h01 * (1 - fu) + h11 * fu) * fv) + terrain.origin[1]


def terrain_normal(terrain: Terrain, x, z, eps=0.05):
    """Unit surface normal at world (x, z) by central differences."""
    hx0 = sample_height(terrain, x - eps, z)
    hx1 = sample_height(terrain, x + eps, z)
    hz0 = sample_height(terrain, x, z - eps)
    hz1 = sample_height(terrain, x, z + eps)
    n = torch.stack([(hx0 - hx1) / (2 * eps), torch.ones_like(hx0),
                     (hz0 - hz1) / (2 * eps)], -1)
    return n / torch.clamp(torch.sqrt(torch.sum(n * n, -1, keepdim=True)),
                           min=1e-8)


def terrain_ball_contacts(terrain: Terrain, centers, radii, pred=0.002):
    """Sphere-vs-terrain contacts: centers [...,3], radii [...]; the
    tangent plane under each sphere (exact for resting contact on smooth
    terrain). Returns (normal sphere→terrain, point, depth, active)."""
    x, z = centers[..., 0], centers[..., 2]
    n = terrain_normal(terrain, x, z)
    plane_pt = torch.stack([x, sample_height(terrain, x, z), z], -1)
    dist = torch.sum((centers - plane_pt) * n, -1)
    depth = radii - dist
    return -n, centers - n * dist[..., None], depth, depth > -pred
