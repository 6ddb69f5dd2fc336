"""Terrain: a heightmap node with its render mesh, height sampling and
ball contacts, the port of ``fyrox_tpu/scene/terrain.py`` (the reference's
Terrain node, fyrox-impl/src/scene/terrain/, one chunk).

A terrain steps in physics as a HEIGHTFIELD collider
(``PhysicsBuilder.add_collider(..., shapes.HEIGHTFIELD, heights=...,
size=...)``); this module samples the same heights for game code on the
device of the query's tensors. ``add_chunked_terrain`` splits a terrain
into chunks with a full-resolution and a decimated mesh each, switched by
the renderer's LOD groups (the reference's chunked height map with its
per-chunk quadtree LOD); brush strokes that edit the heights are
``scene.brush``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fyrox_tpu_torch.render.mesh import MeshData

__all__ = ["Terrain", "sample_height", "terrain_normal",
           "terrain_ball_contacts", "add_chunked_terrain"]


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


def add_chunked_terrain(sb, terrain: Terrain, chunks=(2, 2), lod_split=0.25,
                        decimate=4, parent=-1, albedo=(0.4, 0.5, 0.3)):
    """Chunked terrain with per-chunk LOD (fyrox-impl scene/terrain/
    :126-135 and quadtree.rs, through the renderer's LOD groups): the
    heightmap splits into `chunks` tiles; each gets a full-resolution mesh
    shown within `lod_split` of normalised camera distance and a
    `decimate`-times coarser mesh beyond it. Host code on a SceneBuilder;
    returns [(hi_node, lo_node)] a chunk."""
    h = np.asarray(terrain.heights, np.float32)
    hz, hx = h.shape
    cx, cz = chunks
    out = []
    for jz in range(cz):
        for jx in range(cx):
            x0 = jx * (hx - 1) // cx
            x1 = (jx + 1) * (hx - 1) // cx + 1
            z0 = jz * (hz - 1) // cz
            z1 = (jz + 1) * (hz - 1) // cz + 1
            sub = h[z0:z1, x0:x1]
            size_x = terrain.size_x * (x1 - 1 - x0) / (hx - 1)
            size_z = terrain.size_z * (z1 - 1 - z0) / (hz - 1)
            origin = (terrain.origin[0] + terrain.size_x * x0 / (hx - 1),
                      terrain.origin[1],
                      terrain.origin[2] + terrain.size_z * z0 / (hz - 1))
            hi = Terrain(sub, size_x, size_z, origin)
            lo = Terrain(sub[::decimate, ::decimate].copy()
                         if min(sub.shape) > decimate else sub,
                         size_x, size_z, origin)
            n_hi = sb.add_mesh(hi.to_mesh(albedo),
                               name=f"terrain_{jx}_{jz}_hi", parent=parent)
            n_lo = sb.add_mesh(lo.to_mesh(albedo),
                               name=f"terrain_{jx}_{jz}_lo", parent=parent)
            sb.add_lod_group([(0.0, lod_split, [n_hi]),
                              (lod_split, 1.0, [n_lo])])
            out.append((n_hi, n_lo))
    return out
