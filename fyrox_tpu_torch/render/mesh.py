"""Mesh data + procedural generators (the port's copy of
``fyrox_tpu.render.mesh``; numpy only).

Equivalent of the reference's `SurfaceData` + procedural generators
(fyrox-impl/src/scene/mesh/surface.rs:552 make_sphere, :616 make_cone,
:863 make_cube) re-expressed as packed numpy arrays. Vertex layout is SoA:
positions [V,3], normals [V,3], uvs [V,2]; triangles [T,3] int32. The
texture and transparency fields are carried so that a template keeps its
meshes whole; the port's renderer raises on them (off its slice).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["MeshData", "make_cube", "make_sphere", "make_plane", "make_cone"]


@dataclass
class MeshData:
    positions: np.ndarray   # [V,3] f32
    normals: np.ndarray     # [V,3] f32
    uvs: np.ndarray         # [V,2] f32
    triangles: np.ndarray   # [T,3] i32
    albedo: tuple = (0.8, 0.8, 0.8)
    metallic: float = 0.0
    roughness: float = 0.8
    emission: tuple = (0.0, 0.0, 0.0)
    # < 1 routes the mesh through the forward/transparent pass
    # (RenderPath::Forward, renderer/mod.rs:1066-1115)
    alpha: float = 1.0
    # texture-mapped material inputs (gbuffer.rs:57 material texture sets):
    # sampled at shade time in the deferred path via the scene texture
    # array (render/pipeline.py). albedo_texture multiplies the albedo
    # color; mr_texture's RG channels multiply metallic/roughness. A
    # render.texture.Material may be attached instead — its
    # diffuseTexture / metallicRoughnessTexture bindings (the .shader
    # standard property names, render/shader.py) are picked up.
    albedo_texture: object = None   # render.texture.Texture or [H,W,C]
    mr_texture: object = None
    material: object = None         # render.texture.Material

    @property
    def bbox(self):
        return (self.positions.min(0), self.positions.max(0))

    @property
    def num_vertices(self):
        return int(self.positions.shape[0])

    @property
    def num_triangles(self):
        return int(self.triangles.shape[0])


def make_cube(size=1.0, **mat) -> MeshData:
    """Axis-aligned cube with per-face normals (24 verts, 12 tris)."""
    h = size * 0.5
    faces = [
        ((0, 0, 1), [(-h, -h, h), (h, -h, h), (h, h, h), (-h, h, h)]),
        ((0, 0, -1), [(h, -h, -h), (-h, -h, -h), (-h, h, -h), (h, h, -h)]),
        ((1, 0, 0), [(h, -h, h), (h, -h, -h), (h, h, -h), (h, h, h)]),
        ((-1, 0, 0), [(-h, -h, -h), (-h, -h, h), (-h, h, h), (-h, h, -h)]),
        ((0, 1, 0), [(-h, h, h), (h, h, h), (h, h, -h), (-h, h, -h)]),
        ((0, -1, 0), [(-h, -h, -h), (h, -h, -h), (h, -h, h), (-h, -h, h)]),
    ]
    pos, nrm, uv, tris = [], [], [], []
    for fi, (n, quad) in enumerate(faces):
        base = fi * 4
        pos.extend(quad)
        nrm.extend([n] * 4)
        uv.extend([(0, 0), (1, 0), (1, 1), (0, 1)])
        tris.extend([(base, base + 1, base + 2), (base, base + 2, base + 3)])
    return MeshData(np.asarray(pos, np.float32), np.asarray(nrm, np.float32),
                    np.asarray(uv, np.float32), np.asarray(tris, np.int32), **mat)


def make_plane(size=1.0, **mat) -> MeshData:
    h = size * 0.5
    pos = np.asarray([(-h, 0, -h), (h, 0, -h), (h, 0, h), (-h, 0, h)], np.float32)
    nrm = np.tile(np.asarray([(0, 1, 0)], np.float32), (4, 1))
    uv = np.asarray([(0, 0), (1, 0), (1, 1), (0, 1)], np.float32)
    tris = np.asarray([(0, 2, 1), (0, 3, 2)], np.int32)
    return MeshData(pos, nrm, uv, tris, **mat)


def make_sphere(radius=0.5, slices=16, stacks=16, **mat) -> MeshData:
    pos, nrm, uv = [], [], []
    for i in range(stacks + 1):
        v = i / stacks
        phi = v * np.pi
        for j in range(slices + 1):
            u = j / slices
            theta = u * 2 * np.pi
            p = (radius * np.sin(phi) * np.cos(theta),
                 radius * np.cos(phi),
                 radius * np.sin(phi) * np.sin(theta))
            pos.append(p)
            n = np.asarray(p) / max(radius, 1e-9)
            nrm.append(n)
            uv.append((u, v))
    tris = []
    stride = slices + 1
    for i in range(stacks):
        for j in range(slices):
            a = i * stride + j
            b = a + stride
            tris.extend([(a, b, a + 1), (a + 1, b, b + 1)])
    return MeshData(np.asarray(pos, np.float32), np.asarray(nrm, np.float32),
                    np.asarray(uv, np.float32), np.asarray(tris, np.int32), **mat)


def make_cone(radius=0.5, height=1.0, slices=16, **mat) -> MeshData:
    pos, nrm, uv, tris = [], [], [], []
    apex = (0.0, height * 0.5, 0.0)
    for j in range(slices + 1):
        u = j / slices
        theta = u * 2 * np.pi
        rim = (radius * np.cos(theta), -height * 0.5, radius * np.sin(theta))
        side_n = np.asarray([np.cos(theta), radius / max(height, 1e-9), np.sin(theta)])
        side_n /= np.linalg.norm(side_n)
        pos.extend([apex, rim])
        nrm.extend([side_n, side_n])
        uv.extend([(u, 0.0), (u, 1.0)])
    for j in range(slices):
        a = j * 2
        tris.append((a, a + 1, a + 3))
    # base cap
    base_c = len(pos)
    pos.append((0.0, -height * 0.5, 0.0))
    nrm.append((0.0, -1.0, 0.0))
    uv.append((0.5, 0.5))
    for j in range(slices):
        tris.append((base_c, (j * 2 + 1), ((j + 1) % slices) * 2 + 1))
    return MeshData(np.asarray(pos, np.float32), np.asarray(nrm, np.float32),
                    np.asarray(uv, np.float32), np.asarray(tris, np.int32), **mat)
