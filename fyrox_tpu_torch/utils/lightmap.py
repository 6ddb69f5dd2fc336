"""Lightmapper: baked per-vertex ambient occlusion and direct light (the
port's ``fyrox_tpu.utils.lightmap``).

The reference's CPU ray-traced lightmapper
(fyrox-impl/src/utils/lightmap.rs:855) re-scoped to the engine's vertex
pipeline: the bake writes per-vertex light (multiplied into albedo or
emission), so it needs no UV atlas. Rays test every triangle of the
scene's soup (Möller-Trumbore) in batches on the device; hemisphere
directions come from a deterministic Fibonacci pattern, like the
reference's fixed sampling patterns. Square roots are correctly rounded
on either device (``_util.sqrt_rn``), so the card and the CPU trace the
same rays. No TPU kernel stands behind this
module: the JAX package runs it as XLA, the port as plain PyTorch.

Eager PyTorch materialises every [rays, T] intermediate that XLA fuses
away, so rays go through in batches of at most ``RAY_TRI_BUDGET // T``
rays: each intermediate then holds at most 2^24 float32 values (64 MiB),
a dozen of which are alive at once.
"""
from __future__ import annotations

import numpy as np
import torch

from fyrox_tpu_torch._util import dot3, sqrt_rn

__all__ = ["bake_vertex_ao", "bake_direct_light", "fibonacci_hemisphere",
           "RAY_TRI_BUDGET"]

RAY_TRI_BUDGET = 1 << 24     # rays × triangles of one batch


def _cross(a, b):
    """a × b over the last axis, each component a1·b2 - a2·b1 as
    jnp.cross forms it."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def _normalized(v):
    n = sqrt_rn(dot3(v, v))[..., None]
    return v / torch.clamp(n, min=1e-8)


def fibonacci_hemisphere(n, normal):
    """[..., n, 3] directions above `normal` [..., 3], denser toward the
    pole (cosine-weighted-ish)."""
    i = np.arange(n) + 0.5
    phi = np.pi * (1.0 + 5.0 ** 0.5) * i
    z = i / n
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    local = torch.as_tensor(
        np.stack([r * np.cos(phi), r * np.sin(phi), z], -1)
        .astype(np.float32), device=normal.device)            # [n, 3], +Z up
    n_ = _normalized(normal)
    helper = torch.zeros_like(n_)
    use_y = torch.abs(n_[..., 1]) < 0.9
    helper[..., 1] = use_y.to(n_.dtype)
    helper[..., 0] = (~use_y).to(n_.dtype)
    t = _normalized(_cross(helper, n_))
    b = _cross(n_, t)
    return (local[..., 0:1] * t[..., None, :]
            + local[..., 1:2] * b[..., None, :]
            + local[..., 2:3] * n_[..., None, :])


def _ray_hits_any(origins, dirs, tris, max_t, eps=1e-4):
    """[M] bool: does each ray (origins / dirs [M, 3]) hit any triangle of
    tris [T, 3, 3] within (eps, max_t) (max_t [M] or a float)?
    Möller-Trumbore over [rows, T] in batches of RAY_TRI_BUDGET // T
    rows."""
    m, t_count = origins.shape[0], tris.shape[0]
    out = torch.zeros(m, dtype=torch.bool, device=origins.device)
    if m == 0 or t_count == 0:
        return out
    v0 = tris[:, 0]
    e1 = tris[:, 1] - v0
    e2 = tris[:, 2] - v0
    max_t = torch.as_tensor(max_t, dtype=torch.float32,
                            device=origins.device).expand(m)
    rows = max(1, RAY_TRI_BUDGET // t_count)
    for s in range(0, m, rows):
        o = origins[s:s + rows, None, :]
        d = dirs[s:s + rows, None, :]
        p = _cross(d, e2)                                # [r, T, 3]
        det = dot3(e1, p)
        inv = 1.0 / torch.where(torch.abs(det) < 1e-9,
                                torch.full_like(det, 1e-9), det)
        tvec = o - v0
        u = dot3(tvec, p) * inv
        q = _cross(tvec, e1)
        v = dot3(d, q) * inv
        t = dot3(e2, q) * inv
        hit = ((torch.abs(det) > 1e-9) & (u >= 0) & (v >= 0)
               & (u + v <= 1) & (t > eps) & (t < max_t[s:s + rows, None]))
        out[s:s + rows] = hit.any(-1)
    return out


def _inputs(positions, normals, tris_soup, device):
    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32)
                               if not isinstance(x, torch.Tensor) else x,
                               dtype=torch.float32, device=device)
    p, n, t = f(positions), f(normals), f(tris_soup)
    return p + n * 1e-3, n, t


def bake_vertex_ao(positions, normals, tris_soup, n_rays=32, max_dist=2.0,
                   device="cuda"):
    """[V] float32 ambient-occlusion factor in [0, 1] (1 = fully open) on
    `device` (the card unless asked otherwise): the share of n_rays
    hemisphere rays from each vertex that reach max_dist unblocked
    (lightmap.rs's hemisphere visibility integral, per vertex).
    positions / normals [V, 3]; tris_soup [T, 3, 3] world-space
    occluders."""
    offs, normals, tris = _inputs(positions, normals, tris_soup, device)
    dirs = fibonacci_hemisphere(n_rays, normals)             # [V, R, 3]
    origins = offs[:, None, :].expand_as(dirs)
    occ = _ray_hits_any(origins.reshape(-1, 3), dirs.reshape(-1, 3), tris,
                        float(max_dist)).reshape(dirs.shape[:2])
    return 1.0 - occ.to(torch.float32).mean(-1)


def bake_direct_light(positions, normals, tris_soup, light_dir=None,
                      light_pos=None, intensity=1.0, device="cuda"):
    """[V] float32 direct light with shadow rays, on `device`: a
    directional light (light_dir, world → light) or a point light
    (light_pos); Lambert × visibility, per vertex."""
    p, n, tris = _inputs(positions, normals, tris_soup, device)
    if light_dir is not None:
        ld = -torch.as_tensor(np.asarray(light_dir, np.float32),
                              device=device)
        ld = ld / torch.clamp(sqrt_rn(dot3(ld, ld)), min=1e-8)
        dirs = ld.expand_as(p)
        max_t = 1e6
        att = 1.0
    else:
        lp = torch.as_tensor(np.asarray(light_pos, np.float32), device=device)
        to_l = lp - p
        dist = sqrt_rn(dot3(to_l, to_l))
        dirs = to_l / torch.clamp(dist[..., None], min=1e-8)
        max_t = dist - 1e-3
        att = 1.0 / torch.clamp(dist * dist, min=1e-4)
    ndl = torch.clamp(dot3(n, dirs), 0.0, 1.0)
    shadowed = _ray_hits_any(p, dirs, tris, max_t)
    return intensity * att * ndl * (1.0 - shadowed.to(torch.float32))
