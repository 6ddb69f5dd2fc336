"""G-buffer record, clip transform and near clipping (the port's part of
``fyrox_tpu.render.raster``).

Conventions: clip space from the nalgebra-style projection (RH, NDC z in
[-1, 1], y up); the viewport maps NDC to pixel centres with y flipped;
front faces are counter-clockwise, as in GL. The streaming z-buffer
``raster.rasterize`` is not ported yet: the port rasterizes through
``render.tile_raster`` only, whose clipped mode takes ``clip_near``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["GBuffer", "transform_clip", "clip_near"]


class GBuffer(NamedTuple):
    """Per-pixel outputs (gbuffer.rs:23-27 MRT set, with the world
    position kept instead of reconstructed from depth)."""
    depth: torch.Tensor      # [..., H, W] NDC z, 1e9 where empty
    albedo: torch.Tensor     # [..., H, W, 3]
    normal: torch.Tensor     # [..., H, W, 3] world space
    position: torch.Tensor   # [..., H, W, 3] world space
    material: torch.Tensor   # [..., H, W, 2] metallic, roughness
    emission: torch.Tensor   # [..., H, W, 3]
    mask: torch.Tensor       # [..., H, W] bool coverage
    # interpolated (u, v, albedo layer, mr layer) where the scene binds
    # material textures; None in untextured scenes
    uvt: object = None       # [..., H, W, 4] or None


def transform_clip(positions, mvp):
    """positions [..., V, 3] by mvp [..., 4, 4] → clip [..., V, 4]."""
    p = torch.cat([positions, torch.ones_like(positions[..., :1])], -1)
    return torch.sum(mvp[..., None, :, :] * p[..., :, None, :], -1)


def clip_near(tri_clip, tri_attrs, tri_valid, eps=1e-4):
    """Branch-free Sutherland-Hodgman clip against the w = eps plane
    (``raster.py:52``), batched over leading axes.

    tri_clip [B, T, 3, 4], tri_attrs name → [B, T, 3, C] (or [T, 3, C]),
    tri_valid [B, T] → the fixed 2x expansion ([B, 2T, 3, 4], attrs [B,
    2T, 3, C], valid [B, 2T]): row t is the first triangle of t (all of it
    where it lies in front, its clipped part where one vertex does), row
    T + t the second, used only where two vertices lie in front.
    Attributes are lerped at the intersections with the vertices."""
    b, t = tri_clip.shape[:2]
    d = tri_clip[..., 3] - eps                               # [B, T, 3]
    inside = d >= 0.0
    n_in = inside.to(torch.int32).sum(-1)
    # rotate so that the unique vertex sits at slot 0: the single inside
    # vertex where n_in == 1, the single outside one where n_in == 2
    first_in = torch.argmax(inside.to(torch.int32), -1)
    first_out = torch.argmax((~inside).to(torch.int32), -1)
    uniq = torch.where(n_in == 1, first_in, first_out)
    order = (uniq[..., None] + torch.arange(3, device=d.device)) % 3

    def rot(x):
        if x.dim() == 3:                     # a static [T, 3, C] attribute
            x = x.expand(b, *x.shape)
        idx = order.reshape(order.shape + (1,) * (x.dim() - 3))
        return torch.gather(x, 2, idx.expand(x.shape))

    v = rot(tri_clip)
    a = {k: rot(x) for k, x in tri_attrs.items()}
    dd = torch.gather(d, 2, order)

    def isect(i, j):
        tt = dd[..., i] / (dd[..., i] - dd[..., j])
        tt = torch.clamp(tt, 0.0, 1.0)[..., None]
        vi = v[..., i, :] + tt * (v[..., j, :] - v[..., i, :])
        ai = {k: x[..., i, :] + tt * (x[..., j, :] - x[..., i, :])
              for k, x in a.items()}
        return vi, ai

    i01_v, i01_a = isect(0, 1)
    i02_v, i02_a = isect(0, 2)
    case3 = (n_in == 3)[..., None, None]
    case1 = (n_in == 1)[..., None, None]

    def first(x, i01, i02):
        one = torch.stack([x[..., 0, :], i01, i02], -2)
        two = torch.stack([i01, x[..., 1, :], x[..., 2, :]], -2)
        return torch.where(case3, x, torch.where(case1, one, two))

    def second(x, i01, i02):
        return torch.stack([i01, x[..., 2, :], i02], -2)

    out_v = torch.cat([first(v, i01_v, i02_v), second(v, i01_v, i02_v)], 1)
    out_a = {k: torch.cat([first(a[k], i01_a[k], i02_a[k]),
                           second(a[k], i01_a[k], i02_a[k])], 1) for k in a}
    out_ok = torch.cat([tri_valid & (n_in > 0), tri_valid & (n_in == 2)], 1)
    return out_v, out_a, out_ok
