"""G-buffer record and clip transform (the port's part of
``fyrox_tpu.render.raster``).

Conventions: clip space from the nalgebra-style projection (RH, NDC z in
[-1, 1], y up); the viewport maps NDC to pixel centres with y flipped;
front faces are counter-clockwise, as in GL. The streaming z-buffer
``raster.rasterize`` and its near clip ``clip_near`` are not ported yet:
the port rasterizes through ``render.tile_raster`` only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["GBuffer", "transform_clip"]


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


def transform_clip(positions, mvp):
    """positions [..., V, 3] by mvp [..., 4, 4] → clip [..., V, 4]."""
    p = torch.cat([positions, torch.ones_like(positions[..., :1])], -1)
    return torch.sum(mvp[..., None, :, :] * p[..., :, None, :], -1)
