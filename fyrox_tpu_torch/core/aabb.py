"""Batched axis-aligned bounding boxes (the port's copy of
``fyrox_tpu.core.aabb`` for what the renderer uses): SoA (min, max) pairs
broadcasting over leading batch dims."""
from __future__ import annotations

import torch

__all__ = ["transform"]


def transform(mins, maxs, m):
    """AABB of the image of a box under an affine [..., 4, 4] (centre and
    absolute-extent method, equal to transforming the 8 corners)."""
    c = 0.5 * (mins + maxs)
    e = 0.5 * (maxs - mins)
    lin = m[..., :3, :3]
    new_c = torch.sum(lin * c[..., None, :], -1) + m[..., :3, 3]
    new_e = torch.sum(torch.abs(lin) * e[..., None, :], -1)
    return new_c - new_e, new_c + new_e
