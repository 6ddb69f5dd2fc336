"""Batched view frustums (the port of ``fyrox_tpu.core.frustum``).

A frustum is a [..., 6, 4] tensor of normalized planes (a, b, c, d) in the
reference's order (fyrox-math frustum.rs:27: 0 left, 1 right, 2 top,
3 bottom, 4 far, 5 near), extracted from a row-major view-projection
matrix (Gribb-Hartmann, frustum.rs:54-69). The AABB test is the p-vertex
test, equivalent to the reference's corner test (frustum.rs:222).
"""
from __future__ import annotations

import torch

__all__ = ["from_view_projection", "intersects_aabb", "intersects_sphere",
           "contains_point"]


def from_view_projection(vp):
    """[..., 4, 4] row-major view-projection → [..., 6, 4] normalized
    planes; p is inside when dot(abc, p) + d >= 0 for all six."""
    r0, r1, r2, r3 = vp[..., 0, :], vp[..., 1, :], vp[..., 2, :], vp[..., 3, :]
    planes = torch.stack([r3 + r0, r3 - r0, r3 - r1, r3 + r1, r3 - r2,
                          r3 + r2], dim=-2)
    n = torch.linalg.norm(planes[..., :3], dim=-1, keepdim=True)
    return planes / torch.clamp(n, min=1e-12)


def intersects_aabb(planes, mins, maxs):
    """p-vertex test: planes [..., 6, 4] against boxes [..., 3] → bool."""
    n = planes[..., :3]
    pvert = torch.where(n >= 0.0, maxs[..., None, :], mins[..., None, :])
    d = torch.sum(n * pvert, -1) + planes[..., 3]
    return torch.all(d >= 0.0, dim=-1)


def contains_point(planes, p):
    """planes [..., 6, 4], p [..., 3] → bool [...]."""
    d = torch.sum(planes[..., :3] * p[..., None, :], -1) + planes[..., 3]
    return torch.all(d >= 0.0, dim=-1)


def intersects_sphere(planes, centers, radii):
    """Inside or crossing unless one plane has the whole sphere behind
    it."""
    d = (torch.sum(planes[..., :3] * centers[..., None, :], -1)
         + planes[..., 3])
    return torch.all(d >= -radii[..., None], dim=-1)
