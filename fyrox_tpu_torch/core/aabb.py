"""Batched axis-aligned bounding boxes (the port of
``fyrox_tpu.core.aabb``; fyrox-math/src/aabb.rs): SoA (min, max) pairs
broadcasting over leading batch dims. An invalid box has min = +inf and
max = -inf, so that a union with it leaves the other box."""
from __future__ import annotations

import numpy as np
import torch

from fyrox_tpu_torch._util import const, resolve_device

__all__ = ["invalid", "unit", "from_points", "center", "half_extents",
           "volume", "union", "contains_point", "intersects_aabb",
           "intersects_sphere", "transform", "corners"]

# the 8 corners' min / max choice per axis
_CORNERS = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                       [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
                      np.float32)


def invalid(shape=(), dtype=torch.float32, device="cuda"):
    """(mins, maxs) [*shape, 3] of the empty box, on the card unless
    `device` says otherwise."""
    dev = resolve_device(device)
    size = tuple(shape) + (3,)
    return (torch.full(size, float("inf"), dtype=dtype, device=dev),
            torch.full(size, float("-inf"), dtype=dtype, device=dev))


def unit(dtype=torch.float32, device="cuda"):
    """The unit box centred on the origin."""
    dev = resolve_device(device)
    return (torch.full((3,), -0.5, dtype=dtype, device=dev),
            torch.full((3,), 0.5, dtype=dtype, device=dev))


def from_points(points, axis=-2):
    """The box of a point cloud along `axis`."""
    return torch.amin(points, dim=axis), torch.amax(points, dim=axis)


def center(mins, maxs):
    return 0.5 * (mins + maxs)


def half_extents(mins, maxs):
    return 0.5 * (maxs - mins)


def volume(mins, maxs):
    d = torch.clamp(maxs - mins, min=0.0)
    return d[..., 0] * d[..., 1] * d[..., 2]


def union(a_min, a_max, b_min, b_max):
    return torch.minimum(a_min, b_min), torch.maximum(a_max, b_max)


def contains_point(mins, maxs, p):
    return torch.all((p >= mins) & (p <= maxs), dim=-1)


def intersects_aabb(a_min, a_max, b_min, b_max):
    """Inclusive overlap test (aabb.rs `intersect_aabb`)."""
    return torch.all((a_min <= b_max) & (a_max >= b_min), dim=-1)


def intersects_sphere(mins, maxs, centers, radii):
    """Sphere against box by the closest point's distance."""
    closest = torch.minimum(torch.maximum(centers, mins), maxs)
    d2 = torch.sum((closest - centers) ** 2, dim=-1)
    return d2 <= radii * radii


def corners(mins, maxs):
    """The 8 corner points, [..., 8, 3]."""
    sel = const(_CORNERS, mins.device).to(mins.dtype)
    mins_e, maxs_e = mins[..., None, :], maxs[..., None, :]
    return mins_e + sel * (maxs_e - mins_e)


def transform(mins, maxs, m):
    """AABB of the image of a box under an affine [..., 4, 4] (centre and
    absolute-extent method, equal to transforming the 8 corners)."""
    c = 0.5 * (mins + maxs)
    e = 0.5 * (maxs - mins)
    lin = m[..., :3, :3]
    new_c = torch.sum(lin * c[..., None, :], -1) + m[..., :3, 3]
    new_e = torch.sum(torch.abs(lin) * e[..., None, :], -1)
    return new_c - new_e, new_c + new_e
