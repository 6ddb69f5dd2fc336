"""Batched ray intersection tests, the port of ``fyrox_tpu/core/ray.py``
(fyrox-math/src/ray.rs as vectorized routines). A ray is (origin [...,3],
direction [...,3]); the direction is not assumed normalized and a hit
reports its parameter t along it, with a hit mask. Sums of three products
run in index order and square roots are correctly rounded, so that the
card and the CPU give the same hits.
"""
from __future__ import annotations

import torch

from fyrox_tpu_torch._util import dot3, sqrt_rn

__all__ = ["aabb", "sphere", "triangle", "plane"]

_BIG = 3.0e38


def _dot(a, b):
    return dot3(*torch.broadcast_tensors(a, b))


def aabb(origin, direction, mins, maxs, eps=1e-30):
    """Slab test: (hit, t_near, t_far); t_near < 0 where the origin is
    inside the box."""
    inv = 1.0 / torch.where(torch.abs(direction) < eps,
                            torch.where(direction >= 0, eps, -eps),
                            direction)
    t0 = (mins - origin) * inv
    t1 = (maxs - origin) * inv
    tmin = torch.amax(torch.minimum(t0, t1), -1)
    tmax = torch.amin(torch.maximum(t0, t1), -1)
    return tmax >= torch.clamp(tmin, min=0.0), tmin, tmax


def sphere(origin, direction, center, radius):
    """(hit, t): the nearest non-negative intersection (_BIG on a miss)."""
    oc = origin - center
    a = _dot(direction, direction)
    b = 2.0 * _dot(oc, direction)
    c = _dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = sqrt_rn(torch.clamp(disc, min=0.0))
    denom = torch.clamp(2.0 * a, min=1e-30)
    t0 = (-b - sq) / denom
    t1 = (-b + sq) / denom
    t = torch.where(t0 >= 0.0, t0, t1)
    hit = (disc >= 0.0) & (t >= 0.0)
    return hit, torch.where(hit, t, _BIG)


def plane(origin, direction, normal, d):
    """Ray vs the plane n·x + d = 0: (hit, t)."""
    denom = _dot(normal, direction)
    t = -(_dot(normal, origin) + d) / torch.where(
        torch.abs(denom) < 1e-30, 1e-30, denom)
    hit = (torch.abs(denom) >= 1e-30) & (t >= 0.0)
    return hit, torch.where(hit, t, _BIG)


def triangle(origin, direction, v0, v1, v2, eps=1e-9):
    """Möller–Trumbore, two-sided: (hit, t, u, v) with barycentrics."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = torch.linalg.cross(*torch.broadcast_tensors(direction, e2), dim=-1)
    det = _dot(e1, p)
    inv_det = 1.0 / torch.where(torch.abs(det) < eps, eps, det)
    tv = origin - v0
    u = _dot(tv, p) * inv_det
    q = torch.linalg.cross(*torch.broadcast_tensors(tv, e1), dim=-1)
    v = _dot(direction, q) * inv_det
    t = _dot(e2, q) * inv_det
    hit = ((torch.abs(det) >= eps) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t >= 0.0))
    return hit, torch.where(hit, t, _BIG), u, v
