"""Misc math utilities: Rect and the fyrox-math free functions (the port's
copy of ``fyrox_tpu.core.mathutil``).

fyrox-math/src/lib.rs: classify_plane :55, get_polygon_normal :77,
get_signed_triangle_area :93, vec3_to_vec2_by_plane :98 (the tri-planar
projection of the triangulator and UV mapping), wrap_angle :157,
ieee_remainder :169, round_to_step :175, lerpf :206, cubicf :212/:224,
get_farthest_point :252, get_barycentric_coords :266/:291, triangle_area
:353, spherical_to_cartesian :375, ray_rect_intersection :383; Rect as
re-exported through fyrox-core/src/math/mod.rs:40. The vector-valued
helpers take tensors (or anything numpy reads) with leading batch axes
and return float32 tensors on the input's device; Rect is a host value
type, as in the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["Rect", "PlaneClass", "classify_plane", "vec3_to_vec2_by_plane",
           "get_polygon_normal", "get_signed_triangle_area", "wrap_angle",
           "ieee_remainder", "round_to_step", "lerpf", "cubicf",
           "cubicf_derivative", "get_farthest_point",
           "get_barycentric_coords", "get_barycentric_coords_2d",
           "barycentric_is_inside", "triangle_area",
           "spherical_to_cartesian", "ray_rect_intersection"]


@dataclass
class Rect:
    """Axis-aligned 2D rectangle: position (x, y) + size (w, h)."""
    x: float = 0.0
    y: float = 0.0
    w: float = 0.0
    h: float = 0.0

    # -- constructors/getters (rect tests, fyrox-math/src/lib.rs:938-1020)
    def with_position(self, pos) -> "Rect":
        return Rect(pos[0], pos[1], self.w, self.h)

    def with_size(self, size) -> "Rect":
        return Rect(self.x, self.y, size[0], size[1])

    @property
    def position(self):
        return (self.x, self.y)

    @property
    def size(self):
        return (self.w, self.h)

    def left_top_corner(self):
        return (self.x, self.y)

    def left_bottom_corner(self):
        return (self.x, self.y + self.h)

    def right_top_corner(self):
        return (self.x + self.w, self.y)

    def right_bottom_corner(self):
        return (self.x + self.w, self.y + self.h)

    def center(self):
        return (self.x + self.w / 2, self.y + self.h / 2)

    # -- geometry ops
    def inflate(self, dw, dh) -> "Rect":
        return Rect(self.x - dw, self.y - dh, self.w + 2 * dw, self.h + 2 * dh)

    def deflate(self, dw, dh) -> "Rect":
        return self.inflate(-dw, -dh)

    def translate(self, delta) -> "Rect":
        return Rect(self.x + delta[0], self.y + delta[1], self.w, self.h)

    def contains(self, pt) -> bool:
        return (self.x <= pt[0] <= self.x + self.w
                and self.y <= pt[1] <= self.y + self.h)

    def intersects(self, other: "Rect") -> bool:
        return not (other.x + other.w < self.x or other.x > self.x + self.w
                    or other.y + other.h < self.y
                    or other.y > self.y + self.h)

    def intersects_circle(self, center, radius) -> bool:
        cx = min(max(center[0], self.x), self.x + self.w)
        cy = min(max(center[1], self.y), self.y + self.h)
        return ((cx - center[0]) ** 2 + (cy - center[1]) ** 2
                <= radius * radius)

    def clip_by(self, other: "Rect") -> Optional["Rect"]:
        """Intersection rect, or None when disjoint (Rect::clip_by)."""
        x0 = max(self.x, other.x)
        y0 = max(self.y, other.y)
        x1 = min(self.x + self.w, other.x + other.w)
        y1 = min(self.y + self.h, other.y + other.h)
        if x1 < x0 or y1 < y0:
            return None
        return Rect(x0, y0, x1 - x0, y1 - y0)

    def push(self, pt) -> "Rect":
        """Grow to contain a point (Rect::push; returns the grown rect —
        functional style instead of &mut self)."""
        x0 = min(self.x, pt[0])
        y0 = min(self.y, pt[1])
        x1 = max(self.x + self.w, pt[0])
        y1 = max(self.y + self.h, pt[1])
        return Rect(x0, y0, x1 - x0, y1 - y0)

    def extend_to_contain(self, other: "Rect") -> "Rect":
        return self.push((other.x, other.y)).push(
            (other.x + other.w, other.y + other.h))


class PlaneClass:
    XY = 0
    YZ = 1
    XZ = 2


def _host(v):
    """A small vector as numpy (one host read where it is a tensor)."""
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def classify_plane(normal) -> int:
    """Dominant-axis plane class of a normal (lib.rs:55); a host read of
    one vector."""
    ax, ay, az = (abs(float(x)) for x in _host(normal)[:3])
    longest, cls = 0.0, PlaneClass.XY
    if ax > longest:
        longest, cls = ax, PlaneClass.YZ
    if ay > longest:
        longest, cls = ay, PlaneClass.XZ
    if az > longest:
        cls = PlaneClass.XY
    return cls


def vec3_to_vec2_by_plane(plane_class, normal, point):
    """Tri-planar projection of a 3D point onto the dominant plane with
    orientation-preserving axis order (lib.rs:98)."""
    p = point
    normal = _host(normal)
    if plane_class == PlaneClass.XY:
        return (p[..., 1], p[..., 0]) if float(normal[2]) < 0 \
            else (p[..., 0], p[..., 1])
    if plane_class == PlaneClass.XZ:
        return (p[..., 0], p[..., 2]) if float(normal[1]) < 0 \
            else (p[..., 2], p[..., 0])
    return (p[..., 2], p[..., 1]) if float(normal[0]) < 0 \
        else (p[..., 1], p[..., 2])


def get_polygon_normal(polygon):
    """Newell's-method polygon normal (lib.rs:77) of [n, 3] points, a
    float32 tensor on their device; raises on a degenerate polygon (one
    host read)."""
    poly = _t(polygon)
    nxt = torch.roll(poly, -1, dims=0)
    n = torch.stack([
        torch.sum((poly[:, 1] - nxt[:, 1]) * (poly[:, 2] + nxt[:, 2])),
        torch.sum((poly[:, 2] - nxt[:, 2]) * (poly[:, 0] + nxt[:, 0])),
        torch.sum((poly[:, 0] - nxt[:, 0]) * (poly[:, 1] + nxt[:, 1]))])
    ln = torch.linalg.vector_norm(n)
    if float(ln) <= np.finfo(np.float32).eps:
        raise ValueError("unable to get normal of degenerated polygon")
    return n / ln


def get_signed_triangle_area(v1, v2, v3):
    return 0.5 * (v1[0] * (v3[1] - v2[1]) + v2[0] * (v1[1] - v3[1])
                  + v3[0] * (v2[1] - v1[1]))


def wrap_angle(angle):
    """Wrap into [0, 2π) (lib.rs:157)."""
    two_pi = 2.0 * math.pi
    a = math.fmod(float(angle), two_pi)
    return a + two_pi if a < 0 else a


def ieee_remainder(x, y):
    return float(x) - round(float(x) / float(y)) * float(y)


def round_to_step(x, step):
    return float(x) - ieee_remainder(float(x), float(step))


def lerpf(a, b, t):
    return a + (b - a) * t


def cubicf(p0, p1, t, m0, m1):
    """Cubic Hermite interpolation (lib.rs:212)."""
    t2, t3 = t * t, t * t * t
    return ((2 * t3 - 3 * t2 + 1) * p0 + (t3 - 2 * t2 + t) * m0
            + (-2 * t3 + 3 * t2) * p1 + (t3 - t2) * m1)


def cubicf_derivative(p0, p1, t, m0, m1):
    t2 = t * t
    return ((6 * t2 - 6 * t) * p0 + (3 * t2 - 4 * t + 1) * m0
            + (6 * t - 6 * t2) * p1 + (3 * t2 - 2 * t) * m1)


def _t(x, like=None):
    """x as a float32 tensor (on `like`'s device where x is not one)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def get_farthest_point(points, direction):
    """Support point of a point cloud along a direction (lib.rs:252);
    batched over leading dims of `direction`; the first of tied points
    wins."""
    d = _t(direction)
    pts = _t(points, d)
    dots = torch.einsum("...d,pd->...p", d, pts)
    return pts[torch.argmax(dots, dim=-1)]


def get_barycentric_coords(p, a, b, c):
    """Barycentric (u,v,w) of 3D point p in triangle abc (lib.rs:266)."""
    p = _t(p)
    a, b, c = _t(a, p), _t(b, p), _t(c, p)
    v0, v1, v2 = b - a, c - a, p - a
    d00 = torch.sum(v0 * v0, -1)
    d01 = torch.sum(v0 * v1, -1)
    d11 = torch.sum(v1 * v1, -1)
    d20 = torch.sum(v2 * v0, -1)
    d21 = torch.sum(v2 * v1, -1)
    denom = d00 * d11 - d01 * d01
    denom = torch.where(torch.abs(denom) < 1e-12, torch.ones_like(denom),
                        denom)
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    return 1.0 - v - w, v, w


def get_barycentric_coords_2d(p, a, b, c):
    """2D variant (lib.rs:291)."""
    def to3(q):
        q = _t(q)
        return torch.cat([q, torch.zeros(q.shape[:-1] + (1,),
                                         dtype=q.dtype, device=q.device)], -1)
    return get_barycentric_coords(to3(p), to3(a), to3(b), to3(c))


def barycentric_is_inside(bary, eps=1e-6):
    u, v, w = bary
    return (u >= -eps) & (v >= -eps) & (w >= -eps)


def triangle_area(a, b, c):
    a = _t(a)
    ab, ac = _t(b, a) - a, _t(c, a) - a
    return 0.5 * torch.linalg.vector_norm(torch.linalg.cross(ab, ac, dim=-1),
                                          dim=-1)


def spherical_to_cartesian(azimuth, elevation, radius):
    x = radius * math.sin(elevation) * math.cos(azimuth)
    y = radius * math.cos(elevation)
    z = radius * math.sin(elevation) * math.sin(azimuth)
    return (x, y, z)


def ray_rect_intersection(rect: Rect, origin, direction
                          ) -> Optional[Tuple[float, Tuple[float, float]]]:
    """2D slab test of a ray against a Rect (lib.rs:383). Returns
    (t, point) of the nearest hit or None."""
    tmin, tmax = -math.inf, math.inf
    o = (float(origin[0]), float(origin[1]))
    d = (float(direction[0]), float(direction[1]))
    lo = (rect.x, rect.y)
    hi = (rect.x + rect.w, rect.y + rect.h)
    for ax in range(2):
        if abs(d[ax]) < 1e-12:
            if o[ax] < lo[ax] or o[ax] > hi[ax]:
                return None
        else:
            t1 = (lo[ax] - o[ax]) / d[ax]
            t2 = (hi[ax] - o[ax]) / d[ax]
            if t1 > t2:
                t1, t2 = t2, t1
            tmin = max(tmin, t1)
            tmax = min(tmax, t2)
    if tmax < max(tmin, 0.0):
        return None
    t = tmin if tmin >= 0 else tmax
    return t, (o[0] + d[0] * t, o[1] + d[1] * t)
