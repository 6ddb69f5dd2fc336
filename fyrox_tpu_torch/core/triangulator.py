"""Polygon triangulation (host-side, build time).

Equivalent of fyrox-math/src/triangulator.rs:117 `triangulate`: fans a
triangle, splits a quad along the diagonal that keeps both halves convex,
and ear-clips arbitrary simple polygons after projecting onto the dominant
plane of the polygon normal. Used by asset importers and navmesh authoring
— this runs at build time on numpy, never inside jit.
"""
from __future__ import annotations

import numpy as np

__all__ = ["polygon_normal", "triangulate"]


def polygon_normal(vertices: np.ndarray) -> np.ndarray:
    """Newell's method (get_polygon_normal, fyrox-math/src/lib.rs)."""
    v = np.asarray(vertices, np.float64)
    nxt = np.roll(v, -1, axis=0)
    n = np.sum(np.cross(v, nxt), axis=0)
    ln = np.linalg.norm(n)
    if ln < 1e-12:
        raise ValueError("degenerate polygon (zero normal)")
    return n / ln


def _project_2d(vertices, normal):
    """Drop the dominant axis of the normal (vec3_to_vec2_by_plane),
    keeping an orientation such that the projected polygon stays CCW."""
    ax = int(np.argmax(np.abs(normal)))
    keep = [i for i in range(3) if i != ax]
    pts = np.asarray(vertices, np.float64)[:, keep]
    if normal[ax] < 0:
        pts = pts[:, ::-1]
    return pts


def _point_in_tri(p, a, b, c, eps=1e-12):
    d1 = (p[0] - b[0]) * (a[1] - b[1]) - (a[0] - b[0]) * (p[1] - b[1])
    d2 = (p[0] - c[0]) * (b[1] - c[1]) - (b[0] - c[0]) * (p[1] - c[1])
    d3 = (p[0] - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (p[1] - a[1])
    has_neg = (d1 < -eps) or (d2 < -eps) or (d3 < -eps)
    has_pos = (d1 > eps) or (d2 > eps) or (d3 > eps)
    return not (has_neg and has_pos)


def triangulate(vertices) -> np.ndarray:
    """Triangulate a simple 3D polygon → [T,3] int32 indices into it."""
    verts = np.asarray(vertices, np.float64)
    n = verts.shape[0]
    if n < 3:
        return np.zeros((0, 3), np.int32)
    if n == 3:
        return np.asarray([[0, 1, 2]], np.int32)
    if n == 4:
        # split at a concave corner if any (triangulator.rs:122)
        start = 0
        for i in range(4):
            v = verts[i]
            left = verts[(i + 3) % 4] - v
            diag = verts[(i + 2) % 4] - v
            right = verts[(i + 1) % 4] - v
            norms = [np.linalg.norm(x) for x in (left, diag, right)]
            if min(norms) < 1e-12:
                continue
            left, diag, right = left / norms[0], diag / norms[1], right / norms[2]
            angle = (np.arccos(np.clip(left @ diag, -1, 1))
                     + np.arccos(np.clip(right @ diag, -1, 1)))
            if angle > np.pi:
                start = i
                break
        return np.asarray([[start, (start + 1) % 4, (start + 2) % 4],
                           [start, (start + 2) % 4, (start + 3) % 4]], np.int32)

    pts = _project_2d(verts, polygon_normal(verts))
    # signed area > 0 → CCW; flip traversal for CW input
    area = np.sum(pts[:, 0] * np.roll(pts[:, 1], -1)
                  - np.roll(pts[:, 0], -1) * pts[:, 1])
    order = list(range(n)) if area >= 0 else list(range(n))[::-1]
    out = []
    guard = 0
    i = 0
    while len(order) > 3 and guard < 4 * n * n:
        guard += 1
        k = len(order)
        ip, ie, inx = order[(i - 1) % k], order[i % k], order[(i + 1) % k]
        a, b, c = pts[ip], pts[ie], pts[inx]
        convex = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0]) > 1e-12
        ear = convex and not any(
            _point_in_tri(pts[j], a, b, c)
            for j in order if j not in (ip, ie, inx))
        if ear:
            out.append([ip, ie, inx])
            order.pop(i % k)
            i = max(i - 1, 0)
        else:
            i = (i + 1) % len(order)
    out.append(list(order[:3]))
    return np.asarray(out, np.int32)
