"""Host-side spatial utilities: octree, quadtree, rectangle packer.

The remaining fyrox-core/fyrox-math accel rows:
  * Octree (fyrox-math/src/octree.rs; engine wrapper scene/accel.rs:53
    `sphere_query` :85, `aabb_query` :113) — host-side queries over
    authoring-time geometry (picking, editor tools, navmesh bakes). The
    batched device path stays dense by design (SURVEY §7); this octree
    serves the host-side API surface.
  * QuadTree (fyrox-core/src/quadtree.rs) — the 2D specialization.
  * RectPack (fyrox-core/src/rectpack.rs) — guillotine rectangle packing
    for texture atlases (font/lightmap pages).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["Octree", "QuadTree", "RectPacker"]


class _Tree:
    """Shared N-d loose bounding-volume tree over item AABBs."""

    def __init__(self, mins, maxs, dim, max_items=8, max_depth=8):
        self.mins = np.asarray(mins, np.float64).reshape(-1, dim)
        self.maxs = np.asarray(maxs, np.float64).reshape(-1, dim)
        self.dim = dim
        self.max_items = max_items
        self.max_depth = max_depth
        root_min = (self.mins.min(0) if len(self.mins) else np.zeros(dim))
        root_max = (self.maxs.max(0) if len(self.maxs) else np.ones(dim))
        self.root = self._build(np.arange(len(self.mins)),
                                root_min, root_max, 0)

    def _build(self, idx, bmin, bmax, depth):
        node = dict(bmin=bmin, bmax=bmax, items=idx, children=None)
        if len(idx) <= self.max_items or depth >= self.max_depth:
            return node
        centre = (bmin + bmax) * 0.5
        children = []
        for code in range(1 << self.dim):
            cmin = np.where([code >> a & 1 for a in range(self.dim)],
                            centre, bmin)
            cmax = np.where([code >> a & 1 for a in range(self.dim)],
                            bmax, centre)
            inside = idx[np.all((self.mins[idx] <= cmax)
                                & (self.maxs[idx] >= cmin), axis=1)]
            children.append(self._build(inside, cmin, cmax, depth + 1))
        node["items"] = np.zeros(0, np.int64)
        node["children"] = children
        return node

    def aabb_query(self, qmin, qmax):
        """Item indices whose AABB overlaps [qmin, qmax] (accel.rs:113)."""
        qmin = np.asarray(qmin, np.float64)
        qmax = np.asarray(qmax, np.float64)
        out = set()
        stack = [self.root]
        while stack:
            n = stack.pop()
            if np.any(qmin > n["bmax"]) or np.any(qmax < n["bmin"]):
                continue
            for i in n["items"]:
                if np.all(self.mins[i] <= qmax) and np.all(self.maxs[i] >= qmin):
                    out.add(int(i))
            if n["children"]:
                stack.extend(n["children"])
        return sorted(out)

    def sphere_query(self, centre, radius):
        """Item indices whose AABB intersects the sphere (accel.rs:85)."""
        centre = np.asarray(centre, np.float64)
        cands = self.aabb_query(centre - radius, centre + radius)
        out = []
        for i in cands:
            closest = np.clip(centre, self.mins[i], self.maxs[i])
            if np.sum((closest - centre) ** 2) <= radius * radius:
                out.append(i)
        return out

    def ray_query(self, origin, direction, max_t=np.inf):
        """Item indices whose AABB the ray hits (slab test), nearest first."""
        o = np.asarray(origin, np.float64)
        d = np.asarray(direction, np.float64)
        inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
        hits = []
        for i in self.aabb_query(np.minimum(o, o + d * min(max_t, 1e9)),
                                 np.maximum(o, o + d * min(max_t, 1e9))):
            t0 = (self.mins[i] - o) * inv
            t1 = (self.maxs[i] - o) * inv
            tn = np.max(np.minimum(t0, t1))
            tf = np.min(np.maximum(t0, t1))
            if tf >= max(tn, 0.0) and tn <= max_t:
                hits.append((max(tn, 0.0), i))
        return [i for _, i in sorted(hits)]


class Octree(_Tree):
    """3D (fyrox-math/src/octree.rs)."""

    def __init__(self, mins, maxs, max_items=8, max_depth=8):
        super().__init__(mins, maxs, 3, max_items, max_depth)


class QuadTree(_Tree):
    """2D (fyrox-core/src/quadtree.rs)."""

    def __init__(self, mins, maxs, max_items=8, max_depth=8):
        super().__init__(mins, maxs, 2, max_items, max_depth)


class RectPacker:
    """Guillotine rectangle packer (fyrox-core/src/rectpack.rs): atlas
    placement for fonts/lightmaps. `pack(w, h)` → (x, y) or None."""

    def __init__(self, width, height):
        self.width = width
        self.height = height
        self._free: List[Tuple[float, float, float, float]] = [
            (0.0, 0.0, float(width), float(height))]

    def pack(self, w, h) -> Optional[Tuple[float, float]]:
        best = None
        for k, (fx, fy, fw, fh) in enumerate(self._free):
            if w <= fw and h <= fh:
                waste = fw * fh - w * h
                if best is None or waste < best[0]:
                    best = (waste, k)
        if best is None:
            return None
        _, k = best
        fx, fy, fw, fh = self._free.pop(k)
        # guillotine split along the longer leftover axis
        if fw - w >= fh - h:
            right = (fx + w, fy, fw - w, fh)
            below = (fx, fy + h, w, fh - h)
        else:
            right = (fx + w, fy, fw - w, h)
            below = (fx, fy + h, fw, fh - h)
        for r in (right, below):
            if r[2] > 0 and r[3] > 0:
                self._free.append(r)
        return (fx, fy)
