"""Navigation meshes + agents (the port's copy of
``fyrox_tpu.utils.navmesh``; host numpy).

Equivalent of fyrox-impl/src/utils/navmesh.rs (`Navmesh` triangle mesh +
`build_path` :569 A*-over-triangles with funnel/portal smoothing, and
`NavmeshAgent` :642 with `calculate_path`/steering). Query-side runs
host-side per the reference's usage; the resulting waypoint paths feed the
batched simulation as padded arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from fyrox_tpu_torch.utils import astar as astar_mod

__all__ = ["Navmesh", "NavmeshAgent"]


@dataclass
class Navmesh:
    vertices: np.ndarray    # [V,3]
    triangles: np.ndarray   # [T,3]

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, np.float32)
        self.triangles = np.asarray(self.triangles, np.int32)
        # weld coincident vertices so triangles authored as separate quads
        # still share edges for adjacency (tolerance 1e-5)
        key = np.round(self.vertices / 1e-5).astype(np.int64)
        _, first, inverse = np.unique(key, axis=0, return_index=True,
                                      return_inverse=True)
        self.triangles = inverse[self.triangles].astype(np.int32)
        t = self.triangles
        self._centers = self.vertices[t].mean(axis=1)
        # triangle adjacency via shared edges
        edge_map = {}
        self._neighbors: List[List[int]] = [[] for _ in range(len(t))]
        self._portals = {}
        for ti, tri in enumerate(t):
            for k in range(3):
                a, b = int(tri[k]), int(tri[(k + 1) % 3])
                key = (min(a, b), max(a, b))
                if key in edge_map:
                    tj = edge_map[key]
                    self._neighbors[ti].append(tj)
                    self._neighbors[tj].append(ti)
                    self._portals[(ti, tj)] = key
                    self._portals[(tj, ti)] = key
                else:
                    edge_map[key] = ti

    def triangle_containing(self, p) -> int:
        """Closest triangle by projected barycentric containment, falling
        back to nearest center."""
        p = np.asarray(p, np.float32)
        v = self.vertices[self.triangles]           # [T,3,3]
        # 2D (xz-plane) barycentric test, the common navmesh case
        a, b, c = v[:, 0], v[:, 1], v[:, 2]
        def cross2(o, q, r):
            return ((q[..., 0] - o[..., 0]) * (r[..., 2] - o[..., 2])
                    - (q[..., 2] - o[..., 2]) * (r[..., 0] - o[..., 0]))
        d0 = cross2(a, b, p[None])
        d1 = cross2(b, c, p[None])
        d2 = cross2(c, a, p[None])
        inside = ((d0 >= 0) & (d1 >= 0) & (d2 >= 0)) | \
                 ((d0 <= 0) & (d1 <= 0) & (d2 <= 0))
        hits = np.nonzero(inside)[0]
        if len(hits):
            return int(hits[0])
        return int(np.argmin(np.linalg.norm(self._centers - p, axis=-1)))

    def build_path(self, start, goal) -> np.ndarray:
        """World-space waypoint path start→goal: triangle A* + funnel
        smoothing (navmesh.rs:569). Returns [K,3] waypoints (empty when
        unreachable)."""
        ts = self.triangle_containing(start)
        tg = self.triangle_containing(goal)
        tri_path = astar_mod.astar(self._centers, self._neighbors, ts, tg)
        if not tri_path:
            return np.zeros((0, 3), np.float32)
        if len(tri_path) == 1:
            return np.asarray([start, goal], np.float32)

        # portal list between consecutive triangles
        portals = []
        for ti, tj in zip(tri_path[:-1], tri_path[1:]):
            a, b = self._portals[(ti, tj)]
            portals.append((self.vertices[a], self.vertices[b]))

        return self._funnel(np.asarray(start, np.float32),
                            np.asarray(goal, np.float32), portals)

    @staticmethod
    def _funnel(start, goal, portals) -> np.ndarray:
        """Simple stupid funnel algorithm over the portal edges (2D xz)."""
        def tri_area2(a, b, c):
            return ((b[0] - a[0]) * (c[2] - a[2])
                    - (b[2] - a[2]) * (c[0] - a[0]))

        # orient portals left/right relative to travel direction
        lefts, rights = [], []
        apexish = start
        for (a, b) in portals:
            if tri_area2(apexish, a, b) < 0:
                lefts.append(a); rights.append(b)
            else:
                lefts.append(b); rights.append(a)
            apexish = 0.5 * (a + b)
        lefts.append(goal)
        rights.append(goal)

        path = [start]
        apex, left, right = start, lefts[0], rights[0]
        li = ri = 0
        i = 1
        while i < len(lefts):
            nl, nr = lefts[i], rights[i]
            # tighten right
            if tri_area2(apex, right, nr) >= 0:
                if np.allclose(apex, right) or tri_area2(apex, left, nr) < 0:
                    right = nr
                    ri = i
                else:
                    path.append(left)
                    apex = left
                    left, right = apex, apex
                    i = li = ri = li + 1
                    continue
            # tighten left
            if tri_area2(apex, left, nl) <= 0:
                if np.allclose(apex, left) or tri_area2(apex, right, nl) > 0:
                    left = nl
                    li = i
                else:
                    path.append(right)
                    apex = right
                    left, right = apex, apex
                    i = li = ri = ri + 1
                    continue
            i += 1
        path.append(goal)
        # dedupe consecutive duplicates
        out = [path[0]]
        for p in path[1:]:
            if not np.allclose(p, out[-1]):
                out.append(p)
        return np.asarray(out, np.float32)


@dataclass
class NavmeshAgent:
    """Steering agent following a navmesh path (navmesh.rs:642)."""
    position: np.ndarray
    speed: float = 1.0
    _path: Optional[np.ndarray] = None
    _wp: int = 0

    def calculate_path(self, navmesh: Navmesh, goal) -> bool:
        self._path = navmesh.build_path(self.position, goal)
        self._wp = 0
        return len(self._path) > 0

    @property
    def path(self):
        return self._path

    def update(self, dt: float):
        """Advance toward the next waypoint (steering, navmesh.rs:730)."""
        if self._path is None or self._wp >= len(self._path):
            return
        target = self._path[self._wp]
        to = target - self.position
        d = float(np.linalg.norm(to))
        step = self.speed * dt
        if d <= step or d < 1e-6:
            self.position = np.asarray(target, np.float32)
            self._wp += 1
        else:
            self.position = (self.position + to / d * step).astype(np.float32)
