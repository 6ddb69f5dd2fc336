"""2D blend spaces: triangulated parameter-space pose blending
(fyrox-animation machine/node/blendspace.rs).

Points in a 2D parameter space (say strafe and forward speed) each own a
clip. Sampling at (x, y) finds the Delaunay triangle holding the point and
blends its three corners' poses by barycentric weights (blendspace.rs:338
``fetch_weights``); outside the triangulation the closest edge's
projection is used.

The template is host numpy: points [P,2], a clip per point [P] and the
triangles [T,3] (Bowyer-Watson at build time; the reference triangulates
with the ``spade`` crate on every point edit, blendspace.rs:417).
``sample_weights`` tests every world's point against every triangle at
once.

As in the JAX package, the edge projection's t is clamped to [0, 1], so
the corner regions beyond a vertex take that vertex, where the reference
returns no pose; wherever the reference has a pose, the two agree.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fyrox_tpu_torch._util import const
from fyrox_tpu_torch.animation import pose as pose_mod

__all__ = ["BlendSpaceTemplate", "build_blend_space", "delaunay",
           "sample_weights", "blendspace_pose"]


def delaunay(points: np.ndarray) -> np.ndarray:
    """Bowyer-Watson Delaunay triangulation of points [P,2] (host, build
    time). Returns [T,3] int32 corner indices; collinear or fewer than 3
    points give none (the runtime then projects on the chain's segments,
    as the reference does for 2-point spaces, blendspace.rs:349)."""
    pts = np.asarray(points, np.float64)
    p = pts.shape[0]
    if p < 3:
        return np.zeros((0, 3), np.int32)
    cmin, cmax = pts.min(0), pts.max(0)
    d = max((cmax - cmin).max(), 1.0) * 20.0
    mid = (cmin + cmax) / 2
    sup = np.asarray([[mid[0] - d, mid[1] - d],
                      [mid[0] + d, mid[1] - d],
                      [mid[0], mid[1] + d]])
    verts = np.concatenate([pts, sup], 0)
    tris = [(p, p + 1, p + 2)]

    def circumcircle_contains(tri, q):
        a, b, c = verts[tri[0]], verts[tri[1]], verts[tri[2]]
        m = np.asarray([
            [a[0] - q[0], a[1] - q[1], (a[0] - q[0]) ** 2 + (a[1] - q[1]) ** 2],
            [b[0] - q[0], b[1] - q[1], (b[0] - q[0]) ** 2 + (b[1] - q[1]) ** 2],
            [c[0] - q[0], c[1] - q[1], (c[0] - q[0]) ** 2 + (c[1] - q[1]) ** 2],
        ])
        det = np.linalg.det(m)
        orient = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        return det * np.sign(orient) > 1e-12

    for i in range(p):
        bad = [t for t in tris if circumcircle_contains(t, verts[i])]
        # the hole's boundary: edges not shared by two bad triangles
        edges = {}
        for t in bad:
            for e in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
                key = (min(e), max(e))
                edges[key] = edges.get(key, 0) + 1
        tris = [t for t in tris if t not in bad]
        for (ea, eb), cnt in edges.items():
            if cnt == 1:
                tris.append((ea, eb, i))
    out = [t for t in tris if max(t) < p]
    return (np.asarray(out, np.int32) if out else np.zeros((0, 3), np.int32))


@dataclass
class BlendSpaceTemplate:
    points: np.ndarray      # [P,2] f32 parameter-space positions
    clips: np.ndarray       # [P] int32 clip per point
    triangles: np.ndarray   # [T,3] int32

    @property
    def num_points(self):
        return int(self.points.shape[0])

    def edges(self):
        """(a, b) int64 endpoints of the segments the edge projection
        tries: every triangle's 3 edges, or the point chain's segments
        when there is no triangle. Cached host arrays."""
        if getattr(self, "_edges", None) is None:
            if self.triangles.shape[0]:
                tri = self.triangles.astype(np.int64)
                self._edges = (tri.reshape(-1),
                               np.roll(tri, -1, axis=1).reshape(-1))
            else:
                i = np.arange(self.num_points - 1, dtype=np.int64)
                self._edges = (i, i + 1)
        return self._edges


def build_blend_space(points, clips) -> BlendSpaceTemplate:
    pts = np.asarray(points, np.float32).reshape(-1, 2)
    return BlendSpaceTemplate(points=pts, clips=np.asarray(clips, np.int32),
                              triangles=delaunay(pts))


def _take(x, idx):
    """x [W,E] at idx [W] → [W]."""
    return torch.gather(x, 1, idx[:, None])[:, 0]


def _closest_edge(pts, ea, eb, xy):
    """The edge projection: per world the closest of the segments (ea,
    eb) with its clamped t. Returns (idx [W,3], weights [W,3])."""
    pa, pb = pts[ea], pts[eb]                                # [E,2]
    edge = pb - pa
    to_pt = xy[:, None, :] - pa[None]                        # [W,E,2]
    t = torch.sum(to_pt * edge[None], -1) / torch.clamp(
        torch.sum(edge * edge, -1)[None], min=1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    proj = pa[None] + t[..., None] * edge[None]
    dist = torch.sum((xy[:, None, :] - proj) ** 2, -1)       # [W,E]
    best = torch.argmin(dist, -1)
    tb = _take(t, best)
    idx = torch.stack([ea[best], eb[best], ea[best]], -1)
    return idx, torch.stack([1.0 - tb, tb, torch.zeros_like(tb)], -1)


def sample_weights(bst: BlendSpaceTemplate, xy):
    """Batched fetch_weights (blendspace.rs:338): xy [W,2] → (idx [W,3]
    int32 point indices, w [W,3] f32 weights, normalized)."""
    w_, dev = xy.shape[0], xy.device
    p = bst.num_points
    if p <= 1:
        w = torch.zeros((w_, 3), dtype=torch.float32, device=dev)
        if p == 1:
            w[:, 0] = 1.0
        return torch.zeros((w_, 3), dtype=torch.int32, device=dev), w
    pts = const(bst.points, dev)                                    # [P,2]
    ea, eb = (const(e, dev) for e in bst.edges())
    e_idx, e_w = _closest_edge(pts, ea, eb, xy)
    if bst.triangles.shape[0] == 0:
        return e_idx.to(torch.int32), e_w

    tri = const(bst.triangles, dev).long()                          # [T,3]
    a, b, c = pts[tri[:, 0]], pts[tri[:, 1]], pts[tri[:, 2]]
    # barycentric coordinates of xy in every triangle
    # (math::get_barycentric_coords_2d)
    v0 = b - a
    v1 = c - a
    v2 = xy[:, None, :] - a[None]                                   # [W,T,2]
    d00 = torch.sum(v0 * v0, -1)[None]
    d01 = torch.sum(v0 * v1, -1)[None]
    d11 = torch.sum(v1 * v1, -1)[None]
    d20 = torch.sum(v2 * v0[None], -1)
    d21 = torch.sum(v2 * v1[None], -1)
    det = d00 * d11 - d01 * d01
    denom = torch.clamp(torch.abs(det), min=1e-12) * torch.sign(det + 1e-30)
    v = (d11 * d20 - d01 * d21) / denom                             # [W,T]
    w3 = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - v - w3
    eps = 1e-5
    inside = (u >= -eps) & (v >= -eps) & (w3 >= -eps)
    any_inside = inside.any(-1)
    first = torch.argmax(inside.to(torch.uint8), -1)
    bar = torch.stack([_take(u, first), _take(v, first), _take(w3, first)],
                      -1)
    idx = torch.where(any_inside[:, None], tri[first], e_idx)
    w = torch.where(any_inside[:, None], bar, e_w)
    w = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-8)
    return idx.to(torch.int32), w


def blendspace_pose(bst: BlendSpaceTemplate, xy, poses: pose_mod.PoseSet):
    """The blend space's pose at xy [W,2] from sampled clip poses: the
    3-way weighted blend (eval_pose, blendspace.rs:120) by sequential
    normalized accumulation, as AnimationPose::blend_with chains."""
    idx, w = sample_weights(bst, xy)
    clips = const(bst.clips, xy.device).long()[idx.long()]          # [W,3]
    acc = pose_mod.select_anim_pose(poses, clips[:, 0])
    cum = w[:, 0]
    for k in range(1, 3):
        pk = pose_mod.select_anim_pose(poses, clips[:, k])
        new_cum = cum + w[:, k]
        frac = torch.where(new_cum > 1e-8,
                           w[:, k] / torch.clamp(new_cum, min=1e-8),
                           torch.zeros_like(new_cum))
        acc = pose_mod.blend_pose(acc, pk, frac)
        cum = new_cum
    return acc
