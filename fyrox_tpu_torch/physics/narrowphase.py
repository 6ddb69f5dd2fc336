"""Contact generation (narrowphase) of the dense and grid broadphase
paths, batched over candidate pairs: the port of
``fyrox_tpu/physics/narrowphase.py``.

Each pair routine takes pair-aligned collider world poses and params and
emits a fixed 4-point manifold:

    normal  [..., 3]    from A toward B (world)
    points  [..., 4, 3] world contact positions
    depth   [..., 4]    penetration depth (> 0 = overlapping); a point with
                        depth > -prediction is active (speculative)
    active  [..., 4]    bool

Pairs arrive canonical (effective kind of A <= kind of B). The dense
template's pair list is sorted by kind, so ``generate_contacts_flat`` runs
each routine on its own contiguous slice and emits the compact layout
(``KIND_POINTS`` slots a pair); compacted mode (``max_active_pairs`` > 0)
has pairs of any kind in its slots and runs every routine on every slot,
selecting by kind (``generate_contacts``); the grid broadphase's
per-class pair lists run only their class's routines
(``generate_contacts_class``).

Convex hulls (CONVEX, and cylinders / cones with their registered 12-gon
hulls) go through the SAT routines of physics/convex.py, and pairs with a
heightfield or trimesh through the point-sample routines of
physics/scenery.py; the template's hull and scenery tables reach them as
the per-pair host arrays of ``_hull_gather`` / ``_scenery_kernel``, in
slices of at most ``CHUNK_SLOTS`` (world, pair) slots so that the
routines' [slots, faces, vertices, 3] intermediates stay bounded.

Where JAX's reductions choose an index (argmin / argmax over 3 axes, the 4
deepest of a box's 8 corners, a hull's face or support vertex), the port
counts comparisons or takes the lowest index among equals, so ties go the
way XLA's do, on either device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch._util import const
from fyrox_tpu_torch.physics import shapes as sh

__all__ = ["Manifold", "generate_contacts", "generate_contacts_flat",
           "flat_contact_layout", "effective_kind", "KIND_POINTS",
           "KIND_KERNELS", "CLASS_COMBOS", "CLASS_COMBOS_CONVEX",
           "generate_contacts_class", "convex_pair",
           "scenery_pair", "CHUNK_SLOTS"]

_EPS = 1e-9
_UP = np.array([0.0, 1.0, 0.0], np.float32)
_EYE3 = np.eye(3, dtype=np.float32)
# the 8 corner signs of a box, in the JAX package's order
_CORNERS = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                     for sz in (-1, 1)], np.float32)


class Manifold(NamedTuple):
    normal: torch.Tensor   # [...,3] A→B
    points: torch.Tensor   # [...,4,3]
    depth: torch.Tensor    # [...,4]
    active: torch.Tensor   # [...,4] bool


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _norm(v):
    """sqrt(Σ v²) over the last axis, as jnp.linalg.norm computes it."""
    return torch.sqrt(torch.sum(v * v, -1))


def _empty_like(pos):
    shape = pos.shape[:-1]
    return Manifold(
        normal=pos.new_zeros(shape + (3,)),
        points=pos.new_zeros(shape + (4, 3)),
        depth=pos.new_full(shape + (4,), -1e9),
        active=torch.zeros(shape + (4,), dtype=torch.bool,
                           device=pos.device))


def _safe_normalize(v, fallback):
    n = _norm(v)[..., None]
    return (torch.where(n > _EPS, v / torch.clamp(n, min=_EPS), fallback),
            n[..., 0])


def _predn(pred):
    """pred against multi-point depths [..., n]: a trailing length-1 axis."""
    return torch.as_tensor(pred)[..., None] if torch.is_tensor(pred) \
        else pred


def _one_point(m: Manifold, normal, point, depth, valid):
    pts = torch.cat([point[..., None, :], m.points[..., 1:, :]], -2)
    dep = torch.cat([depth[..., None], m.depth[..., 1:]], -1)
    act = torch.cat([valid[..., None], m.active[..., 1:]], -1)
    return Manifold(normal, pts, dep, act)


def repeat_slots(x, n):
    """x [W,P,...] with each pair's row repeated n times along axis 1 →
    [W,P*n,...] (jnp.repeat(x, n, axis=1), as a broadcast and a copy)."""
    w, p = x.shape[:2]
    return x.unsqueeze(2).expand((w, p, n) + tuple(x.shape[2:])).reshape(
        (w, p * n) + tuple(x.shape[2:]))


def _onehot3(i, like):
    """Rows of the 3×3 identity at integer indices i [...] → [..., 3]."""
    return (i[..., None] == torch.arange(3, device=i.device)).to(like.dtype)


def _argmin3(x):
    """First index of the least of x[..., 0:3] (jnp.argmin's tie rule)."""
    a, b, c = x.unbind(-1)
    return torch.where((a <= b) & (a <= c), 0, torch.where(b <= c, 1, 2))


def _argmax3(x):
    """First index of the greatest of x[..., 0:3] (jnp.argmax's tie rule)."""
    a, b, c = x.unbind(-1)
    return torch.where((a >= b) & (a >= c), 0, torch.where(b >= c, 1, 2))


# --------------------------------------------------------------------------
# sphere family
# --------------------------------------------------------------------------

def ball_ball(pa, ra, pb, rb, pred):
    d = pb - pa
    n, dist = _safe_normalize(d, const(_UP, d.device).expand(d.shape))
    depth = ra + rb - dist
    point = pa + n * (ra - 0.5 * depth)[..., None]
    return _one_point(_empty_like(pa), n, point, depth, depth > -pred)


def ball_cuboid(pa, ra, pb, rot_b, half_b, pred):
    """Sphere A vs box B (rot_b [...,3,3] world←local)."""
    rel = torch.sum(rot_b * (pa - pb)[..., :, None], -2)   # R^T (pa - pb)
    clamped = torch.maximum(torch.minimum(rel, half_b), -half_b)
    delta = rel - clamped
    dist = _norm(delta)
    outside = dist > _EPS
    n_out = delta / torch.clamp(dist[..., None], min=_EPS)
    pen_axis = half_b - torch.abs(rel)
    e_ax = _onehot3(_argmin3(pen_axis), rel)
    sign = torch.sign(torch.sum(rel * e_ax, -1))
    sign = torch.where(sign == 0, 1.0, sign)
    n_in = e_ax * sign[..., None]
    depth_out = ra - dist
    depth_in = ra + torch.min(pen_axis, -1).values
    n_local = torch.where(outside[..., None], n_out, n_in)
    depth = torch.where(outside, depth_out, depth_in)
    surface_local = torch.where(
        outside[..., None], clamped,
        clamped * (1 - e_ax) + (half_b * e_ax * sign[..., None]))
    n_world = torch.sum(rot_b * n_local[..., None, :], -1)
    p_world = pb + torch.sum(rot_b * surface_local[..., None, :], -1)
    return _one_point(_empty_like(pa), -n_world, p_world, depth,
                      depth > -pred)


def _segment_endpoints(p, rot, hh):
    axis = rot[..., :, 1]  # local +Y column
    return p - axis * hh[..., None], p + axis * hh[..., None]


def _closest_point_on_segment(a, b, p):
    ab = b - a
    t = (torch.sum((p - a) * ab, -1)
         / torch.clamp(torch.sum(ab * ab, -1), min=_EPS))
    t = torch.clamp(t, 0.0, 1.0)
    return a + ab * t[..., None]


def ball_capsule(pa, ra, pb, rot_b, hh_b, rb, pred):
    s0, s1 = _segment_endpoints(pb, rot_b, hh_b)
    c = _closest_point_on_segment(s0, s1, pa)
    return ball_ball(pa, ra, c, rb, pred)


def _closest_segment_segment(a0, a1, b0, b1):
    """Closest points between two segments (batched, branch-free)."""
    d1 = a1 - a0
    d2 = b1 - b0
    r = a0 - b0
    a = torch.sum(d1 * d1, -1)
    e = torch.sum(d2 * d2, -1)
    f = torch.sum(d2 * r, -1)
    c = torch.sum(d1 * r, -1)
    b = torch.sum(d1 * d2, -1)
    denom = a * e - b * b
    s = torch.where(denom > _EPS,
                    torch.clamp((b * f - c * e)
                                / torch.clamp(denom, min=_EPS), 0, 1), 0.0)
    t = (b * s + f) / torch.clamp(e, min=_EPS)
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.clamp((b * t_cl - c) / torch.clamp(a, min=_EPS), 0.0, 1.0)
    t = torch.clamp((b * s + f) / torch.clamp(e, min=_EPS), 0.0, 1.0)
    return a0 + d1 * s[..., None], b0 + d2 * t[..., None]


def capsule_capsule(pa, rot_a, hh_a, ra, pb, rot_b, hh_b, rb, pred):
    a0, a1 = _segment_endpoints(pa, rot_a, hh_a)
    b0, b1 = _segment_endpoints(pb, rot_b, hh_b)
    ca, cb = _closest_segment_segment(a0, a1, b0, b1)
    return ball_ball(ca, ra, cb, rb, pred)


def capsule_cuboid(pa, rot_a, hh_a, ra, pb, rot_b, half_b, pred):
    """Capsule A vs box B: a sphere query at each segment end (2 points)."""
    a0, a1 = _segment_endpoints(pa, rot_a, hh_a)
    m0 = ball_cuboid(a0, ra, pb, rot_b, half_b, pred)
    m1 = ball_cuboid(a1, ra, pb, rot_b, half_b, pred)
    m = _empty_like(pa)
    deeper0 = m0.depth[..., 0] >= m1.depth[..., 0]
    normal = torch.where(deeper0[..., None], m0.normal, m1.normal)
    pts = torch.cat([m0.points[..., :1, :], m1.points[..., :1, :],
                     m.points[..., 2:, :]], -2)
    dep = torch.cat([m0.depth[..., :1], m1.depth[..., :1],
                     m.depth[..., 2:]], -1)
    act = torch.cat([m0.active[..., :1], m1.active[..., :1],
                     m.active[..., 2:]], -1)
    return Manifold(normal, pts, dep, act)


# --------------------------------------------------------------------------
# halfspace family (plane normal = collider local +Y)
# --------------------------------------------------------------------------

def _halfspace_frame(pp, rot_p):
    n = rot_p[..., :, 1]
    return n, torch.sum(n * pp, -1)   # plane normal, offset (n·x = d)


def ball_halfspace(pa, ra, pp, rot_p, pred):
    n, d = _halfspace_frame(pp, rot_p)
    dist = torch.sum(n * pa, -1) - d
    depth = ra - dist
    point = pa - n * dist[..., None]
    return _one_point(_empty_like(pa), -n, point, depth, depth > -pred)


def cuboid_halfspace(pa, rot_a, half_a, pp, rot_p, pred):
    """Box vs plane: the 4 deepest corners, deepest first, ties to the
    lower corner index (XLA's top_k order)."""
    n, d = _halfspace_frame(pp, rot_p)
    corners_local = const(_CORNERS, pa.device) * half_a[..., None, :]
    corners = pa[..., None, :] + torch.sum(
        rot_a[..., None, :, :] * corners_local[..., None, :], -1)   # [...,8,3]
    depth = d[..., None] - torch.sum(n[..., None, :] * corners, -1)  # [...,8]
    # rank of corner i: corners deeper than it, or as deep at a lower index
    di, dj = depth[..., :, None], depth[..., None, :]
    idx = torch.arange(8, device=pa.device)
    before = (dj > di) | ((dj == di) & (idx[None, :] < idx[:, None]))
    rank = before.sum(-1)                                           # [...,8]
    oh = (rank[..., None, :] == torch.arange(4, device=pa.device)[:, None]
          ).to(pa.dtype)                                            # [...,4,8]
    pts = torch.sum(oh[..., None] * corners[..., None, :, :], -2)
    top_d = torch.sum(oh * depth[..., None, :], -1)
    return Manifold(-n, pts, top_d, top_d > -_predn(pred))


def capsule_halfspace(pa, rot_a, hh_a, ra, pp, rot_p, pred):
    n, d = _halfspace_frame(pp, rot_p)
    a0, a1 = _segment_endpoints(pa, rot_a, hh_a)
    m = _empty_like(pa)
    pts, dep, act = [], [], []
    for e in (a0, a1):
        dist = torch.sum(n * e, -1) - d
        depth = ra - dist
        pts.append((e - n * dist[..., None])[..., None, :])
        dep.append(depth[..., None])
        act.append((depth > -pred)[..., None])
    return Manifold(-n, torch.cat(pts + [m.points[..., 2:, :]], -2),
                    torch.cat(dep + [m.depth[..., 2:]], -1),
                    torch.cat(act + [m.active[..., 2:]], -1))


# --------------------------------------------------------------------------
# cuboid-cuboid: SAT + reference face clipping
# --------------------------------------------------------------------------

def _box_axes(rot):
    return rot[..., :, 0], rot[..., :, 1], rot[..., :, 2]


def _face_vertices(p, rot, half, axis_dir):
    """The 4 vertices of the box face whose outward normal is closest to
    axis_dir, its centre, tangents and half-sizes."""
    ax = _box_axes(rot)
    dots = torch.stack([torch.sum(a * axis_dir, -1) for a in ax], -1)
    face_i = _argmax3(torch.abs(dots))
    fa = _onehot3(face_i, p)
    sign = torch.sign(torch.sum(dots * fa, -1))
    sign = torch.where(sign == 0, 1.0, sign)
    ta = _onehot3((face_i + 1) % 3, p)
    tb = _onehot3((face_i + 2) % 3, p)
    hn = torch.sum(half * fa, -1)
    ht1 = torch.sum(half * ta, -1)
    ht2 = torch.sum(half * tb, -1)
    n_l = fa * sign[..., None]
    corners = []
    for s1 in (-1, 1):
        for s2 in (-1, 1):
            c_local = (n_l * hn[..., None] + ta * (s1 * ht1)[..., None]
                       + tb * (s2 * ht2)[..., None])
            corners.append(p + torch.sum(rot * c_local[..., None, :], -1))
    t1_w = torch.sum(rot * ta[..., None, :], -1)
    t2_w = torch.sum(rot * tb[..., None, :], -1)
    center = p + torch.sum(rot * (n_l * hn[..., None])[..., None, :], -1)
    return torch.stack(corners, -2), center, t1_w, t2_w, ht1, ht2


def cuboid_cuboid(pa, rot_a, half_a, pb, rot_b, half_b, pred):
    """SAT over 6 face axes + 9 edge-cross axes; the manifold clips the
    incident face of B against the reference face of A (up to 4 points)."""
    d = pb - pa
    axes_a = _box_axes(rot_a)
    axes_b = _box_axes(rot_b)

    def face_pen(axis):
        ra = sum(half_a[..., i, None] * torch.abs(torch.sum(
            axes_a[i] * axis, -1, keepdim=True)) for i in range(3))[..., 0]
        rb = sum(half_b[..., i, None] * torch.abs(torch.sum(
            axes_b[i] * axis, -1, keepdim=True)) for i in range(3))[..., 0]
        return ra + rb - torch.abs(torch.sum(d * axis, -1))

    best_pen = pa.new_full(pa.shape[:-1], 1e9)
    best_axis = torch.zeros_like(d)
    for axis in (*axes_a, *axes_b):
        pen = face_pen(axis)
        better = pen < best_pen
        best_pen = torch.where(better, pen, best_pen)
        best_axis = torch.where(better[..., None], axis, best_axis)
    for i in range(3):
        for j in range(3):
            axis, ln = _safe_normalize(_cross(axes_a[i], axes_b[j]),
                                       best_axis)
            pen = face_pen(axis)
            better = (ln > 1e-6) & (pen < best_pen - 1e-6)
            best_pen = torch.where(better, pen, best_pen)
            best_axis = torch.where(better[..., None], axis, best_axis)

    flip = torch.sum(best_axis * d, -1) < 0
    normal = torch.where(flip[..., None], -best_axis, best_axis)

    _, ref_c, ref_t1, ref_t2, ref_h1, ref_h2 = _face_vertices(
        pa, rot_a, half_a, normal)
    inc_pts = _face_vertices(pb, rot_b, half_b, -normal)[0]
    rel = inc_pts - ref_c[..., None, :]
    u = torch.sum(rel * ref_t1[..., None, :], -1)
    v = torch.sum(rel * ref_t2[..., None, :], -1)
    u = torch.maximum(torch.minimum(u, ref_h1[..., None]), -ref_h1[..., None])
    v = torch.maximum(torch.minimum(v, ref_h2[..., None]), -ref_h2[..., None])
    clipped = (ref_c[..., None, :] + u[..., None] * ref_t1[..., None, :]
               + v[..., None] * ref_t2[..., None, :])
    plane_d = torch.sum(normal * ref_c, -1)
    depth = plane_d[..., None] - torch.sum(normal[..., None, :] * inc_pts, -1)
    active = (depth > -_predn(pred)) & (best_pen[..., None] > -_predn(pred))
    return Manifold(normal, clipped, depth, active)


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

def _k_ball_ball(pa6, pos_a, rot_a, pb6, pos_b, rot_b, pred):
    return ball_ball(pos_a, pa6[..., 0], pos_b, pb6[..., 0], pred)


def _k_ball_cuboid(pa6, pos_a, rot_a, pb6, pos_b, rot_b, pred):
    return ball_cuboid(pos_a, pa6[..., 0], pos_b, rot_b, pb6[..., :3], pred)


def _k_ball_capsule(pa6, pos_a, rot_a, pb6, pos_b, rot_b, pred):
    return ball_capsule(pos_a, pa6[..., 0], pos_b, rot_b, pb6[..., 0],
                        pb6[..., 1], pred)


def _k_ball_halfspace(pa6, pos_a, rot_a, pb6, pos_b, rot_b, pred):
    return ball_halfspace(pos_a, pa6[..., 0], pos_b, rot_b, pred)


def _k_cuboid_cuboid(pa6, pos_a, rot_a, pb6, pos_b, rot_b, pred):
    return cuboid_cuboid(pos_a, rot_a, pa6[..., :3], pos_b, rot_b,
                         pb6[..., :3], pred)


def _k_cuboid_capsule(pa6, pos_a, rot_a, pb6, pos_b, rot_b, pred):
    m = capsule_cuboid(pos_b, rot_b, pb6[..., 0], pb6[..., 1],
                       pos_a, rot_a, pa6[..., :3], pred)
    return Manifold(-m.normal, m.points, m.depth, m.active)


def _k_cuboid_halfspace(pa6, pos_a, rot_a, pb6, pos_b, rot_b, pred):
    return cuboid_halfspace(pos_a, rot_a, pa6[..., :3], pos_b, rot_b, pred)


def _k_capsule_capsule(pa6, pos_a, rot_a, pb6, pos_b, rot_b, pred):
    return capsule_capsule(pos_a, rot_a, pa6[..., 0], pa6[..., 1],
                           pos_b, rot_b, pb6[..., 0], pb6[..., 1], pred)


def _k_capsule_halfspace(pa6, pos_a, rot_a, pb6, pos_b, rot_b, pred):
    return capsule_halfspace(pos_a, rot_a, pa6[..., 0], pa6[..., 1],
                             pos_b, rot_b, pred)


def effective_kind(t):
    """Cylinder and cone collapse onto their capsule proxy (host int); the
    dense builder sends those with a registered hull to CONVEX."""
    return sh.CAPSULE if t in (sh.CYLINDER, sh.CONE) else t


# routine per canonical (effective kind a <= effective kind b) pair
KIND_KERNELS = {
    (sh.BALL, sh.BALL): _k_ball_ball,
    (sh.BALL, sh.CUBOID): _k_ball_cuboid,
    (sh.BALL, sh.CAPSULE): _k_ball_capsule,
    (sh.BALL, sh.HALFSPACE): _k_ball_halfspace,
    (sh.CUBOID, sh.CUBOID): _k_cuboid_cuboid,
    (sh.CUBOID, sh.CAPSULE): _k_cuboid_capsule,
    (sh.CUBOID, sh.HALFSPACE): _k_cuboid_halfspace,
    (sh.CAPSULE, sh.CAPSULE): _k_capsule_capsule,
    (sh.CAPSULE, sh.HALFSPACE): _k_capsule_halfspace,
}

# useful manifold points per canonical pair kind: the compact dense layout
# gives each pair this many contact slots
KIND_POINTS = {
    (sh.BALL, sh.BALL): 1,
    (sh.BALL, sh.CUBOID): 1,
    (sh.BALL, sh.CAPSULE): 1,
    (sh.BALL, sh.HALFSPACE): 1,
    (sh.CUBOID, sh.CUBOID): 4,
    (sh.CUBOID, sh.CAPSULE): 2,
    (sh.CUBOID, sh.HALFSPACE): 4,
    (sh.CAPSULE, sh.CAPSULE): 1,
    (sh.CAPSULE, sh.HALFSPACE): 2,
    (sh.BALL, sh.CONVEX): 1,
    (sh.CUBOID, sh.CONVEX): 4,
    (sh.CAPSULE, sh.CONVEX): 2,
    (sh.HALFSPACE, sh.CONVEX): 4,
    (sh.CONVEX, sh.CONVEX): 4,
    (sh.BALL, sh.HEIGHTFIELD): 1,
    (sh.CAPSULE, sh.HEIGHTFIELD): 2,
    (sh.CUBOID, sh.HEIGHTFIELD): 4,
    (sh.CONVEX, sh.HEIGHTFIELD): 4,
    (sh.BALL, sh.TRIMESH): 1,
    (sh.CAPSULE, sh.TRIMESH): 2,
    (sh.CUBOID, sh.TRIMESH): 4,
    (sh.CONVEX, sh.TRIMESH): 4,
}

# (world, pair) slots of one hull or scenery routine call: a slice's
# [slots, 64, 32, 3] edge-axis intermediates take ~24 KB a slot
CHUNK_SLOTS = 1 << 16


def _chunked(fn, w, n, *args):
    """fn over pair slices of at most CHUNK_SLOTS // w pairs: every tensor
    arg is [*, n, ...] along axis 1 (or has 1 there, broadcast), a Python
    scalar passes as is; the Manifolds concatenate along axis 1."""
    step = max(1, CHUNK_SLOTS // max(w, 1))
    if n <= step:
        return fn(*args)
    outs = []
    for s0 in range(0, n, step):
        s1 = min(n, s0 + step)
        outs.append(fn(*(a[:, s0:s1] if torch.is_tensor(a) and a.dim() >= 2
                         and a.shape[1] == n else a for a in args)))
    return Manifold(*(torch.cat(parts, 1) for parts in zip(*outs)))


def scenery_pair(ka, kb, hull_a, tab, pa6, pos_a, rot_a, pos_b, rot_b,
                 pred):
    """A canonical (dynamic kind, HEIGHTFIELD | TRIMESH) pair through the
    point-sample routines: sample the dynamic shape, contact every sample
    with the surface, keep the 4 deepest (narrowphase.py:462). hull_a:
    (verts, vmask) of a CONVEX A side; tab: per-pair (heights, size_x,
    size_z) or (tris, mask) tensors."""
    from fyrox_tpu_torch.physics import scenery as sc_mod
    from fyrox_tpu_torch.physics.convex import pick, pick3, top_k_first
    samples, radius = sc_mod.sample_points_for(ka, pa6, pos_a, rot_a,
                                               hull=hull_a)
    predn = pred if torch.is_tensor(pred) else torch.full(
        pos_a.shape[:-1], float(pred), device=pos_a.device)
    if kb == sh.HEIGHTFIELD:
        normal, p_w, depth, active = sc_mod.points_heightfield(
            samples, radius, pos_b, rot_b, *tab, predn)
    else:
        # a two-sided distance cannot represent the penetration of a
        # zero-radius sample: every sample gets a collision margin
        radius = torch.clamp(radius, min=0.04)
        normal, p_w, depth, active = sc_mod.points_trimesh(
            samples, radius, pos_b, rot_b, *tab, predn)
    n_s = depth.shape[-1]
    if n_s <= 4:
        pad = 4 - n_s
        return Manifold(
            normal, torch.cat([p_w, p_w.new_zeros(p_w.shape[:-2] + (pad, 3))],
                              -2),
            torch.cat([depth, depth.new_full(depth.shape[:-1] + (pad,),
                                             -1e9)], -1),
            torch.cat([active, active.new_zeros(active.shape[:-1] + (pad,))],
                      -1))
    top_d, top_i = top_k_first(torch.where(active, depth, -1e9), 4)
    act = pick(active, top_i) & (top_d > -1e8)
    return Manifold(normal, pick3(p_w, top_i), pick(depth, top_i), act)


def _scenery_kernel(ka, kb, scenery_ctx, hull_ctx, args, sl):
    """A kind-range slice of (ka, HEIGHTFIELD | TRIMESH) pairs with the
    template's host tables, in slices of CHUNK_SLOTS slots."""
    dev = args[1].device
    hull_a = (tuple(const(x, dev)[None]
                    for x in _hull_gather(hull_ctx, 0, sl)[:2])
              if ka == sh.CONVEX else ())
    tab = tuple(const(x, dev)[None]
                for x in _scenery_rows(scenery_ctx, kb, sl))
    nh = len(hull_a)

    def run(pa6, pos_a, rot_a, _pb6, pos_b, rot_b, pred, *rows):
        return scenery_pair(ka, kb, rows[:nh] or None, rows[nh:], pa6, pos_a,
                            rot_a, pos_b, rot_b, pred)

    return _chunked(run, args[1].shape[0], sl.stop - sl.start, *args,
                    *hull_a, *tab)


def _scenery_rows(scn_ctx, kb, sl):
    """Static per-pair scenery tables of one kind-range slice, built once
    per context: heightfield (heights, size_x, size_z), trimesh (tris,
    mask)."""
    (hf_heights, hf_size, col_hf, tm_tris, tm_mask, col_tm, _pair_a,
     pair_b) = scn_ctx
    key = (kb, sl.start, sl.stop)
    cache = _ROWS_CACHE.setdefault(id(pair_b), (pair_b, {}))[1]
    if key not in cache:
        if kb == sh.HEIGHTFIELD:
            idx = col_hf[pair_b[sl]]
            cache[key] = (np.ascontiguousarray(hf_heights[idx]),
                          np.ascontiguousarray(hf_size[idx, 0]),
                          np.ascontiguousarray(hf_size[idx, 1]))
        else:
            idx = col_tm[pair_b[sl]]
            cache[key] = (np.ascontiguousarray(tm_tris[idx]),
                          np.ascontiguousarray(tm_mask[idx]))
    return cache[key]


_ROWS_CACHE: dict = {}


def _hull_gather(hull_ctx, side, sl, cut=False):
    """Static per-pair hull arrays (verts, vmask, normals, nmask) of one
    kind-range slice (side 0: the pairs' A colliders, 1: B), built once
    per context; with `cut`, cut to the template's hull_widths (the SAT
    routines' inputs)."""
    from fyrox_tpu_torch.physics.convex import hull_widths
    hulls, col_hull, pair_a, pair_b = hull_ctx
    pairs = pair_a if side == 0 else pair_b
    key = (side, sl.start, sl.stop, cut)
    cache = _ROWS_CACHE.setdefault(id(pairs), (pairs, {}))[1]
    if key not in cache:
        idx = col_hull[pairs[sl]]
        nv, nf = (hull_widths(hulls.vmask, hulls.nmask) if cut
                  else hulls.vmask.shape[1:] + hulls.nmask.shape[1:])
        cache[key] = tuple(np.ascontiguousarray(x[idx][:, :n]) for x, n in
                           ((hulls.verts, nv), (hulls.vmask, nv),
                            (hulls.normals, nf), (hulls.nmask, nf)))
    return cache[key]


def _capsule_convex(pa6, pos_a, rot_a, pos_b, rot_b, vb, vmb, nb, nmb, pred):
    """Capsule vs hull: a ball at each segment end; the deeper end's
    normal (narrowphase.py:530)."""
    from fyrox_tpu_torch.physics import convex as cx
    a0, a1 = _segment_endpoints(pos_a, rot_a, pa6[..., 0])
    ra = pa6[..., 1]
    m0 = cx.ball_convex(a0, ra, pos_b, rot_b, vb, vmb, nb, nmb, pred)
    m1 = cx.ball_convex(a1, ra, pos_b, rot_b, vb, vmb, nb, nmb, pred)
    deeper0 = m0.depth[..., 0] >= m1.depth[..., 0]
    normal = torch.where(deeper0[..., None], m0.normal, m1.normal)
    return Manifold(
        normal,
        torch.cat([m0.points[..., :1, :], m1.points[..., :1, :],
                   m0.points[..., 2:, :]], -2),
        torch.cat([m0.depth[..., :1], m1.depth[..., :1], m0.depth[..., 2:]],
                  -1),
        torch.cat([m0.active[..., :1], m1.active[..., :1],
                   m0.active[..., 2:]], -1))


# convex combos per manifold-size class (canonical effective kinds): the
# slab path's hull routines (fyrox_tpu/physics/narrowphase.py:604,
# physics/slab2.py _convex_parts)
CLASS_COMBOS_CONVEX = {
    0: [(sh.BALL, sh.CONVEX)],
    1: [(sh.CAPSULE, sh.CONVEX)],
    2: [(sh.CUBOID, sh.CONVEX), (sh.HALFSPACE, sh.CONVEX),
        (sh.CONVEX, sh.CONVEX)],
}


def convex_pair(ka, hull_a, hull_b, pa6, pos_a, rot_a, pos_b, rot_b, pred):
    """A canonical (ka, CONVEX) pair: hull_a / hull_b are (verts, vmask,
    normals, nmask) tensors (hull_a only for a CONVEX A side)."""
    from fyrox_tpu_torch.physics import convex as cx
    vb, vmb, nb, nmb = hull_b
    if ka == sh.BALL:
        return cx.ball_convex(pos_a, pa6[..., 0], pos_b, rot_b, vb, vmb, nb,
                              nmb, pred)
    if ka == sh.CUBOID:
        va, vma, na, nma = cx.box_as_hull(pa6[..., :3], vb.shape[-2],
                                          nb.shape[-2])
        return cx.convex_convex(pos_a, rot_a, va, vma, na, nma, pos_b, rot_b,
                                vb, vmb, nb, nmb, pred)
    if ka == sh.CAPSULE:
        return _capsule_convex(pa6, pos_a, rot_a, pos_b, rot_b, vb, vmb, nb,
                               nmb, pred)
    if ka == sh.HALFSPACE:
        m = cx.convex_halfspace(pos_b, rot_b, vb, vmb, pos_a, rot_a, pred)
        return Manifold(-m.normal, m.points, m.depth, m.active)
    if ka == sh.CONVEX:
        return cx.convex_convex(pos_a, rot_a, *hull_a, pos_b, rot_b, vb, vmb,
                                nb, nmb, pred)
    raise NotImplementedError((ka, sh.CONVEX))


def _convex_kernel(ka, hull_a, hull_b, pa6, pos_a, rot_a, pb6, pos_b, rot_b,
                   pred):
    """A canonical (ka, CONVEX) pair slice with host hull arrays
    (narrowphase.py:517)."""
    dev = pos_a.device

    def dev_rows(h):
        return None if h is None else tuple(const(x, dev)[None] for x in h)

    ha, hb = dev_rows(hull_a), dev_rows(hull_b)

    def run(pa6, pos_a, rot_a, pos_b, rot_b, pred, *hulls):
        n_a = 4 if ka == sh.CONVEX else 0
        return convex_pair(ka, hulls[:n_a] or None, hulls[n_a:], pa6, pos_a,
                           rot_a, pos_b, rot_b, pred)

    return _chunked(run, pos_a.shape[0], pos_a.shape[1], pa6, pos_a, rot_a,
                    pos_b, rot_b, pred, *((ha or ()) + hb))


def flat_contact_layout(kind_ranges):
    """(pair_idx [K] int32, K): the pair of each slot of the compact dense
    layout, KIND_POINTS[kind] slots a pair."""
    idx = []
    for (ka, kb), s0, s1 in kind_ranges:
        npts = KIND_POINTS[(ka, kb)]
        for p in range(s0, s1):
            idx.extend([p] * npts)
    return np.asarray(idx, np.int32), len(idx)


def generate_contacts_flat(kind_ranges, params_a, pos_a, rot_a,
                           params_b, pos_b, rot_b, pred, hull_ctx=None,
                           scenery_ctx=None):
    """Kind-grouped narrowphase over the kind-sorted pair list [W,P]
    emitting the compact layout: dict(normal [W,K,3], point [W,K,3], depth
    [W,K], active [W,K]), K from flat_contact_layout. pred: [W,P] per-pair
    prediction distance (or a scalar). hull_ctx = (ConvexSet, col_hull,
    pair_a, pair_b) and scenery_ctx = (hf_heights, hf_size, col_hf,
    tm_tris, tm_mask, col_tm, pair_a, pair_b), the template's host arrays,
    where the pairs hold hulls or scenery."""
    normals, points, depths, actives = [], [], [], []
    for (ka, kb), s0, s1 in kind_ranges:
        npts = KIND_POINTS[(ka, kb)]
        sl = slice(s0, s1)
        pr = pred[:, s0:s1] if torch.is_tensor(pred) and pred.dim() >= 2 \
            else pred
        args = (params_a[:, sl], pos_a[:, sl], rot_a[:, sl],
                params_b[:, sl], pos_b[:, sl], rot_b[:, sl], pr)
        if kb == sh.CONVEX:
            m = _convex_kernel(
                ka, _hull_gather(hull_ctx, 0, sl, cut=True)
                if ka == sh.CONVEX else None,
                _hull_gather(hull_ctx, 1, sl, cut=True), *args)
        elif kb in (sh.HEIGHTFIELD, sh.TRIMESH):
            m = _scenery_kernel(ka, kb, scenery_ctx, hull_ctx, args, sl)
        else:
            m = KIND_KERNELS[(ka, kb)](*args)
        w = m.points.shape[0]
        normals.append(repeat_slots(m.normal, npts))
        points.append(m.points[:, :, :npts].reshape(w, -1, 3))
        depths.append(m.depth[:, :, :npts].reshape(w, -1))
        actives.append(m.active[:, :, :npts].reshape(w, -1))
    return dict(normal=torch.cat(normals, 1), point=torch.cat(points, 1),
                depth=torch.cat(depths, 1), active=torch.cat(actives, 1))


def _sel(cond, m_true: Manifold, m_false: Manifold) -> Manifold:
    c1 = cond[..., None]
    c2 = cond[..., None, None]
    return Manifold(torch.where(c1, m_true.normal, m_false.normal),
                    torch.where(c2, m_true.points, m_false.points),
                    torch.where(c1, m_true.depth, m_false.depth),
                    torch.where(c1, m_true.active, m_false.active))


# primitive kind combos per manifold-size class (canonical effective
# order); class 0 = 1 point, 1 = 2 points, 2 = 4 points (CLASS_NPTS)
CLASS_COMBOS = {
    0: [(sh.BALL, sh.BALL), (sh.BALL, sh.CUBOID), (sh.BALL, sh.CAPSULE),
        (sh.BALL, sh.HALFSPACE), (sh.CAPSULE, sh.CAPSULE)],
    1: [(sh.CUBOID, sh.CAPSULE), (sh.CAPSULE, sh.HALFSPACE)],
    2: [(sh.CUBOID, sh.CUBOID), (sh.CUBOID, sh.HALFSPACE)],
}


def generate_contacts_class(cls, type_a, params_a, pos_a, rot_a,
                            type_b, params_b, pos_b, rot_b, pred):
    """Manifolds of canonically ordered pairs known to lie in one
    manifold-size class (the grid broadphase compacts its candidates per
    class): only that class's primitive routines run, each on every slot,
    and the pair's effective kinds select. Inputs as generate_contacts;
    the point axis is cut to the class's size. The grid step carries no
    hull arrays, so hull and scenery pairs get no contact, as in the JAX
    package's grid path."""
    npts = {0: 1, 1: 2, 2: 4}[cls]

    def eff(t):
        return torch.where((t == sh.CYLINDER) | (t == sh.CONE), sh.CAPSULE, t)

    eff_a, eff_b = eff(type_a), eff(type_b)
    out = _empty_like(pos_a)
    for ka, kb in CLASS_COMBOS[cls]:
        m = KIND_KERNELS[(ka, kb)](params_a, pos_a, rot_a, params_b, pos_b,
                                   rot_b, pred)
        out = _sel((eff_a == ka) & (eff_b == kb), m, out)
    return Manifold(normal=out.normal, points=out.points[..., :npts, :],
                    depth=out.depth[..., :npts],
                    active=out.active[..., :npts])


def generate_contacts(type_a, params_a, pos_a, rot_a,
                      type_b, params_b, pos_b, rot_b, pred):
    """Manifolds of canonical pair-aligned collider arrays (compacted
    mode): every primitive routine runs on every slot and the pair's kind
    selects; cylinders and cones take their capsule proxy, and hulls and
    scenery, which this mode does not carry, get no contact, as in the
    JAX package. type_* [...] int; params_* [...,6]; pos_* [...,3];
    rot_* [...,3,3]."""
    def eff(t):
        return torch.where((t == sh.CYLINDER) | (t == sh.CONE), sh.CAPSULE, t)

    type_a, type_b = eff(type_a), eff(type_b)
    ra = params_a[..., 0]
    half_a = params_a[..., :3]
    hh_a, rcap_a = params_a[..., 0], params_a[..., 1]
    rb = params_b[..., 0]
    half_b = params_b[..., :3]
    hh_b, rcap_b = params_b[..., 0], params_b[..., 1]

    m_ck = capsule_cuboid(pos_b, rot_b, hh_b, rcap_b, pos_a, rot_a, half_a,
                          pred)
    mans = [
        ((sh.BALL, sh.BALL), ball_ball(pos_a, ra, pos_b, rb, pred)),
        ((sh.BALL, sh.CUBOID), ball_cuboid(pos_a, ra, pos_b, rot_b, half_b,
                                           pred)),
        ((sh.BALL, sh.CAPSULE), ball_capsule(pos_a, ra, pos_b, rot_b, hh_b,
                                             rcap_b, pred)),
        ((sh.BALL, sh.HALFSPACE), ball_halfspace(pos_a, ra, pos_b, rot_b,
                                                 pred)),
        ((sh.CUBOID, sh.CUBOID), cuboid_cuboid(pos_a, rot_a, half_a, pos_b,
                                               rot_b, half_b, pred)),
        ((sh.CUBOID, sh.HALFSPACE), cuboid_halfspace(pos_a, rot_a, half_a,
                                                     pos_b, rot_b, pred)),
        ((sh.CUBOID, sh.CAPSULE), Manifold(-m_ck.normal, m_ck.points,
                                           m_ck.depth, m_ck.active)),
        ((sh.CAPSULE, sh.CAPSULE), capsule_capsule(
            pos_a, rot_a, hh_a, rcap_a, pos_b, rot_b, hh_b, rcap_b, pred)),
        ((sh.CAPSULE, sh.HALFSPACE), capsule_halfspace(
            pos_a, rot_a, hh_a, rcap_a, pos_b, rot_b, pred)),
    ]
    out = _empty_like(pos_a)
    for (ka, kb), m in mans:
        out = _sel((type_a == ka) & (type_b == kb), m, out)
    return out
