"""Convex polyhedron colliders: hull data, mass properties and the SAT
routines, the port of ``fyrox_tpu/physics/convex.py``.

ConvexPolyhedron of the reference's ``ColliderShape`` set
(fyrox-impl/src/scene/collider.rs:511); cylinders and cones of the dense
path go through 12-gon prism / pyramid hulls (physics/world.py).

Host side (numpy and scipy, at build time): ``hull_from_points``,
``hull_edge_dirs``, ``prism_hull``, ``cone_hull``, ``hull_mass`` and the
padded storage ``ConvexBuilder`` → ``ConvexSet`` (MAX_HULL_VERTS vertices
and MAX_HULL_FACES face normals a hull, masks for the padding).

Tensor side: ``convex_convex`` (SAT over both hulls' face normals and
their edge crosses, a lateral clip of the candidate vertices, the 4
deepest kept, or the line-line edge point where an edge axis wins),
``ball_convex`` and ``convex_halfspace``. Where JAX's reductions choose an
index (argmin, argmax, top_k), the port takes the lowest index among
equals as XLA does, on either device: first-index selections and a stable
descending sort.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch._util import dot3 as dot
from fyrox_tpu_torch._util import sqrt_rn

__all__ = ["MAX_HULL_VERTS", "MAX_HULL_FACES", "MAX_HULL_EDGES",
           "ConvexSet", "ConvexBuilder", "hull_from_points",
           "hull_edge_dirs", "prism_hull", "cone_hull", "hull_mass",
           "convex_support", "convex_convex", "ball_convex",
           "convex_halfspace", "box_as_hull", "argmin_first",
           "argmax_first", "top_k_first", "pick", "pick3", "dot",
           "sqrt_rn", "rot_apply", "rot_apply_t", "hull_widths"]

MAX_HULL_VERTS = 32
MAX_HULL_FACES = 32
MAX_HULL_EDGES = 16
_EDGE_AXES = 8   # face-normal cap per side for the SAT cross axes


# --------------------------------------------------------------------------
# host side (build time)
# --------------------------------------------------------------------------

def hull_from_points(points):
    """(verts [V,3], face_normals [F,3]) of the convex hull of `points`,
    near-parallel face normals merged."""
    from scipy.spatial import ConvexHull
    pts = np.asarray(points, np.float64)
    hull = ConvexHull(pts)
    verts = pts[hull.vertices]
    normals = []
    for eq in hull.equations:            # [nx,ny,nz,d] with n·x + d <= 0
        n = eq[:3] / np.linalg.norm(eq[:3])
        if not any(np.dot(n, m) > 0.999 for m in normals):
            normals.append(n)
    if len(verts) > MAX_HULL_VERTS:
        raise ValueError(f"hull has {len(verts)} verts > {MAX_HULL_VERTS}; "
                         "decimate the collider hull")
    if len(normals) > MAX_HULL_FACES:
        raise ValueError(f"hull has {len(normals)} faces > {MAX_HULL_FACES}")
    return verts.astype(np.float32), np.asarray(normals, np.float32)


def hull_edge_dirs(points, max_edges=None):
    """Unique edge directions of the convex hull (±d one direction), the
    most frequent first, at most max_edges."""
    from scipy.spatial import ConvexHull
    max_edges = MAX_HULL_EDGES if max_edges is None else max_edges
    pts = np.asarray(points, np.float64)
    hull = ConvexHull(pts)
    dirs, counts = [], []
    for simplex in hull.simplices:
        for i in range(3):
            d = pts[simplex[(i + 1) % 3]] - pts[simplex[i]]
            ln = np.linalg.norm(d)
            if ln < 1e-9:
                continue
            d = d / ln
            for k, e in enumerate(dirs):
                if abs(np.dot(d, e)) > 0.9999:
                    counts[k] += 1
                    break
            else:
                dirs.append(d)
                counts.append(1)
    order = np.argsort(counts)[::-1][:max_edges]
    return np.asarray([dirs[i] for i in order], np.float32)


def _ring(radius, n):
    ang = np.arange(n) * (2 * np.pi / n) + np.pi / n
    r = radius / np.cos(np.pi / n)   # circumscribed: flats reach the radius
    return ang, r


def prism_hull(half_height, radius, n=8):
    """n-gon prism approximating a cylinder (axis = local +Y)."""
    ang, r = _ring(radius, n)
    ring = np.stack([r * np.cos(ang), np.zeros(n), r * np.sin(ang)], 1)
    return hull_from_points(np.concatenate([ring + [0, half_height, 0],
                                            ring - [0, half_height, 0]]))


def cone_hull(half_height, radius, n=8):
    """n-gon pyramid approximating a cone (apex up, base at -hh)."""
    ang, r = _ring(radius, n)
    base = np.stack([r * np.cos(ang), np.full(n, -half_height),
                     r * np.sin(ang)], 1)
    return hull_from_points(np.concatenate([base, [[0.0, half_height, 0.0]]]))


def hull_mass(verts, normals, density):
    """Mass, COM [3] and inertia about the COM [3,3] of a closed convex
    hull, by signed tetrahedra against the vertex centroid."""
    from scipy.spatial import ConvexHull
    hull = ConvexHull(np.asarray(verts, np.float64))
    pts = hull.points
    ref = pts[hull.vertices].mean(axis=0)
    vol = 0.0
    com = np.zeros(3)
    inertia = np.zeros((3, 3))
    cov_canon = np.array([[1 / 60, 1 / 120, 1 / 120],
                          [1 / 120, 1 / 60, 1 / 120],
                          [1 / 120, 1 / 120, 1 / 60]])
    for simplex in hull.simplices:
        a, b, c = pts[simplex] - ref
        if np.dot(np.cross(b - a, c - a), a + b + c) < 0:   # outward
            b, c = c, b
        v = np.dot(a, np.cross(b, c)) / 6.0
        vol += v
        com += v * (a + b + c) / 4.0
        m_abc = np.stack([a, b, c], 0)
        cov = 6.0 * v * m_abc.T @ cov_canon @ m_abc
        inertia += np.trace(cov) * np.eye(3) - cov
    com = ref + com / max(vol, 1e-12)
    mass = density * vol
    inertia = density * inertia
    d = com - ref
    inertia -= mass * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    return float(mass), com, inertia


class ConvexSet(NamedTuple):
    """Padded hull storage of a template's hulls: verts [H,V,3] local,
    vmask [H,V], unit outward normals [H,F,3] (padding (0,1,0)), nmask
    [H,F]."""
    verts: np.ndarray
    vmask: np.ndarray
    normals: np.ndarray
    nmask: np.ndarray

    @property
    def count(self):
        return int(self.verts.shape[0])


class ConvexBuilder:
    def __init__(self):
        self.verts = []
        self.normals = []

    def add(self, verts, normals=None) -> int:
        if normals is None:
            verts, normals = hull_from_points(verts)
        self.verts.append(np.asarray(verts, np.float32))
        self.normals.append(np.asarray(normals, np.float32))
        return len(self.verts) - 1

    def build(self) -> ConvexSet:
        n = len(self.verts)
        v = np.zeros((n, MAX_HULL_VERTS, 3), np.float32)
        vm = np.zeros((n, MAX_HULL_VERTS), bool)
        f = np.zeros((n, MAX_HULL_FACES, 3), np.float32)
        f[..., 1] = 1.0
        fm = np.zeros((n, MAX_HULL_FACES), bool)
        for i, (vv, nn) in enumerate(zip(self.verts, self.normals)):
            v[i, :len(vv)] = vv
            vm[i, :len(vv)] = True
            f[i, :len(nn)] = nn
            fm[i, :len(nn)] = True
        return ConvexSet(v, vm, f, fm)


# --------------------------------------------------------------------------
# selections with XLA's tie rule (lowest index among equals)
# --------------------------------------------------------------------------

def argmin_first(x):
    """First index of the least value along the last axis."""
    n = x.shape[-1]
    ar = torch.arange(n, device=x.device)
    hit = x == torch.amin(x, -1, keepdim=True)
    return torch.amin(torch.where(hit, ar, n), -1)


def argmax_first(x):
    """First index of the greatest value along the last axis."""
    n = x.shape[-1]
    ar = torch.arange(n, device=x.device)
    hit = x == torch.amax(x, -1, keepdim=True)
    return torch.amin(torch.where(hit, ar, n), -1)


def top_k_first(x, k):
    """(values, indices) of the k greatest along the last axis, in
    descending order, equals by ascending index (jax.lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pick(x, idx):
    """x [..., N] at idx [..., k] → [..., k] (an exact selection, where the
    JAX package sums one-hot products)."""
    return torch.gather(x.expand(idx.shape[:-1] + x.shape[-1:]), -1, idx)


def pick3(x, idx):
    """Rows of x [..., N, 3] at idx [..., k] → [..., k, 3]."""
    x = x.expand(idx.shape[:-1] + x.shape[-2:])
    return torch.gather(x, -2, idx[..., None].expand(idx.shape + (3,)))


# --------------------------------------------------------------------------
# routines (hull arrays local, poses world; pair-aligned leading axes)
# --------------------------------------------------------------------------

_NEG = -1.0e9
# a box's 8 corner signs, in the JAX package's order
_CORNERS = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                     for sz in (-1, 1)], np.float32)


def rot_apply(rot, v):
    """rot [...,3,3] applied to points v [...,N,3] → [...,N,3]."""
    r = rot[..., None, :, :]
    return torch.stack([dot(r[..., i, :], v) for i in range(3)], -1)


def rot_apply_t(rot, v):
    """rotᵀ [...,3,3] applied to points v [...,N,3] → [...,N,3]."""
    r = rot[..., None, :, :]
    return torch.stack([dot(r[..., :, i], v) for i in range(3)], -1)


def convex_support(verts_w, vmask, axis):
    """max over valid verts of axis·vert: verts_w [...,V,3], axis [...,3]
    → [...]."""
    d = dot(verts_w, axis[..., None, :])
    return torch.amax(torch.where(vmask, d, _NEG), -1)


def box_as_hull(half, n_v=MAX_HULL_VERTS, n_f=MAX_HULL_FACES):
    """Box half-extents [...,3] → hull arrays (8 verts, 6 normals) padded
    to n_v verts and n_f normals, so cuboid pairs reuse the hull
    routines."""
    from fyrox_tpu_torch._util import const
    dev, dt = half.device, half.dtype
    lead = half.shape[:-1]
    sel = const(_CORNERS, dev, dt)
    verts = torch.cat([sel * half[..., None, :],
                       half.new_zeros(lead + (n_v - 8, 3))], -2)
    vmask = torch.arange(n_v, device=dev).expand(lead + (n_v,)) < 8
    eye = torch.eye(3, dtype=dt, device=dev)
    pad_n = torch.zeros((n_f - 6, 3), dtype=dt, device=dev)
    pad_n[:, 1] = 1.0
    normals = torch.cat([eye, -eye, pad_n], 0).expand(lead + (n_f, 3))
    nmask = torch.arange(n_f, device=dev).expand(lead + (n_f,)) < 6
    return verts, vmask, normals, nmask


def hull_widths(vmask, nmask):
    """(verts, normals) a routine needs to hold the hulls of vmask [H,V]
    / nmask [H,F]: their largest counts, at least a box's 8 vertices and
    the 8 normals the edge axes take. The routines mask the padding, so a
    hull cut to these widths gives the same active contacts."""
    vmask, nmask = np.asarray(vmask) > 0, np.asarray(nmask) > 0
    nv = int(vmask.sum(1).max()) if vmask.size else 0
    nf = int(nmask.sum(1).max()) if nmask.size else 0
    return max(8, nv), max(_EDGE_AXES, nf)


def _pred(pred, like):
    return pred if torch.is_tensor(pred) else torch.full_like(like, pred)


def convex_convex(pos_a, rot_a, va, vma, na, nma,
                  pos_b, rot_b, vb, vmb, nb, nmb, pred):
    """SAT over both hulls' face normals and their edge crosses; the
    manifold is the 4 deepest laterally clipped vertices against the
    opposing support plane, or the line-line point of the supporting
    edges where an edge axis wins. Returns a narrowphase.Manifold."""
    from fyrox_tpu_torch.physics.narrowphase import Manifold
    pred = _pred(pred, pos_a[..., 0])
    wa = pos_a[..., None, :] + rot_apply(rot_a, va)            # [...,V,3]
    wb = pos_b[..., None, :] + rot_apply(rot_b, vb)
    na_w = rot_apply(rot_a, na)                                # [...,F,3]
    nb_w = rot_apply(rot_b, nb)
    d_ab = pos_b - pos_a

    def axis_pen(axes, amask):
        """Penetration along each axis oriented A→B: [...,F] and the
        oriented axes."""
        dir_ = torch.where(dot(axes, d_ab[..., None, :])[..., None] >= 0,
                           1.0, -1.0)
        ax = axes * dir_
        sup_a = convex_support(wa[..., None, :, :], vma[..., None, :], ax)
        min_b = -convex_support(wb[..., None, :, :], vmb[..., None, :], -ax)
        return torch.where(amask, sup_a - min_b, 1e9), ax

    pen_a, ax_a = axis_pen(na_w, nma)
    pen_b, ax_b = axis_pen(nb_w, nmb)
    ecap = _EDGE_AXES
    ea_d, eam = na_w[..., :ecap, :], nma[..., :ecap]
    eb_d, ebm = nb_w[..., :ecap, :], nmb[..., :ecap]
    x_a, x_b = torch.broadcast_tensors(ea_d[..., :, None, :],
                                       eb_d[..., None, :, :])
    cr = torch.linalg.cross(x_a, x_b, dim=-1)              # [...,8,8,3]
    crl = sqrt_rn(dot(cr, cr))
    crm = eam[..., :, None] & ebm[..., None, :] & (crl > 1e-6)
    cr = cr / torch.clamp(crl[..., None], min=1e-12)
    lead = cr.shape[:-3]
    pen_e, ax_e = axis_pen(cr.reshape(lead + (ecap * ecap, 3)),
                           crm.reshape(lead + (ecap * ecap,)))

    n_f = pen_a.shape[-1] + pen_b.shape[-1]
    pen_all = torch.cat([pen_a, pen_b, pen_e], -1)
    ax_all = torch.cat([ax_a, ax_b, ax_e], -2)
    best = argmin_first(pen_all)
    best_pen = pick(pen_all, best[..., None])[..., 0]
    normal = pick3(ax_all, best[..., None])[..., 0, :]
    normal = normal / torch.clamp(sqrt_rn(dot(normal, normal))[..., None],
                                  min=1e-12)
    edge_win = best >= n_f

    # the supporting edges' line-line midpoint (the edge contact)
    eidx = torch.where(edge_win, torch.clamp(best - n_f, min=0),
                       argmin_first(pen_e))
    da = pick3(ea_d, (eidx // ecap)[..., None])[..., 0, :]
    db = pick3(eb_d, (eidx % ecap)[..., None])[..., 0, :]
    sa_d = torch.where(vma, dot(wa, normal[..., None, :]), _NEG)
    pa_pt = pick3(wa, argmax_first(sa_d)[..., None])[..., 0, :]
    sb_d = torch.where(vmb, -dot(wb, normal[..., None, :]), _NEG)
    pb_pt = pick3(wb, argmax_first(sb_d)[..., None])[..., 0, :]
    w0 = pa_pt - pb_pt
    aa, bb, cc = dot(da, da), dot(da, db), dot(db, db)
    dd, ee = dot(da, w0), dot(db, w0)
    den = aa * cc - bb * bb
    safe = torch.abs(den) > 1e-9
    den_s = torch.where(safe, den, 1.0)
    s_par = torch.where(safe, (bb * ee - cc * dd) / den_s, 0.0)
    t_par = torch.where(safe, (aa * ee - bb * dd) / den_s, 0.0)
    edge_pt = 0.5 * (pa_pt + s_par[..., None] * da
                     + pb_pt + t_par[..., None] * db)

    # vertex manifold: B's verts below A's support plane, A's above B's
    sup_a = convex_support(wa, vma, normal)
    d_b = torch.where(vmb, sup_a[..., None] - dot(wb, normal[..., None, :]),
                      _NEG)
    min_b = -convex_support(wb, vmb, -normal)
    d_a = torch.where(vma, dot(wa, normal[..., None, :]) - min_b[..., None],
                      _NEG)
    pts_all = torch.cat([wb, wa], -2)
    dep_all = torch.cat([d_b, d_a], -1)
    lat_margin = pred + 1e-3

    def inside(p, nw, nmw, vw, vmw):
        """p [...,P,3] inside the hull of world normals nw, verts vw."""
        sup_f = torch.amax(torch.where(
            vmw[..., None, :], dot(vw[..., None, :, :], nw[..., :, None, :]),
            _NEG), -1)                                      # [...,F]
        d = (dot(p[..., None, :, :], nw[..., :, None, :])
             - sup_f[..., None])                            # [...,F,P]
        d = torch.where(nmw[..., None], d, _NEG)
        return torch.amax(d, -2) <= lat_margin[..., None]

    lat_ok = torch.cat([inside(wb, na_w, nma, wa, vma),
                        inside(wa, nb_w, nmb, wb, vmb)], -1)
    dep_all = torch.where(lat_ok, dep_all, _NEG)
    top_d, top_i = top_k_first(dep_all, 4)
    pts = pick3(pts_all, top_i)
    predn = pred[..., None]
    active = (top_d > -predn) & (best_pen[..., None] > -predn)

    # the single edge point where an edge axis won, or where the lateral
    # clip left no vertex of an overlap
    use_edge = edge_win | (~torch.any(active, -1) & (best_pen > -pred))
    e_sel = torch.arange(4, device=pos_a.device) == 0
    pts = torch.where(use_edge[..., None, None],
                      torch.where(e_sel[:, None], edge_pt[..., None, :], 0.0),
                      pts)
    top_d = torch.where(use_edge[..., None],
                        torch.where(e_sel, best_pen[..., None], _NEG), top_d)
    active = torch.where(use_edge[..., None],
                         e_sel & (best_pen[..., None] > -predn), active)
    return Manifold(normal, pts, top_d, active)


def ball_convex(pa, ra, pos_b, rot_b, vb, vmb, nb, nmb, pred):
    """Sphere vs hull: the face plane the centre is farthest outside of
    gives the normal (exact in face regions, conservative at edges)."""
    from fyrox_tpu_torch.physics.narrowphase import _empty_like, _one_point
    nb_w = rot_apply(rot_b, nb)
    wb = pos_b[..., None, :] + rot_apply(rot_b, vb)
    plane_d = convex_support(wb[..., None, :, :], vmb[..., None, :], nb_w)
    sd = torch.where(nmb, dot(nb_w, pa[..., None, :]) - plane_d, _NEG)
    fi = argmax_first(sd)[..., None]
    dist = pick(sd, fi)[..., 0]
    n_face = pick3(nb_w, fi)[..., 0, :]
    depth = ra - dist
    point = pa - n_face * dist[..., None]
    return _one_point(_empty_like(point), -n_face, point, depth,
                      depth > -pred)


def convex_halfspace(pos_a, rot_a, va, vma, pos_p, rot_p, pred):
    """Hull vs plane: the 4 deepest vertices below the plane."""
    from fyrox_tpu_torch.physics.narrowphase import Manifold
    n = rot_p[..., :, 1]
    d = dot(n, pos_p)
    wa = pos_a[..., None, :] + rot_apply(rot_a, va)
    depth = torch.where(vma, d[..., None] - dot(wa, n[..., None, :]), _NEG)
    top_d, top_i = top_k_first(depth, 4)
    pts = pick3(wa, top_i)
    pred = _pred(pred, pos_a[..., 0])
    return Manifold(-n.expand(pts.shape[:-2] + (3,)), pts, top_d,
                    top_d > -pred[..., None])
