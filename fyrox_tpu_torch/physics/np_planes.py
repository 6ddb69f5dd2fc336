"""Plane-form narrowphase for the primitive shape pairs (the batched
replacement for parry's contact generation; ``fyrox_tpu.physics.np_planes``).

A manifold is ManifoldP(normal=v3 A→B, pts=[v3]*n, depth=[plane]*n,
active=[0/1 f32 plane]*n) with n the manifold class size (1, 2 or 4).
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from fyrox_tpu_torch.physics import shapes as sh
from fyrox_tpu_torch.physics.planes import (add3, cross3, dot3, neg3, norm3,
                                            normalize3, rot9_apply,
                                            rot9_apply_t, rot9_col, scale3,
                                            splat, sub3, where3)

__all__ = ["ManifoldP", "generate_class_planes", "CLASS_COMBOS_P"]

_EPS = 1e-9


class ManifoldP(NamedTuple):
    normal: Tuple
    pts: List
    depth: List
    active: List


def _m(cond):
    return cond.to(torch.float32)


def _empty(like, npts):
    z = torch.zeros_like(like)
    return ManifoldP(normal=(z, z, z), pts=[(z, z, z)] * npts,
                     depth=[torch.full_like(like, -1e9)] * npts,
                     active=[z] * npts)


def _sel(cond, mt, mf):
    return ManifoldP(
        normal=where3(cond, mt.normal, mf.normal),
        pts=[where3(cond, a, b) for a, b in zip(mt.pts, mf.pts)],
        depth=[torch.where(cond, a, b) for a, b in zip(mt.depth, mf.depth)],
        active=[torch.where(cond, a, b)
                for a, b in zip(mt.active, mf.active)])


def _one(normal, point, depth, pred):
    return ManifoldP(normal=normal, pts=[point], depth=[depth],
                     active=[_m(depth > -pred)])


def ball_ball_p(pa, ra, pb, rb, pred):
    n, dist = normalize3(sub3(pb, pa), _EPS)
    depth = ra + rb - dist
    point = add3(pa, scale3(n, ra - 0.5 * depth))
    return _one(n, point, depth, pred)


def ball_cuboid_p(pa, ra, pb, rot_b, half, pred):
    """Sphere A vs box B."""
    rel = rot9_apply_t(rot_b, sub3(pa, pb))
    clamped = tuple(torch.minimum(torch.maximum(rel[i], -half[i]), half[i])
                    for i in range(3))
    delta = sub3(rel, clamped)
    dist = norm3(delta)
    outside = dist > _EPS
    inv = 1.0 / torch.clamp(dist, min=_EPS)
    n_out = scale3(delta, inv)
    # inside: least-penetration axis, first minimum wins ties
    px = half[0] - torch.abs(rel[0])
    py = half[1] - torch.abs(rel[1])
    pz = half[2] - torch.abs(rel[2])
    axf = _m(px <= py) * _m(px <= pz)
    ayf = (1.0 - axf) * _m(py <= pz)
    azf = 1.0 - axf - ayf
    sgn = torch.sign(axf * rel[0] + ayf * rel[1] + azf * rel[2])
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    n_in = (axf * sgn, ayf * sgn, azf * sgn)
    depth_out = ra - dist
    depth_in = ra + torch.minimum(px, torch.minimum(py, pz))
    n_local = where3(outside, n_out, n_in)
    depth = torch.where(outside, depth_out, depth_in)
    surf_in = (clamped[0] * (1 - axf) + half[0] * axf * sgn,
               clamped[1] * (1 - ayf) + half[1] * ayf * sgn,
               clamped[2] * (1 - azf) + half[2] * azf * sgn)
    surf = where3(outside, clamped, surf_in)
    n_world = rot9_apply(rot_b, n_local)
    p_world = add3(pb, rot9_apply(rot_b, surf))
    return _one(neg3(n_world), p_world, depth, pred)


def _segment_endpoints_p(p, rot, hh):
    axis = rot9_col(rot, 1)
    return sub3(p, scale3(axis, hh)), add3(p, scale3(axis, hh))


def _closest_on_segment_p(a, b, p):
    ab = sub3(b, a)
    t = dot3(sub3(p, a), ab) / torch.clamp(dot3(ab, ab), min=_EPS)
    return add3(a, scale3(ab, torch.clamp(t, 0.0, 1.0)))


def ball_capsule_p(pa, ra, pb, rot_b, hh, rb, pred):
    s0, s1 = _segment_endpoints_p(pb, rot_b, hh)
    return ball_ball_p(pa, ra, _closest_on_segment_p(s0, s1, pa), rb, pred)


def _closest_segment_segment_p(a0, a1, b0, b1):
    d1 = sub3(a1, a0)
    d2 = sub3(b1, b0)
    r = sub3(a0, b0)
    a = dot3(d1, d1)
    e = dot3(d2, d2)
    f = dot3(d2, r)
    c = dot3(d1, r)
    b = dot3(d1, d2)
    denom = a * e - b * b
    s = torch.where(denom > _EPS,
                    torch.clamp((b * f - c * e) / torch.clamp(denom, min=_EPS),
                                0, 1),
                    torch.zeros_like(denom))
    t = (b * s + f) / torch.clamp(e, min=_EPS)
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.clamp((b * t_cl - c) / torch.clamp(a, min=_EPS), 0.0, 1.0)
    t = torch.clamp((b * s + f) / torch.clamp(e, min=_EPS), 0.0, 1.0)
    return add3(a0, scale3(d1, s)), add3(b0, scale3(d2, t))


def capsule_capsule_p(pa, rot_a, hha, ra, pb, rot_b, hhb, rb, pred):
    a0, a1 = _segment_endpoints_p(pa, rot_a, hha)
    b0, b1 = _segment_endpoints_p(pb, rot_b, hhb)
    ca, cb = _closest_segment_segment_p(a0, a1, b0, b1)
    return ball_ball_p(ca, ra, cb, rb, pred)


def cuboid_capsule_p(pa, rot_a, half, pb, rot_b, hh, rb, pred):
    """Cuboid A vs capsule B: sphere-box queries at both segment ends."""
    b0, b1 = _segment_endpoints_p(pb, rot_b, hh)
    m0 = ball_cuboid_p(b0, rb, pa, rot_a, half, pred)
    m1 = ball_cuboid_p(b1, rb, pa, rot_a, half, pred)
    deeper0 = m0.depth[0] >= m1.depth[0]
    normal = where3(deeper0, m0.normal, m1.normal)
    return ManifoldP(normal=neg3(normal), pts=[m0.pts[0], m1.pts[0]],
                     depth=[m0.depth[0], m1.depth[0]],
                     active=[m0.active[0], m1.active[0]])


def _halfspace_frame_p(pp, rot_p):
    n = rot9_col(rot_p, 1)
    return n, dot3(n, pp)


def ball_halfspace_p(pa, ra, pp, rot_p, pred):
    n, d = _halfspace_frame_p(pp, rot_p)
    dist = dot3(n, pa) - d
    return _one(neg3(n), sub3(pa, scale3(n, dist)), ra - dist, pred)


def capsule_halfspace_p(pa, rot_a, hh, ra, pp, rot_p, pred):
    n, d = _halfspace_frame_p(pp, rot_p)
    pts, dep, act = [], [], []
    for e in _segment_endpoints_p(pa, rot_a, hh):
        dist = dot3(n, e) - d
        depth = ra - dist
        pts.append(sub3(e, scale3(n, dist)))
        dep.append(depth)
        act.append(_m(depth > -pred))
    return ManifoldP(normal=neg3(n), pts=pts, depth=dep, active=act)


def _rank_select(values, depths, k_out):
    """The k_out deepest of len(depths) candidates (ties by index), each
    returned with its depth: rank_i = #{j : depth_j beats depth_i}."""
    n = len(depths)
    ranks = []
    for i in range(n):
        r = None
        for j in range(n):
            if j == i:
                continue
            gt = (depths[j] >= depths[i]) if j < i else (depths[j] > depths[i])
            gt = gt.to(torch.int32)
            r = gt if r is None else r + gt
        ranks.append(r)
    out = []
    for k in range(k_out):
        px = py = pz = dk = None
        for i in range(n):
            m = (ranks[i] == k).to(depths[i].dtype)
            if px is None:
                px, py, pz = (values[i][0] * m, values[i][1] * m,
                              values[i][2] * m)
                dk = depths[i] * m
            else:
                px = px + values[i][0] * m
                py = py + values[i][1] * m
                pz = pz + values[i][2] * m
                dk = dk + depths[i] * m
        out.append(((px, py, pz), dk))
    return out


def cuboid_halfspace_p(pa, rot_a, half, pp, rot_p, pred):
    """Box vs plane: the 4 deepest of the 8 corners."""
    n, d = _halfspace_frame_p(pp, rot_p)
    corners, depths = [], []
    for sx in (-1, 1):
        for sy in (-1, 1):
            for sz in (-1, 1):
                local = (sx * half[0], sy * half[1], sz * half[2])
                cw = add3(pa, rot9_apply(rot_a, local))
                corners.append(cw)
                depths.append(d - dot3(n, cw))
    sel = _rank_select(corners, depths, 4)
    return ManifoldP(normal=neg3(n), pts=[p for p, _ in sel],
                     depth=[dk for _, dk in sel],
                     active=[_m(dk > -pred) for _, dk in sel])


def cuboid_cuboid_p(pa, rot_a, half_a, pb, rot_b, half_b, pred):
    """SAT over 15 axes + reference-face clipping of the incident face."""
    d = sub3(pb, pa)
    axes_a = [rot9_col(rot_a, j) for j in range(3)]
    axes_b = [rot9_col(rot_b, j) for j in range(3)]

    def face_pen(axis):
        ra = (half_a[0] * torch.abs(dot3(axes_a[0], axis))
              + half_a[1] * torch.abs(dot3(axes_a[1], axis))
              + half_a[2] * torch.abs(dot3(axes_a[2], axis)))
        rb = (half_b[0] * torch.abs(dot3(axes_b[0], axis))
              + half_b[1] * torch.abs(dot3(axes_b[1], axis))
              + half_b[2] * torch.abs(dot3(axes_b[2], axis)))
        return ra + rb - torch.abs(dot3(d, axis))

    best_pen = splat(1e9, d[0])
    best_axis = (torch.zeros_like(d[0]),) * 3
    for axis in (*axes_a, *axes_b):
        pen = face_pen(axis)
        better = pen < best_pen
        best_pen = torch.where(better, pen, best_pen)
        best_axis = where3(better, axis, best_axis)
    for i in range(3):
        for j in range(3):
            axis, ln = normalize3(cross3(axes_a[i], axes_b[j]),
                                  fallback=(0.0, 0.0, 0.0))
            axis = where3(ln > 1e-6, axis, best_axis)
            pen = face_pen(axis)
            better = (_m(ln > 1e-6) * _m(pen < best_pen - 1e-6)) > 0.5
            best_pen = torch.where(better, pen, best_pen)
            best_axis = where3(better, axis, best_axis)

    flip = dot3(best_axis, d) < 0
    normal = where3(flip, neg3(best_axis), best_axis)

    def face_vertices(p, rot, half, axis_dir):
        axes = [rot9_col(rot, j) for j in range(3)]
        dots = [dot3(a, axis_dir) for a in axes]
        a0, a1, a2 = (torch.abs(t) for t in dots)
        fxf = _m(a0 >= a1) * _m(a0 >= a2)
        fyf = (1.0 - fxf) * _m(a1 >= a2)
        fzf = 1.0 - fxf - fyf
        fa = (fxf, fyf, fzf)
        ta = (fzf, fxf, fyf)      # (face+1) % 3 one-hot
        tb = (fyf, fzf, fxf)      # (face+2) % 3 one-hot
        sgn = torch.sign(dots[0] * fxf + dots[1] * fyf + dots[2] * fzf)
        sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
        hn = dot3(half, fa)
        ht1 = dot3(half, ta)
        ht2 = dot3(half, tb)
        n_l = scale3(fa, sgn)
        corners = []
        for s1 in (-1, 1):
            for s2 in (-1, 1):
                c_local = add3(scale3(n_l, hn),
                               add3(scale3(ta, s1 * ht1),
                                    scale3(tb, s2 * ht2)))
                corners.append(add3(p, rot9_apply(rot, c_local)))
        t1_w = rot9_apply(rot, ta)
        t2_w = rot9_apply(rot, tb)
        center = add3(p, rot9_apply(rot, scale3(n_l, hn)))
        return corners, center, t1_w, t2_w, ht1, ht2

    _, ref_c, ref_t1, ref_t2, ref_h1, ref_h2 = face_vertices(
        pa, rot_a, half_a, normal)
    inc_pts = face_vertices(pb, rot_b, half_b, neg3(normal))[0]
    plane_d = dot3(normal, ref_c)
    pen_ok = best_pen > -pred
    pts, dep, act = [], [], []
    for ip in inc_pts:
        rel = sub3(ip, ref_c)
        u = torch.minimum(torch.maximum(dot3(rel, ref_t1), -ref_h1), ref_h1)
        v = torch.minimum(torch.maximum(dot3(rel, ref_t2), -ref_h2), ref_h2)
        pts.append(add3(ref_c, add3(scale3(ref_t1, u), scale3(ref_t2, v))))
        depth = plane_d - dot3(normal, ip)
        dep.append(depth)
        act.append(_m(depth > -pred) * _m(pen_ok))
    return ManifoldP(normal=normal, pts=pts, depth=dep, active=act)


# combos per manifold-size class, canonical effective-kind ordering
CLASS_COMBOS_P = {
    0: [(sh.BALL, sh.BALL), (sh.BALL, sh.CUBOID), (sh.BALL, sh.CAPSULE),
        (sh.BALL, sh.HALFSPACE), (sh.CAPSULE, sh.CAPSULE)],
    1: [(sh.CUBOID, sh.CAPSULE), (sh.CAPSULE, sh.HALFSPACE)],
    2: [(sh.CUBOID, sh.CUBOID), (sh.CUBOID, sh.HALFSPACE)],
}


def _run_combo(ka, kb, pos_a, rot_a, p6a, pos_b, rot_b, p6b, pred):
    if (ka, kb) == (sh.BALL, sh.BALL):
        return ball_ball_p(pos_a, p6a[0], pos_b, p6b[0], pred)
    if (ka, kb) == (sh.BALL, sh.CUBOID):
        return ball_cuboid_p(pos_a, p6a[0], pos_b, rot_b, p6b[:3], pred)
    if (ka, kb) == (sh.BALL, sh.CAPSULE):
        return ball_capsule_p(pos_a, p6a[0], pos_b, rot_b, p6b[0], p6b[1],
                              pred)
    if (ka, kb) == (sh.BALL, sh.HALFSPACE):
        return ball_halfspace_p(pos_a, p6a[0], pos_b, rot_b, pred)
    if (ka, kb) == (sh.CAPSULE, sh.CAPSULE):
        return capsule_capsule_p(pos_a, rot_a, p6a[0], p6a[1],
                                 pos_b, rot_b, p6b[0], p6b[1], pred)
    if (ka, kb) == (sh.CUBOID, sh.CAPSULE):
        return cuboid_capsule_p(pos_a, rot_a, p6a[:3],
                                pos_b, rot_b, p6b[0], p6b[1], pred)
    if (ka, kb) == (sh.CAPSULE, sh.HALFSPACE):
        return capsule_halfspace_p(pos_a, rot_a, p6a[0], p6a[1],
                                   pos_b, rot_b, pred)
    if (ka, kb) == (sh.CUBOID, sh.CUBOID):
        return cuboid_cuboid_p(pos_a, rot_a, p6a[:3],
                               pos_b, rot_b, p6b[:3], pred)
    if (ka, kb) == (sh.CUBOID, sh.HALFSPACE):
        return cuboid_halfspace_p(pos_a, rot_a, p6a[:3], pos_b, rot_b, pred)
    raise NotImplementedError((ka, kb))


def generate_class_planes(cls, eff_a, eff_b, pos_a, rot_a, p6a,
                          pos_b, rot_b, p6b, pred, combos_present=None):
    """Manifolds for canonically ordered slots of one manifold-size class.
    combos_present: the subset of CLASS_COMBOS_P[cls] whose kinds occur in
    the scene (absent combos cost nothing)."""
    npts = {0: 1, 1: 2, 2: 4}[cls]
    out = _empty(pos_a[0], npts)
    combos = (combos_present if combos_present is not None
              else CLASS_COMBOS_P[cls])
    for ka, kb in combos:
        m = _run_combo(ka, kb, pos_a, rot_a, p6a, pos_b, rot_b, p6b, pred)
        out = _sel((eff_a == ka) & (eff_b == kb), m, out)
    return out
