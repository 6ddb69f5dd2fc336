"""Physics queries: batched ray, sphere and shape casts and contact
introspection, the port of ``fyrox_tpu/physics/queries.py``
(PhysicsWorld::cast_ray, fyrox-impl/src/scene/graph/physics/mod.rs:1292;
cast_shape :1357). Every ray tests every collider and the nearest hit
wins; batched over worlds and rays. Where JAX chooses an index (the
nearest collider, a box face, a cast's achieving axis) the port takes the
lowest index among equals; sums of three products run in index order and
square roots are correctly rounded, so the card and the CPU hit alike.
"""
from __future__ import annotations

import numpy as np
import torch

from fyrox_tpu_torch._util import const, dot3, sqrt_rn
from fyrox_tpu_torch.core import quat as quat_mod
from fyrox_tpu_torch.core import ray as ray_mod
from fyrox_tpu_torch.physics import shapes as sh
from fyrox_tpu_torch.physics.convex import argmax_first, argmin_first
from fyrox_tpu_torch.physics.world import (PhysicsState, PhysicsTemplate,
                                           _collider_world)

__all__ = ["cast_ray", "sphere_cast", "shape_cast", "compute_contacts"]

_BIG = 3.0e38


def _take(x, best):
    """x [W,R,C,...] at the winning collider best [W,R] → [W,R,...]."""
    idx = best.reshape(best.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 2, idx.expand(best.shape + (1,) + x.shape[3:])
                        )[:, :, 0]


def _mv(m, v):
    """m [...,3,3] @ v [...,3], each row's sum in index order."""
    return torch.stack([dot3(m[..., i, :], v) for i in range(3)], -1)


def _mtv(m, v):
    """mᵀ [...,3,3] @ v [...,3]."""
    return torch.stack([dot3(m[..., :, i], v) for i in range(3)], -1)


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def cast_ray(state: PhysicsState, t: PhysicsTemplate, origin, direction,
             max_toi=float("inf")):
    """Nearest-hit ray cast. origin / direction [W,R,3]. Returns a dict:
    hit [W,R] bool, toi [W,R] (inf on a miss), collider and body [W,R]
    int (-1 on a miss), point and normal [W,R,3]. Heightfields, trimeshes
    and hulls (other than cylinders / cones, as capsules) are not hit, as
    in the JAX package."""
    return _cast_ray(state, t, origin, direction, max_toi,
                     const(t.col_params, state.position.device))


def _cast_ray(state, t, origin, direction, max_toi, col_params):
    cpos, crot = _collider_world(state, t)              # [W,C,3], [W,C,3,3]
    dev = cpos.device
    w, c = cpos.shape[:2]
    origin = _f32(origin, dev)
    direction = _f32(direction, dev)
    r = origin.shape[1]
    o = origin[:, :, None].expand(w, r, c, 3)
    d = direction[:, :, None].expand(w, r, c, 3)
    cp = cpos[:, None].expand(w, r, c, 3)
    cr = crot[:, None].expand(w, r, c, 3, 3)
    params = col_params[None, None].expand(w, r, c, 6)
    ctype = const(t.col_shape, dev)[None, None].expand(w, r, c)

    hit_b, t_b = ray_mod.sphere(o, d, cp, params[..., 0])
    # cuboid: the ray in the box frame, slab test
    o_loc = _mtv(cr, o - cp)                              # Rᵀ (o - cp)
    d_loc = _mtv(cr, d)
    half = params[..., :3]
    hit_c, tmin_c, _ = ray_mod.aabb(o_loc, d_loc, -half, half)
    t_c = torch.where(hit_c, torch.clamp(tmin_c, min=0.0), _BIG)
    # capsule: cap spheres and the finite cylinder in the local frame
    hh = params[..., 0]
    rad = params[..., 1]
    a_cyl = d_loc[..., 0] ** 2 + d_loc[..., 2] ** 2
    b_cyl = 2.0 * (o_loc[..., 0] * d_loc[..., 0]
                   + o_loc[..., 2] * d_loc[..., 2])
    c_cyl = o_loc[..., 0] ** 2 + o_loc[..., 2] ** 2 - rad * rad
    disc = b_cyl * b_cyl - 4 * a_cyl * c_cyl
    sq = sqrt_rn(torch.clamp(disc, min=0.0))
    t_cyl = (-b_cyl - sq) / torch.clamp(2 * a_cyl, min=1e-12)
    y_at = o_loc[..., 1] + t_cyl * d_loc[..., 1]
    cyl_ok = ((a_cyl > 1e-10) & (disc >= 0) & (t_cyl >= 0)
              & (torch.abs(y_at) <= hh))
    t_cyl = torch.where(cyl_ok, t_cyl, _BIG)
    axis_w = cr[..., :, 1]
    _, t_top = ray_mod.sphere(o, d, cp + axis_w * hh[..., None], rad)
    _, t_bot = ray_mod.sphere(o, d, cp - axis_w * hh[..., None], rad)
    t_k = torch.minimum(t_cyl, torch.minimum(t_top, t_bot))
    # halfspace: the plane through the collider origin, local +Y normal
    n_hs = cr[..., :, 1]
    d_hs = -dot3(n_hs, cp)
    hit_h, t_h = ray_mod.plane(o, d, n_hs, d_hs)

    eff = torch.where((ctype == sh.CYLINDER) | (ctype == sh.CONE),
                      sh.CAPSULE, ctype)
    toi = torch.where(eff == sh.BALL, torch.where(hit_b, t_b, _BIG),
          torch.where(eff == sh.CUBOID, t_c,
          torch.where(eff == sh.CAPSULE, t_k,
          torch.where(eff == sh.HALFSPACE, torch.where(hit_h, t_h, _BIG),
                      _BIG))))
    toi = torch.where(toi <= max_toi, toi, _BIG)        # [W,R,C]

    best = argmin_first(toi)                            # [W,R]
    best_toi = torch.gather(toi, -1, best[..., None])[..., 0]
    hit = best_toi < _BIG
    collider = torch.where(hit, best, -1)
    body = torch.where(hit, const(t.col_body, dev).long()[best], -1)
    point = origin + direction * torch.where(hit, best_toi, 0.0)[..., None]
    rel_p = point - _take(cp, best)
    normal = rel_p / torch.clamp(sqrt_rn(dot3(rel_p, rel_p))[..., None],
                                 min=1e-8)
    best_type = torch.gather(eff, -1, best[..., None])[..., 0]
    normal = torch.where((best_type == sh.HALFSPACE)[..., None],
                         _take(n_hs, best), normal)
    # cuboid: the face normal from the local hit point
    p_loc = _take(o_loc, best) + _take(d_loc, best) * best_toi[..., None]
    ratios = torch.abs(p_loc) / torch.clamp(_take(half, best), min=1e-8)
    face = argmax_first(ratios)
    sign = torch.sign(torch.gather(p_loc, -1, face[..., None]))[..., 0]
    n_loc = torch.eye(3, device=dev)[face] * sign[..., None]
    n_box = _mv(_take(cr, best), n_loc)
    normal = torch.where((best_type == sh.CUBOID)[..., None], n_box, normal)
    return dict(hit=hit, toi=torch.where(hit, best_toi, float("inf")),
                collider=collider, body=body, point=point, normal=normal)


def sphere_cast(state: PhysicsState, t: PhysicsTemplate, origin, direction,
                radius, max_toi=float("inf")):
    """Swept-sphere cast (physics/mod.rs:1371) by Minkowski inflation:
    balls and capsules (cylinders, cones) grow by the radius, cuboids'
    half-extents grow by it (a rounded box, conservative at corners), and
    a halfspace hit moves back by r / |d·n|. radius: a scalar or [W,R];
    the inflation takes its largest value (a host read). Same dict as
    cast_ray."""
    dev = state.position.device
    r = _f32(radius, dev)
    rr = float(r) if r.dim() == 0 else float(r.max())
    out = _cast_ray(state, t, origin, direction, max_toi,
                    const(t.col_params, dev) + rr * const(_inflation(t), dev))
    best_type = const(t.col_shape, dev)[torch.clamp(out["collider"], min=0)]
    is_plane = (best_type == sh.HALFSPACE) & out["hit"]
    d = _f32(direction, dev)
    dn = torch.abs(dot3(d, out["normal"]))
    toi = torch.where(is_plane, torch.clamp(
        out["toi"] - r / torch.clamp(dn, min=1e-6), min=0.0), out["toi"])
    out["toi"] = toi
    out["point"] = _f32(origin, dev) + d * torch.where(out["hit"], toi,
                                                       0.0)[..., None]
    return out


def _inflation(t) -> np.ndarray:
    """[C,6] 0/1: the params a sphere cast grows by its radius."""
    if getattr(t, "_cast_inflation", None) is None:
        m = np.zeros((t.num_colliders, 6), np.float32)
        k = np.asarray(t.col_shape)
        m[k == sh.BALL, 0] = 1.0
        m[k == sh.CUBOID, :3] = 1.0
        m[np.isin(k, (sh.CAPSULE, sh.CYLINDER, sh.CONE)), 1] = 1.0
        t._cast_inflation = m
    return t._cast_inflation


def _support_h(kind, params, m):
    """Support height max over the shape of m·x in its local frame, for a
    direction m of any length: exact for ball, cuboid, capsule, cylinder
    and cone; a hull's bounding sphere (conservative). kind: a Python int
    or an int tensor."""
    mx, my, mz = m.unbind(-1)
    mlen = sqrt_rn(mx * mx + my * my + mz * mz)
    mxz = sqrt_rn(mx * mx + mz * mz)
    g_ball = params[..., 0] * mlen
    g_box = (params[..., 0] * torch.abs(mx) + params[..., 1] * torch.abs(my)
             + params[..., 2] * torch.abs(mz))
    g_cap = params[..., 0] * torch.abs(my) + params[..., 1] * mlen
    g_cyl = params[..., 0] * torch.abs(my) + params[..., 1] * mxz
    g_cone = torch.maximum(params[..., 0] * my,
                           -params[..., 0] * my + params[..., 1] * mxz)
    if isinstance(kind, int):
        return {sh.BALL: g_ball, sh.CUBOID: g_box, sh.CAPSULE: g_cap,
                sh.CYLINDER: g_cyl, sh.CONE: g_cone}.get(kind, g_ball)
    return torch.where(kind == sh.BALL, g_ball,
           torch.where(kind == sh.CUBOID, g_box,
           torch.where(kind == sh.CAPSULE, g_cap,
           torch.where(kind == sh.CYLINDER, g_cyl,
           torch.where(kind == sh.CONE, g_cone, g_ball)))))


def _support_point(kind, params, rot, m_local):
    """The cast shape's local support point along m, rotated to world."""
    mx, my, mz = m_local.unbind(-1)
    mlen = sqrt_rn(torch.clamp(mx * mx + my * my + mz * mz, min=1e-12))
    n = m_local / mlen[..., None]
    if kind == sh.CUBOID:
        p = torch.sign(m_local) * params[..., :3]
    elif kind in (sh.CAPSULE, sh.CYLINDER, sh.CONE):
        p = torch.stack([n[..., 0] * params[..., 1],
                         torch.sign(my) * params[..., 0],
                         n[..., 2] * params[..., 1]], -1)
    else:
        p = n * params[..., 0:1]
    return _mv(rot, p)


def shape_cast(state: PhysicsState, t: PhysicsTemplate, kind, params,
               origin, rotation, direction, max_toi=float("inf")):
    """Convex shape cast (cast_shape, physics/mod.rs:1357): sweep a shape
    of `kind` (BALL/CUBOID/CAPSULE/CYLINDER/CONE) from (origin, rotation
    [W,R,4] or None) along `direction` [W,R,3] (a velocity: toi is in its
    time units) by a swept SAT over the shapes' axes, the collider's axes,
    their 9 crosses, the centre line, the sweep direction and halfspace
    normals: every gap is linear in the sweep, so the hit time is the
    latest crossing and a positive non-closing gap certifies a miss. Same
    dict as cast_ray."""
    kind = int(kind)
    cpos, crot = _collider_world(state, t)              # [W,C,3], [W,C,3,3]
    dev = cpos.device
    w, c = cpos.shape[:2]
    origin = _f32(origin, dev)
    direction = _f32(direction, dev)
    r = origin.shape[1]
    if rotation is None:
        rot_a = torch.eye(3, device=dev).expand(w, r, 3, 3)
    else:
        rot_a = quat_mod.to_mat3(_f32(rotation, dev))
    p6 = torch.zeros(6, device=dev)
    p6[:len(params)] = _f32(params, dev)
    p6 = p6.expand(w, r, 6)
    ctype = const(t.col_shape, dev)
    is_hs = ctype == sh.HALFSPACE
    cparams = const(t.col_params, dev)

    axes_a = [rot_a[..., None, :, j].expand(w, r, c, 3) for j in range(3)]
    axes_b = [crot[:, None, :, :, j].expand(w, r, c, 3) for j in range(3)]
    c2c = cpos[:, None] - origin[:, :, None]            # [W,R,C,3]
    dn = direction[:, :, None].expand(w, r, c, 3)
    cands = list(axes_a) + list(axes_b) + [c2c, dn]
    for i in range(3):
        for j in range(3):
            cr_ = torch.linalg.cross(axes_a[i], axes_b[j], dim=-1)
            ln = sqrt_rn(dot3(cr_, cr_))[..., None]
            cands.append(torch.where(ln > 1e-8, cr_, c2c))
    # a halfspace's only valid axis is its inward normal
    m_plane = crot[:, None, :, :, 1]
    cands.append(torch.where(is_hs[None, :, None], -m_plane, c2c))
    nd = torch.stack(cands, -2)                         # [W,R,C,D,3]
    nd = torch.cat([nd, -nd], -2)
    d_ax = nd.shape[-2]

    # gaps at λ = 0: gap_n = -h_B(-n) - h_A(n), h_X(n) = n·p_X + g_X(R_Xᵀ n)
    m_a = _mtv(rot_a[:, :, None, None], nd)
    h_a = (dot3(nd, origin[:, :, None, None])
           + _support_h(kind, p6[:, :, None, None], m_a))
    m_b = _mtv(crot[:, None, :, None], -nd)
    g_b = _support_h(ctype[None, None, :, None],
                     cparams[None, None, :, None], m_b)
    h_b_neg = dot3(-nd, cpos[:, None, :, None]) + g_b
    gap = -h_b_neg - h_a                                # [W,R,C,D]
    d_base = d_ax // 2
    ar = torch.arange(d_ax, device=dev)
    hs_ok = ((ar % d_base) == (d_base - 1))[None, None, None, :]
    hs4 = is_hs[None, None, :, None]
    gap = torch.where(hs4 & ~hs_ok, -1e9, gap)
    gap = torch.where(hs4 & hs_ok & (ar >= d_base)[None, None, None, :],
                      -1e9, gap)

    closing = dot3(nd, dn[..., None, :])
    sep = gap > 0.0
    crossing = sep & (closing > 1e-12)
    lam = torch.where(crossing, gap / torch.clamp(closing, min=1e-12), -1.0)
    toi_pair = torch.amax(lam, -1)                      # [W,R,C]
    miss_cert = torch.any(sep & (closing <= 1e-12), -1)
    toi_pair = torch.where(~torch.any(sep, -1), 0.0, toi_pair)
    toi_pair = torch.where(miss_cert | (toi_pair > max_toi)
                           | (toi_pair < 0.0), _BIG, toi_pair)

    best = argmin_first(toi_pair)                       # [W,R]
    best_toi = torch.gather(toi_pair, -1, best[..., None])[..., 0]
    hit = best_toi < _BIG
    collider = torch.where(hit, best, -1)
    body = torch.where(hit, const(t.col_body, dev).long()[best], -1)
    lam_best = _take(lam, best)                         # [W,R,D]
    n_best = _take(nd, best)                            # [W,R,D,3]
    ax_best = argmax_first(lam_best)
    n_hit = torch.gather(n_best, -2, ax_best[..., None, None].expand(
        w, r, 1, 3))[..., 0, :]
    n_hit = n_hit / torch.clamp(sqrt_rn(dot3(n_hit, n_hit))[..., None],
                                min=1e-8)
    m_loc = _mtv(rot_a, n_hit)
    sp = _support_point(kind, p6, rot_a, m_loc)
    point = origin + direction * torch.where(hit, best_toi,
                                             0.0)[..., None] + sp
    return dict(hit=hit, toi=torch.where(hit, best_toi, float("inf")),
                collider=collider, body=body, point=point, normal=-n_hit)


def compute_contacts(state: PhysicsState, t: PhysicsTemplate, pred=0.002):
    """Contact introspection (physics/mod.rs:2002-2018): the kind-grouped
    narrowphase over a dense template's static pair list, at prediction
    distance `pred`. Returns the compact layout's dict (normal, point,
    depth, active) with the bodies of each slot (body_a, body_b, numpy)."""
    from fyrox_tpu_torch.physics import narrowphase as np_mod
    if t.pair_kind_ranges is None:
        raise ValueError("compute_contacts requires a dense pair list")
    cpos, crot = _collider_world(state, t)
    dev = cpos.device
    cparams = const(t.col_params, dev)
    pa = const(t.pair_a, dev, torch.int64)
    pb = const(t.pair_b, dev, torch.int64)
    hull_ctx = (None if t.hulls is None else
                (t.hulls, t.col_hull, t.pair_a, t.pair_b))
    scenery_ctx = None
    if t.col_hf is not None or t.col_tm is not None:
        scenery_ctx = (t.hf_heights, t.hf_size, t.col_hf, t.tm_tris,
                       t.tm_mask, t.col_tm, t.pair_a, t.pair_b)
    flat = np_mod.generate_contacts_flat(
        t.pair_kind_ranges, cparams[pa][None], cpos[:, pa], crot[:, pa],
        cparams[pb][None], cpos[:, pb], crot[:, pb], pred=float(pred),
        hull_ctx=hull_ctx, scenery_ctx=scenery_ctx)
    pair_idx, _ = t.flat_layout()
    flat["body_a"] = np.asarray(t.col_body[t.pair_a[pair_idx]])
    flat["body_b"] = np.asarray(t.col_body[t.pair_b[pair_idx]])
    return flat
