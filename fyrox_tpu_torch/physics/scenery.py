"""Heightfield and trimesh colliders (static scenery), the port of
``fyrox_tpu/physics/scenery.py``.

The reference's Heightfield and Trimesh rows of ``ColliderShape``
(fyrox-impl/src/scene/collider.rs:511). Both are static and collide with
the dynamic shapes through one point-sample formulation: a ball samples
its centre (with its radius), a capsule its two segment ends, a cuboid
its 8 corners, a hull its vertices; each sample gets a depth, a point and
a normal against the surface, and the deepest samples form the manifold.

Heightfield: heights [Rz,Rx] over a centred local rectangle (x in
[-sx/2, sx/2], z in [-sz/2, sz/2]); a sample's contact is the tangent
plane of the bilinear cell under it (the cell's analytic gradient).
Trimesh: a padded triangle soup in local space, two-sided; a sample's
contact is its closest triangle. Where JAX chooses an index (the deepest
sample, the closest triangle) the port takes the lowest among equals.
"""
from __future__ import annotations

import numpy as np
import torch

from fyrox_tpu_torch._util import const
from fyrox_tpu_torch.physics import shapes as sh
from fyrox_tpu_torch.physics.convex import (argmax_first, argmin_first, dot,
                                           pick3, rot_apply, rot_apply_t,
                                           sqrt_rn)

__all__ = ["MAX_TRIS", "hf_sample", "points_heightfield", "points_trimesh",
           "sample_points_for", "closest_on_triangle", "heightfield_cell"]

MAX_TRIS = 256

_CORNERS = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                     for sz in (-1, 1)], np.float32)


def _norm(v):
    return sqrt_rn(dot(v, v))


def sample_points_for(kind, params, pos, rot, hull=None):
    """(samples [*,S,3], radius [*]) of a dynamic shape of the static
    `kind`; hull = (verts, vmask) for CONVEX (padding parks at the shape
    origin)."""
    if kind == sh.BALL:
        return pos[..., None, :], params[..., 0]
    if kind == sh.CAPSULE:
        axis = rot[..., :, 1]
        hh = params[..., 0:1]
        return torch.stack([pos - axis * hh, pos + axis * hh], -2), \
            params[..., 1]
    if kind == sh.CUBOID:
        local = const(_CORNERS, pos.device, pos.dtype) * params[..., None, :3]
        world = pos[..., None, :] + rot_apply(rot, local)
        return world, params.new_zeros(params.shape[:-1])
    if kind == sh.CONVEX:
        verts, vmask = hull
        world = pos[..., None, :] + rot_apply(rot, verts)
        world = torch.where(vmask[..., None], world, pos[..., None, :])
        return world, params.new_zeros(params.shape[:-1])
    raise NotImplementedError(kind)


def heightfield_cell(x, z, rx, rz, sx, sz):
    """The bilinear cell of an rz x rx heightfield of size (sx, sz) under
    local (x, z): (i0, j0, fu, fv); the sizes are tensors, so the division
    is IEEE on either device."""
    u = torch.clamp((x / sx + 0.5) * (rx - 1), 0.0, rx - 1.0)
    v = torch.clamp((z / sz + 0.5) * (rz - 1), 0.0, rz - 1.0)
    i0 = torch.clamp(torch.floor(u).to(torch.int32), 0, rx - 2)
    j0 = torch.clamp(torch.floor(v).to(torch.int32), 0, rz - 2)
    return i0, j0, u - i0, v - j0


def hf_sample(heights, size_x, size_z, x, z):
    """Bilinear height of a centred local heightfield heights [Rz,Rx] at
    local (x, z) [...]; borders clamp."""
    rz, rx = heights.shape[-2:]
    i0, j0, fu, fv = heightfield_cell(x, z, rx, rz, size_x, size_z)
    flat = heights.reshape(-1)
    idx = (j0 * rx + i0).long()
    h00, h10 = flat[idx], flat[idx + 1]
    h01, h11 = flat[idx + rx], flat[idx + rx + 1]
    return ((h00 * (1 - fu) + h10 * fu) * (1 - fv)
            + (h01 * (1 - fu) + h11 * fu) * fv)


def _deepest_normal(n_w, depth, active):
    """-(surface normal of the deepest active sample) [*,3]."""
    best = argmax_first(torch.where(active, depth, -1e9))
    return -pick3(n_w, best[..., None])[..., 0, :]


def points_heightfield(samples, radius, pos_h, rot_h, heights, size_x,
                       size_z, pred):
    """Per-sample tangent-plane contact against a posed heightfield.

    samples [*,S,3] world; radius [*]; heights [*,Rz,Rx]; size_x, size_z,
    pred [*]. Returns (normal [*,3] A→field from the deepest sample,
    points [*,S,3], depth [*,S], active [*,S])."""
    rel = samples - pos_h[..., None, :]
    local = rot_apply_t(rot_h, rel)
    x, z = local[..., 0], local[..., 2]
    sx = size_x[..., None]
    sz = size_z[..., None]
    rz_, rx_ = heights.shape[-2:]
    i0, j0, fu, fv = heightfield_cell(x, z, rx_, rz_, sx, sz)
    flat = heights.reshape(heights.shape[:-2] + (rz_ * rx_,)).expand(
        x.shape[:-1] + (rz_ * rx_,))
    idx = (j0 * rx_ + i0).long()
    h00 = torch.gather(flat, -1, idx)
    h10 = torch.gather(flat, -1, idx + 1)
    h01 = torch.gather(flat, -1, idx + rx_)
    h11 = torch.gather(flat, -1, idx + rx_ + 1)
    gy = ((h00 * (1 - fu) + h10 * fu) * (1 - fv)
          + (h01 * (1 - fu) + h11 * fu) * fv)
    dhdx = ((h10 - h00) * (1 - fv) + (h11 - h01) * fv) * (rx_ - 1) / sx
    dhdz = ((h01 - h00) * (1 - fu) + (h11 - h10) * fu) * (rz_ - 1) / sz
    n_l = torch.stack([-dhdx, torch.ones_like(gy), -dhdz], -1)
    n_l = n_l / torch.clamp(_norm(n_l)[..., None], min=1e-8)
    plane_pt = torch.stack([x, gy, z], -1)
    dist = dot(local - plane_pt, n_l)
    r = radius[..., None]
    depth = r - dist
    inside = (torch.abs(x) <= sx * 0.5 + r) & (torch.abs(z) <= sz * 0.5 + r)
    contact_l = local - n_l * dist[..., None]
    n_w = rot_apply(rot_h, n_l)
    p_w = pos_h[..., None, :] + rot_apply(rot_h, contact_l)
    active = (depth > -pred[..., None]) & inside
    return _deepest_normal(n_w, depth, active), p_w, depth, active


def closest_on_triangle(p, a, b, c):
    """Closest point on triangle abc to p (Ericson's barycentric region
    walk, branch-free); broadcasts over leading axes."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = dot(ab, ap)
    d2 = dot(ac, ap)
    bp = p - b
    d3 = dot(ab, bp)
    d4 = dot(ac, bp)
    cp = p - c
    d5 = dot(ab, cp)
    d6 = dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = torch.clamp(va + vb + vc, min=1e-12)
    v = vb / denom
    w = vc / denom
    out = a + ab * v[..., None] + w[..., None] * ac
    t_ab = torch.clamp(d1 / torch.clamp(d1 - d3, min=1e-12), 0.0, 1.0)
    t_ac = torch.clamp(d2 / torch.clamp(d2 - d6, min=1e-12), 0.0, 1.0)
    t_bc = torch.clamp((d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6),
                                               min=1e-12), 0.0, 1.0)
    regions = (
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + ab * t_ab[..., None]),
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + ac * t_ac[..., None]),
        ((va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0),
         b + (c - b) * t_bc[..., None]),
        ((d1 <= 0) & (d2 <= 0), a),
        ((d3 >= 0) & (d4 <= d3), b),
        ((d6 >= 0) & (d5 <= d6), c))
    for cond, q in regions:
        out = torch.where(cond[..., None], q, out)
    return out


def points_trimesh(samples, radius, pos_m, rot_m, tris, tmask, pred):
    """Per-sample closest-triangle contact against a posed triangle soup,
    two-sided: depth = radius - distance, the normal from the surface
    toward the sample.

    samples [*,S,3] world; tris [*,T,3,3] local; tmask [*,T]. Returns
    (normal [*,3], points [*,S,3], depth [*,S], active [*,S])."""
    rel = samples - pos_m[..., None, :]
    local = rot_apply_t(rot_m, rel)
    p = local[..., :, None, :]                          # [*,S,1,3]
    a = tris[..., None, :, 0, :]                        # [*,1,T,3]
    b = tris[..., None, :, 1, :]
    c = tris[..., None, :, 2, :]
    q = closest_on_triangle(p, a, b, c)                 # [*,S,T,3]
    d = _norm(p - q)
    x_ab, x_ac = torch.broadcast_tensors(b - a, c - a)
    n_tri = torch.linalg.cross(x_ab, x_ac, dim=-1)
    n_tri = n_tri / torch.clamp(_norm(n_tri)[..., None], min=1e-12)
    d = torch.where(tmask[..., None, :], d, 1e9)
    best = argmin_first(d)                              # [*,S]
    dist = torch.gather(d, -1, best[..., None])[..., 0]
    q_best = torch.gather(q, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    n_tri = n_tri.expand(q.shape)
    n_best = torch.gather(n_tri, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    dir_raw = local - q_best
    side = torch.sign(dot(dir_raw, n_best))
    side = torch.where(side == 0, 1.0, side)
    dlen = _norm(dir_raw)[..., None]
    dir_l = torch.where(dlen > 1e-6, dir_raw / torch.clamp(dlen, min=1e-9),
                        n_best * side[..., None])
    depth = radius[..., None] - dist
    p_w = pos_m[..., None, :] + rot_apply(rot_m, q_best)
    n_w = rot_apply(rot_m, dir_l)
    active = depth > -pred[..., None]
    return _deepest_normal(n_w, depth, active), p_w, depth, active
