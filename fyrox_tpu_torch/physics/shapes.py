"""Collider shape tags and host-side mass properties (collider.rs:511).

Param layout (params[6], unused slots zero):
  BALL [radius]; CUBOID [hx, hy, hz]; CAPSULE, CYLINDER, CONE
  [half_height, radius] (axis = local +Y, a cone's apex up); HALFSPACE []
  (normal = local +Y through the origin); CONVEX [radius_bound] (its hull
  lives on the template); HEIGHTFIELD [size_x, size_z, radius_bound] and
  TRIMESH [radius_bound] (static scenery, their tables on the template).
SEGMENT and TRIANGLE lower at build time (physics/world.py) to a
zero-radius capsule and a one-cell trimesh; no template holds them.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["BALL", "CUBOID", "CAPSULE", "CYLINDER", "CONE", "HALFSPACE",
           "CONVEX", "HEIGHTFIELD", "TRIMESH", "SEGMENT", "TRIANGLE",
           "NUM_KINDS", "shape_aabb_half_extents", "mass_properties"]

BALL, CUBOID, CAPSULE, CYLINDER, CONE, HALFSPACE = 0, 1, 2, 3, 4, 5
CONVEX, HEIGHTFIELD, TRIMESH = 6, 7, 8
NUM_KINDS = 9
SEGMENT, TRIANGLE = 9, 10

_HUGE = 1.0e9


def shape_aabb_half_extents(shape_type, params, rot_mat):
    """Conservative world-axis half-extents [..., 3] of shapes rotated by
    rot_mat [..., 3, 3] (fyrox_tpu.physics.shapes.shape_aabb_half_extents):
    the ball's radius, the abs-matrix bound of a box, of a capsule's
    [r, hh + r, r] box or of a cylinder's / cone's [r, hh, r] box, the
    rotation-invariant radius bound of a hull or of scenery; a halfspace
    gets a huge box (its bounds are set by the caller)."""
    r = params[..., 0]
    rad = params[..., 1]
    absm = torch.abs(rot_mat)
    ball = torch.stack([r, r, r], -1)
    box = torch.sum(absm * params[..., None, :3], -1)
    cap = torch.sum(absm * torch.stack([rad, r + rad, rad], -1)[..., None, :],
                    -1)
    cyl = torch.sum(absm * torch.stack([rad, r, rad], -1)[..., None, :], -1)
    hf = torch.stack([params[..., 2]] * 3, -1)
    st = shape_type[..., None]
    return torch.where(st == BALL, ball,
           torch.where(st == CUBOID, box,
           torch.where(st == CAPSULE, cap,
           torch.where((st == CYLINDER) | (st == CONE), cyl,
           torch.where((st == CONVEX) | (st == TRIMESH), ball,
           torch.where(st == HEIGHTFIELD, hf,
                       torch.full_like(box, _HUGE)))))))


def mass_properties(shape_type: int, params: np.ndarray, density: float):
    """(mass, local inertia [3,3]) of one shape, parry's formulas; scenery
    carries no mass, and a hull's comes from its geometry
    (convex.hull_mass), so CONVEX reads zero here."""
    p = np.asarray(params, np.float64)
    if shape_type == BALL:
        r = p[0]
        m = density * 4.0 / 3.0 * np.pi * r ** 3
        i = 0.4 * m * r * r
        return m, np.diag([i, i, i])
    if shape_type == CUBOID:
        hx, hy, hz = p[:3]
        m = density * 8.0 * hx * hy * hz
        ix = m / 3.0 * (hy * hy + hz * hz)
        iy = m / 3.0 * (hx * hx + hz * hz)
        iz = m / 3.0 * (hx * hx + hy * hy)
        return m, np.diag([ix, iy, iz])
    if shape_type == CAPSULE:
        hh, r = p[0], p[1]
        h = 2.0 * hh
        m_cyl = density * np.pi * r * r * h
        m_sph = density * 4.0 / 3.0 * np.pi * r ** 3
        m = m_cyl + m_sph
        i_cyl_y = 0.5 * m_cyl * r * r
        i_cyl_x = m_cyl * (3.0 * r * r + h * h) / 12.0
        i_sph = 0.4 * m_sph * r * r
        d = hh + 3.0 * r / 8.0
        i_sph_x = i_sph + m_sph * d * d
        ix = i_cyl_x + i_sph_x
        iy = i_cyl_y + i_sph
        return m, np.diag([ix, iy, ix])
    if shape_type == CYLINDER:
        hh, r = p[0], p[1]
        h = 2.0 * hh
        m = density * np.pi * r * r * h
        iy = 0.5 * m * r * r
        ix = m * (3.0 * r * r + h * h) / 12.0
        return m, np.diag([ix, iy, ix])
    if shape_type == CONE:
        hh, r = p[0], p[1]
        h = 2.0 * hh
        m = density * np.pi * r * r * h / 3.0
        iy = 0.3 * m * r * r
        ix = (m * (3.0 / 20.0 * r * r + 3.0 / 80.0 * h * h)
              + m * (h / 4.0) ** 2)
        return m, np.diag([ix, iy, ix])
    if shape_type in (HALFSPACE, HEIGHTFIELD, TRIMESH, CONVEX):
        return 0.0, np.zeros((3, 3))
    raise ValueError(f"unsupported shape type {shape_type}")
