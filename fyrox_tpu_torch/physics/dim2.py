"""2D physics: the dim2 shape vocabulary on the z-locked 3D pipeline (the
port of ``fyrox_tpu/physics/dim2.py``).

Equivalent of the reference's scene/dim2/ module (collider.rs:195
ColliderShape over rapier2d). A z-locked 3D world is a 2D world: every 2D
shape maps to a z-extruded 3D shape and every body gets the dim2 locks (z
translation, x/y rotation), so one solver and one broadphase serve both
dimensions: circles, rectangles, capsules, segments and polylines (thin
boxes), triangles (z-extruded convex prisms), heightfields (a 1D profile
extruded along z), halfspaces and revolute joints.
"""
from __future__ import annotations

import math

import numpy as np

from fyrox_tpu_torch.physics import shapes as sh
from fyrox_tpu_torch.physics.joints import JointKind
from fyrox_tpu_torch.physics.world import DYNAMIC, PhysicsBuilder

__all__ = ["Physics2DBuilder", "EXTRUDE_HALF"]

EXTRUDE_HALF = 10.0   # z half-depth of extruded shapes: any value larger
                      # than one cell keeps broadphase z-overlap always-on


class Physics2DBuilder:
    """2D facade over PhysicsBuilder (scene/dim2/physics semantics).

    Positions are (x, y); rotations are angles about +z. ``build()``
    returns the regular PhysicsTemplate, stepped by the normal engine and
    world machinery."""

    def __init__(self):
        self.pb = PhysicsBuilder()

    def add_body(self, node=-1, body_type=DYNAMIC, position=(0.0, 0.0),
                 angle=0.0, **kw) -> int:
        q = (0.0, 0.0, math.sin(angle * 0.5), math.cos(angle * 0.5))
        return self.pb.add_body(node=node, body_type=body_type,
                                position=(position[0], position[1], 0.0),
                                rotation=q, dim2=True, **kw)

    def add_circle(self, body, radius, **kw) -> int:
        return self.pb.add_collider(body, sh.BALL, [radius], **kw)

    def add_rectangle(self, body, half_x, half_y, **kw) -> int:
        return self.pb.add_collider(body, sh.CUBOID,
                                    [half_x, half_y, EXTRUDE_HALF], **kw)

    def add_capsule(self, body, half_height, radius, **kw) -> int:
        """2D capsule along +y (dim2 CapsuleShape's default axis)."""
        return self.pb.add_collider(body, sh.CAPSULE, [half_height, radius],
                                    **kw)

    def add_segment(self, body, a, b, thickness=0.05, **kw) -> int:
        """Segment a→b as a thin rotated box (SegmentShape)."""
        ax, ay = a
        bx, by = b
        mid = ((ax + bx) * 0.5, (ay + by) * 0.5, 0.0)
        ang = math.atan2(by - ay, bx - ax)
        q = (0.0, 0.0, math.sin(ang * 0.5), math.cos(ang * 0.5))
        return self.pb.add_collider(
            body, sh.CUBOID,
            [math.hypot(bx - ax, by - ay) * 0.5, thickness, EXTRUDE_HALF],
            offset=mid, offset_rot=q, **kw)

    def add_triangle(self, body, a, b, c, **kw) -> int:
        """TriangleShape as a z-extruded convex prism."""
        pts = [(x, y, z) for (x, y) in (a, b, c)
               for z in (-EXTRUDE_HALF, EXTRUDE_HALF)]
        return self.pb.add_collider(body, sh.CONVEX,
                                    points=np.asarray(pts, np.float32), **kw)

    def add_heightfield(self, body, heights, size_x, **kw) -> int:
        """1D heightfield (HeightfieldShape): heights [Rx] over a centred x
        range, flat along z."""
        h = np.asarray(heights, np.float32)
        return self.pb.add_collider(body, sh.HEIGHTFIELD,
                                    heights=np.stack([h, h], 0),
                                    size=(size_x, 2.0 * EXTRUDE_HALF), **kw)

    def add_polyline(self, body, points, thickness=0.05, **kw) -> list:
        """TrimeshShape's dim2 reality is a polyline: one thin box per
        segment."""
        return [self.add_segment(body, a, b, thickness=thickness, **kw)
                for a, b in zip(points, points[1:])]

    def add_halfspace(self, body, **kw) -> int:
        """Flat ground (the y = 0 plane), shared with 3D."""
        return self.pb.add_collider(body, sh.HALFSPACE, [], **kw)

    def add_revolute_joint(self, body_a, body_b, anchor_a=(0.0, 0.0),
                           anchor_b=(0.0, 0.0)) -> int:
        """2D revolute = 3D revolute about +z."""
        return self.pb.add_joint(JointKind.REVOLUTE, body_a, body_b,
                                 anchor_a=(anchor_a[0], anchor_a[1], 0.0),
                                 anchor_b=(anchor_b[0], anchor_b[1], 0.0),
                                 axis=(0.0, 0.0, 1.0))

    def build(self, **kw):
        return self.pb.build(**kw)
