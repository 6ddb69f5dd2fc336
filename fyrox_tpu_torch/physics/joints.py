"""Joint constraints: the static joint table (``fyrox_tpu.physics.joints``).

Equivalent of the reference's joint wrappers (fyrox-impl/src/scene/
joint.rs:775 over rapier's ImpulseJointSet): BALL (point-to-point), FIXED
(point + full angular lock), REVOLUTE (point + angular lock of the two
off-axis directions) and PRISMATIC (full angular lock + the point
constraint projected off the slide axis).

Host numpy only. The joint passes run inside the TGS solve (K1,
physics/tgs_kernel.py) for any number of joints, once per substep for
velocities and ``n_stabilization`` times for positions: the JAX package's
in-kernel passes and, above its kernel's 128 joints, its XLA joint passes
(``joints.solve_joints_velocity``, ``joint_position_pass``) are the same
Jacobi passes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["JointKind", "JointSet", "JointBuilder", "JTAB_ROWS",
           "joint_table"]

BALL, FIXED, REVOLUTE, PRISMATIC = 0, 1, 2, 3
# rows of the solver's joint table: kind, anchor_a3, anchor_b3, axis_a3,
# ref_rot4, com_a3, com_b3
JTAB_ROWS = 20


class JointKind:
    BALL, FIXED, REVOLUTE, PRISMATIC = BALL, FIXED, REVOLUTE, PRISMATIC


@dataclass
class JointSet:
    """Static joint table (host-built)."""
    kind: np.ndarray          # [J]
    body_a: np.ndarray        # [J]
    body_b: np.ndarray        # [J]
    anchor_a: np.ndarray      # [J,3] body-local
    anchor_b: np.ndarray      # [J,3]
    axis_a: np.ndarray        # [J,3] local hinge / slide axis
    # the relative orientation FIXED/REVOLUTE/PRISMATIC hold: the bodies'
    # creation-time qa0^-1 * qb0 (rapier local_frame1/2), xyzw
    ref_rot: np.ndarray = None  # [J,4]
    # body-local COM offsets of the two bodies: lever arms are measured
    # from the COM
    com_a: np.ndarray = None   # [J,3]
    com_b: np.ndarray = None   # [J,3]

    def __post_init__(self):
        j = self.kind.shape[0]
        if self.ref_rot is None:
            self.ref_rot = np.tile(np.array([0, 0, 0, 1], np.float32), (j, 1))
        if self.com_a is None:
            self.com_a = np.zeros((j, 3), np.float32)
        if self.com_b is None:
            self.com_b = np.zeros((j, 3), np.float32)

    @property
    def num_joints(self):
        return int(self.kind.shape[0])


class JointBuilder:
    def __init__(self):
        self._j = []

    def add(self, kind, body_a, body_b, anchor_a=(0, 0, 0),
            anchor_b=(0, 0, 0), axis=(0, 0, 1), ref_rot=(0, 0, 0, 1)):
        self._j.append((kind, body_a, body_b,
                        np.asarray(anchor_a, np.float32),
                        np.asarray(anchor_b, np.float32),
                        np.asarray(axis, np.float32),
                        np.asarray(ref_rot, np.float32)))
        return len(self._j) - 1

    def build(self, com_local=None) -> JointSet:
        """com_local: optional [B,3] body COM table that resolves each
        joint's COM offsets."""
        j = self._j
        ba = np.asarray([x[1] for x in j], np.int32)
        bb = np.asarray([x[2] for x in j], np.int32)
        if com_local is not None and len(j):
            com_a = np.asarray(com_local, np.float32)[ba]
            com_b = np.asarray(com_local, np.float32)[bb]
        else:
            com_a = com_b = np.zeros((len(j), 3), np.float32)

        def rows(i, width):
            return (np.stack([x[i] for x in j]) if j
                    else np.zeros((0, width), np.float32))

        return JointSet(kind=np.asarray([x[0] for x in j], np.int32),
                        body_a=ba, body_b=bb, anchor_a=rows(3, 3),
                        anchor_b=rows(4, 3), axis_a=rows(5, 3),
                        ref_rot=rows(6, 4), com_a=com_a, com_b=com_b)


def joint_table(joints: JointSet) -> np.ndarray:
    """The solver's static per-joint rows [JTAB_ROWS, J] f32 (the rows of
    ``slab2._run_solver_kernel``'s jtab, without the TPU's lane padding)."""
    return np.ascontiguousarray(np.concatenate(
        [joints.kind[None].astype(np.float32), joints.anchor_a.T,
         joints.anchor_b.T, joints.axis_a.T, joints.ref_rot.T,
         joints.com_a.T, joints.com_b.T], 0), np.float32)
