"""Joint constraints: the static joint table and the joint passes of the
dense solver (``fyrox_tpu.physics.joints``).

Equivalent of the reference's joint wrappers (fyrox-impl/src/scene/
joint.rs:775 over rapier's ImpulseJointSet): BALL (point-to-point), FIXED
(point + full angular lock), REVOLUTE (point + angular lock of the two
off-axis directions) and PRISMATIC (full angular lock + the point
constraint projected off the slide axis).

On the slab path the joint passes run inside the TGS solve (K1,
physics/tgs_kernel.py), once per substep for velocities and
``n_stabilization`` times for positions. The dense solver
(physics/solver.py) calls the same Jacobi passes in PyTorch here
(``solve_joints_velocity``, ``joint_position_pass``): their gathers are K4a
``plane_gather`` launches and their scatters K4b ``plane_scatter`` launches
over the a-side then the b-side joint bodies, so that no float atomic
makes a tick differ from its replay.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fyrox_tpu_torch._util import const, const_rows
from fyrox_tpu_torch.core import quat
from fyrox_tpu_torch.physics.plane_ops import gather_rows, scatter_rows

__all__ = ["JointKind", "JointSet", "JointBuilder", "JTAB_ROWS",
           "joint_table", "solve_joints_velocity", "joint_position_pass"]

BALL, FIXED, REVOLUTE, PRISMATIC = 0, 1, 2, 3
_EYE3 = np.eye(3, dtype=np.float32)
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


# --------------------------------------------------------------------------
# the dense solver's joint passes (fyrox_tpu/physics/joints.py:105-226)
# --------------------------------------------------------------------------

def _statics(joints: JointSet):
    """Host tables of the passes, built once per joint set: the gather /
    scatter index (body_a then body_b) and the COM-relative anchors."""
    st = getattr(joints, "_pass_statics", None)
    if st is None:
        st = dict(idx=np.concatenate([joints.body_a, joints.body_b]
                                     ).astype(np.int32),
                  lever_a=(joints.anchor_a - joints.com_a).astype(np.float32),
                  lever_b=(joints.anchor_b - joints.com_b).astype(np.float32))
        joints._pass_statics = st
    return st


def _mm(a, b):
    """[..., 3, 3] @ [..., 3, 3]."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], -2)


def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _solve3(m, v):
    """x with m x = v for [..., 3, 3] m, through the adjugate (Cramer's
    rule: no pivoting, no host read; jnp.linalg.solve in the JAX
    package)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    c00 = m11 * m22 - m12 * m21
    c01 = m12 * m20 - m10 * m22
    c02 = m10 * m21 - m11 * m20
    inv_det = 1.0 / (m00 * c00 + m01 * c01 + m02 * c02)
    c10 = m02 * m21 - m01 * m22
    c11 = m00 * m22 - m02 * m20
    c12 = m01 * m20 - m00 * m21
    c20 = m01 * m12 - m02 * m11
    c21 = m02 * m10 - m00 * m12
    c22 = m00 * m11 - m01 * m10
    v0, v1, v2 = v.unbind(-1)
    return torch.stack([(c00 * v0 + c10 * v1 + c20 * v2) * inv_det,
                        (c01 * v0 + c11 * v1 + c21 * v2) * inv_det,
                        (c02 * v0 + c12 * v1 + c22 * v2) * inv_det], -1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def solve_joints_velocity(pos, rot, lv, av, inv_mass, ii_world,
                          joints: JointSet, h, erp=0.2):
    """One Jacobi velocity pass over all joints. pos/rot/lv/av [W,B,*],
    inv_mass [W,B], ii_world [W,B,3,3]. Returns (lv, av).

    Point constraint: relative anchor velocity → 0 with positional bias
    erp/h · C, an exact 3×3 effective-mass solve. Angular locks: relative
    angular velocity on the locked axes → 0 with orientation bias against
    the creation-time reference rotation."""
    nj = joints.num_joints
    if nj == 0:
        return lv, av
    w, b = lv.shape[:2]
    dev = lv.device
    st = _statics(joints)
    idx = const_rows(st["idx"], dev, w)
    g = gather_rows(torch.cat([pos, rot, lv, av, inv_mass[..., None],
                               ii_world.reshape(w, b, 9)], -1), idx)
    ga, gb = g[:, :nj], g[:, nj:]
    qa, qb = ga[..., 3:7], gb[..., 3:7]
    ra = quat.rotate(qa, const(st["lever_a"], dev)[None])
    rb = quat.rotate(qb, const(st["lever_b"], dev)[None])
    pa = ga[..., 0:3] + quat.rotate(qa, const(joints.anchor_a, dev)[None])
    pb = gb[..., 0:3] + quat.rotate(qb, const(joints.anchor_b, dev)[None])
    im_a, im_b = ga[..., 13], gb[..., 13]
    ii_a = ga[..., 14:23].reshape(w, nj, 3, 3)
    ii_b = gb[..., 14:23].reshape(w, nj, 3, 3)

    va = ga[..., 7:10] + _cross(ga[..., 10:13], ra)
    vb = gb[..., 7:10] + _cross(gb[..., 10:13], rb)
    c = pb - pa
    kinds = const(joints.kind, dev)[None]
    axis_w0 = quat.rotate(qa, const(joints.axis_a, dev)[None])
    is_prism = (kinds == PRISMATIC)[..., None]
    c = torch.where(is_prism,
                    c - torch.sum(c * axis_w0, -1, keepdim=True) * axis_w0, c)
    vel_err = vb - va + (erp / h) * c
    vel_err = torch.where(
        is_prism,
        vel_err - torch.sum(vel_err * axis_w0, -1, keepdim=True) * axis_w0,
        vel_err)
    eye = const(_EYE3, dev)
    sa, sb = _skew(ra), _skew(rb)
    k_mat = ((im_a + im_b)[..., None, None] * eye
             + _mm(_mm(sa, ii_a), sa.transpose(-1, -2))
             + _mm(_mm(sb, ii_b), sb.transpose(-1, -2)))
    imp = -_solve3(k_mat + 1e-9 * eye, vel_err)
    s = scatter_rows(torch.cat([
        torch.cat([-imp * im_a[..., None], quat.mv(ii_a, _cross(ra, -imp))],
                  -1),
        torch.cat([imp * im_b[..., None], quat.mv(ii_b, _cross(rb, imp))],
                  -1)], 1), idx, b)
    lv = lv + s[..., :3]
    av = av + s[..., 3:]

    # ---- angular locks, against the creation-time reference rotation ----
    g = gather_rows(av, idx)
    rel_w = g[:, nj:] - g[:, :nj]
    q_rel = quat.mul(quat.conjugate(qa), qb)
    q_err = quat.mul(quat.conjugate(const(joints.ref_rot, dev)[None]), q_rel)
    ang_err = quat.rotate(qa, 2.0 * q_err[..., :3]
                          * torch.sign(q_err[..., 3:4]))
    target = rel_w + (erp / h) * ang_err
    axis_w = quat.rotate(qa, const(joints.axis_a, dev)[None])
    t_rev = target - torch.sum(target * axis_w, -1, keepdim=True) * axis_w
    ang_target = torch.where(
        ((kinds == FIXED) | (kinds == PRISMATIC))[..., None], target,
        torch.where((kinds == REVOLUTE)[..., None], t_rev,
                    torch.zeros_like(target)))
    ang_imp = -_solve3(ii_a + ii_b + 1e-9 * eye, ang_target)
    av = av + scatter_rows(torch.cat([quat.mv(ii_a, -ang_imp),
                                      quat.mv(ii_b, ang_imp)], 1), idx, b)
    return lv, av


def joint_position_pass(pos, rot, inv_mass, joints: JointSet, erp=0.5):
    """One NGS positional correction of the anchor separation
    (translation only). Returns pos."""
    nj = joints.num_joints
    if nj == 0:
        return pos
    w, b = pos.shape[:2]
    dev = pos.device
    idx = const_rows(_statics(joints)["idx"], dev, w)
    g = gather_rows(torch.cat([pos, rot, inv_mass[..., None]], -1), idx)
    ga, gb = g[:, :nj], g[:, nj:]
    qa, qb = ga[..., 3:7], gb[..., 3:7]
    ra = quat.rotate(qa, const(joints.anchor_a, dev)[None])
    rb = quat.rotate(qb, const(joints.anchor_b, dev)[None])
    c = (gb[..., 0:3] + rb) - (ga[..., 0:3] + ra)
    axis_w = quat.rotate(qa, const(joints.axis_a, dev)[None])
    is_prism = (const(joints.kind, dev)[None] == PRISMATIC)[..., None]
    c = torch.where(is_prism,
                    c - torch.sum(c * axis_w, -1, keepdim=True) * axis_w, c)
    im_a, im_b = ga[..., 7:8], gb[..., 7:8]
    denom = torch.clamp(im_a + im_b, min=1e-9)
    corr = erp * c
    return pos + scatter_rows(torch.cat([corr * im_a / denom,
                                         -corr * im_b / denom], 1), idx, b)
