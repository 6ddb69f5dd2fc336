"""Ragdoll: physics capsules + joints mapped onto skeleton bones
(``fyrox_tpu.scene.ragdoll``; the reference's ``Ragdoll`` node,
fyrox-impl/src/scene/ragdoll.rs:94).

Each limb owns a rigid body (a capsule) bound to a bone. While a world's
ragdoll is active the bodies drive the bones (limb bodies carry
``node=bone``, so the engine's body → node sync moves them); while it is
inactive the animated bones drive the bodies kinematically:
``drive_kinematic`` overwrites those worlds' limb states from the bone
globals, a masked ``where`` per step.

The builder is host numpy; its quaternion products and rotations are
float32, as the JAX package's builder computes them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch._util import const
from fyrox_tpu_torch.core import quat
from fyrox_tpu_torch.core import transform as tfm

__all__ = ["RagdollTemplate", "RagdollBuilder", "drive_kinematic"]


class RagdollTemplate(NamedTuple):
    bodies: np.ndarray        # [L] physics body index per limb
    bones: np.ndarray         # [L] scene node index per limb
    # bind-pose offset of the body frame in the bone's global frame
    # (body = bone_global ∘ offset)
    off_pos: np.ndarray       # [L,3]
    off_rot: np.ndarray       # [L,4]


def _quat_between(a, b):
    """Unit quaternion rotating direction a onto b."""
    a = a / max(np.linalg.norm(a), 1e-9)
    b = b / max(np.linalg.norm(b), 1e-9)
    c = np.cross(a, b)
    d = float(np.dot(a, b))
    if d < -1.0 + 1e-8:                       # opposite: 180° about any ⊥
        axis = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, [0.0, 0.0, 1.0])
        axis /= np.linalg.norm(axis)
        return np.asarray([axis[0], axis[1], axis[2], 0.0], np.float32)
    s = np.sqrt((1.0 + d) * 2.0)
    q = np.asarray([c[0] / s, c[1] / s, c[2] / s, s * 0.5], np.float32)
    return q / np.linalg.norm(q)


def _qmul32(a, b):
    """Hamilton product a*b in float32 (core.quat.mul's order)."""
    ax, ay, az, aw = np.asarray(a, np.float32)
    bx, by, bz, bw = np.asarray(b, np.float32)
    return np.asarray([aw * bx + ax * bw + ay * bz - az * by,
                       aw * by - ax * bz + ay * bw + az * bx,
                       aw * bz + ax * by - ay * bx + az * bw,
                       aw * bw - ax * bx - ay * by - az * bz], np.float32)


def _cross32(a, b):
    return np.asarray([a[1] * b[2] - a[2] * b[1],
                       a[2] * b[0] - a[0] * b[2],
                       a[0] * b[1] - a[1] * b[0]], np.float32)


def _rot_apply(q, v):
    """v rotated by q in float32: v + 2 (w u×v + u×(u×v))."""
    q = np.asarray(q, np.float32)
    v = np.asarray(v, np.float32)
    u, w = q[:3], q[3]
    uv = _cross32(u, v)
    uuv = _cross32(u, uv)
    return (v + np.float32(2.0) * (w * uv + uuv)).astype(np.float32)


def _rot_inv_apply(q, v):
    qi = np.asarray(q, np.float32) * np.asarray([-1, -1, -1, 1], np.float32)
    return _rot_apply(qi, v)


class RagdollBuilder:
    """Capsule bodies + joints over an existing skeleton.

    `pb`: the scene's PhysicsBuilder. Limb capsules span head → tail in
    bind-pose world space (capsule local +Y along the limb); a limb with a
    parent joins it with a joint at its head point (ragdoll.rs joint
    wiring).
    """

    def __init__(self, pb, bone_bind_globals=None):
        self.pb = pb
        self._limbs = []
        self._bind = bone_bind_globals

    def add_limb(self, bone_node, head, tail, radius=0.08, parent=None,
                 density=1.0, friction=0.6, joint="ball",
                 bind_pos=None, bind_rot=None) -> int:
        """head/tail: bind-pose world endpoints of the limb. parent: the
        limb to join at `head`. bind_pos/bind_rot: the bone's bind-pose
        global (default: the head point, identity)."""
        from fyrox_tpu_torch.physics import CAPSULE
        from fyrox_tpu_torch.physics.joints import JointKind
        head = np.asarray(head, np.float32)
        tail = np.asarray(tail, np.float32)
        seg = tail - head
        length = float(np.linalg.norm(seg))
        hh = max(length * 0.5 - radius, 0.01)
        mid = 0.5 * (head + tail)
        rot = _quat_between(np.asarray([0.0, 1.0, 0.0]), seg)
        body = self.pb.add_body(node=bone_node, position=mid, rotation=rot)
        self.pb.add_collider(body, CAPSULE, [hh, radius], density=density,
                             friction=friction)
        if parent is not None:
            par = self._limbs[parent]
            # the shared head point in each body's local frame
            a_par = _rot_inv_apply(par["rot"], head - par["mid"])
            a_own = _rot_inv_apply(rot, head - mid)
            kind = {"ball": JointKind.BALL, "fixed": JointKind.FIXED,
                    "revolute": JointKind.REVOLUTE}[joint]
            self.pb.add_joint(kind, par["body"], body, anchor_a=a_par,
                              anchor_b=a_own)
        bp = np.asarray(bind_pos if bind_pos is not None else head,
                        np.float32)
        br = np.asarray(bind_rot if bind_rot is not None else [0, 0, 0, 1],
                        np.float32)
        self._limbs.append(dict(body=body, bone=bone_node, mid=mid, rot=rot,
                                bind_pos=bp, bind_rot=br))
        return len(self._limbs) - 1

    def build(self) -> RagdollTemplate:
        limbs = self._limbs
        off_pos = np.zeros((len(limbs), 3), np.float32)
        off_rot = np.zeros((len(limbs), 4), np.float32)
        for i, limb in enumerate(limbs):
            # body = bone_global ∘ offset  ⇒  offset = bind⁻¹ ∘ body_bind
            inv_r = limb["bind_rot"] * np.asarray([-1, -1, -1, 1], np.float32)
            off_pos[i] = _rot_apply(inv_r, limb["mid"] - limb["bind_pos"])
            off_rot[i] = _qmul32(inv_r, limb["rot"])
        return RagdollTemplate(
            bodies=np.asarray([x["body"] for x in limbs], np.int32),
            bones=np.asarray([x["bone"] for x in limbs], np.int32),
            off_pos=off_pos, off_rot=off_rot)


def drive_kinematic(phys_state, scene_state, rd: RagdollTemplate, active):
    """For worlds where `active` is False, overwrite the limb bodies'
    states from the animated bone globals, with zero velocities
    (ragdoll.rs kinematic mode). active: [W] bool tensor. Returns the
    updated PhysicsState."""
    dev = phys_state.position.device
    bones = const(rd.bones.astype(np.int64), dev)
    bidx = const(rd.bodies.astype(np.int64), dev)
    bpos, brot, _ = tfm.decompose_mat4(scene_state.globals_[:, bones])
    pos = bpos + quat.rotate(brot, const(rd.off_pos, dev)[None].expand_as(
        bpos))
    rot = quat.mul(brot, const(rd.off_rot, dev)[None].expand_as(brot))
    drive = (~torch.as_tensor(active, device=dev))[:, None, None]
    zero = torch.zeros_like(pos)
    out = {}
    for name, new in (("position", pos), ("rotation", rot),
                      ("linvel", zero), ("angvel", zero)):
        full = getattr(phys_state, name)
        upd = full.clone()
        upd[:, bidx] = torch.where(drive, new, full[:, bidx])
        out[name] = upd
    return phys_state._replace(**out)
