"""Animation poses: dense per-clip candidate values, blending, application
(fyrox-animation pose.rs; scene-side apply, scene/animation/mod.rs:117).

A pose is dense: [W, A, N, ·] candidate local values per clip plus static
[A, N] masks saying which clip animates which node binding.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch._util import const
from fyrox_tpu_torch.animation.track import AnimationSet
from fyrox_tpu_torch.core import quat

__all__ = ["PoseSet", "build_poses", "apply_overwrite", "select_anim_pose",
           "blend_pose", "apply_pose"]


class PoseSet(NamedTuple):
    position: torch.Tensor      # [W,A,N,3]
    rotation: torch.Tensor      # [W,A,N,4]
    scale: torch.Tensor         # [W,A,N,3]
    pos_mask: torch.Tensor      # [A,N] bool
    rot_mask: torch.Tensor
    scl_mask: torch.Tensor


def _dense_masks(aset: AnimationSet, n_nodes: int):
    cache = getattr(aset, "_dense_masks", None)
    if cache is None or cache[0] != n_nodes:
        a = aset.num_animations

        def mk(nodes, anims):
            m = np.zeros((a, n_nodes), bool)
            if nodes is not None and nodes.size:
                m[anims, nodes] = True
            return m

        cache = (n_nodes, mk(aset.pos_node, aset.pos_anim),
                 mk(aset.rot_node, aset.rot_anim),
                 mk(aset.scl_node, aset.scl_anim))
        aset._dense_masks = cache
    return cache[1:]


def build_poses(aset: AnimationSet, sampled: dict, n_nodes: int) -> PoseSet:
    """Scatter sampled track values into dense [W, A, N, ·] poses."""
    vals0 = next(iter(sampled.values()))[2]
    w, dev, dt = vals0.shape[0], vals0.device, vals0.dtype
    a = aset.num_animations
    pos = torch.zeros((w, a, n_nodes, 3), dtype=dt, device=dev)
    rot = torch.zeros((w, a, n_nodes, 4), dtype=dt, device=dev)
    rot[..., 3] = 1.0
    scl = torch.ones((w, a, n_nodes, 3), dtype=dt, device=dev)
    for kind, arr in (("position", pos), ("rotation", rot), ("scale", scl)):
        if kind in sampled:
            nodes, anims, vals = sampled[kind]
            arr[:, const(anims, dev).long(), const(nodes, dev).long()] = vals
    pm, rm, sm = (const(m, dev) for m in _dense_masks(aset, n_nodes))
    return PoseSet(pos, rot, scl, pm, rm, sm)


def apply_overwrite(poses: PoseSet, enabled, position, rotation, scale):
    """AnimationPlayer application: enabled clips apply in clip order, the
    last enabled clip with a track winning per node binding."""
    a = poses.position.shape[1]
    prio = torch.arange(1, a + 1, device=enabled.device)[None, :, None]

    def overwrite(vals, mask, cur):
        p = torch.where(enabled[..., None] & mask[None], prio, 0)  # [W,A,N]
        win = torch.argmax(p, dim=1)                               # [W,N]
        has = p.amax(dim=1) > 0
        idx = win[:, None, :, None].expand(-1, 1, -1, vals.shape[-1])
        chosen = torch.gather(vals, 1, idx)[:, 0]
        return torch.where(has[..., None], chosen, cur)

    return (overwrite(poses.position, poses.pos_mask, position),
            overwrite(poses.rotation, poses.rot_mask, rotation),
            overwrite(poses.scale, poses.scl_mask, scale))


def select_anim_pose(poses: PoseSet, anim_idx):
    """One clip's pose per world: anim_idx [W] → (pos, rot, scl, masks)."""
    w = anim_idx.shape[0]
    ar = torch.arange(w, device=anim_idx.device)
    return (poses.position[ar, anim_idx], poses.rotation[ar, anim_idx],
            poses.scale[ar, anim_idx], poses.pos_mask[anim_idx],
            poses.rot_mask[anim_idx], poses.scl_mask[anim_idx])


def blend_pose(pa, pb, weight):
    """NodePose::blend_with (pose.rs:41): lerp positions/scales, nlerp
    rotations; weight [W] is pb's weight. Where only one pose has a value,
    that value is taken."""
    ap, ar, asl, apm, arm, asm_ = pa
    bp, br, bsl, bpm, brm, bsm = pb
    w = weight
    while w.dim() < ap.dim() - 1:
        w = w[..., None]

    def mix(a, b, am, bm, is_rot=False):
        both = (am & bm)[..., None]
        only_a = (am & ~bm)[..., None]
        blended = (quat.nlerp(a, b, w[..., None]) if is_rot
                   else a + (b - a) * w[..., None])
        return torch.where(both, blended, torch.where(only_a, a, b))

    return (mix(ap, bp, apm, bpm), mix(ar, br, arm, brm, True),
            mix(asl, bsl, asm_, bsm), apm | bpm, arm | brm, asm_ | bsm)


def apply_pose(pose, position, rotation, scale):
    """Write a pose into local transforms where masked."""
    pp, pr, ps, pm, rm, sm = pose
    return (torch.where(pm[..., None], pp, position),
            torch.where(rm[..., None], pr, rotation),
            torch.where(sm[..., None], ps, scale))
