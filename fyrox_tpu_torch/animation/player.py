"""ABSM player glue (scene/animation/absm.rs:311): sample the clips, tick
the machine, apply the blended pose, advance the clip clocks."""
from __future__ import annotations

from fyrox_tpu_torch.animation import machine as machine_mod
from fyrox_tpu_torch.animation import pose as pose_mod
from fyrox_tpu_torch.animation import track as track_mod

__all__ = ["step_absm"]


def step_absm(aset: track_mod.AnimationSet, mt: machine_mod.MachineTemplate,
              anim: track_mod.AnimationState, ms: machine_mod.MachineState,
              params, position, rotation, scale, dt):
    """One ABSM tick. params: [W, P] bool rule values. Returns
    (anim, machine_state, position, rotation, scale)."""
    n_nodes = position.shape[1]
    sampled = track_mod.sample_tracks(aset, anim)
    ms = machine_mod.update_machine(mt, ms, params, dt)
    if sampled:
        poses = pose_mod.build_poses(aset, sampled, n_nodes)
        final = machine_mod.evaluate_pose(mt, ms, poses)
        position, rotation, scale = pose_mod.apply_pose(
            final, position, rotation, scale)
    anim = track_mod.tick_times(aset, anim, dt)
    return anim, ms, position, rotation, scale
