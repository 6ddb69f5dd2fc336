"""AnimationPlayer and ABSM glue (scene/animation/mod.rs:340,
scene/animation/absm.rs:311): sample the clips at their current times,
apply the pose (clips overwriting in order, or a machine's blend), then
advance the clip clocks (Animation::tick, lib.rs:471)."""
from __future__ import annotations

import torch

from fyrox_tpu_torch.animation import machine as machine_mod
from fyrox_tpu_torch.animation import pose as pose_mod
from fyrox_tpu_torch.animation import rootmotion as rm_mod
from fyrox_tpu_torch.animation import track as track_mod

__all__ = ["step_player", "step_absm", "step_absm_layered",
           "step_player_root_motion"]


def step_player(aset: track_mod.AnimationSet, anim: track_mod.AnimationState,
                position, rotation, scale, dt):
    """One AnimationPlayer tick: the enabled clips' poses at the current
    times overwrite in clip order (the last enabled clip with a track on a
    binding wins), then the clocks advance. Returns (anim, position,
    rotation, scale)."""
    n_nodes = position.shape[1]
    sampled = track_mod.sample_tracks(aset, anim)
    if sampled:
        poses = pose_mod.build_poses(aset, sampled, n_nodes)
        position, rotation, scale = pose_mod.apply_overwrite(
            poses, anim.enabled, position, rotation, scale)
    anim = track_mod.tick_times(aset, anim, dt)
    return anim, position, rotation, scale


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


def step_absm_layered(aset, lm: machine_mod.LayeredMachine, anim, states,
                      params: machine_mod.Parameters,
                      position, rotation, scale, dt):
    """Layered ABSM tick (machine/layer.rs:590): every layer's transitions
    advance against the shared typed parameters, then the layers' poses
    composite bottom-up with per-node bone-mask weights (mask.rs:220).
    Returns (anim, layer_states, position, rotation, scale)."""
    n_nodes = position.shape[1]
    sampled = track_mod.sample_tracks(aset, anim)
    states = machine_mod.update_layers(lm, states, params, dt)
    if sampled:
        poses = pose_mod.build_poses(aset, sampled, n_nodes)
        final = machine_mod.evaluate_layers(lm, states, poses, params)
        position, rotation, scale = pose_mod.apply_pose(
            final, position, rotation, scale)
    anim = track_mod.tick_times(aset, anim, dt)
    return anim, states, position, rotation, scale


def step_player_root_motion(aset, rmd: rm_mod.RootMotionData, anim,
                            rm_state, position, rotation, scale, dt):
    """AnimationPlayer tick with root motion (Animation::tick lib.rs:471 +
    update_root_motion :498): the root's extracted channels are pinned in
    the applied pose and their deltas returned for the engine to apply to
    the character's body.

    Returns (anim, rm_state, position, rotation, scale, delta_position
    [W,3]: the enabled clips' sum, in the root's local frame)."""
    n_nodes = position.shape[1]
    sampled = track_mod.sample_tracks(aset, anim)
    anim2 = track_mod.tick_times(aset, anim, dt)
    rm_state, dp, _dr, sampled = rm_mod.extract_root_motion(
        rmd, aset, sampled, anim.time, anim2.time, rm_state)
    if sampled:
        poses = pose_mod.build_poses(aset, sampled, n_nodes)
        position, rotation, scale = pose_mod.apply_overwrite(
            poses, anim.enabled, position, rotation, scale)
    delta = torch.sum(dp * anim.enabled.to(dp.dtype)[..., None], dim=1)
    return anim2, rm_state, position, rotation, scale, delta
