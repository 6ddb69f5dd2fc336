"""Animation Blending State Machine, batched (fyrox-animation machine/).

One layer; a state's pose source is a single clip or a weighted clip list
(BlendAnimations); transitions fire on boolean parameters and blend over
their duration. Blend-space states and layered machines are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch._util import const, resolve_device
from fyrox_tpu_torch.animation import pose as pose_mod

__all__ = ["MachineTemplate", "MachineBuilder", "MachineState",
           "init_machine_state", "update_machine", "evaluate_pose"]


@dataclass
class MachineTemplate:
    state_anim: np.ndarray    # [S] first clip of each state
    state_names: List[str]
    entry_state: int
    t_from: np.ndarray        # [T] int32
    t_to: np.ndarray          # [T] int32
    t_param: np.ndarray       # [T] int32 bool-parameter index
    t_invert: np.ndarray      # [T] bool — fire when the parameter is False
    t_duration: np.ndarray    # [T] f32 blend time (s)
    param_names: List[str] = field(default_factory=list)
    state_clips: np.ndarray = None     # [S, M] int32
    state_weights: np.ndarray = None   # [S, M] f32 (normalized)

    @property
    def num_states(self):
        return int(self.state_anim.shape[0])

    @property
    def num_transitions(self):
        return int(self.t_from.shape[0])


class MachineBuilder:
    def __init__(self):
        self._states = []
        self._transitions = []
        self._params = []
        self._entry = 0

    def add_parameter(self, name: str) -> int:
        self._params.append(name)
        return len(self._params) - 1

    def add_state(self, name: str, clip: int = None, clips=None,
                  blendspace=None) -> int:
        if blendspace is not None:
            raise NotImplementedError("blend-space machine states")
        if clips is None:
            clips = [(int(clip), 1.0)]
        self._states.append((name, list(clips)))
        return len(self._states) - 1

    def set_entry_state(self, state: int):
        self._entry = int(state)

    def add_transition(self, src: int, dst: int, param: int,
                       duration: float = 0.3, invert: bool = False):
        self._transitions.append((src, dst, param, invert, duration))

    def build(self) -> MachineTemplate:
        tr = self._transitions
        m = max((len(s[1]) for s in self._states), default=1)
        clips = np.zeros((len(self._states), m), np.int32)
        weights = np.zeros((len(self._states), m), np.float32)
        for i, (_, cl) in enumerate(self._states):
            total = sum(w for _, w in cl) or 1.0
            for k, (c, w) in enumerate(cl):
                clips[i, k] = c
                weights[i, k] = w / total
        return MachineTemplate(
            state_anim=clips[:, 0].copy(),
            state_names=[s[0] for s in self._states],
            state_clips=clips, state_weights=weights,
            entry_state=self._entry,
            t_from=np.asarray([t[0] for t in tr], np.int32),
            t_to=np.asarray([t[1] for t in tr], np.int32),
            t_param=np.asarray([t[2] for t in tr], np.int32),
            t_invert=np.asarray([t[3] for t in tr], bool),
            t_duration=np.asarray([t[4] for t in tr], np.float32),
            param_names=list(self._params))


class MachineState(NamedTuple):
    current: torch.Tensor    # [W] int32 — destination/active state
    source: torch.Tensor     # [W] int32 — state blended away from
    blend: torch.Tensor      # [W] f32 in [0,1]; 1 == settled
    duration: torch.Tensor   # [W] f32 active transition blend time


def init_machine_state(mt: MachineTemplate, num_worlds: int,
                       device="cuda") -> MachineState:
    device = resolve_device(device)
    e = torch.full((num_worlds,), mt.entry_state, dtype=torch.int32,
                   device=device)
    one = torch.ones((num_worlds,), dtype=torch.float32, device=device)
    return MachineState(current=e, source=e.clone(), blend=one,
                        duration=one.clone())


def update_machine(mt: MachineTemplate, ms: MachineState, params,
                   dt) -> MachineState:
    """One machine tick (machine/layer.rs:590). params: [W, P] bool. An
    idle world fires the lowest-index enabled transition leaving its
    current state; transitioning worlds advance the blend clock."""
    if mt.num_transitions == 0:
        return ms
    dev = ms.current.device
    t_from = const(mt.t_from, dev)
    t_to = const(mt.t_to, dev)
    t_invert = const(mt.t_invert, dev)
    t_duration = const(mt.t_duration, dev)
    idle = ms.blend >= 1.0
    pvals = params[:, const(mt.t_param, dev).long()]            # [W,T]
    fire = pvals ^ t_invert[None]
    match = idle[:, None] & fire & (ms.current[:, None] == t_from[None])
    any_match = match.any(dim=1)
    first = torch.argmax(match.to(torch.uint8), dim=1)
    source = torch.where(any_match, ms.current, ms.source)
    current = torch.where(any_match, t_to[first], ms.current)
    duration = torch.where(any_match,
                           torch.clamp(t_duration[first], min=1e-6),
                           ms.duration)
    blend = torch.where(any_match, torch.zeros_like(ms.blend), ms.blend)
    blend = torch.clamp(blend + dt / duration, max=1.0)
    source = torch.where(blend >= 1.0, current, source)
    return MachineState(current=current, source=source, blend=blend,
                        duration=duration)


def _state_pose(mt: MachineTemplate, state_idx, poses: pose_mod.PoseSet):
    """A state's pose: its normalized N-way clip blend (blend.rs:92)."""
    dev = state_idx.device
    sidx = state_idx.long()
    clips = const(mt.state_clips, dev).long()[sidx]       # [W,M]
    weights = const(mt.state_weights, dev)[sidx]          # [W,M]
    acc = pose_mod.select_anim_pose(poses, clips[:, 0])
    cum = weights[:, 0]
    for k in range(1, clips.shape[-1]):
        pk = pose_mod.select_anim_pose(poses, clips[:, k])
        new_cum = cum + weights[:, k]
        frac = torch.where(new_cum > 1e-8,
                           weights[:, k] / torch.clamp(new_cum, min=1e-8),
                           torch.zeros_like(new_cum))
        acc = pose_mod.blend_pose(acc, pk, frac)
        cum = new_cum
    return acc


def evaluate_pose(mt: MachineTemplate, ms: MachineState,
                  poses: pose_mod.PoseSet):
    """blend(source state's pose, current state's pose, blend factor)."""
    pa = _state_pose(mt, ms.source, poses)
    pb = _state_pose(mt, ms.current, poses)
    return pose_mod.blend_pose(pa, pb, ms.blend)
