"""Animation Blending State Machine, batched (fyrox-animation machine/).

A state's pose source is a single clip, a weighted clip list
(BlendAnimations) or a 2D blend space; transitions fire on boolean
parameters and blend over their duration. Layered machines
(machine/layer.rs:590) stack several such graphs, each blended over the
layers below it with a weight and a bone mask (mask.rs:220), against one
set of typed parameters (parameter.rs).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch._util import const, resolve_device
from fyrox_tpu_torch.animation import blendspace as bs_mod
from fyrox_tpu_torch.animation import pose as pose_mod

__all__ = ["MachineTemplate", "MachineBuilder", "MachineState",
           "init_machine_state", "update_machine", "evaluate_pose",
           "Parameters", "make_parameters", "LayerSpec", "LayeredMachine",
           "init_layered_state", "update_layers", "evaluate_layers"]


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
    # blend-space states (machine/node/blendspace.rs): (state index,
    # BlendSpaceTemplate) pairs; given a sampling point, such a state takes
    # its pose from the blend space instead of its clip list
    state_spaces: list = field(default_factory=list)

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
        """A state's pose source: a single clip, a weighted list [(clip,
        weight), ...], or a BlendSpaceTemplate sampled at the [W,2] point
        given to evaluate_pose (its first point's clip otherwise)."""
        if clips is None:
            clips = [(int(blendspace.clips[0]) if blendspace is not None
                      else int(clip), 1.0)]
        self._states.append((name, list(clips), blendspace))
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
        for i, (_, cl, _bs) in enumerate(self._states):
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
            param_names=list(self._params),
            state_spaces=[(i, st[2]) for i, st in enumerate(self._states)
                          if st[2] is not None])


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


def _where_pose(sel, pa, pb):
    """Per-world choice between two pose tuples; sel [W] bool."""
    out = []
    for a, b in zip(pa, pb):
        s = sel.reshape(sel.shape + (1,) * (a.dim() - 1))
        out.append(torch.where(s, a, b))
    return tuple(out)


def _state_pose(mt: MachineTemplate, state_idx, poses: pose_mod.PoseSet,
                sampling=None):
    """A state's pose: its normalized N-way clip blend (blend.rs:92), or,
    for a blend-space state when a sampling point [W,2] is given, the
    blend space's pose there (blendspace.rs:120)."""
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
    if sampling is not None:
        for s, bst in mt.state_spaces or []:
            acc = _where_pose(state_idx == s,
                              bs_mod.blendspace_pose(bst, sampling, poses),
                              acc)
    return acc


def evaluate_pose(mt: MachineTemplate, ms: MachineState,
                  poses: pose_mod.PoseSet, sampling=None):
    """blend(source state's pose, current state's pose, blend factor);
    `sampling` [W,2] is the blend-space states' sampling point
    (Parameter::SamplingPoint, blendspace.rs:127)."""
    pa = _state_pose(mt, ms.source, poses, sampling)
    pb = _state_pose(mt, ms.current, poses, sampling)
    return pose_mod.blend_pose(pa, pb, ms.blend)


# --------------------------------------------------------------------------
# typed parameters and layered machines (machine/layer.rs:590, mask.rs:220,
# parameter.rs)
# --------------------------------------------------------------------------

class Parameters(NamedTuple):
    """The reference's Parameter enum as batched typed tensors: Rule →
    bools, Weight → floats, SamplingPoint → points, Index → indices."""
    bools: torch.Tensor      # [W, Pb] bool
    floats: torch.Tensor     # [W, Pf] f32
    points: torch.Tensor     # [W, Pp, 2] f32
    indices: torch.Tensor    # [W, Pi] int32


def make_parameters(num_worlds, bools=0, floats=0, points=0, indices=0,
                    device="cuda") -> Parameters:
    device = resolve_device(device)
    w = num_worlds
    return Parameters(
        bools=torch.zeros((w, max(bools, 1)), dtype=torch.bool,
                          device=device),
        floats=torch.zeros((w, max(floats, 1)), dtype=torch.float32,
                           device=device),
        points=torch.zeros((w, max(points, 1), 2), dtype=torch.float32,
                           device=device),
        indices=torch.zeros((w, max(indices, 1)), dtype=torch.int32,
                            device=device))


@dataclass
class LayerSpec:
    """One machine layer (MachineLayer): its own state graph, a blend
    weight (fixed, or a float parameter), and a bone mask (LayerMask:
    nodes not in it keep the lower layers' pose)."""
    machine: MachineTemplate
    mask: np.ndarray = None          # [N_nodes] bool (None = every node)
    weight: float = 1.0
    weight_param: int = -1           # float-parameter index (-1 = fixed)
    sampling_param: int = -1         # point-parameter index for blend spaces

    def __post_init__(self):
        if self.mask is not None:
            self.mask = np.asarray(self.mask, bool)


@dataclass
class LayeredMachine:
    layers: List[LayerSpec]


def init_layered_state(lm: LayeredMachine, num_worlds,
                       device="cuda") -> tuple:
    return tuple(init_machine_state(l.machine, num_worlds, device)
                 for l in lm.layers)


def update_layers(lm: LayeredMachine, states, params: Parameters, dt):
    """Every layer's transitions tick against the shared bool
    parameters."""
    return tuple(update_machine(l.machine, s, params.bools, dt)
                 for l, s in zip(lm.layers, states))


def evaluate_layers(lm: LayeredMachine, states, poses: pose_mod.PoseSet,
                    params: Parameters = None):
    """Layer 0's pose, then each upper layer blended on top with per-node
    weight = layer weight × bone mask. A masked-off node keeps the lower
    layers' value exactly: the upper pose's masks are zeroed there."""
    out = None
    for spec, ms in zip(lm.layers, states):
        sampling = None
        if spec.sampling_param >= 0 and params is not None:
            sampling = params.points[:, spec.sampling_param]
        p = evaluate_pose(spec.machine, ms, poses, sampling)
        if out is None:
            out = p
            continue
        w, n = out[0].shape[:2]
        if spec.weight_param >= 0 and params is not None:
            wgt = params.floats[:, spec.weight_param, None].expand(w, n)
        else:
            wgt = torch.full((w, n), float(spec.weight), dtype=torch.float32,
                             device=out[0].device)
        if spec.mask is not None:
            mk = const(spec.mask, out[0].device)
            wgt = wgt * mk.to(torch.float32)[None]
            p = (p[0], p[1], p[2], p[3] & mk[None], p[4] & mk[None],
                 p[5] & mk[None])
        out = pose_mod.blend_pose(out, p, wgt)
    return out
