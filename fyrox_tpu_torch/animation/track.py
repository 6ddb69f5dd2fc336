"""Animation clips + packed tracks (fyrox-animation lib/track/container.rs).

An ``AnimationSet`` packs every track of every clip into component-wise
CurveSets: 3 curves per position/scale track and 3 Euler curves per
rotation track (quat = qz*qy*qx, fyrox-math lib.rs:733). Playback state
follows Animation::tick: sample at the current time, then advance by
dt*speed and wrap into the clip when looping.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from fyrox_tpu_torch._util import const, resolve_device
from fyrox_tpu_torch.core import curve as curve_mod
from fyrox_tpu_torch.core import quat

__all__ = ["AnimationSet", "AnimationSetBuilder", "AnimationState",
           "init_animation_state", "tick_times", "sample_tracks"]


@dataclass
class AnimationSet:
    length: np.ndarray          # [A] f32
    speed: np.ndarray           # [A] f32
    looping: np.ndarray         # [A] bool
    names: List[str] = field(default_factory=list)
    pos_curves: Optional[curve_mod.CurveSet] = None   # 3 rows per track
    pos_node: np.ndarray = None
    pos_anim: np.ndarray = None
    rot_curves: Optional[curve_mod.CurveSet] = None   # 3 Euler rows
    rot_node: np.ndarray = None
    rot_anim: np.ndarray = None
    scl_curves: Optional[curve_mod.CurveSet] = None
    scl_node: np.ndarray = None
    scl_anim: np.ndarray = None

    @property
    def num_animations(self):
        return int(self.length.shape[0])


class AnimationSetBuilder:
    """Host-side builder: add clips, add tracks with keyframes, pack."""

    def __init__(self):
        self._clips = []

    def add_clip(self, name="clip", length=1.0, speed=1.0,
                 looping=True) -> int:
        self._clips.append(dict(name=name, length=float(length),
                                speed=float(speed), looping=bool(looping),
                                pos=[], rot=[], scl=[]))
        return len(self._clips) - 1

    def add_position_track(self, clip: int, node: int, keys_xyz):
        self._clips[clip]["pos"].append((node, keys_xyz))

    def add_rotation_track(self, clip: int, node: int, keys_euler_xyz):
        self._clips[clip]["rot"].append((node, keys_euler_xyz))

    def add_scale_track(self, clip: int, node: int, keys_xyz):
        self._clips[clip]["scl"].append((node, keys_xyz))

    def build(self) -> AnimationSet:
        def pack(kind):
            nodes, anims, curves = [], [], []
            for a, clip in enumerate(self._clips):
                for node, keys3 in clip[kind]:
                    if len(keys3) != 3:
                        raise ValueError("a track takes 3 key lists (x, y, z)")
                    nodes.append(node)
                    anims.append(a)
                    curves.extend(keys3)
            if not nodes:
                return None, np.zeros(0, np.int32), np.zeros(0, np.int32)
            return (curve_mod.pack_curves(curves),
                    np.asarray(nodes, np.int32), np.asarray(anims, np.int32))

        pc, pn, pa = pack("pos")
        rc, rn, ra = pack("rot")
        sc, sn, sa = pack("scl")
        return AnimationSet(
            length=np.asarray([c["length"] for c in self._clips], np.float32),
            speed=np.asarray([c["speed"] for c in self._clips], np.float32),
            looping=np.asarray([c["looping"] for c in self._clips], bool),
            names=[c["name"] for c in self._clips],
            pos_curves=pc, pos_node=pn, pos_anim=pa,
            rot_curves=rc, rot_node=rn, rot_anim=ra,
            scl_curves=sc, scl_node=sn, scl_anim=sa)


class AnimationState(NamedTuple):
    time: torch.Tensor      # [W,A] f32 — Animation::time_position
    enabled: torch.Tensor   # [W,A] bool


def init_animation_state(aset: AnimationSet, num_worlds: int, device="cuda",
                         enabled=None) -> AnimationState:
    device = resolve_device(device)
    a = aset.num_animations
    en = np.ones(a, bool) if enabled is None else np.asarray(enabled, bool)
    return AnimationState(
        time=torch.zeros((num_worlds, a), dtype=torch.float32, device=device),
        enabled=torch.as_tensor(en, device=device).expand(
            num_worlds, a).contiguous())


def tick_times(aset: AnimationSet, anim: AnimationState,
               dt) -> AnimationState:
    dev = anim.time.device
    speed = const(aset.speed, dev)[None]
    length = const(aset.length, dev)[None]
    looping = const(aset.looping, dev)[None]
    new_t = anim.time + dt * speed * anim.enabled.to(anim.time.dtype)
    span = torch.clamp(length, min=1e-12)
    wrapped = torch.where(looping, torch.remainder(new_t, span),
                          torch.minimum(torch.clamp(new_t, min=0.0), length))
    return anim._replace(time=wrapped)


def sample_tracks(aset: AnimationSet, anim: AnimationState):
    """Sample every track at its clip's current time. Returns, per binding
    kind, (node_idx [T], anim_idx [T], values [W,T,3|4])."""
    dev = anim.time.device
    out = {}
    for kind, curves, nodes, anims in (
            ("position", aset.pos_curves, aset.pos_node, aset.pos_anim),
            ("rotation", aset.rot_curves, aset.rot_node, aset.rot_anim),
            ("scale", aset.scl_curves, aset.scl_node, aset.scl_anim)):
        if curves is None or not nodes.size:
            continue
        t = anim.time[:, const(anims, dev).long()]          # [W,T]
        t3 = torch.repeat_interleave(t, 3, dim=-1)          # x,y,z rows
        v = curve_mod.sample(curves, t3).reshape(t.shape[0], -1, 3)
        if kind == "rotation":
            v = quat.from_euler(v[..., 0], v[..., 1], v[..., 2])
        out[kind] = (nodes, anims, v)
    return out
