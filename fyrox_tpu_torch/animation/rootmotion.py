"""Root motion extraction, batched (fyrox-animation lib.rs:307
``RootMotionSettings``, :325 ``RootMotion``, :498
``Animation::update_root_motion``).

The root bone's animated translation (and, unless ignored, rotation) is
taken off the pose, which pins the root to its cycle-start value, and
comes out as a per-tick delta that the engine applies to the character's
rigid body instead, so the capsule moves as the clip was animated.

As in the reference, the pose is sampled at the time before the advance
(Animation::tick, lib.rs:471), so ``extract_root_motion`` takes the clip
times before and after ``tick_times`` and that frame's samples. On the
frame whose advance wrapped a looping clip, the motion from the sampled
pose to the cycle's end is kept as a remainder and added on the next
frame (lib.rs:541-556), so none is lost or counted twice at the seam.

The cycle's start and end values are read at fixed times, so
``build_root_motion`` computes them on the host; a step does only
gathers, quaternion products and selections over [W, A].
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch._util import const, resolve_device
from fyrox_tpu_torch.animation.track import AnimationSet
from fyrox_tpu_torch.core import curve as curve_mod
from fyrox_tpu_torch.core import quat

__all__ = ["RootMotionSettings", "RootMotionData", "RootMotionState",
           "build_root_motion", "init_root_motion_state",
           "extract_root_motion", "blend_root_motion"]


@dataclass
class RootMotionSettings:
    """Which node is the motion root, and which channels stay on the pose
    instead of being extracted (RootMotionSettings, lib.rs:307)."""
    node: int
    ignore_x: bool = False
    ignore_y: bool = True    # the usual setup: the vertical bob stays
    ignore_z: bool = False
    ignore_rotations: bool = True


@dataclass
class RootMotionData:
    """Host precompute for one AnimationSet and its settings."""
    settings: RootMotionSettings
    pos_track: np.ndarray        # [A] int32 position track of the root, -1 none
    rot_track: np.ndarray        # [A] int32
    pos_cycle_start: np.ndarray  # [A,3] (start and end swap for speed < 0)
    pos_cycle_end: np.ndarray    # [A,3]
    rot_cycle_start: np.ndarray  # [A,4]
    rot_cycle_end: np.ndarray    # [A,4]
    pos_slice_start: np.ndarray  # [A,3] value at the slice start: the pin
    rot_slice_start: np.ndarray  # [A,4]

    def tables(self):
        """Host tables a step reads, built once (so that a captured tick
        copies nothing from the host): has_p / has_r [1,A,1] bool, keep
        [1,1,3] bool (the ignored axes), the tracks with -1 read as 0, and
        the rows and track indices that get pinned."""
        if getattr(self, "_tables", None) is None:
            st = self.settings
            pos_rows = np.nonzero(self.pos_track >= 0)[0]
            rot_rows = np.nonzero(self.rot_track >= 0)[0]
            self._tables = dict(
                has_p=(self.pos_track >= 0)[None, :, None],
                has_r=(self.rot_track >= 0)[None, :, None],
                keep=np.asarray([st.ignore_x, st.ignore_y,
                                 st.ignore_z])[None, None],
                pos_safe=np.maximum(self.pos_track, 0).astype(np.int64),
                rot_safe=np.maximum(self.rot_track, 0).astype(np.int64),
                pos_rows=pos_rows.astype(np.int64),
                pos_pinned=self.pos_track[pos_rows].astype(np.int64),
                rot_pinned=self.rot_track[rot_rows].astype(np.int64),
                rot_pin=self.rot_slice_start[rot_rows][None].astype(
                    np.float32))
        return self._tables


class RootMotionState(NamedTuple):
    """Per-world, per-clip running state (RootMotion, lib.rs:325)."""
    prev_position: torch.Tensor   # [W,A,3]
    pos_remainder: torch.Tensor   # [W,A,3] zero but on the frame after a wrap
    prev_rotation: torch.Tensor   # [W,A,4]
    rot_remainder: torch.Tensor   # [W,A,4] identity but after a wrap


def _track_value_at(curves, track_idx: int, t: float) -> np.ndarray:
    """One packed 3-component track sampled at a host-known time."""
    tt = torch.full((curves.times.shape[0],), float(np.float32(t)),
                    dtype=torch.float32)
    v = curve_mod.sample(curves, tt).numpy()
    return v[3 * track_idx:3 * track_idx + 3]


def build_root_motion(aset: AnimationSet,
                      settings: RootMotionSettings) -> RootMotionData:
    a = aset.num_animations
    pos_track = np.full(a, -1, np.int32)
    rot_track = np.full(a, -1, np.int32)
    for nodes, anims, tracks in ((aset.pos_node, aset.pos_anim, pos_track),
                                 (aset.rot_node, aset.rot_anim, rot_track)):
        if nodes is None:
            continue
        for i in range(nodes.shape[0]):
            if nodes[i] == settings.node and tracks[anims[i]] < 0:
                tracks[anims[i]] = i

    pos_s = np.zeros((a, 3), np.float32)
    pos_e = np.zeros((a, 3), np.float32)
    rot_s = np.tile(np.asarray([0, 0, 0, 1], np.float32), (a, 1))
    rot_e = rot_s.copy()
    for c in range(a):
        if pos_track[c] >= 0:
            pos_s[c] = _track_value_at(aset.pos_curves, pos_track[c], 0.0)
            pos_e[c] = _track_value_at(aset.pos_curves, pos_track[c],
                                       aset.length[c])
        if rot_track[c] >= 0:
            es = torch.as_tensor(_track_value_at(aset.rot_curves,
                                                 rot_track[c], 0.0))
            ee = torch.as_tensor(_track_value_at(aset.rot_curves,
                                                 rot_track[c],
                                                 aset.length[c]))
            rot_s[c] = quat.from_euler(es[0], es[1], es[2]).numpy()
            rot_e[c] = quat.from_euler(ee[0], ee[1], ee[2]).numpy()
    # a reversed clip's cycle starts at its end (lib.rs:544-555)
    rev = (np.asarray(aset.speed) < 0)[:, None]
    return RootMotionData(settings=settings, pos_track=pos_track,
                          rot_track=rot_track,
                          pos_cycle_start=np.where(rev, pos_e, pos_s),
                          pos_cycle_end=np.where(rev, pos_s, pos_e),
                          rot_cycle_start=np.where(rev, rot_e, rot_s),
                          rot_cycle_end=np.where(rev, rot_s, rot_e),
                          pos_slice_start=pos_s, rot_slice_start=rot_s)


def _identity(shape, device):
    q = torch.zeros(shape + (4,), dtype=torch.float32, device=device)
    q[..., 3] = 1.0
    return q


def init_root_motion_state(rmd: RootMotionData, num_worlds: int,
                           device="cuda") -> RootMotionState:
    """prev = the pose at t = 0, so that the first frame's delta is zero
    (the reference starts from zeros, which makes its first delta the
    root's absolute position)."""
    device = resolve_device(device)
    w, a = num_worlds, rmd.pos_track.shape[0]

    def tiled(x):
        return torch.as_tensor(x, device=device).expand(
            (w,) + x.shape).contiguous()

    return RootMotionState(
        prev_position=tiled(rmd.pos_slice_start),
        pos_remainder=torch.zeros((w, a, 3), dtype=torch.float32,
                                  device=device),
        prev_rotation=tiled(rmd.rot_slice_start),
        rot_remainder=_identity((w, a), device))


def extract_root_motion(rmd: RootMotionData, aset: AnimationSet,
                        sampled: dict, time_old, time_new,
                        state: RootMotionState):
    """One update_root_motion tick (lib.rs:498) over [W, A].

    sampled: ``track.sample_tracks`` at time_old (the pose before the
    advance); time_old / time_new: the clip times before and after
    ``tick_times``. Returns (new_state, delta_position [W,A,3],
    delta_rotation [W,A,4], sampled') where sampled' has the root's
    extracted channels pinned to the slice start (lib.rs:601-636)."""
    st = rmd.settings
    dev = time_old.device
    tab = {k: const(v, dev) for k, v in rmd.tables().items()}
    looping = const(aset.looping, dev)[None]
    fwd = (const(aset.speed, dev) >= 0)[None]
    wrapped = looping & torch.where(fwd, time_new < time_old,
                                    time_new > time_old)
    wr = wrapped[..., None]
    w, a = time_old.shape[0], rmd.pos_track.shape[0]
    delta_p = torch.zeros((w, a, 3), dtype=torch.float32, device=dev)
    delta_r = _identity((w, a), dev)
    new_state = state
    sampled = dict(sampled)

    has_p = tab["has_p"]
    if "position" in sampled and (rmd.pos_track >= 0).any():
        nodes, anims, vals = sampled["position"]
        pose_p = vals[:, tab["pos_safe"]]                            # [W,A,3]
        prev_position = torch.where(wr, const(rmd.pos_cycle_start, dev)[None],
                                    pose_p)
        pos_remainder = torch.where(
            wr, const(rmd.pos_cycle_end, dev)[None] - pose_p,
            torch.zeros_like(pose_p))
        delta = pose_p - state.prev_position + state.pos_remainder
        keep = tab["keep"]
        delta_p = torch.where(keep, torch.zeros_like(delta), delta) \
            * has_p.to(delta.dtype)
        new_state = new_state._replace(
            prev_position=torch.where(has_p, prev_position,
                                      state.prev_position),
            pos_remainder=torch.where(has_p, pos_remainder,
                                      state.pos_remainder))
        # the pose's root position pinned to the slice start on the
        # extracted axes
        pin = torch.where(keep, pose_p,
                          const(rmd.pos_slice_start, dev)[None])
        rows, pinned = tab["pos_rows"], tab["pos_pinned"]
        vals = vals.clone()
        vals[:, pinned] = torch.where(has_p[:, rows], pin[:, rows],
                                      vals[:, pinned])
        sampled["position"] = (nodes, anims, vals)

    has_r = tab["has_r"]
    if ((not st.ignore_rotations) and "rotation" in sampled
            and (rmd.rot_track >= 0).any()):
        nodes, anims, vals = sampled["rotation"]
        pose_r = vals[:, tab["rot_safe"]]                            # [W,A,4]
        cyc_e = const(rmd.rot_cycle_end, dev)[None].expand_as(pose_r)
        prev_rotation = torch.where(
            wr, const(rmd.rot_cycle_start, dev)[None], pose_r)
        rot_remainder = torch.where(
            wr, quat.mul(quat.conjugate(cyc_e), pose_r),
            _identity((1, 1), dev))
        current_rel = quat.mul(quat.conjugate(state.prev_rotation), pose_r)
        delta_r = torch.where(has_r, quat.mul(state.rot_remainder,
                                              current_rel), delta_r)
        new_state = new_state._replace(
            prev_rotation=torch.where(has_r, prev_rotation,
                                      state.prev_rotation),
            rot_remainder=torch.where(has_r, rot_remainder,
                                      state.rot_remainder))
        vals = vals.clone()
        vals[:, tab["rot_pinned"]] = tab["rot_pin"].expand(
            w, -1, -1).to(vals.dtype)
        sampled["rotation"] = (nodes, anims, vals)

    return new_state, delta_p, delta_r, sampled


def blend_root_motion(delta_a, delta_b, weight):
    """RootMotion::blend_with (lib.rs:340): lerp the positions, nlerp the
    rotations. delta_* are (delta_position, delta_rotation) pairs; weight
    (a float or a tensor) is delta_b's."""
    pa, ra = delta_a
    pb, rb = delta_b
    w = weight if isinstance(weight, torch.Tensor) else torch.full(
        (), float(weight), dtype=pa.dtype, device=pa.device)
    while w.dim() < pa.dim():
        w = w[..., None]
    return pa + (pb - pa) * w, quat.nlerp(ra, rb, w)
