"""Animation editor panel: dopesheet + track authoring, headless.

Equivalent of the editor's animation plugin (ref:
editor/src/plugins/animation/ — track.rs track list, ruler.rs time
ruler, thumb.rs scrub cursor, toolbar.rs playback, command/ undo). Every
edit is a `Command` on the shared functional `CommandStack`;
`compile()` lowers the dopesheet document to a runtime `AnimationSet`
(AnimationSetBuilder packing), and `scrub(t)` samples the real
`sample_tracks` path at the cursor — the editor's preview.

Key model: a track owns three component channels (x/y/z or euler XYZ),
each a sorted list of (time, value, tangent) keys — the same key tuples
`ui/curve_editor.py` renders, so the dopesheet and the curve editor
share one document.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple

import numpy as np
import torch

from fyrox_tpu_torch.animation import track as track_mod
from fyrox_tpu_torch.utils.commands import Command, CommandStack

__all__ = ["AnimDocument", "AnimClip", "AnimTrack", "AnimationEditor",
           "POSITION", "ROTATION", "SCALE"]

POSITION, ROTATION, SCALE = "position", "rotation", "scale"


@dataclass(frozen=True)
class AnimTrack:
    """One bound track (animation/track.rs TrackView)."""
    node: int
    kind: str                                   # position|rotation|scale
    channels: Tuple[Tuple[Tuple[float, float, float], ...], ...] = \
        ((), (), ())                            # 3 x sorted (t, v, tangent)
    enabled: bool = True


@dataclass(frozen=True)
class AnimClip:
    name: str
    length: float = 1.0
    speed: float = 1.0
    looping: bool = True
    tracks: Tuple[AnimTrack, ...] = ()


@dataclass(frozen=True)
class AnimDocument:
    clips: Tuple[AnimClip, ...] = ()


def _with_clip(d: AnimDocument, c: int, clip: AnimClip) -> AnimDocument:
    return replace(d, clips=d.clips[:c] + (clip,) + d.clips[c + 1:])


def _with_track(clip: AnimClip, t: int, tr: AnimTrack) -> AnimClip:
    return replace(clip, tracks=clip.tracks[:t] + (tr,) + clip.tracks[t + 1:])


class AnimationEditor:
    """Headless animation editor session over a CommandStack."""

    def __init__(self, doc: Optional[AnimDocument] = None):
        self.stack = CommandStack(doc or AnimDocument())
        self.cursor = 0.0           # thumb.rs scrub position (seconds)
        self.selection: Tuple[int, int, int, int] = (-1, -1, -1, -1)
        # (clip, track, channel, key) — selection.rs

    @property
    def doc(self) -> AnimDocument:
        return self.stack.state

    # ---- clip commands ----
    def add_clip(self, name: str, length=1.0, speed=1.0,
                 looping=True) -> int:
        idx = len(self.doc.clips)
        clip = AnimClip(name=name, length=float(length), speed=float(speed),
                        looping=bool(looping))
        self.stack.do(Command(
            f"Add Clip '{name}'",
            lambda d: replace(d, clips=d.clips + (clip,))))
        return idx

    def set_clip_props(self, c: int, **props):
        """length / speed / looping / name (toolbar.rs fields)."""
        self.stack.do(Command(
            f"Set Clip {c} properties",
            lambda d: _with_clip(d, c, replace(d.clips[c], **props))))

    # ---- track commands (animation/command/) ----
    def add_track(self, c: int, node: int, kind: str = POSITION) -> int:
        assert kind in (POSITION, ROTATION, SCALE)
        idx = len(self.doc.clips[c].tracks)
        tr = AnimTrack(node=int(node), kind=kind)
        self.stack.do(Command(
            f"Add {kind} Track (node {node})",
            lambda d: _with_clip(d, c, replace(
                d.clips[c], tracks=d.clips[c].tracks + (tr,)))))
        return idx

    def remove_track(self, c: int, t: int):
        self.stack.do(Command(
            f"Remove Track {t}",
            lambda d: _with_clip(d, c, replace(
                d.clips[c],
                tracks=d.clips[c].tracks[:t] + d.clips[c].tracks[t + 1:]))))

    def set_track_enabled(self, c: int, t: int, enabled: bool):
        self.stack.do(Command(
            f"{'Enable' if enabled else 'Disable'} Track {t}",
            lambda d: _with_clip(d, c, _with_track(
                d.clips[c], t,
                replace(d.clips[c].tracks[t], enabled=bool(enabled))))))

    # ---- key commands (dopesheet + curve editor shared document) ----
    def add_key(self, c: int, t: int, channel: int, time: float,
                value: float, tangent: float = 0.0) -> int:
        """Insert a key keeping the channel time-sorted; returns its
        index."""
        time, value = float(time), float(value)
        new_key = (time, value, float(tangent))
        inserted_at = []      # index computed from the insertion itself,
                              # so duplicate (time, value) keys can't alias

        def apply(d: AnimDocument) -> AnimDocument:
            tr = d.clips[c].tracks[t]
            ch = list(tr.channels[channel])
            ch.append(new_key)
            ch.sort(key=lambda k: k[0])
            inserted_at[:] = [next(i for i, k in enumerate(ch)
                                   if k is new_key)]
            chans = (tr.channels[:channel] + (tuple(ch),)
                     + tr.channels[channel + 1:])
            return _with_clip(d, c, _with_track(
                d.clips[c], t, replace(tr, channels=chans)))

        self.stack.do(Command(f"Add Key @{time:.3f}", apply))
        return inserted_at[0]

    def move_key(self, c: int, t: int, channel: int, key: int,
                 time: float, value: float):
        time, value = float(time), float(value)

        def apply(d: AnimDocument) -> AnimDocument:
            tr = d.clips[c].tracks[t]
            ch = list(tr.channels[channel])
            tangent = ch[key][2]
            del ch[key]
            ch.append((time, value, tangent))
            ch.sort(key=lambda k: k[0])
            chans = (tr.channels[:channel] + (tuple(ch),)
                     + tr.channels[channel + 1:])
            return _with_clip(d, c, _with_track(
                d.clips[c], t, replace(tr, channels=chans)))

        self.stack.do(Command(f"Move Key {key}", apply))

    def delete_key(self, c: int, t: int, channel: int, key: int):
        def apply(d: AnimDocument) -> AnimDocument:
            tr = d.clips[c].tracks[t]
            ch = tr.channels[channel][:key] + tr.channels[channel][key + 1:]
            chans = (tr.channels[:channel] + (ch,)
                     + tr.channels[channel + 1:])
            return _with_clip(d, c, _with_track(
                d.clips[c], t, replace(tr, channels=chans)))

        self.stack.do(Command(f"Delete Key {key}", apply))

    def undo(self):
        return self.stack.undo()

    def redo(self):
        return self.stack.redo()

    # ---- lowering + preview ----
    def compile(self) -> track_mod.AnimationSet:
        """Lower to the runtime AnimationSet. Disabled tracks are
        OMITTED from the output entirely; keyless channels of enabled
        tracks pad with a constant key, matching the packed CurveSet's
        fixed 3-row layout."""
        ab = track_mod.AnimationSetBuilder()
        for clip in self.doc.clips:
            ci = ab.add_clip(name=clip.name, length=clip.length,
                             speed=clip.speed, looping=clip.looping)
            for tr in clip.tracks:
                if not tr.enabled:
                    continue
                keys3 = [[dict(time=t_, value=v, lt=tg, rt=tg)
                          for (t_, v, tg) in ch]
                         or [dict(time=0.0, value=0.0)]
                         for ch in tr.channels]
                if tr.kind == POSITION:
                    ab.add_position_track(ci, tr.node, keys3)
                elif tr.kind == ROTATION:
                    ab.add_rotation_track(ci, tr.node, keys3)
                else:
                    ab.add_scale_track(ci, tr.node, keys3)
        return ab.build()

    def scrub(self, time: float, device="cuda"):
        """Move the time cursor and sample the REAL track path at it on
        `device`: returns sample_tracks' dict {kind: (node_idx, anim_idx,
        values [1,T,3|4])} — the editor preview's per-node pose
        contributions."""
        self.cursor = float(time)
        aset = self.compile()
        anim = track_mod.init_animation_state(aset, 1, device=device)
        anim = track_mod.AnimationState(
            time=torch.full_like(anim.time, self.cursor),
            enabled=anim.enabled)
        return track_mod.sample_tracks(aset, anim)

    # ---- dopesheet view model (track.rs rows + ruler.rs ticks) ----
    def dopesheet(self, c: int) -> List[dict]:
        """Row-per-track summary the dopesheet widget renders: key times
        merged across the three channels."""
        rows = []
        for t, tr in enumerate(self.doc.clips[c].tracks):
            times = sorted({k[0] for ch in tr.channels for k in ch})
            rows.append(dict(track=t, node=tr.node, kind=tr.kind,
                             enabled=tr.enabled, key_times=times))
        return rows
