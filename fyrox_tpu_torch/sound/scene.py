"""Scene ↔ mixer glue: Sound and Listener nodes drive the mixer, the port
of ``fyrox_tpu/sound/scene.py`` (fyrox-impl scene/sound/mod.rs: a Sound
node writes its global position into the sound context each frame;
listener.rs: the Listener node's global pose is the context's listener).

The sync is a function of the current node globals: every rendered block
reads the globals of all source and listener nodes of all worlds and
mixes a [W, block, 2] stereo block per world in one batched pass (the
world axis W leads every tensor; the JAX package vmaps over it).
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from fyrox_tpu_torch._util import const, dot3, resolve_device, sqrt_rn
from fyrox_tpu_torch.sound.engine import (DistanceModel, SoundBuffers,
                                          SourceState, render_block)

__all__ = ["AudioTemplate", "build_audio_template", "init_audio_state",
           "render_scene_audio"]


class AudioTemplate(NamedTuple):
    """Static audio layout of one scene (host data)."""
    buffers: SoundBuffers
    src_node: np.ndarray       # [S] scene node of each source
    listener_node: int         # the node whose global is the ear pose
    base: SourceState          # [S] initial mixer state, numpy leaves


def build_audio_template(template) -> Optional[AudioTemplate]:
    """Pack a SceneTemplate's SOUND / LISTENER payloads; None where it has
    no Sound node.

    The reference's single active listener: the first Listener node wins;
    a scene without one falls back to the first camera, then to node 0,
    with a warning."""
    snd = getattr(template, "sounds", None) or {}
    nodes = np.asarray(snd.get("node", []), np.int32)
    if nodes.size == 0:
        return None
    buffers = SoundBuffers.pack([np.asarray(b, np.float32)
                                 for b in template.sound_buffers])
    listeners = getattr(template, "listeners", None) or {}
    lnodes = np.asarray(listeners.get("node", []), np.int32)
    if lnodes.size:
        listener = int(lnodes[0])
    else:
        cams = getattr(template, "cameras", None) or {}
        cnodes = np.asarray(cams.get("node", []), np.int32)
        warnings.warn("scene has Sound nodes but no Listener; using the "
                      + ("camera node as ears" if cnodes.size
                         else "root node"))
        listener = int(cnodes[0]) if cnodes.size else 0
    base = SourceState(
        buffer=np.asarray(snd["buffer"], np.int32),
        playhead=np.zeros(nodes.size, np.float32),
        playing=np.asarray(snd["playing"], bool),
        looping=np.asarray(snd["looping"], bool),
        gain=np.asarray(snd["gain"], np.float32),
        pitch=np.asarray(snd["pitch"], np.float32),
        position=np.zeros((nodes.size, 3), np.float32),
        radius=np.asarray(snd["radius"], np.float32),
        max_distance=np.asarray(snd["max_distance"], np.float32),
        rolloff=np.asarray(snd["rolloff"], np.float32))
    return AudioTemplate(buffers=buffers, src_node=nodes,
                         listener_node=listener, base=base)


def init_audio_state(at: AudioTemplate, num_worlds: int,
                     device="cuda") -> SourceState:
    """Batched [W,S,...] mixer state from the template's base sources, on
    the card unless `device` says otherwise."""
    device = resolve_device(device)
    return SourceState(*(
        torch.as_tensor(np.asarray(x), device=device).unsqueeze(0).expand(
            (num_worlds,) + np.shape(x)).contiguous() for x in at.base))


def render_scene_audio(at: AudioTemplate, audio: SourceState, globals_,
                       block_len: int = 513,
                       distance_model=DistanceModel.INVERSE):
    """Mix one stereo block per world from the CURRENT node globals.

    globals_ [W,N,4,4] (scene.globals_): each source's position is its
    node's global translation; the listener's position and ear axis (the
    +X basis column) come from the listener node's global, the reference's
    Sound::sync_native / Listener::sync_native. Returns (block
    [W, block_len, 2], the audio state with advanced playheads)."""
    dev = globals_.device
    # index_select keeps the world axis first ([W,S,4,4])
    src_idx = const(at.src_node, dev, torch.int64)
    src_pos = torch.index_select(globals_, 1, src_idx)[..., :3, 3]
    audio = audio._replace(position=src_pos)
    lg = globals_[:, at.listener_node]                            # [W,4,4]
    lpos = lg[:, :3, 3]
    lright = lg[:, :3, 0]
    lright = lright / torch.clamp(sqrt_rn(dot3(lright, lright))[..., None],
                                  min=1e-8)
    return render_block(at.buffers, audio, lpos, lright, block_len=block_len,
                        distance_model=distance_model)
