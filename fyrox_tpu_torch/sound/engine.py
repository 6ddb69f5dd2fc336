"""Software sound mixer, the port of ``fyrox_tpu/sound/engine.py``
(fyrox-sound ``SoundContext::render``, context.rs:268: 44.1 kHz stereo
block mixing with per-source distance gain and constant-power panning,
the reference's "simple" path).

Every source mixes in one pass of tensor operations; ``render_block``
takes any leading batch axes (the world axis W of
``sound.scene.render_scene_audio``), so a batch of worlds mixes in the same
launches. Distance models per the reference's ``DistanceModel``
(context.rs:59): none, inverse, linear and exponent with a rolloff.
"""
from __future__ import annotations

import wave
from dataclasses import dataclass
from typing import List, NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch._util import const, dot3, resolve_device, sqrt_rn

__all__ = ["SAMPLE_RATE", "DistanceModel", "SoundBuffers", "SourceState",
           "init_sources", "render_block", "load_wav"]

SAMPLE_RATE = 44_100  # engine.rs:54


class DistanceModel:
    NONE, INVERSE, LINEAR, EXPONENT = 0, 1, 2, 3


@dataclass
class SoundBuffers:
    """Padded mono sample storage [NB, Lmax] (host arrays)."""
    samples: np.ndarray
    lengths: np.ndarray

    @staticmethod
    def pack(buffers: List[np.ndarray]) -> "SoundBuffers":
        lmax = max((len(b) for b in buffers), default=1)
        out = np.zeros((max(len(buffers), 1), lmax), np.float32)
        lens = np.zeros(max(len(buffers), 1), np.int32)
        for i, b in enumerate(buffers):
            out[i, :len(b)] = b
            lens[i] = len(b)
        return SoundBuffers(out, lens)

    def lengths_f32(self) -> np.ndarray:
        """The lengths as float32, one host array (so that ``const``
        copies it to a device once)."""
        if getattr(self, "_lengths_f32", None) is None:
            self._lengths_f32 = self.lengths.astype(np.float32)
        return self._lengths_f32


class SourceState(NamedTuple):
    """Per-source mixer state, [..., S] (position [..., S, 3])."""
    buffer: torch.Tensor       # int32
    playhead: torch.Tensor     # float32 sample position
    playing: torch.Tensor      # bool
    looping: torch.Tensor      # bool
    gain: torch.Tensor
    pitch: torch.Tensor
    position: torch.Tensor     # world
    radius: torch.Tensor       # reference distance
    max_distance: torch.Tensor
    rolloff: torch.Tensor


def init_sources(buffer_idx, positions, gain=1.0, pitch=1.0, looping=True,
                 radius=1.0, max_distance=25.0, rolloff=1.0,
                 device="cuda") -> SourceState:
    """S sources at the start of their buffers, playing, on the card
    unless `device` says otherwise."""
    device = resolve_device(device)
    s = len(buffer_idx)

    def full(v, dtype=torch.float32):
        return torch.full((s,), v, dtype=dtype, device=device)

    return SourceState(
        buffer=torch.as_tensor(np.asarray(buffer_idx, np.int32),
                               device=device),
        playhead=full(0.0), playing=full(True, torch.bool),
        looping=full(bool(looping), torch.bool), gain=full(gain),
        pitch=full(pitch),
        position=torch.as_tensor(np.asarray(positions, np.float32).reshape(
            s, 3), device=device),
        radius=full(radius), max_distance=full(max_distance),
        rolloff=full(rolloff))


def _distance_gain(dist, radius, max_d, rolloff, model):
    d = torch.minimum(torch.maximum(dist, radius), max_d)
    if model == DistanceModel.NONE:
        return torch.ones_like(dist)
    if model == DistanceModel.INVERSE:
        return radius / (radius + rolloff * (d - radius))
    if model == DistanceModel.LINEAR:
        return 1.0 - rolloff * (d - radius) / torch.clamp(max_d - radius,
                                                          min=1e-6)
    return (d / radius) ** (-rolloff)   # EXPONENT


def render_block(buffers: SoundBuffers, src: SourceState, listener_pos,
                 listener_right, block_len=513,
                 distance_model=DistanceModel.INVERSE):
    """Mix one stereo block [..., block_len, 2] and advance the playheads.

    src: [..., S] sources; listener_pos and listener_right (the listener's
    +X ear axis in world space) [..., 3] tensors (or triples, which every
    batch entry shares). Panning is constant power from the direction ·
    right projection, the gain the distance model's. Returns (block, src
    with advanced playheads)."""
    dev = src.playhead.device
    samples = const(buffers.samples, dev)
    lengths = const(buffers.lengths_f32(), dev)
    lmax = samples.shape[1]
    listener_pos, listener_right = (
        torch.as_tensor(v, dtype=torch.float32, device=dev)
        for v in (listener_pos, listener_right))

    to_src = src.position - listener_pos[..., None, :]
    dist = sqrt_rn(dot3(to_src, to_src))
    dirn = to_src / torch.clamp(dist[..., None], min=1e-6)
    pan = torch.clamp(dot3(dirn, listener_right[..., None, :]), -1.0, 1.0)
    ang = (pan + 1.0) * (np.pi / 4.0)
    gl, gr = torch.cos(ang), torch.sin(ang)                 # constant power
    dg = _distance_gain(dist, src.radius, src.max_distance, src.rolloff,
                        distance_model)
    amp = src.gain * dg * src.playing.to(torch.float32)

    # per-source sample positions of the block (linear pitch resampling)
    buf = src.buffer.long()
    t = torch.arange(block_len, dtype=torch.float32, device=dev)
    pos = src.playhead[..., None] + t * src.pitch[..., None]    # [...,S,B]
    length = lengths[buf][..., None]
    loop = src.looping[..., None]
    pos_wrapped = torch.where(loop, torch.remainder(pos, length),
                              torch.minimum(pos, length - 1.0))
    active = loop | (pos < length)
    i0 = torch.floor(pos_wrapped).to(torch.int32)
    frac = pos_wrapped - i0
    len_i = length.to(torch.int32)
    i1 = torch.where(loop, torch.remainder(i0 + 1, len_i),
                     torch.minimum(i0 + 1, len_i - 1))
    # rows of the flat [NB·Lmax] sample table (take_along_axis over the
    # source's buffer row)
    flat = samples.reshape(-1)
    row = buf[..., None] * lmax
    s0 = flat[row + i0]
    s1 = flat[row + i1]
    mono = (s0 + (s1 - s0) * frac) * active.to(torch.float32)  # [...,S,B]

    left = torch.sum(mono * (amp * gl)[..., None], dim=-2)
    right = torch.sum(mono * (amp * gr)[..., None], dim=-2)
    block = torch.stack([left, right], -1)

    new_head = src.playhead + block_len * src.pitch
    len_f = lengths[buf]
    new_head = torch.where(src.looping, torch.remainder(new_head, len_f),
                           new_head)
    still = src.playing & (src.looping | (new_head < len_f))
    return block, src._replace(playhead=new_head, playing=still)


def load_wav(path: str) -> np.ndarray:
    """Decode a PCM WAV file to mono float32 (decoder/ equivalent); host
    code on the standard library's ``wave``."""
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
        ch = w.getnchannels()
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(-1)
    return data
