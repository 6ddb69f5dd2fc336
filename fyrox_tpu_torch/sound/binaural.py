"""Binaural (HRTF-path) spatialisation, the port of
``fyrox_tpu/sound/binaural.py`` (the reference's HRTF renderer,
fyrox-sound context.rs:299-327: block convolution against an HRIR sphere,
HRTF_BLOCK_LEN = 513).

The same architecture, per-ear block filtering, with a parametric
spherical-head model where no measured sphere is given: a Woodworth
interaural delay as a windowed-sinc fractional delay, and a one-pole
low-pass on the shadowed ear whose strength grows as the source moves
behind the head. ``HrirSphere`` / ``sample_hrir`` take measured HRIRs
instead. Every function runs on the device of its tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from fyrox_tpu_torch._util import const

__all__ = ["spherical_head_hrir", "render_block_binaural", "HRTF_BLOCK_LEN",
           "HrirSphere", "sample_hrir"]

HRTF_BLOCK_LEN = 513          # context.rs:322
_HEAD_RADIUS = 0.0875         # metres
_SPEED_OF_SOUND = 343.0
_SR = 44_100.0


def spherical_head_hrir(azimuth, length=64):
    """Per-ear FIR approximations [..., 2, length] for sources at
    `azimuth` [...] (radians, 0 = front, +pi/2 = right)."""
    az = azimuth
    theta = torch.clamp(az, -np.pi, np.pi)
    at = torch.abs(theta)
    itd = (_HEAD_RADIUS / _SPEED_OF_SOUND) * (at + torch.sin(at))
    delay_far = itd * _SR                            # samples
    near_is_right = theta > 0
    t = torch.arange(length, dtype=torch.float32, device=az.device)

    def frac_delta(d):
        """windowed-sinc fractional delay FIR"""
        x = t[None] - 1.0 - d[..., None]
        s = torch.sinc(x)
        win = 0.5 * (1 + torch.cos(np.pi * torch.clamp(x / (length / 2),
                                                       -1, 1)))
        return s * win

    near = frac_delta(torch.zeros_like(delay_far))
    far = frac_delta(delay_far)
    # head shadow: a one-pole low-pass on the far ear, the identity at
    # theta = 0 so that centred sources stay symmetric
    alpha = torch.clamp(0.15 + 0.8 * (1 - at / np.pi), 0.05, 1.0)
    decay = (1 - alpha[..., None]) ** t[None]
    lp = alpha[..., None] * decay
    lp = lp / torch.clamp(torch.sum(lp, -1, keepdim=True), min=1e-8)
    strength = torch.sin(at / 2.0)[..., None]
    ident = torch.zeros_like(lp)
    ident[..., 0] = 1.0
    shadow = (1.0 - strength) * ident + strength * lp
    # the far-ear delta convolved with the shadow filter (short FFT)
    n = 2 * length
    far_f = torch.fft.rfft(far, n) * torch.fft.rfft(shadow, n)
    far = torch.fft.irfft(far_f, n)[..., :length]
    gain_far = 0.6 + 0.4 * torch.cos(at)              # mild ILD
    far_g = far * gain_far[..., None]
    nr = near_is_right[..., None]
    left = torch.where(nr, far_g, near)
    right = torch.where(nr, near, far_g)
    return torch.stack([left, right], -2)             # [..., 2, length]


class HrirSphere:
    """Measured HRIRs on a ring of azimuths (the reference loads .hrir
    spheres, context.rs:322); ``sample_hrir`` blends the two nearest
    measurements."""

    def __init__(self, azimuths, hrirs):
        """azimuths [M] radians (a full circle), hrirs [M,2,L]."""
        order = np.argsort(np.asarray(azimuths))
        self.azimuths = np.asarray(azimuths, np.float32)[order]
        self.hrirs = np.asarray(hrirs, np.float32)[order]

    @property
    def length(self):
        return self.hrirs.shape[-1]


def sample_hrir(sphere: HrirSphere, azimuths):
    """[S,2,L] HRIRs at azimuths [S]: the linear blend of the two nearest
    measured directions, wrapping around the circle."""
    dev = azimuths.device
    az_m = const(sphere.azimuths, dev)
    m = az_m.shape[0]
    two_pi = 2.0 * np.pi
    a = torch.remainder(azimuths, two_pi)
    idx = torch.sum((az_m[None, :] <= a[:, None]).to(torch.int32), 1) - 1
    # below the first measured azimuth: the last ↔ first arc
    below = idx < 0
    idx = torch.where(below, torch.full_like(idx, m - 1), idx)
    nxt = torch.remainder(idx + 1, m)
    a0 = torch.where(below, az_m[m - 1] - two_pi, az_m[idx.long()])
    a1 = torch.where(nxt == 0, az_m[0] + two_pi, az_m[nxt.long()])
    a1 = torch.where(below, az_m[0], a1)
    t = torch.clamp((a - a0) / torch.clamp(a1 - a0, min=1e-6), 0.0, 1.0)
    h = const(sphere.hrirs, dev)
    h0 = h[idx.long()]
    h1 = h[nxt.long()]
    return h0 * (1 - t[:, None, None]) + h1 * t[:, None, None]


def render_block_binaural(mono_blocks, azimuths, gains,
                          block_len=HRTF_BLOCK_LEN, hrir_len=64,
                          hrir_sphere: HrirSphere = None):
    """Binaural mix of S sources: mono_blocks [S, block_len], azimuths [S],
    gains [S] → stereo [block_len, 2] by FFT block convolution (the
    overlap tail is cut per block, as short HRIRs allow). `hrir_sphere`
    takes measured HRIRs in place of the spherical-head model."""
    if hrir_sphere is not None:
        hrirs = sample_hrir(hrir_sphere, azimuths)        # [S,2,L]
        hrir_len = hrir_sphere.length
    else:
        hrirs = spherical_head_hrir(azimuths, hrir_len)   # [S,2,L]
    n = int(2 ** np.ceil(np.log2(block_len + hrir_len)))
    src_f = torch.fft.rfft(mono_blocks, n)                # [S,F]
    hr_f = torch.fft.rfft(hrirs, n)                       # [S,2,F]
    out = torch.fft.irfft(src_f[:, None] * hr_f, n)[..., :block_len]
    out = torch.sum(out * gains[:, None, None], dim=0)    # [2,block]
    return out.T
