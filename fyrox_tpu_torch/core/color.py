"""Colours and gradients, the port of ``fyrox_tpu/core/color.py``
(fyrox-core color.rs: RGBA and HSV conversions; color_gradient.rs: the
piecewise-linear gradients particle systems sample).

Colours are float32 tensors [..., 4] in linear space, 0..1; every function
runs on the device of the tensor it is given. A gradient is host data
(numpy) that ``sample_gradient`` copies to the sample's device once.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch._util import const, resolve_device

__all__ = ["from_rgba8", "to_rgba8", "hsv_to_rgb", "rgb_to_hsv",
           "ColorGradient", "sample_gradient", "srgb_to_linear",
           "linear_to_srgb"]


def from_rgba8(r, g, b, a=255, device="cuda"):
    """8-bit channels → a float32 colour [4] on `device` (the card unless
    the caller asks for another)."""
    return torch.tensor([r, g, b, a], dtype=torch.float32,
                        device=resolve_device(device)) / 255.0


def to_rgba8(c):
    """Colour [..., 4] → uint8 channels (round half to even, clamped)."""
    return torch.clamp(torch.round(c * 255.0), 0, 255).to(torch.uint8)


def srgb_to_linear(c):
    return torch.where(c <= 0.04045, c / 12.92,
                       ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.clamp(c, min=1e-8) ** (1 / 2.4) - 0.055)


def hsv_to_rgb(h, s, v):
    """h in degrees (any value; taken mod 360), s and v in [0, 1], tensors
    of one shape → rgb [..., 3]."""
    h = torch.remainder(h, 360.0) / 60.0
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.to(torch.int32)

    def select(choices, default):
        out = default
        for k in range(4, -1, -1):          # the first true case wins
            out = torch.where(i == k, choices[k], out)
        return out

    r = select([v, q, p, p, t], v)
    g = select([t, v, v, q, p], p)
    b = select([p, p, t, v, v], q)
    return torch.stack([r, g, b], -1)


def rgb_to_hsv(rgb):
    """rgb [..., 3] → hsv [..., 3] (h in degrees)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.amax(rgb, -1)
    mn = torch.amin(rgb, -1)
    d = mx - mn
    safe_d = torch.where(d == 0, torch.ones_like(d), d)
    h = torch.where(mx == r, torch.remainder((g - b) / safe_d, 6.0),
                    torch.where(mx == g, (b - r) / safe_d + 2.0,
                                (r - g) / safe_d + 4.0)) * 60.0
    h = torch.where(d == 0, torch.zeros_like(h), h)
    s = torch.where(mx == 0, torch.zeros_like(mx),
                    d / torch.where(mx == 0, torch.ones_like(mx), mx))
    return torch.stack([h, s, mx], -1)


class ColorGradient(NamedTuple):
    """Sorted gradient points (color_gradient.rs:299), host arrays."""
    locations: np.ndarray    # [K] float32
    colors: np.ndarray       # [K,4] float32

    @staticmethod
    def pack(points):
        """points: list of (t, (r, g, b, a))."""
        pts = sorted(points, key=lambda p: p[0])
        return ColorGradient(
            locations=np.asarray([p[0] for p in pts], np.float32),
            colors=np.asarray([p[1] for p in pts], np.float32))


def sample_gradient(g: ColorGradient, t):
    """Piecewise-linear sample at t (a float32 tensor of any shape),
    clamped at the ends → [..., 4] on t's device."""
    loc = const(g.locations, t.device)
    col = const(g.colors, t.device)
    k = loc.shape[0]
    right = torch.clamp(torch.searchsorted(loc, t.reshape(-1), right=True),
                        1, k - 1).reshape(t.shape)
    left = right - 1
    t0, t1 = loc[left], loc[right]
    f = torch.clamp((t - t0) / torch.clamp(t1 - t0, min=1e-8), 0.0, 1.0)
    c = col[left] + (col[right] - col[left]) * f[..., None]
    c = torch.where((t <= loc[0])[..., None], col[0], c)
    return torch.where((t >= loc[-1])[..., None], col[-1], c)
