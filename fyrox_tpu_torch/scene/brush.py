"""Terrain brush editing, the port of ``fyrox_tpu/scene/brush.py`` (the
reference's brushstroke system, fyrox-impl scene/terrain/brushstroke/
mod.rs: BrushShape :695, BrushMode :735, BrushTarget :768, Brush :782 with
hardness, alpha and a 2x2 transform; a stroke keeps each texel's largest
opacity).

A stroke is a set of stamp centres; a texel's opacity is the largest over
the stamps of the shape's falloff, and each mode is one blend over the
whole grid: no scatter and no host loop over texels. Every function runs
on the device of the array it is given (``stroke_opacity`` on the card
unless the caller asks for another).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from fyrox_tpu_torch._util import resolve_device, sqrt_rn, value_const

__all__ = ["Brush", "stroke_opacity", "apply_stroke"]


@dataclass
class Brush:
    """Brush state (brushstroke/mod.rs:782).

    shape: "circle" (radius) or "rect" (width, length)
    mode:  "raise" (amount) | "flatten" | "assign" (value)
           | "smooth" (kernel_radius)
    target: "height" | "layer" | "hole": which array the caller passes to
           apply_stroke; the arithmetic does not depend on it.
    hardness: 0 fades from the centre, 1 is a hard edge. alpha: the
    stroke's opacity. transform: a 2x2 matrix warping the footprint."""
    shape: str = "circle"
    radius: float = 1.0
    width: float = 1.0
    length: float = 1.0
    mode: str = "raise"
    amount: float = 1.0
    value: float = 0.0
    kernel_radius: int = 1
    target: str = "height"
    hardness: float = 0.0
    alpha: float = 1.0
    transform: Tuple[Tuple[float, float], Tuple[float, float]] = \
        ((1.0, 0.0), (0.0, 1.0))


def _texel_grid(shape, cell_size, origin, device):
    h, w = shape
    xs = (torch.arange(w, dtype=torch.float32, device=device) * cell_size
          + origin[0])
    zs = (torch.arange(h, dtype=torch.float32, device=device) * cell_size
          + origin[1])
    return torch.meshgrid(xs, zs, indexing="xy")          # [H,W] each


def stroke_opacity(grid_shape, brush: Brush, points, cell_size=1.0,
                   origin=(0.0, 0.0), device="cuda"):
    """Per-texel stroke opacity [H,W] in [0, 1] on `device`.

    points: [P,2] world-space stamp centres (a stroke's sampled path). The
    opacity is the largest over the stamps (StrokeData keeps the max
    alpha), scaled by brush.alpha, with the hardness-controlled edge."""
    device = resolve_device(device)
    px, pz = _texel_grid(grid_shape, cell_size, origin, device)
    pts = torch.as_tensor(np.asarray(points, np.float32).reshape(-1, 2),
                          device=device)
    inv = np.linalg.inv(np.asarray(brush.transform, np.float32)).astype(
        np.float32)
    dx = px[None] - pts[:, 0, None, None]          # [P,H,W]
    dz = pz[None] - pts[:, 1, None, None]
    wx = float(inv[0, 0]) * dx + float(inv[0, 1]) * dz
    wz = float(inv[1, 0]) * dx + float(inv[1, 1]) * dz

    def over(x, v):        # a division by a tensor is IEEE on both devices
        return x / value_const(float(v), device)

    if brush.shape == "circle":
        d = over(sqrt_rn(wx * wx + wz * wz), max(brush.radius, 1e-6))
    elif brush.shape == "rect":
        d = torch.maximum(over(torch.abs(wx), max(brush.width * 0.5, 1e-6)),
                          over(torch.abs(wz), max(brush.length * 0.5, 1e-6)))
    else:
        raise ValueError(f"unknown brush shape {brush.shape!r}")
    soft = max(1.0 - float(brush.hardness), 1e-6)
    fall = torch.clamp(over(1.0 - d, soft), 0.0, 1.0)
    return torch.amax(fall, dim=0) * brush.alpha


def _box_blur(data, r):
    """Mean over the (2r+1)² neighbourhood by two separable passes of
    shifted adds (BrushMode::Smooth kernel_radius), wrapping at the
    borders."""
    if r <= 0:
        return data
    out = data
    for axis in (0, 1):
        acc = torch.zeros_like(out)
        for s in range(-r, r + 1):
            acc = acc + torch.roll(out, s, dims=axis)
        out = acc / (2 * r + 1)
    return out


def apply_stroke(data, brush: Brush, points, cell_size=1.0,
                 origin=(0.0, 0.0), flatten_value=None):
    """One brush stroke on a [H,W] float32 tensor (a height map, layer mask
    or hole mask per brush.target); returns the updated array on its
    device.

    flatten_value: Flatten's level; by default the data value at the first
    stamp centre (the reference flattens to the height sampled at the
    stroke's start)."""
    data = data.to(torch.float32)
    w = stroke_opacity(tuple(data.shape), brush, points, cell_size, origin,
                       device=data.device)
    if brush.mode == "raise":
        return data + w * brush.amount
    if brush.mode == "assign":
        return data * (1 - w) + brush.value * w
    if brush.mode == "flatten":
        if flatten_value is None:
            # the stamp's texel, in float32 as the JAX package computes it
            p0 = np.asarray(points, np.float32).reshape(-1, 2)[0]
            cs = np.float32(cell_size)
            i = int(np.clip(int((p0[1] - np.float32(origin[1])) / cs), 0,
                            data.shape[0] - 1))
            j = int(np.clip(int((p0[0] - np.float32(origin[0])) / cs), 0,
                            data.shape[1] - 1))
            flatten_value = data[i, j]
        return data * (1 - w) + flatten_value * w
    if brush.mode == "smooth":
        sm = _box_blur(data, int(brush.kernel_radius))
        return data * (1 - w) + sm * w
    raise ValueError(f"unknown brush mode {brush.mode!r}")
