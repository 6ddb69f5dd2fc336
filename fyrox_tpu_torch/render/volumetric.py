"""Volumetric light scattering, light shafts (the port's copy of
``fyrox_tpu.render.volumetric``).

Equivalent of the reference's light-volume pass (fyrox-impl/src/renderer/
light_volume.rs), in the screen-space radial-blur formulation (Mitchell's
"god rays"): the uncovered pixels emit, N nearest taps along each pixel's
ray to the light's screen position accumulate with exponential decay, and
the sum is added to the lit image. Batched over worlds.
"""
from __future__ import annotations

import torch

__all__ = ["light_shafts"]


def light_shafts(color, gbuf_mask, light_clip, light_color, n_samples=24,
                 density=0.9, decay=0.95, weight=0.04, exposure=1.0):
    """Additive screen-space light shafts for one light
    (``volumetric.py:20``).

    color [W, H, Wd, 3]; gbuf_mask [W, H, Wd] (True where geometry
    occludes); light_clip [W, 4] the light's clip-space position;
    light_color [3]. Returns color + shafts."""
    nw, h, w = gbuf_mask.shape
    dev = color.device
    lw = light_clip[:, 3]
    behind = lw <= 1e-6
    ndc = light_clip[:, :3] / torch.where(behind, torch.ones_like(lw),
                                          lw)[:, None]
    lx = ((ndc[:, 0] * 0.5 + 0.5) * w)[:, None, None]
    ly = ((0.5 - ndc[:, 1] * 0.5) * h)[:, None, None]
    px = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, None]
    py = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[None, :,
                                                                  None]
    emissive = (~gbuf_mask).to(torch.float32).reshape(nw, h * w)
    dx = (lx - px) / n_samples * density
    dy = (ly - py) / n_samples * density
    acc = torch.zeros((nw, h, w), dtype=torch.float32, device=dev)
    dec = torch.ones((), dtype=torch.float32, device=dev)
    for i in range(n_samples):
        sx = px + dx * float(i)
        sy = py + dy * float(i)
        x0 = torch.clamp(sx.to(torch.int32), 0, w - 1)
        y0 = torch.clamp(sy.to(torch.int32), 0, h - 1)
        s = torch.gather(emissive, 1, (y0 * w + x0).reshape(nw, -1).long())
        acc = acc + s.reshape(nw, h, w) * dec * weight
        dec = dec * decay
    shaft = acc * exposure * (~behind).to(torch.float32)[:, None, None]
    return color + shaft[..., None] * light_color
