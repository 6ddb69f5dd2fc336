"""Screen-space ambient occlusion (the port of ``fyrox_tpu.render.ssao``).

Equivalent of the reference's ScreenSpaceAmbientOcclusionRenderer
(fyrox-impl/src/renderer/ssao/, wired at renderer/mod.rs:203): hemisphere
samples against the G-buffer, in world space from its position and normal
channels. For each pixel, points of the normal-oriented hemisphere are
projected to the screen and counted as occluded where the stored surface
there lies nearer the camera. Batched over a leading world axis.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch._util import const, value_const
from fyrox_tpu_torch.render.tile_raster import _cross

__all__ = ["SsaoConfig", "compute_ssao"]


class SsaoConfig(NamedTuple):
    num_samples: int = 8
    radius: float = 0.5
    bias: float = 0.02
    power: float = 1.5
    seed: int = 0


@functools.lru_cache(maxsize=None)
def _hemisphere_kernel(n, seed):
    """[n, 3] sample offsets in tangent space (z up), denser near the
    centre as the reference's kernel (``ssao.py:28``; numpy, the JAX
    package's draws from the same seed)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v[:, 2] = np.abs(v[:, 2])
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    scale = (0.3 + 0.7 * (np.arange(n) / max(n - 1, 1)) ** 2)
    out = (v * scale[:, None]).astype(np.float32)
    out.flags.writeable = False
    return out


def compute_ssao(gbuf, view_proj, cam_pos, config: SsaoConfig = SsaoConfig()):
    """AO factor [..., H, W] in [0, 1] (1 = unoccluded; ``ssao.py:39``).

    gbuf [..., H, W, ...] (position, normal, mask), view_proj [..., 4, 4]
    and cam_pos [..., 3], one per leading index (none for one image).
    Depths compare in world units along the camera rays: NDC depth is
    too nonlinear for a fixed bias."""
    h, w = gbuf.depth.shape[-2:]
    dev = gbuf.depth.device
    pos, nrm = gbuf.position, gbuf.normal
    lead = pos.shape[:-3]
    up = torch.where(torch.abs(nrm[..., 1:2]) < 0.9,
                     value_const((0.0, 1.0, 0.0), dev),
                     value_const((1.0, 0.0, 0.0), dev))
    t1 = _cross(up, nrm)
    t1 = t1 / torch.clamp(torch.linalg.norm(t1, dim=-1, keepdim=True),
                          min=1e-8)
    t2 = _cross(nrm, t1)
    kernel = const(_hemisphere_kernel(config.num_samples, config.seed), dev)
    vp = view_proj[..., None, None, :, :]
    cam = cam_pos[..., None, None, :]
    flat_pos = pos.reshape(-1, h * w, 3)
    flat_hit = gbuf.mask.reshape(-1, h * w)
    occluded = torch.zeros(pos.shape[:-1], dtype=torch.float32, device=dev)
    valid = torch.zeros_like(occluded)
    for k in range(config.num_samples):
        offs = (kernel[k, 0] * t1 + kernel[k, 1] * t2
                + kernel[k, 2] * nrm) * config.radius
        sample = pos + offs
        ph = torch.cat([sample, torch.ones_like(sample[..., :1])], -1)
        c = torch.sum(vp * ph[..., None, :], -1)
        wc = torch.clamp(torch.abs(c[..., 3:4]), min=1e-6) \
            * torch.sign(c[..., 3:4])
        ndc = c[..., :3] / wc
        u = (ndc[..., 0] * 0.5 + 0.5) * w
        v = (0.5 - ndc[..., 1] * 0.5) * h
        inside = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (c[..., 3] > 0)
        ui = torch.clamp(u.to(torch.int32), 0, w - 1)
        vi = torch.clamp(v.to(torch.int32), 0, h - 1)
        at = (vi * w + ui).long().reshape(-1, h * w)
        stored_pos = torch.gather(flat_pos, 1, at[..., None].expand(
            -1, -1, 3)).reshape(pos.shape)
        stored_hit = torch.gather(flat_hit, 1, at).reshape(lead + (h, w))
        d_sample = torch.linalg.norm(sample - cam, dim=-1)
        d_stored = torch.linalg.norm(stored_pos - cam, dim=-1)
        closer = stored_hit & (d_stored < d_sample - config.bias)
        in_range = (torch.linalg.norm(stored_pos - pos, dim=-1)
                    < config.radius * 2.0)
        occluded = occluded + (closer & in_range & inside).to(torch.float32)
        valid = valid + inside.to(torch.float32)
    ao = 1.0 - occluded / torch.clamp(valid, min=1.0)
    ao = torch.clamp(ao, 0.0, 1.0) ** config.power
    return torch.where(gbuf.mask, ao, torch.ones_like(ao))
