"""Post-processing: HDR tonemapping with auto-exposure, bloom, colour
grading and FXAA (the port of ``fyrox_tpu.render.post``).

Equivalent of the reference's post chain (renderer/hdr/mod.rs:86
luminance adaptation + tonemap, bloom/mod.rs:44, fxaa.rs:37). Every
function is image-space and batched over the leading axes of [..., H, W,
3] linear HDR colours.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["PostConfig", "tonemap_aces", "auto_exposure", "bloom", "fxaa",
           "color_grading", "identity_lut", "post_process"]


class PostConfig(NamedTuple):
    exposure: float = 1.0
    auto_exposure: bool = True
    adaptation_key: float = 0.18      # middle-grey key value
    bloom_threshold: float = 1.0
    bloom_strength: float = 0.35
    bloom_radius: int = 4
    use_fxaa: bool = True
    gamma: float = 2.2
    # colour grading LUT (camera.rs ColorGradingLut, the HDR mapper's
    # stage): an [N, N, N, 3] cube sampled trilinearly after tonemap and
    # gamma
    color_grading_lut: object = None
    color_grading_amount: float = 1.0


def identity_lut(n: int = 16) -> np.ndarray:
    """[N, N, N, 3] identity colour cube: lut[r, g, b] = (r, g, b) / (N -
    1) (numpy)."""
    ax = np.linspace(0.0, 1.0, n, dtype=np.float32)
    r, g, b = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.stack([r, g, b], -1)


def color_grading(ldr, lut, amount=1.0):
    """Trilinear 3D-LUT grade (``post.py:45``): ldr [..., 3] in [0, 1],
    lut [N, N, N, 3] (a tensor or a host array), blended by `amount`."""
    lut = torch.as_tensor(lut, dtype=torch.float32, device=ldr.device)
    n = lut.shape[0]
    flat = lut.reshape(-1, 3)
    p = torch.clamp(ldr, 0.0, 1.0) * (n - 1)
    i0 = torch.clamp(torch.floor(p).to(torch.int64), max=n - 2)
    f = p - i0

    def at(dr, dg, db):
        idx = ((i0[..., 0] + dr) * n + (i0[..., 1] + dg)) * n \
            + (i0[..., 2] + db)
        return flat[idx]

    fr, fg, fb = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    c00 = at(0, 0, 0) * (1 - fb) + at(0, 0, 1) * fb
    c01 = at(0, 1, 0) * (1 - fb) + at(0, 1, 1) * fb
    c10 = at(1, 0, 0) * (1 - fb) + at(1, 0, 1) * fb
    c11 = at(1, 1, 0) * (1 - fb) + at(1, 1, 1) * fb
    c0 = c00 * (1 - fg) + c01 * fg
    c1 = c10 * (1 - fg) + c11 * fg
    graded = c0 * (1 - fr) + c1 * fr
    return ldr + (graded - ldr) * amount


def _luminance(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def auto_exposure(color, key=0.18, eps=1e-4):
    """Log-average luminance exposure, [..., 1, 1] (``post.py:78``; the
    steady state of hdr/luminance/'s histogram adaptation)."""
    lum = _luminance(color)
    log_avg = torch.exp(torch.mean(torch.log(lum + eps), dim=(-2, -1),
                                   keepdim=True))
    return key / torch.clamp(log_avg, min=eps)


def tonemap_aces(color):
    """ACES filmic approximation (Narkowicz; ``post.py:87``)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((color * (a * color + b))
                       / (color * (c * color + d) + e), 0.0, 1.0)


def _blur_separable(img, radius):
    """Separable box blur of [..., H, W, C] with edge padding, by a
    cumulative sum along H then W (``post.py:95``; the bloom pyramid's
    stand-in)."""
    k = 2 * radius + 1

    def conv_axis(x, axis):
        n = x.shape[axis]
        src = torch.clamp(torch.arange(-radius, n + radius,
                                       device=x.device), 0, n - 1)
        cs = torch.cumsum(torch.index_select(x, axis, src), axis)
        lead = cs.narrow(axis, k - 1, n)
        lag = torch.cat([torch.zeros_like(cs.narrow(axis, 0, 1)),
                         cs.narrow(axis, 0, n - 1)], axis)
        return (lead - lag) / k

    return conv_axis(conv_axis(img, img.dim() - 3), img.dim() - 2)


def bloom(color, threshold=1.0, strength=0.35, radius=4):
    """Bright pass + blur + additive combine (bloom/mod.rs:44)."""
    lum = _luminance(color)[..., None]
    bright = torch.where(lum > threshold, color, torch.zeros_like(color))
    return color + strength * _blur_separable(bright, radius)


def fxaa(ldr):
    """Luma-based edge antialiasing (fxaa.rs:37, simplified;
    ``post.py:121``): where the local luma contrast is high, blend with
    the mean of four shifted copies. The copies shift the last two axes
    of each array, as the JAX function's rolls do: H and W of the luma,
    W and the channels of the colour."""
    lum = _luminance(ldr)

    def sh(a, dy, dx):
        return torch.roll(torch.roll(a, dy, dims=-2), dx, dims=-1)

    l_n, l_s = sh(lum, -1, 0), sh(lum, 1, 0)
    l_e, l_w = sh(lum, 0, 1), sh(lum, 0, -1)
    l_min = torch.minimum(lum, torch.minimum(torch.minimum(l_n, l_s),
                                             torch.minimum(l_e, l_w)))
    l_max = torch.maximum(lum, torch.maximum(torch.maximum(l_n, l_s),
                                             torch.maximum(l_e, l_w)))
    edge = (l_max - l_min) > torch.clamp(l_max * 0.125, min=0.0312)
    blur = 0.25 * (sh(ldr, -1, 0) + sh(ldr, 1, 0)
                   + sh(ldr, 0, 1) + sh(ldr, 0, -1))
    return torch.where(edge[..., None], 0.5 * (ldr + blur), ldr)


def post_process(color, config: PostConfig = PostConfig()):
    """The whole chain (``post.py:145``): exposure → bloom → tonemap →
    gamma → colour grading → FXAA. color [..., H, W, 3] linear HDR →
    LDR in [0, 1]."""
    exp = config.exposure
    if config.auto_exposure:
        exp = exp * auto_exposure(color, config.adaptation_key)[..., None]
    c = color * exp
    if config.bloom_strength > 0:
        c = bloom(c, config.bloom_threshold, config.bloom_strength,
                  config.bloom_radius)
    ldr = tonemap_aces(c) ** (1.0 / config.gamma)
    if config.color_grading_lut is not None:
        ldr = color_grading(ldr, config.color_grading_lut,
                            config.color_grading_amount)
    if config.use_fxaa:
        ldr = fxaa(ldr)
    return ldr
