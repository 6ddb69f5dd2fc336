"""Reflection probes: a six-face capture, its diffuse irradiance and its
specular prefilter (the port of ``fyrox_tpu.render.probe``).

Equivalent of the reference's ReflectionProbe node and its renderer
support (fyrox-impl/src/scene/probe.rs:135; the specular and diffuse
convolutions of renderer convolution.rs):

  * ``capture_probe`` renders the albedo + emission of a world's triangles
    from the probe's position into six faces, unlit, through the
    streaming rasterizer (``raster.rasterize``, no back-face cull);
  * ``face_irradiance`` reduces each face to one RGB value and
    ``apply_probe_ambient`` adds albedo · Σ_f irr[f] · max(0, n · d_f);
  * ``prefilter_specular`` convolves the faces with a normalized
    cosine-power lobe per roughness level (one [O, I] x [I, 3] product a
    level) and ``apply_probe_specular`` samples the two levels that
    bracket each pixel's roughness, with Fresnel-Schlick.

The cube lookup and the texel directions are ``render.skybox``'s.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from fyrox_tpu_torch._util import const, value_const
from fyrox_tpu_torch.core import transform as tfm
from fyrox_tpu_torch.render import raster as raster_mod
from fyrox_tpu_torch.render import shadows as shadows_mod
from fyrox_tpu_torch.render.skybox import face_texel_dirs
from fyrox_tpu_torch.render.skybox import sample_cube as _sample_cube

__all__ = ["capture_probe", "face_irradiance", "apply_probe_ambient",
           "prefilter_specular", "apply_probe_specular", "face_texel_dirs",
           "FACE_DIRS"]

FACE_DIRS = np.asarray([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                        [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float32)


@functools.lru_cache(maxsize=None)
def _texel_dirs(size):
    """face_texel_dirs(size) flattened to [6 S², 3], one host array per
    size (so that its device copy is made once)."""
    d = face_texel_dirs(size).reshape(-1, 3)
    d.flags.writeable = False
    return d


def capture_probe(world_tri_positions, tri_attrs, position, face_size=32,
                  tri_valid=None, chunk=64, z_far=200.0):
    """[6, S, S, 3] colour faces captured from `position` [3]
    (``probe.py:32``): world_tri_positions [T, 3, 3] of one world,
    tri_attrs as ``raster.rasterize`` takes them (albedo and emission
    carry the capture colour), tri_valid [T]. The six faces rasterize as
    one batch of images."""
    vps = shadows_mod.point_vps(position, z_far=z_far)          # [6, 4, 4]
    clip = raster_mod.transform_clip(world_tri_positions.reshape(1, -1, 3),
                                     vps).reshape(6, -1, 3, 4)
    valid = None if tri_valid is None else tri_valid[None].expand(6, -1)
    g = raster_mod.rasterize(clip, tri_attrs, face_size, face_size,
                             tri_valid=valid, chunk=chunk,
                             backface_cull=False)
    return (g.albedo + g.emission) * g.mask[..., None]


def face_irradiance(faces):
    """[..., 6, 3] mean RGB of each face (the cosine-lobe diffuse
    basis; ``probe.py:50``)."""
    return torch.mean(faces, dim=(-3, -2))


def _probe_box(term, position, probe_inv):
    """term kept only where `position` lies in the probe's unit box (the
    reference's probe bounding volume); probe_inv [4, 4] broadcasts."""
    if probe_inv is None:
        return term
    pl = tfm.transform_point(probe_inv, position)
    return term * torch.all(torch.abs(pl) <= 0.5, -1)[..., None]


def apply_probe_ambient(color, gbuf, irradiance, strength=1.0,
                        bounds=None, probe_inv=None):
    """Diffuse IBL (``probe.py:55``): color += albedo · Σ_f irr[f] ·
    max(0, n · d_f) · strength / 3 on covered pixels; with probe_inv only
    inside the probe's box. color and gbuf [..., H, W, ...]; irradiance
    [6, 3]. `bounds` is unused, as in the JAX package."""
    dev = color.device
    n = gbuf.normal
    dirs = const(FACE_DIRS, dev)
    irr = torch.as_tensor(irradiance, dtype=torch.float32, device=dev)
    acc = torch.zeros_like(color)
    for f in range(6):
        ndl = torch.clamp(torch.sum(n * dirs[f], -1), 0.0, 1.0)
        acc = acc + irr[f] * ndl[..., None]
    term = gbuf.albedo * acc * (strength / 3.0) * gbuf.mask[..., None]
    return color + _probe_box(term, gbuf.position, probe_inv)


def prefilter_specular(faces, roughness_levels=(0.1, 0.3, 0.6, 1.0),
                       out_size=8):
    """faces [6, S, S, 3] → [R, 6, out_size, out_size, 3]
    (``probe.py:115``): level r is out[d] = Σ_s env[s] · max(0, d · s)^α /
    Σ_s max(0, d · s)^α with α = 2 / r⁴ - 2, capped where the capture's
    resolution ends (~8 texels a lobe)."""
    s_in = faces.shape[1]
    dev = faces.device
    din = const(_texel_dirs(s_in), dev)                       # [I, 3]
    dout = const(_texel_dirs(out_size), dev)                  # [O, 3]
    env = faces.reshape(-1, 3)
    cos = torch.clamp(dout @ din.T, 0.0, 1.0)                 # [O, I]
    alpha_max = 2.0 * (3.0 * s_in) ** 2 / np.pi ** 2
    levels = []
    for r in roughness_levels:
        alpha = 2.0 / max(float(r), 1e-3) ** 4 - 2.0
        alpha = min(max(alpha, 0.0), alpha_max)
        if alpha > 0:
            w = torch.exp(float(np.float32(alpha))
                          * torch.log(torch.clamp(cos, min=1e-6)))
        else:
            w = torch.ones_like(cos)
        w = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-8)
        levels.append((w @ env).reshape(6, out_size, out_size, 3))
    return torch.stack(levels, 0)


def _pow5(x):
    """x⁵ as XLA's integer power computes it: x · (x²)²."""
    x2 = x * x
    return x * (x2 * x2)


def apply_probe_specular(color, gbuf, cam_pos, prefiltered,
                         roughness_levels=(0.1, 0.3, 0.6, 1.0),
                         strength=1.0, probe_inv=None):
    """Specular IBL (``probe.py:171``): color += F(n · v) · env(reflect(v,
    n), roughness), env lerped between the two prefiltered levels that
    bracket the pixel's roughness; Fresnel-Schlick with F0 = mix(0.04,
    albedo, metallic). color and gbuf [..., H, W, ...], cam_pos [..., 3]
    (one per leading index), prefiltered [R, 6, S, S, 3]."""
    dev = color.device
    n = gbuf.normal
    v = cam_pos[..., None, None, :] - gbuf.position
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                        min=1e-8)
    refl = 2.0 * torch.sum(n * v, -1, keepdim=True) * n - v
    rough = gbuf.material[..., 1]
    metal = gbuf.material[..., 0]
    samples = torch.stack([_sample_cube(prefiltered[i], refl)
                           for i in range(prefiltered.shape[0])], 0)
    lv = value_const(tuple(float(r) for r in roughness_levels), dev)
    idx = torch.clamp(torch.searchsorted(lv, rough.contiguous()) - 1, 0,
                      lv.shape[0] - 2)
    r0, r1 = lv[idx], lv[idx + 1]
    t = torch.clamp((rough - r0) / torch.clamp(r1 - r0, min=1e-6), 0.0, 1.0)
    pick = idx[None, ..., None].expand((1,) + samples.shape[1:])
    s0 = torch.gather(samples, 0, pick)[0]
    s1 = torch.gather(samples, 0, pick + 1)[0]
    env = s0 * (1 - t[..., None]) + s1 * t[..., None]
    ndv = torch.clamp(torch.sum(n * v, -1), 0.0, 1.0)
    f0 = 0.04 * (1 - metal[..., None]) + gbuf.albedo * metal[..., None]
    fres = f0 + (1.0 - f0) * _pow5(1.0 - ndv[..., None])
    term = env * fres * strength * gbuf.mask[..., None]
    return color + _probe_box(term, gbuf.position, probe_inv)
