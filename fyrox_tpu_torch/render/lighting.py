"""Deferred PBR lighting (the port's copy of ``fyrox_tpu.render.lighting``).

Equivalent of the reference's DeferredLightRenderer (fyrox-impl/src/
renderer/light.rs:254): every pixel shades every light with masked
contributions. BRDF: Lambert diffuse + Cook-Torrance GGX specular; point
and spot lights use a smooth distance falloff clamped at the light radius,
spot cones the hotspot / falloff angles of the reference's SpotLight.
Batched over worlds: the G-buffer is [W, H, Wd, ...].
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch._util import value_const

__all__ = ["LightSet", "shade", "POINT", "SPOT", "DIRECTIONAL"]

POINT, SPOT, DIRECTIONAL = 0, 1, 2


class LightSet(NamedTuple):
    """SoA lights: `kind` is host numpy (shade unrolls on it); the per-world
    parts lead with W, the template's parts do not."""
    kind: np.ndarray             # [L] int32
    position: torch.Tensor       # [W, L, 3] (ignored for directional)
    direction: torch.Tensor      # [W, L, 3] normalized
    color: torch.Tensor          # [L, 3]
    intensity: torch.Tensor      # [L]
    radius: torch.Tensor         # [L] effect radius (point / spot)
    cos_hotspot: torch.Tensor    # [L] inner cone cos (spot)
    cos_falloff: torch.Tensor    # [L] outer cone cos (spot)
    enabled: torch.Tensor        # [W, L] bool


def _norm(x):
    return torch.linalg.norm(x, dim=-1, keepdim=True)


def _ggx_brdf(n, v, l, albedo, metallic, roughness):
    """Cook-Torrance GGX (``lighting.py:40``)."""
    h = v + l
    h = h / torch.clamp(_norm(h), min=1e-8)
    nl = torch.clamp(torch.sum(n * l, -1), min=0.0)
    nv = torch.clamp(torch.sum(n * v, -1), min=1e-4)
    nh = torch.clamp(torch.sum(n * h, -1), min=0.0)
    vh = torch.clamp(torch.sum(v * h, -1), min=0.0)

    a = torch.clamp(roughness * roughness, min=1e-3)
    a2 = a * a
    d = a2 / torch.clamp(math.pi * (nh * nh * (a2 - 1.0) + 1.0) ** 2,
                         min=1e-8)
    k = (roughness + 1.0) ** 2 / 8.0
    g = (nl / torch.clamp(nl * (1 - k) + k, min=1e-8)) * \
        (nv / torch.clamp(nv * (1 - k) + k, min=1e-8))
    m = metallic[..., None]
    f0 = 0.04 * (1.0 - m) + albedo * m
    f = f0 + (1.0 - f0) * (1.0 - vh[..., None]) ** 5

    spec = (d * g)[..., None] * f / torch.clamp(4.0 * nl * nv,
                                                min=1e-8)[..., None]
    kd = (1.0 - f) * (1.0 - m)
    diffuse = kd * albedo / math.pi
    return (diffuse + spec) * nl[..., None]


def shade(gbuf, lights: LightSet, camera_pos, ambient=(0.03, 0.03, 0.03),
          shadow_fn=None):
    """Shade a G-buffer batch [W, H, Wd, ...] (``lighting.py:64``).
    camera_pos [W, 3]. shadow_fn: optional callable (light index, world
    positions [W, H, Wd, 3]) → [W, H, Wd] visibility in [0, 1], or None."""
    def px(x):                       # [W, ...] → [W, 1, 1, ...]
        return x[:, None, None]

    n = gbuf.normal
    n = n / torch.clamp(_norm(n), min=1e-8)
    p = gbuf.position
    v = px(camera_pos) - p
    v = v / torch.clamp(_norm(v), min=1e-8)
    albedo = gbuf.albedo
    metallic = gbuf.material[..., 0]
    roughness = gbuf.material[..., 1]

    color = value_const(tuple(ambient), p.device) * albedo + gbuf.emission
    ones = torch.ones(p.shape[:-1], dtype=torch.float32, device=p.device)
    for li in range(lights.kind.shape[0]):   # unrolled over the template's
        kind = int(lights.kind[li])
        lcol = lights.color[li] * lights.intensity[li]
        if kind == DIRECTIONAL:
            ldir = -lights.direction[:, li]
            ldir = ldir / torch.clamp(_norm(ldir), min=1e-8)
            l = torch.broadcast_to(px(ldir), p.shape)
            atten = ones
        else:
            to_l = px(lights.position[:, li]) - p
            dist = torch.linalg.norm(to_l, dim=-1)
            l = to_l / torch.clamp(dist[..., None], min=1e-8)
            r = torch.clamp(lights.radius[li], min=1e-4)
            window = torch.clamp(1.0 - (dist / r) ** 4, 0.0, 1.0) ** 2
            atten = window / (dist * dist + 1.0)
            if kind == SPOT:
                cd = torch.sum(-l * px(lights.direction[:, li]), -1)
                cone = torch.clamp(
                    (cd - lights.cos_falloff[li])
                    / torch.clamp(lights.cos_hotspot[li]
                                  - lights.cos_falloff[li], min=1e-5),
                    0.0, 1.0)
                atten = atten * cone
        vis = ones
        if shadow_fn is not None:
            sv = shadow_fn(li, p)
            if sv is not None:
                vis = sv
        brdf = _ggx_brdf(n, v, l, albedo, metallic, roughness)
        on = lights.enabled[:, li].to(torch.float32)[:, None, None]
        color = color + brdf * lcol * (atten * vis * on)[..., None]
    return torch.where(gbuf.mask[..., None], color, torch.zeros_like(color))
