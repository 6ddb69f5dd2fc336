"""Forward / transparent pass as weighted-blended OIT (the port's copy of
``fyrox_tpu.render.transparent``).

Equivalent of the reference's forward render path for transparent bundles
(fyrox-impl/src/renderer/mod.rs:1066-1115, RenderPath::Forward). No sort:
McGuire-Bavoil weighted-blended order-independent transparency. Every
transparent fragment accumulates premultiplied colour with a depth-falloff
weight and a multiplicative revealage; one composite resolves against the
opaque image. The JAX package computes this pass in XLA with no Pallas
kernel; here it is PyTorch over chunks of triangles against the whole
image, batched over worlds.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from fyrox_tpu_torch._util import value_const
from fyrox_tpu_torch.render import lighting as lm

__all__ = ["composite_transparent"]

CHUNK = 8   # transparent triangles a step: [W, CHUNK, H, Wd] temporaries


def _lit_color(albedo, normal, position, lights, cam_pos, ambient):
    """Reduced forward shading (Lambert + distance / spot attenuation) of
    [W, C, H, Wd, 3] fragments (``transparent.py:23``)."""
    col = albedo * value_const(tuple(ambient), albedo.device)
    if lights is None:
        return albedo

    def px(x):                     # [W, ...] → [W, 1, 1, 1, ...]
        return x[:, None, None, None]

    for li in range(lights.kind.shape[0]):
        kind = int(lights.kind[li])
        lcol = lights.color[li] * lights.intensity[li]
        if kind == lm.DIRECTIONAL:
            ldir = px(-lights.direction[:, li])
            att = 1.0
        else:
            to_l = px(lights.position[:, li]) - position
            dist = torch.linalg.norm(to_l, dim=-1, keepdim=True)
            ldir = to_l / torch.clamp(dist, min=1e-6)
            att = torch.clamp(1.0 - (dist[..., 0] / torch.clamp(
                lights.radius[li], min=1e-6)) ** 2, 0.0, 1.0) ** 2
            if kind == lm.SPOT:
                cd = torch.sum(-ldir * px(lights.direction[:, li]), -1)
                att = att * torch.clamp(
                    (cd - lights.cos_falloff[li])
                    / torch.clamp(lights.cos_hotspot[li]
                                  - lights.cos_falloff[li], min=1e-6),
                    0.0, 1.0)
        ndl = torch.clamp(torch.sum(normal * ldir, -1), 0.0, 1.0)
        en = lights.enabled[:, li].to(torch.float32)[:, None, None, None]
        col = col + albedo * lcol * (ndl * att * en)[..., None] / math.pi
    return col


def composite_transparent(opaque_color, opaque_depth, opaque_mask,
                          tri_clip, tri_attrs: Dict[str, torch.Tensor],
                          tri_alpha, height, width, lights=None,
                          cam_pos=None, ambient=(0.03, 0.03, 0.03),
                          tri_valid=None):
    """Rasterize transparent triangles over the shaded opaque image
    (``transparent.py:57``).

    opaque_* [W, H, Wd, ...]; tri_clip [W, Tt, 3, 4]; tri_attrs albedo /
    normal / position [W, Tt, 3, 3] (or [Tt, 3, 3]); tri_alpha [Tt];
    tri_valid [W, Tt]; cam_pos [W, 3]. Returns the composited [W, H, Wd,
    3] colour."""
    nw, t_total = tri_clip.shape[:2]
    if t_total == 0:
        return opaque_color
    dev = tri_clip.device
    if tri_valid is None:
        tri_valid = torch.ones((nw, t_total), dtype=torch.bool, device=dev)
    packed = torch.cat([tri_attrs[k].expand(nw, t_total, 3, 3)
                        for k in ("albedo", "normal", "position")], -1)
    px = (torch.arange(width, dtype=torch.float32, device=dev)
          + 0.5)[None, None, None, :]
    py = (torch.arange(height, dtype=torch.float32, device=dev)
          + 0.5)[None, None, :, None]
    acc_rgb = torch.zeros((nw, height, width, 3), dtype=torch.float32,
                          device=dev)
    acc_w = torch.zeros((nw, height, width), dtype=torch.float32, device=dev)
    reveal = torch.ones((nw, height, width), dtype=torch.float32, device=dev)
    o_depth, o_mask = opaque_depth[:, None], opaque_mask[:, None]
    for c0 in range(0, t_total, CHUNK):
        clip = tri_clip[:, c0:c0 + CHUNK]
        attrs = packed[:, c0:c0 + CHUNK]
        alpha = tri_alpha[c0:c0 + CHUNK]
        valid = tri_valid[:, c0:c0 + CHUNK]
        w_clip = clip[..., 3]
        behind = w_clip <= 1e-6
        safe_w = torch.where(behind, torch.ones_like(w_clip), w_clip)
        ndc = clip[..., :3] / safe_w[..., None]
        sx = (ndc[..., 0] * 0.5 + 0.5) * width
        sy = (0.5 - ndc[..., 1] * 0.5) * height
        sz = ndc[..., 2]
        x0, x1, x2 = (sx[..., i, None, None] for i in range(3))
        y0, y1, y2 = (sy[..., i, None, None] for i in range(3))
        area = (sx[..., 1] - sx[..., 0]) * (sy[..., 2] - sy[..., 0]) \
            - (sx[..., 2] - sx[..., 0]) * (sy[..., 1] - sy[..., 0])
        # both windings: a glass pane is seen from either side
        ok = valid & (torch.abs(area) > 1e-9) & ~torch.any(behind, -1)
        inv_area = (1.0 / torch.where(torch.abs(area) < 1e-9,
                                      torch.ones_like(area), area)
                    )[..., None, None]

        def edge(xa, ya, xb, yb):
            return (px - xa) * (yb - ya) - (py - ya) * (xb - xa)

        b0 = edge(x1, y1, x2, y2) * inv_area              # [W, C, H, Wd]
        b1 = edge(x2, y2, x0, y0) * inv_area
        b2 = 1.0 - b0 - b1
        thr = -1e-5   # keeps shared edges watertight
        inside = ((b0 >= thr) & (b1 >= thr) & (b2 >= thr)
                  & ok[..., None, None])
        z = (b0 * sz[..., 0, None, None] + b1 * sz[..., 1, None, None]
             + b2 * sz[..., 2, None, None])
        vis = inside & ((z < o_depth) | ~o_mask)           # test, no write
        iw = 1.0 / safe_w
        bw0 = b0 * iw[..., 0, None, None]
        bw1 = b1 * iw[..., 1, None, None]
        bw2 = b2 * iw[..., 2, None, None]
        bws = torch.clamp(bw0 + bw1 + bw2, min=1e-12)
        at = (bw0[..., None] * attrs[:, :, None, None, 0]
              + bw1[..., None] * attrs[:, :, None, None, 1]
              + bw2[..., None] * attrs[:, :, None, None, 2]) / bws[..., None]
        albedo, normal, position = at[..., :3], at[..., 3:6], at[..., 6:9]
        nrm = normal / torch.clamp(torch.linalg.norm(normal, dim=-1,
                                                     keepdim=True), min=1e-8)
        rgb = _lit_color(albedo, nrm, position, lights, cam_pos, ambient)
        a = alpha[None, :, None, None] * vis.to(torch.float32)
        # nearer fragments (smaller NDC z) weigh more
        wgt = a * torch.clamp(1.0 - z * 0.5 - 0.5, 0.05, 1.0) * 8.0
        acc_rgb = acc_rgb + torch.sum(wgt[..., None] * rgb * a[..., None], 1)
        acc_w = acc_w + torch.sum(wgt, 1)
        reveal = reveal * torch.prod(1.0 - a, 1)
    avg = acc_rgb / torch.clamp(acc_w, min=1e-6)[..., None]
    return (opaque_color * reveal[..., None]
            + avg * (1.0 - reveal[..., None]))
