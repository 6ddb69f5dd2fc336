"""G-buffer record, clip transform, near clipping and the streaming
rasterizer (the port of ``fyrox_tpu.render.raster``).

Conventions: clip space from the nalgebra-style projection (RH, NDC z in
[-1, 1], y up); the viewport maps NDC to pixel centres with y flipped;
front faces are counter-clockwise, as in GL. ``render_frame`` rasterizes
through ``render.tile_raster`` (K5), whose clipped mode takes
``clip_near``; ``rasterize`` is the streaming z-buffer without binning,
which the reflection probes (``render.probe``) and callers take.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["GBuffer", "transform_clip", "clip_near", "rasterize"]

_BIG = 1e9


class GBuffer(NamedTuple):
    """Per-pixel outputs (gbuffer.rs:23-27 MRT set, with the world
    position kept instead of reconstructed from depth)."""
    depth: torch.Tensor      # [..., H, W] NDC z, 1e9 where empty
    albedo: torch.Tensor     # [..., H, W, 3]
    normal: torch.Tensor     # [..., H, W, 3] world space
    position: torch.Tensor   # [..., H, W, 3] world space
    material: torch.Tensor   # [..., H, W, 2] metallic, roughness
    emission: torch.Tensor   # [..., H, W, 3]
    mask: torch.Tensor       # [..., H, W] bool coverage
    # interpolated (u, v, albedo layer, mr layer) where the scene binds
    # material textures; None in untextured scenes
    uvt: object = None       # [..., H, W, 4] or None


def transform_clip(positions, mvp):
    """positions [..., V, 3] by mvp [..., 4, 4] → clip [..., V, 4]."""
    p = torch.cat([positions, torch.ones_like(positions[..., :1])], -1)
    return torch.sum(mvp[..., None, :, :] * p[..., :, None, :], -1)


def clip_near(tri_clip, tri_attrs, tri_valid, eps=1e-4):
    """Branch-free Sutherland-Hodgman clip against the w = eps plane
    (``raster.py:52``), batched over leading axes.

    tri_clip [B, T, 3, 4], tri_attrs name → [B, T, 3, C] (or [T, 3, C]),
    tri_valid [B, T] → the fixed 2x expansion ([B, 2T, 3, 4], attrs [B,
    2T, 3, C], valid [B, 2T]): row t is the first triangle of t (all of it
    where it lies in front, its clipped part where one vertex does), row
    T + t the second, used only where two vertices lie in front.
    Attributes are lerped at the intersections with the vertices."""
    b, t = tri_clip.shape[:2]
    d = tri_clip[..., 3] - eps                               # [B, T, 3]
    inside = d >= 0.0
    n_in = inside.to(torch.int32).sum(-1)
    # rotate so that the unique vertex sits at slot 0: the single inside
    # vertex where n_in == 1, the single outside one where n_in == 2
    first_in = torch.argmax(inside.to(torch.int32), -1)
    first_out = torch.argmax((~inside).to(torch.int32), -1)
    uniq = torch.where(n_in == 1, first_in, first_out)
    order = (uniq[..., None] + torch.arange(3, device=d.device)) % 3

    def rot(x):
        if x.dim() == 3:                     # a static [T, 3, C] attribute
            x = x.expand(b, *x.shape)
        idx = order.reshape(order.shape + (1,) * (x.dim() - 3))
        return torch.gather(x, 2, idx.expand(x.shape))

    v = rot(tri_clip)
    a = {k: rot(x) for k, x in tri_attrs.items()}
    dd = torch.gather(d, 2, order)

    def isect(i, j):
        tt = dd[..., i] / (dd[..., i] - dd[..., j])
        tt = torch.clamp(tt, 0.0, 1.0)[..., None]
        vi = v[..., i, :] + tt * (v[..., j, :] - v[..., i, :])
        ai = {k: x[..., i, :] + tt * (x[..., j, :] - x[..., i, :])
              for k, x in a.items()}
        return vi, ai

    i01_v, i01_a = isect(0, 1)
    i02_v, i02_a = isect(0, 2)
    case3 = (n_in == 3)[..., None, None]
    case1 = (n_in == 1)[..., None, None]

    def first(x, i01, i02):
        one = torch.stack([x[..., 0, :], i01, i02], -2)
        two = torch.stack([i01, x[..., 1, :], x[..., 2, :]], -2)
        return torch.where(case3, x, torch.where(case1, one, two))

    def second(x, i01, i02):
        return torch.stack([i01, x[..., 2, :], i02], -2)

    out_v = torch.cat([first(v, i01_v, i02_v), second(v, i01_v, i02_v)], 1)
    out_a = {k: torch.cat([first(a[k], i01_a[k], i02_a[k]),
                           second(a[k], i01_a[k], i02_a[k])], 1) for k in a}
    out_ok = torch.cat([tri_valid & (n_in > 0), tri_valid & (n_in == 2)], 1)
    return out_v, out_a, out_ok


def rasterize(tri_clip, tri_attrs, height, width, tri_valid=None, chunk=64,
              near_clip=True, backface_cull=True):
    """The streaming z-buffer (``raster.py:118``): the triangles in chunks
    of `chunk`, each chunk's edge functions over the whole [C, H, W] pixel
    grid, its nearest triangle per pixel (the first on a tie), the
    winner's perspective-correct barycentrics and its attributes, merged
    into the running buffers chunk after chunk. No bin, so no triangle is
    ever dropped; the work is O(T H W).

    tri_clip [..., T, 3, 4] clip-space triangles (a leading axis batches
    images; the JAX function takes one image and is vmapped); tri_attrs
    name → [..., T, 3, C] or a static [T, 3, C] (albedo, normal, position,
    material and emission, and uvt where given); tri_valid [..., T] bool.
    near_clip clips at w = 1e-4 first (``clip_near``, 2T rows);
    backface_cull=False keeps both windings and lets a pixel within 1e-5
    of an edge in (depth passes: a watertight caster leaks no light).
    Returns a GBuffer [..., H, W, ...], depth 1e9 where empty."""
    lead = tri_clip.shape[:-3]
    t_in = tri_clip.shape[-3]
    dev = tri_clip.device
    tri_clip = tri_clip.reshape(-1, t_in, 3, 4)
    b = tri_clip.shape[0]
    if tri_valid is None:
        tri_valid = torch.ones((b, t_in), dtype=torch.bool, device=dev)
    else:
        tri_valid = tri_valid.expand(lead + (t_in,)).reshape(b, t_in)
    tri_attrs = {k: (v if v.dim() == 3
                     else v.expand(lead + v.shape[-3:]).reshape(
                         b, *v.shape[-3:]))
                 for k, v in tri_attrs.items()}
    if near_clip:
        tri_clip, tri_attrs, tri_valid = clip_near(tri_clip, tri_attrs,
                                                   tri_valid)
    names = sorted(tri_attrs)
    dims = [tri_attrs[k].shape[-1] for k in names]
    packed = torch.cat([tri_attrs[k].expand(b, *tri_attrs[k].shape[-3:])
                        if tri_attrs[k].dim() == 3 else tri_attrs[k]
                        for k in names], -1)              # [B, T, 3, Ctot]
    t_total = tri_clip.shape[1]
    pad = (-t_total) % chunk
    if pad:
        tri_clip = torch.cat([tri_clip, tri_clip.new_zeros((b, pad, 3, 4))],
                             1)
        packed = torch.cat([packed, packed.new_zeros(
            (b, pad, 3, packed.shape[-1]))], 1)
        tri_valid = torch.cat([tri_valid, tri_valid.new_zeros((b, pad))], 1)
    ctot = packed.shape[-1]
    px = (torch.arange(width, dtype=torch.float32, device=dev)
          + 0.5)[None, None, None, :]
    py = (torch.arange(height, dtype=torch.float32, device=dev)
          + 0.5)[None, None, :, None]
    zbuf = torch.full((b, height, width), _BIG, dtype=torch.float32,
                      device=dev)
    abuf = torch.zeros((b, height, width, ctot), dtype=torch.float32,
                       device=dev)
    mbuf = torch.zeros((b, height, width), dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)[:, None, None]
    for c0 in range(0, t_total + pad, chunk):
        clip = tri_clip[:, c0:c0 + chunk]                  # [B, C, 3, 4]
        attrs = packed[:, c0:c0 + chunk]
        valid = tri_valid[:, c0:c0 + chunk]
        w_clip = clip[..., 3]
        behind = w_clip <= 1e-6
        safe_w = torch.where(behind, torch.ones_like(w_clip), w_clip)
        ndc = clip[..., :3] / safe_w[..., None]
        sx = (ndc[..., 0] * 0.5 + 0.5) * width
        sy = (0.5 - ndc[..., 1] * 0.5) * height
        sz = ndc[..., 2]
        x0, x1, x2 = sx.unbind(-1)
        y0, y1, y2 = sy.unbind(-1)
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)   # [B, C]
        if backface_cull:
            ok = valid & (area < -1e-9) & ~torch.any(behind, -1)
        else:
            ok = valid & (torch.abs(area) > 1e-9) & ~torch.any(behind, -1)
        inv_area = (1.0 / torch.where(torch.abs(area) < 1e-9,
                                      torch.ones_like(area), area)
                    )[..., None, None]

        def edge(xa, ya, xb, yb):               # signed area of (a, b, p)
            xa, ya = xa[..., None, None], ya[..., None, None]
            return ((xb[..., None, None] - xa) * (py - ya)
                    - (yb[..., None, None] - ya) * (px - xa))

        w0 = edge(x1, y1, x2, y2) * inv_area                # [B, C, H, W]
        w1 = edge(x2, y2, x0, y0) * inv_area
        w2 = 1.0 - w0 - w1
        thr = 0.0 if backface_cull else -1e-5
        inside = ((w0 >= thr) & (w1 >= thr) & (w2 >= thr)
                  & ok[..., None, None])
        z = (w0 * sz[..., 0, None, None] + w1 * sz[..., 1, None, None]
             + w2 * sz[..., 2, None, None])
        inside = inside & (z >= -1.0) & (z <= 1.0)
        z = torch.where(inside, z, torch.full_like(z, _BIG))
        zmin, winner = torch.min(z, 1)                      # [B, H, W]
        hit = zmin < _BIG

        def gsel(a):
            return torch.gather(a, 1, winner[:, None])[:, 0]

        bw0, bw1, bw2 = gsel(w0), gsel(w1), gsel(w2)
        iw_sel = (1.0 / safe_w)[rows, winner]               # [B, H, W, 3]
        pw0 = bw0 * iw_sel[..., 0]
        pw1 = bw1 * iw_sel[..., 1]
        pw2 = bw2 * iw_sel[..., 2]
        denom = torch.clamp(pw0 + pw1 + pw2, min=1e-12)
        pw0, pw1, pw2 = pw0 / denom, pw1 / denom, pw2 / denom
        sel = attrs[rows, winner]                       # [B, H, W, 3, Ctot]
        interp = (pw0[..., None] * sel[..., 0, :]
                  + pw1[..., None] * sel[..., 1, :]
                  + pw2[..., None] * sel[..., 2, :])
        better = hit & (zmin < zbuf)
        zbuf = torch.where(better, zmin, zbuf)
        abuf = torch.where(better[..., None], interp, abuf)
        mbuf = mbuf | better
    out, off = {}, 0
    for k, d in zip(names, dims):
        out[k] = abuf[..., off:off + d].reshape(lead + (height, width, d))
        off += d
    return GBuffer(depth=zbuf.reshape(lead + (height, width)),
                   albedo=out["albedo"], normal=out["normal"],
                   position=out["position"], material=out["material"],
                   emission=out["emission"],
                   mask=mbuf.reshape(lead + (height, width)),
                   uvt=out.get("uvt"))
