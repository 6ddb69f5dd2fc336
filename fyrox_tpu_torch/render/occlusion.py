"""Occlusion culling: occluder depth prepass + hierarchical-Z tests (the
port's copy of ``fyrox_tpu.render.occlusion``).

Equivalent of the reference's GPU-driven occlusion culling
(fyrox-impl/src/renderer/occlusion/mod.rs:60), kept on the device:

    1. a depth prepass of the big occluders at reduced resolution (one K5
       depth-only launch over every world, ``render/pipeline.py``);
    2. a max-depth mip pyramid (HZB) over that prepass;
    3. per node: project the world AABB, pick the level where its screen
       rectangle spans ~2 texels, and compare the box's nearest depth
       against the farthest HZB depth there: visible unless provably
       behind.

Batched over worlds: depth [W, H, Wd], boxes [W, N, 3], vp [W, 4, 4].
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from fyrox_tpu_torch._util import const

__all__ = ["build_hzb", "hzb_atlas", "occlusion_visible"]

_FAR = 1.0e9


def build_hzb(depth, levels=None):
    """Max-depth pyramid (``occlusion.py:31``): depth [W, H, Wd] (NDC z,
    1e9 where empty) → list of [W, H/2^k, Wd/2^k], level 0 the input."""
    h, w = depth.shape[-2:]
    if levels is None:
        levels = int(np.log2(max(min(h, w), 2)))
    pyr = [depth]
    d = depth
    for _ in range(levels):
        h2, w2 = d.shape[-2] // 2, d.shape[-1] // 2
        if h2 < 1 or w2 < 1:
            break
        d = d[..., :h2 * 2, :w2 * 2].reshape(
            d.shape[0], h2, 2, w2, 2).amax((2, 4))
        pyr.append(d)
    return pyr


@functools.lru_cache(maxsize=None)
def _atlas_meta(sizes):
    """(offsets, widths, heights) per level of a pyramid of (h, w) sizes:
    host arrays made once per shape, so that their device copies are
    cached (``_util.const``)."""
    hs = np.asarray([h for h, _ in sizes], np.int32)
    ws = np.asarray([w for _, w in sizes], np.int32)
    offsets = np.concatenate([[0], np.cumsum(hs.astype(np.int64)
                                             * ws)[:-1]]).astype(np.int32)
    return offsets, ws, hs


def hzb_atlas(pyr):
    """One flat [W, sum(h_k w_k)] array + host metadata (offsets, widths,
    heights per level) (``occlusion.py:48``)."""
    flat = torch.cat([p.reshape(p.shape[0], -1) for p in pyr], 1)
    return (flat, *_atlas_meta(tuple(tuple(p.shape[-2:]) for p in pyr)))


def occlusion_visible(wmin, wmax, vp, hzb, width, height, eps=1e-3):
    """[W, N] bool: node AABBs not provably hidden behind the HZB
    (``occlusion.py:64``). wmin / wmax [W, N, 3] world AABBs, vp [W, 4,
    4], hzb from build_hzb over a [W, height, width] prepass."""
    dev = wmin.device
    corners = torch.stack([
        torch.stack([wmax[..., 0] if m & 1 else wmin[..., 0],
                     wmax[..., 1] if m & 2 else wmin[..., 1],
                     wmax[..., 2] if m & 4 else wmin[..., 2]], -1)
        for m in range(8)], 2)                                # [W, N, 8, 3]
    ph = torch.cat([corners, torch.ones_like(corners[..., :1])], -1)
    clip = torch.sum(vp[:, None, None] * ph[..., None, :], -1)  # [W,N,8,4]
    w_c = clip[..., 3]
    crosses_near = torch.any(w_c <= 1e-6, -1)
    safe_w = torch.where(w_c <= 1e-6, torch.ones_like(w_c), w_c)
    ndc = clip[..., :3] / safe_w[..., None]
    u = (ndc[..., 0] * 0.5 + 0.5) * width
    v = (0.5 - ndc[..., 1] * 0.5) * height
    zmin = torch.where(w_c > 1e-6, ndc[..., 2],
                       torch.full_like(w_c, _FAR)).amin(-1)
    u0 = torch.clamp(u.amin(-1), 0, width - 1)
    u1 = torch.clamp(u.amax(-1), 0, width - 1)
    v0 = torch.clamp(v.amin(-1), 0, height - 1)
    v1 = torch.clamp(v.amax(-1), 0, height - 1)
    # the level where the rectangle spans <= ~2 texels
    span = torch.maximum(u1 - u0, v1 - v0)
    lvl = torch.clamp(torch.ceil(torch.log2(torch.clamp(span, min=1.0)))
                      .to(torch.int32), 0, len(hzb) - 1).long()
    flat, offsets, ws, hs = hzb_atlas(hzb)
    off = const(offsets, dev, torch.int64)[lvl]
    wl = const(ws, dev, torch.int64)[lvl]
    hl = const(hs, dev, torch.int64)[lvl]
    s = torch.exp2(lvl.to(torch.float32))
    ui = (u0 / s).to(torch.int32).long()
    vi = (v0 / s).to(torch.int32).long()
    nw = wmin.shape[0]
    occ = None
    for du in (0, 1):
        for dv in (0, 1):
            uu = torch.minimum(torch.clamp(ui + du, min=0), wl - 1)
            vv = torch.minimum(torch.clamp(vi + dv, min=0), hl - 1)
            val = torch.gather(flat, 1, (off + vv * wl + uu).reshape(nw, -1))
            val = val.reshape(uu.shape)
            occ = val if occ is None else torch.maximum(occ, val)
    hidden = (zmin - eps > occ) & ~crosses_near
    return ~hidden
