"""UV generation: box-projection unwrap into a packed atlas.

Equivalent of the reference's UV mapper (fyrox-impl/src/utils/uvgen.rs —
it generates lightmap UVs by projecting triangles along their dominant
normal axis, clustering them into charts, and packing the charts into an
atlas). Same pipeline here:

    1. each triangle projects onto the plane of its dominant normal axis
       (6 directional charts, ±X/±Y/±Z),
    2. every chart normalizes to its 2D bounding rect,
    3. charts pack into the atlas with core/spatial.RectPacker, with a
       texel margin against bleeding.

Returns per-corner UVs [T,3,2] in [0,1] — seams between charts are cuts,
exactly like lightmap unwraps.
"""
from __future__ import annotations

import numpy as np

from fyrox_tpu_torch.core.spatial import RectPacker

__all__ = ["generate_uvs"]


def generate_uvs(positions, triangles, atlas_size=1024, margin_texels=2):
    """positions [V,3], triangles [T,3] → (uvs [T,3,2], chart_id [T]).

    Raises if the charts cannot fit (increase atlas_size)."""
    positions = np.asarray(positions, np.float64)
    triangles = np.asarray(triangles, np.int64)
    t = triangles.shape[0]
    tri = positions[triangles]                       # [T,3,3]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    dom = np.argmax(np.abs(n), axis=1)               # 0=x,1=y,2=z
    sign = np.sign(n[np.arange(t), dom])
    sign[sign == 0] = 1.0
    chart_id = dom * 2 + (sign < 0)                  # 0..5

    # project: drop the dominant axis, mirror one axis on negative sides
    # so texture orientation stays consistent
    axes_uv = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
    uv_local = np.zeros((t, 3, 2), np.float64)
    for d in range(3):
        m = dom == d
        ua, va = axes_uv[d]
        uv_local[m, :, 0] = tri[m][:, :, ua] * sign[m][:, None]
        uv_local[m, :, 1] = tri[m][:, :, va]

    # chart extents + packing; start near-full and shrink on overflow
    # (guillotine fragmentation makes the achievable fill scene-dependent)
    charts = sorted(range(6), key=lambda c: -_area(uv_local, chart_id, c))
    total = sum(_area(uv_local, chart_id, c) for c in charts
                if np.any(chart_id == c))
    scale = atlas_size * np.sqrt(0.5 / max(total, 1e-9))
    for _attempt in range(8):
        packer = RectPacker(atlas_size, atlas_size)
        uvs = np.zeros((t, 3, 2), np.float32)
        ok = True
        for c in charts:
            m = chart_id == c
            if not np.any(m):
                continue
            lo = uv_local[m].reshape(-1, 2).min(0)
            hi = uv_local[m].reshape(-1, 2).max(0)
            w = (hi[0] - lo[0]) * scale + 2 * margin_texels + 1
            h = (hi[1] - lo[1]) * scale + 2 * margin_texels + 1
            spot = packer.pack(w, h)
            if spot is None:
                ok = False
                break
            x0, y0 = spot
            local = (uv_local[m] - lo) * scale + margin_texels
            uvs[m] = ((local + np.asarray([x0, y0]))
                      / atlas_size).astype(np.float32)
        if ok:
            return uvs, chart_id.astype(np.int32)
        scale *= 0.8
    raise ValueError("atlas overflow — increase atlas_size")


def _extent(uv_local, chart_id, c, margin):
    m = chart_id == c
    if not np.any(m):
        return 0.0, 0.0
    lo = uv_local[m].reshape(-1, 2).min(0)
    hi = uv_local[m].reshape(-1, 2).max(0)
    return float(hi[0] - lo[0] + margin), float(hi[1] - lo[1] + margin)


def _area(uv_local, chart_id, c):
    w, h = _extent(uv_local, chart_id, c, 0.0)
    return w * h
