"""Tiled, binned rasterizer: the port of
``fyrox_tpu/render/pallas_raster.py`` (K5, ``_visibility_pallas``) and of
the XLA work around it in ``rasterize_pallas``.

A pass rasterizes a batch of images at once: an image is one world's
camera view or occlusion prepass, or one (world, map) shadow map. Per
image:

  1. features, [T, 16] rows and a conservative pixel bbox per triangle:
     ``tri_features_h``, 2DH (homogeneous, Olano-Greer) forms, in the
     homogeneous mode; ``tri_features``, screen-affine forms of the
     Sutherland-Hodgman-clipped triangles (``raster.clip_near``: 2T rows),
     in the clipped mode;
  2. ``bin_triangles``: the first K triangle ids (by index) whose bbox
     overlaps each 8 x 128 tile, the tile's count, and the pass's true
     demand (the largest per-tile overlap before the K clamp);
  3. ``visibility`` (K5, its 2DH or its affine variant): per tile, walk
     the tile's binned rows in slot order and keep a z-buffer with the
     winning slot and its barycentrics. CUDA tensors launch
     ``csrc/tile_raster.cu``; CPU tensors take ``visibility_plain``;
  4. winner → triangle id and one joined attribute gather, interpolated
     with the perspective-correct barycentrics (the affine ones corrected
     by 1/w).

The binning takes the k-th set bit of a per-tile cumulative sum by
``torch.searchsorted``: the same integers as the JAX package's
``bin_mode="cumsum"`` (a counting rank, ``pallas_ops.count_lt``) and
``"topk"``, without either TPU workaround.
"""
from __future__ import annotations

import torch

from fyrox_tpu_torch._util import value_const
from fyrox_tpu_torch.render.raster import GBuffer, clip_near

__all__ = ["tri_features_h", "tri_features", "bin_triangles", "visibility",
           "visibility_plain", "rasterize_tiled", "launches",
           "reset_launches", "split_parts", "take_scratch", "BIG", "NFEAT"]

BIG = 1e9
NFEAT = 16          # feature row per triangle: E0, E1, S, Z, W forms, ok
_CHUNK = 8          # the JAX kernel's chunk: K is padded to a multiple
# K5 splits a tile that walks more than SPLIT_SPAN slots into parts that
# other CTAs walk, SPLIT_CAP parts at most in a launch (the span doubles
# until they fit); its scratch holds SPLIT_CAP slices of 1,024 int64 keys
SPLIT_SPAN = 96
SPLIT_CAP = 2048

_LAUNCHES = {"full": 0, "depth": 0, "full_affine": 0, "depth_affine": 0}
_LAST_PLAN = []
_SCRATCH = {}       # K5's plan and slices by (device, stream)


def launches(variant: str) -> int:
    """Kernel launches of one variant since the last reset_launches():
    "full" | "depth" (2DH forms), "full_affine" | "depth_affine"."""
    return _LAUNCHES[variant]


def reset_launches():
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def split_parts():
    """(parts, span) of the last K5 launch: how many parts of split tiles
    its helper CTAs walked, and the span the tiles were cut at (2^31 - 1
    where none was split). Reads the card."""
    if not _LAST_PLAN:
        return 0, 2 ** 31 - 1
    parts, _, span = _LAST_PLAN[-1][:3].tolist()
    return parts, span


def _cross(a, b):
    """Cross product over the last axis, in jnp.cross's order."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def tri_features_h(tri_clip, tri_valid, height, width, backface_cull=True):
    """2DH per-triangle constants (``pallas_raster.py:43``).

    tri_clip [..., T, 3, 4], tri_valid [..., T] → feats [..., T, 16], bbox
    [..., T, 4] (x0, y0, x1, y1 in pixels), ok [..., T]. The five affine
    forms of pixel coordinates p = (px, py, 1) sit in slots 0-14 (E0, E1,
    S = E0 + E1 + E2, Z, W; rows sign-normalized by the determinant);
    slot 15 is the validity flag. A pixel is inside where E0, E1, E2 >= 0
    and W > 0; z = Z / W and the barycentrics E_i / S are
    perspective-correct.
    """
    x_c, y_c, z_c, w_c = tri_clip.unbind(-1)                 # [..., T, 3]
    u = (0.5 * x_c + 0.5 * w_c) * width
    v = (0.5 * w_c - 0.5 * y_c) * height
    cols = torch.stack([u, v, w_c], -1)                      # [..., T, 3, 3]
    c0, c1, c2 = cols.unbind(-2)
    e0 = _cross(c1, c2)
    e1 = _cross(c2, c0)
    e2 = _cross(c0, c1)
    p = e0 * c0
    det = (p[..., 0] + p[..., 1]) + p[..., 2]
    if backface_cull:
        ok = tri_valid & (det < -1e-12)
    else:
        ok = tri_valid & (torch.abs(det) > 1e-12)
    sgn = torch.sign(torch.where(det == 0, torch.ones_like(det), det))[
        ..., None]
    e0, e1, e2 = e0 * sgn, e1 * sgn, e2 * sgn
    s_row = e0 + e1 + e2
    z_row = z_c[..., 0:1] * e0 + z_c[..., 1:2] * e1 + z_c[..., 2:3] * e2
    w_row = w_c[..., 0:1] * e0 + w_c[..., 1:2] * e1 + w_c[..., 2:3] * e2
    feats = torch.cat([e0, e1, s_row, z_row, w_row,
                       ok.to(torch.float32)[..., None]], -1)

    # conservative bbox: projected when fully in front, else the whole
    # screen (a triangle crossing w = 0 can reach infinity)
    front = torch.all(w_c > 1e-6, -1)
    safe_w = torch.where(torch.abs(w_c) < 1e-6, torch.ones_like(w_c), w_c)
    sx, sy = u / safe_w, v / safe_w
    proj = torch.stack([sx.amin(-1), sy.amin(-1), sx.amax(-1), sy.amax(-1)],
                       -1)
    full = value_const((0.0, 0.0, float(width), float(height)),
                       proj.device)
    bbox = torch.where(front[..., None], proj, full)
    return feats, bbox, ok


def tri_features(tri_clip, tri_valid, height, width, backface_cull=True):
    """Screen-affine per-triangle constants (``pallas_raster.py:102``) of
    triangles clipped to w > 0.

    tri_clip [..., T, 3, 4], tri_valid [..., T] → feats [..., T, 16]: the
    barycentrics w0, w1 as affine forms of the pixel centre (a0, b0, c0,
    a1, b1, c1), the NDC z plane (za, zb, zc), the ok flag in column 9,
    zeros to 16; bbox [..., T, 4] of the projected vertices; ok [..., T].
    The forms are divided by the signed area, so the barycentrics do not
    depend on the winding (backface_cull=False needs no fixup).
    """
    w_clip = tri_clip[..., 3]
    degenerate = torch.any(w_clip <= 1e-6, -1)
    safe_w = torch.where(w_clip <= 1e-6, torch.ones_like(w_clip), w_clip)
    ndc = tri_clip[..., :3] / safe_w[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * width
    sy = (0.5 - ndc[..., 1] * 0.5) * height
    sz = ndc[..., 2]
    x0, x1, x2 = sx.unbind(-1)
    y0, y1, y2 = sy.unbind(-1)
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    if backface_cull:
        ok = tri_valid & (area < -1e-9) & ~degenerate
    else:
        ok = tri_valid & (torch.abs(area) > 1e-9) & ~degenerate
    inv_area = 1.0 / torch.where(torch.abs(area) < 1e-9,
                                 torch.ones_like(area), area)
    # w0(p) = ((x2-x1)(py-y1) - (y2-y1)(px-x1)) / area
    a0 = -(y2 - y1) * inv_area
    b0 = (x2 - x1) * inv_area
    c0 = ((y2 - y1) * x1 - (x2 - x1) * y1) * inv_area
    # w1(p) = ((x0-x2)(py-y2) - (y0-y2)(px-x2)) / area
    a1 = -(y0 - y2) * inv_area
    b1 = (x0 - x2) * inv_area
    c1 = ((y0 - y2) * x2 - (x0 - x2) * y2) * inv_area
    # z(p) = w0 z0 + w1 z1 + (1 - w0 - w1) z2
    z0, z1, z2 = sz.unbind(-1)
    za = a0 * (z0 - z2) + a1 * (z1 - z2)
    zb = b0 * (z0 - z2) + b1 * (z1 - z2)
    zc = c0 * (z0 - z2) + c1 * (z1 - z2) + z2
    feats = torch.stack([a0, b0, c0, a1, b1, c1, za, zb, zc,
                         ok.to(torch.float32)], -1)
    feats = torch.cat([feats, feats.new_zeros(feats.shape[:-1]
                                              + (NFEAT - 10,))], -1)
    bbox = torch.stack([sx.amin(-1), sy.amin(-1), sx.amax(-1), sy.amax(-1)],
                       -1)
    return feats, bbox, ok


def bin_triangles(bbox, ok, height, width, tile_h, tile_w, k_per_tile):
    """First-K triangle ids per tile by bbox overlap
    (``pallas_raster.py:172``), batched over images.

    bbox [B, T, 4], ok [B, T] → ids [B, NT, K] int32 (0 in unused slots),
    count [B, NT] int32, demand [B] int32: the largest per-tile overlap
    before the K clamp. Tiles are row-major, NT = (height / tile_h) *
    (width / tile_w); valid slots come first, in triangle-index order.
    """
    b, t = ok.shape
    nty, ntx = height // tile_h, width // tile_w
    dev = bbox.device
    ty0 = (torch.arange(nty, device=dev, dtype=torch.float32)
           * tile_h)[:, None]
    tx0 = (torch.arange(ntx, device=dev, dtype=torch.float32)
           * tile_w)[None, :]
    bb = bbox[:, :, None, None, :]
    ov = ((bb[..., 0] < tx0 + tile_w) & (bb[..., 2] >= tx0)
          & (bb[..., 1] < ty0 + tile_h) & (bb[..., 3] >= ty0)
          & ok[:, :, None, None])                           # [B, T, nty, ntx]
    keys = torch.cumsum(ov.reshape(b, t, nty * ntx), 1,
                        dtype=torch.int32).transpose(1, 2).contiguous()
    total = keys[..., -1]                                    # [B, NT]
    demand = total.amax(-1)
    targets = torch.arange(1, k_per_tile + 1, device=dev,
                           dtype=torch.int32).expand(b, nty * ntx,
                                                     k_per_tile)
    # the k-th set bit: the first index whose running count reaches k
    pos = torch.searchsorted(keys, targets.contiguous(), side="left")
    valid = targets <= total[..., None]
    ids = torch.where(valid, pos.clamp(0, t - 1), torch.zeros_like(pos))
    count = torch.clamp(total, max=k_per_tile)
    return ids.to(torch.int32), count.to(torch.int32), demand


def _pixel_centres(nty, ntx, tile_h, tile_w, device):
    """px [1, NT, 1, tw] and py [1, NT, th, 1] pixel centres per tile."""
    t = torch.arange(nty * ntx, device=device)
    ti, tj = t // ntx, t % ntx
    row = torch.arange(tile_h, device=device)
    col = torch.arange(tile_w, device=device)
    py = (ti[:, None] * tile_h + row[None, :]).to(torch.float32) + 0.5
    px = (tj[:, None] * tile_w + col[None, :]).to(torch.float32) + 0.5
    return px[None, :, None, :], py[None, :, :, None]


def visibility_plain(feats, ids, count, height, width, tile_h, tile_w,
                     depth_only=False, affine=False):
    """Plain PyTorch version of K5: the same function as
    ``csrc/tile_raster.cu``, with every float operation rounded in the
    kernel's order, as a loop over slots on [images, tiles, th, tw]
    blocks.

    feats [B, Tn, 16] f32, ids [B, NT, K] int32, count [B, NT] int32 →
    z [B, H, W] (1e9 where nothing is hit), and unless depth_only the
    winning slot idx int32 (-1 where nothing is hit), w0 and w1 (0 there).
    H and W are multiples of the tile. The 2DH rows (``tri_features_h``)
    give z = Z / W and w_i = E_i / S; the affine rows (``tri_features``,
    ``affine=True``) give w0, w1 and z as they are, inside where w0, w1
    and 1 - w0 - w1 are >= 0 (``pallas_raster.py:318-325``).
    """
    b = feats.shape[0]
    nty, ntx = height // tile_h, width // tile_w
    nt, k = nty * ntx, ids.shape[-1]
    dev = feats.device
    rows = torch.gather(feats, 1, ids.reshape(b, nt * k, 1).long().expand(
        b, nt * k, NFEAT)).reshape(b, nt, k, NFEAT)
    cnt = count.reshape(b, nt, 1, 1)
    px, py = _pixel_centres(nty, ntx, tile_h, tile_w, dev)
    shape = (b, nt, tile_h, tile_w)
    zb = torch.full(shape, BIG, dtype=torch.float32, device=dev)
    if not depth_only:
        ib = torch.full(shape, -1, dtype=torch.int32, device=dev)
        w0b = torch.zeros(shape, dtype=torch.float32, device=dev)
        w1b = torch.zeros(shape, dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    big = torch.full((), BIG, dtype=torch.float32, device=dev)
    n_slots = int(count.max().item()) if count.numel() else 0
    for j in range(n_slots):
        f = rows[:, :, j, :, None, None]                     # [B, NT, 16, 1, 1]

        def aff(i):
            return f[:, :, i] * px + f[:, :, i + 1] * py + f[:, :, i + 2]

        if affine:
            w0, w1, z = aff(0), aff(3), aff(6)
            inside = ((w0 >= 0) & (w1 >= 0) & (1.0 - w0 - w1 >= 0)
                      & (z >= -1.0) & (z <= 1.0) & (f[:, :, 9] > 0.5)
                      & (j < cnt))
        else:
            e0, e1, s, zf, wf = aff(0), aff(3), aff(6), aff(9), aff(12)
            e2 = s - e0 - e1
            in_front = wf > 1e-12
            z = zf / torch.where(in_front, wf, one)
            inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0) & in_front
                      & (z >= -1.0) & (z <= 1.0) & (f[:, :, 15] > 0.5)
                      & (j < cnt))
        zm = torch.where(inside, z, big)
        better = zm < zb
        zb = torch.where(better, zm, zb)
        if not depth_only:
            if not affine:
                s_safe = torch.where(s == 0, one, s)
                w0, w1 = e0 / s_safe, e1 / s_safe
            ib = torch.where(better, torch.full_like(ib, j), ib)
            w0b = torch.where(better, w0, w0b)
            w1b = torch.where(better, w1, w1b)

    def image(x):                    # [B, NT, th, tw] → [B, H, W]
        return x.reshape(b, nty, ntx, tile_h, tile_w).permute(
            0, 1, 3, 2, 4).reshape(b, height, width)

    if depth_only:
        return image(zb)
    return image(zb), image(ib), image(w0b), image(w1b)


def _check_inputs(feats, ids, count, height, width, tile_h, tile_w):
    if feats.dtype != torch.float32 or ids.dtype != torch.int32 \
            or count.dtype != torch.int32:
        raise TypeError(f"tile_raster: feats must be float32, ids and count "
                        f"int32, got {feats.dtype} / {ids.dtype} / "
                        f"{count.dtype}")
    nt = (height // tile_h) * (width // tile_w)
    b = feats.shape[0]
    if (feats.dim() != 3 or feats.shape[2] != NFEAT or ids.dim() != 3
            or tuple(ids.shape[:2]) != (b, nt)
            or tuple(count.shape) != (b, nt)):
        raise ValueError(f"tile_raster: shapes {tuple(feats.shape)} / "
                         f"{tuple(ids.shape)} / {tuple(count.shape)}, want "
                         f"[B,T,16] / [B,{nt},K] / [B,{nt}]")
    if height % tile_h or width % tile_w or tile_h * tile_w > 1024:
        raise ValueError(f"tile_raster: {height}x{width} is not a multiple "
                         f"of the {tile_h}x{tile_w} tile, or the tile holds "
                         "more than 1024 pixels")
    if not (ids.device == count.device == feats.device):
        raise ValueError("tile_raster: inputs on different devices")
    if not (feats.is_contiguous() and ids.is_contiguous()
            and count.is_contiguous()) or feats.data_ptr() % 16:
        raise ValueError("tile_raster: inputs must be contiguous, feats "
                         "16-byte aligned")


def take_scratch(dev, stream):
    """Remove and return K5's scratch of (device, stream handle), or None.
    A CUDA graph that captured launches on that stream keeps what this
    returns for as long as it lives, and no later launch on a stream of
    the same handle (streams come from a pool) finds it."""
    return _SCRATCH.pop((torch.device(dev), stream), None)


def _scratch(dev, stream, n_tiles):
    """K5's scratch for this stream, kept from launch to launch: the plan,
    SPLIT_CAP parts and a counter for each of n_tiles tiles (int32), and
    a slice of 1,024 keys for each part (int64). The plan kernel writes
    all of it that a launch reads. It is never allocated during a CUDA
    graph capture (it would come from the graph's private pool, which
    dies with the graph): a capture's warm-up on the capture stream makes
    it first."""
    plan, slices = _SCRATCH.get((dev, stream), (None, None))
    n_plan = 3 + 5 * SPLIT_CAP + n_tiles
    if plan is None or plan.numel() < n_plan or len(slices) < SPLIT_CAP:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "tile_raster: K5's scratch would be allocated inside a CUDA "
                "graph capture; run the captured work once on the capture "
                "stream first (render.pipeline.CapturedFrame does)")
        plan = torch.empty(n_plan, dtype=torch.int32, device=dev)
        slices = torch.empty((SPLIT_CAP, 1024), dtype=torch.int64,
                             device=dev)
        _SCRATCH[(dev, stream)] = plan, slices
    return plan, slices


def _visibility_cuda(feats, ids, count, height, width, tile_h, tile_w,
                     depth_only=False, affine=False):
    from fyrox_tpu_torch import kernels
    _check_inputs(feats, ids, count, height, width, tile_h, tile_w)
    b, t = feats.shape[:2]
    k = ids.shape[2]
    dev = feats.device
    z = torch.empty((b, height, width), dtype=torch.float32, device=dev)
    if depth_only:
        idx = w0 = w1 = None
        ptrs = (z.data_ptr(), None, None, None)
    else:
        idx = torch.empty((b, height, width), dtype=torch.int32, device=dev)
        w0 = torch.empty_like(z)
        w1 = torch.empty_like(z)
        ptrs = (z.data_ptr(), idx.data_ptr(), w0.data_ptr(), w1.data_ptr())
    if z.numel():
        lib = kernels.library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        plan = slices = None
        if k > SPLIT_SPAN and SPLIT_CAP > 0:    # a tile may be split
            plan, slices = _scratch(dev, stream, count.numel())
        err = lib.fyrox_tile_raster(
            feats.data_ptr(), ids.data_ptr(), count.data_ptr(), *ptrs, b, t,
            k, height, width, tile_h, tile_w, int(depth_only), int(affine),
            SPLIT_SPAN, SPLIT_CAP, plan if plan is None else plan.data_ptr(),
            slices if slices is None else slices.data_ptr(), stream)
        kernels.check(err, "fyrox_tile_raster")
        _LAUNCHES[("depth" if depth_only else "full")
                  + ("_affine" if affine else "")] += 1
        _LAST_PLAN[:] = [] if plan is None else [plan]
    return z if depth_only else (z, idx, w0, w1)


def visibility(feats, ids, count, height, width, tile_h, tile_w,
               depth_only=False, affine=False):
    """Dispatch for K5 (2DH rows, or affine rows where `affine`): CPU
    tensors → ``visibility_plain``; CUDA tensors → ``csrc/tile_raster.cu``
    (which raises on anything it does not take)."""
    if feats.is_cuda:
        return _visibility_cuda(feats, ids, count, height, width, tile_h,
                                tile_w, depth_only, affine)
    if feats.device.type != "cpu":
        raise ValueError(f"tile_raster: no kernel for {feats.device}")
    return visibility_plain(feats, ids, count, height, width, tile_h,
                            tile_w, depth_only, affine)


def rasterize_tiled(tri_clip, tri_attrs, height, width, tri_valid=None,
                    k_per_tile=256, depth_only=False, backface_cull=True,
                    tile_h=8, tile_w=128, demand=None, mode="homogeneous"):
    """A batch of images through features → binning → K5 → attributes
    (``rasterize_pallas``, ``pallas_raster.py:401``).

    tri_clip [B, T, 3, 4] clip-space triangles; tri_attrs maps a name to
    [B, T, 3, C] or [T, 3, C] per-vertex attributes (albedo, normal,
    position, material, emission, and uvt where the scene is textured);
    tri_valid [B, T] bool. Returns a GBuffer batch [B, H, W, ...], or with
    depth_only the depth [B, H, W] (1e9 where empty). mode "homogeneous"
    rasterizes 2DH forms of the T triangles; "clipped" clips them at the
    near plane first (``raster.clip_near``: 2T rows) and rasterizes
    screen-affine forms through K5's affine variant. A size that is not a
    multiple of the tile is rasterized into the next multiple and
    cropped: the viewport stays (height, width), so the padding never
    receives fragments. Where `demand` is a list, (per-image true demand
    [B], cap K) is appended.
    """
    if mode not in ("homogeneous", "clipped"):
        raise ValueError(f"rasterize_tiled: mode {mode!r}")
    affine = mode == "clipped"
    tile_h, tile_w = min(tile_h, height), min(tile_w, width)
    height_p = -(-height // tile_h) * tile_h
    width_p = -(-width // tile_w) * tile_w
    b = tri_clip.shape[0]
    dev = tri_clip.device
    if tri_valid is None:
        tri_valid = torch.ones(tri_clip.shape[:2], dtype=torch.bool,
                               device=dev)
    if affine:
        tri_clip, tri_attrs, tri_valid = clip_near(tri_clip, tri_attrs,
                                                   tri_valid)
    t = tri_clip.shape[1]
    k = min(k_per_tile, t)
    k = -(-k // _CHUNK) * _CHUNK
    feat_fn = tri_features if affine else tri_features_h
    feats, bbox, ok = feat_fn(tri_clip, tri_valid, height, width,
                              backface_cull)
    if t < k:                                   # tiny scenes: pad rows
        pad = k - t
        feats = torch.cat([feats, feats.new_zeros((b, pad, NFEAT))], 1)
        bbox = torch.cat([bbox, bbox.new_full((b, pad, 4), -BIG)], 1)
        ok = torch.cat([ok, ok.new_zeros((b, pad))], 1)
    ids, count, dem = bin_triangles(bbox, ok, height_p, width_p, tile_h,
                                    tile_w, k)
    if demand is not None:
        demand.append((dem, k))
    feats = feats.contiguous()
    if depth_only:
        z = visibility(feats, ids, count, height_p, width_p, tile_h, tile_w,
                       depth_only=True, affine=affine)
        return z[:, :height, :width]
    z, local_idx, w0, w1 = visibility(feats, ids, count, height_p, width_p,
                                      tile_h, tile_w, affine=affine)
    z, local_idx = z[:, :height, :width], local_idx[:, :height, :width]
    w0, w1 = w0[:, :height, :width], w1[:, :height, :width]

    # local tile slot → triangle id: one flat gather per image
    ntx = width_p // tile_w
    py_tile = torch.arange(height, device=dev) // tile_h
    px_tile = torch.arange(width, device=dev) // tile_w
    mask = local_idx >= 0
    flat = ((py_tile[:, None] * ntx + px_tile[None, :]) * k
            + local_idx.clamp(min=0).long())                 # [B, H, W]
    tri_id = torch.gather(ids.reshape(b, -1), 1, flat.reshape(b, -1)).long()

    if affine:
        # screen-space barycentrics need the 1/w correction
        w_clip = tri_clip[..., 3]
        iw = 1.0 / torch.where(w_clip <= 1e-6, torch.ones_like(w_clip),
                               w_clip)                       # [B, T, 3]
        iw_px = torch.gather(iw, 1, tri_id[..., None].expand(-1, -1, 3))
        iw_px = iw_px.reshape(b, height, width, 3)
        w2 = 1.0 - w0 - w1
        pw0 = w0 * iw_px[..., 0]
        pw1 = w1 * iw_px[..., 1]
        pw2 = w2 * iw_px[..., 2]
        denom = torch.clamp(pw0 + pw1 + pw2, min=1e-12)
        pw0, pw1, pw2 = pw0 / denom, pw1 / denom, pw2 / denom
    else:
        # the 2DH barycentrics E_i / S are perspective-correct already
        pw0, pw1 = w0, w1
        pw2 = 1.0 - w0 - w1
    # every attribute comes from ONE row gather of a joined [B, T, 3*Ct]
    # table
    parts = [v.expand(b, *v.shape[-3:]) if v.dim() == 3 else v
             for v in tri_attrs.values()]
    joined = torch.cat([v.reshape(b, t, -1) for v in parts], -1)
    rows = torch.gather(joined, 1, tri_id[..., None].expand(
        b, tri_id.shape[1], joined.shape[-1])).reshape(
        b, height, width, joined.shape[-1])
    out, off = {}, 0
    for name, v in tri_attrs.items():
        c = v.shape[-1]
        av = rows[..., off:off + 3 * c].reshape(b, height, width, 3, c)
        off += 3 * c
        val = (pw0[..., None] * av[..., 0, :] + pw1[..., None] * av[..., 1, :]
               + pw2[..., None] * av[..., 2, :])
        out[name] = torch.where(mask[..., None], val, torch.zeros_like(val))
    z = torch.where(mask, z, torch.full_like(z, BIG))
    return GBuffer(depth=z, albedo=out["albedo"], normal=out["normal"],
                   position=out["position"], material=out["material"],
                   emission=out["emission"], mask=mask, uvt=out.get("uvt"))
