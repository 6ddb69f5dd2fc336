"""Cascaded shadow maps for a directional light (the port's copy of the
CSM part of ``fyrox_tpu.render.shadows``).

Equivalent of the reference's CsmRenderer (fyrox-impl/src/renderer/shadow/
csm.rs:90): 3 cascades, the camera frustum sliced at fractional far
planes, a per-cascade orthographic projection fitted to the slice's corners
in light space (csm.rs:194-253), depth-only rasterization of every cascade
of every world in ONE K5 launch, and a PCF depth compare at shading time.
Batched over worlds: views [W, 4, 4], cascades [W, 3, 4, 4], maps
[W, 3, S, S].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from fyrox_tpu_torch.core import transform as tfm
from fyrox_tpu_torch.render import raster as raster_mod
from fyrox_tpu_torch.render import tile_raster
from fyrox_tpu_torch.scene import camera as camera_mod

__all__ = ["CsmConfig", "fit_cascades", "render_cascade_depths",
           "cascade_budgets", "cull_cascade", "csm_visibility",
           "NUM_CASCADES"]

NUM_CASCADES = 3  # directional.rs:55


class CsmConfig(NamedTuple):
    splits: tuple = (0.05, 0.2, 1.0)  # fractional far planes per cascade
    map_size: int = 256
    bias: float = 2.5e-3
    pcf: bool = True


def _f32(x, device):
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def _frustum_slice_corners(inv_view, fov_y, aspect, z0, z1):
    """[W, 8, 3] world-space corners of the camera frustum slice [z0, z1]
    (camera space is RH, looking down -Z)."""
    dev = inv_view.device
    ty = torch.tan(_f32(0.5 * fov_y, dev))
    tx = ty * aspect
    corners = []
    for z in (z0, z1):
        for sy in (-1.0, 1.0):
            for sx in (-1.0, 1.0):
                corners.append(torch.stack([sx * tx * z, sy * ty * z,
                                            _f32(-z, dev)]))
    c = torch.stack(corners)                                    # [8, 3]
    ch = torch.cat([c, torch.ones((8, 1), dtype=c.dtype, device=dev)], -1)
    world = torch.sum(inv_view[..., None, :, :] * ch[:, None, :], -1)
    return world[..., :3]


def _ortho_offcenter(l, r, b, t, zn, zf):
    m = torch.zeros(l.shape + (4, 4), dtype=torch.float32, device=l.device)
    m[..., 0, 0] = 2.0 / (r - l)
    m[..., 0, 3] = -(r + l) / (r - l)
    m[..., 1, 1] = 2.0 / (t - b)
    m[..., 1, 3] = -(t + b) / (t - b)
    m[..., 2, 2] = -2.0 / (zf - zn)
    m[..., 2, 3] = -(zf + zn) / (zf - zn)
    m[..., 3, 3] = 1.0
    return m


def fit_cascades(view, fov_y, aspect, z_near, z_far, light_dir,
                 config: CsmConfig = CsmConfig()):
    """Per-cascade light view-projections [W, NUM_CASCADES, 4, 4]
    (``shadows.py:48``; csm.rs:194-253): a light-space view along the
    light direction, an ortho box around each slice's corners, padded
    along the light axis so that casters behind the slice still shadow it.
    view [W, 4, 4], light_dir [W, 3]; the scalars are Python floats."""
    dev = view.device
    inv_view = tfm.invert_affine(view)
    ld = light_dir / torch.clamp(torch.linalg.norm(light_dir, dim=-1,
                                                   keepdim=True), min=1e-8)
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=dev)
    y_axis = torch.tensor([0.0, 1.0, 0.0], device=dev)
    up = torch.where(torch.abs(ld[..., 1:2]) > 0.99, x_axis, y_axis)
    vps = []
    prev = z_near
    for ci in range(NUM_CASCADES):
        z1 = z_far * config.splits[ci]
        corners = _frustum_slice_corners(inv_view, fov_y, aspect, prev, z1)
        center = corners.mean(-2)
        lview = camera_mod.look_at_rh(center - ld * 1.0, center, up)
        ch = torch.cat([corners, torch.ones_like(corners[..., :1])], -1)
        lc = torch.sum(lview[..., None, :, :] * ch[..., :, None, :],
                       -1)[..., :3]
        mins, maxs = lc.amin(-2), lc.amax(-2)
        depth_pad = 50.0
        zn = -maxs[..., 2] - depth_pad
        zf = -mins[..., 2] + 1.0
        proj = _ortho_offcenter(mins[..., 0], maxs[..., 0], mins[..., 1],
                                maxs[..., 1], zn, zf)
        vps.append(tfm.mat4_mul(proj, lview))
        prev = z1
    return torch.stack(vps, -3)


def cascade_budgets(tri_budget, t_total, n_casc=NUM_CASCADES):
    """Per-cascade kept-triangle budgets (0 = keep all), as
    ``shadows.py:127-190`` sizes them: a fraction of T rounded up to a
    multiple of 8; in a per-cascade tuple, entries >= 1 keep the full
    set."""
    per_cascade = isinstance(tri_budget, (tuple, list))
    fracs = list(tri_budget) if per_cascade else [tri_budget] * n_casc
    fracs += [fracs[-1]] * max(0, n_casc - len(fracs))

    def budget(frac):
        if frac and t_total > 16 and not (per_cascade and frac >= 1.0):
            return min(-(-int(t_total * frac) // 8) * 8, t_total)
        return 0

    return [budget(f) for f in fracs[:n_casc]]


def cull_cascade(clip, valid, budget):
    """The per-cascade caster pre-cull (csm.rs culls casters per cascade
    volume): clip [W, T, 3, 4] in one cascade's ortho space (w == 1), valid
    [W, T]. Keeps the `budget` triangles of largest projected area among
    those whose bbox meets the [-1, 1]² footprint; returns (clip [W,
    budget, 3, 4], valid [W, budget], in-footprint count [W]). A depth-only
    raster takes a minimum, so the order of the kept rows does not matter;
    the kept set equals the JAX package's whenever the in-footprint count
    stays below the budget."""
    ndc = clip[..., :2]
    inside = (torch.all(ndc.amin(-2) <= 1.0, -1)
              & torch.all(ndc.amax(-2) >= -1.0, -1) & valid)
    e1 = ndc[..., 1, :] - ndc[..., 0, :]
    e2 = ndc[..., 2, :] - ndc[..., 0, :]
    area = torch.abs(e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0])
    score = torch.where(inside, area, torch.full_like(area, -1.0))
    topv, topi = torch.topk(score, budget, dim=-1)
    kept = torch.gather(clip, 1, topi[..., None, None].expand(
        -1, -1, 3, 4))
    return kept, topv >= 0.0, inside.sum(-1)


def render_cascade_depths(world_tri_positions, cascade_vps, map_size,
                          tri_valid=None, k_per_tile=512, tri_budget=0.0,
                          demand=None, footprint=None):
    """Depth-only passes of every cascade of every world, in one K5 launch
    (``shadows.py:103``, its batched single launch :185-232).

    world_tri_positions [W, T, 3, 3], cascade_vps [W, C, 4, 4] → depth maps
    [W, C, S, S] (NDC z, 1e9 where nothing is hit). Each cascade is culled
    to its budget (``cascade_budgets``), padded to the largest kept set,
    and all W*C maps bin at min(k_per_tile, that size). Where `demand` is
    a list, one (true demand [W], cap) entry per cascade is appended; where
    `footprint` is a list, the per-cascade (in-footprint count [W], budget)
    of each culled cascade."""
    w, t_total = world_tri_positions.shape[:2]
    n_casc = cascade_vps.shape[-3]
    if tri_valid is None:
        tri_valid = torch.ones((w, t_total), dtype=torch.bool,
                               device=world_tri_positions.device)
    budgets = cascade_budgets(tri_budget, t_total, n_casc)
    n_max = max(b if b else t_total for b in budgets)
    flat = world_tri_positions.reshape(w, t_total * 3, 3)
    clips, valids = [], []
    for ci in range(n_casc):
        clip = raster_mod.transform_clip(flat, cascade_vps[:, ci]).reshape(
            w, t_total, 3, 4)
        valid = tri_valid
        if budgets[ci]:
            clip, valid, n_in = cull_cascade(clip, valid, budgets[ci])
            if footprint is not None:
                footprint.append((n_in, budgets[ci]))
        pad = n_max - clip.shape[1]
        if pad:
            clip = torch.cat([clip, clip.new_zeros((w, pad, 3, 4))], 1)
            valid = torch.cat([valid, valid.new_zeros((w, pad))], 1)
        clips.append(clip)
        valids.append(valid)
    clips = torch.stack(clips, 1).reshape(w * n_casc, n_max, 3, 4)
    valids = torch.stack(valids, 1).reshape(w * n_casc, n_max)
    passes = [] if demand is not None else None
    z = tile_raster.rasterize_tiled(
        clips, {}, map_size, map_size, tri_valid=valids,
        k_per_tile=min(k_per_tile, n_max), depth_only=True,
        backface_cull=False, demand=passes)
    if demand is not None:
        dem, cap = passes[0]
        dem = dem.reshape(w, n_casc)
        demand.extend((dem[:, ci], cap) for ci in range(n_casc))
    return z.reshape(w, n_casc, map_size, map_size)


def csm_visibility(world_pos, view, cascade_vps, depth_maps, z_far,
                   config: CsmConfig = CsmConfig()):
    """Shadow visibility [W, H, Wd] in [0, 1] (``shadows.py:237``): the
    cascade is chosen by camera-space depth against the split distances,
    then a 3x3 PCF over that cascade's map. world_pos [W, H, Wd, 3]."""
    s = depth_maps.shape[-1]
    w = world_pos.shape[0]
    ph = torch.cat([world_pos, torch.ones_like(world_pos[..., :1])], -1)
    cam_z = -torch.sum(view[:, None, None, 2, :] * ph, -1)
    split_d = torch.tensor([z_far * f for f in config.splits],
                           dtype=torch.float32, device=world_pos.device)
    cascade = torch.sum((cam_z[..., None] > split_d).to(torch.int32), -1)
    cascade = cascade.clamp(0, NUM_CASCADES - 1).long()
    # project into every cascade, then select before sampling
    lc = torch.sum(cascade_vps[:, None, None] * ph[..., None, None, :],
                   -1)                                       # [W,H,Wd,C,4]
    lw = lc[..., 3:4]
    ndc = lc[..., :3] / torch.clamp(torch.abs(lw), min=1e-8) * torch.sign(lw)
    ndc_sel = torch.gather(ndc, -2, cascade[..., None, None].expand(
        *cascade.shape, 1, 3))[..., 0, :]
    u = (ndc_sel[..., 0] * 0.5 + 0.5) * s
    v = (0.5 - ndc_sel[..., 1] * 0.5) * s
    z_ref = ndc_sel[..., 2] - config.bias
    inside = ((u >= 0) & (u < s) & (v >= 0) & (v < s)
              & (torch.abs(ndc_sel[..., 2]) <= 1.0))
    ui0, vi0 = u.to(torch.int32), v.to(torch.int32)
    maps = depth_maps.reshape(w, -1)
    base = cascade * (s * s)

    def sample(du, dv):
        ui = torch.clamp(ui0 + du, 0, s - 1).long()
        vi = torch.clamp(vi0 + dv, 0, s - 1).long()
        occ = torch.gather(maps, 1, (base + vi * s + ui).reshape(w, -1))
        return (z_ref <= occ.reshape(z_ref.shape)).to(torch.float32)

    if config.pcf:
        vis = sum(sample(du, dv)
                  for du in (-1, 0, 1) for dv in (-1, 0, 1)) / 9.0
    else:
        vis = sample(0, 0)
    return torch.where(inside, vis, torch.ones_like(vis))
