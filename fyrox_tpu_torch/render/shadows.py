"""Shadow maps (the port's copy of ``fyrox_tpu.render.shadows``):
cascaded shadow maps for a directional light, spot-light maps and
point-light cube maps.

Equivalent of the reference's CsmRenderer (fyrox-impl/src/renderer/shadow/
csm.rs:90): 3 cascades, the camera frustum sliced at fractional far
planes, a per-cascade orthographic projection fitted to the slice's corners
in light space (csm.rs:194-253), depth-only rasterization of every cascade
of every world in ONE K5 launch, and a PCF depth compare at shading time;
and of SpotShadowMapRenderer (shadow/spot.rs:49) and
PointShadowMapRenderer (shadow/point.rs:50): one depth-only K5 launch for
the spot maps of every spot light of every world, one for the six faces
of every point light of every world. Batched over worlds: views [W, 4, 4],
cascades [W, 3, 4, 4], maps [W, 3, S, S].
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch._util import value_const
from fyrox_tpu_torch.core import transform as tfm
from fyrox_tpu_torch.render import raster as raster_mod
from fyrox_tpu_torch.render import tile_raster
from fyrox_tpu_torch.scene import camera as camera_mod

__all__ = ["CsmConfig", "fit_cascades", "render_cascade_depths",
           "cascade_budgets", "cull_cascade", "csm_visibility",
           "spot_vp", "map_visibility", "point_vps",
           "render_point_depths", "point_visibility", "NUM_CASCADES"]

NUM_CASCADES = 3  # directional.rs:55


class CsmConfig(NamedTuple):
    splits: tuple = (0.05, 0.2, 1.0)  # fractional far planes per cascade
    map_size: int = 256
    bias: float = 2.5e-3
    pcf: bool = True


def _f32(x, device):
    return value_const(float(x), device)


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
    up = torch.where(torch.abs(ld[..., 1:2]) > 0.99,
                     value_const((1.0, 0.0, 0.0), dev),
                     value_const((0.0, 1.0, 0.0), dev))
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
    of each culled cascade.

    With no budget it renders any light's maps: every spot map of every
    world (``render_map_depth``, ``shadows.py:323``, one light per call
    there) or every point-light face (``render_point_depths``) in one
    launch."""
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
    ph = torch.cat([world_pos, torch.ones_like(world_pos[..., :1])], -1)
    cam_z = -torch.sum(view[:, None, None, 2, :] * ph, -1)
    split_d = value_const(tuple(z_far * f for f in config.splits),
                          world_pos.device)
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
    vis = _map_sample(depth_maps, cascade, u, v, z_ref, s, config.pcf)
    return torch.where(inside, vis, torch.ones_like(vis))


# --------------------------------------------------------------------------
# spot + point shadow maps (renderer/shadow/spot.rs:49, point.rs:50)
# --------------------------------------------------------------------------

def _perspective_from(fov_y, z_near, z_far):
    """[..., 4, 4] perspective projections of fov_y [...] (a tensor);
    z_near and z_far are Python floats (``shadows.py:288``)."""
    f = 1.0 / torch.tan(fov_y * 0.5)
    m = torch.zeros(fov_y.shape + (4, 4), dtype=torch.float32,
                    device=fov_y.device)
    m[..., 0, 0] = f
    m[..., 1, 1] = f
    # fill_, not item assignment: assigning a Python float to a 0-d view
    # copies a host scalar, which a CUDA graph capture refuses
    m[..., 2, 2].fill_((z_far + z_near) / (z_near - z_far))
    m[..., 2, 3].fill_(2.0 * z_far * z_near / (z_near - z_far))
    m[..., 3, 2].fill_(-1.0)
    return m


def _look_at(eye, fwd, up):
    """[..., 4, 4] views from eye, forward and up [..., 3]
    (``shadows.py:299``)."""
    z = -fwd / torch.clamp(torch.linalg.norm(fwd, dim=-1, keepdim=True),
                           min=1e-8)
    x = torch.linalg.cross(up, z, dim=-1)
    x = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                        min=1e-8)
    y = torch.linalg.cross(z, x, dim=-1)
    r = torch.stack([x, y, z], -2)                         # rows
    t = -torch.sum(r * eye[..., None, :], -1)
    m = torch.zeros(eye.shape[:-1] + (4, 4), dtype=torch.float32,
                    device=eye.device)
    m[..., :3, :3] = r
    m[..., :3, 3] = t
    m[..., 3, 3] = 1.0
    return m


def spot_vp(light_pos, light_dir, cos_falloff, z_near=0.05, z_far=100.0):
    """View-projections [..., 4, 4] of spot-light shadow maps
    (``shadows.py:311``): a perspective frustum over the outer cone.
    light_pos, light_dir [..., 3], cos_falloff [...] (a tensor)."""
    dev = light_pos.device
    fov = 2.0 * torch.arccos(torch.clamp(cos_falloff, -1.0, 1.0)) + 0.1
    up = torch.where(torch.abs(light_dir[..., 1:2]) > 0.99,
                     value_const((1.0, 0.0, 0.0), dev),
                     value_const((0.0, 1.0, 0.0), dev))
    view = _look_at(light_pos, light_dir, up)
    proj = _perspective_from(fov.expand(view.shape[:-2]), z_near, z_far)
    return tfm.mat4_mul(proj, view)


def _map_sample(depth_maps, face, u, v, z_ref, s, pcf):
    """The fraction of the (3 x 3 PCF, or 1) texels around (u, v) of map
    `face` of depth_maps [W, M, S, S] whose depth z_ref does not exceed;
    face, u, v, z_ref [W, ...]."""
    w = depth_maps.shape[0]
    maps = depth_maps.reshape(w, -1)
    ui0, vi0 = u.to(torch.int32), v.to(torch.int32)
    base = face * (s * s)

    def sample(du, dv):
        ui = torch.clamp(ui0 + du, 0, s - 1).long()
        vi = torch.clamp(vi0 + dv, 0, s - 1).long()
        occ = torch.gather(maps, 1, (base + vi * s + ui).reshape(w, -1))
        return (z_ref <= occ.reshape(z_ref.shape)).to(torch.float32)

    if pcf:
        return sum(sample(du, dv)
                   for du in (-1, 0, 1) for dv in (-1, 0, 1)) / 9.0
    return sample(0, 0)


def map_visibility(world_pos, vp, depth_map, bias=2e-3, pcf=True):
    """Projected shadow-map test (``shadows.py:334``): world_pos [W, H,
    Wd, 3], vp [W, 4, 4], depth_map [W, S, S] → [W, H, Wd] in [0, 1]."""
    s = depth_map.shape[-1]
    ph = torch.cat([world_pos, torch.ones_like(world_pos[..., :1])], -1)
    lc = torch.sum(vp[:, None, None] * ph[..., None, :], -1)
    behind = lc[..., 3] <= 1e-6
    lw = lc[..., 3:4]
    ndc = lc[..., :3] / torch.clamp(torch.abs(lw), min=1e-8) * torch.sign(lw)
    u = (ndc[..., 0] * 0.5 + 0.5) * s
    v = (0.5 - ndc[..., 1] * 0.5) * s
    z_ref = ndc[..., 2] - bias
    inside = (~behind & (u >= 0) & (u < s) & (v >= 0) & (v < s)
              & (torch.abs(ndc[..., 2]) <= 1.0))
    vis = _map_sample(depth_map[:, None],
                      torch.zeros_like(u, dtype=torch.long), u, v, z_ref, s,
                      pcf)
    return torch.where(inside, vis, torch.ones_like(vis))


# the six cube faces: forward axis + up vector (shadow/point.rs:50 renders
# a cube map; here six 90° perspective maps picked by the dominant axis of
# the light → fragment vector)
_CUBE_FACES = (
    ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
    ((-1.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
    ((0.0, 1.0, 0.0), (0.0, 0.0, 1.0)),
    ((0.0, -1.0, 0.0), (0.0, 0.0, 1.0)),
    ((0.0, 0.0, 1.0), (0.0, 1.0, 0.0)),
    ((0.0, 0.0, -1.0), (0.0, 1.0, 0.0)),
)


def point_vps(light_pos, z_near=0.05, z_far=100.0):
    """[..., 6, 4, 4] cube-face view-projections of point lights at
    light_pos [..., 3] (``shadows.py:373``)."""
    dev = light_pos.device
    proj = _perspective_from(value_const(np.pi / 2 + 0.2, dev), z_near,
                             z_far)
    vps = []
    for fwd, up in _CUBE_FACES:
        f = value_const(fwd, dev).expand(light_pos.shape)
        u = value_const(up, dev).expand(light_pos.shape)
        vps.append(tfm.mat4_mul(proj, _look_at(light_pos, f, u)))
    return torch.stack(vps, -3)


def render_point_depths(world_tri_positions, light_pos, map_size,
                        tri_valid=None, z_far=100.0, k_per_tile=512,
                        demand=None):
    """Cube-face depth maps of point lights (``shadows.py:384``), every
    face of every light of every world in one K5 launch. light_pos [W, L,
    3], z_far a Python float or one per light → (vps [W, L, 6, 4, 4],
    maps [W, L, 6, S, S])."""
    w, nl = light_pos.shape[:2]
    zf = z_far if isinstance(z_far, (tuple, list)) else [z_far] * nl
    vps = torch.stack([point_vps(light_pos[:, i], z_far=float(zf[i]))
                       for i in range(nl)], 1)
    maps = render_cascade_depths(world_tri_positions,
                                 vps.reshape(w, nl * 6, 4, 4), map_size,
                                 tri_valid=tri_valid,
                                 k_per_tile=k_per_tile, demand=demand)
    return vps, maps.reshape(w, nl, 6, map_size, map_size)


def point_visibility(world_pos, light_pos, vps, depth_maps, bias=3e-3):
    """Cube-map shadow test (``shadows.py:396``): the face is picked by the
    dominant axis of the light → fragment direction, then a projected
    depth compare on that face. world_pos [W, H, Wd, 3], light_pos [W,
    3], vps [W, 6, 4, 4], depth_maps [W, 6, S, S] → [W, H, Wd]."""
    px = light_pos[:, None, None]
    d = world_pos - px
    dom = torch.argmax(torch.abs(d), -1)
    face = torch.where(
        dom == 0, torch.where(d[..., 0] >= 0, 0, 1),
        torch.where(dom == 1, torch.where(d[..., 1] >= 0, 2, 3),
                    torch.where(d[..., 2] >= 0, 4, 5)))
    s = depth_maps.shape[-1]
    ph = torch.cat([world_pos, torch.ones_like(world_pos[..., :1])], -1)
    # project into all six faces, select before the map gather
    lc = torch.sum(vps[:, None, None] * ph[..., None, None, :], -1)
    lw = lc[..., 3:4]
    ndc = lc[..., :3] / torch.clamp(torch.abs(lw), min=1e-8) * torch.sign(lw)
    nsel = torch.gather(ndc, -2, face[..., None, None].expand(
        *face.shape, 1, 3))[..., 0, :]
    u = (nsel[..., 0] * 0.5 + 0.5) * s
    v = (0.5 - nsel[..., 1] * 0.5) * s
    vis = _map_sample(depth_maps, face, u, v, nsel[..., 2] - bias, s,
                      pcf=False)
    return torch.where(torch.abs(nsel[..., 2]) <= 1.0, vis,
                       torch.ones_like(vis))
