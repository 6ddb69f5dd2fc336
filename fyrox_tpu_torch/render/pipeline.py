"""Frame rendering: cull → G-buffer → shadows → deferred shade →
forward pass (the port of ``fyrox_tpu.render.pipeline``), and the frame
captured as one CUDA graph (``CapturedFrame``).

Equivalent of the reference's Renderer::render_frame chain
(fyrox-impl/src/renderer/mod.rs:1384 → frustum culling bundle.rs:873-929 →
GBuffer::fill gbuffer.rs:57 → DeferredLightRenderer light.rs:254 → CSM
csm.rs, spot / point shadow maps, light volumes, skybox, the forward pass
mod.rs:1066-1115). One RenderTemplate is built per scene; ``render_frame``
renders every world of a batched WorldState at once (the JAX package vmaps
one world; here the world axis is written out), on the device of the
state.

Every feature of the JAX package's frame is here: LOD groups, HZB
occlusion, textured materials, sprites, decals, rectangles, CSM and spot /
point shadow maps, light shafts, the skybox or sky gradient and the
transparent forward pass, in the 2DH ("homogeneous") or the near-clipped
("clipped") raster mode. K5 launches per frame: the camera pass (full),
the cascades, the spot maps and the point-light faces (depth-only, one
launch each over every world), and the occlusion prepass (depth-only); the
camera pass and the prepass take K5's affine variant in clipped mode. The
TPU-only ``edge_mode="mxu"`` raises.
"""
from __future__ import annotations

import time
import types
from dataclasses import dataclass
from functools import cached_property
from typing import NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch._util import const, static_copy, value_const
from fyrox_tpu_torch.core import aabb as aabb_mod
from fyrox_tpu_torch.core import frustum as frustum_mod
from fyrox_tpu_torch.core import transform as tfm
from fyrox_tpu_torch.render import lighting as lighting_mod
from fyrox_tpu_torch.render import occlusion as occ_mod
from fyrox_tpu_torch.render import raster as raster_mod
from fyrox_tpu_torch.render import shadows as shadows_mod
from fyrox_tpu_torch.render import skybox as skybox_mod
from fyrox_tpu_torch.render import tile_raster
from fyrox_tpu_torch.render import transparent as transp_mod
from fyrox_tpu_torch.render import volumetric as vol_mod
from fyrox_tpu_torch.render.texture import (resize_bilinear,
                                            sample_array_bilinear)
from fyrox_tpu_torch.scene import camera as camera_mod
from fyrox_tpu_torch.scene.template import NodeType, SceneTemplate

__all__ = ["RenderConfig", "RenderTemplate", "build_render_template",
           "render_frame", "render_frame_demand", "render_frames_chunked",
           "CapturedFrame"]


class RenderConfig(NamedTuple):
    """``pipeline.py:31`` without the TPU knobs (``use_pallas``,
    ``pallas_interpret``, ``bin_mode``, the streaming raster's ``chunk``):
    the tensors' device decides the route."""
    width: int = 256
    height: int = 256
    sky_zenith: tuple = (0.0, 0.0, 0.0)    # vertical gradient behind the
    sky_horizon: tuple = (0.0, 0.0, 0.0)   # geometry (skybox.rs stand-in)
    shadows: bool = True
    csm: shadows_mod.CsmConfig = shadows_mod.CsmConfig()
    ambient: tuple = (0.05, 0.05, 0.05)
    k_per_tile: int = 512          # max binned triangles per tile
    # per-light shadow maps (renderer/shadow/{spot,point}.rs), opt-in
    spot_shadows: bool = False
    point_shadows: bool = False
    spot_shadow_size: int = 128
    point_shadow_size: int = 64
    # HZB occlusion culling (renderer/occlusion/mod.rs): a depth prepass of
    # the nodes whose local-bbox volume is in the top (1 -
    # occluder_quantile) of mesh nodes (0.0 = every node), max-mip tests
    occlusion: bool = False
    occlusion_size: int = 64
    occluder_quantile: float = 0.75
    light_shafts: bool = False     # renderer/light_volume.rs
    skybox: object = None          # a render.skybox.SkyBox; over the gradient
    # "homogeneous" (2DH, no clip pass) or "clipped" (Sutherland-Hodgman
    # near clipping, 2T binned triangles, K5's affine variant)
    raster_mode: str = "homogeneous"
    # per-cascade caster pre-cull: a fraction of T kept per cascade (0 =
    # off), a scalar for every cascade or a per-cascade tuple
    cascade_tri_budget: object = 0.0
    edge_mode: str = "vpu"         # "mxu" is the TPU's A/B knob: raises
    csm_k_per_tile: int = 0        # bin cap of the CSM pass (0 = k_per_tile)


@dataclass
class RenderTemplate:
    """Static packed geometry: every MESH node's triangles concatenated
    (and two quads per RECTANGLE node), with the owning node per vertex
    and triangle for instancing (``pipeline.py:84``)."""
    positions: np.ndarray    # [V,3] mesh-local
    normals: np.ndarray      # [V,3]
    triangles: np.ndarray    # [T,3] into the packed vertex arrays
    vert_node: np.ndarray    # [V] owning scene node
    tri_node: np.ndarray     # [T]
    albedo: np.ndarray       # [V,3]
    material: np.ndarray     # [V,2] metallic, roughness
    emission: np.ndarray     # [V,3]
    camera_node: int = -1
    fov_y: float = float(np.deg2rad(75.0))
    z_near: float = 0.025
    z_far: float = 2048.0
    cam_ortho: bool = False
    cam_vertical_size: float = 5.0
    light_node: np.ndarray = None        # [L]
    light_kind: np.ndarray = None        # [L]
    light_color: np.ndarray = None       # [L,3]
    light_intensity: np.ndarray = None   # [L]
    light_radius: np.ndarray = None      # [L]
    light_cos_hotspot: np.ndarray = None
    light_cos_falloff: np.ndarray = None
    # sprites (camera-facing billboards, sprite.rs)
    sprite_node: np.ndarray = None       # [S]
    sprite_size: np.ndarray = None       # [S]
    sprite_color: np.ndarray = None      # [S,3]
    # LOD groups (scene/base.rs:61): object node, normalised-distance range
    lod_obj: np.ndarray = None           # [Lo] int32
    lod_begin: np.ndarray = None         # [Lo] f32
    lod_end: np.ndarray = None           # [Lo] f32
    # transparent (forward-pass) triangles: indices into `triangles` and
    # their opacity (meshes with alpha < 1)
    tr_tri: np.ndarray = None            # [Tt] int32
    tr_alpha: np.ndarray = None          # [Tt] f32
    # decals (scene/decal.rs): node, colour, strength
    decal_node: np.ndarray = None        # [D] int32
    decal_color: np.ndarray = None       # [D,3]
    decal_strength: np.ndarray = None    # [D]
    # texture-mapped materials: every scene texture in ONE array at one
    # resolution; per-triangle layers ride the G-buffer's uvt channel
    uvs: np.ndarray = None               # [V,2]
    tex_array: np.ndarray = None         # [NT,R,R,4] or None
    tri_tex: np.ndarray = None           # [T] int32 albedo layer (-1 none)
    tri_mr: np.ndarray = None            # [T] int32 metallic-roughness layer

    @property
    def num_triangles(self):
        return int(self.triangles.shape[0])

    @cached_property
    def frame_tables(self):
        """The host tables a frame indexes with, made once per template so
        that their device copies are made once (``_util.const`` caches by
        the array): the opaque triangle mask and the transparent triangles
        with their nodes (``pipeline.py:428-434``), the sprite colours per
        billboard triangle, and the spot and point lights with their map
        depth ranges."""
        kind = self.light_kind
        tabs = dict(
            opaque=None, tr_triangles=None, tr_node=None,
            sprite_color=(np.repeat(self.sprite_color, 2, axis=0)
                          if self.sprite_node is not None else None),
            spot=np.nonzero(kind == lighting_mod.SPOT)[0],
            point=np.nonzero(kind == lighting_mod.POINT)[0],
            map_far=[float(r) if r > 0 else 100.0
                     for r in np.asarray(self.light_radius, np.float32)])
        if self.tr_tri is not None and self.tr_tri.shape[0]:
            opq = np.ones(self.triangles.shape[0], bool)
            opq[self.tr_tri] = False
            tabs.update(opaque=opq, tr_triangles=self.triangles[self.tr_tri],
                        tr_node=self.tri_node[self.tr_tri])
        return types.SimpleNamespace(**tabs)

    def occluder_mask(self, st: SceneTemplate, quantile: float):
        """The big-occluder triangle mask of the occlusion prepass
        (``pipeline.py:396-409``): triangles of nodes whose local box
        volume reaches the `quantile` of the meshes' volumes; None where
        every triangle occludes. Made once per (scene template, quantile)
        and kept on the template."""
        if st.local_bbox_min is None or quantile <= 0.0:
            return None
        cache = self.__dict__.setdefault("_occluders", {})
        hit = cache.get((id(st), quantile))
        if hit is not None and hit[0] is st:
            return hit[1]
        vol = np.prod(np.maximum(np.asarray(st.local_bbox_max)
                                 - np.asarray(st.local_bbox_min), 0.0), axis=1)
        thresh = np.quantile(vol[np.unique(self.tri_node)],
                             min(max(quantile, 0.0), 1.0))
        mask = vol[self.tri_node] >= thresh
        cache[(id(st), quantile)] = (st, mask)
        return mask


def build_render_template(template: SceneTemplate,
                          camera_index: int = 0) -> RenderTemplate:
    """Pack the MESH payloads, RECTANGLE quads, sprites, decals, LOD
    groups, lights and camera of a SceneTemplate (``pipeline.py:143``)."""
    pos, nrm, tris, vnode, tnode, alb, mat, emi = [], [], [], [], [], [], [], []
    tri_alpha, uvs, tri_tex, tri_mr = [], [], [], []
    textures: list = []         # registered scene textures (dedup by id)
    tex_ids: dict = {}
    voff = 0

    def _register(tex):
        if tex is None:
            return -1
        key = id(tex)
        if key not in tex_ids:
            # Texture objects carry their data in .base; numpy arrays have
            # a .base attribute too (None or a view's parent)
            arr = (tex.base if hasattr(tex, "base")
                   and not isinstance(tex, np.ndarray) else np.asarray(tex))
            tex_ids[key] = len(textures)
            textures.append(np.asarray(arr, np.float32))
        return tex_ids[key]

    def _mesh_tex(mesh, attr, mat_key):
        t = getattr(mesh, attr, None)
        m = getattr(mesh, "material", None)
        if t is None and m is not None and getattr(m, "textures", None):
            t = m.textures.get(mat_key)     # .shader standard names
        return t

    for node_idx in range(template.num_nodes):
        if template.node_type[node_idx] != NodeType.MESH:
            continue
        mesh = template.meshes[template.payload[node_idx]]
        v = mesh.positions.shape[0]
        nt = mesh.triangles.shape[0]
        pos.append(mesh.positions)
        nrm.append(mesh.normals)
        tris.append(mesh.triangles + voff)
        vnode.append(np.full(v, node_idx, np.int32))
        tnode.append(np.full(nt, node_idx, np.int32))
        alb.append(np.tile(np.asarray(mesh.albedo, np.float32), (v, 1)))
        mat.append(np.tile(np.asarray([mesh.metallic, mesh.roughness],
                                      np.float32), (v, 1)))
        emi.append(np.tile(np.asarray(mesh.emission, np.float32), (v, 1)))
        tri_alpha.append(np.full(nt, getattr(mesh, "alpha", 1.0), np.float32))
        muv = getattr(mesh, "uvs", None)
        uvs.append(np.asarray(muv, np.float32) if muv is not None
                   and len(np.shape(muv)) == 2
                   else np.zeros((v, 2), np.float32))
        tri_tex.append(np.full(nt, _register(
            _mesh_tex(mesh, "albedo_texture", "diffuseTexture")), np.int32))
        tri_mr.append(np.full(nt, _register(
            _mesh_tex(mesh, "mr_texture", "metallicRoughnessTexture")),
            np.int32))
        voff += v
    # Rectangle 2D nodes (dim2/rectangle.rs): a unit quad in the node's
    # local XY plane, both windings, emissive (unlit, as the reference's 2D
    # forward path); uv_rect selects the texture's sub-region
    rects = template.rectangles
    for ri, node_idx in enumerate(rects.get("node", [])):
        node_idx = int(node_idx)
        col = np.asarray(rects["color"][ri], np.float32)
        u0, v0, u1, v1 = (float(x) for x in rects["uv_rect"][ri])
        quad = np.asarray([[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0],
                           [0.5, 0.5, 0.0], [-0.5, 0.5, 0.0]], np.float32)
        quv = np.asarray([[u0, v1], [u1, v1], [u1, v0], [u0, v0]],
                         np.float32)
        tri2 = np.asarray([[0, 1, 2], [0, 2, 3],             # front (+Z)
                           [0, 2, 1], [0, 3, 2]], np.int32)  # back
        pos.append(quad)
        nrm.append(np.tile(np.asarray([[0, 0, 1]], np.float32), (4, 1)))
        tris.append(tri2 + voff)
        vnode.append(np.full(4, node_idx, np.int32))
        tnode.append(np.full(4, node_idx, np.int32))
        alb.append(np.tile(col, (4, 1)))
        mat.append(np.zeros((4, 2), np.float32))
        emi.append(np.tile(col, (4, 1)))
        tri_alpha.append(np.ones(4, np.float32))
        uvs.append(quv)
        ti = int(rects["texture"][ri])
        tex = template.rect_textures[ti] if ti >= 0 else None
        tri_tex.append(np.full(4, _register(tex), np.int32))
        tri_mr.append(np.full(4, -1, np.int32))
        voff += 4

    sp = template.sprites
    ns = len(sp.get("node", []))
    if not pos and not ns:
        raise ValueError("scene has no MESH, RECTANGLE or SPRITE nodes "
                         "to render")
    if not pos:                    # sprites only: one empty mesh
        pos = [np.zeros((3, 3), np.float32)]
        nrm = [np.tile(np.asarray([[0, 1, 0]], np.float32), (3, 1))]
        tris = [np.zeros((0, 3), np.int32)]
        vnode = [np.zeros(3, np.int32)]
        tnode = [np.zeros(0, np.int32)]
        alb = [np.zeros((3, 3), np.float32)]
        mat = [np.zeros((3, 2), np.float32)]
        emi = [np.zeros((3, 3), np.float32)]
        tri_alpha = [np.zeros(0, np.float32)]
        uvs = [np.zeros((3, 2), np.float32)]
        tri_tex = [np.zeros(0, np.int32)]
        tri_mr = [np.zeros(0, np.int32)]

    tex_array = None
    if textures:
        r = min(max(max(t.shape[0], t.shape[1]) for t in textures), 512)
        packed = []
        for t in textures:
            if t.ndim == 2:
                t = np.repeat(t[..., None], 4, -1)
            if t.shape[-1] == 3:
                t = np.concatenate([t, np.ones_like(t[..., :1])], -1)
            packed.append(resize_bilinear(t, r))
        tex_array = np.stack(packed).astype(np.float32)

    cams = template.cameras
    cam_node = int(cams["node"][camera_index]) if len(cams["node"]) else -1
    has_cam = cam_node >= 0
    li = template.lights
    nl = len(li["node"]) if li and len(li.get("node", [])) else 0
    f32 = np.float32
    dec = template.decals
    nd = len(dec.get("node", []))
    alpha = np.concatenate(tri_alpha)
    return RenderTemplate(
        positions=np.concatenate(pos).astype(f32),
        normals=np.concatenate(nrm).astype(f32),
        triangles=np.concatenate(tris).astype(np.int32),
        vert_node=np.concatenate(vnode),
        tri_node=np.concatenate(tnode),
        albedo=np.concatenate(alb),
        material=np.concatenate(mat),
        emission=np.concatenate(emi),
        camera_node=cam_node,
        fov_y=(float(cams["fov"][camera_index]) if has_cam
               else np.deg2rad(75.0)),
        z_near=float(cams["z_near"][camera_index]) if has_cam else 0.025,
        z_far=float(cams["z_far"][camera_index]) if has_cam else 2048.0,
        cam_ortho=bool(cams["ortho"][camera_index]) if has_cam else False,
        cam_vertical_size=(float(cams["vertical_size"][camera_index])
                           if has_cam else 5.0),
        light_node=(np.asarray(li["node"], np.int32) if nl
                    else np.zeros(0, np.int32)),
        light_kind=(np.asarray(li["kind"], np.int32) if nl
                    else np.zeros(0, np.int32)),
        light_color=(np.stack(li["color"]).astype(f32) if nl
                     else np.zeros((0, 3), f32)),
        light_intensity=(np.asarray(li["intensity"], f32) if nl
                         else np.zeros(0)),
        light_radius=np.asarray(li["radius"], f32) if nl else np.zeros(0),
        light_cos_hotspot=(np.cos(np.asarray(li["hotspot"], f32) * 0.5)
                           if nl else np.zeros(0)),
        light_cos_falloff=(np.cos(np.asarray(li["hotspot"], f32) * 0.5
                                  + np.asarray(li["falloff_delta"], f32))
                           if nl else np.zeros(0)),
        sprite_node=(np.asarray(sp["node"], np.int32) if ns
                     else np.zeros(0, np.int32)),
        sprite_size=(np.asarray(sp["size"], f32) if ns
                     else np.zeros(0, f32)),
        sprite_color=(np.stack(sp["color"]).astype(f32) if ns
                      else np.zeros((0, 3), f32)),
        uvs=np.concatenate(uvs).astype(f32),
        tex_array=tex_array,
        tri_tex=np.concatenate(tri_tex),
        tri_mr=np.concatenate(tri_mr),
        tr_tri=np.flatnonzero(alpha < 0.999).astype(np.int32),
        tr_alpha=alpha[alpha < 0.999].astype(f32),
        decal_node=np.asarray(dec["node"], np.int32) if nd else None,
        decal_color=np.stack(dec["color"]).astype(f32) if nd else None,
        decal_strength=np.asarray(dec["strength"], f32) if nd else None,
        **_flatten_lod(template),
    )


def _flatten_lod(template):
    """Builder-attached LOD groups (LodGroup, scene/base.rs:129) flattened
    into per-object (node, begin, end) arrays for the culling pass."""
    obj, beg, end = [], [], []
    for levels in template.extras.get("lod_groups", []):
        for b, e, objects in levels:
            b, e = sorted((float(np.clip(b, 0, 1)), float(np.clip(e, 0, 1))))
            for o in objects:
                obj.append(int(o))
                beg.append(b)
                end.append(e)
    return dict(lod_obj=np.asarray(obj, np.int32),
                lod_begin=np.asarray(beg, np.float32),
                lod_end=np.asarray(end, np.float32))


def _check_scope(config: RenderConfig):
    if config.edge_mode != "vpu":
        raise NotImplementedError(
            f'edge_mode={config.edge_mode!r}: the MXU edge evaluation is an '
            'A/B knob of the TPU kernel; the port evaluates the forms in '
            'K5 ("vpu")')


def _cat_rows(a, b, w):
    """Concatenate per-triangle rows, [T, 3, C] (static) or [W, T, 3, C],
    of two tables along T; two static tables stay static."""
    if a.dim() == b.dim() == 3:
        return torch.cat([a, b], 0)
    a = a.expand(w, *a.shape) if a.dim() == 3 else a
    b = b.expand(w, *b.shape) if b.dim() == 3 else b
    return torch.cat([a, b], 1)


def _frame(globals_, gvis, rt: RenderTemplate, st: SceneTemplate,
           config: RenderConfig, demand=None, footprint=None):
    """Render every world: globals_ [W, N, 4, 4], gvis [W, N] → (color [W,
    H, Wd, 3], GBuffer batch) (``pipeline.py:336``, its sections in its
    order)."""
    _check_scope(config)
    dev = globals_.device
    w = globals_.shape[0]
    tabs = rt.frame_tables
    aspect = config.width / config.height
    cam_g = globals_[:, rt.camera_node]
    cam_pos = cam_g[:, :3, 3]
    view = camera_mod.view_matrix(cam_g)
    if rt.cam_ortho:
        proj = camera_mod.orthographic(rt.cam_vertical_size, aspect,
                                       rt.z_near, rt.z_far, dev)
    else:
        proj = camera_mod.perspective(rt.fov_y, aspect, rt.z_near, rt.z_far,
                                      dev)
    vp = tfm.mat4_mul(proj, view)                             # [W, 4, 4]

    # instance transforms → world-space vertices and normals
    vg = globals_[:, const(rt.vert_node, dev).long()]         # [W, V, 4, 4]
    wpos = tfm.transform_point(vg, const(rt.positions, dev))
    wn = tfm.transform_vector(vg, const(rt.normals, dev))
    wn = wn / torch.clamp(torch.linalg.norm(wn, dim=-1, keepdim=True),
                          min=1e-8)
    tri = const(rt.triangles, dev).long()
    tri_node = const(rt.tri_node, dev).long()
    tri_pos = wpos[:, tri]                                    # [W, T, 3, 3]
    clip = raster_mod.transform_clip(wpos, vp)                # [W, V, 4]
    tri_clip = clip[:, tri]                                   # [W, T, 3, 4]

    # per-node culling: frustum test on world AABBs + visibility flags
    planes = frustum_mod.from_view_projection(vp)
    if st.local_bbox_min is not None:
        wmin, wmax = aabb_mod.transform(const(st.local_bbox_min, dev),
                                        const(st.local_bbox_max, dev),
                                        globals_)
        node_vis = frustum_mod.intersects_aabb(planes[:, None], wmin, wmax)
    else:
        node_vis = torch.ones(globals_.shape[:2], dtype=torch.bool,
                              device=dev)
    node_vis = node_vis & gvis

    # LOD filter (renderer/bundle.rs:898): a listed object shows where its
    # normalised camera distance lies in its level's range, and hides its
    # subtree (bundle.rs:994) through the pointer-doubling tables
    if rt.lod_obj is not None and rt.lod_obj.shape[0]:
        obj = const(rt.lod_obj, dev).long()
        dist = torch.linalg.norm(globals_[:, obj, :3, 3] - cam_pos[:, None],
                                 dim=-1)
        nd = (dist - rt.z_near) / max(rt.z_far - rt.z_near, 1e-6)
        in_range = ((nd >= const(rt.lod_begin, dev))
                    & (nd <= const(rt.lod_end, dev)))
        lod_vis = torch.ones((w, globals_.shape[1] + 1), dtype=torch.bool,
                             device=dev)
        lod_vis[:, obj] = in_range
        for p_r in st.doubling_pointers():
            lod_vis = lod_vis & lod_vis[:, const(p_r, dev)]
        node_vis = node_vis & lod_vis[:, :-1]

    # HZB occlusion culling (renderer/occlusion/mod.rs:60): a depth prepass
    # of the big occluders, then the nodes' boxes against its pyramid
    if config.occlusion and st.local_bbox_min is not None:
        os_ = config.occlusion_size
        pre_valid = node_vis[:, tri_node]
        occluders = rt.occluder_mask(st, config.occluder_quantile)
        if occluders is not None:
            pre_valid = pre_valid & const(occluders, dev)
        pre_depth = tile_raster.rasterize_tiled(
            tri_clip, {}, os_, os_, tri_valid=pre_valid,
            k_per_tile=config.k_per_tile, depth_only=True,
            mode=config.raster_mode, demand=demand)
        node_vis = node_vis & occ_mod.occlusion_visible(
            wmin, wmax, vp, occ_mod.build_hzb(pre_depth), os_, os_)

    tri_valid = node_vis[:, tri_node]
    # transparent triangles skip the deferred pass (RenderPath::Forward,
    # renderer/mod.rs:1066) and composite after shading, below
    if tabs.opaque is not None:
        tri_valid = tri_valid & const(tabs.opaque, dev)

    attrs = dict(albedo=const(rt.albedo, dev)[tri], normal=wn[:, tri],
                 position=tri_pos, material=const(rt.material, dev)[tri],
                 emission=const(rt.emission, dev)[tri])
    textured = rt.tex_array is not None
    if textured:
        # (u, v, albedo layer, mr layer) per vertex: the layers are
        # per-triangle constants, which interpolation returns exactly; the
        # deferred pass samples the texture array at shade time
        uv_tri = const(rt.uvs, dev)[tri]                      # [T, 3, 2]
        layers = torch.stack([const(rt.tri_tex, dev, torch.float32),
                              const(rt.tri_mr, dev, torch.float32)], -1)
        attrs["uvt"] = torch.cat([uv_tri, layers[:, None, :].expand(
            -1, 3, -1)], -1)

    # sprites: camera-facing billboards (sprite.rs), two triangles each
    n_sprites = rt.sprite_node.shape[0] if rt.sprite_node is not None else 0
    if n_sprites:
        snode = const(rt.sprite_node, dev).long()
        centers = globals_[:, snode, :3, 3]                   # [W, S, 3]
        right, up = view[:, None, 0, :3], view[:, None, 1, :3]
        fwd = -view[:, 2, :3]
        size = const(rt.sprite_size, dev)[None, :, None]
        c00 = centers - right * size - up * size
        c10 = centers + right * size - up * size
        c11 = centers + right * size + up * size
        c01 = centers - right * size + up * size
        # wound front-facing toward the camera
        sp_pos = torch.stack([torch.stack([c00, c10, c11], 2),
                              torch.stack([c00, c11, c01], 2)],
                             2).reshape(w, -1, 3, 3)          # [W, 2S, 3, 3]
        sp_clip = raster_mod.transform_clip(
            sp_pos.reshape(w, -1, 3), vp).reshape(w, -1, 3, 4)
        col = const(tabs.sprite_color, dev)[:, None].expand(-1, 3, -1)
        sp_attrs = dict(
            albedo=col,
            normal=(-fwd)[:, None, None].expand(sp_pos.shape),
            position=sp_pos,
            material=torch.zeros(col.shape[:2] + (2,), device=dev),
            emission=col)                   # unlit billboards
        if textured:
            sp_attrs["uvt"] = torch.cat(
                [torch.zeros(col.shape[:2] + (2,), device=dev),
                 torch.full(col.shape[:2] + (2,), -1.0, device=dev)], -1)
        tri_clip = torch.cat([tri_clip, sp_clip], 1)
        attrs = {k: _cat_rows(attrs[k], sp_attrs[k], w) for k in attrs}
        # each sprite's flag for its two triangles by an expand, which
        # reads nothing back from the card (a captured frame must not)
        s_vis = node_vis[:, snode]
        tri_valid = torch.cat([tri_valid, s_vis[..., None].expand(
            -1, -1, 2).reshape(w, -1)], 1)
        tri_pos = torch.cat([tri_pos, sp_pos], 1)
    gbuf = tile_raster.rasterize_tiled(tri_clip, attrs, config.height,
                                       config.width, tri_valid=tri_valid,
                                       k_per_tile=config.k_per_tile,
                                       demand=demand, mode=config.raster_mode)

    # texture-mapped materials (gbuffer.rs:57): albedo maps multiply the
    # albedo, metallic-roughness maps' RG the material
    if textured and gbuf.uvt is not None:
        uv_px = gbuf.uvt[..., :2]
        tid_a = torch.round(gbuf.uvt[..., 2]).to(torch.int32)
        tid_m = torch.round(gbuf.uvt[..., 3]).to(torch.int32)
        tex = const(rt.tex_array, dev)
        sa = sample_array_bilinear(tex, torch.clamp(tid_a, min=0), uv_px)
        sm = sample_array_bilinear(tex, torch.clamp(tid_m, min=0), uv_px)
        has_a = ((tid_a >= 0) & gbuf.mask)[..., None]
        has_m = ((tid_m >= 0) & gbuf.mask)[..., None]
        gbuf = gbuf._replace(
            albedo=torch.where(has_a, gbuf.albedo * sa[..., :3], gbuf.albedo),
            material=torch.where(has_m, gbuf.material * sm[..., :2],
                                 gbuf.material))

    # decals (renderer/decal.rs): colour projected into the G-buffer inside
    # each decal node's unit cube, before lighting
    if rt.decal_node is not None:
        inv = tfm.invert_affine(globals_[:, const(rt.decal_node, dev).long()])
        for di in range(rt.decal_node.shape[0]):
            pl = tfm.transform_point(inv[:, di, None, None], gbuf.position)
            inside = (torch.all(torch.abs(pl) <= 0.5, -1) & gbuf.mask
                      & node_vis[:, int(rt.decal_node[di]), None, None])
            w_d = inside.to(torch.float32)[..., None] * float(
                rt.decal_strength[di])
            gbuf = gbuf._replace(albedo=gbuf.albedo * (1 - w_d)
                                 + const(rt.decal_color, dev)[di] * w_d)

    nl = rt.light_node.shape[0]
    lights = None
    if nl:
        lg = globals_[:, const(rt.light_node, dev).long()]    # [W, L, 4, 4]
        lpos = lg[..., :3, 3]
        ldir = lg[..., :3, 2]       # the light looks along +Z, like cameras
        ldir = ldir / torch.clamp(torch.linalg.norm(ldir, dim=-1,
                                                    keepdim=True), min=1e-8)
        kind = rt.light_kind
        lights = lighting_mod.LightSet(
            kind=kind, position=lpos, direction=ldir,
            color=const(rt.light_color, dev),
            intensity=const(rt.light_intensity, dev),
            radius=const(rt.light_radius, dev),
            cos_hotspot=const(rt.light_cos_hotspot, dev, torch.float32),
            cos_falloff=const(rt.light_cos_falloff, dev, torch.float32),
            enabled=(node_vis[:, const(rt.light_node, dev).long()]
                     | (const(kind, dev) == lighting_mod.DIRECTIONAL)))
        shadow_fns = {}
        if config.shadows and np.any(kind == lighting_mod.DIRECTIONAL):
            di = int(np.nonzero(kind == lighting_mod.DIRECTIONAL)[0][0])
            z_far = min(rt.z_far, 100.0)
            cascade_vps = shadows_mod.fit_cascades(
                view, rt.fov_y, aspect, rt.z_near, z_far, ldir[:, di],
                config.csm)
            depth_maps = shadows_mod.render_cascade_depths(
                tri_pos, cascade_vps, config.csm.map_size,
                tri_valid=tri_valid,
                k_per_tile=config.csm_k_per_tile or config.k_per_tile,
                tri_budget=config.cascade_tri_budget, demand=demand,
                footprint=footprint)
            shadow_fns[di] = lambda p: shadows_mod.csm_visibility(
                p, view, cascade_vps, depth_maps, z_far, config.csm)
        if config.shadows and config.spot_shadows and len(tabs.spot):
            svps = torch.stack([shadows_mod.spot_vp(
                lpos[:, si], ldir[:, si], lights.cos_falloff[si],
                z_far=tabs.map_far[si]) for si in tabs.spot], 1)
            smaps = shadows_mod.render_cascade_depths(
                tri_pos, svps, config.spot_shadow_size, tri_valid=tri_valid,
                k_per_tile=config.k_per_tile, demand=demand)
            for j, si in enumerate(tabs.spot):
                shadow_fns[int(si)] = (
                    lambda p, j=j: shadows_mod.map_visibility(
                        p, svps[:, j], smaps[:, j]))
        if config.shadows and config.point_shadows and len(tabs.point):
            pvps, pmaps = shadows_mod.render_point_depths(
                tri_pos, lpos[:, const(tabs.point, dev)],
                config.point_shadow_size,
                tri_valid=tri_valid,
                z_far=[tabs.map_far[pi] for pi in tabs.point],
                k_per_tile=config.k_per_tile, demand=demand)
            for j, pi in enumerate(tabs.point):
                shadow_fns[int(pi)] = (
                    lambda p, j=j, pi=int(pi): shadows_mod.point_visibility(
                        p, lpos[:, pi], pvps[:, j], pmaps[:, j]))
        color = lighting_mod.shade(
            gbuf, lights, cam_pos, ambient=config.ambient,
            shadow_fn=(lambda li, p: shadow_fns[li](p) if li in shadow_fns
                       else None) if shadow_fns else None)
    else:
        color = gbuf.albedo * gbuf.mask[..., None]

    # volumetric light shafts (light_volume.rs)
    if config.light_shafts and nl:
        for li in range(nl):
            lp4 = torch.cat([lpos[:, li], torch.ones_like(lpos[:, li, :1])],
                            -1)
            lclip = torch.sum(vp * lp4[:, None, :], -1)
            color = vol_mod.light_shafts(
                color, gbuf.mask, lclip,
                const(rt.light_color, dev)[li]
                * const(rt.light_intensity, dev)[li] * 0.25)

    # the sky behind the geometry (skybox.rs; the gradient otherwise)
    if config.skybox is not None:
        color = skybox_mod.apply_skybox(color, gbuf.mask, config.skybox,
                                        cam_g, rt.fov_y, aspect)
    elif any(v > 0 for v in config.sky_zenith) or any(
            v > 0 for v in config.sky_horizon):
        ys = torch.linspace(0.0, 1.0, config.height, device=dev)[:, None,
                                                                 None]
        sky = (value_const(tuple(config.sky_zenith), dev) * (1 - ys)
               + value_const(tuple(config.sky_horizon), dev) * ys)
        color = torch.where(gbuf.mask[..., None], color,
                            torch.broadcast_to(sky, color.shape))

    # forward / transparent pass (renderer/mod.rs:1066-1115)
    if tabs.tr_triangles is not None:
        tri_t = const(tabs.tr_triangles, dev).long()
        color = transp_mod.composite_transparent(
            color, gbuf.depth, gbuf.mask, clip[:, tri_t],
            dict(albedo=const(rt.albedo, dev)[tri_t], normal=wn[:, tri_t],
                 position=wpos[:, tri_t]),
            const(rt.tr_alpha, dev), config.height, config.width,
            lights=lights, cam_pos=cam_pos, ambient=config.ambient,
            tri_valid=node_vis[:, const(tabs.tr_node, dev).long()])
    return color, gbuf


def render_frame(scene_state, scene_template: SceneTemplate,
                 rt: RenderTemplate, config: RenderConfig = RenderConfig()):
    """Render every world of a WorldState: [W, H, Wd, 3] color + GBuffer
    batch, on the state's device (``pipeline.py:666``)."""
    return _frame(scene_state.globals_, scene_state.global_visibility, rt,
                  scene_template, config)


def render_frame_demand(scene_state, scene_template: SceneTemplate,
                        rt: RenderTemplate,
                        config: RenderConfig = RenderConfig(),
                        footprint=None):
    """render_frame + the per-pass bin-demand audit (``pipeline.py:673``).

    Returns (color [W, H, Wd, 3], demand [W, P] int32, caps [P]), the
    passes in the JAX trace's order: the occlusion prepass, the camera
    pass, one entry per cascade, per spot light, then per point-light face.
    demand[w, p] is pass p's true largest per-tile overlap in world w
    before the clamp to caps[p]; any demand >= cap means the binning
    dropped triangles and the frame is wrong. The cascades bin together
    in one launch at one cap, as do the spot maps and the point faces.
    Where `footprint` is a list, each culled cascade's (in-footprint count
    [W], budget) is appended."""
    passes = []
    color, _ = _frame(scene_state.globals_, scene_state.global_visibility,
                      rt, scene_template, config, demand=passes,
                      footprint=footprint)
    dev = scene_state.globals_.device
    demand = (torch.stack([d.to(torch.int32) for d, _ in passes], 1)
              if passes else torch.zeros((color.shape[0], 0),
                                         dtype=torch.int32, device=dev))
    return color, demand, [int(k) for _, k in passes]


def render_frames_chunked(scene_state, scene_template: SceneTemplate,
                          rt: RenderTemplate,
                          config: RenderConfig = RenderConfig(),
                          world_chunk: int = 16):
    """render_frame over groups of `world_chunk` worlds, one group after
    another (``pipeline.py:705``): the same output with the per-frame
    temporaries of one group at a time. W must divide by world_chunk."""
    g, vis = scene_state.globals_, scene_state.global_visibility
    w = g.shape[0]
    if w <= world_chunk:
        return render_frame(scene_state, scene_template, rt, config)
    if w % world_chunk:
        raise ValueError(f"render_frames_chunked: {w} worlds do not divide "
                         f"into groups of {world_chunk}")
    outs = [_frame(g[i:i + world_chunk], vis[i:i + world_chunk], rt,
                   scene_template, config) for i in range(0, w, world_chunk)]
    color = torch.cat([c for c, _ in outs])
    gbuf = raster_mod.GBuffer(*(
        None if parts[0] is None else torch.cat(parts)
        for parts in zip(*(b for _, b in outs))))
    return color, gbuf


class CapturedFrame:
    """``render_frame`` as one CUDA graph a (device, W): the counterpart of
    ``jax.jit(lambda s: render_frame(s, t, rt, cfg))``.

    ``frame(scene_state)`` returns what ``render_frame(scene_state,
    scene_template, rt, config)`` returns, bit for bit: (color [W, H, Wd,
    3], GBuffer). CPU tensors take ``render_frame``. On the card, the first
    call for a (device, W) captures the frame (``FrameGraph``); a call
    copies the state's global matrices and visibility into the graph's
    static buffers, replays it and clones its outputs out. Every feature
    and both raster modes capture; ``render_frame_demand`` and
    ``render_frames_chunked`` stay eager. The K5 wrappers' launch counters
    count a capture's warm-up frame and its capture, not its replays."""

    def __init__(self, scene_template: SceneTemplate, rt: RenderTemplate,
                 config: RenderConfig = RenderConfig()):
        _check_scope(config)
        self.scene_template, self.rt, self.config = scene_template, rt, config
        self.graphs = {}

    def graph(self, scene_state) -> "FrameGraph":
        """The captured frame for this state's device and W (captured here
        on first use)."""
        g = scene_state.globals_
        key = (str(g.device), int(g.shape[0]))
        fg = self.graphs.get(key)
        if fg is None:
            fg = FrameGraph(self, scene_state)
            self.graphs[key] = fg
        return fg

    def __call__(self, scene_state):
        if not scene_state.globals_.is_cuda:
            return render_frame(scene_state, self.scene_template, self.rt,
                                self.config)
        return self.graph(scene_state).run(scene_state)


class FrameGraph:
    """One frame captured on static copies of ``globals_`` and
    ``global_visibility``.

    Before the capture, one eager frame on the static buffers (its result
    dropped) runs on the stream the capture then uses: it builds the host
    tables and device constants a frame makes on first use (a capture
    copies nothing from the host) and K5's scratch for that stream (plan
    and slices), which this graph then keeps for itself
    (``tile_raster.take_scratch``): no eager launch and no other graph
    writes it, and it lives as long as the graph. Records the capture's
    seconds and the bytes its private memory pool took."""

    def __init__(self, frame: CapturedFrame, scene_state):
        self.globals_ = static_copy(scene_state.globals_)
        self.visibility = static_copy(scene_state.global_visibility)
        args = (frame.rt, frame.scene_template, frame.config)
        self._frame = lambda: _frame(self.globals_, self.visibility, *args)
        dev = self.globals_.device
        with torch.cuda.device(dev):
            stream = torch.cuda.Stream(dev)
            key = stream.cuda_stream
            tile_raster.take_scratch(dev, key)     # none shared from before
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                self._frame()
            torch.cuda.current_stream(dev).wait_stream(stream)
            torch.cuda.synchronize(dev)
            self.graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            with torch.cuda.graph(self.graph, stream=stream):
                # read inside: entering a capture empties the allocator's
                # cache
                reserved = torch.cuda.memory_reserved(dev)
                self.out = self._frame()
            torch.cuda.synchronize(dev)
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.scratch = tile_raster.take_scratch(dev, key)

    def run(self, scene_state):
        """Copy the state in, replay, clone the outputs out."""
        if (scene_state.globals_.shape != self.globals_.shape
                or scene_state.global_visibility.shape
                != self.visibility.shape):
            raise ValueError("CapturedFrame: the state's shapes differ from "
                             "the captured frame's")
        self.globals_.copy_(scene_state.globals_)
        self.visibility.copy_(scene_state.global_visibility)
        with torch.cuda.device(self.globals_.device):
            self.graph.replay()
        color, gbuf = self.out
        return color.clone(), raster_mod.GBuffer(
            *(None if x is None else x.clone() for x in gbuf))
