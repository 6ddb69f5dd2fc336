"""Frame rendering: cull → G-buffer → CSM → deferred shade (the port of
the deferred + CSM path of ``fyrox_tpu.render.pipeline``).

Equivalent of the reference's Renderer::render_frame chain
(fyrox-impl/src/renderer/mod.rs:1384 → frustum culling bundle.rs:873-929 →
GBuffer::fill gbuffer.rs:57 → DeferredLightRenderer light.rs:254 → CSM
csm.rs). One RenderTemplate is built per scene; ``render_frame`` renders
every world of a batched WorldState at once (the JAX package vmaps one
world; here the world axis is written out), on the device of the state.

A frame makes two K5 launches: the camera pass (full) and every cascade
of every world (depth-only). The features this slice does not carry raise
``NotImplementedError``: occlusion, spot / point shadow maps, light shafts,
skyboxes and the sky gradient, ``raster_mode="clipped"`` and
``edge_mode="mxu"`` here; textures and transparent meshes in
``build_render_template``; sprites, decals, LOD groups and rectangles in
``convert``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch._util import const
from fyrox_tpu_torch.core import aabb as aabb_mod
from fyrox_tpu_torch.core import frustum as frustum_mod
from fyrox_tpu_torch.core import transform as tfm
from fyrox_tpu_torch.render import lighting as lighting_mod
from fyrox_tpu_torch.render import raster as raster_mod
from fyrox_tpu_torch.render import shadows as shadows_mod
from fyrox_tpu_torch.render import tile_raster
from fyrox_tpu_torch.scene import camera as camera_mod
from fyrox_tpu_torch.scene.template import NodeType, SceneTemplate

__all__ = ["RenderConfig", "RenderTemplate", "build_render_template",
           "render_frame", "render_frame_demand"]


class RenderConfig(NamedTuple):
    """``pipeline.py:31`` without the TPU knobs (``use_pallas``,
    ``pallas_interpret``, ``bin_mode``, the streaming raster's ``chunk``):
    the tensors' device decides the route. The switches of features off
    this slice are kept so that asking for one raises; their sizes are
    not."""
    width: int = 256
    height: int = 256
    sky_zenith: tuple = (0.0, 0.0, 0.0)
    sky_horizon: tuple = (0.0, 0.0, 0.0)
    shadows: bool = True
    csm: shadows_mod.CsmConfig = shadows_mod.CsmConfig()
    ambient: tuple = (0.05, 0.05, 0.05)
    k_per_tile: int = 512          # max binned triangles per tile
    spot_shadows: bool = False
    point_shadows: bool = False
    occlusion: bool = False
    light_shafts: bool = False
    skybox: object = None
    raster_mode: str = "homogeneous"
    # per-cascade caster pre-cull: a fraction of T kept per cascade (0 =
    # off), a scalar for every cascade or a per-cascade tuple
    cascade_tri_budget: object = 0.0
    edge_mode: str = "vpu"
    csm_k_per_tile: int = 0        # bin cap of the CSM pass (0 = k_per_tile)


@dataclass
class RenderTemplate:
    """Static packed geometry: every MESH node's triangles concatenated,
    with the owning node per vertex and triangle for instancing."""
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

    @property
    def num_triangles(self):
        return int(self.triangles.shape[0])


def build_render_template(template: SceneTemplate,
                          camera_index: int = 0) -> RenderTemplate:
    """Pack all MESH payloads of a SceneTemplate, its lights and camera
    (``pipeline.py:143``). Textured and transparent meshes raise."""
    pos, nrm, tris, vnode, tnode, alb, mat, emi = [], [], [], [], [], [], [], []
    voff = 0
    for node_idx in range(template.num_nodes):
        if template.node_type[node_idx] != NodeType.MESH:
            continue
        mesh = template.meshes[template.payload[node_idx]]
        if any(getattr(mesh, k, None) is not None
               for k in ("albedo_texture", "mr_texture", "material")):
            raise NotImplementedError("texture-mapped materials")
        if getattr(mesh, "alpha", 1.0) < 0.999:
            raise NotImplementedError("transparent meshes (forward pass)")
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
        voff += v
    if not pos:
        raise ValueError("scene has no MESH nodes to render")
    cams = template.cameras
    has_cam = len(cams.get("node", [])) > 0
    cam = (lambda k, default: type(default)(cams[k][camera_index])
           if has_cam else default)
    li = template.lights
    nl = len(li.get("node", [])) if li else 0
    f32 = np.float32
    hotspot = np.asarray(li["hotspot"], f32) if nl else np.zeros(0, f32)
    return RenderTemplate(
        positions=np.concatenate(pos).astype(f32),
        normals=np.concatenate(nrm).astype(f32),
        triangles=np.concatenate(tris).astype(np.int32),
        vert_node=np.concatenate(vnode),
        tri_node=np.concatenate(tnode),
        albedo=np.concatenate(alb),
        material=np.concatenate(mat),
        emission=np.concatenate(emi),
        camera_node=int(cams["node"][camera_index]) if has_cam else -1,
        fov_y=cam("fov", float(np.deg2rad(75.0))),
        z_near=cam("z_near", 0.025),
        z_far=cam("z_far", 2048.0),
        cam_ortho=cam("ortho", False),
        cam_vertical_size=cam("vertical_size", 5.0),
        light_node=(np.asarray(li["node"], np.int32) if nl
                    else np.zeros(0, np.int32)),
        light_kind=(np.asarray(li["kind"], np.int32) if nl
                    else np.zeros(0, np.int32)),
        light_color=(np.stack(li["color"]).astype(f32) if nl
                     else np.zeros((0, 3), f32)),
        light_intensity=(np.asarray(li["intensity"], f32) if nl
                         else np.zeros(0, f32)),
        light_radius=(np.asarray(li["radius"], f32) if nl
                      else np.zeros(0, f32)),
        light_cos_hotspot=np.cos(hotspot * 0.5),
        light_cos_falloff=(np.cos(hotspot * 0.5 + np.asarray(
            li["falloff_delta"], f32)) if nl else np.zeros(0, f32)),
    )


def _check_scope(config: RenderConfig):
    off = [name for name, on in (
        ("occlusion culling", config.occlusion),
        ("spot shadow maps", config.spot_shadows),
        ("point shadow maps", config.point_shadows),
        ("light shafts", config.light_shafts),
        ("skybox", config.skybox is not None),
        ("sky gradient", any(v > 0 for v in config.sky_zenith)
         or any(v > 0 for v in config.sky_horizon)),
        ('raster_mode="clipped"', config.raster_mode != "homogeneous"),
        ('edge_mode="mxu"', config.edge_mode != "vpu")) if on]
    if off:
        raise NotImplementedError(f"render features off the port's slice: "
                                  f"{', '.join(off)}")


def _frame(globals_, gvis, rt: RenderTemplate, st: SceneTemplate,
           config: RenderConfig, demand=None, footprint=None):
    """Render every world: globals_ [W, N, 4, 4], gvis [W, N] →
    (color [W, H, Wd, 3], GBuffer batch) (``pipeline.py:336``)."""
    _check_scope(config)
    dev = globals_.device
    w = globals_.shape[0]
    aspect = config.width / config.height
    cam_g = globals_[:, rt.camera_node]
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
    tri_pos = wpos[:, tri]                                    # [W, T, 3, 3]
    tri_clip = raster_mod.transform_clip(wpos, vp)[:, tri]    # [W, T, 3, 4]

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
    tri_valid = node_vis[:, const(rt.tri_node, dev).long()]

    attrs = dict(albedo=const(rt.albedo, dev)[tri], normal=wn[:, tri],
                 position=tri_pos, material=const(rt.material, dev)[tri],
                 emission=const(rt.emission, dev)[tri])
    gbuf = tile_raster.rasterize_tiled(tri_clip, attrs, config.height,
                                       config.width, tri_valid=tri_valid,
                                       k_per_tile=config.k_per_tile,
                                       demand=demand)

    nl = rt.light_node.shape[0]
    if not nl:
        return gbuf.albedo * gbuf.mask[..., None], gbuf
    lg = globals_[:, const(rt.light_node, dev).long()]        # [W, L, 4, 4]
    ldir = lg[..., :3, 2]           # the light looks along +Z, like cameras
    ldir = ldir / torch.clamp(torch.linalg.norm(ldir, dim=-1, keepdim=True),
                              min=1e-8)
    kind = rt.light_kind
    lights = lighting_mod.LightSet(
        kind=kind, position=lg[..., :3, 3], direction=ldir,
        color=const(rt.light_color, dev),
        intensity=const(rt.light_intensity, dev),
        radius=const(rt.light_radius, dev),
        cos_hotspot=const(rt.light_cos_hotspot, dev, torch.float32),
        cos_falloff=const(rt.light_cos_falloff, dev, torch.float32),
        enabled=(node_vis[:, const(rt.light_node, dev).long()]
                 | (const(kind, dev) == lighting_mod.DIRECTIONAL)))

    shadow_fn = None
    if config.shadows and np.any(kind == lighting_mod.DIRECTIONAL):
        di = int(np.nonzero(kind == lighting_mod.DIRECTIONAL)[0][0])
        z_far = min(rt.z_far, 100.0)
        cascade_vps = shadows_mod.fit_cascades(
            view, rt.fov_y, aspect, rt.z_near, z_far, ldir[:, di],
            config.csm)
        depth_maps = shadows_mod.render_cascade_depths(
            tri_pos, cascade_vps, config.csm.map_size, tri_valid=tri_valid,
            k_per_tile=config.csm_k_per_tile or config.k_per_tile,
            tri_budget=config.cascade_tri_budget, demand=demand,
            footprint=footprint)

        def shadow_fn(li, world_pos):
            if li != di:
                return None
            return shadows_mod.csm_visibility(world_pos, view, cascade_vps,
                                              depth_maps, z_far, config.csm)

    color = lighting_mod.shade(gbuf, lights, cam_g[:, :3, 3],
                               ambient=config.ambient, shadow_fn=shadow_fn)
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

    Returns (color [W, H, Wd, 3], demand [W, P] int32, caps [P]): P = the
    camera pass + one entry per cascade; demand[w, p] is pass p's true
    largest per-tile overlap in world w before the clamp to caps[p]. Any
    demand >= cap means the binning dropped triangles and the frame is
    wrong. The audit reads the passes the frame runs (the cascades bin
    together in one launch, at one cap). Where `footprint` is a list,
    each culled cascade's (in-footprint count [W], budget) is appended."""
    passes = []
    color, _ = _frame(scene_state.globals_, scene_state.global_visibility,
                      rt, scene_template, config, demand=passes,
                      footprint=footprint)
    dev = scene_state.globals_.device
    demand = (torch.stack([d.to(torch.int32) for d, _ in passes], 1)
              if passes else torch.zeros((color.shape[0], 0),
                                         dtype=torch.int32, device=dev))
    return color, demand, [int(k) for _, k in passes]
