"""Carry templates and state from the JAX package into the port.

The JAX package's templates are host numpy dataclasses (its curve tables
may be device arrays; ``np.asarray`` reads them) and its state is a pytree
that the caller turns into numpy, e.g.
``jax.tree_util.tree_map(np.asarray, engine_state)``. This module reads
both by attribute — it never imports JAX — and rebuilds the port's
templates and state on a given device, so both packages can step the same
inputs. Textures, materials and skyboxes become the port's own, so the same
template renders the same frame in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from fyrox_tpu_torch._util import resolve_device
from fyrox_tpu_torch.animation.blendspace import BlendSpaceTemplate
from fyrox_tpu_torch.animation.machine import (LayeredMachine, LayerSpec,
                                               MachineState, MachineTemplate)
from fyrox_tpu_torch.animation.rootmotion import (RootMotionData,
                                                  RootMotionSettings,
                                                  RootMotionState)
from fyrox_tpu_torch.animation.skinning import SkinTemplate
from fyrox_tpu_torch.animation.track import AnimationSet, AnimationState
from fyrox_tpu_torch.core.curve import CurveSet
from fyrox_tpu_torch.engine import AnimState, Engine, EngineState
from fyrox_tpu_torch.physics.broadphase import (GridConfig, SlabCandidates,
                                                SlabConfig)
from fyrox_tpu_torch.physics.convex import ConvexSet
from fyrox_tpu_torch.physics.joints import JointSet
from fyrox_tpu_torch.physics.world import PhysicsState, PhysicsTemplate
from fyrox_tpu_torch.render.mesh import MeshData
from fyrox_tpu_torch.render.pipeline import RenderTemplate
from fyrox_tpu_torch.render.skybox import SkyBox
from fyrox_tpu_torch.render.texture import Material, Texture
from fyrox_tpu_torch.scene.particles import ParticleState, ParticleTemplate
from fyrox_tpu_torch.scene.state import WorldState
from fyrox_tpu_torch.scene.template import SceneTemplate
from fyrox_tpu_torch.sound.engine import SourceState

__all__ = ["scene_template", "texture", "material", "skybox",
           "physics_template", "joint_set", "slab_config", "grid_config",
           "broadphase_config",
           "animation_set", "blend_space", "machine_template",
           "layered_machine", "root_motion", "particle_template",
           "skin_template", "engine", "engine_state", "physics_state",
           "scene_state", "render_template", "to_numpy"]


def _np(x):
    return None if x is None else np.asarray(x)


def _copy(src, cls, names):
    return cls(**{n: getattr(src, n) for n in names})


def texture(tex, memo=None):
    """A JAX-package Texture (numpy mips) → the port's; a numpy array or
    None stays as it is. `memo` maps id(source) → the port's object, so
    that a texture two meshes share stays one texture (one layer of the
    texture array)."""
    if tex is None or isinstance(tex, np.ndarray):
        return tex
    memo = {} if memo is None else memo
    if id(tex) not in memo:
        memo[id(tex)] = Texture([np.asarray(m, np.float32)
                                 for m in tex.mips])
    return memo[id(tex)]


def material(m, memo=None) -> Material:
    """A JAX-package Material → the port's, its texture bindings too."""
    if m is None:
        return None
    memo = {} if memo is None else memo
    if id(m) not in memo:
        memo[id(m)] = Material(
            name=m.name, albedo=tuple(m.albedo), metallic=m.metallic,
            roughness=m.roughness, emission=tuple(m.emission),
            textures={k: texture(v, memo) for k, v in m.textures.items()},
            properties=dict(m.properties))
    return memo[id(m)]


def skybox(sky) -> SkyBox:
    """A JAX-package SkyBox → the port's (its faces read as numpy)."""
    return SkyBox(np.asarray(sky.faces))


def _mesh_data(m, memo) -> MeshData:
    """A JAX-package MeshData → the port's, field by field, its textures
    and material converted."""
    out = MeshData(**{f: getattr(m, f) for f in MeshData.__dataclass_fields__})
    out.albedo_texture = texture(m.albedo_texture, memo)
    out.mr_texture = texture(m.mr_texture, memo)
    out.material = material(m.material, memo)
    return out


def scene_template(t) -> SceneTemplate:
    """A JAX-package SceneTemplate → the port's: topology, payload
    routing, cameras, lights, meshes, sprites, decals, rectangles (their
    textures converted), sound sources, listeners, sound buffers, navmesh
    nodes with their geometry, and LOD groups."""
    names = ("parent", "node_type", "names", "levels", "depth", "payload",
             "init_position", "init_rotation", "init_scale",
             "init_visibility", "init_enabled", "init_lifetime",
             "init_pre_rotation", "init_post_rotation",
             "init_rotation_offset", "init_rotation_pivot",
             "init_scaling_offset", "init_scaling_pivot", "local_bbox_min",
             "local_bbox_max", "cameras", "lights", "sprites", "decals",
             "rectangles", "sounds", "listeners")
    out = _copy(t, SceneTemplate, names)
    out.navmeshes = {k: np.asarray(v)
                     for k, v in (getattr(t, "navmeshes", None) or {}).items()}
    out.navmesh_data = [(np.asarray(v, np.float32), np.asarray(f, np.int32))
                        for v, f in getattr(t, "navmesh_data", None) or []]
    memo = {}
    out.meshes = [_mesh_data(m, memo) for m in t.meshes]
    out.rect_textures = [texture(x, memo) for x in t.rect_textures]
    out.sound_buffers = [np.asarray(b, np.float32)
                         for b in getattr(t, "sound_buffers", None) or []]
    lod = (getattr(t, "extras", None) or {}).get("lod_groups")
    if lod:
        out.extras = {"lod_groups": [list(levels) for levels in lod]}
    return out


def render_template(rt) -> RenderTemplate:
    """A JAX-package RenderTemplate → the port's (its numpy fields, the
    packed texture array included)."""
    return RenderTemplate(**{f: getattr(rt, f)
                             for f in RenderTemplate.__dataclass_fields__})


def slab_config(sc) -> SlabConfig:
    """A JAX-package SlabConfig → the port's (host fields)."""
    names = ("grid_cols", "big_cols", "cell", "s_class", "kinds", "cls_tab",
             "present", "sweep_cap", "num_colliders", "num_bodies", "s_walk",
             "s_active")
    return _copy(sc, SlabConfig, names)


def grid_config(gc) -> GridConfig:
    """A JAX-package GridConfig → the port's (host fields)."""
    names = ("grid_cols", "big_cols", "cell", "window", "caps",
             "windows_body", "cls_tab", "slot_i", "_kinds", "_kind_i",
             "_num_colliders")
    return GridConfig(**{n: getattr(gc, n) for n in names})


def broadphase_config(cfg):
    """A JAX-package SlabConfig or GridConfig → the port's."""
    return slab_config(cfg) if hasattr(cfg, "s_class") else grid_config(cfg)


def joint_set(j) -> JointSet:
    """A JAX-package JointSet → the port's, field by field."""
    return JointSet(**{f: np.asarray(getattr(j, f))
                       for f in JointSet.__dataclass_fields__})


def physics_template(t) -> PhysicsTemplate:
    """A JAX-package PhysicsTemplate → the port's: a slab template with its
    SlabConfig, a grid one with its GridConfig, a dense one with its pair
    list, kind ranges and compaction width; joints, centre-of-mass
    offsets, convex hulls and heightfield / trimesh scenery come along."""
    names = ("body_node", "body_type", "inv_mass", "inv_inertia_local",
             "com_local", "lin_damping", "ang_damping", "gravity_scale",
             "col_body", "col_shape", "col_params", "col_pos", "col_rot",
             "col_friction", "col_restitution", "col_node", "lin_lock",
             "ang_lock", "init_body_pos", "init_body_rot", "erp",
             "allowed_linear_error", "max_corrective_velocity",
             "restitution_threshold", "n_substeps", "n_pgs",
             "n_stabilization", "warmstart_coefficient", "mass_split_pow",
             "gravity", "broadphase_period", "pair_a", "pair_b",
             "pair_kind_ranges", "max_active_pairs", "col_hull",
             "hf_heights", "hf_size", "col_hf", "tm_tris", "tm_mask",
             "col_tm")
    out = _copy(t, PhysicsTemplate, names)
    out.grid = None if t.grid is None else broadphase_config(t.grid)
    if getattr(t, "joints", None) is not None:
        out.joints = joint_set(t.joints)
    if getattr(t, "hulls", None) is not None:
        out.hulls = ConvexSet(*(np.asarray(getattr(t.hulls, f))
                                for f in ConvexSet._fields))
    return out


def _curves(cs):
    if cs is None:
        return None
    return CurveSet(*(np.asarray(getattr(cs, f)) for f in CurveSet._fields))


def animation_set(a) -> AnimationSet:
    return AnimationSet(
        length=_np(a.length), speed=_np(a.speed), looping=_np(a.looping),
        names=list(a.names),
        pos_curves=_curves(a.pos_curves), pos_node=_np(a.pos_node),
        pos_anim=_np(a.pos_anim),
        rot_curves=_curves(a.rot_curves), rot_node=_np(a.rot_node),
        rot_anim=_np(a.rot_anim),
        scl_curves=_curves(a.scl_curves), scl_node=_np(a.scl_node),
        scl_anim=_np(a.scl_anim))


def blend_space(b) -> BlendSpaceTemplate:
    return BlendSpaceTemplate(points=_np(b.points), clips=_np(b.clips),
                              triangles=_np(b.triangles))


def machine_template(m) -> MachineTemplate:
    """A JAX-package MachineTemplate → the port's, its blend-space states
    included."""
    names = ("state_anim", "state_names", "entry_state", "t_from", "t_to",
             "t_param", "t_invert", "t_duration", "param_names",
             "state_clips", "state_weights")
    out = _copy(m, MachineTemplate, names)
    out.state_spaces = [(int(i), blend_space(b))
                        for i, b in getattr(m, "state_spaces", None) or []]
    return out


def layered_machine(lm) -> LayeredMachine:
    return LayeredMachine(layers=[
        LayerSpec(machine=machine_template(l.machine), mask=_np(l.mask),
                  weight=float(l.weight), weight_param=int(l.weight_param),
                  sampling_param=int(l.sampling_param))
        for l in lm.layers])


def root_motion(r) -> RootMotionData:
    """A JAX-package RootMotionData → the port's (host arrays)."""
    st = r.settings
    settings = RootMotionSettings(
        node=int(st.node), ignore_x=bool(st.ignore_x),
        ignore_y=bool(st.ignore_y), ignore_z=bool(st.ignore_z),
        ignore_rotations=bool(st.ignore_rotations))
    return RootMotionData(settings=settings, **{
        f: _np(getattr(r, f)) for f in RootMotionData.__dataclass_fields__
        if f != "settings"})


def particle_template(t) -> ParticleTemplate:
    return _copy(t, ParticleTemplate, ParticleTemplate.__dataclass_fields__)


def skin_template(s) -> SkinTemplate:
    return SkinTemplate(bones=_np(s.bones), inv_bind=_np(s.inv_bind),
                        vertices=_np(s.vertices),
                        bone_indices=_np(s.bone_indices),
                        bone_weights=_np(s.bone_weights))


def engine(e) -> Engine:
    """A JAX-package Engine → the port's Engine (same templates, particles
    and root motion included)."""
    parts = getattr(e, "particles", None)
    rm = getattr(e, "root_motion", None)
    return Engine(
        template=scene_template(e.template),
        physics=None if e.physics is None else physics_template(e.physics),
        animations=None if e.animations is None else animation_set(
            e.animations),
        machine=None if e.machine is None else machine_template(e.machine),
        particles=None if parts is None else particle_template(parts),
        dt=float(e.dt),
        root_motion=None if rm is None else root_motion(rm),
        root_motion_body=int(getattr(e, "root_motion_body", -1)))


def _t(x, device):
    return None if x is None else torch.as_tensor(np.array(x), device=device)


def _tuple(src, cls, device):
    return cls(**{f: _t(getattr(src, f), device) for f in cls._fields})


def physics_state(p, device="cuda") -> PhysicsState:
    """A JAX-package PhysicsState with numpy leaves → the port's (on the
    card unless `device` says otherwise), a temporal-reuse cache included:
    its per-class candidate tuples become SlabCandidates."""
    device = resolve_device(device)
    out = {f: _t(getattr(p, f), device) for f in PhysicsState._fields
           if f != "bp_cache"}
    cache = getattr(p, "bp_cache", None)
    if cache is not None:
        cands, pos0, cov = cache
        out["bp_cache"] = (
            tuple(SlabCandidates(*(_t(x, device) for x in c)) for c in cands),
            _t(pos0, device), _t(cov, device))
    return PhysicsState(**out)


def scene_state(s, device="cuda") -> WorldState:
    """A JAX-package scene WorldState with numpy leaves → the port's (on
    the card unless `device` says otherwise)."""
    device = resolve_device(device)
    return WorldState(**{f: _t(getattr(s, f), device)
                         for f in WorldState._fields})


def engine_state(s, device="cuda") -> EngineState:
    """A JAX-package EngineState with numpy leaves → the port's state (on
    the card unless `device` says otherwise), its audio mixer state
    included."""
    device = resolve_device(device)
    scene = scene_state(s.scene, device)
    phys = None if s.physics is None else physics_state(s.physics, device)
    anim = None
    if s.animation is not None:
        a = s.animation

        def opt(x, cls):
            return None if x is None else _tuple(x, cls, device)

        anim = AnimState(anim=_tuple(a.anim, AnimationState, device),
                         machine=opt(a.machine, MachineState),
                         rootmotion=opt(a.rootmotion, RootMotionState))
    parts = (None if s.particles is None
             else _tuple(s.particles, ParticleState, device))
    audio = (None if s.audio is None
             else _tuple(s.audio, SourceState, device))
    return EngineState(scene=scene, physics=phys, animation=anim,
                       particles=parts, audio=audio)


def to_numpy(x):
    """Any (nested) port state → the same structure with numpy leaves."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    return x
