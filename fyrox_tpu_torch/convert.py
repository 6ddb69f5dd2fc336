"""Carry templates and state from the JAX package into the port.

The JAX package's templates are host numpy dataclasses (its curve tables
may be device arrays; ``np.asarray`` reads them) and its state is a pytree
that the caller turns into numpy, e.g.
``jax.tree_util.tree_map(np.asarray, engine_state)``. This module reads
both by attribute — it never imports JAX — and rebuilds the port's
templates and state on a given device, so both packages can step the same
inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from fyrox_tpu_torch._util import resolve_device
from fyrox_tpu_torch.animation.machine import MachineState, MachineTemplate
from fyrox_tpu_torch.animation.skinning import SkinTemplate
from fyrox_tpu_torch.animation.track import AnimationSet, AnimationState
from fyrox_tpu_torch.core.curve import CurveSet
from fyrox_tpu_torch.engine import AnimState, Engine, EngineState
from fyrox_tpu_torch.physics.broadphase import SlabConfig
from fyrox_tpu_torch.physics.world import PhysicsState, PhysicsTemplate
from fyrox_tpu_torch.render.mesh import MeshData
from fyrox_tpu_torch.render.pipeline import RenderTemplate
from fyrox_tpu_torch.scene.state import WorldState
from fyrox_tpu_torch.scene.template import SceneTemplate

__all__ = ["scene_template", "physics_template", "slab_config",
           "animation_set", "machine_template", "skin_template", "engine",
           "engine_state", "physics_state", "scene_state", "render_template",
           "to_numpy"]


def _np(x):
    return None if x is None else np.asarray(x)


def _copy(src, cls, names):
    return cls(**{n: getattr(src, n) for n in names})


def _mesh_data(m) -> MeshData:
    """A JAX-package MeshData → the port's, field by field."""
    return MeshData(**{f: getattr(m, f) for f in MeshData.__dataclass_fields__})


def scene_template(t) -> SceneTemplate:
    """A JAX-package SceneTemplate → the port's; payload kinds the port
    has no counterpart for (sprites, decals, rectangles, LOD groups)
    raise."""
    for kind in ("sprites", "decals", "rectangles"):
        if len((getattr(t, kind, None) or {}).get("node", [])):
            raise NotImplementedError(kind)
    if (getattr(t, "extras", None) or {}).get("lod_groups"):
        raise NotImplementedError("LOD groups")
    names = ("parent", "node_type", "names", "levels", "depth", "payload",
             "init_position", "init_rotation", "init_scale",
             "init_visibility", "init_enabled", "init_lifetime",
             "init_pre_rotation", "init_post_rotation",
             "init_rotation_offset", "init_rotation_pivot",
             "init_scaling_offset", "init_scaling_pivot", "local_bbox_min",
             "local_bbox_max", "cameras", "lights")
    out = _copy(t, SceneTemplate, names)
    out.meshes = [_mesh_data(m) for m in t.meshes]
    return out


def render_template(rt) -> RenderTemplate:
    """A JAX-package RenderTemplate → the port's (its numpy fields); the
    parts off the port's slice (sprites, LOD groups, transparent
    triangles, decals, textures) raise."""
    for name in ("sprite_node", "lod_obj", "tr_tri", "decal_node"):
        if getattr(rt, name, None) is not None and len(getattr(rt, name)):
            raise NotImplementedError(name)
    if getattr(rt, "tex_array", None) is not None:
        raise NotImplementedError("texture-mapped materials")
    return RenderTemplate(**{f: getattr(rt, f)
                             for f in RenderTemplate.__dataclass_fields__})


def slab_config(sc) -> SlabConfig:
    if not hasattr(sc, "s_class"):
        raise NotImplementedError(
            f"{type(sc).__name__}: the torch port has the slab broadphase "
            "only")
    names = ("grid_cols", "big_cols", "cell", "s_class", "kinds", "cls_tab",
             "present", "sweep_cap", "num_colliders", "num_bodies", "s_walk",
             "s_active")
    return _copy(sc, SlabConfig, names)


def physics_template(t) -> PhysicsTemplate:
    if getattr(t, "joints", None) is not None:
        raise NotImplementedError("joints")
    if getattr(t, "hulls", None) is not None:
        raise NotImplementedError("convex hulls (incl. cylinder/cone)")
    if any(getattr(t, k, None) is not None for k in ("col_hf", "col_tm")):
        raise NotImplementedError("heightfield/trimesh scenery")
    if int(getattr(t, "broadphase_period", 1) or 1) != 1:
        raise NotImplementedError("broadphase_period > 1")
    if t.grid is None:
        raise NotImplementedError("the dense broadphase")
    names = ("body_node", "body_type", "inv_mass", "inv_inertia_local",
             "com_local", "lin_damping", "ang_damping", "gravity_scale",
             "col_body", "col_shape", "col_params", "col_pos", "col_rot",
             "col_friction", "col_restitution", "col_node", "lin_lock",
             "ang_lock", "init_body_pos", "init_body_rot", "erp",
             "allowed_linear_error", "max_corrective_velocity",
             "restitution_threshold", "n_substeps", "n_pgs",
             "n_stabilization", "warmstart_coefficient", "mass_split_pow",
             "gravity", "broadphase_period")
    out = _copy(t, PhysicsTemplate, names)
    out.grid = slab_config(t.grid)
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


def machine_template(m) -> MachineTemplate:
    if getattr(m, "state_spaces", None):
        raise NotImplementedError("blend-space machine states")
    names = ("state_anim", "state_names", "entry_state", "t_from", "t_to",
             "t_param", "t_invert", "t_duration", "param_names",
             "state_clips", "state_weights")
    return _copy(m, MachineTemplate, names)


def skin_template(s) -> SkinTemplate:
    return SkinTemplate(bones=_np(s.bones), inv_bind=_np(s.inv_bind),
                        vertices=_np(s.vertices),
                        bone_indices=_np(s.bone_indices),
                        bone_weights=_np(s.bone_weights))


def engine(e) -> Engine:
    """A JAX-package Engine → the port's Engine (same templates)."""
    for attr in ("particles", "root_motion"):
        if getattr(e, attr, None) is not None:
            raise NotImplementedError(attr)
    return Engine(
        template=scene_template(e.template),
        physics=None if e.physics is None else physics_template(e.physics),
        animations=None if e.animations is None else animation_set(
            e.animations),
        machine=None if e.machine is None else machine_template(e.machine),
        dt=float(e.dt))


def _t(x, device):
    return None if x is None else torch.as_tensor(np.array(x), device=device)


def _tuple(src, cls, device):
    return cls(**{f: _t(getattr(src, f), device) for f in cls._fields})


def physics_state(p, device="cuda") -> PhysicsState:
    device = resolve_device(device)
    if getattr(p, "bp_cache", None) is not None:
        raise NotImplementedError("temporal broadphase reuse state")
    return PhysicsState(**{f: _t(getattr(p, f), device)
                           for f in PhysicsState._fields
                           if f not in ("bp_cache", "bp_age")})


def scene_state(s, device="cuda") -> WorldState:
    """A JAX-package scene WorldState with numpy leaves → the port's (on
    the card unless `device` says otherwise)."""
    device = resolve_device(device)
    return WorldState(**{f: _t(getattr(s, f), device)
                         for f in WorldState._fields})


def engine_state(s, device="cuda") -> EngineState:
    """A JAX-package EngineState with numpy leaves → the port's state (on
    the card unless `device` says otherwise)."""
    device = resolve_device(device)
    if s.particles is not None or s.audio is not None:
        raise NotImplementedError("particles and audio")
    scene = scene_state(s.scene, device)
    phys = None if s.physics is None else physics_state(s.physics, device)
    anim = None
    if s.animation is not None:
        if s.animation.rootmotion is not None:
            raise NotImplementedError("root motion")
        anim = AnimState(
            anim=_tuple(s.animation.anim, AnimationState, device),
            machine=(None if s.animation.machine is None else
                     _tuple(s.animation.machine, MachineState, device)))
    return EngineState(scene=scene, physics=phys, animation=anim)


def to_numpy(x):
    """Any (nested) port state → the same structure with numpy leaves."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    return x
