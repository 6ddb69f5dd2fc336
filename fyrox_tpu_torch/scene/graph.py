"""Batched scene-graph update (Graph::update_hierarchical_data,
fyrox-impl scene/graph/mod.rs:1275).

global = parent_global @ local, global_visibility = parent_gv && own,
global_enabled = parent_ge && own — computed by pointer doubling: each of
ceil(log2(depth+1)) rounds composes every node with its ancestor 2^r
levels up, gathered by index.
"""
from __future__ import annotations

import numpy as np
import torch

from fyrox_tpu_torch._util import const
from fyrox_tpu_torch.core import aabb as aabb_mod
from fyrox_tpu_torch.core import transform as tfm
from fyrox_tpu_torch.scene.state import WorldState
from fyrox_tpu_torch.scene.template import SceneTemplate

__all__ = ["local_matrices", "update_hierarchical_data", "step",
           "world_bounding_boxes"]

_BOTTOM_ROW = np.array([0.0, 0.0, 0.0, 1.0], np.float32)   # affine 4th row


def local_matrices(state: WorldState) -> torch.Tensor:
    """[W,N,4,4] local matrices (Transform::matrix)."""
    return tfm.local_matrix(tfm.Transform(
        position=state.position, rotation=state.rotation, scale=state.scale,
        pre_rotation=state.pre_rotation, post_rotation=state.post_rotation,
        rotation_offset=state.rotation_offset,
        rotation_pivot=state.rotation_pivot,
        scaling_offset=state.scaling_offset,
        scaling_pivot=state.scaling_pivot))


def update_hierarchical_data(state: WorldState,
                             template: SceneTemplate) -> WorldState:
    locals_ = local_matrices(state)
    w, n = locals_.shape[:2]
    dev, dtype = locals_.device, locals_.dtype
    # [W,N+1,3,4] affines; slot N is the virtual identity ancestor
    ident = torch.eye(4, dtype=dtype, device=dev)[:3].expand(w, 1, 3, 4)
    aff = torch.cat([locals_[:, :, :3, :], ident], dim=1)
    one = torch.ones((w, 1), dtype=dtype, device=dev)
    vis = torch.cat([(state.visibility & state.alive).to(dtype), one], 1)
    en = torch.cat([state.enabled.to(dtype), one], 1)
    for table in template.doubling_pointers():
        p = const(table, dev)
        par = aff[:, p]
        # (par ∘ child) for 3x4 affines: linear = Pl @ Cl, t = Pl @ Ct + Pt
        lin = (par[..., :, 0:1] * aff[..., 0:1, :]
               + par[..., :, 1:2] * aff[..., 1:2, :]
               + par[..., :, 2:3] * aff[..., 2:3, :])
        lin[..., 3] = lin[..., 3] + par[..., 3]
        aff = lin
        vis = vis[:, p] * vis
        en = en[:, p] * en
    bottom = const(_BOTTOM_ROW, dev).to(dtype).expand(w, n, 1, 4)
    globals_ = torch.cat([aff[:, :n], bottom], dim=2)
    return state._replace(globals_=globals_,
                          global_visibility=vis[:, :n] > 0.5,
                          global_enabled=en[:, :n] > 0.5)


def step(state: WorldState, template: SceneTemplate, dt: float,
         update_hierarchy: bool = True) -> WorldState:
    """Hierarchy refresh + lifetime countdown (graph/mod.rs:1459)."""
    if update_hierarchy:
        state = update_hierarchical_data(state, template)
    lifetime = state.lifetime - dt
    alive = state.alive & (lifetime > 0.0)
    return state._replace(lifetime=lifetime, alive=alive,
                          time=state.time + dt)


def world_bounding_boxes(state: WorldState, template: SceneTemplate):
    """[W, N, 3] (mins, maxs) of every node's local box under its global
    matrix (NodeTrait::world_bounding_box, scene/node/mod.rs:178)."""
    if template.local_bbox_min is None:
        raise ValueError("template has no local bounding boxes")
    dev = state.position.device
    mins = const(template.local_bbox_min, dev).expand(state.position.shape)
    maxs = const(template.local_bbox_max, dev).expand(state.position.shape)
    return aabb_mod.transform(mins, maxs, state.globals_)
