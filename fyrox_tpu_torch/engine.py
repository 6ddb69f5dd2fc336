"""Engine facade: one batched engine tick over the world batch
(Engine::update, fyrox-impl engine/mod.rs:1616).

    1. the ABSM writes node local transforms (AnimationPlayer::update)
    2. hierarchical data (skipped when every body node is a scene root:
       the post-physics refresh recomputes everything)
    3. physics step (PhysicsWorld::update)
    4. body poses written back into their nodes' local transforms
    5. hierarchy refresh so consumers see post-physics globals

Root motion, particles and audio are not ported and raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from fyrox_tpu_torch import disable_tf32
from fyrox_tpu_torch._util import const, resolve_device
from fyrox_tpu_torch.animation import machine as machine_mod
from fyrox_tpu_torch.animation import player as player_mod
from fyrox_tpu_torch.animation import track as track_mod
from fyrox_tpu_torch.core import transform as tfm
from fyrox_tpu_torch.physics import world as phys_mod
from fyrox_tpu_torch.scene import graph as graph_mod
from fyrox_tpu_torch.scene.state import WorldState, init_state
from fyrox_tpu_torch.scene.template import SceneTemplate

__all__ = ["Engine", "EngineState", "AnimState", "DEFAULT_DT"]

DEFAULT_DT = 1.0 / 60.0  # executor.rs:87


class AnimState(NamedTuple):
    anim: Optional[track_mod.AnimationState] = None
    machine: Optional[machine_mod.MachineState] = None
    rootmotion: Optional[NamedTuple] = None


class EngineState(NamedTuple):
    scene: WorldState
    physics: Optional[phys_mod.PhysicsState] = None
    animation: Optional[AnimState] = None
    particles: Optional[NamedTuple] = None
    audio: Optional[NamedTuple] = None


@dataclass
class Engine:
    """Holds the static templates; all dynamics live in EngineState."""
    template: SceneTemplate
    physics: Optional[phys_mod.PhysicsTemplate] = None
    animations: Optional[track_mod.AnimationSet] = None
    machine: Optional[machine_mod.MachineTemplate] = None
    dt: float = DEFAULT_DT

    def init_state(self, num_worlds: int, device="cuda",
                   body_pose=None) -> EngineState:
        """Initial state of num_worlds worlds, on the card unless `device`
        says otherwise (raises where there is no card)."""
        device = resolve_device(device)
        if device.type == "cuda":
            disable_tf32()
        scene = init_state(self.template, num_worlds, device)
        scene = graph_mod.update_hierarchical_data(scene, self.template)
        phys = None
        if self.physics is not None:
            if body_pose is None:
                # bodies start at their nodes' initial global poses;
                # standalone bodies (node -1) keep their builder pose
                bn = self.physics.body_node
                g = scene.globals_[0, torch.as_tensor(
                    np.maximum(bn, 0).astype(np.int64), device=device)]
                pos, rot, _ = tfm.decompose_mat4(g)
                pos, rot = pos.cpu().numpy(), rot.cpu().numpy()
                has_node = (bn >= 0)[:, None]
                if self.physics.init_body_pos is not None:
                    pos = np.where(has_node, pos, self.physics.init_body_pos)
                    rot = np.where(has_node, rot, self.physics.init_body_rot)
                body_pose = (pos, rot)
            phys = phys_mod.init_physics_state(body_pose, self.physics,
                                               num_worlds, device)
        anim = None
        if self.animations is not None:
            a = track_mod.init_animation_state(self.animations, num_worlds,
                                               device)
            m = (machine_mod.init_machine_state(self.machine, num_worlds,
                                               device)
                 if self.machine is not None else None)
            anim = AnimState(anim=a, machine=m)
        return EngineState(scene=scene, physics=phys, animation=anim)

    def step(self, state: EngineState, machine_params=None,
             dt: Optional[float] = None, fused=True,
             bp_rank="sort") -> EngineState:
        """One engine tick. machine_params: [W,P] bool ABSM rules.
        fused=False keeps physics on the staged path; bp_rank ("sort" or
        "count") is the slab broadphase's rank (world.step_physics)."""
        dt = self.dt if dt is None else dt
        scene = state.scene
        anim = state.animation
        if (state.particles is not None or state.audio is not None
                or (anim is not None and anim.rootmotion is not None)):
            raise NotImplementedError("particles, audio and root motion")

        # ---- 1. animation ----
        if anim is not None and self.animations is not None:
            if self.machine is None or anim.machine is None:
                raise NotImplementedError("the plain AnimationPlayer path "
                                          "(the port drives ABSMs)")
            if machine_params is None:
                machine_params = torch.zeros(
                    (scene.num_worlds, max(len(self.machine.param_names), 1)),
                    dtype=torch.bool, device=scene.position.device)
            a, m, p, r, s = player_mod.step_absm(
                self.animations, self.machine, anim.anim, anim.machine,
                machine_params, scene.position, scene.rotation, scene.scale,
                dt)
            anim = AnimState(anim=a, machine=m)
            scene = scene._replace(position=p, rotation=r, scale=s)

        # ---- 2. hierarchy (pre-physics) ----
        skip_pre = (state.physics is not None and self.physics is not None
                    and self._bodies_at_root())
        scene = graph_mod.step(scene, self.template, dt,
                               update_hierarchy=not skip_pre)

        # ---- 3+4+5. physics, body → node sync, refresh ----
        phys = state.physics
        if phys is not None and self.physics is not None:
            phys = phys_mod.step_physics(phys, self.physics, dt, fused=fused,
                                         bp_rank=bp_rank)
            scene = self._sync_bodies_to_nodes(scene, phys)
            scene = graph_mod.update_hierarchical_data(scene, self.template)
        return EngineState(scene=scene, physics=phys, animation=anim)

    def _bodies_at_root(self) -> bool:
        if getattr(self, "_bodies_at_root_cache", None) is None:
            bn = self.physics.body_node
            nodes = bn[bn >= 0]
            self._bodies_at_root_cache = bool(
                (self.template.parent[nodes] < 0).all()) if len(nodes) \
                else True
        return self._bodies_at_root_cache

    def _sync_bodies_to_nodes(self, scene: WorldState,
                              phys: phys_mod.PhysicsState) -> WorldState:
        """Body world poses → node local transforms, decomposed against
        the parent's global transform (physics/mod.rs:1447-1475)."""
        bn = self.physics.body_node
        mask = bn >= 0
        if not mask.any():
            return scene
        dev = scene.position.device
        if getattr(self, "_sync_idx", None) is None:
            nodes = bn[mask].astype(np.int64)
            parents = self.template.parent[nodes].astype(np.int64)
            self._sync_idx = (nodes, np.nonzero(mask)[0].astype(np.int64),
                              np.maximum(parents, 0), parents >= 0)
        nodes, bidx, parents0, has_parent = self._sync_idx
        bpos = phys.position[:, const(bidx, dev)]
        brot = phys.rotation[:, const(bidx, dev)]
        if has_parent.any():
            pg = scene.globals_[:, const(parents0, dev)]
            local_m = tfm.mat4_mul(tfm.invert_affine(pg), tfm.compose_trs(
                bpos, brot, torch.ones_like(bpos)))
            lp, lr, _ = tfm.decompose_mat4(local_m)
            hp = const(has_parent, dev)[None, :, None]
            bpos = torch.where(hp, lp, bpos)
            brot = torch.where(hp, lr, brot)
        position = scene.position.clone()
        rotation = scene.rotation.clone()
        node_idx = const(nodes, dev)
        position[:, node_idx] = bpos
        rotation[:, node_idx] = brot
        return scene._replace(position=position, rotation=rotation)

