"""NavigationalMesh nodes at run time: the template accessor and batched
world-parallel agents (the port's ``fyrox_tpu.utils.navagent``).

``SceneBuilder.add_navmesh`` puts navmesh geometry in the scene graph
(fyrox-impl/src/scene/navmesh.rs:81); ``template_navmesh`` bakes the
node's template transform into a ``utils.navmesh.Navmesh``, and
``BatchedNavAgents`` is the world-batched ``NavmeshAgent``
(fyrox-impl/src/utils/navmesh.rs:642): A* and funnel pathfinding run per
world on the host (small graphs, as the reference runs them on the CPU),
and the per-tick waypoint steering is one tensor function over [W] agents
on the device, which can drive rigid bodies between ticks.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch.core import quat
from fyrox_tpu_torch.scene.template import SceneTemplate
from fyrox_tpu_torch.utils.navmesh import Navmesh

__all__ = ["template_navmesh", "BatchedNavAgents", "NavAgentState"]


def template_navmesh(template: SceneTemplate, index: int = 0) -> Navmesh:
    """A pathfinding Navmesh from the template's index-th NAVMESH node,
    the node's template-time local TRS baked into the vertices (navmeshes
    are static geometry: the node's data is edited, not driven)."""
    nm = template.navmeshes
    if not nm or index >= len(nm.get("node", [])):
        raise IndexError(f"template has no NAVMESH payload {index}")
    node = int(nm["node"][index])
    verts, tris = template.navmesh_data[int(nm["data"][index])]
    p = np.asarray(template.init_position[node], np.float64)
    q = torch.as_tensor(np.asarray(template.init_rotation[node], np.float32))
    s = np.asarray(template.init_scale[node], np.float64)
    rot = quat.to_mat3(q).numpy().astype(np.float64)
    world = (np.asarray(verts, np.float64) * s) @ rot.T + p
    return Navmesh(vertices=world.astype(np.float32),
                   triangles=np.asarray(tris, np.int32))


class NavAgentState(NamedTuple):
    """Batched agent state on the device."""
    waypoints: torch.Tensor  # [W, P, 3] padded per-world paths
    length: torch.Tensor     # [W] int32 true waypoint counts
    wp: torch.Tensor         # [W] int32 current waypoint index


class BatchedNavAgents:
    """World-batched NavmeshAgent (utils/navmesh.rs:642): host ``plan`` →
    device ``steer``.

    plan(navmesh, starts [W,3], goals [W,3]) finds one funnel-smoothed
    path a world on the host and pads them to a [W, P, 3] tensor;
    steer(state, pos, speed, dt) returns the velocity toward the active
    waypoint and the advanced NavAgentState, on the device with no host
    read (written into a rigid body's linvel each tick, the reference's
    agent-drives-body pattern)."""

    def __init__(self, radius: float = 0.05):
        self.radius = float(radius)

    def plan(self, navmesh: Navmesh, starts, goals,
             device="cuda") -> NavAgentState:
        """Paths on the host; the padded state on `device` (the card
        unless asked otherwise)."""
        starts = np.asarray(starts, np.float32)
        goals = np.asarray(goals, np.float32)
        paths = [navmesh.build_path(s, g) for s, g in zip(starts, goals)]
        pmax = max(max(len(p) for p in paths), 1)
        w = len(paths)
        wp = np.zeros((w, pmax, 3), np.float32)
        ln = np.zeros(w, np.int32)
        for i, p in enumerate(paths):
            if len(p):
                wp[i, :len(p)] = p
                wp[i, len(p):] = p[-1]      # pad with the goal
                ln[i] = len(p)
        return NavAgentState(
            waypoints=torch.as_tensor(wp, device=device),
            length=torch.as_tensor(ln, device=device),
            wp=torch.zeros(w, dtype=torch.int32, device=device))

    def steer(self, st: NavAgentState, pos, speed, dt):
        """pos [W,3] agent / body positions → (vel [W,3], NavAgentState).
        Advances the waypoint cursor within `radius` (or one dt step) of
        the target; the velocity is zero once the path is done. speed is a
        float or a [W] tensor."""
        w, pmax = st.waypoints.shape[:2]
        idx = torch.clamp(st.wp, max=pmax - 1).long()
        target = st.waypoints[torch.arange(w, device=idx.device), idx]
        to = target - pos
        d = torch.linalg.vector_norm(to, dim=-1)
        speed = torch.as_tensor(speed, dtype=torch.float32, device=pos.device)
        step = speed * dt
        arrived = d <= torch.clamp(step, min=self.radius)
        active = st.wp < st.length
        new_wp = torch.where(arrived & active, st.wp + 1, st.wp)
        dir_ = to / torch.clamp(d, min=1e-8)[:, None]
        vel = torch.where((active & ~arrived)[:, None],
                          dir_ * speed.reshape(-1, 1), torch.zeros_like(to))
        return vel, st._replace(wp=new_wp)
