"""Utility layer: pathfinding, navmeshes, batched nav agents, behavior
trees, the lightmap bake and performance statistics (the port's
``fyrox_tpu.utils``; fyrox-impl/src/utils/ astar.rs, navmesh.rs,
behavior/, lightmap.rs)."""

from fyrox_tpu_torch.utils import (astar, behavior, lightmap, navagent,
                                   navmesh, stats)
from fyrox_tpu_torch.utils.navagent import (BatchedNavAgents, NavAgentState,
                                            template_navmesh)
from fyrox_tpu_torch.utils.astar import astar as astar_search
from fyrox_tpu_torch.utils.astar import (build_grid_graph, distance_field,
                                         pack_adjacency)
from fyrox_tpu_torch.utils.behavior import (BehaviorTree, BehaviorTreeBuilder,
                                            Status)
from fyrox_tpu_torch.utils.navmesh import Navmesh, NavmeshAgent

__all__ = ["astar", "behavior", "lightmap", "navagent", "navmesh", "stats",
           "BatchedNavAgents", "NavAgentState", "template_navmesh",
           "astar_search", "build_grid_graph", "distance_field",
           "pack_adjacency", "BehaviorTree", "BehaviorTreeBuilder", "Status",
           "Navmesh", "NavmeshAgent"]
