"""Scene layer: templates (static topology) + WorldState (batched state)."""
from fyrox_tpu_torch.scene import builder, graph, state, template
from fyrox_tpu_torch.scene.builder import SceneBuilder
from fyrox_tpu_torch.scene.state import WorldState, init_state
from fyrox_tpu_torch.scene.template import NodeType, SceneTemplate

__all__ = ["builder", "graph", "state", "template", "SceneBuilder",
           "WorldState", "init_state", "NodeType", "SceneTemplate"]
