"""Scene layer: templates (static topology) + WorldState (batched state)."""
from fyrox_tpu_torch.scene import (brush, builder, camera, graph,
                                   particles, ragdoll, state, template,
                                   terrain)
from fyrox_tpu_torch.scene.builder import SceneBuilder
from fyrox_tpu_torch.scene.ragdoll import (RagdollBuilder, RagdollTemplate,
                                           drive_kinematic)
from fyrox_tpu_torch.scene.state import WorldState, init_state
from fyrox_tpu_torch.scene.template import NodeType, SceneTemplate

__all__ = ["brush", "builder", "camera", "graph", "particles", "ragdoll", "state",
           "template", "terrain",
           "SceneBuilder", "WorldState", "init_state", "NodeType",
           "SceneTemplate", "RagdollBuilder", "RagdollTemplate",
           "drive_kinematic"]
