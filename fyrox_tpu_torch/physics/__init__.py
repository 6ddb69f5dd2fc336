"""Physics layer: batched rigid bodies on the slab pipeline (fused route
where the scene allows it, else staged)."""
from fyrox_tpu_torch.physics import (broadphase, fused_step, np_planes,
                                     plane_ops, shapes, slab2, tgs_kernel,
                                     world)
from fyrox_tpu_torch.physics.shapes import BALL, CAPSULE, CUBOID, HALFSPACE
from fyrox_tpu_torch.physics.world import (BodyType, PhysicsBuilder,
                                           PhysicsState, PhysicsTemplate,
                                           init_physics_state, step_physics)

__all__ = ["broadphase", "fused_step", "np_planes", "plane_ops", "shapes", "slab2",
           "tgs_kernel", "world", "BALL", "CUBOID", "CAPSULE", "HALFSPACE",
           "BodyType", "PhysicsBuilder", "PhysicsState", "PhysicsTemplate",
           "init_physics_state", "step_physics"]
