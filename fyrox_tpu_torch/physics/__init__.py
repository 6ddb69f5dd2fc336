"""Physics layer: batched rigid bodies on the slab pipeline (fused route
where the scene allows it, else staged; joints and centre-of-mass offsets
take the staged route) or, under 192 colliders, the dense broadphase with
its kind-grouped narrowphase and Jacobi TGS solver."""
from fyrox_tpu_torch.physics import (broadphase, dim2, fused_step, joints,
                                     narrowphase, np_planes, plane_ops,
                                     shapes, slab2, solver, tgs_kernel,
                                     world)
from fyrox_tpu_torch.physics.joints import JointKind, JointSet
from fyrox_tpu_torch.physics.shapes import BALL, CAPSULE, CUBOID, HALFSPACE
from fyrox_tpu_torch.physics.world import (BodyType, PhysicsBuilder,
                                           PhysicsState, PhysicsTemplate,
                                           init_physics_state, step_physics)

__all__ = ["broadphase", "dim2", "fused_step", "joints", "narrowphase",
           "np_planes", "plane_ops", "shapes", "slab2", "solver",
           "tgs_kernel", "world", "BALL", "CUBOID",
           "CAPSULE", "HALFSPACE", "BodyType", "JointKind", "JointSet",
           "PhysicsBuilder", "PhysicsState", "PhysicsTemplate",
           "init_physics_state", "step_physics"]
