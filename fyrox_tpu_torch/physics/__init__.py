"""Physics layer: batched rigid bodies on the slab pipeline (fused route
where the scene allows it, else staged; joints, centre-of-mass offsets,
convex hulls and scenery take the staged route), under 192 colliders the
dense broadphase with its kind-grouped narrowphase and Jacobi TGS solver,
or on request the grid broadphase with its per-class narrowphase and
directed TGS solver; ray and shape queries on each."""
from fyrox_tpu_torch.physics import (broadphase, convex, dim2, fused_step,
                                     joints, narrowphase, np_planes,
                                     plane_ops, queries, scenery, shapes,
                                     slab2, solver, tgs_kernel, world)
from fyrox_tpu_torch.physics.joints import JointKind, JointSet
from fyrox_tpu_torch.physics.shapes import (BALL, CAPSULE, CONE, CONVEX,
                                            CUBOID, CYLINDER, HALFSPACE,
                                            HEIGHTFIELD, SEGMENT, TRIANGLE,
                                            TRIMESH)
from fyrox_tpu_torch.physics.world import (BodyType, PhysicsBuilder,
                                           PhysicsState, PhysicsTemplate,
                                           init_physics_state, step_physics)

__all__ = ["broadphase", "convex", "dim2", "fused_step", "joints",
           "narrowphase", "np_planes", "plane_ops", "queries", "scenery",
           "shapes", "slab2", "solver", "tgs_kernel", "world", "BALL",
           "CUBOID", "CAPSULE", "CYLINDER", "CONE", "HALFSPACE", "CONVEX",
           "HEIGHTFIELD", "TRIMESH", "SEGMENT", "TRIANGLE", "BodyType", "JointKind", "JointSet",
           "PhysicsBuilder", "PhysicsState", "PhysicsTemplate",
           "init_physics_state", "step_physics"]
