"""Parallel layer: world-axis sharding over a mesh of torch devices."""

from fyrox_tpu_torch.parallel.mesh import (make_sharded_rollout,
                                           make_sharded_step, shard_state,
                                           unshard_state, world_mesh)

__all__ = ["world_mesh", "shard_state", "make_sharded_step",
           "make_sharded_rollout", "unshard_state"]
