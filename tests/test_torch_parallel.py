"""Port parity: world sharding (``parallel``) against the JAX package's
shard_map rollout on the CPU.

The JAX side runs ``make_sharded_rollout`` on 2 of the conftest's 8
virtual CPU devices; the port's runs on ``world_mesh(["cpu", "cpu"])``, two
shards that share one device (as the card's sharded phase does on one
card). The scene is an 8-body dense pile on the scene graph (the engine's
physics and body → node sync, no character) whose worlds fall at
different speeds, so the shards hold different worlds and the pile meets
the ground within the roll. States are held at test_torch_rollout.py's
bars (positions 1e-5, velocities 1e-4: XLA's fused multiply-adds), the
metrics within 1e-6; the port's sharded roll equals its unsharded roll
bit for bit.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fyrox_tpu.engine import Engine as JEngine
from fyrox_tpu.models.character import build_pile_scene as jax_build_pile_scene
from fyrox_tpu.parallel import make_sharded_rollout as jax_sharded_rollout
from fyrox_tpu.parallel import shard_state as jax_shard_state
from fyrox_tpu.parallel import world_mesh as jax_world_mesh
from fyrox_tpu.scene import SceneBuilder as JSceneBuilder
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.engine import _leaves
from fyrox_tpu_torch.parallel import (make_sharded_rollout,
                                      make_sharded_step, shard_state,
                                      unshard_state, world_mesh)

torch.set_num_threads(2)

W, TICKS = 4, 6


def _pile_engine():
    """The JAX package's 8-body pile (balls and boxes over a ground plane,
    dense broadphase) on its scene graph, no character: one JAX compile of
    the sharded roll costs what the physics costs."""
    sb = JSceneBuilder()
    pb, _ = jax_build_pile_scene(sb, n_bodies=8, seed=11)
    return JEngine(template=sb.build(), physics=pb.build())


@pytest.fixture(scope="module")
def rolled():
    je = _pile_engine()
    js = je.init_state(num_worlds=W)
    dyn = (np.asarray(je.physics.body_type) == 0)[None, :, None]
    v = np.where(dyn, np.float32([0.0, -4.0, 0.0]), np.float32(0.0))
    v = v * (1.3 ** np.arange(W, dtype=np.float32))[:, None, None]
    js = js._replace(physics=js.physics._replace(linvel=jnp.asarray(
        np.broadcast_to(v, js.physics.linvel.shape).astype(np.float32))))
    te = convert.engine(je)
    ts = convert.engine_state(jax.tree_util.tree_map(np.asarray, js),
                              device="cpu")
    jmesh = jax_world_mesh(jax.devices()[:2])
    jout, jm = jax_sharded_rollout(je, jmesh, TICKS)(
        jax_shard_state(js, jmesh))
    mesh = world_mesh(["cpu", "cpu"])
    shards, m = make_sharded_rollout(te, mesh, TICKS)(shard_state(ts, mesh))
    return (te, ts, jax.tree_util.tree_map(np.asarray, jout),
            {k: float(x) for k, x in jm.items()}, shards, m)


@pytest.mark.parametrize("part,field,bound", [
    ("physics", "position", 1e-5), ("physics", "rotation", 1e-5),
    ("physics", "linvel", 1e-4), ("physics", "angvel", 1e-4),
    ("scene", "position", 1e-5), ("scene", "globals_", 1e-5)])
def test_sharded_rollout_matches_jax(rolled, part, field, bound):
    _, _, js, _, shards, _ = rolled
    ts = convert.to_numpy(unshard_state(shards))
    d = np.abs(getattr(getattr(js, part), field)
               - getattr(getattr(ts, part), field))
    assert d.max() < bound, d.max()


def test_sharded_metrics_match_jax(rolled):
    _, _, js, jm, shards, m = rolled
    assert float(m["total_worlds"]) == jm["total_worlds"] == W
    assert abs(float(m["mean_body_speed"]) - jm["mean_body_speed"]) < 1e-6
    assert (js.physics.warm_pair >= 0).sum() > 0           # in contact
    ts = unshard_state(shards)
    assert (ts.physics.warm_pair >= 0).sum() > 0


def test_sharded_roll_equals_the_unsharded_roll(rolled):
    te, ts, _, _, shards, m = rolled
    want = te.rollout(ts, TICKS)
    got = unshard_state(shards)
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b)
    assert all(x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))
    assert float(m["mean_body_speed"]) == pytest.approx(float(
        torch.linalg.vector_norm(want.physics.linvel, dim=-1).mean()),
        rel=1e-6, abs=0)
    mesh = world_mesh(["cpu", "cpu"])
    stepped = make_sharded_step(te, mesh)(shard_state(ts, mesh))
    one = te.step(ts)
    assert all(torch.equal(x, y) for x, y in
               zip(_leaves(unshard_state(stepped)), _leaves(one)))


def test_shards_are_equal_parts_on_their_devices(rolled):
    _, ts, _, _, _, _ = rolled
    mesh = world_mesh(["cpu", "cpu"])
    shards = shard_state(ts, mesh)
    assert [s.scene.position.shape[0] for s in shards] == [W // 2] * 2
    assert shards[0].scene.position.data_ptr() != ts.scene.position.data_ptr()
    assert all(torch.equal(x, y) for x, y in
               zip(_leaves(unshard_state(shards)), _leaves(ts)))
    with pytest.raises(ValueError, match="equal shards"):
        shard_state(_take(ts, 3), mesh)
    with pytest.raises(ValueError, match="shards"):
        make_sharded_rollout(rolled[0], mesh, 1)(shards[:1])


def _take(state, n):
    from fyrox_tpu_torch.engine import _map
    return _map(lambda x: x[:n] if x.ndim else x, state)


def test_world_mesh_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        world_mesh()
    with pytest.raises(RuntimeError):
        world_mesh(["cuda:0"])
    mesh = world_mesh(["cpu", "cpu"], axis_name="w")
    assert mesh.size == 2 and mesh.axis_name == "w"
    assert mesh.devices == (torch.device("cpu"),) * 2
