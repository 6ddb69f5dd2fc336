"""Port parity: the whole slice — Engine.init_state, 12 Engine.step ticks
(ABSM, hierarchy, slab physics on the port's fused route (K3), body → node
sync) and skinning —
of fyrox_tpu_torch against fyrox_tpu on the small flagship (192 bodies:
the slab route), with the port's state carried over by convert.py.

The JAX step runs op by op at ~3 s a tick on the CPU, so the trajectory is
short: every dynamic body starts falling at 3 m/s (world 1 at 3.6 m/s),
so the pile, which starts 0.35 m up, meets the ground and itself from
tick 7 (at rest it would take 14 ticks), and the ABSM `run` parameter
switches world 1 at tick 4: the ticks still cross an ABSM transition
and solve live contacts."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fyrox_tpu.animation import skinning as jskinning
from fyrox_tpu.models import build_flagship as jax_build_flagship
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.animation import skinning as tskinning

torch.set_num_threads(2)

W, TICKS = 2, 12


def _params(tick):
    """ABSM `run` rule: world 1 starts running at tick 4."""
    return np.array([[False], [tick >= 4]])


def _falling(je, js):
    """js with every dynamic body falling at 3 m/s (world k at 3 · 1.2^k)."""
    dyn = (np.asarray(je.physics.body_type) == 0)[None, :, None]
    v = np.where(dyn, np.float32([0.0, -3.0, 0.0]), np.float32(0.0))
    v = v * (1.2 ** np.arange(W, dtype=np.float32))[:, None, None]
    v = np.broadcast_to(v, js.physics.linvel.shape).astype(np.float32)
    return js._replace(physics=js.physics._replace(linvel=jnp.asarray(v)))


@pytest.fixture(scope="module")
def slice_run():
    je, jskin = jax_build_flagship(n_bones=10, n_verts=300, n_bodies=192)
    te, tskin = convert.engine(je), convert.skin_template(jskin)
    js = je.init_state(num_worlds=W)
    init = (jax.tree_util.tree_map(np.asarray, js),
            convert.to_numpy(te.init_state(W, device="cpu")))
    js = _falling(je, js)
    ts = convert.engine_state(jax.tree_util.tree_map(np.asarray, js),
                              device="cpu")
    # the JAX step runs op by op: its XLA CPU compile of the narrowphase
    # costs seconds per step at this size, eager dispatch well under one
    with jax.disable_jit():
        for tick in range(TICKS):
            p = _params(tick)
            js = je.step(js, machine_params=jnp.asarray(p))
            ts = te.step(ts, machine_params=torch.as_tensor(p))
        jverts = jskinning.skin_positions_dense(
            jskinning.bone_matrices(js.scene.globals_, jskin), jskin)
    tverts = tskinning.skin_positions_dense(
        tskinning.bone_matrices(ts.scene.globals_, tskin), tskin)
    return (init, jax.tree_util.tree_map(np.asarray, js),
            convert.to_numpy(ts), np.asarray(jverts), tverts.numpy())


@pytest.mark.parametrize("field", ["position", "rotation", "globals_"])
def test_init_state_matches(slice_run, field):
    (jinit, tinit), *_ = slice_run
    np.testing.assert_allclose(getattr(jinit.scene, field),
                               getattr(tinit.scene, field), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(jinit.physics.position,
                               tinit.physics.position, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(jinit.physics.warm_pair,
                                  tinit.physics.warm_pair)


def test_contacts_are_live_and_state_finite(slice_run):
    _, js, ts, _, tverts = slice_run
    assert (js.physics.warm_pair >= 0).sum() > 0
    assert (ts.physics.warm_pair >= 0).sum() > 0
    for leaf in (ts.scene.globals_, ts.physics.position, ts.physics.linvel,
                 ts.physics.warm_n, tverts):
        assert np.isfinite(leaf).all()
    np.testing.assert_array_equal(js.animation.machine.current,
                                  ts.animation.machine.current)


@pytest.mark.parametrize("field,bound", [("position", 5e-4),
                                         ("linvel", 5e-3)])
def test_bodies_within_trajectory_bounds(slice_run, field, bound):
    _, js, ts, _, _ = slice_run
    # the reference's own bounds between two implementations of a 30-step
    # slab trajectory (test_pallas_solver.py:64-65), over 12 ticks here
    d = np.abs(getattr(js.physics, field) - getattr(ts.physics, field))
    assert d.max() < bound, d.max()


def test_body_nodes_follow_bodies(slice_run):
    _, js, ts, _, _ = slice_run
    # node positions are the synced body positions: same bound as bodies
    np.testing.assert_allclose(js.scene.position, ts.scene.position,
                               rtol=0, atol=5e-4)


def test_skinned_vertices_match(slice_run):
    _, _, _, jverts, tverts = slice_run
    # animated skin after 12 ticks; bone globals agree to ~1e-6, the
    # [V,B] @ [W,B,12] product adds float32 summation-order noise
    np.testing.assert_allclose(jverts, tverts, rtol=0, atol=1e-3)
