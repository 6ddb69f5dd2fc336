"""Port parity of the jointed engine step: Engine.step on the jointed
flagship (chip_smoke.jointed_flagship_scene) at a small size, through the
port and the JAX package: ABSM, hierarchy, the staged slab step with K1's
joint passes and COM terms, and the body → node sync with ragdoll limb
bodies bound to root pivots.

The JAX engine step is jitted: its compile costs ~43 s here, while under
``jax.disable_jit()`` the first tick alone costs ~83 s (every primitive
compiles on first use)."""
import numpy as np
import torch
import jax

import chip_smoke
from fyrox_tpu.engine import Engine as JEngine
from fyrox_tpu_torch import convert
from test_torch_joints import JAX, SMALL

torch.set_num_threads(2)


def test_jointed_engine_ticks_match():
    """3 ticks, 2 worlds. Bounds: the engine parity suite's
    (test_torch_engine.py: positions 1e-5, velocities 1e-4, node globals
    1e-4); measured here 5e-8, 7e-6 and 1e-7 (XLA fuses multiply-adds,
    PyTorch does not)."""
    template, pt, aset, mt, _, _, _, rds = \
        chip_smoke.jointed_flagship_scene(JAX, **SMALL)
    je = JEngine(template=template, physics=pt, animations=aset, machine=mt)
    te = convert.engine(je)
    assert te.physics.joints.num_joints == pt.joints.num_joints > 0
    js = je.init_state(num_worlds=2)
    ts = convert.engine_state(jax.tree_util.tree_map(np.asarray, js),
                              device="cpu")
    step = jax.jit(je.step)
    for _ in range(3):
        js = step(js)
        ts = te.step(ts)
    js = jax.tree_util.tree_map(np.asarray, js)
    tn = convert.to_numpy(ts)
    np.testing.assert_array_equal(js.physics.warm_pair, tn.physics.warm_pair)
    assert (tn.physics.warm_pair >= 0).sum() > 0
    np.testing.assert_allclose(js.physics.position, tn.physics.position,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(js.physics.linvel, tn.physics.linvel,
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(js.scene.globals_, tn.scene.globals_, rtol=0,
                               atol=1e-4)
    # the limb bodies drive their root pivots' nodes
    for rd in rds:
        np.testing.assert_allclose(
            tn.scene.globals_[:, np.asarray(rd.bones)][..., :3, 3],
            tn.physics.position[:, np.asarray(rd.bodies)], rtol=0, atol=1e-5)
