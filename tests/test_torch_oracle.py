"""Port parity: the port's sequential float64 oracle
(``fyrox_tpu_torch.physics.oracle``) against the JAX package's, and the
port's slab staged step against the port's oracle, on the CPU.

The oracle is straight-line float64 numpy in both packages, so the port's
equals the JAX package's bit for bit, step after step, in both solve
orders (``sequential``), on tests/test_oracle.py's two scenes (the
three-cube stack and the mixed cluster; ``chip_smoke.ORACLE_SCENES``),
reading the port's tensors.

tests/test_oracle.py holds the JAX package's slab path to the oracle over
60 ticks and is marked slow; this holds the port's staged slab route
(``fused=False``: the PyTorch broadphase, K4a's plain version, K1's plain
solve) on the same scenes over a short trajectory. At sampled ticks, one
port step from the trajectory's state with its warm start zeroed (the
oracle has none) is compared with one oracle step from the same state,
within test_oracle.py's bar of 1e-5 in position, linear and angular
velocity (``chip_smoke.oracle_deviation``, which the card's oracle phase
runs on both routes).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from fyrox_tpu.physics import oracle as jorc
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.physics import oracle as orc
from fyrox_tpu_torch.physics import world as tworld

torch.set_num_threads(2)

DT = 1.0 / 60.0
TOL = chip_smoke.ORACLE_TOL      # tests/test_oracle.py's tol


@pytest.mark.parametrize("scene,samples", [
    ("stack", {0, 10, 19}), ("mixed", {0, 8, 19})])
def test_slab_staged_step_matches_the_oracle(scene, samples):
    worst, live = chip_smoke.oracle_deviation(
        scene, "cpu", False, orc.oracle_step, orc.state_from_device, samples)
    assert live > 0          # the sampled steps solved contacts
    assert max(worst.values()) < TOL, worst


@pytest.mark.parametrize("sequential", [False, True])
@pytest.mark.parametrize("scene", ["stack", "mixed"])
def test_port_oracle_equals_the_jax_oracle(scene, sequential):
    pb = chip_smoke.ORACLE_SCENES[scene]()
    t = pb.build(broadphase="slab")
    s = tworld.init_physics_state(pb, t, 1, device="cpu")
    got = orc.state_from_device(s)
    want = jorc.state_from_device(convert.to_numpy(s))
    moved = 0.0
    for _ in range(20):
        got = orc.oracle_step(got, t, DT, sequential=sequential)
        want = jorc.oracle_step(want, t, DT, sequential=sequential)
        for f in ("position", "rotation", "linvel", "angvel"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype == np.float64
            np.testing.assert_array_equal(a, b, err_msg=f)
        moved = max(moved, float(np.abs(got.linvel).max()))
    assert moved > 0.1
