"""Port parity: the port's slab staged step against the sequential float64
oracle (``fyrox_tpu.physics.oracle``) on the CPU.

tests/test_oracle.py holds the JAX package's slab path to the oracle over
60 ticks and is marked slow; this holds the port's staged slab route
(``fused=False``: the PyTorch broadphase, K4a's plain version, K1's plain
solve) on the same scenes over a short trajectory. At sampled ticks, one
port step from the trajectory's state with its warm start zeroed (the
oracle has none) is compared with one oracle step from the same state,
within test_oracle.py's bar of 1e-5 in position, linear and angular
velocity.
"""
import numpy as np
import pytest
import torch

from fyrox_tpu.physics import oracle as orc
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.physics import shapes as sh
from fyrox_tpu_torch.physics import world as tworld
from fyrox_tpu_torch.physics.world import PhysicsBuilder

torch.set_num_threads(2)

DT = 1.0 / 60.0
TOL = 1e-5       # tests/test_oracle.py's tol


def stack():
    """tests/test_oracle.py's _stack: three unit cubes on a halfspace."""
    pb = PhysicsBuilder()
    g = pb.add_body(body_type=1)
    pb.add_collider(g, sh.HALFSPACE, [], friction=0.8)
    for k in range(3):
        b = pb.add_body(position=(0.02 * k, 0.55 + 1.08 * k, -0.01 * k))
        pb.add_collider(b, sh.CUBOID, [0.5, 0.5, 0.5], friction=0.8)
    return pb


def mixed_cluster():
    """tests/test_oracle.py's _mixed_cluster: balls, cuboids and capsules
    on a halfspace."""
    rng = np.random.default_rng(3)
    pb = PhysicsBuilder()
    g = pb.add_body(body_type=1)
    pb.add_collider(g, sh.HALFSPACE, [], friction=0.5, restitution=0.2)
    shapes = [(sh.BALL, [0.25]), (sh.CUBOID, [0.2, 0.25, 0.2]),
              (sh.CAPSULE, [0.2, 0.15])]
    for i in range(9):
        kind, params = shapes[i % 3]
        p = (rng.uniform(-0.8, 0.8), 0.5 + 0.5 * (i // 3),
             rng.uniform(-0.8, 0.8))
        b = pb.add_body(position=p)
        pb.add_collider(b, kind, params, friction=0.4, restitution=0.1)
    return pb


@pytest.mark.parametrize("scene,samples", [
    ("stack", {0, 10, 19}), ("mixed", {0, 8, 19})])
def test_slab_staged_step_matches_the_oracle(scene, samples):
    pb = stack() if scene == "stack" else mixed_cluster()
    t = pb.build(broadphase="slab")
    s = tworld.init_physics_state(pb, t, 1, device="cpu")
    worst = 0.0
    live = 0
    for i in range(max(samples) + 1):
        if i in samples:
            cold = s._replace(warm_n=torch.zeros_like(s.warm_n),
                              warm_t1=torch.zeros_like(s.warm_t1),
                              warm_t2=torch.zeros_like(s.warm_t2))
            dev = tworld.step_physics(cold, t, DT, fused=False)
            ref = orc.oracle_step(orc.state_from_device(
                convert.to_numpy(cold)), t, DT)
            for f in ("position", "linvel", "angvel"):
                worst = max(worst, float(np.abs(
                    getattr(dev, f)[0].double().numpy()
                    - getattr(ref, f)).max()))
            live += int((dev.warm_n != 0).sum())
        s = tworld.step_physics(s, t, DT, fused=False)
    assert live > 0          # the sampled steps solved contacts
    assert worst < TOL, worst
