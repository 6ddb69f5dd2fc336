"""Port parity of Engine.rollout, world_health and restore_unhealthy:
fyrox_tpu_torch against fyrox_tpu (fyrox_tpu/engine.py:275-316) on the
small flagship (10 bones, 300 vertices, 192 bodies), with the port's state
carried over by convert.py. The captured CUDA graph that rollout replays
on the card is held to eager steps by tests/test_torch_gpu.py and
chip_smoke.py; here, on the CPU, rollout is the plain loop and
CapturedTick.advance (the work the graph holds) runs eagerly."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fyrox_tpu import engine as jengine
from fyrox_tpu.models import build_flagship as jax_build_flagship
from fyrox_tpu_torch import convert
from fyrox_tpu_torch import engine as tengine

torch.set_num_threads(2)

W, TICKS = 2, 6
PARAMS = np.array([[False], [True]])      # the ABSM's `run` rule per world


def _falling(je, w):
    """je.init_state(w) with every dynamic body falling at 5 m/s (world k
    at 5 · 1.2^k), so that the pile meets the ground and itself inside 6
    ticks (it starts 0.35 m up): the jitted JAX tick costs ~3.5 s on the
    CPU."""
    js = je.init_state(num_worlds=w)
    dyn = (np.asarray(je.physics.body_type) == 0)[None, :, None]
    v = np.where(dyn, np.float32([0.0, -5.0, 0.0]), np.float32(0.0))
    v = v * (1.2 ** np.arange(w, dtype=np.float32))[:, None, None]
    v = np.broadcast_to(v, js.physics.linvel.shape).astype(np.float32)
    return js._replace(physics=js.physics._replace(linvel=jnp.asarray(v)))


@pytest.fixture(scope="module", autouse=True)
def _fresh_perm_cache():
    """fyrox_tpu's pallas_ops._perm_idx caches by id() of a template's
    matrices: no entry may serve a template that took a freed one's id."""
    from fyrox_tpu.physics import pallas_ops
    pallas_ops._PERM_CACHE.clear()
    yield
    pallas_ops._PERM_CACHE.clear()


@pytest.fixture(scope="module")
def flagship():
    je, _ = jax_build_flagship(n_bones=10, n_verts=300, n_bodies=192)
    js = _falling(je, W)
    ts = convert.engine_state(jax.tree_util.tree_map(np.asarray, js),
                              device="cpu")
    return je, convert.engine(je), js, ts


def _assert_same(got, want):
    a, b = tengine._leaves(got), tengine._leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and torch.equal(x, y)


def test_rollout_equals_the_step_loop(flagship):
    _, te, _, ts = flagship
    p = torch.as_tensor(PARAMS)
    want = ts
    for _ in range(TICKS):
        want = te.step(want, machine_params=p)
    _assert_same(te.rollout(ts, TICKS, machine_params=p), want)
    _assert_same(te.rollout(ts, 0, machine_params=p), ts)
    with pytest.raises(ValueError):
        te.rollout(ts, -1)


def test_captured_tick_advances_as_the_step_loop(flagship):
    """The captured graph's work, run eagerly: a tick on static buffers
    with its outputs copied back, three times, equals three steps bit for
    bit, and the caller's state is not written."""
    _, te, _, ts = flagship
    before = convert.to_numpy(ts)
    p = torch.as_tensor(PARAMS)
    tick = tengine.CapturedTick(te, ts, p, True, "sort")
    assert all(x.is_contiguous() for x in tengine._leaves(tick.static))
    want = ts
    for _ in range(3):
        tick.advance()
        want = te.step(want, machine_params=p)
    _assert_same(tick.static, want)
    for x, y in zip(tengine._leaves(ts), tengine._leaves(before)):
        np.testing.assert_array_equal(x.numpy(), y)


@pytest.fixture(scope="module")
def rolled(flagship):
    """TICKS ticks of both packages' rollout: JAX's jitted (one lax.scan),
    the port's on CPU tensors."""
    je, te, js, ts = flagship
    jout = jax.jit(lambda s, p: je.rollout(s, TICKS, machine_params=p))(
        js, jnp.asarray(PARAMS))
    tout = te.rollout(ts, TICKS, machine_params=torch.as_tensor(PARAMS))
    return jax.tree_util.tree_map(np.asarray, jout), convert.to_numpy(tout)


# Bounds: positions within tests/test_engine.py:56's 1e-5 (rollout vs
# stepping); velocities within 1e-4, ten times the JAX package's one-step
# velocity bound between two implementations (test_pallas_step.py:102-105),
# for XLA's fused multiply-adds (measured: 1.2e-7 m, 7.5e-6 m/s, 396 live
# contact slots at tick 6).
@pytest.mark.parametrize("part,field,bound", [
    ("physics", "position", 1e-5), ("physics", "rotation", 1e-5),
    ("physics", "linvel", 1e-4), ("physics", "angvel", 1e-4),
    ("scene", "position", 1e-5), ("scene", "globals_", 1e-5)])
def test_rollout_matches_jax_rollout(rolled, part, field, bound):
    js, ts = rolled
    d = np.abs(getattr(getattr(js, part), field)
               - getattr(getattr(ts, part), field))
    assert d.max() < bound, d.max()


def test_rolled_pile_is_in_contact(rolled):
    js, ts = rolled
    assert (ts.physics.warm_pair >= 0).sum() > 0
    assert (js.physics.warm_pair >= 0).sum() > 0
    np.testing.assert_array_equal(js.animation.machine.current,
                                  ts.animation.machine.current)
    np.testing.assert_allclose(js.animation.anim.time,
                               ts.animation.anim.time, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def sick(flagship):
    """Four worlds (JAX and port) with values injected: world 1 a NaN
    body position, world 3 a NaN animation time, world 0 +inf in a body
    velocity and world 2 +inf in a node lifetime (+inf is a sentinel, not
    a fault); and a fallback state."""
    je = flagship[0]
    js = _falling(je, 4)
    ph, sc, an = js.physics, js.scene, js.animation
    js = js._replace(
        physics=ph._replace(position=ph.position.at[1, 5, 1].set(jnp.nan),
                            linvel=ph.linvel.at[0, 7, 0].set(jnp.inf)),
        scene=sc._replace(lifetime=sc.lifetime.at[2, 3].set(jnp.inf)),
        animation=an._replace(anim=an.anim._replace(
            time=an.anim.time.at[3, 0].set(jnp.nan))))
    jfb = je.init_state(num_worlds=4)

    def port(s):
        return convert.engine_state(jax.tree_util.tree_map(np.asarray, s),
                                    device="cpu")

    return js, jfb, port(js), port(jfb)


def test_world_health_matches_jax(sick):
    js, _, ts, _ = sick
    want = np.asarray(jengine.world_health(js))
    got = tengine.world_health(ts)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(want, [True, False, True, False])
    np.testing.assert_array_equal(got.numpy(), want)


def test_restore_unhealthy_matches_jax(sick):
    js, jfb, ts, tfb = sick
    jout = convert.engine_state(jax.tree_util.tree_map(
        np.asarray, jengine.restore_unhealthy(js, jfb)), device="cpu")
    tout = tengine.restore_unhealthy(ts, tfb)
    for a, b in zip(tengine._leaves(tout), tengine._leaves(jout)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert bool(tengine.world_health(tout).all())
    # healthy worlds keep their values (the +inf sentinels included), the
    # others take the fallback's
    assert torch.equal(tout.physics.linvel[0], ts.physics.linvel[0])
    assert torch.equal(tout.scene.lifetime[2], ts.scene.lifetime[2])
    assert torch.equal(tout.physics.position[1], tfb.physics.position[1])
    assert torch.equal(tout.animation.anim.time[3],
                       tfb.animation.anim.time[3])


def test_bench_torch_needs_a_card():
    """bench_torch.py measures on a CUDA card only: where torch sees none
    it exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "needs a CUDA card" in out.stderr and "{" not in out.stdout
