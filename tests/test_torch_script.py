"""Port parity: the script system, the Executor and the stock camera
scripts of fyrox_tpu_torch against fyrox_tpu's on the CPU.

Mirrors tests/test_queries_scripts.py (TestScripts, TestStockScripts): the
lifecycle order and message routing, the fixed timestep, and the camera
controllers' yaw / pitch / radius and the camera node's transform after 10
updates from the same seeded per-world inputs, within 1e-6. The loop's
spike throttle is held against the JAX Executor under the same fake clock
on a scene-only engine (its jitted tick is a hierarchy pass). The
Executor's ticks equal the same script calls and eager Engine.step calls
by hand, bit for bit.
"""
import time

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fyrox_tpu.engine import Engine as JEngine
from fyrox_tpu.render import make_cube as jmake_cube
from fyrox_tpu.scene import SceneBuilder as JSceneBuilder
from fyrox_tpu.script import Executor as JExecutor
from fyrox_tpu.script import ScriptProcessor as JScriptProcessor
from fyrox_tpu.scripts import FlyingCameraController as JFlying
from fyrox_tpu.scripts import OrbitCameraController as JOrbit
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.engine import Engine, _leaves
from fyrox_tpu_torch.models import build_flagship
from fyrox_tpu_torch.script import (DEFAULT_UPDATE_RATE, Executor, Script,
                                    ScriptProcessor)
from fyrox_tpu_torch.scripts import (FlyingCameraController,
                                     OrbitCameraController)

torch.set_num_threads(2)

TOL = 1e-6
W = 3


def _camera_scene():
    """tests/test_queries_scripts.py's scene: a cube and a camera (JAX
    builders; the port takes the converted template)."""
    sb = JSceneBuilder()
    sb.add_mesh(jmake_cube(1.0), position=(0, 0, 0))
    cam = sb.add_camera("cam", position=(0, 1.0, -5.0))
    je = JEngine(template=sb.build())
    te = Engine(template=convert.scene_template(je.template))
    return je, te, cam


def _states(je, te, w):
    js = je.init_state(num_worlds=w)
    return js, te.init_state(w, device="cpu")


def test_lifecycle_order_and_messages():
    calls = []

    class S(Script):
        def __init__(self, tag):
            self.tag = tag

        def on_init(self, ctx):
            calls.append(("init", self.tag))

        def on_start(self, ctx):
            calls.append(("start", self.tag))

        def on_update(self, ctx):
            calls.append(("update", self.tag))

        def on_message(self, ctx, m):
            calls.append(("msg", self.tag, m))

    sp = ScriptProcessor()
    sp.add(S("a"))
    sp.add(S("b"))
    sp.send_message("hello")
    sp.update(None, None, 1 / 60)
    assert calls == [("init", "a"), ("init", "b"), ("start", "a"),
                     ("start", "b"), ("msg", "a", "hello"),
                     ("msg", "b", "hello"), ("update", "a"), ("update", "b")]
    calls.clear()
    sp.update(None, None, 1 / 60)          # no second init / start
    assert calls == [("update", "a"), ("update", "b")]
    assert DEFAULT_UPDATE_RATE == 60.0


def test_executor_fixed_timestep_equals_the_ticks_by_hand():
    engine, _ = build_flagship(n_bones=4, n_verts=16, n_bodies=2)
    state = engine.init_state(2, device="cpu")

    class Push(Script):
        """Adds a per-world velocity to body 1 each tick, out of place."""
        def __init__(self):
            self.dts = []

        def on_update(self, ctx):
            self.dts.append(ctx.dt)
            ph = ctx.state.physics
            lv = ph.linvel + torch.tensor([[0.1], [0.2]])[:, :, None] * \
                torch.tensor([1.0, 0.0, 0.0])
            ctx.state = ctx.state._replace(physics=ph._replace(linvel=lv))

    ex = Executor(engine, state)
    push = ex.scripts.add(Push())
    frames = []
    out = ex.run(duration_s=0.5, on_frame=frames.append)
    assert len(push.dts) == 30 and len(frames) == 30   # 0.5 s at 60 Hz
    assert abs(float(out.scene.time[0]) - 0.5) < 1e-4
    # the same script calls and eager ticks by hand, bit for bit
    sp = ScriptProcessor()
    sp.add(Push())
    s = state
    for _ in range(30):
        s = engine.step(sp.update(engine, s, 1 / 60))
    for a, b in zip(_leaves(out), _leaves(s)):
        assert torch.equal(a, b)
    # the state given to the run was not written
    assert torch.equal(state.physics.linvel,
                       engine.init_state(2, device="cpu").physics.linvel)


def test_realtime_loop_throttles_spikes_as_jax_does(monkeypatch):
    """realtime=True under a fake clock with a 0.5 s spike: the lag is
    capped at max_lag_steps ticks and the tick and frame counts equal the
    JAX Executor's under the same clock."""
    je, te, cam = _camera_scene()
    gaps = [0.004, 0.02, 0.5, 0.016, 0.03, 0.0]

    def counts(executor_cls, engine, state):
        clock = iter(np.cumsum([0.0] + gaps * 50).tolist())
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        ex = executor_cls(engine, state, max_lag_steps=4)
        ticks, frames = [], []

        class Tick:
            def on_init(self, ctx):
                pass

            def on_start(self, ctx):
                pass

            def on_message(self, ctx, m):
                pass

            def on_update(self, ctx):
                ticks.append(1)

        ex.scripts.add(Tick())
        ex.run(duration_s=1.0, on_frame=lambda s: frames.append(len(ticks)),
               realtime=True)
        monkeypatch.undo()
        return len(ticks), frames

    js, ts = _states(je, te, 1)
    jt, jf = counts(JExecutor, je, js)
    tt, tf = counts(Executor, te, ts)
    assert (tt, tf) == (jt, jf) and tt == 60
    assert max(np.diff([0] + tf)) == 4      # the spike ran 4 ticks at most


def _inputs(seed, w, cols=2):
    rng = np.random.default_rng(seed)
    return rng.uniform(-20, 20, (w, cols)).astype(np.float32)


def test_flying_camera_matches_jax():
    je, te, cam = _camera_scene()
    js, ts = _states(je, te, W)
    jsp, tsp = JScriptProcessor(), ScriptProcessor()
    jc = jsp.add(JFlying(cam, W, speed=2.0, sensitivity=1e-2))
    tc = tsp.add(FlyingCameraController(cam, W, speed=2.0, sensitivity=1e-2,
                                        device="cpu"))
    mouse, move = _inputs(0, W), np.clip(_inputs(1, W) / 20, -1, 1)
    mouse[0, 1] = 1e4             # world 0 hits the pitch limit
    for c in (jc, tc):
        c.set_input(mouse_delta=mouse, move_axes=move)
    given = ts.scene.position.clone()
    for _ in range(10):
        js = jsp.update(je, js, 1 / 60)
        ts = tsp.update(te, ts, 1 / 60)
    assert torch.equal(given, te.init_state(W, device="cpu").scene.position)
    np.testing.assert_allclose(tc.yaw.numpy(), np.asarray(jc.yaw), atol=TOL)
    np.testing.assert_allclose(tc.pitch.numpy(), np.asarray(jc.pitch),
                               atol=TOL)
    assert float(tc.pitch.max()) <= np.deg2rad(89.9) + 1e-6
    for f in ("position", "rotation"):
        np.testing.assert_allclose(getattr(ts.scene, f).numpy(),
                                   np.asarray(getattr(js.scene, f)),
                                   atol=TOL)
    assert not torch.equal(ts.scene.position[0, cam], given[0, cam])


def test_orbit_camera_matches_jax():
    je, te, cam = _camera_scene()
    js, ts = _states(je, te, 2)
    jsp, tsp = JScriptProcessor(), ScriptProcessor()
    jc = jsp.add(JOrbit(cam, 2, target=(0, 0, 0), radius=5.0,
                        sensitivity=5e-3))
    tc = tsp.add(OrbitCameraController(cam, 2, target=(0, 0, 0), radius=5.0,
                                       sensitivity=5e-3, device="cpu"))
    mouse = _inputs(2, 2)
    zoom = np.asarray([0.5, -0.3], np.float32)
    for c in (jc, tc):
        c.set_input(mouse_delta=mouse, zoom=zoom)
    for _ in range(10):
        js = jsp.update(je, js, 1 / 60)
        ts = tsp.update(te, ts, 1 / 60)
    for a, b in ((tc.yaw, jc.yaw), (tc.pitch, jc.pitch),
                 (tc.radius, jc.radius)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL * 5)
    for f in ("position", "rotation"):
        np.testing.assert_allclose(getattr(ts.scene, f).numpy(),
                                   np.asarray(getattr(js.scene, f)),
                                   atol=TOL * 5)
    r = torch.linalg.vector_norm(ts.scene.position[:, cam], dim=-1)
    np.testing.assert_allclose(r.numpy(), tc.radius.numpy(), rtol=1e-6)
