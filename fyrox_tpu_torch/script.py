"""Script system and the fixed-timestep game loop (the port's
``fyrox_tpu.script``).

The reference's ``ScriptTrait`` (fyrox-impl/src/script/mod.rs:601:
on_init / on_start / on_update / on_message), ``ScriptProcessor``
(engine/mod.rs:612) and the ``Executor`` loop (engine/executor.rs:62,
DEFAULT_UPDATE_RATE = 60 at :87, the lag accumulator at :475-512).

Scripts are batched: one script instance runs its logic for every world
at once. ``on_update(ctx)`` sees the whole EngineState and sets
``ctx.state`` to a new one; it builds new tensors and writes none of the
state it was given, which may be a captured tick's output or a state that
a checkpoint or another script still holds. Scripts run between ticks, on
the state's device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

__all__ = ["Script", "ScriptContext", "ScriptProcessor", "Executor",
           "DEFAULT_UPDATE_RATE"]

DEFAULT_UPDATE_RATE = 60.0  # executor.rs:87


@dataclass
class ScriptContext:
    """What a script sees each tick (script/mod.rs ScriptContext)."""
    dt: float
    engine: Any
    state: Any
    messages: List[Any] = field(default_factory=list)


class Script:
    """Subclass and override the lifecycle hooks (ScriptTrait)."""

    def on_init(self, ctx: ScriptContext):
        """Called once before the first update (script/mod.rs:611)."""

    def on_start(self, ctx: ScriptContext):
        """Called after every script's on_init ran."""

    def on_update(self, ctx: ScriptContext):
        """Called every tick; set ctx.state to a new state to change the
        worlds. The return value is ignored."""

    def on_message(self, ctx: ScriptContext, message):
        """Reacts to messages routed by the processor (script/mod.rs:686)."""


class ScriptProcessor:
    """Drains the scripts' lifecycles once a tick (engine/mod.rs:612):
    on_init for all, on_start for all (first tick only), the queued
    messages to every script, then on_update for all."""

    def __init__(self):
        self._scripts: List[Script] = []
        self._initialized = False
        self._queue: List[Any] = []

    def add(self, script: Script) -> Script:
        self._scripts.append(script)
        return script

    def send_message(self, message):
        self._queue.append(message)

    def update(self, engine, state, dt):
        ctx = ScriptContext(dt=dt, engine=engine, state=state)
        if not self._initialized:
            for s in self._scripts:
                s.on_init(ctx)
            for s in self._scripts:
                s.on_start(ctx)
            self._initialized = True
        msgs, self._queue = self._queue, []
        for m in msgs:
            for s in self._scripts:
                s.on_message(ctx, m)
        for s in self._scripts:
            s.on_update(ctx)
        return ctx.state


class Executor:
    """Fixed-timestep game loop (executor.rs:62): accumulate real time,
    step the engine at exactly `update_rate` Hz with a spike throttle, and
    hand each rendered-frame opportunity to `on_frame`.

    A tick is the scripts' update, then one engine tick: on the card,
    where the engine's tick captures (``Engine._capturable``), a replay of
    its captured CUDA graph (``Engine.captured_tick(state).run(state,
    None, 1)``, the JAX package's ``jax.jit(engine.step)``), else an
    eager ``Engine.step``. Both give the same state bit for bit."""

    def __init__(self, engine, state, update_rate: float = DEFAULT_UPDATE_RATE,
                 max_lag_steps: int = 10):
        self.engine = engine
        self.state = state
        self.dt = 1.0 / update_rate
        self.max_lag_steps = max_lag_steps  # spike throttle (executor.rs:487)
        self.scripts = ScriptProcessor()

    def _tick(self, state):
        if state.scene.position.is_cuda and self.engine._capturable():
            return self.engine.captured_tick(state).run(state, None, 1)
        return self.engine.step(state)

    def run(self, duration_s: float,
            on_frame: Optional[Callable[[Any], None]] = None,
            realtime: bool = False):
        """Run the loop for `duration_s` of simulated time. With
        realtime=False (headless benchmarking, training) ticks run back to
        back, as the reference's headless tests do."""
        total_steps = round(duration_s / self.dt)
        done = 0
        lag = 0.0
        last = time.perf_counter()
        while done < total_steps:
            if realtime:
                now = time.perf_counter()
                lag += now - last
                last = now
                lag = min(lag, self.max_lag_steps * self.dt)
            else:
                lag = self.dt
            while lag >= self.dt - 1e-12 and done < total_steps:
                self.state = self.scripts.update(self.engine, self.state,
                                                 self.dt)
                self.state = self._tick(self.state)
                lag -= self.dt
                done += 1
            if on_frame is not None:
                on_frame(self.state)
        return self.state
