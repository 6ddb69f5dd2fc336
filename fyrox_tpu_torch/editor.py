"""Editor session: selection, gizmo transform commands, world outliner,
play-mode preview (the port's copy of ``fyrox_tpu.editor``).

Equivalent of the editor layer (editor/src/lib.rs:329 Mode Edit/Play,
editor/src/scene/commands/graph.rs:43/140/185 Move/Scale/RotateNodeCommand,
editor/src/world/ outliner). The TPU redesign: the edited scene is the
engine's immutable EngineState, so every gizmo command is a pure
state → state function on the CommandStack (undo = cursor move, no
inverse commands), and play mode is a snapshot + a fixed-timestep
Executor over the SAME state — stop simply restores the snapshot instead
of killing a child process.

In the port the states are tensors that could be written in place, so the
design holds only while nothing writes a state the stack keeps: every
gizmo command clones the column it changes (on the state's device) and
builds a new state, and play mode's ticks (``script.Executor``: on the
card, replays of the engine's captured tick, which copy the state into the
graph's own buffers and clone the result out) never write their input.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from fyrox_tpu_torch.scene import graph as graph_mod
from fyrox_tpu_torch.script import Executor
from fyrox_tpu_torch.utils.commands import Command, CommandStack

__all__ = ["EditorSession", "OutlinerNode"]


@dataclass
class OutlinerNode:
    """World-outliner row (editor/src/world/)."""
    index: int
    name: str
    depth: int
    children: List[int]


def _quat_mul(a, b):
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz], -1)


class EditorSession:
    """Edit a scene with undoable commands; preview it in play mode.

    engine: fyrox_tpu_torch.engine.Engine; state: its EngineState (the edit
    scene — typically W=1 for editing)."""

    def __init__(self, engine, state):
        self.engine = engine
        self.stack = CommandStack(state)
        self.selection: List[int] = []      # node indices
        self.mode = "edit"                  # "edit" | "play"
        self._executor: Optional[Executor] = None

    # -- state access -------------------------------------------------------
    @property
    def state(self):
        if self.mode == "play" and self._executor is not None:
            return self._executor.state
        return self.stack.state

    # -- selection ----------------------------------------------------------
    def select(self, *nodes: int):
        self.selection = list(nodes)

    # -- outliner (world viewer) --------------------------------------------
    def outliner(self) -> List[OutlinerNode]:
        t = self.engine.template
        parent = np.asarray(t.parent)
        names = getattr(t, "names", None) or [f"node{i}"
                                              for i in range(t.num_nodes)]
        children = [[] for _ in range(t.num_nodes)]
        for i, p in enumerate(parent):
            if p >= 0:
                children[p].append(i)
        depth = np.zeros(t.num_nodes, np.int32)
        order = []

        def walk(i, d):
            depth[i] = d
            order.append(i)
            for c in children[i]:
                walk(c, d + 1)
        for i, p in enumerate(parent):
            if p < 0:
                walk(i, 0)
        return [OutlinerNode(i, str(names[i]), int(depth[i]), children[i])
                for i in order]

    # -- gizmo transform commands (scene/commands/graph.rs) -----------------
    def _transform_command(self, name, node, fn):
        def apply(state):
            scene = fn(state.scene)
            scene = graph_mod.update_hierarchical_data(
                scene, self.engine.template)
            return state._replace(scene=scene)
        self.stack.do(Command(name, apply))

    @staticmethod
    def _column(x, node, fn):
        """A copy of x with x[:, node] replaced by fn(x[:, node])."""
        out = x.clone()
        out[:, node] = fn(x[:, node])
        return out

    @staticmethod
    def _vec(v, like):
        return torch.as_tensor(np.asarray(v, np.float32), device=like.device)

    def translate(self, node: int, delta):
        """MoveNodeCommand (graph.rs:43)."""
        def fn(scene):
            d = self._vec(delta, scene.position)
            return scene._replace(position=self._column(
                scene.position, node, lambda p: p + d))
        self._transform_command(f"move node {node}", node, fn)

    def rotate(self, node: int, quat):
        """RotateNodeCommand (graph.rs:185): pre-multiply local rotation."""
        def fn(scene):
            q = self._vec(quat, scene.rotation)
            return scene._replace(rotation=self._column(
                scene.rotation, node, lambda cur: _quat_mul(q, cur)))
        self._transform_command(f"rotate node {node}", node, fn)

    def scale(self, node: int, factor):
        """ScaleNodeCommand (graph.rs:140)."""
        def fn(scene):
            f = self._vec(factor, scene.scale)
            return scene._replace(scale=self._column(
                scene.scale, node, lambda s: s * f))
        self._transform_command(f"scale node {node}", node, fn)

    def undo(self):
        return self.stack.undo()

    def redo(self):
        return self.stack.redo()

    # -- play mode (lib.rs:329 Mode::Play; preview.rs) ----------------------
    def play(self, update_rate: float = 60.0) -> Executor:
        """Enter play mode: snapshot the edit state and hand it to a
        fixed-timestep Executor. Scripts registered on the returned
        executor run exactly as in the standalone game loop."""
        if self.mode == "play":
            return self._executor
        self._executor = Executor(self.engine, self.stack.state,
                                  update_rate=update_rate)
        self.mode = "play"
        return self._executor

    def tick(self, duration_s: float, on_frame=None):
        """Advance play-mode simulation time."""
        assert self.mode == "play", "enter play() first"
        self._executor.run(duration_s, on_frame=on_frame, realtime=False)
        return self._executor.state

    def pause(self):
        """Freeze play mode, keeping the simulated state inspectable."""
        assert self.mode == "play"
        self.mode = "paused"

    def resume(self):
        assert self.mode == "paused"
        self.mode = "play"

    def stop(self):
        """Leave play mode and restore the pre-play edit state — the
        functional equivalent of killing the play process (Mode::Play)."""
        if self.mode in ("play", "paused"):
            self._executor = None
            self.mode = "edit"
        # edit state was never touched: stack.state is the snapshot
        return self.stack.state
