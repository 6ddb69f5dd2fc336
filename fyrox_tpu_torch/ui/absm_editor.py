"""ABSM editor panel: the state-machine authoring surface, headless.

Equivalent of the editor's ABSM plugin (ref: editor/src/plugins/absm/ —
state_graph/ canvas with draggable state nodes, transition.rs edges,
parameter.rs panel, toolbar.rs preview toggle, command/ undo stack). The
batched engine has no windowed shell, so the panel is a functional
document + command model: every edit is a `Command` on the shared
`CommandStack` (utils/commands.py), `compile()` lowers the document to a
runtime `MachineTemplate`, and `preview()` drives the real
`update_machine` — the editor's play-preview — returning the active
state trace.

The document is an immutable snapshot (tuples), so undo/redo fall out of
the functional command stack with no per-command inverse logic.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple

import numpy as np
import torch

from fyrox_tpu_torch.animation import machine as machine_mod
from fyrox_tpu_torch.utils.commands import Command, CommandStack

__all__ = ["AbsmDocument", "AbsmState", "AbsmTransition", "AbsmEditor"]


@dataclass(frozen=True)
class AbsmState:
    """One state node on the graph canvas (absm/node.rs)."""
    name: str
    clips: Tuple[Tuple[int, float], ...] = ()   # (clip, weight) pose source
    position: Tuple[float, float] = (0.0, 0.0)  # canvas placement


@dataclass(frozen=True)
class AbsmTransition:
    """A directed edge between states (absm/transition.rs)."""
    src: int
    dst: int
    param: int
    duration: float = 0.3
    invert: bool = False


@dataclass(frozen=True)
class AbsmDocument:
    """Immutable ABSM document snapshot (the command-stack state)."""
    states: Tuple[AbsmState, ...] = ()
    transitions: Tuple[AbsmTransition, ...] = ()
    params: Tuple[str, ...] = ()
    entry: int = 0


class AbsmEditor:
    """Headless ABSM editor session over a CommandStack.

    edits → document snapshots; `compile()` → MachineTemplate;
    `preview(param_rows)` → active-state trace via update_machine."""

    def __init__(self, doc: Optional[AbsmDocument] = None):
        self.stack = CommandStack(doc or AbsmDocument())
        self.selection: Tuple[str, int] = ("none", -1)  # (kind, index)

    @property
    def doc(self) -> AbsmDocument:
        return self.stack.state

    # ---- selection (absm/selection.rs) ----
    def select_state(self, i: int):
        self.selection = ("state", int(i))

    def select_transition(self, i: int):
        self.selection = ("transition", int(i))

    # ---- commands (absm/command/) ----
    def add_state(self, name: str, clips=((0, 1.0),),
                  position=(0.0, 0.0)) -> int:
        idx = len(self.doc.states)
        st = AbsmState(name=name, clips=tuple(tuple(c) for c in clips),
                       position=tuple(position))
        self.stack.do(Command(
            f"Add State '{name}'",
            lambda d: replace(d, states=d.states + (st,))))
        return idx

    def remove_state(self, i: int):
        """Removes the state and every transition touching it; indices
        above shift down (state_graph/mod.rs delete semantics)."""
        def apply(d: AbsmDocument) -> AbsmDocument:
            states = d.states[:i] + d.states[i + 1:]

            def shift(x):
                return x - 1 if x > i else x

            trans = tuple(
                replace(t, src=shift(t.src), dst=shift(t.dst))
                for t in d.transitions if t.src != i and t.dst != i)
            entry = shift(d.entry) if d.entry != i else 0
            return replace(d, states=states, transitions=trans, entry=entry)

        self.stack.do(Command(f"Remove State {i}", apply))

    def move_state(self, i: int, position):
        pos = tuple(float(p) for p in position)
        self.stack.do(Command(
            f"Move State {i}",
            lambda d: replace(d, states=d.states[:i] + (
                replace(d.states[i], position=pos),) + d.states[i + 1:])))

    def rename_state(self, i: int, name: str):
        self.stack.do(Command(
            f"Rename State {i} -> '{name}'",
            lambda d: replace(d, states=d.states[:i] + (
                replace(d.states[i], name=name),) + d.states[i + 1:])))

    def set_state_clips(self, i: int, clips):
        cl = tuple(tuple(c) for c in clips)
        self.stack.do(Command(
            f"Set State {i} pose source",
            lambda d: replace(d, states=d.states[:i] + (
                replace(d.states[i], clips=cl),) + d.states[i + 1:])))

    def set_entry(self, i: int):
        self.stack.do(Command(f"Set Entry State {i}",
                              lambda d: replace(d, entry=int(i))))

    def add_parameter(self, name: str) -> int:
        idx = len(self.doc.params)
        self.stack.do(Command(
            f"Add Parameter '{name}'",
            lambda d: replace(d, params=d.params + (name,))))
        return idx

    def add_transition(self, src: int, dst: int, param: int,
                       duration: float = 0.3, invert: bool = False) -> int:
        idx = len(self.doc.transitions)
        tr = AbsmTransition(src=int(src), dst=int(dst), param=int(param),
                            duration=float(duration), invert=bool(invert))
        self.stack.do(Command(
            f"Add Transition {src}->{dst}",
            lambda d: replace(d, transitions=d.transitions + (tr,))))
        return idx

    def remove_transition(self, i: int):
        self.stack.do(Command(
            f"Remove Transition {i}",
            lambda d: replace(d, transitions=d.transitions[:i]
                              + d.transitions[i + 1:])))

    def set_transition_duration(self, i: int, duration: float):
        self.stack.do(Command(
            f"Set Transition {i} duration",
            lambda d: replace(d, transitions=d.transitions[:i] + (
                replace(d.transitions[i], duration=float(duration)),)
                + d.transitions[i + 1:])))

    def undo(self):
        return self.stack.undo()

    def redo(self):
        return self.stack.redo()

    # ---- validation (state_viewer error panel) ----
    def problems(self) -> List[str]:
        d = self.doc
        out = []
        n = len(d.states)
        if n == 0:
            out.append("machine has no states")
            return out
        if not (0 <= d.entry < n):
            out.append(f"entry state {d.entry} out of range")
        for k, t in enumerate(d.transitions):
            if not (0 <= t.src < n and 0 <= t.dst < n):
                out.append(f"transition {k} references a missing state")
            if not (0 <= t.param < len(d.params)):
                out.append(f"transition {k} references a missing parameter")
        reachable = {d.entry}
        frontier = [d.entry]
        while frontier:
            s = frontier.pop()
            for t in d.transitions:
                if t.src == s and t.dst not in reachable:
                    reachable.add(t.dst)
                    frontier.append(t.dst)
        for i in range(n):
            if i not in reachable:
                out.append(f"state {i} '{d.states[i].name}' unreachable "
                           "from entry")
        return out

    # ---- lowering + preview (toolbar.rs preview mode) ----
    def compile(self) -> machine_mod.MachineTemplate:
        d = self.doc
        mb = machine_mod.MachineBuilder()
        for p in d.params:
            mb.add_parameter(p)
        for s in d.states:
            mb.add_state(s.name, clips=list(s.clips))
        mb.set_entry_state(d.entry)
        for t in d.transitions:
            mb.add_transition(t.src, t.dst, t.param,
                              duration=t.duration, invert=t.invert)
        return mb.build()

    def preview(self, param_rows, dt=1.0 / 60.0, device="cuda") -> List[int]:
        """Run the REAL machine over a [steps, P] bool parameter sequence
        (W=1) on `device` and return the active-state index per step."""
        mt = self.compile()
        ms = machine_mod.init_machine_state(mt, 1, device=device)
        trace = []
        for row in np.atleast_2d(np.asarray(param_rows, bool)):
            row = torch.as_tensor(row, device=ms.current.device)
            ms = machine_mod.update_machine(mt, ms, row[None], dt)
            trace.append(int(ms.current[0]))
        return trace
