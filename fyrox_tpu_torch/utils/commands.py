"""Command stack: undo/redo over functional state (the port's copy of
``fyrox_tpu.utils.commands``).

Equivalent of the editor's command machinery (editor/src/command/ — every
edit is a Command with execute/revert, pushed on a stack with undo/redo
cursors). The engine's states are immutable PyTrees/dataclasses, so a
command here is simply (describe, apply) where apply is a pure
state → state function; revert falls out of keeping the pre-state —
no per-command inverse logic needed, which is the functional win.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

__all__ = ["Command", "CommandStack"]


@dataclass
class Command:
    name: str
    apply: Callable[[Any], Any]


class CommandStack:
    """Undo/redo cursor over snapshots of a functional state.

    stack = CommandStack(initial_state)
    stack.do(Command("move node", lambda s: reflect.set_path(s, ...)))
    stack.undo(); stack.redo()
    """

    def __init__(self, state, limit: int = 256):
        self._states: List[Any] = [state]
        self._names: List[str] = []
        self._cursor = 0            # index into _states
        self.limit = limit

    @property
    def state(self):
        return self._states[self._cursor]

    @property
    def can_undo(self) -> bool:
        return self._cursor > 0

    @property
    def can_redo(self) -> bool:
        return self._cursor < len(self._states) - 1

    def do(self, command: Command):
        """Execute: truncates any redo branch (editor stack semantics)."""
        new_state = command.apply(self.state)
        del self._states[self._cursor + 1:]
        del self._names[self._cursor:]
        self._states.append(new_state)
        self._names.append(command.name)
        self._cursor += 1
        if len(self._states) > self.limit:
            drop = len(self._states) - self.limit
            del self._states[:drop]
            del self._names[:drop]
            self._cursor -= drop
        return new_state

    def undo(self) -> Optional[str]:
        """Step back; returns the undone command's name (or None)."""
        if not self.can_undo:
            return None
        self._cursor -= 1
        return self._names[self._cursor]

    def redo(self) -> Optional[str]:
        if not self.can_redo:
            return None
        name = self._names[self._cursor]
        self._cursor += 1
        return name

    def history(self) -> List[Tuple[str, bool]]:
        """[(name, applied)] — the editor's command list panel."""
        return [(n, i < self._cursor) for i, n in enumerate(self._names)]
