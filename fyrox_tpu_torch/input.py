"""Aggregated input state (the port's copy of ``fyrox_tpu.input``).

Equivalent of the reference's engine input aggregation (fyrox-impl/src/
engine/input.rs: keyboard/mouse state accumulated from OS events, reset in
post_update). Scripts read it through their context; for batched RL-style
control the same structure holds per-world action arrays instead.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Set, Tuple

__all__ = ["InputState"]


@dataclass
class InputState:
    keys_down: Set[str] = field(default_factory=set)
    keys_pressed: Set[str] = field(default_factory=set)    # this frame
    keys_released: Set[str] = field(default_factory=set)   # this frame
    mouse_position: Tuple[float, float] = (0.0, 0.0)
    mouse_delta: Tuple[float, float] = (0.0, 0.0)
    mouse_buttons: Set[int] = field(default_factory=set)
    wheel_delta: float = 0.0

    def process_event(self, event: Dict):
        """Feed an OS-style event dict (engine/mod.rs handle_os_events)."""
        et = event.get("type")
        if et == "key_down":
            k = event["key"]
            if k not in self.keys_down:
                self.keys_pressed.add(k)
            self.keys_down.add(k)
        elif et == "key_up":
            k = event["key"]
            self.keys_down.discard(k)
            self.keys_released.add(k)
        elif et == "mouse_move":
            old = self.mouse_position
            self.mouse_position = (event["x"], event["y"])
            self.mouse_delta = (event["x"] - old[0], event["y"] - old[1])
        elif et == "mouse_down":
            self.mouse_buttons.add(event["button"])
        elif et == "mouse_up":
            self.mouse_buttons.discard(event["button"])
        elif et == "wheel":
            self.wheel_delta += event["delta"]

    def is_key_down(self, key: str) -> bool:
        return key in self.keys_down

    def was_key_pressed(self, key: str) -> bool:
        return key in self.keys_pressed

    def end_frame(self):
        """Per-frame reset (engine/mod.rs:1748-1750)."""
        self.keys_pressed.clear()
        self.keys_released.clear()
        self.mouse_delta = (0.0, 0.0)
        self.wheel_delta = 0.0
