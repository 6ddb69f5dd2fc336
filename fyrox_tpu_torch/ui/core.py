"""The part of fyrox-ui's core that the UI renderer needs (the port's copy
of ``fyrox_tpu.ui.core``'s ``Rect`` and ``DrawCommand``): a widget's
bounds and one draw command of the list that ``ui.renderer.render_ui``
paints. The widget tree, layout and message routing are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

__all__ = ["Rect", "DrawCommand"]


@dataclass
class Rect:
    x: float = 0.0
    y: float = 0.0
    w: float = 0.0
    h: float = 0.0

    def contains(self, px, py):
        return self.x <= px <= self.x + self.w and self.y <= py <= self.y + self.h


@dataclass
class DrawCommand:
    kind: str                      # 'rect', 'text', 'border', 'image', 'line'
    bounds: Rect = field(default_factory=Rect)
    color: Tuple[float, float, float, float] = (1, 1, 1, 1)
    text: str = ""
    thickness: float = 1.0
    texture: Optional[object] = None   # image widgets (image.rs)
    points: Optional[list] = None      # polyline (vector_image.rs)
