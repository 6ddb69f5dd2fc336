"""UI layer: the retained-mode widget tree with its layout and messages
(fyrox-ui core), formatted text and TrueType fonts, the draw-command
rasterizer (renderer/ui_renderer.rs) and per-world HUD overlays (the
port's ``fyrox_tpu.ui``)."""

from fyrox_tpu_torch.ui import hud
from fyrox_tpu_torch.ui.core import (DrawCommand, Rect, UiMessage,
                                     UserInterface, Widget)
from fyrox_tpu_torch.ui.hud import Hud
from fyrox_tpu_torch.ui.renderer import compose_over, render_ui

__all__ = ["hud", "UserInterface", "Widget", "UiMessage", "Rect",
           "DrawCommand", "Hud", "render_ui", "compose_over"]
