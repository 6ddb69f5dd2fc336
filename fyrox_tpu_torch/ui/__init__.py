"""UI layer: the draw-command rasterizer (renderer/ui_renderer.rs) and
per-world HUD overlays, with the draw command and rect types of fyrox-ui's
core (the port's part of ``fyrox_tpu.ui``)."""

from fyrox_tpu_torch.ui import hud
from fyrox_tpu_torch.ui.core import DrawCommand, Rect
from fyrox_tpu_torch.ui.hud import Hud
from fyrox_tpu_torch.ui.renderer import compose_over, render_ui

__all__ = ["hud", "Rect", "DrawCommand", "Hud", "render_ui", "compose_over"]
