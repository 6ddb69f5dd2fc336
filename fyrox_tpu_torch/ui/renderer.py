"""UI renderer: rasterize the widget draw-command list to an RGBA image
(the port's ``fyrox_tpu.ui.renderer``).

Equivalent of fyrox-impl/src/renderer/ui_renderer.rs (which converts
fyrox-ui draw commands into GL geometry): here each command paints into a
numpy RGBA buffer in painter's order — rect fills, 1px-ish borders, and
text via an embedded 5x7 bitmap font (digits, A-Z, and HUD punctuation).
`compose_over` alpha-blends the UI image onto rendered world frames.

Command counts are tiny (a HUD is tens of rects), so ``render_ui`` runs on
the host in numpy by design, with the 5x7 bitmap font or a TrueType font
(``ui/font.py``); its image drops onto the [..., H, W, 3] frames of
render_frame through ``compose_over``, on the frames' device.
"""
from __future__ import annotations

from typing import List

import numpy as np

import torch

from fyrox_tpu_torch.ui.core import DrawCommand
from fyrox_tpu_torch.ui.font import FontAtlas, TtfFont

__all__ = ["render_ui", "compose_over", "FONT_5X7"]

# 5x7 font rows as 5-bit integers, MSB = leftmost pixel
FONT_5X7 = {
    "0": (0x0E, 0x11, 0x13, 0x15, 0x19, 0x11, 0x0E),
    "1": (0x04, 0x0C, 0x04, 0x04, 0x04, 0x04, 0x0E),
    "2": (0x0E, 0x11, 0x01, 0x02, 0x04, 0x08, 0x1F),
    "3": (0x1F, 0x02, 0x04, 0x02, 0x01, 0x11, 0x0E),
    "4": (0x02, 0x06, 0x0A, 0x12, 0x1F, 0x02, 0x02),
    "5": (0x1F, 0x10, 0x1E, 0x01, 0x01, 0x11, 0x0E),
    "6": (0x06, 0x08, 0x10, 0x1E, 0x11, 0x11, 0x0E),
    "7": (0x1F, 0x01, 0x02, 0x04, 0x08, 0x08, 0x08),
    "8": (0x0E, 0x11, 0x11, 0x0E, 0x11, 0x11, 0x0E),
    "9": (0x0E, 0x11, 0x11, 0x0F, 0x01, 0x02, 0x0C),
    "A": (0x0E, 0x11, 0x11, 0x1F, 0x11, 0x11, 0x11),
    "B": (0x1E, 0x11, 0x11, 0x1E, 0x11, 0x11, 0x1E),
    "C": (0x0E, 0x11, 0x10, 0x10, 0x10, 0x11, 0x0E),
    "D": (0x1C, 0x12, 0x11, 0x11, 0x11, 0x12, 0x1C),
    "E": (0x1F, 0x10, 0x10, 0x1E, 0x10, 0x10, 0x1F),
    "F": (0x1F, 0x10, 0x10, 0x1E, 0x10, 0x10, 0x10),
    "G": (0x0E, 0x11, 0x10, 0x17, 0x11, 0x11, 0x0F),
    "H": (0x11, 0x11, 0x11, 0x1F, 0x11, 0x11, 0x11),
    "I": (0x0E, 0x04, 0x04, 0x04, 0x04, 0x04, 0x0E),
    "J": (0x07, 0x02, 0x02, 0x02, 0x02, 0x12, 0x0C),
    "K": (0x11, 0x12, 0x14, 0x18, 0x14, 0x12, 0x11),
    "L": (0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x1F),
    "M": (0x11, 0x1B, 0x15, 0x15, 0x11, 0x11, 0x11),
    "N": (0x11, 0x19, 0x15, 0x13, 0x11, 0x11, 0x11),
    "O": (0x0E, 0x11, 0x11, 0x11, 0x11, 0x11, 0x0E),
    "P": (0x1E, 0x11, 0x11, 0x1E, 0x10, 0x10, 0x10),
    "Q": (0x0E, 0x11, 0x11, 0x11, 0x15, 0x12, 0x0D),
    "R": (0x1E, 0x11, 0x11, 0x1E, 0x14, 0x12, 0x11),
    "S": (0x0F, 0x10, 0x10, 0x0E, 0x01, 0x01, 0x1E),
    "T": (0x1F, 0x04, 0x04, 0x04, 0x04, 0x04, 0x04),
    "U": (0x11, 0x11, 0x11, 0x11, 0x11, 0x11, 0x0E),
    "V": (0x11, 0x11, 0x11, 0x11, 0x11, 0x0A, 0x04),
    "W": (0x11, 0x11, 0x11, 0x15, 0x15, 0x1B, 0x11),
    "X": (0x11, 0x11, 0x0A, 0x04, 0x0A, 0x11, 0x11),
    "Y": (0x11, 0x11, 0x0A, 0x04, 0x04, 0x04, 0x04),
    "Z": (0x1F, 0x01, 0x02, 0x04, 0x08, 0x10, 0x1F),
    " ": (0, 0, 0, 0, 0, 0, 0),
    ".": (0, 0, 0, 0, 0, 0x0C, 0x0C),
    ",": (0, 0, 0, 0, 0x0C, 0x04, 0x08),
    ":": (0, 0x0C, 0x0C, 0, 0x0C, 0x0C, 0),
    "-": (0, 0, 0, 0x1F, 0, 0, 0),
    "+": (0, 0x04, 0x04, 0x1F, 0x04, 0x04, 0),
    "/": (0x01, 0x02, 0x02, 0x04, 0x08, 0x08, 0x10),
    "%": (0x19, 0x1A, 0x02, 0x04, 0x08, 0x0B, 0x13),
    "_": (0, 0, 0, 0, 0, 0, 0x1F),
}


def _blend_px(img, y0, y1, x0, x1, rgba):
    h, w = img.shape[:2]
    y0, y1 = max(int(y0), 0), min(int(y1), h)
    x0, x1 = max(int(x0), 0), min(int(x1), w)
    if y0 >= y1 or x0 >= x1:
        return
    r, g, b, a = rgba
    dst = img[y0:y1, x0:x1]
    dst[..., :3] = dst[..., :3] * (1 - a) + np.asarray([r, g, b]) * a
    dst[..., 3] = 1.0 - (1.0 - dst[..., 3]) * (1.0 - a)


def _draw_text(img, text, x, y, scale, rgba):
    cw = 6 * scale
    for ch in str(text).upper():
        glyph = FONT_5X7.get(ch)
        if glyph is not None:
            for row, bits in enumerate(glyph):
                for col in range(5):
                    if bits & (1 << (4 - col)):
                        _blend_px(img,
                                  y + row * scale, y + (row + 1) * scale,
                                  x + col * scale, x + (col + 1) * scale,
                                  rgba)
        x += cw


# Parsed fonts and their atlases, keyed by the objects themselves, which
# the keys keep alive: a key of id(font) could serve a freed font's atlas
# to the next font that CPython places at the same address.
_FONTS: dict = {}               # path or bytes -> TtfFont
_ATLASES: dict = {}             # (TtfFont, px) -> FontAtlas


def _atlas_for(font, px_size: int):
    """font: a FontAtlas (used as-is), a TtfFont (per-size atlases built
    and cached), or a path/bytes (parsed once, then cached)."""
    if isinstance(font, FontAtlas):
        return font
    if not isinstance(font, TtfFont):
        key = font if isinstance(font, str) else bytes(font)
        font = _FONTS.get(key) or _FONTS.setdefault(key, TtfFont(font))
    key = (font, int(px_size))
    at = _ATLASES.get(key)
    if at is None:
        at = _ATLASES[key] = FontAtlas(font, int(px_size))
    return at


def render_ui(commands: List[DrawCommand], height, width,
              font=None) -> np.ndarray:
    """Paint the draw-command list → [H,W,4] f32 RGBA (straight alpha, 0
    where untouched).

    `font` (optional): a ui.font.FontAtlas / TtfFont / .ttf path or bytes
    — text commands then render antialiased glyphs sized to the widget
    (fyrox-ui font/mod.rs atlas path); without it the embedded 5x7
    bitmap font."""
    img = np.zeros((height, width, 4), np.float32)
    for cmd in commands:
        b = cmd.bounds
        if cmd.kind == "rect":
            _blend_px(img, b.y, b.y + b.h, b.x, b.x + b.w, cmd.color)
        elif cmd.kind == "border":
            t = max(int(cmd.thickness), 1)
            _blend_px(img, b.y, b.y + t, b.x, b.x + b.w, cmd.color)
            _blend_px(img, b.y + b.h - t, b.y + b.h, b.x, b.x + b.w, cmd.color)
            _blend_px(img, b.y, b.y + b.h, b.x, b.x + t, cmd.color)
            _blend_px(img, b.y, b.y + b.h, b.x + b.w - t, b.x + b.w, cmd.color)
        elif cmd.kind == "text":
            if font is not None:
                px = max(int(b.h * 0.7), 6)
                _atlas_for(font, px).draw(img, str(cmd.text), b.x + 3,
                                          b.y + 1, cmd.color)
            else:
                # 5x7: fit glyphs to ~70% of the widget height
                scale = max(int(b.h * 0.7 / 7), 1)
                _draw_text(img, cmd.text, b.x + 3, b.y + 3, scale,
                           cmd.color)
    return img


def compose_over(frames, ui_rgba):
    """Alpha-blend the UI image over rendered frames.

    frames [..., H, W, 3] tensor, ui_rgba [..., H, W, 4] (a numpy image or
    a tensor; broadcast over the frames' leading axes) → a new tensor
    like frames, on their device."""
    ui = ui_rgba if isinstance(ui_rgba, torch.Tensor) else \
        torch.as_tensor(np.asarray(ui_rgba, np.float32))
    ui = ui.to(device=frames.device, dtype=frames.dtype)
    a = ui[..., 3:]
    return frames * (1.0 - a) + ui[..., :3] * a
