"""Sprite-sheet (flipbook) animation, batched (fyrox-animation
spritesheet/, SpriteSheetAnimation :165: a frame grid over a texture, fps
playback, looping, frame ranges). The state is a per-world clock; frames
and UV rectangles derive from it."""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["SpriteSheetAnimation", "current_frame", "frame_uv_rect"]


@dataclass
class SpriteSheetAnimation:
    """Frame grid: `columns x rows` cells, playing [first_frame,
    last_frame] at `fps`."""
    columns: int
    rows: int
    fps: float = 10.0
    first_frame: int = 0
    last_frame: int = -1          # -1 = all cells
    looping: bool = True

    @property
    def num_frames(self):
        last = (self.last_frame if self.last_frame >= 0
                else self.columns * self.rows - 1)
        return last - self.first_frame + 1


def current_frame(sheet: SpriteSheetAnimation, time: torch.Tensor):
    """int32 frame index at float32 time(s) [...]: wraps when looping,
    clamps otherwise."""
    raw = torch.floor(time * sheet.fps).to(torch.int32)
    n = sheet.num_frames
    idx = (torch.remainder(raw, n) if sheet.looping
           else torch.clamp(raw, 0, n - 1))
    return sheet.first_frame + idx


def frame_uv_rect(sheet: SpriteSheetAnimation, frame: torch.Tensor):
    """UV rectangle (u0, v0, u1, v1) of integer frame indices [...] →
    [..., 4] float32."""
    col = torch.remainder(frame, sheet.columns)
    row = torch.div(frame, sheet.columns, rounding_mode="floor")
    du = 1.0 / sheet.columns
    dv = 1.0 / sheet.rows
    u0 = col.to(torch.float32) * du
    v0 = row.to(torch.float32) * dv
    return torch.stack([u0, v0, u0 + du, v0 + dv], -1)
