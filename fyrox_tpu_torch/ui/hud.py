"""Per-world HUD: batched parametric overlays (the port's
``fyrox_tpu.ui.hud``).

The host-side painter (ui/renderer.py) produces ONE static RGBA image —
fine for a shared HUD, but the batched regime needs per-world state on
screen (health bars, scores). Reference equivalent: each Fyrox scene
instance draws its own UI (fyrox-impl/src/renderer/ui_renderer.rs); here
one HudTemplate holds the static layer plus *parametric* elements whose
per-world scalars are bound at render time, producing a [W,H,Wd,4] batch
on the device of the bound values:

  * add_bar(key, ...):     rect whose filled width is value∈[0,1] — a
                           static coverage ramp compared against the bound
                           scalar (pure elementwise, no scatters)
  * add_counter(key, ...): fixed-width decimal readout — a prerendered
                           [10, gh, gw] glyph bank gathered per digit per
                           world and blended at static offsets (a slice of
                           a new tensor; nothing given is written)

The static layer, the bars' masks and the glyph banks are host arrays made
once and copied to a device once (``_util.const``), so a frame after the
first copies nothing from the host.

`compose_over` (ui/renderer.py) already broadcasts: frames [W,H,Wd,3] ×
overlay [W,H,Wd,4] compose directly.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from fyrox_tpu_torch._util import const
from fyrox_tpu_torch.ui.renderer import FONT_5X7, render_ui

__all__ = ["Hud"]


class Hud:
    """Builder + renderer for a batched HUD overlay."""

    def __init__(self, height: int, width: int):
        self.height = int(height)
        self.width = int(width)
        self._static_cmds: List = []
        self._bars: List[dict] = []
        self._counters: List[dict] = []
        self._static_img = None
        self._host = {}

    # -- static layer (painted once, host-side) ---------------------------
    def add_static(self, commands) -> "Hud":
        """Draw commands (ui/core.DrawCommand list) shared by all worlds."""
        self._static_cmds.extend(commands)
        self._static_img = None
        return self

    # -- parametric elements ----------------------------------------------
    def add_bar(self, key: str, x: int, y: int, w: int, h: int,
                color=(0.9, 0.2, 0.2, 0.9),
                background=(0.1, 0.1, 0.1, 0.6)) -> "Hud":
        """Horizontal fill bar; bound value in [0,1] is the filled
        fraction (left → right)."""
        self._bars.append(dict(key=key, x=int(x), y=int(y), w=int(w),
                               h=int(h), color=tuple(color),
                               background=tuple(background)))
        return self

    def add_counter(self, key: str, x: int, y: int, digits: int = 5,
                    scale: int = 2, color=(1.0, 1.0, 1.0, 1.0)) -> "Hud":
        """Fixed-width decimal readout; bound value is a non-negative
        number (leading zeros shown, fractional part truncated)."""
        self._counters.append(dict(key=key, x=int(x), y=int(y),
                                   digits=int(digits), scale=int(scale),
                                   color=tuple(color)))
        return self

    # -- internals ----------------------------------------------------------
    def _static(self) -> np.ndarray:
        if self._static_img is None:
            img = render_ui(self._static_cmds, self.height, self.width)
            # bar backgrounds belong to the static layer
            for b in self._bars:
                r, g, bl, a = b["background"]
                dst = img[b["y"]:b["y"] + b["h"], b["x"]:b["x"] + b["w"]]
                dst[..., :3] = dst[..., :3] * (1 - a) + np.asarray([r, g, bl]) * a
                dst[..., 3] = 1.0 - (1.0 - dst[..., 3]) * (1.0 - a)
            self._static_img = img
        return self._static_img

    @staticmethod
    def _glyph_bank(scale: int, color) -> np.ndarray:
        """[10, 7*scale, 6*scale, 4] prerendered digit glyphs."""
        gh, gw = 7 * scale, 6 * scale
        bank = np.zeros((10, gh, gw, 4), np.float32)
        rgba = np.asarray(color, np.float32)
        for d in range(10):
            glyph = FONT_5X7[str(d)]
            for row, bits in enumerate(glyph):
                for col in range(5):
                    if bits & (1 << (4 - col)):
                        bank[d, row * scale:(row + 1) * scale,
                             col * scale:(col + 1) * scale] = rgba
        return bank

    def _bar_masks(self, b):
        """(rect mask, fill ramp) [H, Wd] host arrays of bar b, made once."""
        key = ("bar", id(b))
        if key not in self._host:
            ys = np.zeros((self.height, self.width), np.float32)
            ys[b["y"]:b["y"] + b["h"], b["x"]:b["x"] + b["w"]] = 1.0
            ramp = np.ones((self.height, self.width), np.float32)
            ramp[:, b["x"]:b["x"] + b["w"]] = (
                np.arange(b["w"], dtype=np.float32) + 1.0) / b["w"]
            color = np.asarray(b["color"][:3], np.float32)
            self._host[key] = (b, ys, ramp, color)
        return self._host[key][1:]

    def _bank(self, c):
        key = ("bank", id(c))
        if key not in self._host:
            self._host[key] = (c, self._glyph_bank(c["scale"], c["color"]))
        return self._host[key][1]

    def render(self, values: Dict[str, torch.Tensor]):
        """Bind per-world scalars → [W, H, Wd, 4] overlay batch, on the
        values' device (the CPU for host values).

        values[key]: [W] tensor for every bar (fraction) / counter (number)
        key declared on this HUD; a missing key raises KeyError."""
        keys = ([b["key"] for b in self._bars]
                + [c["key"] for c in self._counters])
        missing = [k for k in keys if k not in values]
        if missing:
            raise KeyError(f"HUD values missing bindings: {missing}")
        vals = {k: v if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v)) for k, v in
                ((k, values[k]) for k in keys)}
        dev = vals[keys[0]].device if keys else torch.device("cpu")
        w_batch = vals[keys[0]].shape[0] if keys else 1
        static = self._static()
        img = const(static, dev).expand(w_batch, self.height, self.width, 4)

        def blend(dst, src_rgb, src_a):
            a = src_a[..., None]
            rgb = dst[..., :3] * (1 - a) + src_rgb * a
            al = 1.0 - (1.0 - dst[..., 3:]) * (1.0 - a)
            return torch.cat([rgb, al], -1)

        for b in self._bars:
            ys, ramp, color = self._bar_masks(b)
            f = torch.clamp(vals[b["key"]].to(torch.float32), 0.0, 1.0)
            filled = const(ramp, dev)[None] <= f[:, None, None]
            alpha = const(ys, dev)[None] * filled * b["color"][3]
            img = blend(img, const(color, dev), alpha)

        if self._counters:
            img = img.clone()        # never the shared static layer
        for c in self._counters:
            bank = const(self._bank(c), dev)
            gh, gw = bank.shape[1], bank.shape[2]
            val = torch.clamp(vals[c["key"]], min=0).to(torch.int32)
            for i in range(c["digits"]):
                div = 10 ** (c["digits"] - 1 - i)
                d = (val // div) % 10
                glyphs = bank[d.long()]                   # [W, gh, gw, 4]
                x0 = c["x"] + i * gw
                if x0 + gw > self.width or c["y"] + gh > self.height:
                    continue
                region = img[:, c["y"]:c["y"] + gh, x0:x0 + gw]
                blended = blend(region, glyphs[..., :3], glyphs[..., 3])
                img[:, c["y"]:c["y"] + gh, x0:x0 + gw] = blended
        return img
