"""Curve editor widget (the port's copy of ``fyrox_tpu.ui.curve_editor``;
``ui.core`` draws a ``curve_editor`` widget through ``draw_commands``).

Equivalent of fyrox-ui/src/curve/ (CurveEditor: key editing with
view pan/zoom, key selection/drag/add/remove, Hermite segment preview).
Keys are (t, value, tangent) triples compatible with core/curve.py's
Hermite sampling; all edits go through messages so an editor command
stack can capture them."""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

from fyrox_tpu_torch.ui.core import (DrawCommand, Handle, Rect, UiMessage,
                                     UserInterface, Widget)

__all__ = ["add_curve_editor", "curve_to_screen", "screen_to_curve",
           "hit_test_key", "add_key", "remove_key", "move_key",
           "select_key", "pan", "zoom", "sample_keys", "draw_commands"]

KEY_HALF = 4.0   # key square half-extent in px


def add_curve_editor(ui: UserInterface, keys=None, parent=None,
                     **kw) -> Handle:
    return ui.add(Widget(kind="curve_editor",
                         curve_keys=sorted(list(keys or [])),
                         background=(0.1, 0.1, 0.1, 1.0), **kw), parent)


# -- view transform ---------------------------------------------------------

def curve_to_screen(w: Widget, t, v) -> Tuple[float, float]:
    ox, oy, sx, sy = w.view
    r = w.actual_rect
    return (r.x + (t - ox) * sx, r.y + r.h * 0.5 + (v - oy) * sy)


def screen_to_curve(w: Widget, px, py) -> Tuple[float, float]:
    ox, oy, sx, sy = w.view
    r = w.actual_rect
    return ((px - r.x) / sx + ox, (py - r.y - r.h * 0.5) / sy + oy)


def pan(w: Widget, dx_px, dy_px):
    ox, oy, sx, sy = w.view
    w.view = (ox - dx_px / sx, oy - dy_px / sy, sx, sy)


def zoom(w: Widget, factor):
    ox, oy, sx, sy = w.view
    w.view = (ox, oy, sx * factor, sy * factor)


# -- key operations (curve/mod.rs command messages) -------------------------

def _msg(ui, h, kind, **data):
    ui.send_message(UiMessage(destination=h, direction="from_widget",
                              data=dict(kind=kind, **data)))


def hit_test_key(w: Widget, px, py) -> int:
    for i, (t, v, _m) in enumerate(w.curve_keys):
        kx, ky = curve_to_screen(w, t, v)
        if abs(px - kx) <= KEY_HALF and abs(py - ky) <= KEY_HALF:
            return i
    return -1


def select_key(ui: UserInterface, h: Handle, index: int):
    w = ui.nodes.borrow(h)
    w.selected_key = index
    _msg(ui, h, "key_selected", index=index)


def add_key(ui: UserInterface, h: Handle, t, v, tangent=0.0) -> int:
    w = ui.nodes.borrow(h)
    w.curve_keys.append((float(t), float(v), float(tangent)))
    w.curve_keys.sort(key=lambda k: k[0])
    idx = next(i for i, k in enumerate(w.curve_keys)
               if k[0] == float(t) and k[1] == float(v))
    _msg(ui, h, "key_added", index=idx, t=float(t), value=float(v))
    return idx


def remove_key(ui: UserInterface, h: Handle, index: int):
    w = ui.nodes.borrow(h)
    if 0 <= index < len(w.curve_keys):
        k = w.curve_keys.pop(index)
        if w.selected_key == index:
            w.selected_key = -1
        _msg(ui, h, "key_removed", index=index, t=k[0], value=k[1])


def move_key(ui: UserInterface, h: Handle, index: int, t, v,
             tangent: Optional[float] = None):
    w = ui.nodes.borrow(h)
    if not (0 <= index < len(w.curve_keys)):
        return
    old = w.curve_keys[index]
    w.curve_keys[index] = (float(t), float(v),
                           old[2] if tangent is None else float(tangent))
    w.curve_keys.sort(key=lambda k: k[0])
    _msg(ui, h, "key_moved", index=index, t=float(t), value=float(v))


# -- evaluation + drawing ---------------------------------------------------

def sample_keys(keys: List[tuple], t: float) -> float:
    """Hermite evaluation of the editor's key list (matches
    core/curve.py semantics: clamped ends, per-key tangents)."""
    if not keys:
        return 0.0
    if t <= keys[0][0]:
        return keys[0][1]
    if t >= keys[-1][0]:
        return keys[-1][1]
    for (t0, v0, m0), (t1, v1, m1) in zip(keys, keys[1:]):
        if t0 <= t <= t1:
            d = max(t1 - t0, 1e-9)
            u = (t - t0) / d
            u2, u3 = u * u, u * u * u
            # |Δvalue| tangent scaling, matching core/curve._cubicf
            # (the reference's cubicf, fyrox-math/src/lib.rs:212)
            s = abs(v1 - v0)
            return ((2 * u3 - 3 * u2 + 1) * v0 + (u3 - 2 * u2 + u) * m0 * s
                    + (-2 * u3 + 3 * u2) * v1 + (u3 - u2) * m1 * s)
    return keys[-1][1]


def draw_commands(w: Widget) -> List[DrawCommand]:
    """Background + sampled curve polyline + key squares. Line segments
    are emitted as thin rects (the HUD rasterizer draws rects/borders)."""
    cmds = [DrawCommand("rect", w.actual_rect, w.background),
            DrawCommand("border", w.actual_rect, w.foreground)]
    keys = w.curve_keys or []
    r = w.actual_rect
    if keys and r.w > 4:
        t0, _ = screen_to_curve(w, r.x, r.y)
        t1, _ = screen_to_curve(w, r.x + r.w, r.y)
        n = max(int(r.w // 4), 2)
        prev = None
        for i in range(n + 1):
            t = t0 + (t1 - t0) * i / n
            px, py = curve_to_screen(w, t, sample_keys(keys, t))
            py = min(max(py, r.y), r.y + r.h)
            if prev is not None:
                x0, y0 = prev
                cmds.append(DrawCommand(
                    "rect", Rect(min(x0, px), min(y0, py),
                                 max(abs(px - x0), 1.0),
                                 max(abs(py - y0), 1.0)),
                    (0.3, 0.8, 0.3, 1.0)))
            prev = (px, py)
    for i, (t, v, _m) in enumerate(keys):
        kx, ky = curve_to_screen(w, t, v)
        col = (1.0, 0.8, 0.2, 1.0) if i == w.selected_key \
            else (0.8, 0.8, 0.8, 1.0)
        cmds.append(DrawCommand(
            "rect", Rect(kx - KEY_HALF, ky - KEY_HALF,
                         2 * KEY_HALF, 2 * KEY_HALF), col))
    return cmds
