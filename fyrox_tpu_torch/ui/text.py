"""Formatted-text layout + text editing ops (the port's copy of
``fyrox_tpu.ui.text``).

Host-side equivalents of fyrox-ui's formatted text engine and TextBox
(fyrox-ui/src/formatted_text.rs, text_box.rs): paragraph splitting, word/
letter wrap against a width constraint, horizontal/vertical alignment,
caret↔position mapping, and the caret/selection editing operations the
TextBox widget applies to key events. Glyph metrics use the UI's
monospace model (advance = font_size * CHAR_ASPECT, line height =
font_size * LINE_FACTOR) — the same metric ui/renderer.py rasterizes
with, so layout and drawing agree.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Tuple

__all__ = ["CHAR_ASPECT", "LINE_FACTOR", "FormattedText", "apply_key",
           "parse_bbcode"]

CHAR_ASPECT = 0.55
LINE_FACTOR = 1.3


@dataclass
class Line:
    start: int          # global char index (inclusive)
    end: int            # exclusive; excludes the wrap point / newline
    x: float = 0.0      # line origin (alignment applied)
    y: float = 0.0
    width: float = 0.0


class FormattedText:
    """Wrap `text` into positioned lines (formatted_text.rs build pass).

    wrap: "none" | "letter" | "word" (WrapMode). halign: "left" |
    "center" | "right"; valign: "top" | "center" | "bottom" (only
    meaningful with a finite constraint on that axis).
    """

    def __init__(self, text: str, font_size: float = 14.0, wrap="word",
                 halign="left", valign="top",
                 constraint=(math.inf, math.inf), font=None):
        self.text = text
        self.font_size = font_size
        self.wrap = wrap
        self.halign = halign
        self.valign = valign
        self.constraint = constraint
        # font: optional ui.font.FontAtlas — layout then uses real glyph
        # advances + kerning (formatted_text.rs measures with font
        # metrics); without one, the monospace model stands in
        self.font = font
        self.char_w = font_size * CHAR_ASPECT
        self.line_h = (font.line_height if font is not None
                       else font_size * LINE_FACTOR)
        self.lines: List[Line] = []
        self._build()

    def _advances(self, s: str):
        """Per-char advance widths (kerning folded into the following
        char) — uniform char_w when no font is attached."""
        if self.font is None:
            return [self.char_w] * len(s)
        out, prev = [], None
        for ch in s:
            g = self.font.glyphs.get(ch)
            a = g["advance"] if g else self.font.px_size * 0.5
            if prev is not None:
                a += self.font.kerning(prev, ch)
            out.append(a)
            prev = ch
        return out

    def _wrap_widths(self, para: str, p0: int, limit: float):
        """Width-based wrapping for proportional fonts: greedy word fill
        against the pixel constraint, letter-splitting overlong words."""
        adv = self._advances(para)
        n = len(para)
        s = 0
        while s < n:
            acc = 0.0
            last_space = -1
            e = s
            while e < n:
                acc += adv[e]
                if para[e] == " ":
                    last_space = e
                if acc > limit and e > s:
                    break
                e += 1
            if e >= n:
                self.lines.append(Line(p0 + s, p0 + n))
                break
            if self.wrap == "word" and last_space > s:
                self.lines.append(Line(p0 + s, p0 + last_space))
                s = last_space + 1            # swallow the space
            else:                             # letter wrap / long word
                self.lines.append(Line(p0 + s, p0 + e))
                s = e

    # -- layout -------------------------------------------------------------

    def _max_cols(self):
        cw = self.constraint[0]
        if not math.isfinite(cw) or self.wrap == "none":
            return None
        return max(int(cw // self.char_w), 1)

    def _build(self):
        self.lines = []
        if self.font is not None:
            cw = self.constraint[0]
            pos = 0
            for para in self.text.split("\n"):
                if (not math.isfinite(cw) or self.wrap == "none"
                        or not para):
                    self.lines.append(Line(pos, pos + len(para)))
                else:
                    self._wrap_widths(para, pos, cw)
                pos += len(para) + 1
            if not self.lines:
                self.lines = [Line(0, 0)]
            self._finish_layout()
            return
        cols = self._max_cols()
        pos = 0
        for para in self.text.split("\n"):
            p0 = pos
            n = len(para)
            if cols is None or n <= cols:
                self.lines.append(Line(p0, p0 + n))
            elif self.wrap == "letter":
                for s in range(0, n, cols):
                    self.lines.append(Line(p0 + s, p0 + min(s + cols, n)))
            else:                                   # word wrap
                s = 0
                while s < n:
                    if n - s <= cols:
                        self.lines.append(Line(p0 + s, p0 + n))
                        break
                    cut = para.rfind(" ", s, s + cols + 1)
                    if cut <= s:                    # long word: letter-break
                        self.lines.append(Line(p0 + s, p0 + s + cols))
                        s = s + cols
                    else:
                        self.lines.append(Line(p0 + s, p0 + cut))
                        s = cut + 1                 # swallow the space
            pos += n + 1                            # +1 for the newline
        if not self.lines:
            self.lines = [Line(0, 0)]
        self._finish_layout()

    def _finish_layout(self):
        for i, ln in enumerate(self.lines):
            if self.font is None:
                ln.width = (ln.end - ln.start) * self.char_w
            else:
                ln.width = float(sum(
                    self._advances(self.text[ln.start:ln.end])))
            ln.y = i * self.line_h
        total_w = max((ln.width for ln in self.lines), default=0.0)
        cw, ch = self.constraint
        box_w = cw if math.isfinite(cw) else total_w
        box_h = ch if math.isfinite(ch) else len(self.lines) * self.line_h
        for ln in self.lines:
            if self.halign == "center":
                ln.x = (box_w - ln.width) * 0.5
            elif self.halign == "right":
                ln.x = box_w - ln.width
        if self.valign in ("center", "bottom"):
            extra = box_h - len(self.lines) * self.line_h
            off = extra * (0.5 if self.valign == "center" else 1.0)
            for ln in self.lines:
                ln.y += off

    # -- queries ------------------------------------------------------------

    @property
    def size(self) -> Tuple[float, float]:
        w = max((ln.width for ln in self.lines), default=0.0)
        return (w, len(self.lines) * self.line_h)

    def line_text(self, i: int) -> str:
        ln = self.lines[i]
        return self.text[ln.start:ln.end]

    def caret_to_xy(self, idx: int) -> Tuple[float, float]:
        """Top-left of the caret for char index idx ∈ [0, len(text)]."""
        idx = max(0, min(idx, len(self.text)))

        def _x_at(ln, i):
            if self.font is None:
                return ln.x + (i - ln.start) * self.char_w
            return ln.x + float(sum(
                self._advances(self.text[ln.start:ln.end])[:i - ln.start]))

        for ln in self.lines:
            if ln.start <= idx <= ln.end:
                return (_x_at(ln, idx), ln.y)
        ln = self.lines[-1]
        return (_x_at(ln, ln.end), ln.y)

    def xy_to_caret(self, x: float, y: float) -> int:
        """Nearest char index for a local point (click → caret)."""
        li = max(0, min(int(y // self.line_h), len(self.lines) - 1))
        ln = self.lines[li]
        if self.font is not None:
            adv = self._advances(self.text[ln.start:ln.end])
            acc, col = ln.x, 0
            for a in adv:
                if x < acc + a * 0.5:
                    break
                acc += a
                col += 1
            return ln.start + col
        col = int(round((x - ln.x) / self.char_w))
        return ln.start + max(0, min(col, ln.end - ln.start))


# -- TextBox editing ops (text_box.rs key handling) -------------------------

def _sel_range(caret, anchor):
    if anchor < 0 or anchor == caret:
        return None
    return (min(caret, anchor), max(caret, anchor))


def apply_key(text: str, caret: int, anchor: int, key: str, char: str = "",
              shift: bool = False):
    """One TextBox key event → (text, caret, anchor, events).

    key: "Left"/"Right"/"Home"/"End"/"Backspace"/"Delete"/"Enter"/"Char";
    char: the printable char for key == "Char". anchor: selection anchor
    index or -1. events ⊆ {"changed", "committed"}.
    """
    caret = max(0, min(caret, len(text)))
    events = []
    sel = _sel_range(caret, anchor)

    def delete_sel():
        nonlocal text, caret, anchor, sel
        a, b = sel
        text = text[:a] + text[b:]
        caret = a
        anchor = -1
        sel = None

    if key in ("Left", "Right", "Home", "End"):
        if shift and anchor < 0:
            anchor = caret
        if key == "Left":
            caret = max(caret - 1, 0)
        elif key == "Right":
            caret = min(caret + 1, len(text))
        elif key == "Home":
            caret = 0
        else:
            caret = len(text)
        if not shift:
            anchor = -1
    elif key == "Backspace":
        if sel:
            delete_sel()
        elif caret > 0:
            text = text[:caret - 1] + text[caret:]
            caret -= 1
        events.append("changed")
    elif key == "Delete":
        if sel:
            delete_sel()
        elif caret < len(text):
            text = text[:caret] + text[caret + 1:]
        events.append("changed")
    elif key == "Enter":
        events.append("committed")
    elif key == "Char" and char:
        if sel:
            delete_sel()
        text = text[:caret] + char + text[caret:]
        caret += len(char)
        anchor = -1
        events.append("changed")
    return text, caret, anchor, events


# -- BBCode markup (fyrox-ui/src/bbcode.rs) ---------------------------------

_NAMED_COLORS = {
    "red": (1.0, 0.2, 0.2, 1.0), "green": (0.2, 1.0, 0.2, 1.0),
    "blue": (0.3, 0.5, 1.0, 1.0), "white": (1.0, 1.0, 1.0, 1.0),
    "black": (0.0, 0.0, 0.0, 1.0), "yellow": (1.0, 1.0, 0.2, 1.0),
    "gray": (0.6, 0.6, 0.6, 1.0), "orange": (1.0, 0.6, 0.1, 1.0),
}


def _parse_color(v: str):
    v = v.strip().lower()
    if v.startswith("#"):
        h = v[1:]
        if len(h) == 3:
            h = "".join(c * 2 for c in h)
        if len(h) in (6, 8):
            try:
                r = int(h[0:2], 16) / 255.0
                g = int(h[2:4], 16) / 255.0
                b = int(h[4:6], 16) / 255.0
                a = int(h[6:8], 16) / 255.0 if len(h) == 8 else 1.0
                return (r, g, b, a)
            except ValueError:
                return None
        return None
    return _NAMED_COLORS.get(v)


def parse_bbcode(markup: str):
    """BBCode → (plain_text, runs). Each run is (start, end, style) with
    style keys bold/italic/color/size (bbcode.rs tag set: [b] [i]
    [color=...] [size=...]; unknown or unbalanced tags pass through as
    literal text)."""
    plain = []
    runs = []
    stack = []          # (tag, value)
    i = 0
    run_start = 0

    def cur_style():
        st = {}
        for tag, val in stack:
            if tag == "b":
                st["bold"] = True
            elif tag == "i":
                st["italic"] = True
            elif tag == "color":
                st["color"] = val
            elif tag == "size":
                st["size"] = val
        return st

    def flush():
        nonlocal run_start
        end = len(plain)
        if end > run_start:
            runs.append((run_start, end, cur_style()))
        run_start = end

    while i < len(markup):
        if markup[i] == "[":
            j = markup.find("]", i + 1)
            if j > i:
                body = markup[i + 1:j]
                closing = body.startswith("/")
                name = (body[1:] if closing else body).split("=", 1)[0]                     .strip().lower()
                value = (body.split("=", 1)[1].strip()
                         if "=" in body else None)
                if name in ("b", "i", "color", "size"):
                    if closing:
                        if stack and stack[-1][0] == name:
                            flush()
                            stack.pop()
                            i = j + 1
                            continue
                    else:
                        val = None
                        if name == "color" and value is not None:
                            val = _parse_color(value)
                        elif name == "size" and value is not None:
                            try:
                                val = float(value)
                            except ValueError:
                                val = None
                        if name in ("b", "i") or val is not None:
                            flush()
                            stack.append((name, val))
                            i = j + 1
                            continue
            # not a recognized tag: literal '['
        plain.append(markup[i])
        i += 1
    flush()
    return "".join(plain), runs
