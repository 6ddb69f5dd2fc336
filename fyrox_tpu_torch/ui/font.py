"""Real font support: a pure-Python TrueType parser + rasterizer and a
glyph atlas the UI renderer draws from (the port's copy of
``fyrox_tpu.ui.font``, host numpy in the same order of operations, so
glyph coverage is equal to the bit).

Reference parity: fyrox-ui/src/font/mod.rs loads TTFs (via fontdue) into
per-size glyph atlases with advance/bearing metrics, and
formatted_text.rs lays text out against those metrics. Here the same
pipeline is host-side numpy: `TtfFont` parses the font tables (head,
cmap 4/12, loca, glyf incl. composite glyphs, hhea/hmtx, kern 0),
rasterizes glyph outlines (quadratic béziers flattened to polylines,
non-zero-winding scanline fill at 4x supersampling, box downsample for
antialiasing), and `FontAtlas` packs a charset at a pixel size into one
[H,W] f32 coverage texture + per-glyph metrics. Atlases are plain
arrays — they can ride into the texture system or the CPU UI painter
(ui/renderer.py draws text through an atlas when one is supplied; the
embedded 5x7 bitmap remains the dependency-free fallback).

The reference ships its default fonts in-tree
(fyrox-ui/src/font/built_in_font.ttf); the port's tests and
``chip_smoke.py`` take a font that ``chip_smoke.write_ttf`` writes.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["TtfFont", "FontAtlas", "default_charset"]


def default_charset() -> str:
    return ("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
            "0123456789 .,:;!?%+-*/=()[]{}<>'\"_#@&|~^$\\")


def _u16(b, o):
    return struct.unpack_from(">H", b, o)[0]


def _i16(b, o):
    return struct.unpack_from(">h", b, o)[0]


def _u32(b, o):
    return struct.unpack_from(">I", b, o)[0]


class TtfFont:
    """Minimal TrueType font: character map, glyph outlines, metrics.

    Supports the sfnt tables the reference's built-in fonts (and any
    common Latin TTF) need: head/maxp/cmap(4,12)/loca/glyf/hhea/hmtx,
    composite glyphs with translate + scale + 2x2 components, and
    kern format 0 pair kerning. CFF ('OTTO') outlines are out of scope.
    """

    def __init__(self, data: bytes):
        if isinstance(data, str):
            data = open(data, "rb").read()
        self.data = bytes(data)
        b = self.data
        tag = b[:4]
        if tag == b"OTTO":
            raise ValueError("CFF/OTF outlines not supported (TTF only)")
        num_tables = _u16(b, 4)
        self.tables: Dict[bytes, Tuple[int, int]] = {}
        for i in range(num_tables):
            o = 12 + 16 * i
            self.tables[b[o:o + 4]] = (_u32(b, o + 8), _u32(b, o + 12))
        for need in (b"head", b"maxp", b"cmap", b"loca", b"glyf",
                     b"hhea", b"hmtx"):
            if need not in self.tables:
                raise ValueError(f"font missing table {need!r}")

        ho = self.tables[b"head"][0]
        self.units_per_em = _u16(b, ho + 18)
        self.loca_long = _i16(b, ho + 50) == 1
        mo = self.tables[b"maxp"][0]
        self.num_glyphs = _u16(b, mo + 4)
        hh = self.tables[b"hhea"][0]
        self.ascent = _i16(b, hh + 4)
        self.descent = _i16(b, hh + 6)
        self.line_gap = _i16(b, hh + 8)
        self.num_hmetrics = _u16(b, hh + 34)
        self._cmap = self._parse_cmap()
        self._loca = self._parse_loca()
        self._kern = self._parse_kern()
        self._glyph_cache: Dict[int, List[np.ndarray]] = {}

    # -- tables ------------------------------------------------------------

    def _parse_cmap(self) -> Dict[int, int]:
        b = self.data
        co = self.tables[b"cmap"][0]
        n = _u16(b, co + 2)
        best = None
        for i in range(n):
            pid = _u16(b, co + 4 + 8 * i)
            eid = _u16(b, co + 6 + 8 * i)
            off = _u32(b, co + 8 + 8 * i)
            score = {(3, 10): 5, (3, 1): 4, (0, 4): 3, (0, 3): 3,
                     (0, 6): 2}.get((pid, eid), 1 if pid == 0 else 0)
            if best is None or score > best[0]:
                best = (score, co + off)
        sub = best[1]
        fmt = _u16(b, sub)
        out: Dict[int, int] = {}
        if fmt == 4:
            segcount = _u16(b, sub + 6) // 2
            ends = [_u16(b, sub + 14 + 2 * i) for i in range(segcount)]
            starts = [_u16(b, sub + 16 + 2 * segcount + 2 * i)
                      for i in range(segcount)]
            deltas = [_i16(b, sub + 16 + 4 * segcount + 2 * i)
                      for i in range(segcount)]
            range_off_base = sub + 16 + 6 * segcount
            for i in range(segcount):
                ro = _u16(b, range_off_base + 2 * i)
                for c in range(starts[i], min(ends[i], 0xFFFE) + 1):
                    if ro == 0:
                        g = (c + deltas[i]) & 0xFFFF
                    else:
                        addr = (range_off_base + 2 * i + ro
                                + 2 * (c - starts[i]))
                        g = _u16(b, addr)
                        if g:
                            g = (g + deltas[i]) & 0xFFFF
                    if g:
                        out[c] = g
        elif fmt == 12:
            ngroups = _u32(b, sub + 12)
            for i in range(ngroups):
                o = sub + 16 + 12 * i
                s, e, gs = _u32(b, o), _u32(b, o + 4), _u32(b, o + 8)
                for c in range(s, min(e, s + 0x2000) + 1):
                    out[c] = gs + (c - s)
        else:
            raise ValueError(f"unsupported cmap format {fmt}")
        return out

    def _parse_loca(self):
        b = self.data
        lo, ln = self.tables[b"loca"]
        if self.loca_long:
            return np.frombuffer(b, ">u4", self.num_glyphs + 1, lo)
        return np.frombuffer(b, ">u2", self.num_glyphs + 1, lo) * 2

    def _parse_kern(self) -> Dict[Tuple[int, int], int]:
        b = self.data
        out: Dict[Tuple[int, int], int] = {}
        if b"kern" not in self.tables:
            return out
        ko = self.tables[b"kern"][0]
        ntab = _u16(b, ko + 2)
        o = ko + 4
        for _ in range(ntab):
            length = _u16(b, o + 2)
            cov = _u16(b, o + 4)
            if cov & 0xFF00 == 0 and (cov & 0x1):   # format 0 horizontal
                npairs = _u16(b, o + 6)
                po = o + 14
                for i in range(npairs):
                    l = _u16(b, po + 6 * i)
                    r = _u16(b, po + 6 * i + 2)
                    v = _i16(b, po + 6 * i + 4)
                    out[(l, r)] = v
            o += length
        return out

    # -- glyphs ------------------------------------------------------------

    def glyph_index(self, ch: str) -> int:
        return self._cmap.get(ord(ch), 0)

    def advance(self, gid: int) -> int:
        b = self.data
        ho = self.tables[b"hmtx"][0]
        if gid < self.num_hmetrics:
            return _u16(b, ho + 4 * gid)
        return _u16(b, ho + 4 * (self.num_hmetrics - 1))

    def kerning(self, gl: int, gr: int) -> int:
        return self._kern.get((gl, gr), 0)

    def glyph_contours(self, gid: int, depth: int = 0) -> List[np.ndarray]:
        """Glyph outline as a list of closed polylines [N,2] in font
        units (quadratics flattened, on-curve midpoints inserted per the
        TrueType implied-point rule)."""
        if gid in self._glyph_cache:
            return self._glyph_cache[gid]
        b = self.data
        go = self.tables[b"glyf"][0]
        off, end = int(self._loca[gid]), int(self._loca[gid + 1])
        if off == end or gid >= self.num_glyphs:
            self._glyph_cache[gid] = []
            return []
        o = go + off
        ncont = _i16(b, o)
        if ncont >= 0:
            conts = self._simple_glyph(o, ncont)
        elif depth > 4:
            conts = []
        else:
            conts = self._composite_glyph(o, depth)
        self._glyph_cache[gid] = conts
        return conts

    def _simple_glyph(self, o, ncont) -> List[np.ndarray]:
        b = self.data
        end_pts = [_u16(b, o + 10 + 2 * i) for i in range(ncont)]
        npts = end_pts[-1] + 1 if ncont else 0
        ins_len = _u16(b, o + 10 + 2 * ncont)
        p = o + 12 + 2 * ncont + ins_len
        flags = []
        while len(flags) < npts:
            f = b[p]; p += 1
            flags.append(f)
            if f & 8:                                   # repeat
                rep = b[p]; p += 1
                flags.extend([f] * rep)
        xs, x = [], 0
        for f in flags:
            if f & 2:
                dx = b[p]; p += 1
                x += dx if (f & 16) else -dx
            elif not (f & 16):
                x += _i16(b, p); p += 2
            xs.append(x)
        ys, y = [], 0
        for f in flags:
            if f & 4:
                dy = b[p]; p += 1
                y += dy if (f & 32) else -dy
            elif not (f & 32):
                y += _i16(b, p); p += 2
            ys.append(y)
        on = [bool(f & 1) for f in flags]

        conts = []
        start = 0
        for e in end_pts:
            pts = [(xs[i], ys[i], on[i]) for i in range(start, e + 1)]
            start = e + 1
            conts.append(self._flatten(pts))
        return [c for c in conts if len(c) >= 3]

    @staticmethod
    def _flatten(pts, steps: int = 8) -> np.ndarray:
        """One contour of (x, y, on_curve) → closed polyline [N,2]."""
        n = len(pts)
        if n == 0:
            return np.zeros((0, 2), np.float64)
        # rotate so the contour starts on-curve (insert midpoint if none)
        first_on = next((i for i, q in enumerate(pts) if q[2]), None)
        if first_on is None:
            x0 = 0.5 * (pts[0][0] + pts[1][0])
            y0 = 0.5 * (pts[0][1] + pts[1][1])
            pts = [(x0, y0, True)] + pts
            n += 1
            first_on = 0
        pts = pts[first_on:] + pts[:first_on]
        out = [np.array(pts[0][:2], np.float64)]
        i = 1
        t = np.linspace(0.0, 1.0, steps + 1)[1:][:, None]
        while i <= n:
            cur = pts[i % n]
            if cur[2]:                                   # on-curve: line
                out.append(np.array(cur[:2], np.float64))
                i += 1
                continue
            nxt = pts[(i + 1) % n]
            ctrl = np.array(cur[:2], np.float64)
            if nxt[2]:
                end = np.array(nxt[:2], np.float64)
                i += 2
            else:                                        # implied midpoint
                end = 0.5 * (ctrl + np.array(nxt[:2], np.float64))
                i += 1
            p0 = out[-1]
            q = ((1 - t) ** 2 * p0 + 2 * (1 - t) * t * ctrl + t ** 2 * end)
            out.extend(list(q))
        return np.asarray(out)

    def _composite_glyph(self, o, depth) -> List[np.ndarray]:
        b = self.data
        p = o + 10
        conts: List[np.ndarray] = []
        while True:
            flags = _u16(b, p)
            gi = _u16(b, p + 2)
            p += 4
            if flags & 1:                                # words
                a1, a2 = _i16(b, p), _i16(b, p + 2); p += 4
            else:
                a1 = struct.unpack_from(">b", b, p)[0]
                a2 = struct.unpack_from(">b", b, p + 1)[0]; p += 2
            m = np.eye(2)
            if flags & 8:                                # single scale
                sc = _i16(b, p) / 16384.0; p += 2
                m = np.diag([sc, sc])
            elif flags & 0x40:                           # x & y scale
                sx = _i16(b, p) / 16384.0
                sy = _i16(b, p + 2) / 16384.0; p += 4
                m = np.diag([sx, sy])
            elif flags & 0x80:                           # 2x2
                v = [_i16(b, p + 2 * i) / 16384.0 for i in range(4)]
                p += 8
                m = np.array([[v[0], v[1]], [v[2], v[3]]])
            dx, dy = (a1, a2) if (flags & 2) else (0, 0)  # XY values
            for c in self.glyph_contours(gi, depth + 1):
                conts.append(c @ m.T + np.array([dx, dy], np.float64))
            if not (flags & 0x20):                       # MORE_COMPONENTS
                break
        return conts

    # -- rasterization -----------------------------------------------------

    def rasterize(self, ch: str, px_size: float, ss: int = 4):
        """Antialiased coverage bitmap for one character.

        Returns (img [h,w] f32 in [0,1], metrics dict with advance,
        bearing_x, bearing_y (px from baseline to bitmap top), w, h) —
        the fontdue-style per-glyph packet fyrox-ui consumes."""
        gid = self.glyph_index(ch)
        scale = px_size / self.units_per_em
        adv = self.advance(gid) * scale
        conts = [c * scale for c in self.glyph_contours(gid)]
        if not conts:
            return (np.zeros((0, 0), np.float32),
                    dict(advance=adv, bearing_x=0.0, bearing_y=0.0,
                         w=0, h=0))
        allp = np.concatenate(conts)
        x0, y0 = np.floor(allp.min(axis=0) - 0.25)
        x1, y1 = np.ceil(allp.max(axis=0) + 0.25)
        w = max(int(x1 - x0), 1)
        h = max(int(y1 - y0), 1)
        img_ss = np.zeros((h * ss, w * ss), np.float32)
        segs_a = []
        segs_b = []
        for c in conts:
            a = (c - [x0, y0]) * ss
            segs_a.append(a)
            segs_b.append(np.roll(a, -1, axis=0))
        A = np.concatenate(segs_a)
        B = np.concatenate(segs_b)
        dyn = B[:, 1] - A[:, 1]
        keep = np.abs(dyn) > 1e-12
        A, B, dyn = A[keep], B[keep], dyn[keep]
        wind = np.where(dyn > 0, 1, -1)
        ys = np.arange(h * ss) + 0.5
        # vectorized scanline: for each sample row, segments spanning it
        ymin = np.minimum(A[:, 1], B[:, 1])
        ymax = np.maximum(A[:, 1], B[:, 1])
        for yi, y in enumerate(ys):
            hit = (ymin <= y) & (y < ymax)
            if not hit.any():
                continue
            t = (y - A[hit, 1]) / dyn[hit]
            xx = A[hit, 0] + t * (B[hit, 0] - A[hit, 0])
            order = np.argsort(xx, kind="stable")
            xx = xx[order]
            ww = wind[hit][order]
            acc = np.cumsum(ww)
            inside = acc != 0                            # non-zero winding
            # spans between crossing i and i+1 where inside
            for i in np.nonzero(inside[:-1])[0]:
                xa, xb = xx[i], xx[i + 1]
                ia, ib = int(np.ceil(xa - 0.5)), int(np.floor(xb - 0.5))
                ia2, ib2 = max(ia, 0), min(ib, w * ss - 1)
                if ia2 <= ib2:
                    img_ss[yi, ia2:ib2 + 1] = 1.0
            if inside.any() and inside[-1]:
                xa = xx[-1]
                ia = max(int(np.ceil(xa - 0.5)), 0)
                img_ss[yi, ia:] = 1.0
        img = img_ss.reshape(h, ss, w, ss).mean(axis=(1, 3))
        img = img[::-1]                # font y-up → image y-down
        return (img.astype(np.float32),
                dict(advance=adv, bearing_x=float(x0),
                     bearing_y=float(y1), w=w, h=h))


class FontAtlas:
    """One pixel size of a font packed into a single coverage texture.

    `atlas` [H,W] f32; `glyphs` maps char → dict(u0, v0, w, h,
    advance, bearing_x, bearing_y). `measure(text)` returns (width,
    height) with kerning — the metric formatted_text layout consumes.
    """

    def __init__(self, font: TtfFont, px_size: float,
                 charset: Optional[str] = None):
        self.font = font
        self.px_size = float(px_size)
        charset = charset or default_charset()
        packets = {}
        for ch in charset:
            img, m = font.rasterize(ch, px_size)
            packets[ch] = (img, m)
        cell_h = max((p[0].shape[0] for p in packets.values()),
                     default=1) + 1
        cell_w = max((p[0].shape[1] for p in packets.values()),
                     default=1) + 1
        ncols = max(int(np.ceil(np.sqrt(len(charset)))), 1)
        nrows = int(np.ceil(len(charset) / ncols))
        self.atlas = np.zeros((nrows * cell_h, ncols * cell_w), np.float32)
        self.glyphs: Dict[str, dict] = {}
        for i, ch in enumerate(charset):
            img, m = packets[ch]
            r, c = divmod(i, ncols)
            y, x = r * cell_h, c * cell_w
            h, w = img.shape
            self.atlas[y:y + h, x:x + w] = img
            self.glyphs[ch] = dict(u0=x, v0=y, w=w, h=h,
                                   advance=m["advance"],
                                   bearing_x=m["bearing_x"],
                                   bearing_y=m["bearing_y"])
        scale = px_size / font.units_per_em
        self.ascent = font.ascent * scale
        self.descent = font.descent * scale
        self.line_height = (font.ascent - font.descent
                            + font.line_gap) * scale
        self._kscale = scale

    def kerning(self, a: str, b: str) -> float:
        return self.font.kerning(self.font.glyph_index(a),
                                 self.font.glyph_index(b)) * self._kscale

    def measure(self, text: str) -> Tuple[float, float]:
        wmax, x = 0.0, 0.0
        lines = 1
        prev = None
        for ch in text:
            if ch == "\n":
                wmax = max(wmax, x)
                x, prev, lines = 0.0, None, lines + 1
                continue
            g = self.glyphs.get(ch)
            if g is None:
                x += self.px_size * 0.5
                prev = None
                continue
            if prev is not None:
                x += self.kerning(prev, ch)
            x += g["advance"]
            prev = ch
        return max(wmax, x), lines * self.line_height

    def draw(self, img: np.ndarray, text: str, x: float, y: float,
             rgba) -> float:
        """Blend `text` into img [H,W,4] with the glyph baseline at
        y + ascent (y = top of the line box). Returns the end x."""
        r, g_, b, a = rgba
        base = y + self.ascent
        prev = None
        H, W = img.shape[:2]
        for ch in text:
            gl = self.glyphs.get(ch)
            if gl is None:
                x += self.px_size * 0.5
                prev = None
                continue
            if prev is not None:
                x += self.kerning(prev, ch)
            cov = self.atlas[gl["v0"]:gl["v0"] + gl["h"],
                             gl["u0"]:gl["u0"] + gl["w"]]
            px = int(round(x + gl["bearing_x"]))
            py = int(round(base - gl["bearing_y"]))
            y0, y1 = max(py, 0), min(py + gl["h"], H)
            x0, x1 = max(px, 0), min(px + gl["w"], W)
            if y0 < y1 and x0 < x1:
                sub = cov[y0 - py:y1 - py, x0 - px:x1 - px]
                alpha = (sub * a)[..., None]
                dst = img[y0:y1, x0:x1]
                dst[..., :3] = (dst[..., :3] * (1 - alpha)
                                + np.asarray([r, g_, b]) * alpha)
                dst[..., 3:] = 1.0 - (1.0 - dst[..., 3:]) * (1.0 - alpha)
            x += gl["advance"]
            prev = ch
        return x
