"""Port parity: TrueType fonts and formatted text of fyrox_tpu_torch
(ui.font, ui.text, the TrueType path of ui.renderer.render_ui) against
fyrox_tpu's on the CPU.

The font is chip_smoke.write_ttf's (no font file ships with the repo): head,
hhea, maxp, cmap format 4 (an idDelta segment and a glyphIdArray segment),
short and long loca, glyf with line and quadratic outlines, composite
glyphs (translate, one scale, x and y scales, a 2 x 2 matrix, two
components), a space with no outline, hmtx with a shared tail, and kern
format 0. Both packages parse the same bytes; tables, outlines, glyph
coverage at two sizes, atlases, kerning, measures, drawn text and
FormattedText's lines and caret maps (monospace and through an atlas) are
held equal: the code is the same numpy in the same order of operations.
The atlas cache of render_ui is held to the font object, not its address.
"""
import gc

import numpy as np
import pytest

import chip_smoke
from fyrox_tpu.ui import renderer as jrenderer
from fyrox_tpu.ui import text as jtext
from fyrox_tpu.ui.core import DrawCommand as JDrawCommand
from fyrox_tpu.ui.core import Rect as JRect
from fyrox_tpu.ui.font import FontAtlas as JFontAtlas
from fyrox_tpu.ui.font import TtfFont as JTtfFont
from fyrox_tpu_torch.ui import DrawCommand, Rect, render_ui
from fyrox_tpu_torch.ui import renderer
from fyrox_tpu_torch.ui import text
from fyrox_tpu_torch.ui.font import FontAtlas, TtfFont, default_charset

SIZES = (9, 23)


@pytest.fixture(scope="module", params=[False, True], ids=["short", "long"])
def fonts(request):
    data = chip_smoke.write_ttf(long_loca=request.param)
    return TtfFont(data), JTtfFont(data)


@pytest.fixture(scope="module")
def atlases():
    data = chip_smoke.write_ttf()
    return (FontAtlas(TtfFont(data), 14), JFontAtlas(JTtfFont(data), 14))


def test_tables_equal_jax(fonts):
    f, j = fonts
    assert f.tables == j.tables and f.loca_long == j.loca_long
    for k in ("units_per_em", "num_glyphs", "ascent", "descent", "line_gap",
              "num_hmetrics"):
        assert getattr(f, k) == getattr(j, k), k
    assert f._cmap == j._cmap and f._kern == j._kern
    np.testing.assert_array_equal(f._loca, j._loca)
    for gid in range(f.num_glyphs):
        assert f.advance(gid) == j.advance(gid)
        a, b = f.glyph_contours(gid), j.glyph_contours(gid)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_writer_font_has_every_table_feature(fonts):
    """What the writer promises, read through the port's parser."""
    f, _ = fonts
    assert set(f.tables) >= {b"head", b"hhea", b"maxp", b"cmap", b"loca",
                             b"glyf", b"hmtx", b"kern"}
    gid = f.glyph_index
    assert [gid(chr(c)) for c in range(32, 127)] == list(range(1, 96))
    assert f.glyph_contours(gid(" ")) == [] and f.advance(gid(" ")) > 0
    assert f.num_hmetrics < f.num_glyphs
    assert f.kerning(gid("A"), gid("V")) < 0 == f.kerning(gid("V"), gid("V"))
    glyf = f.tables[b"glyf"][0]

    def n_contours(ch):
        o = glyf + int(f._loca[gid(ch)])
        return int.from_bytes(f.data[o:o + 2], "big", signed=True)

    assert n_contours("A") > 0 and n_contours(".") == 1
    for ch in "a:;/_`":
        assert n_contours(ch) == -1, ch
    # a lowercase letter is its capital at 3/4 scale, moved 40 units right
    big, small = f.glyph_contours(gid("A")), f.glyph_contours(gid("a"))
    np.testing.assert_allclose(small[0], big[0] * 0.75 + [40, 0])
    assert len(f.glyph_contours(gid(":"))) == 2          # two components
    # quadratic pieces: flattened curves put points off the pixel grid
    pts = np.concatenate(big)
    assert (pts % 25 != 0).any()


@pytest.mark.parametrize("px", SIZES)
def test_glyph_coverage_equals_jax(atlases, px):
    """Every charset glyph rasterized at two sizes (the outlines of both
    loca layouts are held equal above)."""
    f, j = atlases[0].font, atlases[1].font
    for ch in default_charset():
        (a, ma), (b, mb) = f.rasterize(ch, px), j.rasterize(ch, px)
        assert ma == mb, ch
        assert a.dtype == b.dtype and a.shape == b.shape, ch
        np.testing.assert_array_equal(a, b)
    img, _ = f.rasterize("W", px)
    assert img.max() == 1.0 and ((img > 0) & (img < 1)).any()


def test_atlas_measure_kerning_and_draw_equal_jax(atlases):
    a, j = atlases
    np.testing.assert_array_equal(a.atlas, j.atlas)
    assert a.glyphs == j.glyphs
    assert (a.ascent, a.descent, a.line_height) == (j.ascent, j.descent,
                                                     j.line_height)
    for s in ("AVATar", "LT 11", "Pa\nTo", "", "é?"):
        assert a.measure(s) == j.measure(s), s
    for x, y in ("AV", "VA", "To", "ab", "11"):
        assert a.kerning(x, y) == j.kerning(x, y)
    assert a.kerning("A", "V") < 0
    img_a = np.zeros((40, 160, 4), np.float32)
    img_j = np.zeros((40, 160, 4), np.float32)
    ends = (a.draw(img_a, "AVATar: Hello, 12!", -3.5, 2.25, (1, .5, 0, .8)),
            j.draw(img_j, "AVATar: Hello, 12!", -3.5, 2.25, (1, .5, 0, .8)))
    assert ends[0] == ends[1]
    np.testing.assert_array_equal(img_a, img_j)
    assert (img_a[..., 3] > 0).mean() > 0.05


TEXTS = ("The quick brown fox jumps over the lazy dog",
         "short\n\nlines and averyveryverylongword that wraps",
         "", "AVATar To Pa 11 LT")


@pytest.mark.parametrize("with_font", [False, True], ids=["mono", "atlas"])
def test_formatted_text_equals_jax(atlases, with_font):
    """Lines, sizes and caret maps (caret_to_xy for every index,
    xy_to_caret over a grid of points) for every wrap mode and alignment."""
    fa, fj = atlases if with_font else (None, None)
    for s in TEXTS:
        for wrap in ("none", "letter", "word"):
            for halign, valign, con in (("left", "top", (90.0, 1e9)),
                                        ("center", "center", (70.0, 120.0)),
                                        ("right", "bottom", (130.0, 80.0)),
                                        ("left", "top", (float("inf"),) * 2)):
                kw = dict(wrap=wrap, halign=halign, valign=valign,
                          constraint=con)
                a = text.FormattedText(s, 13.0, font=fa, **kw)
                b = jtext.FormattedText(s, 13.0, font=fj, **kw)
                assert [vars(x) for x in a.lines] == \
                    [vars(x) for x in b.lines], (s, kw)
                assert a.size == b.size and a.line_h == b.line_h
                for i in range(len(s) + 2):
                    assert a.caret_to_xy(i) == b.caret_to_xy(i)
                for x in np.linspace(-5, 140, 11):
                    for y in np.linspace(-5, 90, 7):
                        assert a.xy_to_caret(x, y) == b.xy_to_caret(x, y)
    wide = text.FormattedText("WWWW", 16, font=fa)
    thin = text.FormattedText("iiii", 16, font=fa)
    assert (wide.lines[0].width > thin.lines[0].width) == with_font


def test_editing_and_bbcode_equal_jax():
    """apply_key over a key sequence with selections, and parse_bbcode on
    nested, coloured, sized, unknown and unbalanced tags."""
    state = ("hello world", 3, -1)
    jstate = state
    seq = [("Right", "", True), ("Right", "", True), ("Char", "X", False),
           ("Home", "", False), ("End", "", True), ("Backspace", "", False),
           ("Char", "ab", False), ("Left", "", False), ("Delete", "", False),
           ("Enter", "", False), ("Left", "", True), ("Delete", "", False),
           ("Backspace", "", False), ("Char", "", False)]
    for key, ch, shift in seq:
        out = text.apply_key(*state, key, char=ch, shift=shift)
        jout = jtext.apply_key(*jstate, key, char=ch, shift=shift)
        assert out == jout, key
        state, jstate = out[:3], jout[:3]
    for s in ("[b]bold [i]both[/i][/b] [color=#ff000080]red[/color]",
              "[size=20]big[/size] [color=teal]?[/color] [b]open",
              "[color=#abc]x[/color][size=x]y[/size][/b] [[b]]",
              "plain"):
        assert text.parse_bbcode(s) == jtext.parse_bbcode(s)


def test_atlas_cache_follows_the_font_not_its_address():
    """render_ui caches parsed fonts and atlases by the objects, which the
    cache keeps alive: after font A is dropped, a font B of A's byte length
    (its letters mapped to other glyphs) draws B's glyphs, for bytes and for
    TtfFont objects alike."""
    cmds = [DrawCommand(kind="text", bounds=Rect(2, 2, 120, 12),
                        text="ABC abc", color=(1, 1, 1, 1))]

    def draw(font):
        return render_ui(cmds, 16, 128, font=font)

    def fresh(data):
        """The font's own atlas of just the drawn characters (where a glyph
        sits in an atlas does not change what it draws)."""
        return render_ui(cmds, 16, 128, font=FontAtlas(
            TtfFont(data), max(int(12 * 0.7), 6), charset="ABC abc"))

    a = chip_smoke.write_ttf()
    size = len(a)
    img_a = draw(a)
    np.testing.assert_array_equal(img_a, fresh(a))
    del a
    gc.collect()
    b = chip_smoke.write_ttf(cmap_shift=1)
    assert len(b) == size
    img_b = draw(b)
    np.testing.assert_array_equal(img_b, fresh(b))
    assert not np.array_equal(img_b, img_a)
    fa = TtfFont(chip_smoke.write_ttf(cmap_shift=2))
    img_fa = draw(fa)
    del fa
    gc.collect()
    data = chip_smoke.write_ttf(cmap_shift=3)
    fb = TtfFont(data)
    img_fb = draw(fb)
    np.testing.assert_array_equal(img_fb, fresh(data))
    assert not np.array_equal(img_fb, img_fa)
    assert len(renderer._ATLASES) >= 4


def test_render_ui_font_equals_jax():
    """Text commands at two heights (one atlas each), rects and borders
    through the writer's font, passed as a TtfFont and as a FontAtlas:
    equal to the JAX package's to the bit, and unlike the 5x7 image (the
    font as bytes: test_torch_ui_tree.py)."""
    data = chip_smoke.write_ttf()

    def cmds(dc, rc):
        return [dc(kind="rect", bounds=rc(0, 0, 60, 20),
                   color=(0.1, 0.2, 0.3, 0.7)),
                dc(kind="text", bounds=rc(1, 2, 150, 24),
                   text="Hello AVATar 12", color=(1, 1, 1, 1)),
                dc(kind="text", bounds=rc(-4, 40, 90, 12), text="To Pa; :/_`",
                   color=(1, 0, 0, 0.6)),
                dc(kind="border", bounds=rc(3, 55, 100, 20),
                   color=(0, 1, 0, 1), thickness=2),
                dc(kind="text", bounds=rc(100, 60, 80, 12),
                   text="~{|}", color=(0.5, 0.5, 1, 1))]

    for make, jmake in ((lambda: TtfFont(data), lambda: JTtfFont(data)),
                        (lambda: FontAtlas(TtfFont(data), 10),
                         lambda: JFontAtlas(JTtfFont(data), 10))):
        got = render_ui(cmds(DrawCommand, Rect), 80, 180, font=make())
        want = jrenderer.render_ui(cmds(JDrawCommand, JRect), 80, 180,
                                   font=jmake())
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, render_ui(cmds(DrawCommand, Rect),
                                                 80, 180))
