"""Port parity: the UI runtime of fyrox_tpu_torch against fyrox_tpu's on
the CPU: ui.core's widget tree, styles, add and remove, the message queue,
process_os_event, the editors' helpers, animate / update, measure /
arrange and draw; input.InputState; render_ui with the 5x7 font and with
a TrueType font (chip_smoke.write_ttf); compose_over; and chip_smoke's ui
phase loop (hud_ui, hud_tick) run on the CPU.

One tree holding every widget kind that fyrox_tpu/ui/core.py measures,
arranges or draws (the kinds are read from its source) is built in both
packages and driven by one script of OS events (InputState events, turned
into the UI's clicks, drags, scrolls and keys by chip_smoke.ui_event):
moves, clicks, wheel, keys with modifiers, focus cycling, popups opened
and clicked away, hotkeys, a message box, a file browser over a temporary
directory, and animations over several update(dt) calls. After every event
both trees must hold equal widgets (every field, actual_rect exactly),
equal polled messages, focus and input state, and equal draw lists, field
by field. The UI is host Python and numpy in both packages, run in the
same order of operations, so every comparison is exact; compose_over is
float32 multiplies and adds on both sides and is held to the bit.
"""
import dataclasses
import re
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke
from fyrox_tpu import input as jinput
from fyrox_tpu.ui import core as jcore
from fyrox_tpu.ui import curve_editor as jce
from fyrox_tpu.ui import renderer as jrenderer
from fyrox_tpu.ui.font import FontAtlas as JFontAtlas
from fyrox_tpu.ui.font import TtfFont as JTtfFont
from fyrox_tpu_torch import input as tinput
from fyrox_tpu_torch.ui import core as tcore
from fyrox_tpu_torch.ui import curve_editor as tce
from fyrox_tpu_torch.ui import renderer as trenderer
from fyrox_tpu_torch.ui.font import FontAtlas, TtfFont

torch.set_num_threads(2)

JAX = types.SimpleNamespace(core=jcore, ce=jce, InputState=jinput.InputState,
                            render_ui=jrenderer.render_ui,
                            TtfFont=JTtfFont, FontAtlas=JFontAtlas)
PORT = types.SimpleNamespace(core=tcore, ce=tce,
                             InputState=tinput.InputState,
                             render_ui=trenderer.render_ui, TtfFont=TtfFont,
                             FontAtlas=FontAtlas)
SCREEN = (640.0, 400.0)
DT = 1 / 20
# past numpy's print threshold (1,000 values), so reprs summarise it
TEXTURE = np.linspace(0, 1, 24 * 16 * 4, dtype=np.float32).reshape(16, 24, 4)


# every widget kind fyrox_tpu/ui/core.py lays out or draws, each in zoo()
KINDS = ("bbcode", "border", "button", "canvas", "check", "colorpicker",
         "curve_editor", "decorator", "dropdown", "expander", "filebrowser",
         "grid", "image", "list", "log", "menu", "menu_item", "ninepatch",
         "numeric", "popup", "progress", "range", "screen", "scroll",
         "scrollbar", "searchbar", "selector", "slider", "stack", "tabs",
         "text", "textbox", "thumb", "tile", "toggle", "tree", "vec",
         "vector_image", "window", "wrap")


def core_kinds():
    """Every widget kind that fyrox_tpu/ui/core.py names: in kind
    comparisons, Widget(kind=...) calls and the focusable list."""
    import fyrox_tpu.ui.core as mod
    src = open(mod.__file__).read()
    kinds = set()
    for m in re.finditer(r'kind\s*(?:==|in|not in)\s*(\([^)]*\)|"[^"]+")',
                         src):
        kinds |= set(re.findall(r'"([^"]+)"', m.group(1)))
    kinds |= set(re.findall(r'kind="([^"]+)"', src))
    focusable = re.search(r"_FOCUSABLE = \(([^)]*)\)", src, re.S)
    kinds |= set(re.findall(r'"([^"]+)"', focusable.group(1)))
    return kinds


def zoo(lib, tmp):
    """A UserInterface holding every widget kind, with lib's packages.
    Returns (ui, {name: handle})."""
    core, ce = lib.core, lib.ce
    W_ = core.Widget
    ui = core.UserInterface(SCREEN)
    ui.define_style("warn", foreground=(1.0, 0.5, 0.0, 1.0), font_size=12.0)
    h = {}

    def add(name, parent=None, **kw):
        h[name] = ui.add(W_(name=name, **kw),
                         h[parent] if parent is not None else None)
        return h[name]

    def pressed(u, _h):
        u.log_push(h["log"], 1, "pressed")
        r = u.nodes.borrow(h["press"]).actual_rect
        u.open_popup(h["ctx"], r.x + r.w, r.y)

    def committed(u, hb):
        u.log_push(h["log"], 0, "commit " + u.nodes.borrow(hb).text)

    # the background screen: a nine-patch with an image, a decorator
    add("screen", kind="screen")
    add("patch", "screen", kind="ninepatch", width=90.0, height=60.0,
        margin=(540, 330, 0, 0), patch_border=6.0)
    add("image", "patch", kind="image", texture=TEXTURE)
    add("deco", "screen", kind="decorator", checked=True, width=90.0,
        height=20.0, margin=(440, 370, 0, 0))
    add("menubar", kind="menu", width=640.0)
    add("file", "menubar", kind="menu_item", text="File")
    add("open", "file", kind="menu_item", text="Open")
    add("quit", "file", kind="menu_item", text="Quit")
    add("edit", "menubar", kind="menu_item", text="Edit")
    add("undo", "edit", kind="menu_item", text="Undo")
    add("help", "menubar", kind="menu_item", text="Help")
    add("tools", kind="window", title="TOOLS", width=200.0,
        float_pos=(4.0, 26.0))
    add("form", "tools", kind="stack")
    add("hello", "form", kind="text", text="Hello", style="warn")
    add("press", "form", kind="button", text="Press", on_click=pressed)
    add("menubtn", "form", kind="button", text="Menu")
    add("check", "form", kind="check", text="Enabled")
    add("toggle", "form", kind="toggle", text="Snap")
    add("box", "form", kind="textbox", text="edit me", width=150.0,
        on_commit=committed)
    add("search", "form", kind="searchbar")
    add("num", "form", kind="numeric", value=1.5, step=0.5, min_value=0.0,
        max_value=3.0)
    add("slider", "form", kind="slider", value=0.3)
    add("range", "form", kind="range", value=0.2, value2=0.8)
    add("progress", "form", kind="progress", progress=0.4)
    add("hbar", "form", kind="scrollbar", orientation="horizontal",
        value=0.5)
    add("selector", "form", kind="selector", items=["a", "bb", "ccc"],
        selected=0)
    add("drop", "form", kind="dropdown", items=["Low", "Mid", "High"],
        selected=0)
    add("more", kind="window", title="MORE", width=200.0,
        float_pos=(210.0, 26.0))
    add("form2", "more", kind="stack")
    add("color", "form2", kind="colorpicker",
        color_value=(0.2, 0.6, 0.4, 1.0))
    add("expander", "form2", kind="expander", text="More")
    add("inside", "expander", kind="text", text="inside")
    add("tree", "form2", kind="tree", text="Root")
    add("leaf", "tree", kind="tree", text="Leaf", expanded=False)
    add("deep", "leaf", kind="text", text="deep")
    add("pick", "form2", kind="list", items=["one", "two", "three"])
    h["vec"] = ui.add_vec_editor((1.0, 2.0, 3.0), parent=h["form2"])
    h["rect"] = ui.add_rect_editor((0.0, 0.0, 4.0, 3.0), parent=h["form2"])
    h["matrix"] = ui.add_matrix_editor(((1.0, 0.0), (0.0, 1.0)),
                                       parent=h["form2"])
    h["path"] = ui.add_path_editor(str(tmp / "a.txt"), parent=h["form2"],
                                   browse_dir=str(tmp))
    add("grid", kind="grid", width=210.0, height=110.0,
        margin=(420, 26, 0, 0), rows=[("auto",), ("stretch",)],
        columns=[("strict", 100.0), ("stretch",)])
    add("glabel", "grid", kind="text", text="Grid")
    add("bb", "grid", kind="bbcode", grid_column=1,
        text="[b]Bold[/b] and [color=red]red[/color]\n[size=10]small[/size]"
             " [color=#0f0]ok[/color] [x]")
    add("log", "grid", kind="log", grid_row=1, log_capacity=4)
    add("tabs", "grid", kind="tabs", grid_row=1, grid_column=1,
        tab_headers=["One", "Two"])
    add("page1", "tabs", kind="text", text="first page")
    add("page2", "tabs", kind="text", text="second page")
    add("flow", kind="wrap", width=210.0, margin=(420, 140, 0, 0))
    for i in range(6):
        add(f"w{i}", "flow", kind="button", text=f"W{i}")
    add("scroller", kind="scroll", width=210.0, height=60.0,
        margin=(420, 220, 0, 0))
    add("lines", "scroller", kind="stack")
    for i in range(8):
        add(f"line{i}", "lines", kind="text", text=f"line {i}")
    add("dock", kind="tile", split="horizontal", ratio=0.4, width=210.0,
        height=60.0, margin=(420, 285, 0, 0))
    add("left", "dock", kind="tile")
    h["curve"] = ce.add_curve_editor(
        ui, keys=[(0.0, 0.0, 0.0), (1.0, 0.5, 1.0), (2.0, -0.2, 0.0)],
        parent=h["left"])
    add("right", "dock", kind="tile", split="vertical")
    add("vimg", "right", kind="vector_image",
        primitives=[("line", 0, 0, 20, 10), ("rect", 4, 4, 8, 6)])
    add("panel", "right", kind="border")
    add("grip", kind="thumb", float_pos=(600.0, 350.0))
    add("ctx", kind="popup")
    add("cut", "ctx", kind="menu_item", text="Cut")
    add("copy", "ctx", kind="menu_item", text="Copy")
    h["dropmenu"] = ui.attach_dropdown_menu(h["menubtn"], ["Alpha", "Beta"])
    add("bar", kind="border", width=100.0, height=8.0,
        margin=(4, 380, 0, 0), background=(0.2, 0.0, 0.0, 0.9))
    add("fill", "bar", kind="border", width=87.0, height=8.0,
        background=(0.1, 0.8, 0.1, 0.9))
    ui.bind_hotkey("s", lambda u: u.log_push(h["log"], 2, "saved"),
                   ctrl=True)
    ui.bind_hotkey("F1", lambda u: h.__setitem__(
        "msgbox", u.show_message_box("Note", "Saved", ("OK", "Cancel"))))
    ui.animate(h["progress"], "progress", 1.0, 0.2, "smooth")
    ui.animate(h["deco"], "background", (1.0, 0.0, 0.0, 1.0), 0.3,
               "ease_in")
    ui.animate(h["slider"], "value", 0.9, 0.15, "ease_out")
    ui.animate(h["range"], "value2", 0.6, 0.1)
    ui.update_layout()
    return ui, h


def script():
    """The script: a list of steps, each a function (ui, h) that returns
    one InputState event aimed at the widgets' current rects, or acts on
    the ui directly and returns None."""
    def at(name, fx=0.5, fy=0.5):
        def f(ui, h):
            r = ui.nodes.borrow(h[name]).actual_rect
            return {"type": "mouse_move", "x": r.x + r.w * fx,
                    "y": r.y + r.h * fy}
        return f

    def click(name, fx=0.5, fy=0.5):
        return [at(name, fx, fy), lambda ui, h: {"type": "mouse_down",
                                                 "button": 0},
                lambda ui, h: {"type": "mouse_up", "button": 0}]

    def row(name, i):
        """A click on row i of a list widget."""
        def f(ui, h):
            w = ui.nodes.borrow(h[name])
            if name == "browser":
                w = ui.nodes.borrow(w.children[0])
            r = w.actual_rect
            return {"type": "mouse_move", "x": r.x + 4.0,
                    "y": r.y + (i + 0.5) * w.font_size * 1.4}
        return [f, lambda ui, h: {"type": "mouse_down", "button": 0},
                lambda ui, h: {"type": "mouse_up", "button": 0}]

    def key(k, up=False):
        return lambda ui, h: {"type": "key_up" if up else "key_down",
                              "key": k}

    def keys(*names):
        return [key(k) for k in names]

    def path_button(ui, h):
        row_ = ui.nodes.borrow(h["path"])
        r = ui.nodes.borrow(row_.children[1]).actual_rect
        return {"type": "mouse_move", "x": r.x + r.w / 2, "y": r.y + r.h / 2}

    def act(fn):
        def f(ui, h):
            fn(ui, h)
        return f

    def find_browser(ui, h):
        for hh, w in ui.nodes.iter():
            if w.kind == "filebrowser":
                h["browser"] = hh

    def msgbox_button(label):
        def f(ui, h):
            win = ui.nodes.borrow(h["msgbox"])
            stack = ui.nodes.borrow(win.children[0])
            row_ = ui.nodes.borrow(stack.children[1])
            for c in row_.children:
                b = ui.nodes.borrow(c)
                if b.text == label:
                    r = b.actual_rect
                    return {"type": "mouse_move", "x": r.x + r.w / 2,
                            "y": r.y + r.h / 2}
        return f

    def spinner(name, up):
        def f(ui, h):
            r = ui.nodes.borrow(h[name]).actual_rect
            return {"type": "mouse_move", "x": r.x + r.w - 4,
                    "y": r.y + r.h * (0.25 if up else 0.75)}
        return f

    down = lambda ui, h: {"type": "mouse_down", "button": 0}  # noqa: E731
    up_ = lambda ui, h: {"type": "mouse_up", "button": 0}     # noqa: E731
    vec_num = act(lambda ui, h: h.__setitem__(
        "vnum", ui.nodes.borrow(h["vec"]).children[1]))
    steps = [
        *click("box", 0.9), *keys("Home", "Shift", "Right", "Right"),
        key("Shift", True), *keys("Z", "End", "Backspace", "Left", "Delete",
                                  "q", "Enter"),
        *keys("Control", "s"), key("Control", True), key("s", True),
        *keys("Tab", "Tab", "Tab", "Shift", "Tab"), key("Shift", True),
        *click("search"), *keys("f", "o", "Backspace"),
        *click("check"), *click("check"), *click("toggle"),
        *click("slider", 0.75), *click("range", 0.1), *click("range", 0.95),
        *click("hbar", 0.2), *click("selector", 0.02),
        *click("selector", 0.98), *click("selector", 0.98),
        spinner("num", True), down, up_, spinner("num", False), down, up_,
        vec_num, spinner("vnum", True), down, up_,
        *click("drop"), *row("drop", 2), *click("drop"), *row("drop", 1),
        *click("pick"), *row("pick", 2),
        *click("tabs", 0.5, 0.05), *click("expander", 0.5, 0.05),
        *click("expander", 0.5, 0.05), *click("tree", 0.5, 0.02),
        *click("tree", 0.5, 0.02), *click("color", 0.3, 0.1),
        *click("color", 0.6, 0.6),
        *click("file"), *click("open"), *click("edit"), *click("help"),
        *click("press"), *click("cut"), *click("press"), *click("w3"),
        *click("menubtn"), at("dropmenu"),
        act(lambda ui, h: ui.close_popups()), *click("menubtn"),
        act(lambda ui, h: h.__setitem__(
            "alpha", ui.nodes.borrow(h["dropmenu"]).children[0])),
        *click("alpha"),
        at("scroller"), lambda ui, h: {"type": "wheel", "delta": -20.0},
        lambda ui, h: {"type": "wheel", "delta": -30.0},
        lambda ui, h: {"type": "wheel", "delta": 15.0},
        at("grip"), down, lambda ui, h: {"type": "mouse_move", "x": 590.0,
                                         "y": 340.0}, up_,
        at("tools", 0.5, 0.02), down,
        lambda ui, h: {"type": "mouse_move", "x": 120.0, "y": 60.0}, up_,
        *click("curve"),
        path_button, down, up_, act(find_browser),
        *row("browser", 1), act(find_browser), *row("browser", 1),
        *keys("F1"), act(lambda ui, h: ui.update_layout()),
        msgbox_button("Cancel"), down, up_,
        *keys("F1"), msgbox_button("OK"), down, up_,
        act(lambda ui, h: ui.remove(h["line7"])),
        act(lambda ui, h: h.__setitem__("late", ui.add(
            type(ui.nodes.borrow(h["line0"]))(kind="text", text="late",
                                              style="warn"), h["lines"]))),
        act(lambda ui, h: ui.animate(h["grid"], "margin", (400, 30, 0, 0),
                                     0.15, "smooth")),
        at("help", 0.5, 0.5), at("flow"), *click("deco"),
    ]
    return steps


def hnd(h):
    return None if h is None else (h.index, h.generation)


def box(r):
    return (r.x, r.y, r.w, r.h)


def fn(f):
    return None if f is None else f.__qualname__


def widget(w):
    """Every attribute of a widget (its dataclass fields and what layout
    stores on it) as plain values: handles as (index, generation), rects as
    tuples, callbacks by qualified name, a texture by identity."""
    d = dict(vars(w))
    d.update(parent=hnd(w.parent), children=[hnd(c) for c in w.children],
             actual_rect=box(w.actual_rect), on_click=fn(w.on_click),
             on_commit=fn(w.on_commit), texture=id(w.texture))
    return d


def snapshot(ui, msgs, inp):
    return dict(
        nodes=[(hnd(hh), widget(w)) for hh, w in ui.nodes.iter()],
        cmds=[(c.kind, box(c.bounds), c.color, c.text, c.thickness,
               id(c.texture), c.points) for c in ui.draw()],
        msgs=[(hnd(m.destination), m.data, m.direction, m.handled)
              for m in msgs],
        focus=hnd(ui.focus), input=dataclasses.asdict(inp),
        queue=len(ui._queue))


def drive(lib, tmp, each):
    """Build the zoo with lib and run the script; each(k, ui, h, snap) is
    called after every step. Returns (ui, h, every polled message)."""
    ui, h = zoo(lib, tmp)
    inp = lib.InputState()
    seen = []
    for k, step in enumerate(script()):
        ev = step(ui, h)
        if ev is not None:
            inp.process_event(ev)
            uev = chip_smoke.ui_event(inp, ev)
            if uev is not None:
                ui.process_os_event(uev)
        ui.update(DT)
        msgs = []
        m = ui.poll_message()
        while m is not None:
            msgs.append(m)
            m = ui.poll_message()
        each(k, ui, h, snapshot(ui, msgs, inp))
        seen += msgs
        inp.end_frame()
    return ui, h, seen


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("browse")
    (tmp / "a.txt").write_text("a")
    (tmp / "b.txt").write_text("b")
    (tmp / "sub").mkdir()
    (tmp / "sub" / "c.txt").write_text("c")
    return tmp


@pytest.fixture(scope="module")
def runs(files):
    """Both packages driven through the script: per step the snapshot, and
    the 5x7 renders of a few steps' draw lists."""
    out = {}
    for name, lib in (("jax", JAX), ("port", PORT)):
        snaps, images = [], {}

        def each(k, ui, h, snap, lib=lib, snaps=snaps, images=images):
            snaps.append(snap)
            if k % 40 == 0:
                images[k] = lib.render_ui(ui.draw(), int(SCREEN[1]),
                                          int(SCREEN[0]))

        ui, h, msgs = drive(lib, files, each)
        out[name] = dict(snaps=snaps, images=images, ui=ui, h=h, msgs=msgs)
    return out


def test_zoo_holds_every_widget_kind(runs):
    """KINDS is every kind the JAX module names, and the zoo holds each."""
    assert core_kinds() == set(KINDS)
    kinds = {w.kind for _hh, w in runs["port"]["ui"].nodes.iter()}
    assert set(KINDS) <= kinds, sorted(set(KINDS) - kinds)


@pytest.mark.parametrize("part", ["nodes", "msgs", "focus", "input",
                                  "cmds", "queue"])
def test_every_event_equals_jax(runs, part):
    """Widgets (every field: actual_rect exactly, desired sizes, texts,
    carets, values, open states), messages, focus, input state and draw
    lists after each event of the script."""
    j, p = runs["jax"]["snaps"], runs["port"]["snaps"]
    assert len(j) == len(p) > 100
    for k, (a, b) in enumerate(zip(j, p)):
        assert b[part] == a[part], f"step {k}"


def test_script_reaches_every_handler(runs):
    seen = {m.data.get("type", m.data.get("kind"))
            for m in runs["port"]["msgs"]}
    want = {"focused", "click", "checked", "toggled", "value_changed",
            "range_changed", "selection_changed", "text_changed",
            "text_committed", "hotkey", "menu_selected", "tab_changed",
            "color_changed", "vec_changed", "file_selected", "path_changed",
            "message_box_result", "anim_done", "drag_delta",
            "search_text_changed"}
    assert want <= seen, sorted(want - seen)
    ui, h = runs["port"]["ui"], runs["port"]["h"]
    log = [m for _s, m in ui.nodes.borrow(h["log"]).log_entries]
    assert len(log) == 4 and "saved" in log
    assert ui.nodes.try_borrow(h["msgbox"]) is None
    assert ui.nodes.try_borrow(h["line7"]) is None
    assert ui.nodes.borrow(h["late"]).font_size == 12.0     # styled
    assert ui.nodes.borrow(h["box"]).text != "edit me"
    assert ui.nodes.borrow(h["scroller"]).scroll[1] == 35.0
    assert ui.nodes.borrow(h["grip"]).float_pos != (600.0, 350.0)
    assert ui.nodes.borrow(h["tools"]).float_pos != (4.0, 26.0)


def test_render_ui_5x7_equals_jax(runs):
    j, p = runs["jax"]["images"], runs["port"]["images"]
    assert sorted(j) == sorted(p) and len(p) >= 4
    for k in p:
        np.testing.assert_array_equal(p[k], j[k])
        assert (p[k][..., 3] > 0).mean() > 0.1


def test_render_ui_truetype_equals_jax(runs):
    """The zoo's last draw list through a FontAtlas, and hud_ui's through
    the writer's bytes (parsed once, an atlas a text height), in each
    package: equal to the bit."""
    data = chip_smoke.write_ttf()
    cmds = {n: runs[n]["ui"].draw() for n in ("jax", "port")}
    hud = {n: chip_smoke.hud_ui(lib.core)[0].draw()
           for n, lib in (("jax", JAX), ("port", PORT))}
    h, w = int(SCREEN[1]), int(SCREEN[0])
    n = chip_smoke.UI_SIZE
    for lists, (hh, ww), make in (
            (cmds, (h, w), lambda lib: lib.FontAtlas(lib.TtfFont(data), 11)),
            (hud, (n, n), lambda lib: data)):
        want = JAX.render_ui(lists["jax"], hh, ww, font=make(JAX))
        got = PORT.render_ui(lists["port"], hh, ww, font=make(PORT))
        np.testing.assert_array_equal(got, want)
        plain = PORT.render_ui(lists["port"], hh, ww)
        assert not np.array_equal(got, plain)
        assert chip_smoke.uninked_text(lists["port"], got) == []


def test_hud_loop_equals_jax():
    """chip_smoke's ui phase on the CPU: hud_ui's tree and UI_TICKS ticks
    of hud_tick in both packages, each tick's messages, widgets and
    render_ui through the writer's font equal, composed over seeded
    frames equal to the bit."""
    data = chip_smoke.write_ttf()
    n = chip_smoke.UI_SIZE
    frames = np.random.default_rng(3).uniform(0, 1, (2, n, n, 3)).astype(
        np.float32)
    runs_ = {}
    for name, lib in (("jax", JAX), ("port", PORT)):
        ui, h = chip_smoke.hud_ui(lib.core)
        inp = lib.InputState()
        atlas = lib.FontAtlas(lib.TtfFont(data), chip_smoke.UI_FONT_PX)
        ticks = []
        for k in range(chip_smoke.UI_TICKS):
            msgs = chip_smoke.hud_tick(ui, h, inp, k)
            cmds = ui.draw()
            img = lib.render_ui(cmds, n, n, font=atlas)
            ticks.append((snapshot(ui, msgs, inp), img, cmds))
        runs_[name] = (ui, h, ticks)
    assert len(list(runs_["port"][0].nodes.iter())) >= 20
    for k, (a, b) in enumerate(zip(runs_["jax"][2], runs_["port"][2])):
        assert b[0] == a[0], f"tick {k}"
        np.testing.assert_array_equal(b[1], a[1])
        assert chip_smoke.uninked_text(b[2], b[1]) == []
    ui, h, ticks = runs_["port"]
    assert ui.nodes.borrow(h["name"]).text != "hero"
    assert ui.nodes.borrow(h["scroll"]).scroll[1] > 0
    img = ticks[-1][1]
    got = trenderer.compose_over(torch.as_tensor(frames), img)
    want = np.asarray(jrenderer.compose_over(jnp.asarray(frames), img))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(img, PORT.render_ui(ticks[-1][2], n, n))


def test_compose_over_equals_jax():
    """compose_over on CPU tensors (a numpy image and a tensor image,
    broadcast over the worlds) against the JAX package's: equal to the
    bit (the same three float32 multiplies and adds, none fused)."""
    rng = np.random.default_rng(7)
    frames = rng.uniform(0, 1, (3, 40, 56, 3)).astype(np.float32)
    ui = rng.uniform(0, 1, (40, 56, 4)).astype(np.float32)
    ui[..., 3] *= rng.uniform(0, 1, (40, 56)) > 0.3
    want = np.asarray(jrenderer.compose_over(jnp.asarray(frames), ui))
    for img in (ui, torch.as_tensor(ui)):
        got = trenderer.compose_over(torch.as_tensor(frames), img)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_input_state_equals_jax():
    """InputState over a stream of every event type, field by field after
    each event and after each end_frame."""
    events = [{"type": "key_down", "key": "w"},
              {"type": "key_down", "key": "w"},
              {"type": "mouse_move", "x": 10.0, "y": 5.0},
              {"type": "mouse_move", "x": 13.5, "y": 2.0},
              {"type": "mouse_down", "button": 0},
              {"type": "mouse_down", "button": 2},
              {"type": "wheel", "delta": 1.5},
              {"type": "wheel", "delta": -0.25},
              {"type": "key_up", "key": "w"},
              {"type": "mouse_up", "button": 0},
              {"type": "key_up", "key": "q"},
              {"type": "unknown"}]
    a, b = JAX.InputState(), PORT.InputState()
    for i, ev in enumerate(events):
        a.process_event(ev)
        b.process_event(ev)
        assert dataclasses.asdict(b) == dataclasses.asdict(a), i
        assert b.is_key_down("w") == a.is_key_down("w")
        assert b.was_key_pressed("w") == a.was_key_pressed("w")
        if i % 3 == 2:
            a.end_frame()
            b.end_frame()
            assert dataclasses.asdict(b) == dataclasses.asdict(a), i


def test_pool_equals_jax():
    """The generational pool under spawn, spawn_at, free, replace,
    take_reserve / put_back: handles, validity and contents equal."""
    from fyrox_tpu.core.pool import Pool as JPool
    from fyrox_tpu_torch.core.pool import Handle, Pool

    def run(cls):
        p = cls()
        out = []
        hs = [p.spawn(f"v{i}") for i in range(5)]
        p.free(hs[1])
        p.free(hs[3])
        hs.append(p.spawn("again"))
        hs.append(p.spawn_at(8, "far"))
        t = p.take_reserve(hs[0])
        out.append(p.try_borrow(hs[0]))
        hs[0] = p.put_back(t, "back")
        p.replace(hs[2], "new")
        with pytest.raises(ValueError):
            p.spawn_at(8, "x")
        with pytest.raises(KeyError):
            p.borrow(hs[1])
        out += [(h.index, h.generation, p.is_valid(h), p.try_borrow(h))
                for h in hs]
        out += [len(p), p.capacity, [(h.index, h.generation, v)
                                     for h, v in p.iter()],
                [(h.index, h.generation) for h in p.handles()]]
        return out

    assert run(Pool) == run(JPool)
    assert Handle.none().is_none() and not Handle(2, 1).is_none()
