"""Retained-mode UI core (the port's copy of ``fyrox_tpu.ui.core``).

Equivalent of fyrox-ui's foundations (fyrox-ui/src/lib.rs): a widget tree on
the generational pool, routed message queue (`poll_message`, lib.rs:2345),
and the two-pass measure/arrange layout (`measure_node` lib.rs:1830,
`arrange_node` :1745, `update_layout` :1507). Widgets emit draw commands
only (draw.rs) — ``ui.renderer.render_ui`` paints the command list on the
host and ``ui.renderer.compose_over`` lays the image over frames on their
device.

Host-side by design, like the reference: UI is authoring/HUD logic, not the
batched hot loop.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from fyrox_tpu_torch.core.pool import Handle, Pool

__all__ = ["Widget", "UserInterface", "UiMessage", "Rect", "DrawCommand"]

INF = float("inf")
_SEL_ARROW_PX = 16.0          # selector.rs arrow hit zones
# widget kinds reachable by Tab traversal (navigation.rs)
_FOCUSABLE = ("textbox", "searchbar", "button", "check", "numeric",
              "slider", "dropdown", "toggle", "selector", "list")


def _hsv_to_rgb(h, s, v):
    import colorsys
    return colorsys.hsv_to_rgb(h % 1.0, min(max(s, 0.0), 1.0),
                               min(max(v, 0.0), 1.0))


@dataclass
class Rect:
    x: float = 0.0
    y: float = 0.0
    w: float = 0.0
    h: float = 0.0

    def contains(self, px, py):
        return self.x <= px <= self.x + self.w and self.y <= py <= self.y + self.h


@dataclass
class UiMessage:
    """Routed widget message (message.rs equivalent)."""
    destination: Handle
    data: Dict
    direction: str = "to_widget"   # or "from_widget"
    handled: bool = False


@dataclass
class DrawCommand:
    kind: str                      # 'rect', 'text', 'border', 'image', 'line'
    bounds: Rect = field(default_factory=Rect)
    color: Tuple[float, float, float, float] = (1, 1, 1, 1)
    text: str = ""
    thickness: float = 1.0
    texture: Optional[object] = None   # image widgets (image.rs)
    points: Optional[list] = None      # polyline (vector_image.rs)


@dataclass
class Widget:
    """Base widget data (fyrox-ui widget.rs equivalent). Subclass behavior
    comes from `kind` + the per-kind measure/arrange/draw/message hooks."""
    name: str = ""
    kind: str = "border"
    parent: Handle = field(default_factory=Handle.none)
    children: List[Handle] = field(default_factory=list)
    # layout inputs
    width: float = INF             # NaN/INF = auto
    height: float = INF
    min_size: Tuple[float, float] = (0.0, 0.0)
    max_size: Tuple[float, float] = (INF, INF)
    margin: Tuple[float, float, float, float] = (0, 0, 0, 0)  # l,t,r,b
    visible: bool = True
    # widget-kind payload
    text: str = ""
    background: Tuple[float, float, float, float] = (0.2, 0.2, 0.2, 1.0)
    foreground: Tuple[float, float, float, float] = (0.9, 0.9, 0.9, 1.0)
    orientation: str = "vertical"  # stack panels
    font_size: float = 14.0
    on_click: Optional[Callable] = None
    # grid (fyrox-ui/src/grid.rs): row/column size definitions — each entry
    # ("strict", px) | ("auto",) | ("stretch",); children carry grid_row/col
    rows: List[tuple] = field(default_factory=list)
    columns: List[tuple] = field(default_factory=list)
    grid_row: int = 0
    grid_column: int = 0
    # scroll viewer (scroll_viewer.rs): content offset in px
    scroll: Tuple[float, float] = (0.0, 0.0)
    # window (window.rs): title bar height; tree item (tree.rs): expansion
    title: str = ""
    title_height: float = 22.0
    expanded: bool = True
    indent: float = 16.0
    # check box (check_box.rs)
    checked: bool = False
    # docking tile (dock/mod.rs Tile): "content" leaf, or a
    # horizontal/vertical split of exactly two child tiles at `ratio`
    split: str = "content"
    ratio: float = 0.5
    splitter_px: float = 4.0
    # curve editor (curve/mod.rs): keys live on the widget; `view` is
    # (origin_x, origin_y, scale_x, scale_y) curve→pixel transform
    curve_keys: Optional[list] = None      # [(t, value, tangent), ...]
    view: Tuple[float, float, float, float] = (0.0, 0.0, 50.0, -50.0)
    selected_key: int = -1
    # text box (text_box.rs): caret/selection state + wrap mode
    # (formatted text layout lives in ui/text.py)
    caret: int = 0
    sel_anchor: int = -1
    wrap: str = "none"             # "none" | "letter" | "word"
    on_commit: Optional[Callable] = None   # fn(ui, handle) on Enter
    # list view / dropdown list (list_view.rs, dropdown_list.rs)
    items: List[str] = field(default_factory=list)
    selected: int = -1
    # popup / menu / dropdown open state (popup.rs, menu.rs)
    open: bool = False
    popup_pos: Tuple[float, float] = (0.0, 0.0)
    # progress bar (progress_bar.rs): fraction in [0,1]
    progress: float = 0.0
    # range / slider (range.rs, scroll_bar.rs)
    value: float = 0.0
    min_value: float = 0.0
    max_value: float = 1.0
    # nine patch (nine_patch.rs): fixed-margin frame, stretching center
    patch_border: float = 8.0
    # tab control (tab_control.rs): active tab index; children are pages
    active_tab: int = 0
    tab_headers: List[str] = field(default_factory=list)
    # expander (expander.rs): header + collapsible content (uses
    # `expanded` + `text` shared with tree)
    # color picker / color field (color.rs): current RGBA
    color_value: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 1.0)
    # file browser (file_browsers/): current directory + listing state
    path: str = ""
    # style key (style/mod.rs StyledProperty): resolved at add() time
    style: str = ""
    # numeric up-down (numeric.rs): value/min/max shared with slider
    step: float = 1.0
    # free-floating position for windows/popouts on a canvas
    # (window.rs desired_position); None = parent-arranged
    float_pos: Optional[Tuple[float, float]] = None
    # image (image.rs): texture payload blitted by the renderer
    texture: Optional[object] = None
    # vector image (vector_image.rs): primitive list, coords in local
    # units — [("line", x0, y0, x1, y1), ("rect", x, y, w, h), ...]
    primitives: List[tuple] = field(default_factory=list)
    # range editor (range.rs): second value (start = `value`, end = value2)
    value2: float = 1.0
    # log panel (fyrox-ui log.rs): (severity, message) ring; severity
    # filter 0=info 1=warning 2=error
    log_entries: List[tuple] = field(default_factory=list)
    log_filter: int = 0
    log_capacity: int = 256
    # layout outputs
    desired_size: Tuple[float, float] = (0.0, 0.0)
    actual_rect: Rect = field(default_factory=Rect)


class UserInterface:
    """Widget tree + layout + message routing (lib.rs:733)."""

    def __init__(self, screen_size=(800.0, 600.0)):
        self.nodes: Pool = Pool()
        self.root = self.nodes.spawn(Widget(name="__ROOT__", kind="canvas"))
        self.screen_size = screen_size
        self._queue: List[UiMessage] = []
        self.focus: Optional[Handle] = None    # keyboard focus (text input)
        # style table (fyrox-ui style/mod.rs): named property bundles
        # resolved at add() time; register with define_style()
        self.styles: Dict[str, Dict] = {}
        # hotkey table (key.rs HotKey): (key, ctrl, shift, alt) -> callback
        self.hotkeys: Dict[tuple, Callable] = {}
        # running property animations (animation.rs)
        self._anims: List[dict] = []
        # composite-widget message taps (path editor etc): fn(ui, msg)
        self._routes: List[Callable] = []

    def define_style(self, name: str, **props):
        """Register a named style bundle (style/mod.rs Style resources).
        Widgets created with Widget(style=name) get these fields applied
        unless explicitly overridden before add()."""
        self.styles[name] = dict(props)

    # -- tree ---------------------------------------------------------------
    def add(self, widget: Widget, parent: Optional[Handle] = None) -> Handle:
        parent = parent or self.root
        if widget.style and widget.style in self.styles:
            defaults = Widget()
            for k, v in self.styles[widget.style].items():
                # only fill fields the caller left at their defaults
                if getattr(widget, k) == getattr(defaults, k):
                    setattr(widget, k, v)
        h = self.nodes.spawn(widget)
        widget.parent = parent
        self.nodes.borrow(parent).children.append(h)
        return h

    def remove(self, handle: Handle):
        w = self.nodes.borrow(handle)
        for c in list(w.children):
            self.remove(c)
        parent = self.nodes.try_borrow(w.parent)
        if parent is not None and handle in parent.children:
            parent.children.remove(handle)
        self.nodes.free(handle)

    # -- messages -----------------------------------------------------------
    def send_message(self, msg: UiMessage):
        for r in list(self._routes):
            r(self, msg)
        self._queue.append(msg)

    def poll_message(self) -> Optional[UiMessage]:
        """lib.rs:2345 — drain one routed message."""
        return self._queue.pop(0) if self._queue else None

    def process_os_event(self, event: Dict):
        """Hit-test clicks → click messages → on_click callbacks."""
        if event.get("type") == "key":
            self._key_event(event)
            return
        if event.get("type") == "click":
            x, y = event["x"], event["y"]
            hit = self._hit_test(self.root, x, y)
            if (hit is not None
                    and self.nodes.borrow(hit).kind in ("textbox",
                                                        "searchbar")):
                w = self.nodes.borrow(hit)
                if self.focus != hit:
                    self.focus = hit
                    self.send_message(UiMessage(
                        destination=hit, data={"type": "focused"},
                        direction="from_widget"))
                from fyrox_tpu_torch.ui.text import FormattedText
                ft = FormattedText(w.text, w.font_size, wrap=w.wrap,
                                   constraint=(w.actual_rect.w, w.actual_rect.h))
                w.caret = ft.xy_to_caret(x - w.actual_rect.x - 3,
                                         y - w.actual_rect.y - 2)
                w.sel_anchor = -1
            elif self.focus is not None:
                self.focus = None
            if hit is not None and not self._in_open_overlay(hit):
                # click-away: anything outside an open overlay chain
                # closes menus/popups/dropdowns (popup.rs focus loss)
                self.close_popups()
            if hit is not None:
                w = self.nodes.borrow(hit)
                msg = UiMessage(destination=hit,
                                data={"type": "click", "x": x, "y": y},
                                direction="from_widget")
                self.send_message(msg)
                if w.kind == "check":
                    w.checked = not w.checked
                    self.send_message(UiMessage(
                        destination=hit,
                        data={"type": "checked", "value": w.checked},
                        direction="from_widget"))
                if w.kind == "tree":
                    head_h = w.font_size * 1.4
                    if y <= w.actual_rect.y + head_h:
                        w.expanded = not w.expanded
                if w.kind == "menu_item":
                    if w.children:
                        was = w.open
                        parent = self.nodes.try_borrow(w.parent)
                        if parent is not None:
                            for sib in parent.children:
                                self.nodes.borrow(sib).open = False
                        w.open = not was
                        self.update_layout()
                    else:
                        self.send_message(UiMessage(
                            destination=hit,
                            data={"type": "menu_selected", "item": w.text},
                            direction="from_widget"))
                        self.close_popups()
                if w.kind == "dropdown":
                    w.open = not w.open
                    lst = self._dropdown_list(hit)
                    lw = self.nodes.borrow(lst)
                    lw.items = list(w.items)
                    lw.selected = w.selected
                    self.update_layout()
                if w.kind == "list":
                    row_h = w.font_size * 1.4
                    idx = int((y - w.actual_rect.y) // row_h)
                    if 0 <= idx < len(w.items):
                        w.selected = idx
                        self.send_message(UiMessage(
                            destination=hit,
                            data={"type": "selection_changed",
                                  "index": idx, "item": w.items[idx]},
                            direction="from_widget"))
                        parent = self.nodes.try_borrow(w.parent)
                        if parent is not None and parent.kind == "dropdown":
                            parent.selected = idx
                            parent.open = False
                            self.send_message(UiMessage(
                                destination=w.parent,
                                data={"type": "selection_changed",
                                      "index": idx, "item": w.items[idx]},
                                direction="from_widget"))
                            self.update_layout()
                        elif (parent is not None
                              and parent.kind == "filebrowser"):
                            import os as _os
                            item = w.items[idx]
                            if item == "..":
                                self.browse(w.parent, _os.path.dirname(
                                    parent.path) or parent.path)
                            elif item.endswith("/"):
                                self.browse(w.parent, _os.path.join(
                                    parent.path, item[:-1]))
                            else:
                                self.send_message(UiMessage(
                                    destination=w.parent,
                                    data={"type": "file_selected",
                                          "path": _os.path.join(
                                              parent.path, item)},
                                    direction="from_widget"))
                if w.kind == "slider":
                    t = (x - w.actual_rect.x) / max(w.actual_rect.w, 1e-9)
                    t = min(max(t, 0.0), 1.0)
                    w.value = w.min_value + t * (w.max_value - w.min_value)
                    self.send_message(UiMessage(
                        destination=hit,
                        data={"type": "value_changed", "value": w.value},
                        direction="from_widget"))
                if w.kind == "toggle":
                    # toggle button (toggle.rs): flips pressed state
                    w.checked = not w.checked
                    self.send_message(UiMessage(
                        destination=hit,
                        data={"type": "toggled", "value": w.checked},
                        direction="from_widget"))
                if w.kind == "range":
                    # move the NEAREST handle to the click (range.rs)
                    t = (x - w.actual_rect.x) / max(w.actual_rect.w, 1e-9)
                    t = min(max(t, 0.0), 1.0)
                    v = w.min_value + t * (w.max_value - w.min_value)
                    if abs(v - w.value) <= abs(v - w.value2):
                        w.value = min(v, w.value2)
                    else:
                        w.value2 = max(v, w.value)
                    self.send_message(UiMessage(
                        destination=hit,
                        data={"type": "range_changed",
                              "start": w.value, "end": w.value2},
                        direction="from_widget"))
                if w.kind == "scrollbar":
                    # value from click position along the orientation
                    # (scroll_bar.rs thumb jump)
                    r = w.actual_rect
                    if w.orientation == "vertical":
                        t = (y - r.y) / max(r.h, 1e-9)
                    else:
                        t = (x - r.x) / max(r.w, 1e-9)
                    t = min(max(t, 0.0), 1.0)
                    w.value = w.min_value + t * (w.max_value - w.min_value)
                    self.send_message(UiMessage(
                        destination=hit,
                        data={"type": "value_changed", "value": w.value},
                        direction="from_widget"))
                if w.kind == "selector":
                    # selector.rs: arrow zones cycle through items
                    r = w.actual_rect
                    delta = (-1 if x <= r.x + _SEL_ARROW_PX else
                             1 if x >= r.x + r.w - _SEL_ARROW_PX else 0)
                    if delta and w.items:
                        w.selected = (w.selected + delta) % len(w.items)
                        self.send_message(UiMessage(
                            destination=hit,
                            data={"type": "selection_changed",
                                  "index": w.selected,
                                  "item": w.items[w.selected]},
                            direction="from_widget"))
                if w.kind == "numeric":
                    r = w.actual_rect
                    if x >= r.x + r.w - 14:
                        delta = w.step if y < r.y + r.h / 2 else -w.step
                        w.value = min(max(w.value + delta, w.min_value),
                                      w.max_value)
                        self.send_message(UiMessage(
                            destination=hit,
                            data={"type": "value_changed",
                                  "value": w.value},
                            direction="from_widget"))
                        parent = self.nodes.try_borrow(w.parent)
                        if parent is not None and parent.kind == "vec":
                            self.send_message(UiMessage(
                                destination=w.parent,
                                data={"type": "vec_changed",
                                      "value": self.vec_value(w.parent)},
                                direction="from_widget"))
                if w.kind == "tabs":
                    head_h = w.font_size * 1.6
                    if y <= w.actual_rect.y + head_h:
                        cx_ = w.actual_rect.x
                        for i, title in enumerate(w.tab_headers):
                            tw_ = len(title) * w.font_size * 0.55 + 16
                            if cx_ <= x < cx_ + tw_:
                                if i != w.active_tab:
                                    w.active_tab = i
                                    self.send_message(UiMessage(
                                        destination=hit,
                                        data={"type": "tab_changed",
                                              "index": i},
                                        direction="from_widget"))
                                    self.update_layout()
                                break
                            cx_ += tw_
                if w.kind == "expander":
                    if y <= w.actual_rect.y + w.font_size * 1.4:
                        w.expanded = not w.expanded
                        self.update_layout()
                if w.kind == "colorpicker":
                    r = w.actual_rect
                    strip_w = max(r.w - 34.0, 10.0)
                    if x <= r.x + strip_w:
                        import colorsys
                        h0, s0, v0 = colorsys.rgb_to_hsv(*w.color_value[:3])
                        t = min(max((x - r.x) / strip_w, 0.0), 1.0)
                        if y <= r.y + 13.0:           # hue strip
                            rgb = _hsv_to_rgb(t, 1.0, max(v0, 0.5))
                        else:                          # value strip
                            rgb = _hsv_to_rgb(h0, 1.0 if s0 == 0 else s0, t)
                        w.color_value = (*rgb, w.color_value[3])
                        self.send_message(UiMessage(
                            destination=hit,
                            data={"type": "color_changed",
                                  "color": w.color_value},
                            direction="from_widget"))
                if w.on_click is not None:
                    w.on_click(self, hit)
            else:
                self.close_popups()
        elif event.get("type") == "drag":
            # window title-bar dragging (window.rs): move free-floating
            # windows by (dx, dy); the hit must land on the title bar
            x, y = event["x"], event["y"]
            hit = self._hit_test(self.root, x, y)
            if hit is not None:
                tw = self.nodes.borrow(hit)
                if tw.kind == "thumb":
                    # thumb.rs: draggable grip — moves itself and emits
                    # the delta for whoever owns it
                    base = (tw.float_pos if tw.float_pos is not None
                            else (tw.actual_rect.x, tw.actual_rect.y))
                    tw.float_pos = (base[0] + event.get("dx", 0.0),
                                    base[1] + event.get("dy", 0.0))
                    self.send_message(UiMessage(
                        destination=hit,
                        data={"type": "drag_delta",
                              "dx": event.get("dx", 0.0),
                              "dy": event.get("dy", 0.0)},
                        direction="from_widget"))
                    self.update_layout()
                    return
            while hit is not None and hit.is_some():
                w = self.nodes.borrow(hit)
                if w.kind == "window":
                    if y <= w.actual_rect.y + w.title_height:
                        base = (w.float_pos if w.float_pos is not None
                                else (w.actual_rect.x, w.actual_rect.y))
                        w.float_pos = (base[0] + event.get("dx", 0.0),
                                       base[1] + event.get("dy", 0.0))
                        self.update_layout()
                    break
                hit = w.parent if w.parent.is_some() else None
        elif event.get("type") == "scroll":
            hit = self._hit_test(self.root, event["x"], event["y"])
            while hit is not None:
                w = self.nodes.borrow(hit)
                if w.kind == "scroll":
                    w.scroll = (w.scroll[0],
                                max(w.scroll[1] - event.get("dy", 0.0), 0.0))
                    break
                hit = w.parent if w.parent.is_some() else None

    def _in_open_overlay(self, handle: Handle) -> bool:
        """True when the widget is an overlay kind (menu_item/popup/
        dropdown/list) or lives under one — clicks there must not
        trigger click-away closing."""
        h = handle
        while h is not None and h.is_some():
            w = self.nodes.try_borrow(h)
            if w is None:
                return False
            if w.kind in ("menu", "menu_item", "popup", "dropdown", "list"):
                return True
            h = w.parent
        return False

    def close_popups(self):
        """Close every open menu/popup/dropdown (click-away semantics,
        popup.rs hide-on-focus-loss)."""
        changed = False
        for _h, w in self.nodes.iter():
            if getattr(w, "kind", None) in ("menu_item", "popup",
                                            "dropdown") and w.open:
                w.open = False
                changed = True
        if changed:
            self.update_layout()

    def bind_hotkey(self, key: str, callback: Callable, ctrl=False,
                    shift=False, alt=False):
        """Register a global hotkey (key.rs HotKey): callback(ui) fires on
        a matching key event not consumed by a focused text field."""
        self.hotkeys[(key, bool(ctrl), bool(shift), bool(alt))] = callback

    def focus_next(self, backward=False):
        """Move keyboard focus to the next/previous focusable widget in
        tree order (navigation.rs KeyboardNavigationManager), cyclic."""
        order: List[Handle] = []

        def walk(h):
            w = self.nodes.borrow(h)
            if not w.visible:
                return
            if w.kind in _FOCUSABLE:
                order.append(h)
            for c in w.children:
                walk(c)

        walk(self.root)
        if not order:
            return
        try:
            i = order.index(self.focus)
            i = (i - 1 if backward else i + 1) % len(order)
        except ValueError:
            i = len(order) - 1 if backward else 0
        self.focus = order[i]
        self.send_message(UiMessage(
            destination=self.focus, data={"type": "focused"},
            direction="from_widget"))

    def add_vec_editor(self, values, parent=None, labels=None,
                       step: float = 0.1) -> Handle:
        """N-component vector field editor (fyrox-ui vec.rs VecEditor):
        a row of labeled numeric up-downs; any component change emits a
        `vec_changed` message on the editor with the full tuple."""
        vec = self.add(Widget(kind="vec", orientation="horizontal"),
                       parent)
        labels = labels or ("x", "y", "z", "w")[:len(values)]
        for lbl, v in zip(labels, values):
            self.add(Widget(kind="text", text=lbl, margin=(4, 2, 2, 0)),
                     vec)
            self.add(Widget(kind="numeric", value=float(v), step=step,
                            min_value=-1e18, max_value=1e18), vec)
        return vec

    def vec_value(self, handle: Handle) -> tuple:
        """Current tuple of a vec editor's numeric components."""
        w = self.nodes.borrow(handle)
        return tuple(self.nodes.borrow(c).value for c in w.children
                     if self.nodes.borrow(c).kind == "numeric")

    def add_rect_editor(self, rect, parent=None) -> Handle:
        """Rect field editor (fyrox-ui rect.rs RectEditor): an (x, y, w,
        h) numeric row; edits emit `vec_changed` with the 4-tuple."""
        return self.add_vec_editor(tuple(rect), parent=parent,
                                   labels=("x", "y", "w", "h"))

    def add_matrix_editor(self, matrix, parent=None) -> Handle:
        """Matrix field editor (fyrox-ui matrix.rs): one vec row per
        matrix row under a vertical stack; read back with
        matrix_value()."""
        box = self.add(Widget(kind="stack", orientation="vertical"),
                       parent)
        for row in matrix:
            self.add_vec_editor(tuple(row), parent=box,
                                labels=[""] * len(row))
        return box

    def matrix_value(self, handle: Handle) -> tuple:
        w = self.nodes.borrow(handle)
        return tuple(self.vec_value(c) for c in w.children
                     if self.nodes.borrow(c).kind == "vec")

    def add_path_editor(self, path: str, parent=None,
                        browse_dir: str = ".") -> Handle:
        """Path field editor (fyrox-ui path.rs PathEditor): a text box +
        a '...' button opening a file-browser popup; committing the box
        or picking a file emits `path_changed` on the editor."""
        row = self.add(Widget(kind="stack", orientation="horizontal"),
                       parent)

        def commit(ui, h):
            ui.send_message(UiMessage(
                destination=row,
                data={"type": "path_changed",
                      "path": ui.nodes.borrow(h).text},
                direction="from_widget"))

        tb = self.add(Widget(kind="textbox", text=path, width=160.0,
                             on_commit=commit), row)
        popup = self.add(Widget(kind="popup"))
        fb = self.add(Widget(kind="filebrowser", path=browse_dir), popup)

        def on_browse(ui, _h):
            ui.browse(fb, ui.nodes.borrow(fb).path or browse_dir)
            r = ui.nodes.borrow(row).actual_rect
            ui.open_popup(popup, r.x, r.y + r.h)

        self.add(Widget(kind="button", text="...", on_click=on_browse),
                 row)

        editor = row

        def pump_file_selected(ui, msg):
            if (msg.destination == fb
                    and msg.data.get("type") == "file_selected"):
                ui.nodes.borrow(tb).text = msg.data["path"]
                ui.nodes.borrow(popup).open = False
                ui.send_message(UiMessage(
                    destination=editor,
                    data={"type": "path_changed",
                          "path": msg.data["path"]},
                    direction="from_widget"))

        self._routes.append(pump_file_selected)
        return row

    def attach_dropdown_menu(self, button: Handle, items) -> Handle:
        """Dropdown menu helper (fyrox-ui dropdown_menu.rs): clicking
        the button opens a popup menu below it; picking an item emits
        `menu_selected` on the BUTTON."""
        popup = self.add(Widget(kind="popup"))
        for it in items:
            def pick(ui, _h, _it=it):
                ui.send_message(UiMessage(
                    destination=button,
                    data={"type": "menu_selected", "item": _it},
                    direction="from_widget"))
                ui.close_popups()
            self.add(Widget(kind="menu_item", text=it, on_click=pick),
                     popup)
        prev = self.nodes.borrow(button).on_click

        def open_menu(ui, h):
            if prev is not None:
                prev(ui, h)
            r = ui.nodes.borrow(h).actual_rect
            ui.open_popup(popup, r.x, r.y + r.h)

        self.nodes.borrow(button).on_click = open_menu
        return popup

    def log_push(self, handle: Handle, severity: int, message: str):
        """Append to a log panel (log.rs Log::writeln): ring-buffered at
        log_capacity, auto-scrolled to the tail."""
        w = self.nodes.borrow(handle)
        w.log_entries.append((int(severity), str(message)))
        if len(w.log_entries) > w.log_capacity:
            del w.log_entries[:len(w.log_entries) - w.log_capacity]

    def animate(self, handle: Handle, attr: str, to, duration: float,
                easing: str = "linear"):
        """Animate a numeric (or tuple) widget property over `duration`
        seconds (fyrox-ui animation.rs): advanced by update(dt); emits
        `anim_done` on completion. Easings: linear, smooth (smoothstep),
        ease_in, ease_out."""
        w = self.nodes.borrow(handle)
        self._anims.append(dict(h=handle, attr=attr,
                                frm=getattr(w, attr), to=to, t=0.0,
                                dur=max(float(duration), 1e-6),
                                easing=easing))

    def show_message_box(self, title: str, text: str, buttons=("OK",),
                         x: float = None, y: float = None) -> Handle:
        """Modal message box (messagebox.rs): a floating window with text
        and buttons. Clicking a button emits a `message_box_result`
        message (destination = the box) with the button's label and
        removes the box."""
        sw, sh = self.screen_size
        win = self.add(Widget(kind="window", title=title,
                              background=(0.16, 0.16, 0.2, 1.0)))
        stack = self.add(Widget(kind="stack", orientation="vertical"), win)
        self.add(Widget(kind="text", text=text,
                        margin=(8, 8, 8, 4)), stack)
        row = self.add(Widget(kind="stack", orientation="horizontal",
                              margin=(8, 4, 8, 8)), stack)

        def make_cb(label):
            def cb(ui, _h):
                ui.send_message(UiMessage(
                    destination=win,
                    data={"type": "message_box_result", "button": label},
                    direction="from_widget"))
                ui.remove(win)
            return cb

        for label in buttons:
            self.add(Widget(kind="button", text=label, margin=(4, 0, 4, 0),
                            on_click=make_cb(label)), row)
        self.update_layout()
        w = self.nodes.borrow(win)
        bw, bh = w.desired_size
        w.float_pos = (x if x is not None else (sw - bw) * 0.5,
                       y if y is not None else (sh - bh) * 0.4)
        self.update_layout()
        return win

    def open_popup(self, handle: Handle, x: float, y: float):
        """Show a popup widget at screen position (popup.rs Placement)."""
        w = self.nodes.borrow(handle)
        w.popup_pos = (float(x), float(y))
        w.open = True
        self.update_layout()

    def browse(self, handle: Handle, path: str):
        """Point a filebrowser widget at a directory (file_browsers/
        FileBrowser::set_path): refreshes its managed listing ('..' +
        dirs + files, sorted, dirs first with a trailing '/')."""
        import os as _os
        w = self.nodes.borrow(handle)
        w.path = _os.path.abspath(path)
        lst = self._browser_list(handle)
        lw = self.nodes.borrow(lst)
        try:
            entries = sorted(_os.listdir(w.path))
        except OSError:
            entries = []
        dirs = [e + "/" for e in entries
                if _os.path.isdir(_os.path.join(w.path, e))]
        files = [e for e in entries
                 if not _os.path.isdir(_os.path.join(w.path, e))]
        lw.items = [".."] + dirs + files
        lw.selected = -1
        self.update_layout()

    def _browser_list(self, handle: Handle) -> Handle:
        w = self.nodes.borrow(handle)
        for c in w.children:
            if self.nodes.borrow(c).kind == "list":
                return c
        return self.add(Widget(kind="list", background=w.background,
                               foreground=w.foreground,
                               font_size=w.font_size), parent=handle)

    def _dropdown_list(self, handle: Handle) -> Handle:
        """The dropdown's auto-managed child list (dropdown_list.rs keeps
        an internal ListView)."""
        w = self.nodes.borrow(handle)
        for c in w.children:
            if self.nodes.borrow(c).kind == "list":
                return c
        return self.add(Widget(kind="list", items=list(w.items),
                               background=w.background,
                               foreground=w.foreground,
                               font_size=w.font_size), parent=handle)

    def _key_event(self, event: Dict):
        """Keyboard input: Tab focus traversal (navigation.rs), then the
        focused TextBox (text_box.rs on_key_down/char), then hotkeys
        (key.rs HotKey) for anything not consumed."""
        key = event.get("key", "Char")
        if key == "Tab":
            self.focus_next(backward=bool(event.get("shift")))
            return
        w = (self.nodes.try_borrow(self.focus)
             if self.focus is not None else None)
        if (w is None or w.kind not in ("textbox", "searchbar")
                or event.get("ctrl")):
            hk = (key, bool(event.get("ctrl")), bool(event.get("shift")),
                  bool(event.get("alt")))
            cb = self.hotkeys.get(hk)
            if cb is not None:
                cb(self)
                self.send_message(UiMessage(
                    destination=self.focus or self.root,
                    data={"type": "hotkey", "key": key},
                    direction="from_widget"))
            return
        from fyrox_tpu_torch.ui.text import apply_key
        char = event.get("char", "")
        if key != "Char" and not char and len(key) == 1:
            # bare single-character key == typing that character
            key, char = "Char", key
        text, caret, anchor, events = apply_key(
            w.text, w.caret, w.sel_anchor, key, char=char,
            shift=bool(event.get("shift")))
        w.text, w.caret, w.sel_anchor = text, caret, anchor
        for ev in events:
            self.send_message(UiMessage(
                destination=self.focus,
                data={"type": f"text_{ev}", "text": w.text},
                direction="from_widget"))
            if ev == "committed" and w.on_commit is not None:
                w.on_commit(self, self.focus)
            if ev == "changed" and w.kind == "searchbar":
                # searchbar.rs SearchBarMessage::Text — the filter query
                self.send_message(UiMessage(
                    destination=self.focus,
                    data={"type": "search_text_changed", "text": w.text},
                    direction="from_widget"))

    def _hit_test(self, h: Handle, x, y) -> Optional[Handle]:
        w = self.nodes.borrow(h)
        if not w.visible:
            return None
        best = None
        if w.actual_rect.contains(x, y):
            best = h
        for c in w.children:
            deeper = self._hit_test(c, x, y)
            if deeper is not None:
                best = deeper
        return best

    # -- layout: measure / arrange (lib.rs:1830, :1745) ----------------------
    def update_layout(self):
        sw, sh = self.screen_size
        self.measure(self.root, (sw, sh))
        self.arrange(self.root, Rect(0, 0, sw, sh))

    def measure(self, h: Handle, available):
        w = self.nodes.borrow(h)
        if not w.visible:
            w.desired_size = (0.0, 0.0)
            return w.desired_size
        ml, mt, mr, mb = w.margin
        avail = (max(available[0] - ml - mr, 0.0),
                 max(available[1] - mt - mb, 0.0))
        fixed_w = w.width if np.isfinite(w.width) else None
        fixed_h = w.height if np.isfinite(w.height) else None
        inner = (fixed_w if fixed_w is not None else avail[0],
                 fixed_h if fixed_h is not None else avail[1])

        if w.kind in ("stack", "vec"):
            main = 0.0
            cross = 0.0
            for c in w.children:
                cs = self.measure(c, inner)
                if w.orientation == "vertical":
                    main += cs[1]
                    cross = max(cross, cs[0])
                else:
                    main += cs[0]
                    cross = max(cross, cs[1])
            content = ((cross, main) if w.orientation == "vertical"
                       else (main, cross))
        elif w.kind == "grid":
            content = self._measure_grid(w, inner)
        elif w.kind == "scroll":
            # children measure against infinity on the scrolling axis
            for c in w.children:
                self.measure(c, (inner[0], INF))
            content = inner
        elif w.kind == "window":
            body = (0.0, 0.0)
            for c in w.children:
                cs = self.measure(c, (inner[0], max(inner[1] - w.title_height, 0)))
                body = (max(body[0], cs[0]), max(body[1], cs[1]))
            content = (max(body[0], len(w.title) * w.font_size * 0.55 + 12),
                       body[1] + w.title_height)
        elif w.kind == "tree":
            hh = w.font_size * 1.4
            ww = len(w.text) * w.font_size * 0.55 + w.indent
            if w.expanded:
                for c in w.children:
                    cs = self.measure(c, inner)
                    ww = max(ww, cs[0] + w.indent)
                    hh += cs[1]
            else:
                for c in w.children:
                    self.measure(c, (0.0, 0.0))
            content = (ww, hh)
        elif w.kind == "check":
            box = w.font_size
            content = (box + 6 + len(w.text) * w.font_size * 0.55,
                       max(box, w.font_size * 1.3))
        elif w.kind == "menu":
            # horizontal bar of menu_item children (menu.rs)
            total = 0.0
            for c in w.children:
                cs = self.measure(c, inner)
                total += cs[0]
            content = (total, w.font_size * 1.6)
        elif w.kind == "menu_item":
            # own label only; the submenu overlays (popup), so children
            # never contribute to the bar layout
            for c in w.children:
                self.measure(c, inner)
            content = (len(w.text) * w.font_size * 0.55 + 16,
                       w.font_size * 1.6)
        elif w.kind == "popup":
            # free-floating overlay at popup_pos (popup.rs); contents
            # stacked vertically
            ww = hh = 0.0
            for c in w.children:
                cs = self.measure(c, inner)
                ww = max(ww, cs[0])
                hh += cs[1]
            content = (ww + 8, hh + 8) if w.open else (0.0, 0.0)
        elif w.kind == "list":
            row_h = w.font_size * 1.4
            ww = max((len(s) * w.font_size * 0.55 + 12 for s in w.items),
                     default=40.0)
            content = (ww, row_h * max(len(w.items), 1))
        elif w.kind == "dropdown":
            ww = max((len(s) * w.font_size * 0.55 + 28 for s in w.items),
                     default=60.0)
            for c in w.children:
                self.measure(c, inner)
            content = (ww, w.font_size * 1.5)     # closed height only
        elif w.kind == "progress":
            content = (max(inner[0], 40.0) if not np.isfinite(w.width)
                       else w.width, w.font_size * 0.9)
        elif w.kind == "slider":
            content = (max(inner[0], 60.0) if not np.isfinite(w.width)
                       else w.width, w.font_size * 1.2)
        elif w.kind == "ninepatch":
            # fixed border margins, stretching center (nine_patch.rs)
            body = (0.0, 0.0)
            pb2 = 2 * w.patch_border
            for c in w.children:
                cs = self.measure(c, (max(inner[0] - pb2, 0.0),
                                      max(inner[1] - pb2, 0.0)))
                body = (max(body[0], cs[0]), max(body[1], cs[1]))
            content = (body[0] + pb2, body[1] + pb2)
        elif w.kind == "tabs":
            # header strip + active page (tab_control.rs)
            head_h = w.font_size * 1.6
            body = (0.0, 0.0)
            for c in w.children:
                cs = self.measure(c, (inner[0],
                                      max(inner[1] - head_h, 0.0)))
                body = (max(body[0], cs[0]), max(body[1], cs[1]))
            head_w = sum(len(t) * w.font_size * 0.55 + 16
                         for t in w.tab_headers)
            content = (max(body[0], head_w), body[1] + head_h)
        elif w.kind == "expander":
            head_h = w.font_size * 1.4
            ww = len(w.text) * w.font_size * 0.55 + 16
            hh = head_h
            for c in w.children:
                cs = self.measure(c, inner)
                if w.expanded:
                    ww = max(ww, cs[0])
                    hh += cs[1]
            content = (ww, hh)
        elif w.kind == "colorpicker":
            content = (max(inner[0], 120.0) if not np.isfinite(w.width)
                       else w.width, 30.0 + w.font_size)
        elif w.kind == "numeric":
            content = (max(len(f"{w.value:g}") * w.font_size * 0.55 + 26,
                           60.0), w.font_size * 1.4)
        elif w.kind == "filebrowser":
            for c in w.children:
                self.measure(c, inner)
            content = (max(inner[0], 160.0) if not np.isfinite(w.width)
                       else w.width, inner[1])
        elif w.kind == "tile":
            # dock tile (dock/mod.rs): splits measure children at the
            # ratio-divided size; content tiles fill with their children
            if w.split in ("horizontal", "vertical") and len(w.children) == 2:
                if w.split == "horizontal":
                    self.measure(w.children[0], (inner[0] * w.ratio, inner[1]))
                    self.measure(w.children[1],
                                 (inner[0] * (1 - w.ratio), inner[1]))
                else:
                    self.measure(w.children[0], (inner[0], inner[1] * w.ratio))
                    self.measure(w.children[1],
                                 (inner[0], inner[1] * (1 - w.ratio)))
            else:
                for c in w.children:
                    self.measure(c, inner)
            content = inner
        elif w.kind == "wrap":
            # wrap panel (wrap_panel.rs): flow children along the
            # orientation axis, wrapping into new lines at the constraint
            content = self._measure_wrap(w, inner)
        elif w.kind == "screen":
            # screen.rs: always the full screen, children fit inside
            for c in w.children:
                self.measure(c, self.screen_size)
            content = self.screen_size
        elif w.kind == "image":
            if w.texture is not None and hasattr(w.texture, "shape"):
                th_, tw_ = w.texture.shape[0], w.texture.shape[1]
            else:
                th_ = tw_ = 32.0
            content = (float(tw_), float(th_))
        elif w.kind == "vector_image":
            xs = [0.0]
            ys = [0.0]
            for prim in w.primitives:
                if prim[0] == "line":
                    xs += [prim[1], prim[3]]
                    ys += [prim[2], prim[4]]
                elif prim[0] == "rect":
                    xs += [prim[1], prim[1] + prim[3]]
                    ys += [prim[2], prim[2] + prim[4]]
            content = (max(xs), max(ys))
        elif w.kind == "range":
            content = (max(inner[0], 80.0) if not np.isfinite(w.width)
                       else w.width, w.font_size * 1.2)
        elif w.kind == "toggle":
            content = (len(w.text) * w.font_size * 0.55 + 16,
                       w.font_size * 1.3 + 6)
        elif w.kind == "scrollbar":
            if w.orientation == "vertical":
                content = (14.0, max(inner[1], 40.0))
            else:
                content = (max(inner[0], 40.0), 14.0)
        elif w.kind == "searchbar":
            content = (max(inner[0], 120.0) if not np.isfinite(w.width)
                       else w.width, w.font_size * 1.4 + 4)
        elif w.kind == "bbcode":
            from fyrox_tpu_torch.ui.text import parse_bbcode
            plain, _runs = parse_bbcode(w.text)
            lines = plain.split("\n") or [""]
            ww = max((len(l) for l in lines), default=0) \
                * w.font_size * 0.55
            content = (ww, len(lines) * w.font_size * 1.3)
        elif w.kind == "log":
            rows = [e for e in w.log_entries if e[0] >= w.log_filter]
            ww = max((len(m) for _s, m in rows), default=20) \
                * w.font_size * 0.55
            content = (max(inner[0] if not np.isfinite(w.width) else 0.0,
                           ww),
                       max(len(rows), 1) * w.font_size * 1.3)
        elif w.kind == "selector":
            # selector.rs: "< item >" cycler — widest item + arrow zones
            iw = max((len(s) * w.font_size * 0.55 for s in w.items),
                     default=40.0)
            content = (iw + 2 * _SEL_ARROW_PX, w.font_size * 1.5)
        elif w.kind == "thumb":
            # thumb.rs: a draggable grip; fixed default size
            content = (16.0, 16.0)
        elif w.kind == "text":
            content = (len(w.text) * w.font_size * 0.55 if w.text else 0.0,
                       w.font_size * 1.3)
        elif w.kind == "textbox":
            from fyrox_tpu_torch.ui.text import FormattedText
            ft = FormattedText(w.text, w.font_size, wrap=w.wrap,
                               constraint=(inner[0] - 6, math.inf)
                               if w.wrap != "none" else (math.inf, math.inf))
            tw, th = ft.size
            content = (max(tw + 6, w.font_size * 3),
                       max(th + 4, w.font_size * 1.3 + 4))
        else:  # border/button/canvas: fit children
            content = (0.0, 0.0)
            for c in w.children:
                cs = self.measure(c, inner)
                content = (max(content[0], cs[0]), max(content[1], cs[1]))
            if w.kind == "button" and w.text:
                content = (max(content[0], len(w.text) * w.font_size * 0.55 + 12),
                           max(content[1], w.font_size * 1.3 + 8))

        dw = fixed_w if fixed_w is not None else content[0]
        dh = fixed_h if fixed_h is not None else content[1]
        dw = min(max(dw, w.min_size[0]), w.max_size[0])
        dh = min(max(dh, w.min_size[1]), w.max_size[1])
        w.desired_size = (dw + ml + mr, dh + mt + mb)
        return w.desired_size

    def arrange(self, h: Handle, final: Rect):
        w = self.nodes.borrow(h)
        if not w.visible:
            w.actual_rect = Rect(final.x, final.y, 0, 0)
            return
        ml, mt, mr, mb = w.margin
        if w.float_pos is not None:
            # free-floating widget (window.rs desired_position): anchor at
            # its own position with its desired size, ignoring the slot
            final = Rect(w.float_pos[0], w.float_pos[1],
                         w.desired_size[0], w.desired_size[1])
        rect = Rect(final.x + ml, final.y + mt,
                    max(final.w - ml - mr, 0.0), max(final.h - mt - mb, 0.0))
        if np.isfinite(w.width):
            rect.w = min(rect.w, w.width)
        if np.isfinite(w.height):
            rect.h = min(rect.h, w.height)
        w.actual_rect = rect

        if w.kind in ("stack", "vec"):
            offset = 0.0
            for c in w.children:
                cw = self.nodes.borrow(c)
                if w.orientation == "vertical":
                    self.arrange(c, Rect(rect.x, rect.y + offset, rect.w,
                                         cw.desired_size[1]))
                    offset += cw.desired_size[1]
                else:
                    self.arrange(c, Rect(rect.x + offset, rect.y,
                                         cw.desired_size[0], rect.h))
                    offset += cw.desired_size[0]
        elif w.kind == "grid":
            self._arrange_grid(w, rect)
        elif w.kind == "scroll":
            sx, sy = w.scroll
            for c in w.children:
                cw = self.nodes.borrow(c)
                self.arrange(c, Rect(rect.x - sx, rect.y - sy,
                                     max(rect.w, cw.desired_size[0]),
                                     cw.desired_size[1]))
        elif w.kind == "window":
            body = Rect(rect.x, rect.y + w.title_height, rect.w,
                        max(rect.h - w.title_height, 0.0))
            for c in w.children:
                self.arrange(c, body)
        elif w.kind == "tree":
            hh = w.font_size * 1.4
            offset = hh
            for c in w.children:
                cw = self.nodes.borrow(c)
                if w.expanded:
                    self.arrange(c, Rect(rect.x + w.indent, rect.y + offset,
                                         max(rect.w - w.indent, 0.0),
                                         cw.desired_size[1]))
                    offset += cw.desired_size[1]
                else:
                    self.arrange(c, Rect(rect.x, rect.y, 0.0, 0.0))
        elif w.kind == "menu":
            offset = 0.0
            for c in w.children:
                cw = self.nodes.borrow(c)
                self.arrange(c, Rect(rect.x + offset, rect.y,
                                     cw.desired_size[0], rect.h))
                offset += cw.desired_size[0]
        elif w.kind == "menu_item":
            # open submenu becomes a vertical popup below this item
            if w.open:
                ww = max((self.nodes.borrow(c).desired_size[0]
                          for c in w.children), default=0.0)
                oy = rect.y + rect.h
                for c in w.children:
                    cw = self.nodes.borrow(c)
                    self.arrange(c, Rect(rect.x, oy, ww,
                                         cw.desired_size[1]))
                    oy += cw.desired_size[1]
            else:
                for c in w.children:
                    self.arrange(c, Rect(rect.x, rect.y, 0.0, 0.0))
        elif w.kind == "popup":
            if w.open:
                px, py = w.popup_pos
                w.actual_rect = Rect(px, py, w.desired_size[0],
                                     w.desired_size[1])
                oy = py + 4
                for c in w.children:
                    cw = self.nodes.borrow(c)
                    self.arrange(c, Rect(px + 4, oy,
                                         w.desired_size[0] - 8,
                                         cw.desired_size[1]))
                    oy += cw.desired_size[1]
            else:
                w.actual_rect = Rect(rect.x, rect.y, 0.0, 0.0)
                for c in w.children:
                    self.arrange(c, Rect(rect.x, rect.y, 0.0, 0.0))
        elif w.kind == "dropdown":
            # the open row list overlays below the closed box
            oy = rect.y + rect.h
            for c in w.children:
                cw = self.nodes.borrow(c)
                if w.open:
                    self.arrange(c, Rect(rect.x, oy, rect.w,
                                         cw.desired_size[1]))
                    oy += cw.desired_size[1]
                else:
                    self.arrange(c, Rect(rect.x, rect.y, 0.0, 0.0))
        elif w.kind == "ninepatch":
            pb = w.patch_border
            inner_r = Rect(rect.x + pb, rect.y + pb,
                           max(rect.w - 2 * pb, 0.0),
                           max(rect.h - 2 * pb, 0.0))
            for c in w.children:
                self.arrange(c, inner_r)
        elif w.kind == "tabs":
            head_h = w.font_size * 1.6
            body = Rect(rect.x, rect.y + head_h, rect.w,
                        max(rect.h - head_h, 0.0))
            for i, c in enumerate(w.children):
                self.arrange(c, body if i == w.active_tab
                             else Rect(rect.x, rect.y, 0.0, 0.0))
        elif w.kind == "expander":
            head_h = w.font_size * 1.4
            oy = rect.y + head_h
            for c in w.children:
                cw = self.nodes.borrow(c)
                if w.expanded:
                    self.arrange(c, Rect(rect.x + 8, oy, rect.w - 8,
                                         cw.desired_size[1]))
                    oy += cw.desired_size[1]
                else:
                    self.arrange(c, Rect(rect.x, rect.y, 0.0, 0.0))
        elif w.kind == "filebrowser":
            for c in w.children:
                self.arrange(c, Rect(rect.x, rect.y + w.font_size * 1.5,
                                     rect.w,
                                     max(rect.h - w.font_size * 1.5, 0.0)))
        elif w.kind == "wrap":
            self._arrange_wrap(w, rect)
        elif w.kind == "screen":
            sw, sh = self.screen_size
            w.actual_rect = Rect(0.0, 0.0, sw, sh)
            for c in w.children:
                self.arrange(c, w.actual_rect)
        elif (w.kind == "tile" and w.split in ("horizontal", "vertical")
              and len(w.children) == 2):
            sp = w.splitter_px * 0.5
            if w.split == "horizontal":
                lw = rect.w * w.ratio
                self.arrange(w.children[0],
                             Rect(rect.x, rect.y, max(lw - sp, 0), rect.h))
                self.arrange(w.children[1],
                             Rect(rect.x + lw + sp, rect.y,
                                  max(rect.w - lw - sp, 0), rect.h))
            else:
                th = rect.h * w.ratio
                self.arrange(w.children[0],
                             Rect(rect.x, rect.y, rect.w, max(th - sp, 0)))
                self.arrange(w.children[1],
                             Rect(rect.x, rect.y + th + sp, rect.w,
                                  max(rect.h - th - sp, 0)))
        else:
            for c in w.children:
                self.arrange(c, rect)

    # -- wrap panel helpers (wrap_panel.rs) -----------------------------------
    def _wrap_lines(self, w, limit):
        """Group children into flow lines under the main-axis limit."""
        lines, cur, used = [], [], 0.0
        main = 0 if w.orientation == "horizontal" else 1
        for c in w.children:
            cs = self.nodes.borrow(c).desired_size
            if cur and used + cs[main] > limit:
                lines.append(cur)
                cur, used = [], 0.0
            cur.append(c)
            used += cs[main]
        if cur:
            lines.append(cur)
        return lines

    def _measure_wrap(self, w, inner):
        for c in w.children:
            self.measure(c, inner)
        main = 0 if w.orientation == "horizontal" else 1
        cross = 1 - main
        limit = inner[main]
        total_cross = 0.0
        widest = 0.0
        for line in self._wrap_lines(w, limit):
            sizes = [self.nodes.borrow(c).desired_size for c in line]
            widest = max(widest, sum(s[main] for s in sizes))
            total_cross += max((s[cross] for s in sizes), default=0.0)
        return ((widest, total_cross) if main == 0
                else (total_cross, widest))

    def _arrange_wrap(self, w, rect):
        main = 0 if w.orientation == "horizontal" else 1
        cross = 1 - main
        limit = rect.w if main == 0 else rect.h
        off_cross = 0.0
        for line in self._wrap_lines(w, limit):
            sizes = [self.nodes.borrow(c).desired_size for c in line]
            line_cross = max((s[cross] for s in sizes), default=0.0)
            off_main = 0.0
            for c, cs in zip(line, sizes):
                if main == 0:
                    self.arrange(c, Rect(rect.x + off_main,
                                         rect.y + off_cross,
                                         cs[0], line_cross))
                else:
                    self.arrange(c, Rect(rect.x + off_cross,
                                         rect.y + off_main,
                                         line_cross, cs[1]))
                off_main += cs[main]
            off_cross += line_cross

    # -- grid helpers (grid.rs measure/arrange) ------------------------------
    def _grid_defs(self, defs, n_needed):
        return list(defs) if defs else [("stretch",)] * max(n_needed, 1)

    def _measure_grid(self, w, inner):
        rows = self._grid_defs(w.rows, 1 + max((self.nodes.borrow(c).grid_row
                                                for c in w.children), default=0))
        cols = self._grid_defs(w.columns, 1 + max((self.nodes.borrow(c).grid_column
                                                   for c in w.children), default=0))
        rh = [d[1] if d[0] == "strict" else 0.0 for d in rows]
        cw_ = [d[1] if d[0] == "strict" else 0.0 for d in cols]
        for c in w.children:
            cc = self.nodes.borrow(c)
            cs = self.measure(c, inner)
            r = min(cc.grid_row, len(rows) - 1)
            k = min(cc.grid_column, len(cols) - 1)
            if rows[r][0] == "auto":
                rh[r] = max(rh[r], cs[1])
            if cols[k][0] == "auto":
                cw_[k] = max(cw_[k], cs[0])
        w._grid_row_sizes = rh
        w._grid_col_sizes = cw_
        return (sum(cw_), sum(rh))

    def _arrange_grid(self, w, rect):
        rows = self._grid_defs(w.rows, 1 + max((self.nodes.borrow(c).grid_row
                                                for c in w.children), default=0))
        cols = self._grid_defs(w.columns, 1 + max((self.nodes.borrow(c).grid_column
                                                   for c in w.children), default=0))
        rh = list(getattr(w, "_grid_row_sizes", [0.0] * len(rows)))
        cw_ = list(getattr(w, "_grid_col_sizes", [0.0] * len(cols)))
        # stretch rows/cols share the leftover space equally (grid.rs)
        def resolve(defs, sizes, total):
            fixed = sum(s for d, s in zip(defs, sizes) if d[0] != "stretch")
            n_st = sum(1 for d in defs if d[0] == "stretch")
            share = max(total - fixed, 0.0) / n_st if n_st else 0.0
            return [share if d[0] == "stretch" else s
                    for d, s in zip(defs, sizes)]
        rh = resolve(rows, rh, rect.h)
        cw_ = resolve(cols, cw_, rect.w)
        ry = [rect.y + sum(rh[:i]) for i in range(len(rh))]
        cx = [rect.x + sum(cw_[:i]) for i in range(len(cw_))]
        for c in w.children:
            cc = self.nodes.borrow(c)
            r = min(cc.grid_row, len(rh) - 1)
            k = min(cc.grid_column, len(cw_) - 1)
            self.arrange(c, Rect(cx[k], ry[r], cw_[k], rh[r]))

    # -- draw command emission (draw.rs) --------------------------------------
    def draw(self) -> List[DrawCommand]:
        cmds: List[DrawCommand] = []
        self._draw_node(self.root, cmds)
        return cmds

    def _draw_node(self, h: Handle, cmds: List[DrawCommand]):
        w = self.nodes.borrow(h)
        if not w.visible:
            return
        if w.kind in ("border", "button", "stack", "grid", "scroll", "window"):
            cmds.append(DrawCommand("rect", w.actual_rect, w.background))
            if w.kind in ("border", "button", "window"):
                cmds.append(DrawCommand("border", w.actual_rect, w.foreground))
        if w.kind == "window" and w.title:
            bar = Rect(w.actual_rect.x, w.actual_rect.y, w.actual_rect.w,
                       w.title_height)
            cmds.append(DrawCommand("rect", bar, (0.15, 0.15, 0.25, 1.0)))
            cmds.append(DrawCommand("text", bar, w.foreground, text=w.title))
        if w.kind == "tree":
            head = Rect(w.actual_rect.x, w.actual_rect.y, w.actual_rect.w,
                        w.font_size * 1.4)
            marker = "-" if w.expanded else "+"
            cmds.append(DrawCommand("text", head, w.foreground,
                                    text=f"{marker} {w.text}"))
        if w.kind == "check":
            box = Rect(w.actual_rect.x, w.actual_rect.y, w.font_size,
                       w.font_size)
            cmds.append(DrawCommand("border", box, w.foreground))
            if w.checked:
                inner = Rect(box.x + 3, box.y + 3, box.w - 6, box.h - 6)
                cmds.append(DrawCommand("rect", inner, w.foreground))
            if w.text:
                lbl = Rect(box.x + w.font_size + 6, w.actual_rect.y,
                           w.actual_rect.w, w.actual_rect.h)
                cmds.append(DrawCommand("text", lbl, w.foreground, text=w.text))
        if w.kind in ("text", "button") and w.text:
            cmds.append(DrawCommand("text", w.actual_rect, w.foreground,
                                    text=w.text))
        if w.kind == "numeric":
            r = w.actual_rect
            cmds.append(DrawCommand("rect", r, w.background))
            cmds.append(DrawCommand("border", r, w.foreground))
            body = Rect(r.x, r.y, max(r.w - 14, 0), r.h)
            cmds.append(DrawCommand("text", body, w.foreground,
                                    text=f"{w.value:g}"))
            # up/down spinners on the right (numeric.rs)
            cmds.append(DrawCommand("text",
                                    Rect(r.x + r.w - 12, r.y, 12, r.h / 2),
                                    w.foreground, text="+"))
            cmds.append(DrawCommand("text",
                                    Rect(r.x + r.w - 12, r.y + r.h / 2, 12,
                                         r.h / 2),
                                    w.foreground, text="-"))
        if w.kind == "textbox":
            from fyrox_tpu_torch.ui.text import FormattedText, _sel_range
            cmds.append(DrawCommand("rect", w.actual_rect,
                                    (0.12, 0.12, 0.12, 1.0)))
            cmds.append(DrawCommand("border", w.actual_rect, w.foreground))
            ft = FormattedText(w.text, w.font_size, wrap=w.wrap,
                               constraint=(w.actual_rect.w - 6, math.inf)
                               if w.wrap != "none" else (math.inf, math.inf))
            ox, oy = w.actual_rect.x + 3, w.actual_rect.y + 2
            sel = _sel_range(w.caret, w.sel_anchor)
            for i, ln in enumerate(ft.lines):
                if sel is not None:           # per-line selection band
                    a = max(sel[0], ln.start)
                    b = min(sel[1], ln.end)
                    if a < b:
                        cmds.append(DrawCommand(
                            "rect",
                            Rect(ox + ln.x + (a - ln.start) * ft.char_w,
                                 oy + ln.y, (b - a) * ft.char_w, ft.line_h),
                            (0.2, 0.35, 0.6, 1.0)))
                if ln.end > ln.start:
                    cmds.append(DrawCommand(
                        "text", Rect(ox + ln.x, oy + ln.y, ln.width,
                                     ft.line_h),
                        w.foreground, text=ft.line_text(i)))
            if self.focus is not None and self.nodes.try_borrow(
                    self.focus) is w:
                cx, cy = ft.caret_to_xy(w.caret)
                cmds.append(DrawCommand(
                    "rect", Rect(ox + cx, oy + cy, 1.0, ft.line_h),
                    w.foreground))
        if w.kind == "curve_editor":
            from fyrox_tpu_torch.ui import curve_editor as ce
            cmds.extend(ce.draw_commands(w))
        if w.kind == "menu":
            cmds.append(DrawCommand("rect", w.actual_rect, w.background))
        if w.kind == "menu_item":
            cmds.append(DrawCommand("text", w.actual_rect, w.foreground,
                                    text=w.text))
            if w.open and w.children:
                # popup backdrop behind the open submenu
                ys = [self.nodes.borrow(c).actual_rect for c in w.children]
                x0 = min(r.x for r in ys)
                y0 = min(r.y for r in ys)
                x1 = max(r.x + r.w for r in ys)
                y1 = max(r.y + r.h for r in ys)
                cmds.append(DrawCommand("rect", Rect(x0 - 2, y0 - 2,
                                                     x1 - x0 + 4,
                                                     y1 - y0 + 4),
                                        w.background))
        if w.kind == "popup":
            if not w.open:
                return
            cmds.append(DrawCommand("rect", w.actual_rect, w.background))
            cmds.append(DrawCommand("border", w.actual_rect, w.foreground))
        if w.kind == "list":
            cmds.append(DrawCommand("rect", w.actual_rect, w.background))
            row_h = w.font_size * 1.4
            for i, item in enumerate(w.items):
                r = Rect(w.actual_rect.x, w.actual_rect.y + i * row_h,
                         w.actual_rect.w, row_h)
                if r.y >= w.actual_rect.y + w.actual_rect.h:
                    break
                if i == w.selected:
                    cmds.append(DrawCommand("rect", r,
                                            (0.2, 0.35, 0.6, 1.0)))
                cmds.append(DrawCommand("text", r, w.foreground, text=item))
        if w.kind == "dropdown":
            cmds.append(DrawCommand("rect", w.actual_rect, w.background))
            cmds.append(DrawCommand("border", w.actual_rect, w.foreground))
            label = (w.items[w.selected]
                     if 0 <= w.selected < len(w.items) else "")
            cmds.append(DrawCommand("text", w.actual_rect, w.foreground,
                                    text=f"{label} v"))
        if w.kind == "progress":
            cmds.append(DrawCommand("rect", w.actual_rect,
                                    (0.1, 0.1, 0.1, 1.0)))
            p = min(max(float(w.progress), 0.0), 1.0)
            fill = Rect(w.actual_rect.x, w.actual_rect.y,
                        w.actual_rect.w * p, w.actual_rect.h)
            cmds.append(DrawCommand("rect", fill, w.foreground))
            cmds.append(DrawCommand("border", w.actual_rect, w.foreground))
        if w.kind == "slider":
            track = Rect(w.actual_rect.x,
                         w.actual_rect.y + w.actual_rect.h * 0.4,
                         w.actual_rect.w, w.actual_rect.h * 0.2)
            cmds.append(DrawCommand("rect", track, (0.15, 0.15, 0.15, 1.0)))
            span = max(w.max_value - w.min_value, 1e-9)
            t = min(max((w.value - w.min_value) / span, 0.0), 1.0)
            hx = w.actual_rect.x + t * max(w.actual_rect.w - 8, 0.0)
            cmds.append(DrawCommand("rect",
                                    Rect(hx, w.actual_rect.y, 8.0,
                                         w.actual_rect.h), w.foreground))
        if w.kind == "ninepatch":
            pb = w.patch_border
            r = w.actual_rect
            # center + fixed-margin frame ring (nine_patch.rs: corners keep
            # their size, edges stretch along one axis only)
            cmds.append(DrawCommand("rect", Rect(r.x + pb, r.y + pb,
                                                 max(r.w - 2 * pb, 0),
                                                 max(r.h - 2 * pb, 0)),
                                    w.background))
            for fr in (Rect(r.x, r.y, r.w, pb),               # top edge
                       Rect(r.x, r.y + r.h - pb, r.w, pb),    # bottom
                       Rect(r.x, r.y + pb, pb, max(r.h - 2 * pb, 0)),
                       Rect(r.x + r.w - pb, r.y + pb, pb,
                            max(r.h - 2 * pb, 0))):
                cmds.append(DrawCommand("rect", fr, w.foreground))
        if w.kind == "tabs":
            cmds.append(DrawCommand("rect", w.actual_rect, w.background))
            head_h = w.font_size * 1.6
            x = w.actual_rect.x
            for i, title in enumerate(w.tab_headers):
                tw_ = len(title) * w.font_size * 0.55 + 16
                r = Rect(x, w.actual_rect.y, tw_, head_h)
                if i == w.active_tab:
                    cmds.append(DrawCommand("rect", r,
                                            (0.25, 0.3, 0.4, 1.0)))
                cmds.append(DrawCommand("text", r, w.foreground, text=title))
                x += tw_
            # only the active page draws
            for i, c in enumerate(w.children):
                if i == w.active_tab:
                    self._draw_node(c, cmds)
            return
        if w.kind == "expander":
            head = Rect(w.actual_rect.x, w.actual_rect.y, w.actual_rect.w,
                        w.font_size * 1.4)
            marker = "-" if w.expanded else "+"
            cmds.append(DrawCommand("text", head, w.foreground,
                                    text=f"{marker} {w.text}"))
            if not w.expanded:
                return
        if w.kind == "colorpicker":
            r = w.actual_rect
            # hue strip (top): quantized hue swatches; value strip below;
            # current-color swatch on the right (color.rs picker parity
            # scoped to draw-command primitives)
            strip_w = max(r.w - 34.0, 10.0)
            n = 16
            for i in range(n):
                col = _hsv_to_rgb(i / n, 1.0, 1.0)
                cmds.append(DrawCommand("rect",
                                        Rect(r.x + i * strip_w / n, r.y,
                                             strip_w / n, 12.0),
                                        (*col, 1.0)))
            for i in range(n):
                v = i / (n - 1)
                cmds.append(DrawCommand("rect",
                                        Rect(r.x + i * strip_w / n,
                                             r.y + 14.0, strip_w / n, 12.0),
                                        (v, v, v, 1.0)))
            cmds.append(DrawCommand("rect",
                                    Rect(r.x + strip_w + 4, r.y, 30.0, 26.0),
                                    w.color_value))
            cmds.append(DrawCommand("border",
                                    Rect(r.x + strip_w + 4, r.y, 30.0, 26.0),
                                    w.foreground))
        if w.kind == "filebrowser":
            cmds.append(DrawCommand("rect", w.actual_rect, w.background))
            head = Rect(w.actual_rect.x, w.actual_rect.y, w.actual_rect.w,
                        w.font_size * 1.5)
            cmds.append(DrawCommand("text", head, w.foreground, text=w.path))
        if w.kind == "image":
            cmds.append(DrawCommand("image", w.actual_rect, w.background,
                                    texture=w.texture))
        if w.kind == "vector_image":
            r = w.actual_rect
            for prim in w.primitives:
                if prim[0] == "line":
                    cmds.append(DrawCommand(
                        "line", r, w.foreground,
                        points=[(r.x + prim[1], r.y + prim[2]),
                                (r.x + prim[3], r.y + prim[4])]))
                elif prim[0] == "rect":
                    cmds.append(DrawCommand(
                        "rect", Rect(r.x + prim[1], r.y + prim[2],
                                     prim[3], prim[4]), w.foreground))
        if w.kind == "toggle":
            on_bg = (0.2, 0.45, 0.3, 1.0) if w.checked else w.background
            cmds.append(DrawCommand("rect", w.actual_rect, on_bg))
            cmds.append(DrawCommand("border", w.actual_rect, w.foreground))
            if w.text:
                cmds.append(DrawCommand("text", w.actual_rect, w.foreground,
                                        text=w.text))
        if w.kind == "range":
            r = w.actual_rect
            track = Rect(r.x, r.y + r.h * 0.4, r.w, r.h * 0.2)
            cmds.append(DrawCommand("rect", track, (0.15, 0.15, 0.15, 1.0)))
            span = max(w.max_value - w.min_value, 1e-9)
            t0 = min(max((w.value - w.min_value) / span, 0.0), 1.0)
            t1 = min(max((w.value2 - w.min_value) / span, 0.0), 1.0)
            x0 = r.x + t0 * max(r.w - 8, 0.0)
            x1 = r.x + t1 * max(r.w - 8, 0.0)
            cmds.append(DrawCommand("rect",
                                    Rect(x0, track.y, max(x1 - x0, 0.0),
                                         track.h), (0.25, 0.4, 0.6, 1.0)))
            for hx in (x0, x1):
                cmds.append(DrawCommand("rect", Rect(hx, r.y, 8.0, r.h),
                                        w.foreground))
        if w.kind == "scrollbar":
            r = w.actual_rect
            cmds.append(DrawCommand("rect", r, (0.15, 0.15, 0.15, 1.0)))
            span = max(w.max_value - w.min_value, 1e-9)
            t = min(max((w.value - w.min_value) / span, 0.0), 1.0)
            thumb = 18.0
            if w.orientation == "vertical":
                ty = r.y + t * max(r.h - thumb, 0.0)
                cmds.append(DrawCommand("rect", Rect(r.x, ty, r.w, thumb),
                                        w.foreground))
            else:
                tx = r.x + t * max(r.w - thumb, 0.0)
                cmds.append(DrawCommand("rect", Rect(tx, r.y, thumb, r.h),
                                        w.foreground))
        if w.kind == "searchbar":
            cmds.append(DrawCommand("rect", w.actual_rect,
                                    (0.12, 0.12, 0.12, 1.0)))
            cmds.append(DrawCommand("border", w.actual_rect, w.foreground))
            body = Rect(w.actual_rect.x + 3, w.actual_rect.y,
                        max(w.actual_rect.w - 20, 0), w.actual_rect.h)
            cmds.append(DrawCommand("text", body, w.foreground,
                                    text=w.text or "search..."))
            icon = Rect(w.actual_rect.x + w.actual_rect.w - 16,
                        w.actual_rect.y, 16, w.actual_rect.h)
            cmds.append(DrawCommand("text", icon, w.foreground, text="?"))
        if w.kind == "bbcode":
            # bbcode.rs: styled runs drawn as colored text segments with
            # the UI's monospace metrics
            from fyrox_tpu_torch.ui.text import parse_bbcode
            plain, runs = parse_bbcode(w.text)
            r = w.actual_rect
            cw = w.font_size * 0.55
            lh = w.font_size * 1.3
            # char index -> (line, col)
            line = col = 0
            pos = []
            for ch in plain:
                pos.append((line, col))
                if ch == "\n":
                    line += 1
                    col = 0
                else:
                    col += 1
            for start, end, style in runs:
                i = start
                while i < end:
                    ln, cl = pos[i]
                    j = i
                    while (j < end and pos[j][0] == ln
                           and plain[j] != "\n"):
                        j += 1
                    seg = plain[i:j]
                    if seg:
                        fg = style.get("color", w.foreground)
                        fs = style.get("size", w.font_size)
                        cmds.append(DrawCommand(
                            "text",
                            Rect(r.x + cl * cw, r.y + ln * lh,
                                 max(len(seg) * cw, 1.0), lh),
                            fg, text=seg, thickness=2.0
                            if style.get("bold") else 1.0))
                    i = j + 1 if j < end and plain[j] == "\n" else j
        if w.kind == "log":
            # log.rs panel: severity-colored rows, newest at the bottom
            r = w.actual_rect
            lh = w.font_size * 1.3
            sev_color = {0: w.foreground, 1: (1.0, 0.8, 0.2, 1.0),
                         2: (1.0, 0.3, 0.3, 1.0)}
            rows = [e for e in w.log_entries if e[0] >= w.log_filter]
            max_rows = max(int(r.h // lh), 1)
            for k, (sev, msg) in enumerate(rows[-max_rows:]):
                cmds.append(DrawCommand(
                    "text", Rect(r.x, r.y + k * lh, r.w, lh),
                    sev_color.get(sev, w.foreground), text=msg))
        if w.kind == "selector":
            r = w.actual_rect
            cmds.append(DrawCommand("rect", r, w.background))
            cmds.append(DrawCommand(
                "text", Rect(r.x, r.y, _SEL_ARROW_PX, r.h), w.foreground,
                text="<"))
            item = (w.items[w.selected]
                    if w.items and 0 <= w.selected < len(w.items) else "")
            cmds.append(DrawCommand(
                "text", Rect(r.x + _SEL_ARROW_PX, r.y,
                             max(r.w - 2 * _SEL_ARROW_PX, 0.0), r.h),
                w.foreground, text=item))
            cmds.append(DrawCommand(
                "text", Rect(r.x + r.w - _SEL_ARROW_PX, r.y,
                             _SEL_ARROW_PX, r.h), w.foreground, text=">"))
        if w.kind == "thumb":
            cmds.append(DrawCommand("rect", w.actual_rect, w.background))
            cmds.append(DrawCommand("border", w.actual_rect, w.foreground))
        if w.kind == "decorator":
            # decorator.rs: brush switches on the selected/checked state
            bg = (0.25, 0.3, 0.45, 1.0) if w.checked else w.background
            cmds.append(DrawCommand("rect", w.actual_rect, bg))
        if w.kind == "tree" and not w.expanded:
            return                    # collapsed subtree draws nothing
        for c in w.children:
            self._draw_node(c, cmds)

    def update(self, dt: float = 0.0):
        """Engine post_update equivalent: advance property animations
        (animation.rs), then relayout + message pump hooks."""
        done = []
        for a in self._anims:
            a["t"] = min(a["t"] + dt, a["dur"])
            t = a["t"] / a["dur"]
            e = a["easing"]
            if e == "smooth":
                t = t * t * (3.0 - 2.0 * t)
            elif e == "ease_in":
                t = t * t
            elif e == "ease_out":
                t = 1.0 - (1.0 - t) ** 2
            w = self.nodes.try_borrow(a["h"])
            if w is None:
                done.append(a)
                continue
            frm, to = a["frm"], a["to"]
            if isinstance(to, (tuple, list)):
                val = tuple(f + (g - f) * t for f, g in zip(frm, to))
            else:
                val = frm + (to - frm) * t
            setattr(w, a["attr"], val)
            if a["t"] >= a["dur"]:
                done.append(a)
                self.send_message(UiMessage(
                    destination=a["h"],
                    data={"type": "anim_done", "attr": a["attr"]},
                    direction="from_widget"))
        for a in done:
            if a in self._anims:
                self._anims.remove(a)
        self.update_layout()
