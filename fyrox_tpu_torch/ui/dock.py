"""Docking manager.

Equivalent of fyrox-ui/src/dock/ (DockingManager + Tile): a binary tile
tree where each tile is either a content leaf holding one window or a
horizontal/vertical split of two tiles at an adjustable ratio. Windows
dock into leaves, splits can be re-ratioed by dragging the splitter, and
undocking floats the window back to the UI root. Layout for the "tile"
kind lives in ui/core.py measure/arrange."""
from __future__ import annotations

from typing import Optional

from fyrox_tpu_torch.ui.core import Handle, UserInterface, Widget

__all__ = ["DockingManager"]


class DockingManager:
    """Owns the root tile; all operations restructure the widget tree."""

    def __init__(self, ui: UserInterface, parent: Optional[Handle] = None,
                 **kw):
        self.ui = ui
        self.root = ui.add(Widget(name="dock_root", kind="tile", **kw),
                           parent)

    # -- queries ------------------------------------------------------------
    def tile_of(self, window: Handle) -> Optional[Handle]:
        """The content tile currently holding `window`."""
        w = self.ui.nodes.try_borrow(window)
        if w is None:
            return None
        p = self.ui.nodes.try_borrow(w.parent)
        if p is not None and p.kind == "tile" and p.split == "content":
            return w.parent
        return None

    def windows(self):
        out = []
        def walk(h):
            t = self.ui.nodes.borrow(h)
            if t.split == "content":
                out.extend(c for c in t.children
                           if self.ui.nodes.borrow(c).kind == "window")
            else:
                for c in t.children:
                    if self.ui.nodes.borrow(c).kind == "tile":
                        walk(c)
        walk(self.root)
        return out

    # -- operations (dock/mod.rs Tile message handlers) ---------------------
    def dock(self, window: Handle, tile: Optional[Handle] = None,
             side: Optional[str] = None, ratio: float = 0.5) -> Handle:
        """Dock a window. Without `side`: into `tile` (default root) as
        its content. With side "left"/"right"/"top"/"bottom": split the
        tile, existing content keeps the other half."""
        tile = tile if tile is not None else self.root
        t = self.ui.nodes.borrow(tile)
        assert t.kind == "tile"
        self._detach(window)
        if side is None:
            if t.split != "content" or any(
                    self.ui.nodes.borrow(c).kind == "window"
                    for c in t.children):
                # occupied → split right by default
                return self.dock(window, tile, side="right", ratio=ratio)
            self._attach(window, tile)
            return tile
        horiz = side in ("left", "right")
        first_new = side in ("left", "top")
        # move existing content into a fresh child tile
        old = Widget(kind="tile", split=t.split, ratio=t.ratio)
        old_h = self.ui.add(old, tile)
        for c in list(t.children):
            if c != old_h:
                t.children.remove(c)
                old.children.append(c)
                self.ui.nodes.borrow(c).parent = old_h
        new_h = self.ui.add(Widget(kind="tile"), tile)
        self._attach(window, new_h)
        t.split = "horizontal" if horiz else "vertical"
        t.ratio = ratio if first_new else 1.0 - ratio
        # order: first child is left/top
        t.children = [new_h, old_h] if first_new else [old_h, new_h]
        return new_h

    def undock(self, window: Handle):
        """Float the window back to the UI root and collapse the empty
        split (Tile::RemoveWindow semantics)."""
        tile = self.tile_of(window)
        self._detach(window)
        self.ui.nodes.borrow(self.ui.root).children.append(window)
        self.ui.nodes.borrow(window).parent = self.ui.root
        if tile is not None:
            self._collapse(tile)

    def set_ratio(self, tile: Handle, ratio: float):
        self.ui.nodes.borrow(tile).ratio = min(max(ratio, 0.05), 0.95)

    def split_tile(self, tile: Handle, orientation: str,
                   ratio: float = 0.5) -> tuple:
        """Split an empty content tile into two empty leaves."""
        t = self.ui.nodes.borrow(tile)
        assert t.kind == "tile" and t.split == "content"
        a = self.ui.add(Widget(kind="tile"), tile)
        b = self.ui.add(Widget(kind="tile"), tile)
        t.split = orientation
        t.ratio = ratio
        return a, b

    # -- internals ----------------------------------------------------------
    def _attach(self, window, tile):
        self.ui.nodes.borrow(tile).children.append(window)
        self.ui.nodes.borrow(window).parent = tile

    def _detach(self, window):
        w = self.ui.nodes.borrow(window)
        p = self.ui.nodes.try_borrow(w.parent)
        if p is not None and window in p.children:
            p.children.remove(window)
        w.parent = Handle.none()

    def _collapse(self, tile: Handle):
        """If a split's child tile emptied out, promote the sibling into
        the parent (keeps the tree binary and leaf-meaningful)."""
        t = self.ui.nodes.try_borrow(tile)
        if t is None or t.children:
            return
        parent_h = t.parent
        p = self.ui.nodes.try_borrow(parent_h)
        if p is None or p.kind != "tile" or p.split == "content":
            return
        sibling = next((c for c in p.children if c != tile), None)
        p.children.remove(tile)
        self.ui.nodes.free(tile)
        if sibling is None:
            p.split = "content"
            return
        s = self.ui.nodes.borrow(sibling)
        if s.kind == "tile":
            # promote sibling tile's shape into the parent
            p.split = s.split
            p.ratio = s.ratio
            p.children.remove(sibling)
            for c in list(s.children):
                p.children.append(c)
                self.ui.nodes.borrow(c).parent = parent_h
            self.ui.nodes.free(sibling)
        else:
            p.split = "content"
