"""Inspector: reflection-driven property grid.

Equivalent of fyrox-ui's Inspector widget family (fyrox-ui/src/inspector/
— the property grid the editor binds to any Reflect object). Here the
rows come from `core/reflect.enumerate_paths`: one grid row per leaf
field, name column + value column, with `refresh` re-reading values and
`set_value` writing through the functional `reflect.set_path` (the
Inspector's PropertyChanged message analog).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from fyrox_tpu_torch.core import reflect
from fyrox_tpu_torch.ui.core import UiMessage, UserInterface, Widget

__all__ = ["Inspector"]


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    if isinstance(v, np.ndarray):
        return "(" + ", ".join(f"{float(x):.3g}" for x in np.ravel(v)[:4]) + ")"
    return str(v)


def _parse(text: str, like):
    """Parse an edited value string against the current value's type (the
    Inspector's property editors reduced to text round-trips)."""
    text = text.strip()
    if isinstance(like, bool):
        return text.lower() in ("1", "true", "yes", "on")
    if isinstance(like, int) and not isinstance(like, bool):
        return int(float(text))
    if isinstance(like, float):
        return float(text)
    if isinstance(like, np.ndarray):
        vals = [float(x) for x in text.strip("()[] ").split(",") if x.strip()]
        return np.asarray(vals, like.dtype).reshape(like.shape)
    if isinstance(like, (tuple, list)):
        vals = [float(x) for x in text.strip("()[] ").split(",") if x.strip()]
        return type(like)(vals)
    return text


class Inspector:
    """Property grid bound to a target object.

    ins = Inspector(ui, target, parent)   # builds rows
    ins.refresh()                          # re-read values into the grid
    ins.set_value("inner.value", 3.0)      # functional write + message
    """

    def __init__(self, ui: UserInterface, target: Any, parent=None,
                 max_depth=3, row_height=18.0):
        self.ui = ui
        self.target = target
        self.paths: List[str] = reflect.enumerate_paths(target,
                                                        max_depth=max_depth)
        self.root = ui.add(Widget(kind="grid",
                                  columns=[("stretch",), ("stretch",)],
                                  rows=[("strict", row_height)]
                                  * max(len(self.paths), 1)), parent)
        self._value_widgets: Dict[str, Any] = {}
        for i, p in enumerate(self.paths):
            ui.add(Widget(kind="text", text=p, grid_row=i, grid_column=0),
                   self.root)
            vw = ui.add(Widget(kind="textbox",
                               text=_fmt(reflect.get_path(target, p)),
                               grid_row=i, grid_column=1,
                               on_commit=self._make_commit(p)), self.root)
            self._value_widgets[p] = vw

    def _make_commit(self, path):
        """Enter in a value TextBox → parse + functional write-through
        (the Inspector PropertyChanged round trip, now actually editable
        — text_box.rs + inspector/ semantics)."""
        def commit(ui, handle):
            w = ui.nodes.borrow(handle)
            cur = reflect.get_path(self.target, path)
            try:
                val = _parse(w.text, cur)
            except (ValueError, TypeError):
                w.text = _fmt(cur)            # reject: restore display
                return
            self.set_value(path, val)
        return commit

    def refresh(self):
        """Re-read every bound field (Inspector sync pass)."""
        for p, h in self._value_widgets.items():
            self.ui.nodes.borrow(h).text = _fmt(reflect.get_path(self.target, p))

    def set_value(self, path: str, value):
        """Functional write-through + PropertyChanged-style message."""
        self.target = reflect.set_path(self.target, path, value)
        self.ui.send_message(UiMessage(
            destination=self._value_widgets.get(path, self.root),
            data={"type": "property_changed", "path": path, "value": value},
            direction="from_widget"))
        self.refresh()
        return self.target
