"""Port parity: the editor panels (``ui.dock``, ``ui.inspector`` with
``core.reflect``, ``ui.absm_editor``, ``ui.anim_editor``) against the JAX
package's on the CPU.

The panels are host code: the same command sequences give the same
documents, rectangles, rows and texts. The ABSM preview runs each
package's machine (the port's on CPU tensors) over the same seeded
parameter rows and gives the same state trace; the animation scrub samples
each package's tracks within 1e-6 (float32 curve sampling; XLA may fuse
multiply-adds that PyTorch rounds apart). The sessions come from
chip_smoke.absm_session / anim_session, which the card's editors phase
drives as well.
"""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from fyrox_tpu.core import reflect as jreflect
from fyrox_tpu.ui import absm_editor as jabsm
from fyrox_tpu.ui import anim_editor as janim
from fyrox_tpu.ui import core as jcore
from fyrox_tpu.ui.dock import DockingManager as JDock
from fyrox_tpu.ui.inspector import Inspector as JInspector
from fyrox_tpu_torch.core import reflect
from fyrox_tpu_torch.ui import absm_editor, anim_editor
from fyrox_tpu_torch.ui import core
from fyrox_tpu_torch.ui.dock import DockingManager
from fyrox_tpu_torch.ui.inspector import Inspector

torch.set_num_threads(2)


# ------------------------------------------------------------------ dock

def _rects(ui, handles):
    out = []
    for h in handles:
        r = ui.nodes.borrow(h).actual_rect
        out.append((r.x, r.y, r.w, r.h))
    return out


def _dock_session(ui_mod, dock_cls):
    """Four windows docked on every side, a ratio drag, an undock and a
    re-dock into a tile; the rectangles after each layout."""
    ui = ui_mod.UserInterface((800, 600))
    dm = dock_cls(ui)
    wins = [ui.add(ui_mod.Widget(kind="window", name=n, title=n))
            for n in "ABCD"]
    seen = []
    dm.dock(wins[0])
    dm.dock(wins[1], side="right", ratio=0.25)
    dm.dock(wins[2], side="bottom", ratio=0.4)
    dm.dock(wins[3], tile=dm.tile_of(wins[1]), side="top", ratio=0.6)
    ui.update_layout()
    seen.append(_rects(ui, wins))
    dm.set_ratio(dm.root, 0.7)
    ui.update_layout()
    seen.append(_rects(ui, wins))
    dm.undock(wins[1])
    ui.update_layout()
    seen.append(_rects(ui, wins))
    dm.dock(wins[1], tile=dm.tile_of(wins[0]), side="left", ratio=0.3)
    ui.update_layout()
    seen.append(_rects(ui, wins))
    return seen, [ui.nodes.borrow(w).parent == ui.root for w in wins]


def test_dock_sequence_gives_the_same_rectangles():
    want = _dock_session(jcore, JDock)
    got = _dock_session(core, DockingManager)
    assert got == want
    assert len({tuple(r) for r in got[0][0]}) == 4   # four distinct panes


# ------------------------------------------------- reflect and inspector

def _target():
    """A nested target of numpy leaves, from a seed (its classes made anew
    for each package's inspector)."""
    rng = np.random.default_rng(4)

    @dataclasses.dataclass
    class Inner:
        value: float = float(rng.uniform(-2, 2))
        count: int = 3
        items: list = dataclasses.field(
            default_factory=lambda: [1.5, 2.25, 3.0])

    @dataclasses.dataclass
    class Settings:
        name: str = "bot"
        enabled: bool = True
        speed: float = float(rng.uniform(0, 5))
        inner: Inner = dataclasses.field(default_factory=Inner)
        arr: np.ndarray = dataclasses.field(
            default_factory=lambda: rng.uniform(-1, 1, 4).astype(np.float32))

    return Settings()


def _inspector_session(ui_mod, ins_cls):
    ui = ui_mod.UserInterface((400, 400))
    ins = ins_cls(ui, _target())
    ui.update_layout()
    texts = [ui.nodes.borrow(ins._value_widgets[p]).text for p in ins.paths]
    ins.set_value("inner.value", 0.125)
    ins.set_value("arr[2]", 7.5)
    for path, text in (("speed", "4.5"), ("enabled", "no"),
                       ("inner.count", "12"), ("arr", "(1, 2, 3, 4)"),
                       ("inner.items[1]", "9"), ("name", "drone"),
                       ("speed", "not a number")):
        h = ins._value_widgets[path]
        ui.nodes.borrow(h).text = text
        ui.nodes.borrow(h).on_commit(ui, h)
    msgs = []
    while (m := ui.poll_message()) is not None:
        if m.data.get("type") == "property_changed":
            msgs.append((m.data["path"], repr(m.data["value"])))
    after = [ui.nodes.borrow(ins._value_widgets[p]).text for p in ins.paths]
    return ins.paths, texts, after, msgs, ins.target


def test_inspector_rows_texts_and_edits_match_jax():
    jpaths, jtexts, jafter, jmsgs, jt = _inspector_session(jcore, JInspector)
    paths, texts, after, msgs, t = _inspector_session(core, Inspector)
    assert paths == jpaths and "inner.items[1]" in paths
    assert texts == jtexts
    assert after == jafter
    assert msgs == jmsgs and len(msgs) >= 6
    for p in paths:
        np.testing.assert_array_equal(reflect.get_path(t, p),
                                      jreflect.get_path(jt, p))
    assert t.arr.dtype == jt.arr.dtype == np.float32


def test_set_path_gives_the_same_values():
    rng = np.random.default_rng(9)
    base = {"a": [rng.standard_normal(3), (1, 2.5, "x")],
            "b": {"c": rng.standard_normal((2, 2)), "d": 4}}
    for path, value in (("a[0][1]", 3.5), ("a[1][2]", "y"), ("b.c[1]", 0.0),
                        ("b.d", 5), ("a[1]", (0, 0))):
        got, want = (reflect.set_path(base, path, value),
                     jreflect.set_path(base, path, value))
        assert reflect.enumerate_paths(got) == jreflect.enumerate_paths(want)
        for p in jreflect.enumerate_paths(want):
            np.testing.assert_array_equal(reflect.get_path(got, p),
                                          jreflect.get_path(want, p))
    assert base["b"]["d"] == 4 and base["a"][1][2] == "x"


@pytest.mark.parametrize("dtype", [torch.float32, torch.int64])
def test_tensor_leaf_set_keeps_device_and_dtype(dtype):
    """The port's counterpart of the JAX array branch: the set is on a
    clone, of the same device and dtype; the caller's tensor is not
    written. A tensor leaf formats as text, as a JAX array leaf does."""
    leaf = torch.arange(6, dtype=dtype).reshape(2, 3)
    obj = {"pose": {"t": leaf}}
    out = reflect.set_path(obj, "pose.t[1]", 9)
    assert out["pose"]["t"].dtype == dtype
    assert out["pose"]["t"].device == leaf.device
    assert out["pose"]["t"][1].tolist() == [9, 9, 9]
    assert leaf[1].tolist() == [3, 4, 5]
    assert out["pose"]["t"] is not leaf
    assert reflect.enumerate_paths(obj) == ["pose.t"]
    ui = core.UserInterface((200, 100))
    ins = Inspector(ui, obj)
    assert ui.nodes.borrow(ins._value_widgets["pose.t"]).text == str(leaf)


# -------------------------------------------------------- ABSM editor

def _doc(d):
    return dataclasses.asdict(d)


def test_absm_commands_undo_redo_match_jax():
    ed, jed = (chip_smoke.absm_session(absm_editor),
               chip_smoke.absm_session(jabsm))
    assert _doc(ed.doc) == _doc(jed.doc)
    assert ed.stack.history() == jed.stack.history()
    assert ed.problems() == jed.problems()
    for _ in range(3):
        assert ed.undo() == jed.undo()
        assert _doc(ed.doc) == _doc(jed.doc)
    ed.remove_state(1)
    jed.remove_state(1)
    assert _doc(ed.doc) == _doc(jed.doc)
    assert ed.redo() == jed.redo()
    assert _doc(ed.doc) == _doc(jed.doc)
    assert ed.problems() == jed.problems()


def test_absm_preview_trace_matches_jax():
    rows = chip_smoke.absm_rows()
    ed, jed = (chip_smoke.absm_session(absm_editor),
               chip_smoke.absm_session(jabsm))
    mt, jmt = ed.compile(), jed.compile()
    assert (mt.num_states, mt.num_transitions, mt.param_names) == (
        jmt.num_states, jmt.num_transitions, jmt.param_names)
    trace = ed.preview(rows, device="cpu")
    assert trace == jed.preview(rows)
    assert len(set(trace)) == 3                 # every state visited


def test_absm_preview_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device"):
        chip_smoke.absm_session(absm_editor).preview([[True, False]])


# --------------------------------------------------- animation editor

def test_anim_commands_undo_redo_match_jax():
    ed, jed = (chip_smoke.anim_session(anim_editor),
               chip_smoke.anim_session(janim))
    assert _doc(ed.doc) == _doc(jed.doc)
    assert ed.stack.history() == jed.stack.history()
    for _ in range(4):
        assert ed.undo() == jed.undo()
        assert _doc(ed.doc) == _doc(jed.doc)
    for _ in range(2):
        assert ed.redo() == jed.redo()
    assert _doc(ed.doc) == _doc(jed.doc)
    assert [ed.dopesheet(c) for c in range(2)] == [jed.dopesheet(c)
                                                   for c in range(2)]


def test_anim_scrub_matches_jax():
    ed, jed = (chip_smoke.anim_session(anim_editor),
               chip_smoke.anim_session(janim))
    aset, jaset = ed.compile(), jed.compile()
    for f in ("pos_node", "rot_node", "scl_node"):
        np.testing.assert_array_equal(getattr(aset, f), getattr(jaset, f))
    for tm in chip_smoke.SCRUB_TIMES:
        got, want = ed.scrub(tm, device="cpu"), jed.scrub(tm)
        assert sorted(got) == sorted(want) and ed.cursor == jed.cursor
        for kind in want:
            (gn, ga, gv), (wn, wa, wv) = got[kind], want[kind]
            np.testing.assert_array_equal(gn, np.asarray(wn))
            np.testing.assert_array_equal(ga, np.asarray(wa))
            assert gv.dtype == torch.float32
            np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=0,
                                       atol=1e-6)


def test_anim_scrub_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device"):
        chip_smoke.anim_session(anim_editor).scrub(0.5)
