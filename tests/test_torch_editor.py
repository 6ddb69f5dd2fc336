"""Port parity: the editor session (gizmo commands, undo / redo, the
outliner, play mode) and the command stack of fyrox_tpu_torch against
fyrox_tpu's on the CPU.

The scene is tests/test_editor.py's (a ground pivot with a child, a ball
over a halfspace), built with each package's builders. Translate, rotate,
scale, undo and redo run in both packages and the edited scene states are
held equal: positions, scales, visibility and the refreshed globals
exactly where the edit only adds, multiplies or moves values, within 1e-6
where a quaternion product or a matrix chain rounds differently under XLA
and PyTorch. Play, tick and stop run on the port only (no JAX engine tick
runs here): the state taken before play, and the state the stack holds,
are unchanged bit for bit after tick and stop, and undo after play gives
back the first state.
"""
import numpy as np
import pytest
import torch

from fyrox_tpu.editor import EditorSession as JEditorSession
from fyrox_tpu.engine import Engine as JEngine
from fyrox_tpu.physics import BALL as JBALL
from fyrox_tpu.physics import HALFSPACE as JHALFSPACE
from fyrox_tpu.physics import BodyType as JBodyType
from fyrox_tpu.physics import PhysicsBuilder as JPhysicsBuilder
from fyrox_tpu.scene import SceneBuilder as JSceneBuilder
from fyrox_tpu.utils.commands import Command as JCommand
from fyrox_tpu.utils.commands import CommandStack as JCommandStack
from fyrox_tpu_torch.editor import EditorSession
from fyrox_tpu_torch.engine import Engine, _leaves, _map
from fyrox_tpu_torch.physics import BALL, HALFSPACE, BodyType, PhysicsBuilder
from fyrox_tpu_torch.scene import SceneBuilder
from fyrox_tpu_torch.script import Script
from fyrox_tpu_torch.utils.commands import Command, CommandStack

torch.set_num_threads(2)
TOL = 1e-6


def session(jax_side=False):
    """tests/test_editor.py's session with either package's builders."""
    if jax_side:
        sbc, pbc, eng = JSceneBuilder, JPhysicsBuilder, JEngine
        ball_k, half_k, static = JBALL, JHALFSPACE, JBodyType.STATIC
    else:
        sbc, pbc, eng = SceneBuilder, PhysicsBuilder, Engine
        ball_k, half_k, static = BALL, HALFSPACE, BodyType.STATIC
    sb = sbc()
    ground = sb.add_pivot("ground")
    child = sb.add_node("child", position=(1.0, 0.0, 0.0), parent=ground)
    pb = pbc()
    g = pb.add_body(node=ground, body_type=static)
    pb.add_collider(g, half_k, [])
    ball = sb.add_node("ball", position=(0.0, 3.0, 0.0),
                       bbox=(np.full(3, -0.5), np.full(3, 0.5)))
    bi = pb.add_body(node=ball, position=(0.0, 3.0, 0.0))
    pb.add_collider(bi, ball_k, [0.5])
    e = eng(template=sb.build(), physics=pb.build())
    state = (e.init_state(num_worlds=2) if jax_side
             else e.init_state(2, device="cpu"))
    cls = JEditorSession if jax_side else EditorSession
    return cls(e, state), dict(ground=ground, child=child, ball=ball)


def same_scene(got, want):
    g, w = got.scene, want.scene
    for f in ("position", "scale", "visibility", "enabled",
              "global_visibility", "global_enabled"):
        np.testing.assert_array_equal(getattr(g, f).numpy(),
                                      np.asarray(getattr(w, f)), err_msg=f)
    for f in ("rotation", "globals_"):
        np.testing.assert_allclose(getattr(g, f).numpy(),
                                   np.asarray(getattr(w, f)), rtol=0,
                                   atol=TOL, err_msg=f)


def clone(state):
    return _map(torch.clone, state)


def same_bits(got, want):
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and torch.equal(x, y)


EDITS = [
    ("translate", "ball", (0.0, 2.0, 0.0)),
    ("translate", "ground", (0.0, 0.0, 5.0)),
    ("scale", "child", (2.0, 2.0, 2.0)),
    ("rotate", "ground", (0.0, np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4))),
    ("rotate", "child", (np.sin(0.2), 0.0, 0.0, np.cos(0.2))),
]


@pytest.mark.parametrize("step", range(len(EDITS)))
def test_gizmo_commands_equal_jax(step):
    es, n = session()
    jes, jn = session(jax_side=True)
    for kind, node, arg in EDITS[:step + 1]:
        getattr(es, kind)(n[node], arg)
        getattr(jes, kind)(jn[node], arg)
        same_scene(es.state, jes.state)
    assert es.undo() == jes.undo()
    same_scene(es.state, jes.state)
    assert es.redo() == jes.redo()
    same_scene(es.state, jes.state)
    assert es.stack.history() == jes.stack.history()


def test_translate_parent_moves_child_and_undo_restores_bits():
    es, n = session()
    first = clone(es.state)
    es.translate(n["ground"], (0.0, 0.0, 5.0))
    assert abs(float(es.state.scene.globals_[0, n["child"], 2, 3]) - 5.0) \
        < 1e-5
    es.undo()
    same_bits(es.state, first)
    assert es.redo() == f"move node {n['ground']}"


def test_outliner_equal_jax():
    es, _ = session()
    jes, _ = session(jax_side=True)
    rows = [(r.index, r.name, r.depth, r.children) for r in es.outliner()]
    assert rows == [(r.index, r.name, r.depth, r.children)
                    for r in jes.outliner()]
    es.select(2, 1)
    assert es.selection == [2, 1]


def test_command_stack_equal_jax():
    stacks = [CommandStack(0, limit=4), JCommandStack(0, limit=4)]
    logs = []
    for st, cmd in zip(stacks, (Command, JCommand)):
        log = []
        for k in range(6):
            st.do(cmd(f"add {k}", lambda s, k=k: s + k))
        log += [st.state, st.undo(), st.undo(), st.state, st.redo()]
        st.do(cmd("times 10", lambda s: s * 10))
        log += [st.state, st.can_redo, st.history(), st.undo(), st.undo(),
                st.undo(), st.undo(), st.can_undo]
        logs.append(log)
    assert logs[0] == logs[1]


def test_play_tick_stop_leave_the_edit_state_unchanged():
    es, n = session()
    first = clone(es.state)
    es.translate(n["ball"], (0.0, 1.0, 0.0))
    edited = es.state
    kept = clone(edited)
    y0 = float(edited.physics.position[0, 1, 1])
    hits = []

    class Counter(Script):
        def on_update(self, ctx):
            hits.append(ctx.dt)

    ex = es.play(update_rate=30.0)
    ex.scripts.add(Counter())
    es.tick(0.5)
    assert len(hits) == 15
    assert float(es.state.physics.position[0, 1, 1]) < y0 - 0.3
    es.pause()
    assert es.mode == "paused"
    es.resume()
    es.tick(0.1)
    back = es.stop()
    assert es.mode == "edit" and back is edited
    same_bits(edited, kept)              # no tick wrote the kept state
    es.undo()
    same_bits(es.state, first)
    es.redo()
    same_bits(es.state, kept)
