"""Port parity: ``engine.debug_step`` against the JAX package's checkify
step on the CPU.

The same states (the JAX states converted) go through
``fyrox_tpu.engine.debug_step`` (checkify's float and index checks, one
jitted step) and the port's ``debug_step`` on a 4-bone animated character
with no physics: both find nothing on a healthy state, both name "nan" on
a state with a NaN node position, both flag an ABSM state index past the
machine's states and neither flags -1 (a valid index from the end). On
tests/test_engine.py's 2-body engine (converted), the port names "nan"
and the physics stage for a NaN or inf linear velocity (checkify names
the NaN the value produces there too: tests/test_engine.py:207-217).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fyrox_tpu.engine import Engine as JEngine
from fyrox_tpu.engine import debug_step as jax_debug_step
from fyrox_tpu.models.character import build_character_scene
from fyrox_tpu_torch import convert
from fyrox_tpu_torch import engine as tengine
from fyrox_tpu_torch.physics import plane_ops
from test_engine import small_engine

torch.set_num_threads(2)


def _port(jstate):
    return convert.engine_state(jax.tree_util.tree_map(np.asarray, jstate),
                                device="cpu")


@pytest.fixture(scope="module")
def physics_engine():
    je, _ = small_engine(2)
    return je, convert.engine(je)


@pytest.fixture(scope="module")
def anim_engine():
    sb, aset, mt, _, _ = build_character_scene(n_bones=4, n_verts=16)
    je = JEngine(template=sb.build(), animations=aset, machine=mt)
    return je, jax.jit(jax_debug_step(je)), convert.engine(je)


def test_healthy_ticks_report_nothing(physics_engine, anim_engine):
    je, jstep, te = anim_engine
    assert jstep(je.init_state(num_worlds=2))[0].get() is None
    for je, te in ((physics_engine[0], physics_engine[1]),
                   (anim_engine[0], anim_engine[2])):
        js = je.init_state(num_worlds=2)
        terr, tout = tengine.debug_step(te)(_port(js))
        assert terr.get() is None
        terr.throw()
        # the checked tick is the plain tick
        plain = te.step(_port(js))
        for a, b in zip(tengine._leaves(tout), tengine._leaves(plain)):
            assert torch.equal(a, b)
    assert tengine._CHECKS is None and plane_ops._INDEX_CHECKS is None


def test_poisoned_position_names_nan_as_checkify_does(anim_engine):
    je, jstep, te = anim_engine
    js = je.init_state(num_worlds=2)
    js = js._replace(scene=js.scene._replace(
        position=js.scene.position.at[1, 0, 1].set(jnp.nan)))
    jerr, _ = jstep(js)
    terr, _ = tengine.debug_step(te)(_port(js))
    assert "nan" in str(jerr.get()).lower()
    assert terr.get().startswith("nan in stage "), terr.get()


@pytest.mark.parametrize("value", [float("nan"), float("inf")])
def test_poisoned_velocity_names_nan_and_the_physics_stage(physics_engine,
                                                           value):
    je, te = physics_engine
    js = je.init_state(num_worlds=2)
    js = js._replace(physics=js.physics._replace(
        linvel=js.physics.linvel.at[0, 1, 0].set(value)))
    terr, _ = tengine.debug_step(te)(_port(js))
    msg = terr.get()
    assert msg.startswith("nan in stage physics: physics."), msg
    with pytest.raises(tengine.DebugStepError, match="nan"):
        terr.throw()


@pytest.mark.parametrize("current,flagged", [(99, True), (-1, False),
                                             (1, False)])
def test_machine_index_out_of_range(anim_engine, current, flagged):
    je, jstep, te = anim_engine
    js = je.init_state(num_worlds=2)
    m = js.animation.machine
    js = js._replace(animation=js.animation._replace(machine=m._replace(
        current=jnp.asarray([0, current], jnp.int32))))
    jerr, _ = jstep(js)
    terr, tout = tengine.debug_step(te)(_port(js))
    assert (jerr.get() is not None) == flagged
    assert "out-of-bounds" in str(jerr.get()) or not flagged
    msg = terr.get()
    if flagged:
        assert msg == "index in stage animation: animation.machine.current"
        # the flagged index was read as 0, so the tick stayed in range
        assert bool(tengine.world_health(tout).all())
    else:
        assert msg is None


def test_physics_gather_indices_are_checked():
    """A K4a / K4b index tensor out of range, seen while a checked tick
    runs, is flagged in the stage that ends next; -1 is no error."""
    checks = tengine._Checks()
    plane_ops._INDEX_CHECKS = []
    try:
        planes = torch.zeros((1, 2, 4))
        plane_ops.plane_gather(planes, torch.tensor([[0, -1, 3]],
                                                    dtype=torch.int32))
        plane_ops.plane_scatter(torch.zeros((1, 2, 2)),
                                torch.tensor([[-1, 4]], dtype=torch.int32), 4)
        checks.stage("physics")
    finally:
        plane_ops._INDEX_CHECKS = None
    err = tengine.StepError(checks.flags)
    assert err.get() == "index in stage physics: plane_scatter idx"


@pytest.mark.parametrize("planar", [False, True])
def test_row_gather_indices_are_checked(planar):
    """K4a's row form is checked as its plane form is: -1 is no error, an
    index at or above the table's rows is flagged; a plain gather (the
    slab broadphase's plain path) is not a kernel call and not checked."""
    checks = tengine._Checks()
    plane_ops._INDEX_CHECKS = []
    try:
        x = torch.zeros((1, 4, 2))
        plane_ops.gather_rows(x, torch.tensor([[0, -1, 3]]), planar=planar)
        plane_ops.gather_rows(x, torch.tensor([[9]]), plain=True)
        checks.stage("sync")
        plane_ops.gather_rows(x, torch.tensor([[0, 4]]), planar=planar)
        checks.stage("physics")
    finally:
        plane_ops._INDEX_CHECKS = None
    err = tengine.StepError(checks.flags)
    assert err.get() == "index in stage physics: gather_rows idx"
