"""Port parity: the grid broadphase path of fyrox_tpu_torch against
fyrox_tpu's on the CPU.

The same inputs, made from numpy seeds, go through both packages: the
grid candidate sets of a random mixed scene with a halfspace, the
per-class narrowphase, one directed TGS solve on the inputs the JAX step
hands its solver, 20-tick trajectories at W = 4 of a mixed pile and of a
jointed stack, the demand statistics, the directed twins' momentum and
the restitution apex, and Engine.step / rollout on a grid template. Both
packages run float32 in another operation order (XLA fuses multiply-adds;
the port's windowed segment sums run in one ascending sum a body on K4b's
plain version where XLA reduces each body's window as it chooses), so
single evaluations are held to 1e-5 and trajectories to the bounds stated
at each test; integers (pair sets, warm pair ids) are held equal.
"""
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import chip_smoke
import fyrox_tpu.physics as JP
import fyrox_tpu_torch.physics as TP
from fyrox_tpu.core import quat as jquat
from fyrox_tpu.physics import broadphase as jbp
from fyrox_tpu.physics.joints import JointKind as JJointKind
from fyrox_tpu.physics import narrowphase as jnarrow
from fyrox_tpu.physics import solver as jsolver
from fyrox_tpu.physics import world as jworld
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.engine import Engine
from fyrox_tpu_torch.physics import broadphase as tbp
from fyrox_tpu_torch.physics.joints import JointKind
from fyrox_tpu_torch.physics import narrowphase as tnarrow
from fyrox_tpu_torch.physics import plane_ops
from fyrox_tpu_torch.physics import shapes as sh
from fyrox_tpu_torch.physics import solver as tsolver
from fyrox_tpu_torch.physics import world as tworld
from fyrox_tpu_torch.scene import SceneBuilder

torch.set_num_threads(2)

DT = 1.0 / 60.0
W = 4
TICKS = 20


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


# ---- scenes: chip_smoke's grid_pile and jointed_stack, through either
# package's builders ----------------------------------------------------

def _lib(P, kinds):
    return types.SimpleNamespace(
        PhysicsBuilder=P.PhysicsBuilder, BodyType=P.BodyType,
        JointKind=kinds, BALL=P.BALL, CUBOID=P.CUBOID, CAPSULE=P.CAPSULE,
        HALFSPACE=P.HALFSPACE)


JLIB = _lib(JP, JJointKind)
TLIB = _lib(TP, JointKind)


def mixed_pile(lib, n=24, seed=1):
    return chip_smoke.grid_pile(lib, n=n, seed=seed)


def jointed_stack(lib):
    return chip_smoke.jointed_stack(lib)


def _both(scene, **build_kw):
    jpb, tpb = scene(JLIB), scene(TLIB)
    return (jpb, jpb.build(broadphase="grid", **build_kw), tpb,
            tpb.build(broadphase="grid", **build_kw))


def _distinct(js, t, seed):
    """W worlds made distinct by a seeded jitter of the dynamic bodies'
    positions (±5 cm) and velocities (±0.5 m/s)."""
    rng = np.random.default_rng(seed)
    dyn = (np.asarray(t.body_type) == 0)[None, :, None]
    return js._replace(
        position=js.position + jnp.asarray(
            rng.uniform(-0.05, 0.05, js.position.shape) * dyn, jnp.float32),
        linvel=js.linvel + jnp.asarray(
            rng.uniform(-0.5, 0.5, js.linvel.shape) * dyn, jnp.float32))


# ---------------------------------------------------------------- layout

def test_grid_config_matches_jax():
    """build(broadphase="grid") lays out what the JAX package's does (big
    colliders, cell, caps, windows, slot map, kinds), and a JAX GridConfig
    converts field for field."""
    _, jt, _, tt = _both(mixed_pile, grid_window=32,
                         grid_windows_body=(40, 12, 24))
    for g in (tt.grid, convert.physics_template(jt).grid):
        assert isinstance(g, tbp.GridConfig)
        assert g.cell == jt.grid.cell and g.window == 32
        assert g.caps == jt.grid.caps
        assert g.windows_body == jt.grid.windows_body == (40, 12, 24)
        for f in ("grid_cols", "big_cols", "cls_tab", "slot_i", "_kinds",
                  "_kind_i"):
            np.testing.assert_array_equal(getattr(g, f),
                                          getattr(jt.grid, f), err_msg=f)
    with pytest.raises(ValueError):
        pb = TP.PhysicsBuilder()
        b = pb.add_body()
        pb.add_collider(b, TP.CONVEX, points=np.eye(3).tolist() + [[0] * 3])
        pb.add_collider(pb.add_body(position=(2, 0, 0)), TP.BALL, [0.2])
        pb.build(broadphase="grid")           # a dynamic hull is big


def test_grid_candidates_match_jax():
    """The candidate sets (ia, ib, valid, pid) of 80 colliders (balls,
    cuboids, capsules and a halfspace; a dense cluster that overflows the
    walk window of 16 and the caps of 40) at random AABBs, W = 2: equal
    as integers, class by class; the walk demand equals JAX's [W,Cg,9]
    count."""
    rng = np.random.default_rng(0)
    c, w = 80, 2
    col_shape = np.asarray([(sh.BALL, sh.CUBOID, sh.CAPSULE)[i % 3]
                            for i in range(c)], np.int32)
    col_shape[0] = sh.HALFSPACE
    col_params = np.zeros((c, 6), np.float32)
    col_params[:, :3] = (0.3, 0.25, 0.2)
    col_body = np.arange(c, dtype=np.int32)
    col_body[41] = 40                      # a two-collider body
    body_type = np.zeros(c, np.int32)
    body_type[0] = 1
    body_type[5] = 2                       # a kinematic body
    args = (col_shape, col_params, col_body, body_type)
    jg = jbp.build_grid_config(*args, margin=0.052, window=16,
                               caps=(40, 40, 40))
    tg = tbp.build_grid_config(*args, margin=0.052, window=16,
                               caps=(40, 40, 40))
    pos = rng.uniform(-3, 3, (w, c, 3)).astype(np.float32)
    pos[:, :30] = rng.uniform(-0.8, 0.8, (w, 30, 3))
    he = rng.uniform(0.2, 0.4, (w, c, 3)).astype(np.float32)
    he[:, 0] = 1e9
    amin, amax = pos - he, pos + he
    dyn_col = body_type[col_body] == 0
    jsets = jax.jit(lambda lo, hi: jbp.grid_candidates(
        jg, col_body, dyn_col, lo, hi))(jnp.asarray(amin), jnp.asarray(amax))
    tsets, demand = tbp.grid_candidates(tg, col_body, dyn_col,
                                        torch.tensor(amin),
                                        torch.tensor(amax),
                                        return_demand=True)
    n_valid = 0
    for js, ts in zip(jsets, tsets):
        for f in ("ia", "ib", "valid", "pid"):
            assert getattr(ts, f).dtype in (torch.int32, torch.bool)
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)),
                                          err_msg=f)
        n_valid += int(ts.valid.sum())
    assert n_valid > 50
    assert int(demand.max()) > 16          # the walk window overflowed
    assert any(bool(ts.valid.all()) for ts in tsets)   # a cap overflowed


def test_generate_contacts_class_matches_jax():
    """Each class's routines at random canonical pairs of every kind combo
    of the class (the pair's kinds select among them): normals, points
    and depths within 1e-6, active flags equal. JAX runs op by op
    (disable_jit), where it rounds each operation as PyTorch does; jitted,
    XLA's fused multiply-adds move the normals by up to 1.7e-6."""
    rng = np.random.default_rng(4)
    for cls, combos in jnarrow.CLASS_COMBOS.items():
        assert tnarrow.CLASS_COMBOS[cls] == combos
        n = 240          # one shape for every class: JAX's op cache hits
        ka = np.asarray([combos[i % len(combos)][0] for i in range(n)])
        kb = np.asarray([combos[i % len(combos)][1] for i in range(n)])
        params_a = rng.uniform(0.15, 0.4, (1, n, 6)).astype(np.float32)
        params_b = rng.uniform(0.15, 0.4, (1, n, 6)).astype(np.float32)
        pos_a = rng.uniform(-0.3, 0.3, (1, n, 3)).astype(np.float32)
        pos_b = (pos_a + rng.uniform(-0.5, 0.5, (1, n, 3))).astype(
            np.float32)
        q = rng.normal(size=(2, 1, n, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        rot_a = np.asarray(jquat.to_mat3(jnp.asarray(q[0], jnp.float32)))
        rot_b = np.asarray(jquat.to_mat3(jnp.asarray(q[1], jnp.float32)))
        pred = np.float32(0.052)
        with jax.disable_jit():
            jm = jnarrow.generate_contacts_class(
                cls, jnp.asarray(ka[None], jnp.int32), jnp.asarray(params_a),
                jnp.asarray(pos_a), jnp.asarray(rot_a),
                jnp.asarray(kb[None], jnp.int32), jnp.asarray(params_b),
                jnp.asarray(pos_b), jnp.asarray(rot_b), jnp.asarray(pred))
        tm = tnarrow.generate_contacts_class(
            cls, torch.tensor(ka[None], dtype=torch.int32),
            torch.tensor(params_a), torch.tensor(pos_a),
            torch.tensor(rot_a), torch.tensor(kb[None], dtype=torch.int32),
            torch.tensor(params_b), torch.tensor(pos_b),
            torch.tensor(rot_b), torch.tensor(pred))
        act = np.asarray(jm.active)
        np.testing.assert_array_equal(tm.active.numpy(), act)
        assert act.any() and not act.all()
        for f in ("normal", "points", "depth"):
            np.testing.assert_allclose(getattr(tm, f).numpy(),
                                       np.asarray(getattr(jm, f)), rtol=0,
                                       atol=1e-6, err_msg=f"{cls} {f}")


# ---------------------------------------------------------------- solve

def test_solve_tgs_directed_matches_jax(pile_run):
    """One directed solve, JAX's (jitted) and the port's, on the same
    inputs: the port's grid_contacts segments of the pile's JAX state
    after 10 ticks (W = 4 distinct worlds, contacts live, warm starts
    carried): poses and velocities within 1e-5, impulses within 1e-4."""
    jt, tt, js0, seq = pile_run
    prev = jax.tree_util.tree_map(lambda x: x[9], seq)
    ts = convert.physics_state(prev, device="cpu")
    accel, angvel = tworld.external_accelerations(ts, tt, DT)
    segs, warm, _ = tworld.grid_contacts(ts, tt)
    assert sum(int(g.active.sum()) for g in segs) > 0
    inv_mass = torch.tensor(tt.inv_mass)[None].expand(W, -1)
    sp = tsolver.SolverParams(dt=DT)
    out = tsolver.solve_tgs_directed(
        ts.position, ts.rotation, ts.linvel, angvel, tt.com_local, inv_mass,
        tt.inv_inertia_local, accel, segs, sp, warm=warm)
    jsegs = [jsolver.DirectedSeg(window=g.window, **{
        f: jnp.asarray(getattr(g, f).numpy())
        for f in tsolver.DirectedSeg._fields if f != "window"})
        for g in segs]
    jwarm = [tuple(jnp.asarray(x.numpy()) for x in wm) for wm in warm]
    jsp = jsolver.SolverParams(dt=jnp.asarray(DT, jnp.float32))
    jout = jax.jit(lambda *a: jsolver.solve_tgs_directed(
        *a, jnp.asarray(tt.com_local), jnp.asarray(inv_mass.numpy()),
        jnp.asarray(tt.inv_inertia_local), jnp.asarray(accel.numpy()),
        jsegs, jsp, warm=jwarm))(
        *(jnp.asarray(x.numpy()) for x in (ts.position, ts.rotation,
                                            ts.linvel, angvel)))
    for k in range(4):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=1e-5)
    for tl, jl in zip(out[4], jout[4]):
        for x, y in zip(tl, jl):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                       atol=1e-4)


def test_segment_sum_drops_past_the_window():
    """The windowed segment sum: a body's rows past `window` drop (JAX's
    _seg_scatter), through K4b's plain version."""
    body_self = torch.tensor([[0, 0, 0, 1, 3, 3]], dtype=torch.int32)
    seg = tsolver.DirectedSeg(
        body_a=body_self, body_b=body_self, sigma=torch.ones(1, 6),
        body_self=body_self,
        bounds=tsolver.segment_bounds(body_self, 4),
        normal=None, point=None, depth=None, active=None, friction=None,
        restitution=None, window=2)
    assert seg.bounds.tolist() == [[0, 3, 4, 4, 6]]
    _, scat = tsolver._seg_ops(seg, 4)
    vals = torch.tensor([[1.0, 2.0, 4.0, 8.0, 16.0, 32.0]])[..., None]
    assert scat(vals)[0, :, 0].tolist() == [3.0, 8.0, 0.0, 48.0]
    jseg = jsolver.DirectedSeg(
        body_a=None, body_b=None, sigma=None, body_self=None,
        bounds=jnp.asarray(seg.bounds.numpy()), normal=None, point=None,
        depth=None, active=None, friction=None, restitution=None, window=2)
    assert np.asarray(jsolver._seg_scatter(
        jseg, jnp.asarray(vals.numpy()), 4))[0, :, 0].tolist() == [
        3.0, 8.0, 0.0, 48.0]


# ---------------------------------------------------------------- steps

def _jax_run(scene, seed=7):
    """(JAX template, port template, W = 4 distinct initial JAX state
    (numpy), the JAX states of TICKS ticks from it, one jitted scan,
    stacked (numpy))."""
    jpb, jt, _, tt = _both(scene)
    js0 = _distinct(jworld.init_physics_state(jpb, jt, W), jt, seed)

    def body(s, _):
        s = jworld.step_physics(s, jt, DT)
        return s, s

    _, seq = jax.jit(lambda s: jax.lax.scan(body, s, None,
                                            length=TICKS))(js0)
    return jt, tt, _np(js0), _np(seq)


@pytest.fixture(scope="module")
def pile_run():
    return _jax_run(mixed_pile)


@pytest.fixture(scope="module")
def jointed_run():
    return _jax_run(jointed_stack)


# Whole-trajectory position bounds. XLA fuses the integration's
# pos + h·lv into a fused multiply-add on the CPU, PyTorch rounds the
# product first: a falling body's position parts by up to 2 ulp a tick
# (4.77e-7 at y ≈ 2 m; the pile's top layer falls for 15 ticks), so the
# pile's 20-tick trajectory reaches 1.8e-5 with the contacts' growth where
# each tick from JAX's own state stays within 4.8e-7. The jointed stack
# stays within 1.5e-6.
TRAJ_POS = {"pile": 2e-5, "jointed": 1e-5}


@pytest.mark.parametrize("scene", ["pile", "jointed"])
def test_grid_trajectory_matches_jax(scene, request):
    """TICKS ticks at W = 4 distinct worlds from the same state, JAX as one
    jitted scan: every tick from JAX's own state within 1e-5 (positions)
    and 5e-4 (velocities); the whole trajectory's velocities within 5e-4,
    its positions within TRAJ_POS, the warm pair ids equal every tick;
    contacts live; the port's tick launches no kernel on CPU tensors."""
    jt, tt, prev, seq = request.getfixturevalue(f"{scene}_run")
    ts = convert.physics_state(prev, device="cpu")
    plane_ops.reset_launches()
    for k in range(TICKS):
        want = jax.tree_util.tree_map(lambda x: x[k], seq)
        one = tworld.step_physics(convert.physics_state(prev, device="cpu"),
                                  tt, DT)
        np.testing.assert_allclose(one.position.numpy(), want.position,
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(one.linvel.numpy(), want.linvel, rtol=0,
                                   atol=5e-4)
        ts = tworld.step_physics(ts, tt, DT)
        np.testing.assert_array_equal(ts.warm_pair.numpy(), want.warm_pair)
        np.testing.assert_allclose(ts.position.numpy(), want.position,
                                   rtol=0, atol=TRAJ_POS[scene])
        np.testing.assert_allclose(ts.linvel.numpy(), want.linvel, rtol=0,
                                   atol=5e-4)
        prev = want
    assert int((ts.warm_pair >= 0).sum()) > 4 * W
    assert plane_ops.launches("plane_gather") == 0
    assert plane_ops.launches("plane_scatter") == 0


def test_broadphase_stats_match_jax(pile_run):
    """broadphase_stats of the pile after 15 ticks (W = 4) equal JAX's."""
    jt, tt, _, seq = pile_run
    js = jax.tree_util.tree_map(lambda x: x[14], seq)
    want = jbp.broadphase_stats(jt, jax.tree_util.tree_map(jnp.asarray, js))
    got = tbp.broadphase_stats(tt, convert.physics_state(js, device="cpu"))
    assert got == want
    assert got[0]["needed"] > 0


def test_directed_twins_conserve_momentum():
    """Two balls (e = 1, no gravity) colliding head on over 60 grid ticks:
    momentum conserved to 1e-4 (the twins' self halves), and each rebounds
    at nearly its approach speed (tests/test_broadphase.py's check)."""
    pb = TP.PhysicsBuilder()
    a = pb.add_body(position=(-1.2, 0, 0), gravity_scale=0.0)
    pb.add_collider(a, TP.BALL, [0.5], restitution=1.0)
    b = pb.add_body(position=(1.2, 0, 0), gravity_scale=0.0)
    pb.add_collider(b, TP.BALL, [0.5], restitution=1.0)
    t = pb.build(broadphase="grid")
    s = tworld.init_physics_state(pb, t, 1, device="cpu")
    s = s._replace(linvel=torch.tensor([[[2.0, 0, 0], [-2.0, 0, 0]]]))
    for _ in range(60):
        s = tworld.step_physics(s, t, DT)
    v = s.linvel[0].numpy()
    assert np.abs(v.sum(0)).max() < 1e-4
    assert v[0, 0] < -1.9 and v[1, 0] > 1.9


def test_restitution_apex():
    """An e = 0.8 ball dropped from 3 m onto the halfspace on the grid
    broadphase rebounds to an apex of ~2.1 m (tests/test_broadphase.py's
    check, there on the dense path)."""
    pb = TP.PhysicsBuilder()
    g = pb.add_body(body_type=TP.BodyType.STATIC)
    pb.add_collider(g, TP.HALFSPACE, [], restitution=0.0)
    b = pb.add_body(position=(0, 3.0, 0))
    pb.add_collider(b, TP.BALL, [0.5], restitution=0.8)
    t = pb.build(broadphase="grid")
    s = tworld.init_physics_state(pb, t, 1, device="cpu")
    ys = []
    for _ in range(160):
        s = tworld.step_physics(s, t, DT)
        ys.append(float(s.position[0, 1, 1]))
    ys = np.asarray(ys)
    imp = int(np.argmin(ys[:100]))
    assert 1.8 < ys[imp:].max() < 2.3


def _grid_engine(n=12):
    """A pile of n bodies with scene nodes on the grid broadphase."""
    sb = SceneBuilder()
    pb = mixed_pile(TLIB, n=n, seed=2)
    for i in range(1, n + 1):
        pb._bodies[i]["node"] = sb.add_node(
            f"b{i}", node_type=7, position=pb._bodies[i]["position"])
    return Engine(template=sb.build(), physics=pb.build(broadphase="grid"))


def test_engine_step_and_rollout_on_grid():
    """Engine.step on a grid template steps its physics with step_physics
    and moves the bodies' nodes with them; rollout equals the step loop
    bit for bit (and captures on the card: _capturable); world_health
    holds."""
    from fyrox_tpu_torch.engine import world_health
    te = _grid_engine()
    assert te._capturable()
    st = te.init_state(2, device="cpu")
    stepped = te.step(te.step(te.step(st)))
    ph = st.physics
    for _ in range(3):
        ph = tworld.step_physics(ph, te.physics, te.dt)
    assert torch.equal(ph.position, stepped.physics.position)
    bn = te.physics.body_node
    np.testing.assert_allclose(
        stepped.scene.globals_[:, bn[1:], :3, 3].numpy(),
        ph.position[:, 1:].numpy(), rtol=0, atol=1e-6)
    rolled = te.rollout(st, 3)
    for a, b in zip(rolled.physics, stepped.physics):
        if a is not None:
            assert torch.equal(a, b)
    assert bool(world_health(rolled).all())
