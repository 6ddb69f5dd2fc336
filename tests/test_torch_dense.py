"""Port parity: the dense broadphase path of fyrox_tpu_torch against
fyrox_tpu's on the CPU, and against the sequential float64 oracle.

The same inputs, made from numpy seeds, go through both packages: the
builder's layout (pair list, kind ranges, compact contact layout), the
narrowphase of each of the nine kind combos at random poses, one step from
identical states in full-layout and compacted mode with a joint and a COM
offset, a 20-tick trajectory at W = 4, the template conversion, a dim2
world and Engine.step on a small dense flagship. Both packages run float32
in another operation order (XLA fuses multiply-adds, the port's scatters
add the a-side and b-side rows in one ascending sum), so single evaluations
are held to 1e-5 and trajectories to the bounds stated at each test.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fyrox_tpu.models.character import build_flagship as jax_build_flagship
from fyrox_tpu.models.character import build_pile_scene as jax_pile
from fyrox_tpu.physics import narrowphase as jnarrow
from fyrox_tpu.physics import oracle as orc
from fyrox_tpu.physics import world as jworld
from fyrox_tpu.physics.dim2 import Physics2DBuilder as JPhysics2DBuilder
from fyrox_tpu.physics.world import PhysicsBuilder as JPhysicsBuilder
from fyrox_tpu.scene import SceneBuilder as JSceneBuilder
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.models import build_flagship
from fyrox_tpu_torch.models.character import build_pile_scene
from fyrox_tpu_torch.physics import narrowphase as tnarrow
from fyrox_tpu_torch.physics import shapes as sh
from fyrox_tpu_torch.physics import world as tworld
from fyrox_tpu_torch.physics.dim2 import Physics2DBuilder
from fyrox_tpu_torch.physics.world import PhysicsBuilder
from fyrox_tpu_torch.scene import SceneBuilder

torch.set_num_threads(2)

DT = 1.0 / 60.0
TOL = 1e-5
W = 4
TICKS = 20
STATE = ("position", "rotation", "linvel", "angvel")


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _max_diff(js, ts, fields=STATE):
    return max(float(np.abs(np.asarray(getattr(js, f))
                            - getattr(ts, f).numpy()).max()) for f in fields)


# ---- scenes: each takes either package's builder ------------------------

def mixed_cluster(pb, joint=False, com=False):
    """tests/test_oracle.py's mixed cluster (balls, cuboids, capsules on a
    halfspace); optionally a ball joint between two bodies and a collider
    offset (a COM offset) on one body."""
    rng = np.random.default_rng(3)
    g = pb.add_body(body_type=1)
    pb.add_collider(g, sh.HALFSPACE, [], friction=0.5, restitution=0.2)
    shapes = [(sh.BALL, [0.25]), (sh.CUBOID, [0.2, 0.25, 0.2]),
              (sh.CAPSULE, [0.2, 0.15])]
    for i in range(9):
        kind, params = shapes[i % 3]
        p = (rng.uniform(-0.8, 0.8), 0.5 + 0.5 * (i // 3),
             rng.uniform(-0.8, 0.8))
        b = pb.add_body(position=p)
        pb.add_collider(b, kind, params, friction=0.4, restitution=0.1,
                        offset=(0.06, 0.0, -0.03) if com and i == 4
                        else (0, 0, 0))
    if joint:
        pb.add_joint(0, 2, 3, anchor_a=(0.2, 0.0, 0.0),
                     anchor_b=(-0.2, 0.0, 0.0))
    return pb


def box_stack(pb):
    """tests/test_oracle.py's stack of three unit cubes."""
    g = pb.add_body(body_type=1)
    pb.add_collider(g, sh.HALFSPACE, [], friction=0.8)
    for k in range(3):
        b = pb.add_body(position=(0.02 * k, 0.55 + 1.08 * k, -0.01 * k))
        pb.add_collider(b, sh.CUBOID, [0.5, 0.5, 0.5], friction=0.8)
    return pb


def pile64(pb_cls, sb_cls, pile):
    sb = sb_cls()
    pb, _ = pile(sb, n_bodies=64, seed=1)
    return pb


def world_jitter(state, seed):
    """Per-world jitter (±3 cm, ±0.3 m/s) of the dynamic bodies of a
    JAX-package state with W worlds, as numpy."""
    rng = np.random.default_rng(seed)
    pos = np.array(state.position)
    vel = np.array(state.linvel)
    pos[:, 1:] += rng.uniform(-0.03, 0.03, pos[:, 1:].shape)
    vel[:, 1:] += rng.uniform(-0.3, 0.3, vel[:, 1:].shape)
    return state._replace(position=jnp.asarray(pos, jnp.float32),
                          linvel=jnp.asarray(vel, jnp.float32))


# ---- the builder's layout -------------------------------------------------

@pytest.mark.parametrize("scene", ["pile64", "mixed", "mixed_compacted"])
def test_builder_layout_equal(scene):
    if scene == "pile64":
        jpb = pile64(JPhysicsBuilder, JSceneBuilder, jax_pile)
        tpb = pile64(PhysicsBuilder, SceneBuilder, build_pile_scene)
        kw = {}
    else:
        jpb = mixed_cluster(JPhysicsBuilder(), joint=True, com=True)
        tpb = mixed_cluster(PhysicsBuilder(), joint=True, com=True)
        kw = dict(max_active_pairs=8) if scene == "mixed_compacted" else {}
    jt, tt = jpb.build(**kw), tpb.build(**kw)
    assert jt.grid is None and tt.grid is None          # "auto" → dense
    np.testing.assert_array_equal(tt.pair_a, jt.pair_a)
    np.testing.assert_array_equal(tt.pair_b, jt.pair_b)
    assert tt.pair_kind_ranges == jt.pair_kind_ranges
    assert tt.max_active_pairs == jt.max_active_pairs
    (ji, jk), (ti, tk) = jt.flat_layout(), tt.flat_layout()
    assert tk == jk
    np.testing.assert_array_equal(ti, ji)
    inc_a, inc_b = jt.incidence()
    np.testing.assert_array_equal(tt.contact_tables()["index"],
                                  np.concatenate([inc_a.argmax(1),
                                                  inc_b.argmax(1)]))
    for name in ("inv_mass", "inv_inertia_local", "com_local"):
        np.testing.assert_allclose(getattr(tt, name), getattr(jt, name),
                                   rtol=1e-6, atol=1e-7)
    js = jworld.init_physics_state(jpb, jt, 2)
    ts = tworld.init_physics_state(tpb, tt, 2, device="cpu")
    for f in ("warm_n", "warm_pair"):
        assert tuple(getattr(ts, f).shape) == getattr(js, f).shape
    if scene == "pile64":
        assert (jt.num_pairs, jk) == (2080, 3664)


# ---- narrowphase: the nine kind combos at random poses --------------------

COMBOS = [(sh.BALL, sh.BALL), (sh.BALL, sh.CUBOID), (sh.BALL, sh.CAPSULE),
          (sh.BALL, sh.HALFSPACE), (sh.CUBOID, sh.CUBOID),
          (sh.CUBOID, sh.CAPSULE), (sh.CUBOID, sh.HALFSPACE),
          (sh.CAPSULE, sh.CAPSULE), (sh.CAPSULE, sh.HALFSPACE)]
PARAMS = {sh.BALL: [0.3], sh.CUBOID: [0.3, 0.25, 0.2],
          sh.CAPSULE: [0.25, 0.15], sh.HALFSPACE: []}


def _random_rot(rng, shape):
    q = rng.normal(size=shape + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = np.moveaxis(q, -1, 0)
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2).astype(np.float32)


def _pair_inputs(combo, seed, w=2, p=24):
    rng = np.random.default_rng(seed)
    p6 = np.zeros((2, 6), np.float32)
    for i, k in enumerate(combo):
        p6[i, :len(PARAMS[k])] = PARAMS[k]
    pos_a = rng.uniform(-1, 1, (w, p, 3)).astype(np.float32)
    pos_b = (pos_a + rng.uniform(-0.6, 0.6, (w, p, 3))).astype(np.float32)
    rot_a, rot_b = _random_rot(rng, (w, p)), _random_rot(rng, (w, p))
    pred = rng.uniform(0.02, 0.1, (w, p)).astype(np.float32)
    pa6 = np.broadcast_to(p6[0], (1, p, 6)).copy()
    pb6 = np.broadcast_to(p6[1], (1, p, 6)).copy()
    return pa6, pos_a, rot_a, pb6, pos_b, rot_b, pred


def _close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_narrowphase_combo_matches(combo):
    """generate_contacts_flat (the kind's own routine on its slice) and
    generate_contacts (every routine, selected by kind): normals, points
    and depths within 1e-5, active equal."""
    args = _pair_inputs(combo, seed=sum(combo) * 7 + combo[0])
    p = args[1].shape[1]
    ranges = [(combo, 0, p)]
    jf = jnarrow.generate_contacts_flat(ranges, *map(jnp.asarray, args))
    tf = tnarrow.generate_contacts_flat(ranges, *map(torch.as_tensor, args))
    for k in ("normal", "point", "depth"):
        _close(tf[k].numpy(), np.asarray(jf[k]), k)
    np.testing.assert_array_equal(tf["active"].numpy(),
                                  np.asarray(jf["active"]))
    assert tf["active"].any() and not tf["active"].all()

    pa6, pos_a, rot_a, pb6, pos_b, rot_b, pred = args
    types = [np.full((2, p), k, np.int32) for k in combo]
    full = (types[0], np.broadcast_to(pa6, (2, p, 6)), pos_a, rot_a,
            types[1], np.broadcast_to(pb6, (2, p, 6)), pos_b, rot_b, pred)
    jm = jnarrow.generate_contacts(*map(jnp.asarray, full))
    tm = tnarrow.generate_contacts(*(torch.as_tensor(np.ascontiguousarray(x))
                                     for x in full))
    for k in ("normal", "points", "depth"):
        _close(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)), k)
    np.testing.assert_array_equal(tm.active.numpy(), np.asarray(jm.active))


def test_box_on_plane_takes_xla_corner_order():
    """A box resting flat on the plane has four corners at exactly one
    depth: the port keeps them in XLA top_k's order (lowest index first),
    so slots and warm starts line up with the JAX package's."""
    args = [np.zeros((1, 1, 6), np.float32), np.array([[[0, 0.3, 0]]]),
            np.eye(3)[None, None], np.zeros((1, 1, 6), np.float32),
            np.zeros((1, 1, 3)), np.eye(3)[None, None],
            np.full((1, 1), 0.05)]
    args[0][..., :3] = 0.3
    args = [np.asarray(a, np.float32) for a in args]
    ranges = [((sh.CUBOID, sh.HALFSPACE), 0, 1)]
    jf = jnarrow.generate_contacts_flat(ranges, *map(jnp.asarray, args))
    tf = tnarrow.generate_contacts_flat(ranges, *map(torch.as_tensor, args))
    np.testing.assert_array_equal(tf["point"].numpy(), np.asarray(jf["point"]))
    np.testing.assert_array_equal(tf["depth"].numpy(), np.asarray(jf["depth"]))


# ---- the step: one step and a trajectory ---------------------------------

@pytest.fixture(scope="module", params=["full", "compacted"])
def jointed_run(request):
    """The mixed cluster with a joint and a COM offset at W = 4 distinct
    worlds, full-layout or compacted (max_active_pairs = 8): JAX and port
    states over TICKS ticks from the same initial state."""
    kw = dict(max_active_pairs=8) if request.param == "compacted" else {}
    jpb = mixed_cluster(JPhysicsBuilder(), joint=True, com=True)
    tpb = mixed_cluster(PhysicsBuilder(), joint=True, com=True)
    jt, tt = jpb.build(**kw), tpb.build(**kw)
    js = world_jitter(jworld.init_physics_state(jpb, jt, W), seed=2)
    ts = convert.physics_state(_np(js), device="cpu")
    step = jax.jit(lambda s: jworld.step_physics(s, jt, DT))
    out = [(_np(js), ts)]
    for _ in range(TICKS):
        js, ts = step(js), tworld.step_physics(ts, tt, DT)
        out.append((_np(js), ts))
    return request.param, jt, tt, step, out


def test_one_step_from_identical_states(jointed_run):
    """One step from the JAX state after 10 ticks (contacts live, warm
    starts non-zero), carried into the port: within 1e-5."""
    mode, jt, tt, step, out = jointed_run
    js = out[10][0]
    ts = convert.physics_state(js, device="cpu")
    jn = _np(step(jax.tree_util.tree_map(jnp.asarray, js)))
    tn = tworld.step_physics(ts, tt, DT)
    assert float(np.asarray(js.warm_n).max()) > 0
    assert _max_diff(jn, tn) < TOL, mode
    assert _max_diff(jn, tn, ("warm_n", "warm_t1", "warm_t2")) < 1e-4, mode
    np.testing.assert_array_equal(tn.warm_pair.numpy(), jn.warm_pair)


# The trajectory bound: float32 rounding in another order, amplified by the
# contacts and the joint (its bias multiplies a position ulp by 0.2/h =
# 48 /s); measured up to 1.2e-4 over 20 ticks (velocities)
TRAJ_BOUND = 5e-4


def test_trajectory_within_bound(jointed_run):
    mode, jt, tt, step, out = jointed_run
    worst = max(_max_diff(j, t) for j, t in out)
    assert worst < TRAJ_BOUND, (mode, worst)
    js, ts = out[-1]
    np.testing.assert_array_equal(ts.warm_pair.numpy(), js.warm_pair)
    assert torch.unique(ts.position.flatten(1), dim=0).shape[0] == W


# ---- the oracle: the port's dense step against oracle_step ---------------

@pytest.mark.parametrize("scene,samples", [("stack", (0, 12, 24)),
                                           ("mixed", (0, 10, 24))])
def test_dense_step_matches_the_oracle(scene, samples):
    """From cold-warm-start states sampled along a short port trajectory,
    one port step against fyrox_tpu.physics.oracle.oracle_step (sequential
    float64, the same Jacobi semantics): within 1e-5, test_oracle.py's
    bar."""
    pb = box_stack(PhysicsBuilder()) if scene == "stack" else \
        mixed_cluster(PhysicsBuilder())
    t = pb.build(broadphase="dense")
    s = tworld.init_physics_state(pb, t, 1, device="cpu")
    worst = 0.0
    for i in range(max(samples) + 1):
        if i in samples:
            cold = s._replace(warm_n=torch.zeros_like(s.warm_n),
                              warm_t1=torch.zeros_like(s.warm_t1),
                              warm_t2=torch.zeros_like(s.warm_t2))
            dev = tworld.step_physics(cold, t, DT)
            ref = orc.oracle_step(orc.state_from_device(
                convert.to_numpy(cold)), t, DT)
            for f in ("position", "linvel", "angvel"):
                worst = max(worst, float(np.abs(
                    getattr(dev, f)[0].double().numpy()
                    - getattr(ref, f)).max()))
        s = tworld.step_physics(s, t, DT)
    assert worst < TOL, worst


# ---- conversion, dim2, the engine ----------------------------------------

def test_convert_dense_template_round_trip():
    """convert.physics_template carries a dense JAX template over: pair
    list, kind ranges, compaction width, joints; a step on the converted
    template equals a step on the port's own build bit for bit."""
    for kw in ({}, dict(max_active_pairs=8)):
        jpb = mixed_cluster(JPhysicsBuilder(), joint=True, com=True)
        tpb = mixed_cluster(PhysicsBuilder(), joint=True, com=True)
        jt, tt = jpb.build(**kw), tpb.build(**kw)
        ct = convert.physics_template(jt)
        assert ct.grid is None and ct.pair_kind_ranges == tt.pair_kind_ranges
        assert ct.max_active_pairs == tt.max_active_pairs
        np.testing.assert_array_equal(ct.pair_a, tt.pair_a)
        assert ct.joints.num_joints == 1
        s = tworld.init_physics_state(tpb, tt, 2, device="cpu")
        a, b = tworld.step_physics(s, ct, DT), tworld.step_physics(s, tt, DT)
        for f in STATE + ("warm_n",):
            assert torch.equal(getattr(a, f), getattr(b, f))


def _dim2_world(b):
    g = b.add_body(body_type=1)
    b.add_halfspace(g, friction=0.6)
    b.add_segment(g, (-3.0, 0.6), (-1.0, 0.2), thickness=0.05)
    c = b.add_body(position=(-2.0, 1.6))
    b.add_circle(c, 0.25)
    r = b.add_body(position=(0.5, 0.8), angle=0.3)
    b.add_rectangle(r, 0.3, 0.2)
    k = b.add_body(position=(1.5, 1.2))
    b.add_capsule(k, 0.2, 0.1)
    p0 = b.add_body(position=(2.6, 1.5))
    b.add_circle(p0, 0.15)
    b.add_revolute_joint(k, p0, anchor_a=(0.5, 0.0), anchor_b=(-0.6, 0.3))
    return b


def test_dim2_world_matches():
    """A dim2 world (circle, rectangle, capsule, segment, halfspace, a
    revolute joint) over 20 ticks: within 1e-4 of the JAX package's, and
    on the z = 0 plane; triangles and heightfields lower to a CONVEX prism
    and a HEIGHTFIELD collider (their steps: test_torch_convex.py)."""
    jb, tb = _dim2_world(JPhysics2DBuilder()), _dim2_world(Physics2DBuilder())
    jt, tt = jb.build(), tb.build()
    np.testing.assert_array_equal(tt.pair_a, jt.pair_a)
    js = jworld.init_physics_state(jb.pb, jt, 2)
    ts = tworld.init_physics_state(tb.pb, tt, 2, device="cpu")
    step = jax.jit(lambda s: jworld.step_physics(s, jt, DT))
    for _ in range(TICKS):
        js, ts = step(js), tworld.step_physics(ts, tt, DT)
    assert _max_diff(_np(js), ts) < 1e-4
    assert float(ts.position[..., 2].abs().max()) == 0.0
    tri = tb.add_triangle(0, (0, 0), (1, 0), (0, 1))
    hf = tb.add_heightfield(0, [0.0, 1.0], 2.0)
    assert [tb.pb._colliders[i]["shape"] for i in (tri, hf)] == \
        [sh.CONVEX, sh.HEIGHTFIELD]


def test_engine_step_on_small_dense_flagship():
    """Engine.step on build_flagship(n_bones=10, n_verts=300, n_bodies=16)
    (dense) for 5 ticks: the port's engine equals the JAX package's
    within 1e-4 (bodies) and 1e-5 (node globals of the first tick);
    world_health and restore_unhealthy take the dense state."""
    from fyrox_tpu_torch.engine import restore_unhealthy, world_health
    je, _ = jax_build_flagship(n_bones=10, n_verts=300, n_bodies=16)
    te, _ = build_flagship(n_bones=10, n_verts=300, n_bodies=16)
    assert te.physics.grid is None and te.physics.num_pairs == \
        je.physics.num_pairs
    js = je.init_state(num_worlds=2)
    ts = te.init_state(2, device="cpu")
    jstep = jax.jit(lambda s: je.step(s))
    for i in range(5):
        js, ts = jstep(js), te.step(ts)
        if i == 0:
            np.testing.assert_allclose(ts.scene.globals_.numpy(),
                                       np.asarray(js.scene.globals_),
                                       atol=1e-5)
    assert _max_diff(_np(js.physics), ts.physics) < 1e-4
    warm = ts.physics.warm_n.clone()
    warm[1, 0] = float("nan")
    sick = ts._replace(physics=ts.physics._replace(warm_n=warm))
    assert world_health(sick).tolist() == [True, False]
    fixed = restore_unhealthy(sick, ts)
    assert world_health(fixed).all() and torch.equal(fixed.physics.warm_n,
                                                     ts.physics.warm_n)
