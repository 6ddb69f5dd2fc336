"""Port parity: convex hulls (fyrox_tpu_torch.physics.convex) and the dense
path with hulls and scenery, against fyrox_tpu on the CPU.

The same numpy-seeded inputs go through both packages: hull building
(scipy), the SAT, sphere and halfspace routines at random poses and at
exact ties (a cube registered as a hull resting on a box), the builder's
template with every collider kind, its conversion, the route decision,
dim2 triangles and heightfields, and one dense step and a 20-tick
trajectory of a small hull + heightfield + trimesh scene
(chip_smoke.terrain_pile). Single evaluations are held to 1e-5.

The routines at random poses run the JAX side eagerly
(``jax.disable_jit``), which rounds as PyTorch does: a hull face's
vertices lie at one depth in exact arithmetic, XLA's fused multiply-adds
part them by an ulp in another way than PyTorch's separate products, and
the 4 deepest of 12 tied vertices are then another 4 (both packages take
the lowest index among exact equals). The exact tie of a cube on a box,
where the tied values are bit-equal in both, runs jitted.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

import chip_smoke
from fyrox_tpu.physics import convex as jcx
from fyrox_tpu.physics import pallas_step as jpallas_step
from fyrox_tpu.physics import slab2 as jslab2
from fyrox_tpu.physics import world as jworld
from fyrox_tpu.physics.dim2 import Physics2DBuilder as JPhysics2DBuilder
from fyrox_tpu.physics.world import PhysicsBuilder as JPhysicsBuilder
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.physics import convex as tcx
from fyrox_tpu_torch.physics import fused_step
from fyrox_tpu_torch.physics import shapes as sh
from fyrox_tpu_torch.physics import world as tworld
from fyrox_tpu_torch.physics.dim2 import Physics2DBuilder
from fyrox_tpu_torch.physics.world import PhysicsBuilder

torch.set_num_threads(2)

DT = 1.0 / 60.0
TOL = 1e-5
STATE = ("position", "rotation", "linvel", "angvel")
# a small terrain pile: 16 bodies (cylinders, hull clouds, cones, balls,
# cuboids) over a 9 x 9 heightfield and the 4-triangle ramp
SMALL = dict(n_bodies=16, res=9, size=6.0, ramp=True,
             kinds={0: sh.CYLINDER, 2: sh.CONVEX, 4: sh.CONE})


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def assert_manifolds_match(jm, tm, tol=TOL):
    """Active flags equal; normals, points and depths within tol."""
    np.testing.assert_array_equal(tm.active.numpy(), np.asarray(jm.active))
    for f in ("normal", "points", "depth"):
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   np.asarray(getattr(jm, f)), atol=tol,
                                   rtol=0, err_msg=f)


# ---- hull building (host) ------------------------------------------------

def test_hull_building_matches():
    """hull_from_points, prism / cone hulls, hull_edge_dirs, hull_mass and
    the padded ConvexSet equal the JAX package's arrays exactly."""
    rng = np.random.default_rng(0)
    clouds = [rng.normal(size=(n, 3)) * 0.3 for n in (6, 12, 24)]
    jb, tb = jcx.ConvexBuilder(), tcx.ConvexBuilder()
    for pts in clouds:
        jb.add(pts)
        tb.add(pts)
        np.testing.assert_array_equal(tcx.hull_edge_dirs(pts),
                                      jcx.hull_edge_dirs(pts))
    for fn in ("prism_hull", "cone_hull"):
        j = getattr(jcx, fn)(0.3, 0.2, n=12)
        t = getattr(tcx, fn)(0.3, 0.2, n=12)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b, a)
        jb.add(*j)
        tb.add(*t)
        jm, tm = jcx.hull_mass(*j, 2.0), tcx.hull_mass(*t, 2.0)
        for a, b in zip(jm, tm):
            np.testing.assert_array_equal(b, a)
    for a, b in zip(jb.build(), tb.build()):
        np.testing.assert_array_equal(b, a)


# ---- the routines ----------------------------------------------------------

def _hull_pair_inputs(seed, w=3, p=40):
    """Random hull poses in contact range: hull indices into a set of a
    cloud, a 12-gon prism and a 12-gon pyramid."""
    rng = np.random.default_rng(seed)
    b = jcx.ConvexBuilder()
    b.add(rng.normal(size=(12, 3)) * 0.3)
    b.add(*jcx.prism_hull(0.3, 0.2, 12))
    b.add(*jcx.cone_hull(0.3, 0.2, 12))
    cs = b.build()
    ha, hb = rng.integers(0, 3, p), rng.integers(0, 3, p)
    pa = (rng.normal(size=(w, p, 3)) * 0.3).astype(np.float32)
    pb = (pa + rng.normal(size=(w, p, 3)) * 0.3).astype(np.float32)
    ra = Rotation.random(w * p, random_state=seed).as_matrix()
    rb = Rotation.random(w * p, random_state=seed + 1).as_matrix()
    ra = ra.reshape(w, p, 3, 3).astype(np.float32)
    rb = rb.reshape(w, p, 3, 3).astype(np.float32)
    pred = rng.uniform(0.02, 0.1, (w, p)).astype(np.float32)
    hull_a = [x[ha][None] for x in cs]
    hull_b = [x[hb][None] for x in cs]
    return pa, ra, hull_a, pb, rb, hull_b, pred


@pytest.mark.parametrize("routine", ["convex_convex", "ball_convex",
                                     "convex_halfspace", "box_convex"])
def test_routine_matches_at_random_poses(routine):
    pa, ra, ha, pb, rb, hb, pred = _hull_pair_inputs(seed=len(routine))
    if routine == "convex_convex":
        args = (pa, ra, *ha, pb, rb, *hb, pred)
    elif routine == "ball_convex":
        args = (pa, np.float32(0.2), pb, rb, *hb, pred)
    elif routine == "convex_halfspace":
        args = (pa, ra, *ha[:2], pb, rb, pred)
    else:
        half = np.full((1, pa.shape[1], 3), 0.2, np.float32)
        jb = jcx.box_as_hull(jnp.asarray(half))
        tb = tcx.box_as_hull(_t(half))
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        args = (pa, ra, *map(np.asarray, jb), pb, rb, *hb, pred)
        routine = "convex_convex"
    with jax.disable_jit():
        jm = getattr(jcx, routine)(*args)
    tm = getattr(tcx, routine)(*map(_t, args))
    assert np.asarray(jm.active).any()
    assert_manifolds_match(jm, tm)


def test_cube_hull_resting_on_box_ties():
    """A cube registered as a hull resting on a box: face axes tie exactly
    (the +y face of one, the -y face of the other) and four vertices share
    one depth; the port picks the same axis and the same points, in XLA's
    order, as the JAX package."""
    cube = np.array([[x, y, z] for x in (-0.2, 0.2) for y in (-0.2, 0.2)
                     for z in (-0.2, 0.2)])
    b = jcx.ConvexBuilder()
    b.add(cube)
    cs = b.build()
    hull = [x[[0, 0]][None] for x in cs]
    pa = np.array([[[0, 0.39, 0], [0.05, 0.395, -0.03]]], np.float32)
    pb = np.zeros((1, 2, 3), np.float32)
    rot = np.broadcast_to(np.eye(3, dtype=np.float32), (1, 2, 3, 3)).copy()
    pred = np.full((1, 2), 0.05, np.float32)
    half = np.full((1, 2, 3), 0.2, np.float32)
    box = list(map(np.asarray, jcx.box_as_hull(jnp.asarray(half))))
    args = (pa, rot, *hull, pb, rot, *box, pred)
    jm = jax.jit(jcx.convex_convex)(*args)
    tm = tcx.convex_convex(*map(_t, args))
    for f in ("normal", "points", "depth", "active"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)), f)
    assert np.asarray(jm.active).sum() == 8


# ---- the builder, conversion and the route ----------------------------------

def _small(lib_pb, **kw):
    pb = chip_smoke.terrain_pile(lib_pb, **SMALL)
    return pb, pb.build(**kw)


def _every_kind(pb):
    """One collider of every kind add_collider takes, on both packages."""
    g = pb.add_body(body_type=1)
    pb.add_collider(g, sh.HALFSPACE, [])
    pb.add_collider(g, sh.TRIANGLE, points=[(0, 0, 0), (1, 0, 0), (0, 0, 1)])
    pb.add_collider(g, sh.HEIGHTFIELD, heights=chip_smoke.hills(5, 4.0),
                    size=(4.0, 4.0))
    pb.add_collider(g, sh.TRIMESH, triangles=chip_smoke.RAMP)
    shapes = [(sh.BALL, [0.2]), (sh.CUBOID, [0.2, 0.1, 0.3]),
              (sh.CAPSULE, [0.2, 0.1]), (sh.CYLINDER, [0.2, 0.15]),
              (sh.CONE, [0.25, 0.2]), (sh.SEGMENT, [0.3])]
    for i, (k, p) in enumerate(shapes):
        b = pb.add_body(position=(i * 0.6, 1.0, 0.0))
        pb.add_collider(b, k, p, offset=(0.05, 0, 0) if i == 2 else (0, 0, 0))
    b = pb.add_body(position=(0, 2, 1))
    pb.add_collider(b, sh.CONVEX, points=np.random.default_rng(4).normal(
        size=(10, 3)) * 0.2)
    pb.add_collider(b, sh.SEGMENT, points=[(0, 0, 0), (0.3, 0.2, 0.1)])
    return pb


@pytest.mark.parametrize("broadphase", ["dense", "slab"])
def test_convert_hull_scenery_template(broadphase):
    """Every collider kind on either broadphase: the JAX template
    converted equals the port builder's template field by field (hulls,
    heightfields, trimeshes, masses and inertias from the hull geometry),
    and a step on the converted template equals one on the port's own bit
    for bit."""
    jpb, tpb = _every_kind(JPhysicsBuilder()), _every_kind(PhysicsBuilder())
    jt, tt = jpb.build(broadphase=broadphase), tpb.build(broadphase=broadphase)
    ct = convert.physics_template(jt)
    for f in dataclasses.fields(tt):
        a, b = getattr(tt, f.name), getattr(ct, f.name)
        if f.name == "hulls":
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif f.name == "grid" and a is not None:
            for g in ("grid_cols", "big_cols", "kinds", "sweep_cap"):
                np.testing.assert_array_equal(getattr(a, g), getattr(b, g))
            assert a.s_class == b.s_class and a.cell == b.cell
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, f.name)
        elif f.name not in ("grid", "joints"):
            assert a == b, f.name
    s = tworld.init_physics_state(tpb, tt, 2, device="cpu")
    x, y = tworld.step_physics(s, ct, DT), tworld.step_physics(s, tt, DT)
    for f in STATE + ("warm_n",):
        assert torch.equal(getattr(x, f), getattr(y, f))


def test_route_matches_the_jax_package():
    """A hull template and a heightfield template take the staged route in
    both packages (no K2 / K3); a primitive slab scene with cylinders
    keeps the fused routes in both."""
    hull_kinds = {0: sh.CONVEX}
    for ramp, kinds, fused in ((False, hull_kinds, False),
                               (False, {}, False),
                               (None, {4: sh.CYLINDER}, True)):
        scene = dict(SMALL, ramp=bool(ramp), kinds=kinds, n_bodies=12)
        if ramp is None:          # no scenery: a halfspace ground
            jpb, tpb = JPhysicsBuilder(), PhysicsBuilder()
            for pb in (jpb, tpb):
                g = pb.add_body(body_type=1)
                pb.add_collider(g, sh.HALFSPACE, [])
                for i in range(12):
                    b = pb.add_body(position=(0.6 * i, 1.0, 0.0))
                    k, p = ((sh.CYLINDER, [0.2, 0.2]) if i % 4 == 0
                            else (sh.BALL, [0.25]))
                    pb.add_collider(b, k, p)
        else:
            jpb = chip_smoke.terrain_pile(JPhysicsBuilder(), **scene)
            tpb = chip_smoke.terrain_pile(PhysicsBuilder(), **scene)
        jt, tt = jpb.build(broadphase="slab"), tpb.build(broadphase="slab")
        jc = jslab2._ctx(jt)
        assert jpallas_step.supports_fused(jc, jt) == \
            fused_step.supports_fused(tt) == fused
        assert jpallas_step.supports_fused_bp(jc, jt) == \
            fused_step.supports_fused_bp(tt) == fused


# ---- the dense step ----------------------------------------------------------

@pytest.fixture(scope="module")
def dense_run():
    """The small terrain pile, W = 2 distinct worlds: the JAX states of a
    jitted dense step over 40 ticks (contacts with hulls, the heightfield
    and the ramp from tick ~14)."""
    jpb, jt = _small(JPhysicsBuilder())
    tpb, tt = _small(PhysicsBuilder())
    assert tt.grid is None and tt.pair_kind_ranges == jt.pair_kind_ranges
    js = jworld.init_physics_state(jpb, jt, 2)
    js = js._replace(position=js.position.at[1].add(0.01))
    step = jax.jit(lambda s: jworld.step_physics(s, jt, DT))
    states = [_np(js)]
    for _ in range(40):
        js = step(js)
        states.append(_np(js))
    return jt, tt, step, states


def _diff(js, ts, fields=("position",)):
    return max(float(np.abs(np.asarray(getattr(js, f))
                            - getattr(ts, f).numpy()).max()) for f in fields)


def test_dense_step_matches(dense_run):
    """One step from JAX states with live hull, heightfield and trimesh
    contacts (ticks 18 and 24) carried into the port: positions within
    1e-5, pair slots equal."""
    jt, tt, step, states = dense_run
    for tick in (18, 24):
        js = states[tick]
        assert np.asarray(js.warm_n).max() > 0
        ts = convert.physics_state(js, device="cpu")
        jn = _np(step(jax.tree_util.tree_map(jnp.asarray, js)))
        tn = tworld.step_physics(ts, tt, DT)
        assert _diff(jn, tn) < TOL, tick
        np.testing.assert_array_equal(tn.warm_pair.numpy(), jn.warm_pair)


def test_dense_trajectory_within_bound(dense_run):
    """20 port ticks from the JAX state at tick 14 (the first contacts)
    against the JAX trajectory: positions within 1e-4 m."""
    jt, tt, step, states = dense_run
    ts = convert.physics_state(states[14], device="cpu")
    worst = 0.0
    for tick in range(15, 35):
        ts = tworld.step_physics(ts, tt, DT)
        worst = max(worst, _diff(states[tick], ts))
    assert worst < 1e-4, worst
    assert torch.unique(ts.position.flatten(1), dim=0).shape[0] == 2


# ---- dim2 -------------------------------------------------------------------

def _dim2(b):
    g = b.add_body(body_type=1)
    b.add_heightfield(g, [0.0, 0.3, 0.1, 0.4, 0.0], 6.0)
    b.add_triangle(g, (1.5, 0.5), (2.5, 0.5), (2.0, 1.0))
    for i in range(4):
        d = b.add_body(position=(-1.0 + 0.9 * i, 0.75 + 0.15 * i))
        if i % 2:
            b.add_triangle(d, (-0.2, -0.15), (0.2, -0.15), (0.0, 0.2))
        else:
            b.add_circle(d, 0.2)
    return b


def test_dim2_triangles_and_heightfield_match():
    """A Physics2DBuilder world with a 1D heightfield, a static and two
    dynamic triangles: equal templates, and 20 ticks within 1e-4 m (the
    bound of test_torch_dense.py's dim2 world). From the first hull
    contact (tick 11) the jitted JAX step parts from the eager one by
    ~1.5e-5 m a tick (fused multiply-adds, 7.3e-5 at tick 20); the port
    equals the eager JAX step within 6e-8 m through tick 23."""
    jb, tb = _dim2(JPhysics2DBuilder()), _dim2(Physics2DBuilder())
    jt, tt = jb.build(), tb.build()
    ct = convert.physics_template(jt)
    for f in ("col_shape", "col_params", "col_hull", "hf_heights", "col_hf",
              "inv_mass", "inv_inertia_local", "com_local"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(ct, f), f)
    js = jworld.init_physics_state(jb.pb, jt, 1)
    ts = tworld.init_physics_state(tb.pb, tt, 1, device="cpu")
    step = jax.jit(lambda s: jworld.step_physics(s, jt, DT))
    worst = 0.0
    for _ in range(20):
        js, ts = step(js), tworld.step_physics(ts, tt, DT)
        worst = max(worst, _diff(_np(js), ts))
    assert worst < 1e-4, worst
    assert float(np.asarray(js.warm_n).max()) > 0
