"""Port parity: joints, centre-of-mass offsets and ragdolls (the jointed
slab path) of fyrox_tpu_torch against fyrox_tpu: builders, routes, staged
rollouts and ``drive_kinematic``. One solve is in test_torch_joint_solve.py,
the engine step in test_torch_joint_engine.py.

Scenes come from chip_smoke.py's helpers, built through both packages'
builders: the joint zoo (all four joint kinds, COM offsets), the jointed
flagship at a small size, and tests/test_pallas_solver.py's jointed chain.
The JAX side stays small: physics-only scenes of a few bodies."""
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import chip_smoke
from fyrox_tpu.models import character as jcharacter
from fyrox_tpu.physics import BALL as JBALL, CAPSULE as JCAPSULE
from fyrox_tpu.physics import CUBOID as JCUBOID, HALFSPACE as JHALFSPACE
from fyrox_tpu.physics import BodyType as JBodyType
from fyrox_tpu.physics import PhysicsBuilder as JPhysicsBuilder
from fyrox_tpu.physics import pallas_step as jpstep
from fyrox_tpu.physics import slab2 as jslab2
from fyrox_tpu.physics import world as jworld
from fyrox_tpu.physics.joints import JointKind as JJointKind
from fyrox_tpu.scene import RagdollBuilder as JRagdollBuilder
from fyrox_tpu.scene import SceneBuilder as JSceneBuilder
from fyrox_tpu.scene import drive_kinematic as jdrive
from fyrox_tpu.scene import graph as jgraph, init_state as jinit_state
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.physics import fused_step, slab2, tgs_kernel
from fyrox_tpu_torch.physics import world as tworld
from fyrox_tpu_torch.scene import drive_kinematic as tdrive
from fyrox_tpu_torch.scene import graph as tgraph, init_state as tinit_state

torch.set_num_threads(2)

DT = 1.0 / 60.0
JAX = types.SimpleNamespace(
    build_character_scene=jcharacter.build_character_scene,
    build_pile_scene=jcharacter.build_pile_scene,
    PhysicsBuilder=JPhysicsBuilder, SceneBuilder=JSceneBuilder,
    RagdollBuilder=JRagdollBuilder, BodyType=JBodyType, JointKind=JJointKind,
    BALL=JBALL, CAPSULE=JCAPSULE, CUBOID=JCUBOID, HALFSPACE=JHALFSPACE)
PORT = chip_smoke.port_lib()
SMALL = dict(n_bones=10, n_verts=300, n_bodies=24, chains=2, spines=1)
JOINT_FIELDS = ("kind", "body_a", "body_b", "anchor_a", "anchor_b", "axis_a",
                "ref_rot", "com_a", "com_b")
PHYS_FIELDS = ("body_type", "inv_mass", "inv_inertia_local", "com_local",
               "col_body", "col_shape", "col_params", "col_pos", "col_rot",
               "init_body_pos", "init_body_rot")


def _close(a, b, what, tol=1e-7):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=what)


def _same_physics(jt, tt):
    for f in PHYS_FIELDS:
        _close(getattr(jt, f), getattr(tt, f), f)
    for f in JOINT_FIELDS:
        _close(getattr(jt.joints, f), getattr(tt.joints, f), f"joints.{f}")


def _rotated_pairs(lib):
    """Bodies at seeded random orientations joined by all four kinds with
    the default (creation-time) reference rotation."""
    rng = np.random.default_rng(11)
    pb = lib.PhysicsBuilder()
    g = pb.add_body(body_type=lib.BodyType.STATIC)
    pb.add_collider(g, lib.HALFSPACE, [])
    bodies = []
    for i in range(8):
        q = rng.standard_normal(4)
        b = pb.add_body(position=(0.6 * i, 1.0, 0.0),
                        rotation=tuple(float(x) for x in q / np.linalg.norm(q)))
        pb.add_collider(b, lib.CUBOID, [0.2, 0.1, 0.15],
                        offset=tuple(rng.uniform(-0.1, 0.1, 3)))
        bodies.append(b)
    for i in range(7):
        pb.add_joint(i % 4, bodies[i], bodies[i + 1], anchor_a=(0.3, 0, 0),
                     anchor_b=(-0.3, 0, 0), axis=(0, 1, 0))
    return pb.build(broadphase="slab")


def _diagonal_ragdoll(lib):
    """A three-limb arm at an angle, with non-identity bind rotations."""
    sb = lib.SceneBuilder()
    pb = lib.PhysicsBuilder()
    rb = lib.RagdollBuilder(pb)
    pts = [(0.0, 1.0, 0.0), (0.3, 1.2, 0.1), (0.5, 1.0, 0.4), (0.2, 0.7, 0.6)]
    limbs = []
    for i in range(3):
        bone = sb.add_pivot(f"b{i}", position=pts[i])
        limbs.append(rb.add_limb(bone, pts[i], pts[i + 1], radius=0.05,
                                 parent=limbs[-1] if limbs else None,
                                 joint=("ball", "fixed", "revolute")[i],
                                 bind_rot=(0.0, 0.3826834, 0.0, 0.9238795)))
    return rb.build(), pb.build(broadphase="slab")


# ---- builders -------------------------------------------------------------

def test_joint_zoo_templates_equal():
    (_, jt), (_, tt) = chip_smoke.joint_zoo(JAX), chip_smoke.joint_zoo(PORT)
    assert sorted(set(tt.joints.kind.tolist())) == [0, 1, 2, 3]
    assert np.any(tt.com_local)
    _same_physics(jt, tt)


def test_default_reference_rotations_equal():
    jt, tt = _rotated_pairs(JAX), _rotated_pairs(PORT)
    assert not np.allclose(tt.joints.ref_rot[:, 3], 1.0)
    _same_physics(jt, tt)


def test_jointed_flagship_templates_equal():
    j = chip_smoke.jointed_flagship_scene(JAX, **SMALL)
    t = chip_smoke.jointed_flagship_scene(PORT, **SMALL)
    _same_physics(j[1], t[1])
    np.testing.assert_array_equal(j[0].parent, t[0].parent)
    for jr, tr in zip(j[7], t[7]):
        for f in ("bodies", "bones", "off_pos", "off_rot"):
            _close(getattr(jr, f), getattr(tr, f), f)


def test_ragdoll_offsets_equal():
    (jr, jt), (tr, tt) = _diagonal_ragdoll(JAX), _diagonal_ragdoll(PORT)
    assert not np.allclose(tr.off_rot[:, 3], 1.0)
    for f in ("bodies", "bones", "off_pos", "off_rot"):
        _close(getattr(jr, f), getattr(tr, f), f)
    _same_physics(jt, tt)


def test_convert_carries_joints_and_com():
    _, jt = chip_smoke.joint_zoo(JAX)
    _same_physics(jt, convert.physics_template(jt))


# ---- routes ---------------------------------------------------------------

@pytest.mark.parametrize("scene", ["joints", "com", "plain"])
def test_both_packages_route_alike(scene):
    """Joints or COM offsets keep both packages off the fused kernels."""
    def build(lib):
        pb = lib.PhysicsBuilder()
        g = pb.add_body(body_type=lib.BodyType.STATIC)
        pb.add_collider(g, lib.HALFSPACE, [])
        a = pb.add_body(position=(0, 1, 0))
        b = pb.add_body(position=(0.5, 1, 0))
        pb.add_collider(a, lib.BALL, [0.2],
                        offset=(0.1, 0, 0) if scene == "com" else (0, 0, 0))
        pb.add_collider(b, lib.BALL, [0.2])
        if scene == "joints":
            pb.add_joint(lib.JointKind.BALL, a, b, anchor_a=(0.25, 0, 0))
        return pb.build(broadphase="slab")

    jt, tt = build(JAX), build(PORT)
    assert jpstep.supports_fused(jslab2._ctx(jt), jt) == (scene == "plain")
    assert fused_step.supports_fused(tt) == (scene == "plain")


def test_jointed_template_takes_the_staged_route(monkeypatch):
    """fused=True on a jointed COM template runs the staged path (K1 with
    its joint tables) and never reaches a fused kernel."""
    pb, t = chip_smoke.joint_zoo(PORT)
    st = tworld.init_physics_state(pb.initial_pose(), t, 1, device="cpu")

    def refuse(*a, **k):
        raise AssertionError("a fused kernel was reached")

    for name in ("fused_step", "fused_full_step", "bp_candidates",
                 "narrow_compact"):
        monkeypatch.setattr(fused_step, name, refuse)
    seen = []
    solve = tgs_kernel.solve_tgs

    def spy(*a, **kw):
        seen.append((kw.get("has_com"), kw.get("joints")))
        return solve(*a, **kw)

    monkeypatch.setattr(tgs_kernel, "solve_tgs", spy)
    st = tworld.step_physics(st, t, DT, fused=True)
    assert torch.isfinite(st.position).all()
    assert len(seen) == 1 and seen[0][0] is True
    assert seen[0][1].body_a.shape[0] == t.joints.num_joints


def _long_chain(lib):
    """A 130-link ball chain (129 joints, each joining the links' centres
    0.3 m apart, so the chain pulls itself together) over a halfspace."""
    pb = lib.PhysicsBuilder()
    g = pb.add_body(body_type=lib.BodyType.STATIC)
    pb.add_collider(g, lib.HALFSPACE, [])
    prev = None
    for i in range(130):
        b = pb.add_body(position=(0.3 * i, 1.0, 0.0))
        pb.add_collider(b, lib.BALL, [0.1])
        if prev is not None:
            pb.add_joint(lib.JointKind.BALL, prev, b)
        prev = b
    return pb, pb.build(broadphase="slab")


def test_more_than_128_joints_raise():
    """More than 128 joints step: 10 ticks of the 129-joint chain on the
    port's staged route (the plain K1 solve with its joint passes) against
    the JAX package's step_physics, which sends more than its kernel's 128
    joints to its XLA joint passes (joints.solve_joints_velocity,
    joint_position_pass). Bounds: 3e-4 m in position, 2e-2 m/s in velocity
    (test_rollout_within_jax_bounds'); the collapsing chain makes contacts
    from the first ticks and parts the two packages' float32 rounding
    faster than a settled scene does, so it is held over 10 ticks."""
    from fyrox_tpu.physics import pallas_ops as jops
    from fyrox_tpu.physics import pallas_solver as jps
    jpb, jt = _long_chain(JAX)
    _, tt = _long_chain(PORT)
    _same_physics(jt, tt)
    assert tt.joints.num_joints == 129 and not jps.supports_kernel(jt, False)
    js = jworld.init_physics_state(jpb, jt, 2)
    ts = convert.physics_state(jax.tree_util.tree_map(np.asarray, js),
                               device="cpu")
    step = jax.jit(lambda s: jworld.step_physics(s, jt, DT))
    # pallas_ops._perm_idx caches by id() of a template's matrices: no
    # entry of this test's templates may outlive them and serve a later
    # template whose matrix takes the same id
    jops._PERM_CACHE.clear()
    try:
        for _ in range(10):
            js = step(js)
            ts = tworld.step_physics(ts, tt, DT)
    finally:
        jops._PERM_CACHE.clear()
    assert int((ts.warm_pair >= 0).sum()) > 0
    tp = ts.position.numpy()
    assert np.isfinite(tp).all()
    assert np.abs(np.asarray(js.position) - tp).max() < 3e-4
    assert np.abs(np.asarray(js.linvel) - ts.linvel.numpy()).max() < 2e-2


def test_chain_forest_steps_with_global_joint_tables():
    """chip_smoke.py's chain forest (1,024 joints, COM offsets), whose
    joint tables K1 keeps in global memory on the card, steps on the CPU
    through the plain solve: one staged tick at W = 1, finite, the chains
    hanging from their anchors."""
    pb, t = chip_smoke.chain_forest(PORT)
    cx = slab2._ctx(t)
    assert t.joints.num_joints == 1024 and cx.has_com
    assert tgs_kernel._layout(t.num_bodies, cx.cg, cx.s_active, True,
                              1024)[:2] == (False, True)
    st = tworld.init_physics_state(pb.initial_pose(), t, 1, device="cpu")
    p0 = st.position.clone()
    st = tworld.step_physics(st, t, DT)
    assert torch.isfinite(st.position).all()
    assert torch.isfinite(st.linvel).all()
    # every link moved, and every chain's tip stays within reach of its
    # anchor (test_rollout_within_jax_bounds' 2.6 m)
    anchors = chip_smoke.chain_anchor_bodies(t)
    assert len(anchors) == 256
    links = torch.as_tensor(t.body_type == 0)
    assert (st.position - p0)[0, links].norm(dim=-1).min() > 0
    tips = torch.as_tensor(anchors) + 4
    assert (st.position[0, tips] - st.position[0, anchors]).norm(
        dim=-1).max() < 2.6


# ---- rollouts -------------------------------------------------------------

def _jointed_scene(lib, with_com):
    """tests/test_pallas_solver.py:120-148 through `lib`'s builders."""
    pb = lib.PhysicsBuilder()
    g = pb.add_body(body_type=lib.BodyType.STATIC)
    pb.add_collider(g, lib.HALFSPACE, [], friction=0.6)
    k = lib.JointKind
    chip_smoke.add_chain(lib, pb, (0.0, 2.4, 0.0),
                         [k.REVOLUTE, k.BALL, k.REVOLUTE, k.BALL],
                         com=(0.06, -0.04, 0.02) if with_com else (0, 0, 0))
    fb = pb.add_body(position=(1.1, 3.2, 0.0))
    pb.add_collider(fb, lib.BALL, [0.2], friction=0.5, restitution=0.1)
    return pb, pb.build(broadphase="slab")


@pytest.mark.parametrize("with_com,dp_max", [(False, 1e-3), (True, 2e-3)])
def test_rollout_within_jax_bounds(with_com, dp_max):
    """40 staged steps of the jointed chain against the JAX package's
    step_physics, within its own kernel-vs-XLA bounds
    (test_pallas_solver.py:185-203)."""
    jpb, jt = _jointed_scene(JAX, with_com)
    _, tt = _jointed_scene(PORT, with_com)
    _same_physics(jt, tt)
    js = jworld.init_physics_state(jpb, jt, 2)
    ts = convert.physics_state(jax.tree_util.tree_map(np.asarray, js),
                               device="cpu")
    step = jax.jit(lambda s: jworld.step_physics(s, jt, DT))
    for _ in range(40):
        js = step(js)
        ts = tworld.step_physics(ts, tt, DT)
    jp, tp = np.asarray(js.position), ts.position.numpy()
    assert np.abs(jp - tp).max() < dp_max
    assert np.abs(np.asarray(js.linvel) - ts.linvel.numpy()).max() < 2e-2
    assert np.isfinite(tp).all()
    # the chain hangs: its tip within chain reach of the anchor
    assert np.linalg.norm(tp[0, 5] - np.asarray([0, 2.4, 0])) < 2.6


# ---- ragdolls and the engine ----------------------------------------------

def _spine(lib):
    sb = lib.SceneBuilder()
    pb = lib.PhysicsBuilder()
    g = pb.add_body(body_type=lib.BodyType.STATIC)
    pb.add_collider(g, lib.HALFSPACE, [], friction=0.8)
    rd = chip_smoke.add_spine(lib, sb, pb, 0.0, 0.0, "s")
    return sb.build(), pb, pb.build(broadphase="slab"), rd


def test_drive_kinematic_matches():
    jtpl, jpb, jt, jrd = _spine(JAX)
    ttpl, _, tt, trd = _spine(PORT)
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, jtpl.num_nodes, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    js = jinit_state(jtpl, 2)
    js = jgraph.update_hierarchical_data(js._replace(
        rotation=jnp.asarray(q)), jtpl)
    ts = tgraph.update_hierarchical_data(tinit_state(ttpl, 2, device="cpu")
                                         ._replace(rotation=torch.as_tensor(q)),
                                         ttpl)
    jp = jworld.init_physics_state(jpb, jt, 2)
    jp = jp._replace(position=jp.position + 5.0, linvel=jp.linvel + 1.0)
    tp = convert.physics_state(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    jout = jdrive(jp, js, jrd, jnp.asarray([True, False]))
    tout = tdrive(tp, ts, trd, torch.as_tensor([True, False]))
    for f in ("position", "rotation", "linvel", "angvel"):
        np.testing.assert_allclose(np.asarray(getattr(jout, f)),
                                   getattr(tout, f).numpy(), rtol=0,
                                   atol=1e-6, err_msg=f)
    assert np.allclose(tout.linvel[1, trd.bodies].numpy(), 0.0)
