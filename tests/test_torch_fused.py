"""Port parity: the fused route of the slab step (physics/fused_step.py; K3
fused_full_step_pallas and K2 fused_step_pallas of the JAX package) against
the JAX package on the CPU, where the port runs the kernels' plain versions.

Stages are held against the JAX kernels' own bodies, called as plain jnp
functions: ``pallas_step._bp_candidates`` (K3's broadphase) and
``pallas_step._narrow_compact`` (the narrowphase + compaction of K2/K3). One
whole step runs through the JAX K3 kernel in Pallas interpret mode (~35 s),
and the K2 route is held over 15 steps to the JAX staged path (its pile on
the platform is in contact from the first step; the jitted JAX step is
~0.5 s a tick on the CPU, ~2 s of CPU time)."""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fyrox_tpu.models import build_flagship as jax_build_flagship
from fyrox_tpu.physics import BALL as JBALL, CAPSULE as JCAPSULE
from fyrox_tpu.physics import CUBOID as JCUBOID, HALFSPACE as JHALFSPACE
from fyrox_tpu.physics import BodyType as JBodyType
from fyrox_tpu.physics import PhysicsBuilder as JPhysicsBuilder
from fyrox_tpu.physics import broadphase as jbp
from fyrox_tpu.physics import pallas_step as jps
from fyrox_tpu.physics import slab2 as jslab2
from fyrox_tpu.physics import world as jworld
from fyrox_tpu.physics.pallas_ops import pad_to
from fyrox_tpu.physics.pallas_solver import _C_NAMES
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.animation import machine as tmachine
from fyrox_tpu_torch.animation import track as ttrack
from fyrox_tpu_torch.models import build_flagship as torch_build_flagship
from fyrox_tpu_torch.physics import BALL, CAPSULE, CUBOID, HALFSPACE
from fyrox_tpu_torch.physics import BodyType, PhysicsBuilder
from fyrox_tpu_torch.physics import fused_step
from fyrox_tpu_torch.physics import world as tworld
from fyrox_tpu_torch.scene import camera as tcamera
from fyrox_tpu_torch.scene import init_state as tscene_init

torch.set_num_threads(2)

DT = 1.0 / 60.0
FLAGSHIP = dict(n_bones=10, n_verts=300, n_bodies=192)


def _pile(pb_cls, ball, cuboid, capsule, halfspace, static, n=24, seed=3,
          big_cuboid=False):
    """tests/test_pallas_step.py::_scene; with big_cuboid, the ground is a
    finite static cuboid platform (broadphase-big, not a halfspace) and the
    bodies start at seeded random orientations: a box landing flat on the
    platform is a tie between two face axes of the SAT, which float32
    rounding breaks differently in each package."""
    rng = np.random.default_rng(seed)
    pb = pb_cls()
    if big_cuboid:
        g = pb.add_body(body_type=static, position=(0.0, -0.2, 0.0))
        pb.add_collider(g, cuboid, [4.0, 0.2, 4.0], friction=0.7)
        rot_rng = np.random.default_rng(seed + 100)
    else:
        g = pb.add_body(body_type=static)
        pb.add_collider(g, halfspace, [], friction=0.7)
    for i in range(n):
        p = (rng.uniform(-1.5, 1.5), 0.4 + 0.45 * (i // 6),
             rng.uniform(-1.5, 1.5))
        q = (0.0, 0.0, 0.0, 1.0)
        if big_cuboid:
            q = rot_rng.standard_normal(4)
            q = tuple(float(x) for x in q / np.linalg.norm(q))
        b = pb.add_body(position=p, rotation=q)
        if i % 5 == 0:
            pb.add_collider(b, capsule, [0.15, 0.12], friction=0.5)
        elif i % 2:
            pb.add_collider(b, ball, [0.22], friction=0.5, restitution=0.2)
        else:
            pb.add_collider(b, cuboid, [0.18, 0.18, 0.18], friction=0.5)
    return pb, pb.build(broadphase="slab")


def _jax_pile(**kw):
    return _pile(JPhysicsBuilder, JBALL, JCUBOID, JCAPSULE, JHALFSPACE,
                 JBodyType.STATIC, **kw)


def _torch_pile(**kw):
    return _pile(PhysicsBuilder, BALL, CUBOID, CAPSULE, HALFSPACE,
                 BodyType.STATIC, **kw)


@functools.lru_cache(maxsize=None)
def _flagship_physics():
    """Both packages' flagship physics templates and the port's initial
    pose, built once for the file (the JAX build runs its hierarchy pass
    op by op); the callers only read them."""
    je, _ = jax_build_flagship(**FLAGSHIP)
    te, _ = torch_build_flagship(**FLAGSHIP)
    pose = te.init_state(1, device="cpu").physics
    return je.physics, te.physics, (pose.position[0].numpy(),
                                    pose.rotation[0].numpy())


# ---- scope ----------------------------------------------------------------

SCENES = {
    "flagship": _flagship_physics,
    "capsule_pile": lambda: (_jax_pile()[1], _torch_pile()[1], None),
    "big_cuboid_pile": lambda: (_jax_pile(big_cuboid=True)[1],
                                _torch_pile(big_cuboid=True)[1], None),
}


@pytest.mark.parametrize("scene", list(SCENES))
def test_scope_matches_jax(scene):
    jt, tt, _ = SCENES[scene]()
    jcx = jslab2._ctx(jt)
    want = (jps.supports_fused(jcx, jt), jps.supports_fused_bp(jcx, jt))
    assert (fused_step.supports_fused(tt),
            fused_step.supports_fused_bp(tt)) == want
    # K3 where every big collider is a halfspace; K2 on the platform
    assert want == (True, scene != "big_cuboid_pile")


# ---- stages against the JAX kernel bodies ---------------------------------

def _settled(tt, pose, w, steps, seed=0):
    """init_physics_state with seeded per-world jitter, then `steps` steps
    of the port's fused route (plain versions on the CPU)."""
    st = tworld.init_physics_state(pose, tt, w, device="cpu")
    rng = np.random.default_rng(seed)
    dyn = torch.as_tensor(tt.body_type == 0)[None, :, None].float()

    def noise(scale):
        return torch.as_tensor(rng.uniform(-scale, scale, st.position.shape)
                               .astype(np.float32)) * dyn

    st = st._replace(position=st.position + noise(0.05),
                     linvel=st.linvel + noise(0.5))
    for _ in range(steps):
        st = tworld.step_physics(st, tt, DT)
    return st


def _jax_stage_inputs(jt):
    """The statics of slab2._run_fused_step / _build_fused_bp_statics."""
    jcx = jslab2._ctx(jt)
    sc = jt.grid
    c, cg, b = jcx.c, jcx.cg, jcx.b
    cgp, cpp, bp = pad_to(cg, 128), pad_to(c, 128), pad_to(b, 128)
    layout, row0 = [], 0
    for cls in range(3):
        if sc.nslot(cls):
            layout.append((cls, sc.nslot(cls), row0))
            row0 += sc.nslot(cls)
    layout = tuple(layout)
    statics = jslab2._build_fused_bp_statics(jcx, sc, cpp, cgp, bp, layout)
    gi = jcx.grid_cols
    stj = np.zeros((10, cpp), np.float32)
    stj[0:6, :c] = jcx.params.T
    stj[6, :c], stj[7, :c] = jcx.fric, jcx.rest
    stj[8, :c], stj[9, :c] = jcx.kinds, jcx.col_body
    sti = np.zeros((10, cgp), np.float32)
    sti[0:6, :cg] = jcx.params[gi].T
    sti[6, :cg], sti[7, :cg] = jcx.fric[gi], jcx.rest[gi]
    sti[8, :cg], sti[9, :cg] = jcx.kinds[gi], gi
    margin = jt.allowed_linear_error + jworld.SPECULATIVE_MARGIN
    prm = np.concatenate([np.asarray(jslab2._kernel_params(jt, DT)),
                          np.array([margin, sc.cell, DT], np.float32)])
    dims = dict(c=c, cg=cg, b=b, cgp=cgp, cpp=cpp, bp=bp, s=jcx.s_active)
    return jcx, layout, statics, stj, sti, prm.astype(np.float32), dims


def _jax_stages(jt, body, warm_lam, warm_pid):
    """JAX _bp_candidates → _narrow_compact on each world (unpadded
    numpy): jv [W,NS,Cg], col [W,10,C], con [W,15,S,Cg], body_j, pid."""
    jcx, layout, statics, stj, sti, prm, d = _jax_stage_inputs(jt)
    sc = jt.grid
    inc_j, inc_gct, bp_sta_j, bp_sta_i, jv_big = (jnp.asarray(a)
                                                  for a in statics)
    c, cg, cgp = d["c"], d["cg"], d["cgp"]
    out = {k: [] for k in ("jv", "col", "con", "body_j", "pid")}
    for wi in range(body.shape[0]):
        bpl = np.zeros((29, d["bp"]), np.float32)
        bpl[:, :d["b"]] = body[wi]
        colj, coli, jall = jps._bp_candidates(
            jnp.asarray(prm), jnp.asarray(bpl), inc_j, inc_gct, bp_sta_j,
            bp_sta_i, jnp.asarray(sti), jv_big, cg=cgp, bp=d["bp"],
            cp_=d["cpp"], cg_real=cg, s_walk=int(sc.s_walk),
            class_layout=layout, nbig=int(sc.big_cols.size),
            tight_delta=(jworld.SPECULATIVE_MARGIN
                         - jworld.PREDICTION_DISTANCE),
            zbits=jbp._QBITS_Z, zfine_div=float(jbp._ZFINE))
        wl = np.zeros((3, d["s"], cgp), np.float32)
        wl[:, :, :cg] = warm_lam[wi]
        wp = np.full((d["s"], cgp), -2, np.int32)
        wp[:, :cg] = warm_pid[wi]
        con, (hi, lo), pid = jps._narrow_compact(
            jnp.asarray(prm), colj, jnp.asarray(stj), coli,
            jnp.asarray(sti), jall, jnp.asarray(wl), jnp.asarray(wp),
            s=d["s"], cg=cgp, bp=d["bp"], cp_=d["cpp"],
            num_colliders=sc.num_colliders, class_layout=layout,
            combos=jcx.combos)
        out["jv"].append(np.asarray(jall)[:, :cg])
        out["col"].append(np.asarray(colj)[:, :c])
        out["con"].append(np.stack([np.asarray(con[n])[:, :cg]
                                    for n in _C_NAMES]))
        out["body_j"].append((np.asarray(hi) * 128 + np.asarray(lo))[:, :cg])
        out["pid"].append(np.asarray(pid)[:, :cg])
    return {k: np.stack(v) for k, v in out.items()}


STAGE_CASES = [("flagship", 0), ("flagship", 20), ("capsule_pile", 20)]


@pytest.fixture(scope="module", params=STAGE_CASES,
                ids=[f"{s}-{n}steps" for s, n in STAGE_CASES])
def stages(request):
    scene, steps = request.param
    if scene == "flagship":
        jt, tt, pose = _flagship_physics()
    else:
        (_, jt), (tpb, tt) = _jax_pile(), _torch_pile()
        pose = tpb.initial_pose()
    st = _settled(tt, pose, 2, steps)
    accel, angvel = tworld.external_accelerations(st, tt, DT)
    body, warm_lam, warm_pid = fused_step._inputs(st, tt, accel, angvel)
    jv, col = fused_step.bp_candidates_plain(tt, body, DT)
    con, body_j, pid = fused_step.narrow_compact_plain(tt, col, jv, warm_lam,
                                                       warm_pid)
    port = dict(jv=jv, col=col, con=con, body_j=body_j, pid=pid)
    ref = _jax_stages(jt, body.numpy(), warm_lam.numpy(), warm_pid.numpy())
    return ref, {k: v.numpy() for k, v in port.items()}, steps


def test_bp_candidates_plain_matches_jax_kernel_body(stages):
    ref, port, _ = stages
    assert (ref["jv"] >= 0).sum() > 0
    np.testing.assert_array_equal(ref["jv"], port["jv"])        # integers
    np.testing.assert_allclose(ref["col"], port["col"], rtol=0, atol=1e-6)


def test_narrow_compact_plain_matches_jax_kernel_body(stages):
    ref, port, steps = stages
    np.testing.assert_array_equal(ref["pid"], port["pid"])
    np.testing.assert_array_equal(ref["body_j"], port["body_j"])
    act = _C_NAMES.index("actf")
    np.testing.assert_array_equal(ref["con"][:, act], port["con"][:, act])
    if steps:
        assert port["con"][:, act].sum() > 0
        # warm impulses carried into matched slots
        assert np.abs(port["con"][:, _C_NAMES.index("lam_n")]).sum() > 0
    # identical float32 op order: the planes agree to rounding
    np.testing.assert_allclose(ref["con"], port["con"], rtol=0, atol=1e-6)


# ---- one step through the JAX K3 kernel (Pallas interpret mode) -----------

def test_one_step_matches_jax_k3_in_interpret_mode(monkeypatch):
    (jpb, jt), (tpb, tt) = _jax_pile(n=12), _torch_pile(n=12)
    assert fused_step.supports_fused_bp(tt)
    st = _settled(tt, tpb.initial_pose(), 2, 20)
    cold = st._replace(warm_n=torch.zeros_like(st.warm_n),
                       warm_t1=torch.zeros_like(st.warm_t1),
                       warm_t2=torch.zeros_like(st.warm_t2))
    got = convert.to_numpy(tworld.step_physics(cold, tt, DT))

    calls = []
    real = jps.fused_full_step_pallas

    def spy(*a, **k):
        calls.append(k.get("interpret"))
        return real(*a, **k)

    monkeypatch.setattr(jps, "fused_full_step_pallas", spy)
    monkeypatch.setenv("FYROX_PALLAS_INTERPRET", "1")
    for k in ("FYROX_NO_FUSED_STEP", "FYROX_NO_PALLAS_SOLVER",
              "FYROX_FUSED_STEP", "FYROX_FUSED_BP"):
        monkeypatch.delenv(k, raising=False)
    js = jworld.init_physics_state(jpb, jt, 2)
    js = js._replace(**{f: jnp.asarray(getattr(convert.to_numpy(cold), f))
                        for f in ("position", "rotation", "linvel", "angvel",
                                  "warm_n", "warm_t1", "warm_t2",
                                  "warm_pair")})
    ref = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda s: jworld.step_physics(s, jt, DT))(js))
    assert calls == [True]                   # the K3 kernel, interpreted
    # one step of the same float32 math (test_pallas_step.py:102-110)
    np.testing.assert_allclose(ref.position, got.position, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ref.linvel, got.linvel, rtol=0, atol=1e-5)
    active = (np.abs(ref.warm_n) > 1e-7) | (np.abs(got.warm_n) > 1e-7)
    assert active.sum() > 0
    np.testing.assert_array_equal(ref.warm_pair[active], got.warm_pair[active])


# ---- the K2 route over 30 steps -------------------------------------------

def test_k2_route_matches_jax_staged_path(monkeypatch):
    (jpb, jt), (tpb, tt) = (_jax_pile(big_cuboid=True),
                            _torch_pile(big_cuboid=True))
    assert fused_step.supports_fused(tt) and not fused_step.supports_fused_bp(
        tt)
    for k in ("FYROX_PALLAS_INTERPRET", "FYROX_NO_FUSED_STEP"):
        monkeypatch.delenv(k, raising=False)
    js = jworld.init_physics_state(jpb, jt, 2)
    ts = convert.physics_state(jax.tree_util.tree_map(np.asarray, js),
                               device="cpu")
    routes = []
    real = fused_step.fused_step

    def spy(*a, **k):
        routes.append("K2")
        return real(*a, **k)

    monkeypatch.setattr(fused_step, "fused_step", spy)
    step = jax.jit(lambda s: jworld.step_physics(s, jt, DT))
    for _ in range(15):
        js = step(js)
        ts = tworld.step_physics(ts, tt, DT)
    assert routes == ["K2"] * 15
    ref = jax.tree_util.tree_map(np.asarray, js)
    got = convert.to_numpy(ts)
    # the reference's bounds between two implementations of a 30-step
    # trajectory (test_pallas_step.py:72-73), over 15 steps here
    assert np.abs(ref.position - got.position).max() < 5e-4
    assert np.abs(ref.linvel - got.linvel).max() < 5e-3
    assert np.isfinite(got.position).all()
    # the pile interacts: bodies moved and contacts are live
    assert np.abs(jpb.initial_pose()[0] - got.position).max() > 1e-3
    assert (got.warm_pair >= 0).sum() > 0


def test_fused_route_equals_staged_route_on_the_flagship():
    """K3's static halfspace rows give the staged path's contact set: the
    AABB test they skip only admits pairs whose manifolds are inactive."""
    _, tt, pose = _flagship_physics()
    a = _settled(tt, pose, 2, 0)
    b = a
    for _ in range(10):
        a = tworld.step_physics(a, tt, DT)
        b = tworld.step_physics(b, tt, DT, fused=False)
    assert (a.warm_pair >= 0).sum() > 0
    assert torch.equal(a.warm_pair, b.warm_pair)
    assert (a.position - b.position).abs().max() < 1e-6


# ---- entry points default to the card -------------------------------------

@pytest.mark.parametrize("entry", ["engine", "physics", "scene", "animation",
                                   "machine", "convert", "camera"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    e, _ = torch_build_flagship(**FLAGSHIP)
    calls = {
        "engine": lambda: e.init_state(2),
        "physics": lambda: tworld.init_physics_state(
            (e.physics.init_body_pos, e.physics.init_body_rot), e.physics,
            2),
        "scene": lambda: tscene_init(e.template, 2),
        "animation": lambda: ttrack.init_animation_state(e.animations, 2),
        "machine": lambda: tmachine.init_machine_state(e.machine, 2),
        "convert": lambda: convert.physics_state(
            convert.to_numpy(e.init_state(2, device="cpu").physics)),
        "camera": lambda: tcamera.perspective(1.2, 1.5, 0.05, 100.0),
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()
    assert e.init_state(2, device="cpu").physics.position.device.type == "cpu"


def test_sat_tie_inputs_round_as_unfused_jax():
    """The SAT of two near axis-aligned boxes (a box resting flat on a
    finite platform, where two face axes tie) rounds every operation as
    the JAX package does without XLA's fusion: under jax.disable_jit the
    two packages' rotations and manifolds are equal bit for bit. Jitted,
    XLA may fuse q_to_rot9's products into FMAs (one ulp apart on the
    axis-aligned pile's resting boxes), which is where that pile's
    trajectories part (ROADMAP queue 3)."""
    from fyrox_tpu.physics import np_planes as jnp_planes
    from fyrox_tpu.physics import planes as jplanes
    from fyrox_tpu_torch.physics import np_planes as tnp_planes
    from fyrox_tpu_torch.physics import planes as tplanes
    rng = np.random.default_rng(11)
    n = 64
    q = np.concatenate([rng.normal(0, 1e-4, (n, 3)), np.ones((n, 1))], -1)
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    pb = np.stack([rng.uniform(-3, 3, n), 0.18 + rng.normal(0, 1e-4, n),
                   rng.uniform(-3, 3, n)], -1).astype(np.float32)
    pa = np.tile(np.float32([0.0, -0.2, 0.0]), (n, 1))
    qa = np.tile(np.float32([0.0, 0.0, 0.0, 1.0]), (n, 1))
    ha, hb = (4.0, 0.2, 4.0), (0.18, 0.18, 0.18)

    def jax_side(pa, qa, pb, qb):
        sp = lambda x: tuple(x[:, i] for i in range(x.shape[1]))
        full = lambda h: tuple(jnp.full((n,), v, jnp.float32) for v in h)
        ra, rb = jplanes.q_to_rot9(sp(qa)), jplanes.q_to_rot9(sp(qb))
        return rb, jnp_planes.cuboid_cuboid_p(sp(pa), ra, full(ha), sp(pb),
                                              rb, full(hb), 0.002)

    with jax.disable_jit():
        jrb, jm = jax_side(*(jnp.asarray(x) for x in (pa, qa, pb, q)))
    sp = lambda x: tuple(torch.as_tensor(x[:, i].copy())
                         for i in range(x.shape[1]))
    full = lambda h: tuple(torch.full((n,), v) for v in h)
    trb = tplanes.q_to_rot9(sp(q))
    tm = tnp_planes.cuboid_cuboid_p(sp(pa), tplanes.q_to_rot9(sp(qa)),
                                    full(ha), sp(pb), trb, full(hb), 0.002)
    leaves = lambda t: [np.asarray(x) for x in jax.tree_util.tree_leaves(t)]
    for a, b in zip(leaves((jrb, jm)), leaves(convert.to_numpy((trb, tm)))):
        np.testing.assert_array_equal(a, b)
    assert (leaves(jm.active)[0] > 0.5).any()
