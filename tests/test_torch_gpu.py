"""CUDA kernels of fyrox_tpu_torch against their plain PyTorch versions.

These tests need a CUDA card and the CUDA toolkit; elsewhere they skip.
This file imports no JAX, so on a machine without JAX run it without the
suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

from fyrox_tpu_torch import convert
from fyrox_tpu_torch.models import build_flagship
from fyrox_tpu_torch.physics import (BALL, CAPSULE, CUBOID, HALFSPACE,
                                     BodyType, PhysicsBuilder)
from fyrox_tpu_torch.physics import fused_step, plane_ops, slab2, tgs_kernel
from fyrox_tpu_torch.physics import world as phys_mod

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    from fyrox_tpu_torch import disable_tf32
    disable_tf32()
    return torch.device("cuda")


@pytest.mark.parametrize("w,a,n,k,tables", [
    (4, 19, 1001, 13000, 4), (2, 10, 1000, 48000, 2), (3, 1, 7, 5, 3),
    (4, 4, 16641, 12000, 1), (4, 256, 1001, 3000, 1)])
def test_plane_gather_kernel_is_bit_exact(cuda, w, a, n, k, tables):
    """Per-world planes, and one table every world reads (world stride 0:
    a heightfield's corner heights, the hull rows)."""
    rng = np.random.default_rng(k)
    planes = torch.as_tensor(rng.standard_normal((tables, a, n)).astype(
        np.float32), device=cuda)
    idx = torch.as_tensor(rng.integers(-n // 4, n + n // 4, (w, k)).astype(
        np.int32), device=cuda)
    before = plane_ops.launches("plane_gather")
    got = plane_ops.plane_gather(planes, idx)
    assert plane_ops.launches("plane_gather") == before + 1
    assert torch.equal(got, plane_ops.plane_gather_plain(planes, idx))


def test_plane_gather_kernel_rejects_bad_inputs(cuda):
    planes = torch.zeros((2, 3, 10), device=cuda)
    with pytest.raises(TypeError):
        plane_ops.plane_gather(planes, torch.zeros((2, 4), dtype=torch.int64,
                                                   device=cuda))
    with pytest.raises(ValueError):
        plane_ops.plane_gather(planes.transpose(1, 2),
                               torch.zeros((2, 4), dtype=torch.int32,
                                           device=cuda))


@pytest.mark.parametrize("w,a,n", [(128, 16, 1000), (4, 10, 300),
                                   (3, 40, 7)])
def test_plane_scatter_kernel_is_bit_exact_on_a_permutation(cuda, w, a, n):
    rng = np.random.default_rng(n)
    vals = torch.as_tensor(rng.standard_normal((w, a, n)).astype(np.float32),
                           device=cuda)
    idx = torch.as_tensor(np.stack([rng.permutation(n) for _ in range(w)])
                          .astype(np.int32), device=cuda)
    before = plane_ops.launches("plane_scatter")
    got = plane_ops.plane_scatter(vals, idx, n)
    assert plane_ops.launches("plane_scatter") == before + 1
    assert torch.equal(got, plane_ops.plane_scatter_plain(vals, idx, n))
    # the broadphase's use: rows into key order
    x = vals.transpose(1, 2).contiguous()
    assert torch.equal(plane_ops.scatter_rows(x, idx, n),
                       plane_ops.scatter_rows(x, idx, n, plain=True))


def test_plane_scatter_kernel_with_repeats(cuda):
    rng = np.random.default_rng(5)
    w, a, k, n = 8, 16, 3000, 1000
    vals = torch.as_tensor(rng.standard_normal((w, a, k)).astype(np.float32),
                           device=cuda)
    idx = torch.as_tensor(rng.integers(-50, n + 50, (w, k)).astype(np.int32),
                          device=cuda)
    got = plane_ops.plane_scatter(vals, idx, n)
    again = plane_ops.plane_scatter(vals, idx, n)
    assert torch.equal(got, again)          # a fixed order of sums
    ref = plane_ops.plane_scatter_plain(vals, idx, n)
    assert (got - ref).abs().max().item() <= 1e-6 * max(
        1.0, ref.abs().max().item())


def test_plane_scatter_kernel_rejects_bad_inputs(cuda):
    vals = torch.zeros((2, 3, 10), device=cuda)
    idx = torch.zeros((2, 10), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        plane_ops.plane_scatter(vals.double(), idx, 5)
    with pytest.raises(TypeError):
        plane_ops.plane_scatter(vals, idx.long(), 5)
    with pytest.raises(ValueError):
        plane_ops.plane_scatter(vals, idx[:, :4].contiguous(), 5)
    with pytest.raises(ValueError):
        plane_ops.plane_scatter(vals.transpose(1, 2).contiguous()
                                .transpose(1, 2), idx, 5)
    with pytest.raises(ValueError):
        plane_ops.plane_scatter(vals, idx.cpu(), 5)


def _all_differ(x):
    return torch.unique(x.flatten(1), dim=0).shape[0] == x.shape[0]


@pytest.fixture
def settled(cuda):
    """Packed solver inputs of a small flagship after 30 ticks, in 8
    worlds made to differ by seeded jitter of the dynamic bodies' poses
    and velocities, so a kernel that reads another world's slice fails."""
    engine, _ = build_flagship(n_bones=10, n_verts=300, n_bodies=192)
    st = engine.init_state(8, device=cuda)
    rng = np.random.default_rng(3)
    dyn = torch.as_tensor(engine.physics.body_type == phys_mod.DYNAMIC,
                          device=cuda)[None, :, None].float()

    def noise(scale):
        return torch.as_tensor(rng.uniform(-scale, scale, (8, dyn.shape[1], 3))
                               .astype(np.float32), device=cuda) * dyn

    st = st._replace(physics=st.physics._replace(
        position=st.physics.position + noise(0.05),
        linvel=st.physics.linvel + noise(0.5)))
    for _ in range(30):
        st = engine.step(st)
    t = engine.physics
    accel, angvel = phys_mod.external_accelerations(st.physics, t,
                                                    engine.dt)
    packed, _ = slab2.solver_inputs(st.physics, t, engine.dt, accel, angvel)
    assert _all_differ(packed[0]) and _all_differ(packed[2])
    return packed, tgs_kernel.solver_params(t, engine.dt)


def test_tgs_kernel_matches_plain(settled):
    packed, params = settled
    assert packed[0][:, 9].sum() > 0
    body, lam = tgs_kernel.solve_tgs(*packed, params)
    ref_b, ref_l = tgs_kernel.solve_tgs_plain(*packed, params)
    # one step of the same solve in another summation order: ten times
    # the JAX package's one-step bounds between its two implementations
    assert (body[:, 6:13] - ref_b[:, 6:13]).abs().max() < 1e-5
    assert (body[:, 0:6] - ref_b[:, 0:6]).abs().max() < 1e-4
    assert ((lam - ref_l).abs() <= 1e-3 * ref_l.abs() + 1e-5).all()


def test_tgs_kernel_repeats_bit_for_bit(settled):
    packed, params = settled
    a = tgs_kernel.solve_tgs(*packed, params)
    b = tgs_kernel.solve_tgs(*packed, params)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_tgs_kernel_refuses_oversized_worlds(settled):
    """K1 takes any body count (the global-memory variant), but a slot
    buffer of one collider's slots must fit a block's shared memory."""
    packed, params = settled
    body = packed[2][:1].contiguous()
    s = 10_000                              # 240 KB of slot buffer
    con = torch.zeros((1, 15, s, 1), device=body.device)
    body_j = torch.zeros((1, s, 1), dtype=torch.int32, device=body.device)
    col_body = torch.zeros((1,), dtype=torch.int32, device=body.device)
    with pytest.raises(ValueError, match="shared"):
        tgs_kernel.solve_tgs(con, body_j, body, col_body, params)


def test_tgs_kernel_visits_the_live_slots(settled):
    packed, params = settled
    tgs_kernel.solve_tgs(*packed, params)
    live = tgs_kernel.live_slots(packed[0])
    assert torch.equal(tgs_kernel.visited_slots(), live)
    assert 0 < int(live.sum()) < packed[0][:, 9].numel()


# ---- K1 with joint tables and COM planes ---------------------------------

@pytest.fixture
def jointed(cuda):
    """Packed solver inputs and joint tables of the joint zoo (all four
    joint kinds, COM offsets) after 30 ticks, in 8 worlds jittered apart."""
    import chip_smoke
    pb, t = chip_smoke.joint_zoo(chip_smoke.port_lib())
    st = phys_mod.init_physics_state(pb.initial_pose(), t, 8, device=cuda)
    st = chip_smoke.jitter(st, t, cuda, 3)
    for _ in range(30):
        st = phys_mod.step_physics(st, t, 1 / 60)
    accel, angvel = phys_mod.external_accelerations(st, t, 1 / 60)
    packed, _ = slab2.solver_inputs(st, t, 1 / 60, accel, angvel)
    cx = slab2._ctx(t)
    assert cx.has_com and _all_differ(packed[2])
    return (packed, tgs_kernel.solver_params(t, 1 / 60),
            dict(has_com=True, joints=slab2.joint_tables(cx, cuda)))


def test_tgs_kernel_with_joints_matches_plain(jointed):
    packed, params, kw = jointed
    before = tgs_kernel.launches()
    body, lam = tgs_kernel.solve_tgs(*packed, params, **kw)
    assert tgs_kernel.launches() == before + 1
    ref_b, ref_l = tgs_kernel.solve_tgs_plain(*packed, params, **kw)
    # K1's bounds (test_tgs_kernel_matches_plain)
    assert (body[:, 6:13] - ref_b[:, 6:13]).abs().max() < 1e-5
    assert (body[:, 0:6] - ref_b[:, 0:6]).abs().max() < 1e-4
    assert ((lam - ref_l).abs() <= 1e-3 * ref_l.abs() + 1e-5).all()
    # the joint passes and the COM terms matter at this state
    free, _ = tgs_kernel.solve_tgs(*packed, params)
    assert (free[:, 0:6] - body[:, 0:6]).abs().max() > 1e-2


def test_tgs_kernel_with_joints_repeats_bit_for_bit(jointed):
    packed, params, kw = jointed
    a = tgs_kernel.solve_tgs(*packed, params, **kw)
    b = tgs_kernel.solve_tgs(*packed, params, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_tgs_kernel_refuses_more_than_128_joints(cuda):
    """More than 128 joints run on the card: the chain forest (1,024
    joints, COM offsets) after 20 ticks in 8 jittered worlds, whose joint
    tables K1 keeps in global memory, matches plain at chip_smoke.py
    K1joint's bounds."""
    import chip_smoke
    pb, t = chip_smoke.chain_forest(chip_smoke.port_lib())
    st = chip_smoke.jitter(phys_mod.init_physics_state(
        pb.initial_pose(), t, 8, device=cuda), t, cuda, 3)
    for _ in range(20):
        st = phys_mod.step_physics(st, t, 1 / 60)
    accel, angvel = phys_mod.external_accelerations(st, t, 1 / 60)
    packed, _ = slab2.solver_inputs(st, t, 1 / 60, accel, angvel)
    cx = slab2._ctx(t)
    nj = t.joints.num_joints
    assert nj >= 1000 and _all_differ(packed[2])
    assert tgs_kernel._layout(t.num_bodies, cx.cg, cx.s_active, True,
                              nj)[:2] == (False, True)
    params = tgs_kernel.solver_params(t, 1 / 60)
    kw = dict(has_com=True, joints=slab2.joint_tables(cx, cuda))
    before = tgs_kernel.launches()
    body, lam = tgs_kernel.solve_tgs(*packed, params, **kw)
    assert tgs_kernel.launches() == before + 1
    again = tgs_kernel.solve_tgs(*packed, params, **kw)
    assert torch.equal(body, again[0]) and torch.equal(lam, again[1])
    ref_b, ref_l = tgs_kernel.solve_tgs_plain(*packed, params, **kw)
    assert (body[:, 6:13] - ref_b[:, 6:13]).abs().max() < 1e-5
    assert (body[:, 0:6] - ref_b[:, 0:6]).abs().max() < 3e-4
    assert ((lam - ref_l).abs() <= 1e-3 * ref_l.abs() + 1e-5).all()


def _pad_bodies(body, n):
    """The packed body planes with inert bodies appended up to n (no
    collider or joint refers to them; unit quaternion, zero mass)."""
    pad = torch.zeros((body.shape[0], body.shape[1], n - body.shape[2]),
                      device=body.device)
    pad[:, 12] = 1.0
    return torch.cat([body, pad], 2).contiguous()


def test_tgs_kernel_takes_oversized_worlds(jointed):
    """1,850 bodies with COM offsets and joints do not fit one block's
    shared memory: K1 takes its global-memory variant and matches plain at
    K1's bounds."""
    packed, params, kw = jointed
    con, body_j, body, col_body = packed
    nj = int(kw["joints"].body_a.shape[0])
    big = _pad_bodies(body, 1850)
    assert tgs_kernel.smem_bytes(1850, con.shape[3], True, nj) > \
        tgs_kernel.SMEM_LIMIT
    assert tgs_kernel._layout(1850, con.shape[3], con.shape[2], True, nj)[0]
    got_b, got_l = tgs_kernel.solve_tgs(con, body_j, big, col_body, params,
                                        **kw)
    ref_b, ref_l = tgs_kernel.solve_tgs_plain(con, body_j, big, col_body,
                                              params, **kw)
    assert (got_b[:, 6:13] - ref_b[:, 6:13]).abs().max() < 1e-5
    assert (got_b[:, 0:6] - ref_b[:, 0:6]).abs().max() < 1e-4
    assert ((got_l - ref_l).abs() <= 1e-3 * ref_l.abs() + 1e-5).all()
    # the bodies the solve knows take the same result as without the pad
    small_b, _ = tgs_kernel.solve_tgs(*packed, params, **kw)
    assert (got_b[:, :, :body.shape[2]] - small_b).abs().max() < 1e-5


# ---- the fused route: fused_bp (K3) and narrow_compact (K2) --------------

def _settled_fused_inputs(cuda, n_worlds=8, **kw):
    """The fused step's inputs on a settled flagship of distinct worlds
    (build_flagship(n_bones=10, n_verts=300, n_bodies=192, **kw))."""
    kw.setdefault("n_bodies", 192)
    engine, _ = build_flagship(n_bones=10, n_verts=300, **kw)
    st = engine.init_state(n_worlds, device=cuda)
    rng = np.random.default_rng(4)
    dyn = torch.as_tensor(engine.physics.body_type == phys_mod.DYNAMIC,
                          device=cuda)[None, :, None].float()
    st = st._replace(physics=st.physics._replace(
        position=st.physics.position + torch.as_tensor(
            rng.uniform(-0.05, 0.05, st.physics.position.shape).astype(
                np.float32), device=cuda) * dyn))
    for _ in range(30):
        st = engine.step(st)
    t = engine.physics
    accel, angvel = phys_mod.external_accelerations(st.physics, t, engine.dt)
    body, warm_lam, warm_pid = fused_step._inputs(st.physics, t, accel,
                                                  angvel)
    return t, engine.dt, body, warm_lam, warm_pid


@pytest.fixture
def fused_inputs(cuda):
    """The fused step's inputs on the settled, distinct small flagship."""
    return _settled_fused_inputs(cuda)


# the small flagship; its reuse variant (broadphase_period=4: windows 16 /
# 8 / 12, walk 64, 69 window rows a collider, K2 route); the flagship with
# 2,000 bodies (Cg = 2,000)
_FUSED_CASES = {"flagship": dict(), "reuse": dict(broadphase_period=4),
                "big": dict(n_bodies=2000, n_worlds=4)}


@pytest.fixture(params=list(_FUSED_CASES))
def fused_case(cuda, request):
    return request.param, _settled_fused_inputs(
        cuda, **_FUSED_CASES[request.param])


def test_fused_bp_kernel_is_bit_exact(fused_case):
    """K3's windows equal plain's as integers and its collider planes bit
    for bit, and two launches agree; on the reuse template too, whose
    windows (walk 64) K3 computes as the K2 route's broadphase does."""
    case, (t, dt, body) = fused_case[0], fused_case[1][:3]
    assert fused_step.supports_fused_bp(t) == (case != "reuse")
    before = fused_step.launches("fused_bp")
    jv, col = fused_step.bp_candidates(t, body, dt)
    assert fused_step.launches("fused_bp") == before + 1
    again = fused_step.bp_candidates(t, body, dt)
    jv_p, col_p = fused_step.bp_candidates_plain(t, body, dt)
    assert (jv >= 0).sum() > 0 and _all_differ(jv)
    assert torch.equal(jv, jv_p) and torch.equal(col, col_p)
    assert torch.equal(jv, again[0]) and torch.equal(col, again[1])


def test_narrow_compact_kernel_matches_plain_and_repeats(fused_case):
    case, (t, dt, body, warm_lam, warm_pid) = fused_case
    if case == "reuse":                 # the K2 route's windows
        fs = fused_step._statics(t)
        col = fused_step.collider_planes(t, body, dt).contiguous()
        amin, amax = fused_step._aabbs(t, col)
        jv = fused_step._jv_from_candidates(
            fs, fused_step.bp_mod.slab_candidates(
                t.grid, fs.cx.col_body, fs.cx.dyn_col, amin, amax,
                tight_delta=fused_step._tight_delta()))
        assert fs.wd == 69
    else:
        jv, col = fused_step.bp_candidates_plain(t, body, dt)
    got = fused_step.narrow_compact(t, col, jv, warm_lam, warm_pid)
    again = fused_step.narrow_compact(t, col, jv, warm_lam, warm_pid)
    con_p, bj_p, pid_p = fused_step.narrow_compact_plain(t, col, jv,
                                                         warm_lam, warm_pid)
    con, bj, pid = got
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(pid, pid_p) and torch.equal(bj, bj_p)
    assert torch.equal(con[:, 9], con_p[:, 9]) and con[:, 9].sum() > 0
    # the plain version's float32 operations in its order
    assert (con - con_p).abs().max() <= 1e-5


def _platform_pile():
    """A pile on a finite static cuboid: the K2 route."""
    rng = np.random.default_rng(3)
    pb = PhysicsBuilder()
    g = pb.add_body(body_type=BodyType.STATIC, position=(0.0, -0.2, 0.0))
    pb.add_collider(g, CUBOID, [4.0, 0.2, 4.0], friction=0.7)
    for i in range(24):
        q = rng.standard_normal(4)
        b = pb.add_body(position=(rng.uniform(-1.5, 1.5), 0.4 + 0.45 * (i // 6),
                                  rng.uniform(-1.5, 1.5)),
                        rotation=tuple(float(x) for x in q / np.linalg.norm(q)))
        shape, params = [(CAPSULE, [0.15, 0.12]), (BALL, [0.22]),
                         (CUBOID, [0.18, 0.18, 0.18])][i % 3]
        pb.add_collider(b, shape, params, friction=0.5)
    return pb, pb.build(broadphase="slab")


def test_k2_route_on_the_card_matches_the_cpu(cuda):
    pb, t = _platform_pile()
    assert fused_step.supports_fused(t) and not fused_step.supports_fused_bp(t)
    cpu = phys_mod.init_physics_state(pb, t, 4, device="cpu")
    gpu = convert.physics_state(convert.to_numpy(cpu), device=cuda)
    n0 = fused_step.launches("narrow_compact")
    for _ in range(30):
        cpu = phys_mod.step_physics(cpu, t, 1 / 60)
        gpu = phys_mod.step_physics(gpu, t, 1 / 60)
    assert fused_step.launches("narrow_compact") == n0 + 30
    assert (cpu.warm_pair >= 0).sum() > 0
    # trajectory bounds between two implementations (test_pallas_step.py)
    assert (gpu.position.cpu() - cpu.position).abs().max() < 5e-4
    assert (gpu.linvel.cpu() - cpu.linvel).abs().max() < 5e-3


def test_fused_wrappers_reject_bad_inputs(fused_inputs):
    t, dt, body, warm_lam, warm_pid = fused_inputs
    jv, col = fused_step.bp_candidates_plain(t, body, dt)
    with pytest.raises(TypeError):
        fused_step.bp_candidates(t, body.double(), dt)
    with pytest.raises(ValueError, match="contiguous"):
        fused_step.bp_candidates(
            t, body.transpose(1, 2).contiguous().transpose(1, 2), dt)
    with pytest.raises(TypeError):
        fused_step.narrow_compact(t, col, jv.long(), warm_lam, warm_pid)
    with pytest.raises(ValueError, match="shape"):
        fused_step.narrow_compact(t, col, jv[:, :-1].contiguous(), warm_lam,
                                  warm_pid)
    with pytest.raises(ValueError, match="contiguous"):
        fused_step.narrow_compact(
            t, col, jv, warm_lam.transpose(2, 3).contiguous().transpose(2, 3),
            warm_pid)


def test_fused_route_takes_worlds_beyond_one_k1_block(cuda):
    """2,000 balls over a halfspace: past the bodies one block's shared
    memory holds, K1 keeps the world's planes in global memory and the
    fused route steps the pile."""
    pb = PhysicsBuilder()
    g = pb.add_body(body_type=BodyType.STATIC)
    pb.add_collider(g, HALFSPACE, [])
    for i in range(2000):
        b = pb.add_body(position=(0.6 * (i % 45), 0.5 + 0.6 * (i // 2025),
                                  0.6 * (i // 45)))
        pb.add_collider(b, BALL, [0.25])
    t = pb.build(broadphase="slab")
    st = phys_mod.init_physics_state(pb, t, 1, device=cuda)
    before = tgs_kernel.launches()
    for _ in range(3):
        st = phys_mod.step_physics(st, t, 1 / 60)
    assert tgs_kernel.launches() == before + 3
    assert torch.isfinite(st.position).all()
    assert (st.position[0, 1:, 1] < 0.5).all()      # falling


@pytest.mark.parametrize("case", ["flagship", "staged", "jointed",
                                  "platform", "platform-count"])
def test_rollout_replays_equal_eager_steps(cuda, case):
    """Engine.rollout replays a captured CUDA graph of the tick: 12 replays
    equal 12 Engine.step ticks bit for bit, from 4 jittered worlds, on every
    period-1 route: the small flagship (K3; and staged, fused=False), a
    small jointed flagship (staged, K1's joint tables) and a pile on a
    finite platform (K2 route; and with the count rank, K4b); the caller's
    state is not written, and a second roll from it reuses the capture."""
    import chip_smoke
    from fyrox_tpu_torch.engine import Engine, _leaves
    from fyrox_tpu_torch.scene import SceneBuilder
    kw = {}
    if case in ("flagship", "staged"):
        engine, _ = build_flagship(n_bones=10, n_verts=300, n_bodies=192)
        kw = dict(fused=case == "flagship")
    elif case == "jointed":
        engine, _, _, _ = chip_smoke.jointed_engine(
            n_bones=10, n_verts=300, n_bodies=24, chains=2, spines=1)
    else:
        _, t = chip_smoke.pile_scene(big_cuboid=True)
        assert fused_step.supports_fused(t)
        assert not fused_step.supports_fused_bp(t)
        sb = SceneBuilder()
        sb.add_pivot("root")
        engine = Engine(template=sb.build(), physics=t)
        kw = dict(bp_rank="count" if case.endswith("count") else "sort")
    state = chip_smoke.distinct_worlds(engine, 4, cuda, seed=2)
    before = [x.clone() for x in _leaves(state)]
    eager = state
    for _ in range(12):
        eager = engine.step(eager, **kw)
    rolled = engine.rollout(state, 12, **kw)
    assert len(engine._captured) == 1
    tick = next(iter(engine._captured.values()))
    assert tick.graph is not None and tick.pool_bytes > 0
    for got, want in zip(_leaves(rolled), _leaves(eager)):
        assert torch.equal(got, want)
    for x, y in zip(_leaves(state), before):
        assert torch.equal(x, y)
    again = engine.rollout(state, 12, **kw)
    assert len(engine._captured) == 1
    for got, want in zip(_leaves(again), _leaves(eager)):
        assert torch.equal(got, want)


# ---- the dense broadphase path ---------------------------------------------

@pytest.mark.parametrize("case", ["flagship", "compacted"])
def test_dense_rollout_replays_equal_eager_steps(cuda, case):
    """Engine.rollout on a dense template (a small build_flagship(), all
    pairs in the compact layout; or compacted into 24 slots, top-k on the
    card): 30 replays equal 30 Engine.step ticks bit for bit, from 4
    jittered worlds, the pile landed (contacts hold impulses). Nothing on
    the path uses float atomics."""
    import chip_smoke
    from fyrox_tpu_torch.engine import _leaves
    kw = dict(max_active_pairs=24) if case == "compacted" else {}
    engine, _ = build_flagship(n_bones=10, n_verts=300, n_bodies=16, **kw)
    assert engine.physics.grid is None
    state = chip_smoke.distinct_worlds(engine, 4, cuda, seed=2)
    eager = state
    for _ in range(30):
        eager = engine.step(eager)
    rolled = engine.rollout(state, 30)
    assert len(engine._captured) == 1
    for got, want in zip(_leaves(rolled), _leaves(eager)):
        assert torch.equal(got, want)
    assert int((eager.physics.warm_n > 0).sum()) > 0


@pytest.mark.parametrize("case", ["full", "compacted"])
def test_dense_step_on_the_card_matches_the_cpu(cuda, case):
    """chip_smoke's dense-small scene (mixed cluster + jointed ragdoll),
    card vs CPU over 20 ticks at W=4, within dense-small's bounds (dp 5e-4,
    dv 5e-3); compacted mode too (max_active_pairs=16)."""
    import chip_smoke
    pb, t = chip_smoke.dense_small_scene()
    if case == "compacted":
        t = pb.build(broadphase="dense", max_active_pairs=16)
    cpu = chip_smoke.jitter(phys_mod.init_physics_state(pb, t, 4,
                                                        device="cpu"),
                            t, "cpu", seed=3)
    gpu = convert.physics_state(convert.to_numpy(cpu), device=cuda)
    for _ in range(20):
        cpu = phys_mod.step_physics(cpu, t, 1 / 60)
        gpu = phys_mod.step_physics(gpu, t, 1 / 60)
    assert (gpu.position.cpu() - cpu.position).abs().max() < 5e-4
    assert (gpu.linvel.cpu() - cpu.linvel).abs().max() < 5e-3
    assert int((cpu.warm_n > 0).sum()) > 0


def test_dense_k4_kernels_equal_plain(cuda):
    """K4a and K4b on one dense flagship tick's calls (the default 64-body
    pile, settled 25 ticks, 8 distinct worlds): bit-equal to their plain
    versions (the scatter's on CPU copies, which sums in ascending k as
    the kernel does)."""
    import chip_smoke
    engine, _ = build_flagship(n_bones=10, n_verts=300)
    state = chip_smoke.distinct_worlds(engine, 8, cuda, seed=5)
    for _ in range(25):
        state = engine.step(state)
    gathers, scatters = chip_smoke.capture_dense_calls(engine, state)
    assert (len(gathers), len(scatters)) == chip_smoke.dense_launches(
        engine.physics) == (13, 14)
    for planes, idx in gathers:
        assert idx.shape == (8, 2 * 3664)
        assert torch.equal(plane_ops.plane_gather(planes, idx),
                           plane_ops.plane_gather_plain(planes, idx))
    for vals, idx, n in scatters:
        assert n == 65
        assert torch.equal(plane_ops.plane_scatter(vals, idx, n).cpu(),
                           plane_ops.plane_scatter_plain(vals.cpu(),
                                                         idx.cpu(), n))


# ---- hulls, scenery, terrain and queries ------------------------------------

@pytest.mark.parametrize("broadphase", ["dense", "slab"])
def test_terrain_small_on_the_card_matches_the_cpu(cuda, broadphase):
    """chip_smoke's terrain-small scene (cylinders, hull clouds, cones,
    balls and cuboids over a heightfield and a trimesh ramp) at W=4: each
    of 30 card ticks against the same tick on the CPU from the card's
    state, within dp 5e-4, dv 5e-3 (chip_smoke.card_vs_cpu_steps)."""
    import chip_smoke
    pb = chip_smoke.terrain_pile(PhysicsBuilder(), **chip_smoke.TERRAIN_SMALL)
    t = pb.build(broadphase=broadphase)
    gpu = convert.physics_state(convert.to_numpy(chip_smoke.jitter(
        phys_mod.init_physics_state(pb, t, 4, device="cpu"), t, "cpu", 4)),
        device=cuda)
    worst_p = worst_v = 0.0
    for _ in range(30):
        cpu = phys_mod.step_physics(convert.physics_state(
            convert.to_numpy(gpu), device="cpu"), t, 1 / 60)
        gpu = phys_mod.step_physics(gpu, t, 1 / 60)
        worst_p = max(worst_p, float((gpu.position.cpu()
                                      - cpu.position).abs().max()))
        worst_v = max(worst_v, float((gpu.linvel.cpu()
                                      - cpu.linvel).abs().max()))
    assert worst_p < 5e-4 and worst_v < 5e-3, (worst_p, worst_v)
    assert int((cpu.warm_n > 0).sum()) > 0


@pytest.mark.parametrize("broadphase", ["dense", "slab"])
def test_terrain_rollout_replays_equal_eager_steps(cuda, broadphase):
    """Engine.rollout on a small terrain engine (10-bone character, the
    16-body terrain pile): 30 replays equal 30 Engine.step ticks bit for
    bit from 4 jittered worlds, the pile landed."""
    import chip_smoke
    from fyrox_tpu_torch.engine import Engine, _leaves
    from fyrox_tpu_torch.models import character
    from fyrox_tpu_torch.scene import NodeType
    sb, aset, mt, bones, skin = character.build_character_scene(
        n_bones=10, n_verts=300)
    pb = chip_smoke.terrain_pile(PhysicsBuilder(), sb, NodeType,
                                 **chip_smoke.TERRAIN_SMALL)
    engine, _ = character.assemble_flagship(
        sb, pb.build(broadphase=broadphase), aset, mt, bones, skin)
    assert isinstance(engine, Engine)
    state = chip_smoke.distinct_worlds(engine, 4, cuda, seed=2)
    eager = state
    for _ in range(30):
        eager = engine.step(eager)
    rolled = engine.rollout(state, 30)
    for got, want in zip(_leaves(rolled), _leaves(eager)):
        assert torch.equal(got, want)
    assert int((eager.physics.warm_n != 0).sum()) > 0


def test_fused_bp_kernel_with_cylinders_is_bit_exact(cuda):
    """A slab pile with cylinders (capsule proxies, no hull tables) keeps
    the K3 route, and K3's cylinder AABBs equal plain's."""
    pb = PhysicsBuilder()
    g = pb.add_body(body_type=BodyType.STATIC)
    pb.add_collider(g, HALFSPACE, [])
    for i in range(200):
        b = pb.add_body(position=(0.7 * (i % 10), 0.6 + 0.7 * (i // 50),
                                  0.7 * ((i // 10) % 5)))
        pb.add_collider(b, 3 if i % 3 == 0 else BALL,
                        [0.22, 0.2] if i % 3 == 0 else [0.25])
    t = pb.build(broadphase="slab")
    assert fused_step.supports_fused_bp(t)
    st = phys_mod.init_physics_state(pb, t, 4, device=cuda)
    for _ in range(20):
        st = phys_mod.step_physics(st, t, 1 / 60)
    accel, angvel = phys_mod.external_accelerations(st, t, 1 / 60)
    body = fused_step._inputs(st, t, accel, angvel)[0]
    jv, col = fused_step.bp_candidates(t, body, 1 / 60)
    jv_p, col_p = fused_step.bp_candidates_plain(t, body, 1 / 60)
    assert (jv >= 0).sum() > 0
    assert torch.equal(jv, jv_p) and torch.equal(col, col_p)


def test_queries_on_the_card_match_the_cpu(cuda):
    """cast_ray and sphere_cast fans over the small terrain pile at W=4:
    hits, colliders and bodies equal card vs CPU, toi within 1e-5."""
    import chip_smoke
    from fyrox_tpu_torch.physics import queries
    pb = chip_smoke.terrain_pile(PhysicsBuilder(), **chip_smoke.TERRAIN_SMALL)
    t = pb.build()
    cpu = phys_mod.init_physics_state(pb, t, 4, device="cpu")
    gpu = convert.physics_state(convert.to_numpy(cpu), device=cuda)
    for fn in (queries.cast_ray,
               lambda s, t_, o, d: queries.sphere_cast(s, t_, o, d, 0.1)):
        o, d = chip_smoke.ray_fan(8, 4, "cpu", height=6.0, length=8.0)
        a, b = fn(cpu, t, o, d), fn(gpu, t, o.to(cuda), d.to(cuda))
        for k in ("hit", "collider", "body"):
            assert torch.equal(b[k].cpu(), a[k]), k
        hit = a["hit"]
        assert 0 < int(hit.sum()) < hit.numel()
        assert float((b["toi"].cpu()[hit] - a["toi"][hit]).abs().max()) < 1e-5


def _raster_scene(device, n_worlds=3):
    """A small lit scene (ground, cubes, spheres, directional light) in
    worlds whose objects are jittered apart (seeded)."""
    from fyrox_tpu_torch.render import (build_render_template, make_cube,
                                        make_plane, make_sphere)
    from fyrox_tpu_torch.scene import NodeType, SceneBuilder, graph
    from fyrox_tpu_torch.scene import init_state
    sb = SceneBuilder()
    sb.add_mesh(make_plane(20.0))
    rng = np.random.default_rng(0)
    for i in range(12):
        x, z = rng.uniform(-5, 5, 2)
        sb.add_mesh(make_cube(1.0) if i % 2 else make_sphere(0.5),
                    position=(x, 0.5, z))
    sb.add_light("directional", rotation=(0.5, 0.0, 0.0, 0.866))
    sb.add_camera("cam", position=(0, 5.0, -9.0),
                  rotation=(0.2, 0.0, 0.0, 0.98))
    t = sb.build()
    st = init_state(t, n_worlds, device=device)
    mesh = torch.as_tensor(t.node_type == NodeType.MESH, device=device)
    noise = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.1, 0.1, tuple(st.position.shape)).astype(np.float32),
        device=device)
    st = st._replace(position=st.position + noise * mesh[None, :, None])
    return t, build_render_template(t), graph.update_hierarchical_data(st, t)


@pytest.mark.parametrize("depth_only", [False, True])
def test_tile_raster_kernel_is_bit_exact(cuda, depth_only):
    """K5 at a frame's own inputs (64 x 256 camera pass, 3 cascades of
    128 x 128 maps): equal to its plain version bit for bit, twice."""
    from fyrox_tpu_torch.render import (CsmConfig, RenderConfig,
                                        render_frame, tile_raster)
    t, rt, st = _raster_scene(cuda)
    seen = []
    dispatch = tile_raster.visibility

    def spy(*args, **kw):
        seen.append((args, kw.get("depth_only", False)))
        return dispatch(*args, **kw)

    tile_raster.visibility = spy
    try:
        before = tile_raster.launches("depth" if depth_only else "full")
        render_frame(st, t, rt, RenderConfig(
            width=256, height=64, k_per_tile=256, csm=CsmConfig(
                map_size=128), cascade_tri_budget=(0.05, 1.0, 0.75)))
        assert tile_raster.launches("depth" if depth_only else "full") == \
            before + 1
    finally:
        tile_raster.visibility = dispatch
    args = next(a for a, d in seen if d == depth_only)
    got = tile_raster.visibility(*args, depth_only=depth_only)
    again = tile_raster.visibility(*args, depth_only=depth_only)
    ref = tile_raster.visibility_plain(*args, depth_only=depth_only)
    got, again, ref = ((x,) if depth_only else x for x in (got, again, ref))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _all_differ(got[0]) and (got[0] < 1e8).float().mean() > 0.05


@pytest.mark.parametrize("tiles,span", [
    ((16, 256, 8, 128), None), ((16, 256, 8, 128), 40),
    ((16, 64, 8, 32), None), ((12, 320, 6, 160), 40)],
    ids=["8x128", "8x128-span40", "8x32", "6x160-span40"])
def test_tile_raster_kernel_on_knife_edges(cuda, monkeypatch, tiles, span):
    """chip_smoke.k5_knife_edges on the card: edges through pixel centres
    on the warps' rectangle borders and the tiles' outer rows and columns,
    ok = 0 and W <= 1e-12 rows nearest the camera, negative zeros, z ties,
    walks past one 64-row chunk, tiles above SPLIT_SPAN slots split into
    parts; both variants bit-equal to plain, twice."""
    import chip_smoke
    from fyrox_tpu_torch.render import tile_raster
    if span:
        monkeypatch.setattr(tile_raster, "SPLIT_SPAN", span)
    args = chip_smoke.k5_knife_edges(*tiles, seed=1, device=cuda)
    got = tile_raster.visibility(*args)
    assert tile_raster.split_parts()[0] > 0
    again = tile_raster.visibility(*args)
    ref = tile_raster.visibility_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert 0.2 < (ref[1] >= 0).float().mean() < 0.98
    assert torch.equal(tile_raster.visibility(*args, depth_only=True),
                       ref[0])


def test_render_frame_on_the_card_matches_the_cpu(cuda):
    from fyrox_tpu_torch.render import CsmConfig, RenderConfig, render_frame
    t, rt, st = _raster_scene("cpu")
    cfg = RenderConfig(width=64, height=64, csm=CsmConfig(map_size=64))
    cpu, _ = render_frame(st, t, rt, cfg)
    gpu, _ = render_frame(convert.scene_state(convert.to_numpy(st),
                                              device=cuda), t, rt, cfg)
    err = (gpu.cpu() - cpu).abs()
    # 99.9 % of the values within 1e-4: sums over short axes run in other
    # orders on the two devices, and a pixel on a triangle's edge whose
    # coverage flips on a last-bit difference moves by its whole color
    assert (err <= 1e-4).float().mean() >= 0.999 and cpu.abs().sum() > 0


def test_tile_raster_kernel_rejects_bad_inputs(cuda):
    from fyrox_tpu_torch.render import tile_raster
    feats = torch.zeros((1, 8, 16), device=cuda)
    ids = torch.zeros((1, 1, 8), dtype=torch.int32, device=cuda)
    count = torch.ones((1, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        tile_raster.visibility(feats.double(), ids, count, 8, 128, 8, 128)
    with pytest.raises(ValueError):                     # 2 tiles, 1 binned
        tile_raster.visibility(feats, ids, count, 16, 128, 8, 128)
    with pytest.raises(ValueError):                     # tile > 1024 px
        tile_raster.visibility(feats, ids, count, 16, 128, 16, 128)


@pytest.mark.parametrize("tiles,span", [
    ((16, 256, 8, 128), None), ((16, 256, 8, 128), 40),
    ((16, 128, 8, 64), None), ((12, 320, 6, 160), 40)],
    ids=["8x128", "8x128-span40", "8x64", "6x160-span40"])
def test_tile_raster_affine_kernel_on_knife_edges(cuda, monkeypatch, tiles,
                                                  span):
    """K5's affine variant on chip_smoke.k5_knife_edges_affine: forms zero
    on pixel centres at the warps' rectangle borders, z ranges crossing
    -1 and 1, ok = 0 rows nearest the camera, split tiles; full and
    depth-only bit-equal to plain, twice."""
    import chip_smoke
    from fyrox_tpu_torch.render import tile_raster
    if span:
        monkeypatch.setattr(tile_raster, "SPLIT_SPAN", span)
    args = chip_smoke.k5_knife_edges_affine(*tiles, seed=2, device=cuda)
    got = tile_raster.visibility(*args, affine=True)
    again = tile_raster.visibility(*args, affine=True)
    ref = tile_raster.visibility_plain(*args, affine=True)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(tile_raster.visibility(*args, depth_only=True,
                                              affine=True), ref[0])


@pytest.mark.parametrize("mode", ["homogeneous", "clipped"])
def test_features_frame_on_the_card_matches_the_cpu(cuda, mode):
    """chip_smoke's features frame (every feature) at 2 worlds, 32 x 32:
    the card's colour against the CPU's, the same caps and no pass at its
    cap (the demand itself may differ by a few triangles: this scene's
    zero-area and edge-on triangles round differently on the two
    devices); K5's launches by variant (the prepass and camera pass
    affine in clipped mode)."""
    import chip_smoke
    from fyrox_tpu_torch.render import (CsmConfig, RenderConfig,
                                        build_render_template,
                                        render_frame_demand, tile_raster)
    from fyrox_tpu_torch.scene import graph, init_state
    lib = chip_smoke.render_lib()
    t = chip_smoke.features_scene(lib, n_obj=8, tex_size=32, n_sprites=4)
    st = graph.update_hierarchical_data(init_state(t, 2, device="cpu"), t)
    rt = build_render_template(t)
    kw = chip_smoke.features_config(lib, size=32)
    kw["raster_mode"] = mode
    cfg = RenderConfig(csm=CsmConfig(map_size=64), **kw)
    cpu, dem, caps = render_frame_demand(st, t, rt, cfg)
    tile_raster.reset_launches()
    gpu, gdem, gcaps = render_frame_demand(
        convert.scene_state(convert.to_numpy(st), device=cuda), t, rt, cfg)
    affine = mode == "clipped"
    assert tile_raster._LAUNCHES == dict(
        full=int(not affine), depth=3 + int(not affine),
        full_affine=int(affine), depth_affine=int(affine))
    err = (gpu.cpu() - cpu).abs()
    assert (err <= 1e-4).float().mean() >= 0.999 and err.max() <= 2e-3
    assert gcaps == caps and all(
        int(d) < k for d, k in zip(gdem.amax(0).tolist(), gcaps))


# ---- the animation breadth and the real-asset flagship ---------------------

def test_real_asset_rollout_replays_equal_eager_steps(cuda):
    """The real-asset flagship (an 8-bone FBX character on the plain
    AnimationPlayer, 192 bodies, K3 route): 12 replays of Engine.rollout
    equal 12 Engine.step ticks bit for bit, from 4 jittered worlds, and
    K3, K2 and K1 launch once an eager tick."""
    import chip_smoke
    from fyrox_tpu_torch.engine import _leaves
    from fyrox_tpu_torch.models import make_character_fbx
    engine, _ = build_flagship(n_bodies=192, real_asset=make_character_fbx(
        n_bones=8, n_verts=320))
    assert engine.machine is None
    assert fused_step.supports_fused_bp(engine.physics)
    state = chip_smoke.distinct_worlds(engine, 4, cuda, seed=2)
    chip_smoke.reset_all_launches()
    eager = state
    for _ in range(12):
        eager = engine.step(eager)
    assert chip_smoke.all_launches() == dict(
        fused_bp=12, narrow_compact=12, solve_tgs=12, plane_gather=0,
        plane_scatter=0)
    rolled = engine.rollout(state, 12)
    for got, want in zip(_leaves(rolled), _leaves(eager)):
        assert torch.equal(got, want)


def test_particles_replay_with_an_advancing_counter(cuda):
    """A root-motion walker with a particle emitter: replays equal eager
    ticks bit for bit with the counter advanced in the graph's buffer, and
    a replay at counter 1 draws other newborns than at counter 0."""
    import chip_smoke
    from fyrox_tpu_torch.scene.particles import ParticleTemplate
    engine, _ = chip_smoke.walker_engine(ParticleTemplate(
        max_particles=32, emit_rate=90.0, emitter_kind=2, seed=1))
    rolled = chip_smoke.particle_replays(engine, 4)
    assert int(rolled.particles.step) == chip_smoke.ANIM_TICKS
    assert bool(rolled.particles.alive.any())


def test_anim_breadth_on_the_card_matches_the_cpu(cuda):
    """chip_smoke.py's anim-small phase: the player, root motion with its
    body drive, a blend-space state, a layered machine, blend shapes,
    gather skinning, sprite sheets and particles, card against CPU."""
    import chip_smoke
    chip_smoke.phase_anim_small()


# ---- the grid broadphase and the audio mixer ---------------------------------

@pytest.mark.parametrize("scene", ["pile", "jointed"])
def test_grid_rollout_replays_equal_eager_steps(cuda, scene):
    """Engine.rollout on a grid template (chip_smoke's 64-body grid pile,
    or its jointed stack, with scene nodes): 20 replays equal 20
    Engine.step ticks bit for bit from 4 jittered worlds; the eager ticks
    launch K4a and K4b chip_smoke.grid_launches(t) times each and no other
    kernel; pairs live."""
    import chip_smoke
    from fyrox_tpu_torch.engine import Engine, _leaves
    from fyrox_tpu_torch.scene import SceneBuilder
    lib = chip_smoke.port_lib()
    pb = (chip_smoke.grid_pile(lib, n=64) if scene == "pile"
          else chip_smoke.jointed_stack(lib))
    sb = SceneBuilder()
    for body in pb._bodies:
        if body["body_type"] == BodyType.DYNAMIC:
            body["node"] = sb.add_node("b", node_type=7,
                                       position=body["position"])
    engine = Engine(template=sb.build(), physics=pb.build(broadphase="grid"))
    state = chip_smoke.distinct_worlds(engine, 4, cuda, seed=2)
    chip_smoke.reset_all_launches()
    eager = state
    for _ in range(20):
        eager = engine.step(eager)
    g, s = chip_smoke.grid_launches(engine.physics)
    assert chip_smoke.all_launches() == dict(
        fused_bp=0, narrow_compact=0, solve_tgs=0, plane_gather=20 * g,
        plane_scatter=20 * s)
    rolled = engine.rollout(state, 20)
    assert len(engine._captured) == 1
    for got, want in zip(_leaves(rolled), _leaves(eager)):
        assert torch.equal(got, want)
    assert int((eager.physics.warm_pair >= 0).sum()) > 0


def test_grid_k4_kernels_equal_plain(cuda):
    """K4a and K4b on one tick's calls of a 300-body grid flagship (10-bone
    character; 25 settling ticks, 8 distinct worlds): bit-equal to their
    plain versions (the scatter's on CPU copies, which sums in ascending
    k as the kernel does), rows past a body's window dropped by both."""
    import chip_smoke
    from fyrox_tpu_torch.models import character
    sb, aset, mt, bones, skin = character.build_character_scene(
        n_bones=10, n_verts=300)
    pb, _ = character.build_pile_scene(sb, n_bodies=300, seed=1)
    engine, _ = character.assemble_flagship(
        sb, pb.build(broadphase="grid"), aset, mt, bones, skin)
    state = chip_smoke.distinct_worlds(engine, 8, cuda, seed=5)
    for _ in range(25):
        state = engine.step(state)
    gathers, scatters = chip_smoke.capture_dense_calls(engine, state)
    assert (len(gathers), len(scatters)) == chip_smoke.grid_launches(
        engine.physics)
    for planes, idx in gathers:
        assert torch.equal(plane_ops.plane_gather(planes, idx),
                           plane_ops.plane_gather_plain(planes, idx))
    assert any(bool((idx < 0).any()) for _, idx, _ in scatters)
    for vals, idx, n in scatters:
        assert n == engine.physics.num_bodies
        assert torch.equal(plane_ops.plane_scatter(vals, idx, n).cpu(),
                           plane_ops.plane_scatter_plain(vals.cpu(),
                                                         idx.cpu(), n))


def test_audio_flagship_replays_with_audio_leaves_carried(cuda):
    """The small flagship with audio (chip_smoke.audio_worlds, W=4): 15
    replays of Engine.rollout equal 15 Engine.step ticks bit for bit, the
    audio leaves carried unchanged; render_audio after the roll on the
    card equals it on the CPU from the same state within 1e-5."""
    import chip_smoke
    from fyrox_tpu_torch.engine import _leaves
    engine, _ = build_flagship(**chip_smoke.AUDIO_SMALL, with_audio=True)
    state = chip_smoke.audio_worlds(engine, 4, cuda, seed=3)
    eager = state
    for _ in range(15):
        eager = engine.step(eager)
    rolled = engine.rollout(state, 15)
    for got, want in zip(_leaves(rolled), _leaves(eager)):
        assert torch.equal(got, want)
    for got, want in zip(rolled.audio, state.audio):
        assert torch.equal(got, want)
    block, _ = engine.render_audio(rolled, block_len=256)
    cpu_block, _ = engine.render_audio(
        convert.engine_state(convert.to_numpy(rolled), device="cpu"),
        block_len=256)
    assert (block.cpu() - cpu_block).abs().max() <= 1e-5
    assert bool(torch.isfinite(block).all()) and block.abs().max() > 1e-3


# ---- the captured frame, the render package's remainder, public names ----

@pytest.mark.parametrize("mode", ["bench", "homogeneous", "clipped"])
def test_captured_frame_replays_equal_eager_frames(cuda, mode):
    """render.CapturedFrame at W=2, 32 x 32 (the bench scene, or every
    feature in either raster mode): replays equal eager render_frame bit
    for bit, from the captured state and from another; a second capture
    after the first graph is freed replays as eager; the graph owns its
    K5 scratch (none is left in the stream-keyed cache)."""
    import gc
    import chip_smoke
    from fyrox_tpu_torch.render import (CapturedFrame, CsmConfig,
                                        render_frame, tile_raster)
    kw = dict(size=32, seed=3, n_obj=8)
    if mode == "bench":
        t, rt, st, cfg = chip_smoke.features_frame(
            2, cuda, features=frozenset(), **kw)
    else:
        t, rt, st, cfg = chip_smoke.features_frame(2, cuda, tex_size=32,
                                                   n_sprites=4, **kw)
        cfg = cfg._replace(raster_mode=mode)
    cfg = cfg._replace(csm=CsmConfig(map_size=64))
    other = chip_smoke.moved_state(st, 4)
    for _ in range(2):
        frame = CapturedFrame(t, rt, cfg)
        for s in (st, other, st):
            chip_smoke.same_frame(mode, frame(s), render_frame(s, t, rt, cfg))
        fg = frame.graph(st)
        assert fg.capture_seconds > 0 and fg.pool_bytes > 0
        if fg.scratch is not None:
            held = {v[0].data_ptr() for v in tile_raster._SCRATCH.values()}
            assert fg.scratch[0].data_ptr() not in held
        del frame, fg
        gc.collect()
        torch.cuda.empty_cache()


def test_render_extras_and_unbinned_builds_on_the_card():
    """chip_smoke's render-extras-small (the streaming rasterizer, probes,
    post-processing and SSAO, card vs CPU) and unbinned (slab and grid
    builds with no grid collider step on the card as on the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    import chip_smoke
    chip_smoke.phase_render_extras_small()
    chip_smoke.phase_unbinned()


def test_public_names_on_the_card(cuda):
    """core.aabb / frustum / quat / transform, scene.camera and
    scene.graph.world_bounding_boxes on the card equal the CPU within
    1e-6 (booleans exactly), and default to the card."""
    from fyrox_tpu_torch.core import aabb, frustum, quat
    from fyrox_tpu_torch.core import transform as tfm
    from fyrox_tpu_torch.render import shader
    from fyrox_tpu_torch.scene import camera, graph, init_state
    rng = np.random.default_rng(0)

    def both(fn, *xs):
        cpu = fn(*(torch.as_tensor(x) for x in xs))
        card = fn(*(torch.as_tensor(x, device=cuda) for x in xs))
        cpu, card = ((cpu,), (card,)) if isinstance(cpu, torch.Tensor) \
            else (cpu, card)
        for a, b in zip(cpu, card):
            assert b.is_cuda and a.shape == b.shape
            if a.dtype == torch.bool:
                assert torch.equal(a, b.cpu())
            else:
                assert (a - b.cpu()).abs().max() <= 1e-6

    lo = rng.uniform(-2, 2, (32, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 1.0, (32, 3)).astype(np.float32)
    p = rng.uniform(-3, 3, (32, 3)).astype(np.float32)
    r = rng.uniform(0.1, 1.0, 32).astype(np.float32)
    q = rng.standard_normal((32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q2 = np.roll(q, 1, 0)
    m = rng.standard_normal((32, 3, 3)).astype(np.float32)
    for fn, xs in ((aabb.from_points, (m,)), (aabb.center, (lo, hi)),
                   (aabb.half_extents, (lo, hi)), (aabb.volume, (lo, hi)),
                   (aabb.union, (lo, hi, hi, hi + 1)),
                   (aabb.contains_point, (lo, hi, p)),
                   (aabb.intersects_aabb, (lo, hi, p, p + 1)),
                   (aabb.intersects_sphere, (lo, hi, p, r)),
                   (aabb.corners, (lo, hi)), (quat.inverse, (q,)),
                   (quat.from_axis_angle, (p / np.linalg.norm(
                       p, axis=-1, keepdims=True), r)),
                   (quat.slerp, (q, q2, r)), (quat.angle, (q,)),
                   (quat.face_towards, (p, np.array([0, 1, 0], np.float32))),
                   (quat.mtv, (m, p)), (quat.mvb, (m, m)),
                   (tfm.make_translation, (p,)), (tfm.make_scale, (p,))):
        both(fn, *xs)
    vp = camera.view_projection(tfm.make_translation(torch.as_tensor(
        p[:4], device=cuda)), 1.0, 1.2, 0.1, 30.0)
    planes = camera.camera_frustums(vp)
    both(frustum.contains_point, planes.cpu().numpy()[:, None], p[None])
    both(frustum.intersects_sphere, planes.cpu().numpy()[:, None], p[None],
         r[None])
    assert aabb.invalid((2,))[0].is_cuda and aabb.unit()[0].is_cuda
    assert quat.identity((2,)).is_cuda and tfm.mat4_identity().is_cuda
    assert shader.standard_shader().default_properties()[
        "properties"]["diffuseColor"].is_cuda
    import chip_smoke
    t = chip_smoke.features_scene(chip_smoke.render_lib(), frozenset(),
                                  n_obj=4)
    st = graph.update_hierarchical_data(init_state(t, 2), t)
    card = graph.world_bounding_boxes(st, t)
    cpu = graph.world_bounding_boxes(convert.scene_state(
        convert.to_numpy(st), device="cpu"), t)
    for a, b in zip(cpu, card):
        assert (a - b.cpu()).abs().max() <= 1e-5


def test_executor_replays_equal_eager_ticks_and_resume(cuda, tmp_path):
    """script.Executor on the card (captured ticks) equals the same script
    calls and eager Engine.step ticks, bit for bit; a run saved, loaded
    into a fresh state and resumed equals the whole run."""
    from fyrox_tpu_torch.engine import _leaves
    from fyrox_tpu_torch.io import load_state, save_state
    from fyrox_tpu_torch.script import Executor, Script, ScriptProcessor

    class Push(Script):
        def on_update(self, ctx):
            ph = ctx.state.physics
            lv = ph.linvel.clone()
            lv[:, 1, 0] += 0.05
            ctx.state = ctx.state._replace(physics=ph._replace(linvel=lv))

    e, _ = build_flagship(n_bones=10, n_verts=300, n_bodies=192)
    st = e.init_state(4, device=cuda)
    ex = Executor(e, st)
    ex.scripts.add(Push())
    whole = ex.run(12 / 60)
    sp = ScriptProcessor()
    sp.add(Push())
    s = st
    for _ in range(12):
        s = e.step(sp.update(e, s, 1 / 60))
    assert all(torch.equal(a, b) for a, b in zip(_leaves(whole), _leaves(s)))
    first = Executor(e, st)
    first.scripts.add(Push())
    save_state(first.run(6 / 60), str(tmp_path / "s.npz"))
    second = Executor(e, load_state(e.init_state(4, device=cuda),
                                    str(tmp_path / "s.npz")))
    second.scripts.add(Push())
    got = second.run(6 / 60)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(got),
                                                 _leaves(whole)))


def test_debug_step_on_the_card(cuda):
    """debug_step on the card: None on a healthy tick, "nan" in the physics
    stage for a NaN velocity, and an ABSM index past the states flagged
    with the tick carried on (no device assert)."""
    from fyrox_tpu_torch.engine import debug_step, world_health
    e, _ = build_flagship(n_bones=10, n_verts=300, n_bodies=192)
    st = e.step(e.init_state(4, device=cuda))
    dbg = debug_step(e)
    assert dbg(st)[0].get() is None
    lv = st.physics.linvel.clone()
    lv[1, 3, 0] = float("nan")
    msg = dbg(st._replace(physics=st.physics._replace(linvel=lv)))[0].get()
    assert msg.startswith("nan in stage physics"), msg
    m = st.animation.machine
    cur = m.current.clone()
    cur[2] = 99
    err, out = dbg(st._replace(animation=st.animation._replace(
        machine=m._replace(current=cur))))
    assert err.get() == "index in stage animation: animation.machine.current"
    assert bool(world_health(out).all())
    torch.cuda.synchronize()


def test_game_loop_modules_on_the_card_match_the_cpu(cuda):
    """distance_field, the lightmap bakes, behavior ticks, nav steering and
    the HUD on the card equal the CPU."""
    from fyrox_tpu_torch.ui import Hud, compose_over
    from fyrox_tpu_torch.utils import (BatchedNavAgents, BehaviorTreeBuilder,
                                       Navmesh, build_grid_graph,
                                       distance_field, lightmap,
                                       pack_adjacency)
    rng = np.random.default_rng(3)
    blocked = [y * 16 + 8 for y in range(15)]
    v, nb = build_grid_graph(16, 16, blocked)
    src = torch.as_tensor(rng.choice(200, 6, replace=False))
    d = [distance_field(*pack_adjacency(v, nb, device=dev), src.to(dev),
                        num_iters=80) for dev in ("cpu", cuda)]
    assert torch.equal(d[0], d[1].cpu())
    tris = rng.uniform(-1, 1, (40, 3, 3)).astype(np.float32)
    pts = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    nrm = rng.normal(size=(30, 3)).astype(np.float32)
    for fn in (lambda dev: lightmap.bake_vertex_ao(pts, nrm, tris, 16,
                                                   device=dev),
               lambda dev: lightmap.bake_direct_light(
                   pts, nrm, tris, light_pos=(0, 2, 0), device=dev)):
        a, b = fn("cpu"), fn(cuda)
        assert (a - b.cpu()).abs().max() <= 1e-6
    b = BehaviorTreeBuilder()
    root = b.selector()
    seq = b.sequence(parent=root)
    b.leaf(seq)
    b.leaf(b.inverter(parent=seq))
    b.leaf(root)
    tree = b.build(root)
    leaves = torch.as_tensor(rng.integers(0, 3, (64, 3)).astype(np.int32))
    assert torch.equal(tree.tick(leaves), tree.tick(leaves.to(cuda)).cpu())
    verts = np.asarray([[0, 0, 0], [0, 0, 1], [1, 0, 0], [1, 0, 1]],
                       np.float32)
    nm = Navmesh(verts, np.asarray([[0, 2, 3], [0, 3, 1]], np.int32))
    ag = BatchedNavAgents()
    starts, goals = [[0.1, 0, 0.1]] * 3, [[0.9, 0, 0.8]] * 3
    pos = torch.as_tensor(rng.uniform(0, 1, (3, 3)).astype(np.float32))
    for dev in ("cpu", cuda):
        vel, st = ag.steer(ag.plan(nm, starts, goals, device=dev),
                           pos.to(dev), 1.5, 1 / 60)
        if dev == "cpu":
            want = vel
    assert (vel.cpu() - want).abs().max() <= 1e-6
    hud = Hud(32, 64).add_bar("hp", 2, 2, 60, 4).add_counter("n", 2, 10, 3)
    vals = {"hp": torch.as_tensor([0.3, 0.8]), "n": torch.as_tensor([7, 512])}
    got = [compose_over(torch.zeros(2, 32, 64, 3, device=dev), hud.render(
        {k: x.to(dev) for k, x in vals.items()})) for dev in ("cpu", cuda)]
    assert (got[0] - got[1].cpu()).abs().max() <= 1e-6


def test_gltf_import_steps_on_the_card_as_on_the_cpu(cuda, tmp_path):
    """A .glb of a small character loaded through the resource manager,
    built with a 192-body pile (the fused route): K3, K2 and K1 once a tick
    on the card, within the CPU suite's trajectory bounds of the same
    ticks on the CPU, skinned meshes within 1e-3."""
    import chip_smoke
    from fyrox_tpu_torch.animation import skinning
    from fyrox_tpu_torch.resource import ResourceManager
    path = tmp_path / "c.glb"
    path.write_bytes(chip_smoke.character_glb(n_bones=10, n_verts=300))
    rm = ResourceManager()
    res = rm.request(str(path)).wait(60)
    rm.shutdown()
    assert res.is_ok(), res.error
    engine, skin = chip_smoke.imported_flagship(res.data, n_bodies=192)
    gpu = chip_smoke.distinct_worlds(engine, 4, cuda)
    cpu = convert.engine_state(convert.to_numpy(gpu), device="cpu")
    plane_ops.reset_launches()
    tgs_kernel.reset_launches()
    fused_step.reset_launches()
    for _ in range(20):
        gpu = engine.step(gpu)
        cpu = engine.step(cpu)
    assert (fused_step.launches("fused_bp"),
            fused_step.launches("narrow_compact"),
            tgs_kernel.launches()) == (20, 20, 20)
    assert (gpu.physics.position.cpu() - cpu.physics.position).abs().max() \
        < 5e-4
    assert (gpu.physics.linvel.cpu() - cpu.physics.linvel).abs().max() < 5e-3

    def skinned(st):
        return skinning.skin_positions_dense(skinning.bone_matrices(
            st.scene.globals_, skin), skin).cpu()

    assert (skinned(gpu) - skinned(cpu)).abs().max() < 1e-3


def test_editor_undo_after_play_on_the_card(cuda, tmp_path):
    """EditorSession over an imported character on the card: play mode's
    ticks replay the captured tick and write no state the stack keeps; the
    snapshot after stop and undo after play equal the states taken before,
    bit for bit."""
    import chip_smoke
    from fyrox_tpu_torch.editor import EditorSession
    from fyrox_tpu_torch.io.gltf import load_gltf
    path = tmp_path / "c.glb"
    path.write_bytes(chip_smoke.character_glb(n_bones=10, n_verts=300))
    engine, skin = chip_smoke.imported_flagship(load_gltf(str(path)),
                                                n_bodies=192)
    first = engine.init_state(1, device=cuda)
    before = chip_smoke.clone_state(first)
    es = EditorSession(engine, first)
    es.translate(int(skin.bones[0]), (0.0, 0.5, 0.0))
    edited = es.state
    kept = chip_smoke.clone_state(edited)
    es.play()
    played = es.tick(0.25)
    assert not torch.equal(played.physics.position, edited.physics.position)
    chip_smoke.same_state("stop", es.stop(), kept)
    chip_smoke.same_state("the edited state", edited, kept)
    es.undo()
    chip_smoke.same_state("undo after play", es.state, before)
    chip_smoke.same_state("the first state", first, before)


def test_ui_tree_composes_over_a_captured_frame_as_on_the_cpu(cuda):
    """chip_smoke's ui phase at W = 2, 64²: example_hud.py's scene through
    render.CapturedFrame (K5) under hud_ui's tree in the writer's TrueType
    font, a scripted OS event a tick: every composed frame equals the CPU's
    compose_over of the replayed frame copied to the CPU, bit for bit."""
    import chip_smoke
    from fyrox_tpu_torch import render
    from fyrox_tpu_torch.input import InputState
    from fyrox_tpu_torch.scene import graph, init_state
    from fyrox_tpu_torch.ui import compose_over, core, render_ui
    from fyrox_tpu_torch.ui.font import FontAtlas, TtfFont
    t = chip_smoke.hud_scene()
    cfg = render.RenderConfig(width=64, height=64, shadows=True)
    frame = render.CapturedFrame(t, render.build_render_template(t), cfg)
    st = chip_smoke.moved_state(graph.update_hierarchical_data(
        init_state(t, 2, device=cuda), t), 1)
    ui, h = chip_smoke.hud_ui(core, size=64)
    inp = InputState()
    atlas = FontAtlas(TtfFont(chip_smoke.write_ttf()), 7)
    for k in range(6):
        color = frame(st)[0]
        chip_smoke.hud_tick(ui, h, inp, k)
        img = render_ui(ui.draw(), 64, 64, font=atlas)
        out = compose_over(color, img)
        assert out.is_cuda and torch.equal(out.cpu(),
                                           compose_over(color.cpu(), img))
    assert bool(torch.isfinite(out).all()) and (img[..., 3] > 0).any()
    assert frame.graphs

