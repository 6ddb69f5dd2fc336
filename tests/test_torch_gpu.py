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


@pytest.mark.parametrize("w,a,n,k", [(4, 19, 1001, 13000), (2, 10, 1000, 48000),
                                     (3, 1, 7, 5)])
def test_plane_gather_kernel_is_bit_exact(cuda, w, a, n, k):
    rng = np.random.default_rng(k)
    planes = torch.as_tensor(rng.standard_normal((w, a, n)).astype(
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


def test_tgs_kernel_refuses_more_than_128_joints(jointed):
    packed, params, kw = jointed
    j = kw["joints"]
    many = tgs_kernel.JointTables(body_a=j.body_a.repeat(20),
                                  body_b=j.body_b.repeat(20),
                                  jtab=j.jtab.repeat(1, 20).contiguous())
    with pytest.raises(NotImplementedError, match="128"):
        tgs_kernel.solve_tgs(*packed, params, has_com=True, joints=many)


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
