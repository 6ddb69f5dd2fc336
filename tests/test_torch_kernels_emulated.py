"""The fused route's CUDA kernels on the CPU: csrc/*.cu compiled as host C++
under tests/cuda_emu/cuda_runtime.h (one thread per CUDA thread, barriers
for __syncthreads and warp votes, no FMA contraction) and called through
the port's own ctypes wrappers on CPU tensors, against their plain PyTorch
versions. This holds the kernels' logic and rounding where there is no
card, bit for bit as on the card; speed and the real nvcc build are the
card's to show (chip_smoke.py, tests/test_torch_gpu.py). Skips without
g++."""
import ctypes
import os
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from fyrox_tpu_torch import kernels
from fyrox_tpu_torch.models import build_flagship
from fyrox_tpu_torch.physics import (BALL, CAPSULE, CUBOID, HALFSPACE,
                                     BodyType, PhysicsBuilder, fused_step,
                                     plane_ops, slab2, tgs_kernel)
from fyrox_tpu_torch.physics import world as tworld

import chip_smoke

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
DT = 1.0 / 60.0


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernels' C entry points, built as host code."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA sources as host C++")
    out = tmp_path_factory.mktemp("cuda_emu")
    for hdr in kernels.CSRC.glob("*.cuh"):
        shutil.copy(hdr, out / hdr.name)
    srcs = []
    for src in sorted(kernels.CSRC.glob("*.cu")):
        code = src.read_text()
        code = re.sub(r"extern __shared__ (float|unsigned long long) (\w+)\[\];",
                      r"\1* \2 = reinterpret_cast<\1*>(emu::smem.data());",
                      code)
        code = re.sub(r"(\w+(?:<\w+>)?)<<<([^,]+),([^,]+),([^,]+),[^>]*>>>\(",
                      r"EMU_LAUNCH(\2,\3,\4, \1, ", code)
        dst = out / (src.stem + ".cpp")
        dst.write_text(code)
        srcs.append(str(dst))
    so = out / "libfyrox_emu.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", "-I", os.path.join(HERE, "cuda_emu"), "-I", str(out),
         "-o", str(so), *srcs], capture_output=True, text=True)
    if proc.returncode != 0:
        if "barrier" in proc.stderr and "No such file" in proc.stderr:
            pytest.skip("g++ without C++20 <barrier>")
        raise AssertionError(proc.stderr)
    lib = ctypes.CDLL(str(so))
    for name, args in kernels._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


@pytest.fixture
def on_cpu(emulated, monkeypatch):
    """Route the wrappers' launches to the host build, on CPU tensors."""
    monkeypatch.setattr(kernels, "library", lambda: emulated)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))


def _pile(big_cuboid=False, n=36, seed=5, rounds=False):
    """Capsules, balls and cuboids at seeded random orientations over a
    halfspace (K3) or a finite cuboid platform (K2); with `rounds`,
    cylinders and cones take the capsules' turns (their capsule proxies
    on the slab path; K3 bounds them by their own [r, hh, r] box)."""
    rng = np.random.default_rng(seed)
    pb = PhysicsBuilder()
    if big_cuboid:
        g = pb.add_body(body_type=BodyType.STATIC, position=(0.0, -0.2, 0.0))
        pb.add_collider(g, CUBOID, [4.0, 0.2, 4.0], friction=0.7)
    else:
        g = pb.add_body(body_type=BodyType.STATIC)
        pb.add_collider(g, HALFSPACE, [], friction=0.7)
    for i in range(n):
        q = rng.standard_normal(4)
        b = pb.add_body(position=(rng.uniform(-1.0, 1.0), 0.4 + 0.3 * (i // 8),
                                  rng.uniform(-1.0, 1.0)),
                        rotation=tuple(float(x) for x in q / np.linalg.norm(q)))
        shape, params = [(CAPSULE, [0.15, 0.12]), (BALL, [0.2]),
                         (CUBOID, [0.18, 0.18, 0.18])][i % 3]
        if rounds and shape == CAPSULE:
            shape = 3 if i % 2 else 4           # CYLINDER, CONE
        pb.add_collider(b, shape, params, friction=0.5)
    return pb.initial_pose(), pb.build(broadphase="slab")


def _flagship(**kw):
    e, _ = build_flagship(n_bones=10, n_verts=300, n_bodies=192, **kw)
    st = e.init_state(1, device="cpu").physics
    return (st.position[0].numpy(), st.rotation[0].numpy()), e.physics


def _crowd():
    """108 balls in free fall in one coarse grid cell, 36 to a fine z slab
    (one sort key each, past jitter; the slabs take turns in grid index
    order, so every key spans both of the sort's 64-word runs), 0.02 m
    apart: most balls' walks pass their cap of 48 slots and their windows
    fill. A static cuboid far off widens the cell (the largest grid
    collider sets it)."""
    pb = PhysicsBuilder()
    g = pb.add_body(body_type=BodyType.STATIC, position=(-6.0, 0.0, 0.0))
    pb.add_collider(g, CUBOID, [0.4, 0.4, 0.4])
    for j in range(6):
        for i in range(6):
            for z in (0.43, 0.80, 1.17):
                b = pb.add_body(position=(0.25 + 0.22 * i, 1.3 + 0.22 * j, z))
                pb.add_collider(b, BALL, [0.1], friction=0.5)
    return pb.initial_pose(), pb.build(broadphase="slab")


SCENES = {"flagship": _flagship, "pile": _pile,
          "rounds": lambda: _pile(rounds=True),
          "platform": lambda: _pile(big_cuboid=True), "crowd": _crowd,
          "reuse": lambda: _flagship(broadphase_period=4)}


@pytest.fixture(scope="module", params=list(SCENES))
def settled(request):
    """Fused-step inputs after 25 steps, in 2 worlds jittered apart."""
    pose, t = SCENES[request.param]()
    st = tworld.init_physics_state(pose, t, 2, device="cpu")
    rng = np.random.default_rng(1)
    dyn = torch.as_tensor(t.body_type == 0)[None, :, None].float()
    st = st._replace(position=st.position + torch.as_tensor(rng.uniform(
        -0.05, 0.05, st.position.shape).astype(np.float32)) * dyn)
    for _ in range(25):
        st = tworld.step_physics(st, t, DT)
    accel, angvel = tworld.external_accelerations(st, t, DT)
    body, warm_lam, warm_pid = fused_step._inputs(st, t, accel, angvel)
    return request.param, t, body, warm_lam, warm_pid


def _walk_demand(t, col):
    """The slab walk's raw demand [W,Cg] and each grid collider's sort key
    on these collider planes (the plain broadphase's own numbers)."""
    amin, amax = fused_step._aabbs(t, col)
    cx = fused_step._statics(t).cx
    _, _, total = fused_step.bp_mod.class_windows(
        t.grid, cx.col_body, cx.dyn_col, amin, amax,
        fused_step._tight_delta(), plain=True)
    gmin = amin[:, torch.as_tensor(t.grid.grid_cols, dtype=torch.long)]
    cell = np.float32(t.grid.cell)
    zfine = np.float32(t.grid.cell / fused_step.bp_mod._ZFINE)
    key = fused_step.bp_mod._pack_xyz(
        torch.floor(gmin[..., 0] / cell).int(),
        torch.floor(gmin[..., 1] / cell).int(),
        torch.floor(gmin[..., 2] / zfine).int())
    return total, key


# K3 cases: the scene (the `settled` fixture's), fused_bp's blocks per world
# (0: as many as fill the emulated card: 2 for the flagship's 192 grid
# colliders over 2 worlds, 1 for the pile's 36) and whether the shared
# memory a block may use is cut to the least the kernel takes, so that the
# static word table stays in global memory and the walk goes in tiles of a
# few colliders
_BP_CASES = {
    "flagship": ("flagship", 0, False),
    "pile": ("pile", 0, False),
    "rounds": ("rounds", 0, False),
    "crowd": ("crowd", 0, False),
    "flagship-parts3": ("flagship", 3, False),
    "flagship-parts7": ("flagship", 7, False),
    "crowd-lean": ("crowd", 1, True),
}


@pytest.mark.parametrize("settled, parts, lean", list(_BP_CASES.values()),
                         ids=list(_BP_CASES), indirect=["settled"])
def test_fused_bp_matches_plain(on_cpu, monkeypatch, settled, parts, lean):
    """K3 against its plain version: windows equal as integers, collider
    planes bit-equal. The crowd holds 36 balls to one sort key (the sort's
    stability across its merge rounds) and sends most walks past their
    cap; the split cases walk each world's colliders over several blocks,
    each writing its slice of the collider planes."""
    scene, t, body = settled[:3]
    assert fused_step.supports_fused_bp(t)
    monkeypatch.setattr(fused_step, "_BP_PARTS", parts)
    fs = fused_step._statics(t)
    if lean:
        least = fused_step.bp_smem_bytes(fs.cx.cg, fs.ns)
        monkeypatch.setattr(tgs_kernel, "SMEM_LIMIT", least + 4 * fs.ns * 3)
    jv, col = fused_step._bp_candidates_cuda(t, body, DT)
    jv_p, col_p = fused_step.bp_candidates_plain(t, body, DT)
    assert (jv_p >= 0).sum() > 0
    if scene == "crowd":
        total, key = _walk_demand(t, col_p)
        assert int((total > t.grid.s_walk).sum()) >= 0.75 * 2 * 108
        assert int(torch.unique(key[0], return_counts=True)[1].max()) >= 36
    assert torch.equal(jv, jv_p)
    assert torch.equal(col, col_p)


# K2 cases: the scene and whether every window row of one collider in one
# world is cut to -1 (a collider with no candidate at all); the pile's 36
# grid colliders are not a multiple of the 32-wide tile; "flagship-tile8"
# cuts the shared memory a block may use so that the tile is 8 wide
_NC_CASES = {
    "flagship": ("flagship", False, None),
    "pile": ("pile", False, None),
    "rounds": ("rounds", False, None),
    "platform": ("platform", False, None),
    "crowd": ("crowd", False, None),
    "reuse": ("reuse", False, None),
    "pile-empty": ("pile", True, None),
    "flagship-tile8": ("flagship", False, 8),
}


@pytest.mark.parametrize("settled, empty, tile", list(_NC_CASES.values()),
                         ids=list(_NC_CASES), indirect=["settled"])
def test_narrow_compact_matches_plain(on_cpu, monkeypatch, settled, empty,
                                      tile):
    """K2 against its plain version on K3's windows or, where the scene
    takes the K2 route (the platform; the reuse flagship, windows 16 / 8 /
    12, walk 64, 69 window rows), on the PyTorch broadphase's."""
    scene, t, body, warm_lam, warm_pid = settled
    if fused_step.supports_fused_bp(t):
        jv, col = fused_step.bp_candidates_plain(t, body, DT)
    else:                               # the K2 route's windows
        col = fused_step.collider_planes(t, body, DT).contiguous()
        amin, amax = fused_step._aabbs(t, col)
        cx = fused_step._statics(t).cx
        jv = fused_step._jv_from_candidates(
            fused_step._statics(t), fused_step.bp_mod.slab_candidates(
                t.grid, cx.col_body, cx.dyn_col, amin, amax,
                tight_delta=fused_step._tight_delta()))
    fs = fused_step._statics(t)
    s = fs.cx.s_active
    assert fused_step._nc_tile(fs.wd, fs.ns, s) == 32
    if scene == "reuse":
        assert fs.wd == 69 and t.grid.s_walk == 64
    if empty:
        g = int(torch.nonzero((jv[0] >= 0).any(0))[0, 0])
        jv = jv.clone()
        jv[0, :, g] = -1
    if tile:
        monkeypatch.setattr(tgs_kernel, "SMEM_LIMIT", fused_step.nc_smem_bytes(
            fs.wd, fs.ns, s, tile))
        assert fused_step._nc_tile(fs.wd, fs.ns, s) == tile
    con, body_j, pid = fused_step._narrow_compact_cuda(t, col, jv, warm_lam,
                                                       warm_pid)
    con_p, body_j_p, pid_p = fused_step.narrow_compact_plain(
        t, col, jv, warm_lam, warm_pid)
    assert con_p[:, 9].sum() > 0
    if empty:
        assert (pid[0, :, g] == -1).all() and (con[0, 9, :, g] == 0).all()
    assert torch.equal(pid, pid_p) and torch.equal(body_j, body_j_p)
    assert torch.equal(con[:, 9], con_p[:, 9])
    # PyTorch's float32 sqrt on the CPU is not always correctly rounded (one
    # ulp off IEEE in the flagship case here); on the card both sides are
    # IEEE and agree bit for bit (chip_smoke.py phase K2nc)
    assert (con - con_p).abs().max() <= 1e-6


def _joint_zoo():
    pb, t = chip_smoke.joint_zoo(chip_smoke.port_lib())
    return pb.initial_pose(), t


_K1_INPUTS = {}


def _k1_inputs(scene):
    """K1's packed inputs of a settled step, 2 worlds jittered apart, with
    its parameters and joint tables (built once per scene)."""
    if scene not in _K1_INPUTS:
        pose, t = (_flagship if scene == "flagship" else _joint_zoo)()
        st = tworld.init_physics_state(pose, t, 2, device="cpu")
        st = chip_smoke.jitter(st, t, "cpu", 1)
        for _ in range(25):
            st = tworld.step_physics(st, t, DT)
        accel, angvel = tworld.external_accelerations(st, t, DT)
        packed, _ = slab2.solver_inputs(st, t, DT, accel, angvel)
        cx = slab2._ctx(t)
        _K1_INPUTS[scene] = (packed, tgs_kernel.solver_params(t, DT),
                             cx.has_com, slab2.joint_tables(cx, "cpu"))
    return _K1_INPUTS[scene]


def _punch_hole(con, body_j):
    """The packed inputs with slot 0 of one collider that has two or more
    live slots set to the unfilled-slot pattern (all planes 0, own 1,
    partner 0), so that its live slots are no longer a prefix."""
    act = con[0, 9]                                           # [S,Cg]
    g = int(torch.nonzero(act.sum(0) >= 2)[0, 0])
    con, body_j = con.clone(), body_j.clone()
    con[0, :, 0, g] = 0.0
    con[0, 10, 0, g] = 1.0
    body_j[0, 0, g] = 0
    assert con[0, 9, 1, g] != 0 and con[0, 9, 0, g] == 0
    return con, body_j


def _many_joints(packed, joints, copies):
    """The scene's bodies and joints `copies` times over: copy c's joints
    join copy c's bodies, and the contacts stay on copy 0, so that a small
    scene has more than 128 joints, each solved once a pass. (Repeating
    the tables on the same bodies would apply each joint's Jacobi impulse
    `copies` times, and the solve diverges.)"""
    con, body_j, body, col_body = packed
    nb = body.shape[2]
    shift = torch.arange(copies, dtype=torch.int32).repeat_interleave(
        joints.body_a.shape[0]) * nb
    return ((con, body_j, body.repeat(1, 1, copies).contiguous(), col_body),
            tgs_kernel.JointTables(
                body_a=joints.body_a.repeat(copies) + shift,
                body_b=joints.body_b.repeat(copies) + shift,
                jtab=joints.jtab.repeat(1, copies).contiguous()))


@pytest.mark.parametrize("case", ["flagship", "zoo", "hole", "big-flagship",
                                  "big-zoo", "many-zoo",
                                  "joints-global-many-zoo",
                                  "joints-global-big-many-zoo"])
def test_tgs_solve_matches_plain(on_cpu, monkeypatch, case):
    """K1 on a settled step's packed inputs, 2 worlds jittered apart, at the
    kernel's card bounds: the flagship (no joints, no COM) and the joint
    zoo (all four joint kinds, COM offsets); the flagship with a hole in
    one collider's live slots; both scenes through the global-memory
    variant (SMEM_LIMIT cut to the least a block with that variant needs,
    so its slot buffer holds 128 slots and every pass runs in tiles); and
    the zoo with its joint tables repeated past 128 joints, in shared
    memory, in global memory beside the body planes in shared memory, and
    in global memory with the global-memory variant."""
    scene = "zoo" if case.endswith("zoo") else "flagship"
    packed, p, has_com, joints = _k1_inputs(scene)
    assert (joints is not None) == has_com == (scene == "zoo")
    if case == "hole":
        packed = _punch_hole(packed[0], packed[1]) + tuple(packed[2:])
    if "many" in case:
        packed, joints = _many_joints(
            packed, joints, 130 // int(joints.body_a.shape[0]) + 1)
    con, nb, cg = packed[0], packed[2].shape[2], packed[0].shape[3]
    s = con.shape[2]
    nj = 0 if joints is None else int(joints.body_a.shape[0])
    if case.startswith("big"):
        least = tgs_kernel.smem_bytes(0, 0, n_joints=nj, n_slots=s)
        assert least < tgs_kernel.smem_bytes(nb, cg, has_com, nj)
        monkeypatch.setattr(tgs_kernel, "SMEM_LIMIT", least)
        assert tgs_kernel._layout(nb, cg, s, has_com, nj) == (
            True, False, 128)
        if scene == "flagship":         # several tiles of 128 live slots
            assert int(tgs_kernel.live_slots(con).min()) > 3 * 128
    elif case.startswith("joints-global"):
        # room for the body planes and 128 slots, not for the joint tables
        big = "big" in case
        least = tgs_kernel.smem_bytes(0 if big else nb, 0 if big else cg,
                                      has_com, 0, s)
        monkeypatch.setattr(tgs_kernel, "SMEM_LIMIT", least)
        assert tgs_kernel._layout(nb, cg, s, has_com, nj) == (big, True, 128)
    else:
        assert tgs_kernel._layout(nb, cg, s, has_com, nj)[:2] == (False,
                                                                  False)
    assert nj > 128 or "many" not in case
    assert con[:, 9].sum() > 0
    body, lam = tgs_kernel._solve_tgs_cuda(*packed, p, has_com, joints)
    assert torch.equal(tgs_kernel.visited_slots(),
                       tgs_kernel.live_slots(con))
    ref_b, ref_l = tgs_kernel.solve_tgs_plain(*packed, p, has_com=has_com,
                                              joints=joints)
    assert not torch.equal(ref_b[0], ref_b[1])
    # the card's bounds for K1 against its plain version (chip_smoke.py K1)
    assert (body[:, 6:13] - ref_b[:, 6:13]).abs().max() <= 1e-5
    assert (body[:, 0:6] - ref_b[:, 0:6]).abs().max() <= 1e-4
    assert ((lam - ref_l).abs() <= 1e-3 * ref_l.abs() + 1e-5).all()
    if case == "hole":
        # the dead slot's λ is written as 0, as the plain version has it
        g = int(torch.nonzero((con[0, 9, 0] == 0) & (con[0, 9, 1] != 0))[0, 0])
        assert (lam[0, :, 0, g] == 0).all() and (ref_l[0, :, 0, g] == 0).all()


@pytest.mark.parametrize("tables", [2, 1])
def test_plane_gather_matches_plain(on_cpu, tables):
    """Per-world planes, and one table every world reads (stride 0)."""
    rng = np.random.default_rng(0)
    planes = torch.as_tensor(rng.standard_normal((tables, 5, 40)).astype(
        np.float32))
    idx = torch.as_tensor(rng.integers(-5, 45, (2, 300)).astype(np.int32))
    got = plane_ops._plane_gather_cuda(planes, idx)
    assert torch.equal(got, plane_ops.plane_gather_plain(planes, idx))


@pytest.mark.parametrize("case", ["permutation", "repeats", "one_bucket",
                                  "empty", "tiles"])
def test_plane_scatter_matches_plain(on_cpu, case):
    """K4b against its plain version: a permutation bit-equal; repeats with
    out-of-range and negative indices within 1e-6 (the same sums, in
    ascending k, where the plain version's order is its own); all indices
    in three buckets (K >> N: long buckets), bit-equal to the ascending-k
    sums; every index out of range (all zeros); and a shape past one tile of output rows, one chunk of indices
    and one chunk of attribute rows (kMaxRows, kMaxIdx, kValFloats)."""
    rng = np.random.default_rng(3)
    w, a, k, n = {"one_bucket": (2, 20, 300, 8), "tiles": (1, 9, 4500, 4200)
                  }.get(case, (2, 20, 300, 260))
    vals = torch.as_tensor(rng.standard_normal((w, a, k)).astype(np.float32))
    if case == "permutation":
        idx = np.stack([rng.permutation(k) for _ in range(w)]) - 20
    elif case == "one_bucket":
        idx = rng.choice([0, 3, 7], (w, k))
    elif case == "empty":
        idx = rng.choice([-7, -1, n, n + 5], (w, k))
    else:
        idx = rng.integers(-10, n + 10, (w, k))
    idx = torch.as_tensor(idx.astype(np.int32))
    before = plane_ops.launches("plane_scatter")
    got = plane_ops._plane_scatter_cuda(vals, idx, n)
    assert plane_ops.launches("plane_scatter") == before + 1
    ref = plane_ops.plane_scatter_plain(vals, idx, n)
    if case == "empty":
        assert not ref.any() and not got.any()
    elif case == "one_bucket":
        assert (ref[..., [0, 3, 7]] != 0).all()
    else:
        assert (ref != 0).float().mean() > 0.5
    if case in ("permutation", "empty"):
        assert torch.equal(got, ref)
    elif case == "one_bucket":
        # buckets of ~100 values: bit-equal to the float32 sums in ascending
        # k; against plain (its own order) within twice the float32 bound of
        # a sum of m terms in any order, m·2⁻²⁴·Σ|v| (Higham)
        assert torch.equal(got, chip_smoke.scatter_in_order(vals, idx, n))
        bound = chip_smoke.scatter_sum_bound(vals, idx, n)
        assert ((got - ref).abs() <= 2 * bound).all()
    else:
        assert (got - ref).abs().max() <= 1e-6


def _raster_inputs(size, n_img=3, t=300, seed=0, cull=True):
    """Binned 2DH feature rows of seeded random triangles in n_img
    different images: enough per tile to walk several 64-row chunks."""
    from fyrox_tpu_torch.render import tile_raster
    h, w = size
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, (n_img, t, 1, 2))
    v = centers + rng.uniform(-0.4, 0.4, (n_img, t, 3, 2))
    depth = rng.uniform(-0.9, 0.9, (n_img, t, 1, 1))
    wc = rng.uniform(0.5, 2.0, (n_img, t, 1, 1))
    clip = np.concatenate([v * wc, np.broadcast_to(depth * wc, (n_img, t, 3, 1)),
                           np.broadcast_to(wc, (n_img, t, 3, 1))], -1)
    clip = torch.as_tensor(clip.astype(np.float32))
    tile_h, tile_w = min(8, h), min(128, w)
    feats, bbox, ok = tile_raster.tri_features_h(
        clip, torch.ones((n_img, t), dtype=torch.bool), h, w, cull)
    ids, count, _ = tile_raster.bin_triangles(bbox, ok, h, w, tile_h, tile_w,
                                              160)
    assert int(count.max()) > 64
    return feats.contiguous(), ids, count, h, w, tile_h, tile_w


@pytest.mark.parametrize("size", [(16, 256), (32, 32)])
def test_tile_raster_full_matches_plain(on_cpu, size):
    from fyrox_tpu_torch.render import tile_raster
    args = _raster_inputs(size)
    z, idx, w0, w1 = tile_raster._visibility_cuda(*args)
    zp, idxp, w0p, w1p = tile_raster.visibility_plain(*args)
    assert (idxp >= 0).float().mean() > 0.3
    assert not torch.equal(idxp[0], idxp[1])
    assert torch.equal(idx, idxp)
    for a, b in ((z, zp), (w0, w0p), (w1, w1p)):
        assert (a - b).abs().max() <= 1e-6


def test_tile_raster_depth_matches_plain(on_cpu):
    from fyrox_tpu_torch.render import tile_raster
    args = _raster_inputs((16, 256), cull=False, seed=1)
    z = tile_raster._visibility_cuda(*args, depth_only=True)
    zp = tile_raster.visibility_plain(*args, depth_only=True)
    assert (zp < 1e8).float().mean() > 0.3
    assert (z - zp).abs().max() <= 1e-6


# (height, width, tile_h, tile_w): the bench's 8 x 128 tiles of 8 x 16 warp
# rectangles; a small image's 8 x 32 tile; a 6 x 160 tile, which no grid of
# 8 rectangles covers (row-major runs of 128 pixels a warp)
_KNIFE_TILES = {"8x128": (16, 256, 8, 128), "8x32": (16, 64, 8, 32),
                "6x160": (12, 320, 6, 160)}


def _split_plan(count, n_slots, span, cap):
    """(parts, span) that csrc/tile_raster.cu's plan kernel chooses; none
    runs where no tile can be split (K = n_slots)."""
    if n_slots <= span or cap == 0:
        return 0, 2 ** 31 - 1
    n = count.flatten().tolist()
    for k in range(16):
        sp = span << k
        parts = sum(-(-c // sp) for c in n if c > sp)
        if parts <= cap:
            return parts, sp
    return 0, 2 ** 31 - 1


# (tile, SPLIT_SPAN, SPLIT_CAP): K5's own span and cap (tiles above 96
# slots split); no split (a cap of 0: no plan); every tile above 40 slots
# split; a cap of 5 parts, which doubles the span until the parts fit; a
# span above K (no plan)
@pytest.mark.parametrize("tiles,span,cap", [
    ("8x128", None, None), ("8x128", None, 0), ("8x128", 40, None),
    ("8x128", 40, 5), ("8x32", None, None), ("6x160", 40, None),
    ("8x128", 160, None)],
    ids=["8x128", "8x128-nosplit", "8x128-span40", "8x128-cap5", "8x32",
         "6x160-span40", "8x128-span-above-k"])
def test_tile_raster_on_knife_edges(on_cpu, monkeypatch, tiles, span, cap):
    """Edges through pixel centres on the warps' rectangle borders and the
    tiles' outer rows and columns, rows with ok = 0 or W <= 1e-12 nearest
    the camera, negative zeros, z ties, walks past one 64-row chunk
    (chip_smoke.k5_knife_edges): K5's per-warp rejection may skip only
    what the plain version finds outside, and tiles split into parts merge
    to the plain walk's winners."""
    from fyrox_tpu_torch.render import tile_raster
    span = span or tile_raster.SPLIT_SPAN
    cap = tile_raster.SPLIT_CAP if cap is None else cap
    monkeypatch.setattr(tile_raster, "SPLIT_SPAN", span)
    monkeypatch.setattr(tile_raster, "SPLIT_CAP", cap)
    h, w, th, tw = _KNIFE_TILES[tiles]
    args = chip_smoke.k5_knife_edges(h, w, th, tw, seed=len(tiles))
    assert int(args[2].max()) > 128
    z, idx, w0, w1 = tile_raster._visibility_cuda(*args)
    assert tile_raster.split_parts() == _split_plan(
        args[2], args[1].shape[2], span, cap)
    zp, idxp, w0p, w1p = tile_raster.visibility_plain(*args)
    hit = idxp >= 0
    assert 0.2 < hit.float().mean() < 0.98
    # pixels won on an edge (e0 = 0 or e1 = 0) count as inside
    assert ((w0p == 0) & hit).any() and ((w1p == 0) & hit).any()
    assert torch.equal(idx, idxp)
    for a, b in ((z, zp), (w0, w0p), (w1, w1p)):
        assert (a - b).abs().max() <= 1e-6
    zd = tile_raster._visibility_cuda(*args, depth_only=True)
    assert (zd - zp).abs().max() <= 1e-6


def test_tile_raster_split_keeps_the_first_of_tied_zeros(on_cpu, monkeypatch):
    """Rows covering a whole tile at z = +0 and z = -0, in different parts
    of a split tile (fillers with ok = 0 between them): the plain walk
    keeps the first of the tie, and its z's sign."""
    from fyrox_tpu_torch.render import tile_raster
    monkeypatch.setattr(tile_raster, "SPLIT_SPAN", 16)
    full = [1, 0, 0.5, 0, 1, 0.5, 0, 0, 4096]       # e0 = px, e1 = py
    feats = torch.tensor([full + [0, 0, 0.0, 0, 0, 1, 1],
                          full + [-0.0, -0.0, -0.0, 0, 0, 1, 1],
                          full + [0, 0, -0.5, 0, 0, 1, 0]])
    n = 48                                          # three parts of 16
    order = [[0] + [2] * (n - 2) + [1], [1] + [2] * (n - 2) + [0]]
    ids = torch.tensor([order], dtype=torch.int32)
    count = torch.full((1, 2), n, dtype=torch.int32)
    args = (feats[None].contiguous(), ids, count, 8, 256, 8, 128)
    z, idx, w0, w1 = tile_raster._visibility_cuda(*args)
    assert tile_raster.split_parts() == (6, 16)
    zp, idxp, _, _ = tile_raster.visibility_plain(*args)
    assert torch.equal(idx, idxp) and (idxp == 0).all()
    assert torch.equal(z.view(torch.int32), zp.view(torch.int32))
    assert (z[0, :, :128].view(torch.int32) == 0).all()          # +0
    assert (z[0, :, 128:].view(torch.int32) == -2 ** 31).all()   # -0


def _raster_inputs_affine(size, n_img=3, t=300, seed=0, cull=True):
    """Binned screen-affine feature rows (K5's affine variant) of seeded
    random triangles, a fifth of them crossing the near plane (clipped
    into two by raster.clip_near), in n_img different images."""
    from fyrox_tpu_torch.render import raster, tile_raster
    h, w = size
    rng = np.random.default_rng(seed)
    v = (rng.uniform(-1, 1, (n_img, t, 1, 2))
         + rng.uniform(-0.4, 0.4, (n_img, t, 3, 2)))
    depth = rng.uniform(-0.9, 0.9, (n_img, t, 1, 1))
    wc = rng.uniform(0.5, 2.0, (n_img, t, 3, 1))
    wc[:, ::5, 0] = -0.3                        # one vertex behind the eye
    clip = np.concatenate([v * wc, np.broadcast_to(depth, (n_img, t, 3, 1))
                           * wc, wc], -1)
    clip, _, valid = raster.clip_near(
        torch.as_tensor(clip.astype(np.float32)), {},
        torch.ones((n_img, t), dtype=torch.bool))
    tile_h, tile_w = min(8, h), min(128, w)
    feats, bbox, ok = tile_raster.tri_features(clip, valid, h, w, cull)
    ids, count, _ = tile_raster.bin_triangles(bbox, ok, h, w, tile_h, tile_w,
                                              160)
    assert int(count.max()) > 64
    return feats.contiguous(), ids, count, h, w, tile_h, tile_w


@pytest.mark.parametrize("size", [(16, 256), (64, 64)])
def test_tile_raster_affine_matches_plain(on_cpu, size):
    """K5's affine variant, full and depth-only, against visibility_plain
    on clipped triangles; 64 x 64 runs on the 8 x 64 tiles of the
    occlusion prepass and the point maps."""
    from fyrox_tpu_torch.render import tile_raster
    args = _raster_inputs_affine(size, n_img=2, t=200,
                                 cull=size[0] != 64)
    tile_raster.reset_launches()
    z, idx, w0, w1 = tile_raster._visibility_cuda(*args, affine=True)
    zp, idxp, w0p, w1p = tile_raster.visibility_plain(*args, affine=True)
    assert (idxp >= 0).float().mean() > 0.3
    assert not torch.equal(idxp[0], idxp[1])
    assert torch.equal(idx, idxp)
    for a, b in ((z, zp), (w0, w0p), (w1, w1p)):
        assert (a - b).abs().max() <= 1e-6
    zd = tile_raster._visibility_cuda(*args, depth_only=True, affine=True)
    assert (zd - zp).abs().max() <= 1e-6
    assert tile_raster.launches("full_affine") == 1
    assert tile_raster.launches("depth_affine") == 1
    assert tile_raster.launches("full") == tile_raster.launches("depth") == 0


@pytest.mark.parametrize("tiles,span,cap", [
    ("8x128", None, None), ("8x128", 40, None), ("6x160", 40, None)],
    ids=["8x128", "8x128-span40", "6x160-span40"])
def test_tile_raster_affine_on_knife_edges(on_cpu, monkeypatch, tiles, span,
                                           cap):
    """The affine variant's per-warp rejection (w0, w1, w2 and the z
    range) may skip only what the plain version finds outside, on rows
    whose forms are zero on pixel centres at the warps' rectangle borders
    (chip_smoke.k5_knife_edges_affine), split tiles included."""
    from fyrox_tpu_torch.render import tile_raster
    span = span or tile_raster.SPLIT_SPAN
    cap = tile_raster.SPLIT_CAP if cap is None else cap
    monkeypatch.setattr(tile_raster, "SPLIT_SPAN", span)
    monkeypatch.setattr(tile_raster, "SPLIT_CAP", cap)
    h, w, th, tw = _KNIFE_TILES[tiles]
    args = chip_smoke.k5_knife_edges_affine(h, w, th, tw, seed=len(tiles))
    z, idx, w0, w1 = tile_raster._visibility_cuda(*args, affine=True)
    assert tile_raster.split_parts() == _split_plan(
        args[2], args[1].shape[2], span, cap)
    zp, idxp, w0p, w1p = tile_raster.visibility_plain(*args, affine=True)
    hit = idxp >= 0
    assert 0.2 < hit.float().mean() < 0.98
    assert ((w0p == 0) & hit).any() and ((w1p == 0) & hit).any()
    assert torch.equal(idx, idxp)
    for a, b in ((z, zp), (w0, w0p), (w1, w1p)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    zd = tile_raster._visibility_cuda(*args, depth_only=True, affine=True)
    assert torch.equal(zd.view(torch.int32), zp.view(torch.int32))
