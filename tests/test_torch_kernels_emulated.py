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
        code = re.sub(r"(\w+)<<<([^,]+),([^,]+),([^,]+),[^>]*>>>\(",
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


def _pile(big_cuboid=False, n=36, seed=5):
    """Capsules, balls and cuboids at seeded random orientations over a
    halfspace (K3) or a finite cuboid platform (K2)."""
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
        pb.add_collider(b, shape, params, friction=0.5)
    return pb.initial_pose(), pb.build(broadphase="slab")


def _flagship():
    e, _ = build_flagship(n_bones=10, n_verts=300, n_bodies=192)
    st = e.init_state(1, device="cpu").physics
    return (st.position[0].numpy(), st.rotation[0].numpy()), e.physics


SCENES = {"flagship": _flagship, "pile": _pile,
          "platform": lambda: _pile(big_cuboid=True)}


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


@pytest.mark.parametrize("settled", ["flagship", "pile"], indirect=True)
def test_fused_bp_matches_plain(on_cpu, settled):
    scene, t, body = settled[:3]
    assert fused_step.supports_fused_bp(t)
    jv, col = fused_step._bp_candidates_cuda(t, body, DT)
    jv_p, col_p = fused_step.bp_candidates_plain(t, body, DT)
    assert (jv_p >= 0).sum() > 0
    assert torch.equal(jv, jv_p)
    assert torch.equal(col, col_p)


def test_narrow_compact_matches_plain(on_cpu, settled):
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
    con, body_j, pid = fused_step._narrow_compact_cuda(t, col, jv, warm_lam,
                                                       warm_pid)
    con_p, body_j_p, pid_p = fused_step.narrow_compact_plain(
        t, col, jv, warm_lam, warm_pid)
    assert con_p[:, 9].sum() > 0
    assert torch.equal(pid, pid_p) and torch.equal(body_j, body_j_p)
    assert torch.equal(con[:, 9], con_p[:, 9])
    # PyTorch's float32 sqrt on the CPU is not always correctly rounded (one
    # ulp off IEEE in the flagship case here); on the card both sides are
    # IEEE and agree bit for bit (chip_smoke.py phase K2nc)
    assert (con - con_p).abs().max() <= 1e-6


def _joint_zoo():
    pb, t = chip_smoke.joint_zoo(chip_smoke.port_lib())
    return pb.initial_pose(), t


@pytest.mark.parametrize("scene", ["flagship", "zoo"])
def test_tgs_solve_matches_plain(on_cpu, scene):
    """K1 on a settled step's packed inputs, 2 worlds jittered apart: the
    flagship (no joints, no COM) and the joint zoo (all four joint kinds,
    COM offsets), at the kernel's card bounds."""
    pose, t = (_flagship if scene == "flagship" else _joint_zoo)()
    st = tworld.init_physics_state(pose, t, 2, device="cpu")
    st = chip_smoke.jitter(st, t, "cpu", 1)
    for _ in range(25):
        st = tworld.step_physics(st, t, DT)
    accel, angvel = tworld.external_accelerations(st, t, DT)
    packed, _ = slab2.solver_inputs(st, t, DT, accel, angvel)
    cx = slab2._ctx(t)
    p = tgs_kernel.solver_params(t, DT)
    joints = slab2.joint_tables(cx, "cpu")
    assert (joints is not None) == cx.has_com == (scene == "zoo")
    assert packed[0][:, 9].sum() > 0
    body, lam = tgs_kernel._solve_tgs_cuda(*packed, p, cx.has_com, joints)
    ref_b, ref_l = tgs_kernel.solve_tgs_plain(*packed, p, has_com=cx.has_com,
                                              joints=joints)
    assert not torch.equal(ref_b[0], ref_b[1])
    # the card's bounds for K1 against its plain version (chip_smoke.py K1)
    assert (body[:, 6:13] - ref_b[:, 6:13]).abs().max() <= 1e-5
    assert (body[:, 0:6] - ref_b[:, 0:6]).abs().max() <= 1e-4
    assert ((lam - ref_l).abs() <= 1e-3 * ref_l.abs() + 1e-5).all()


def test_plane_gather_matches_plain(on_cpu):
    rng = np.random.default_rng(0)
    planes = torch.as_tensor(rng.standard_normal((2, 5, 40)).astype(
        np.float32))
    idx = torch.as_tensor(rng.integers(-5, 45, (2, 300)).astype(np.int32))
    got = plane_ops._plane_gather_cuda(planes, idx)
    assert torch.equal(got, plane_ops.plane_gather_plain(planes, idx))


@pytest.mark.parametrize("case", ["permutation", "repeats"])
def test_plane_scatter_matches_plain(on_cpu, case):
    """K4b over two index tiles, two blocks of rows and two attribute
    chunks: a permutation bit-equal, repeats with out-of-range and
    negative indices within 1e-6 (sums in another order)."""
    rng = np.random.default_rng(3)
    w, a, k, n = 2, 20, 300, 260
    vals = torch.as_tensor(rng.standard_normal((w, a, k)).astype(np.float32))
    if case == "permutation":
        idx = np.stack([rng.permutation(k) for _ in range(w)]) - 20
    else:
        idx = rng.integers(-10, n + 10, (w, k))
    idx = torch.as_tensor(idx.astype(np.int32))
    before = plane_ops.launches("plane_scatter")
    got = plane_ops._plane_scatter_cuda(vals, idx, n)
    assert plane_ops.launches("plane_scatter") == before + 1
    ref = plane_ops.plane_scatter_plain(vals, idx, n)
    assert (ref != 0).float().mean() > 0.5
    if case == "permutation":
        assert torch.equal(got, ref)
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
