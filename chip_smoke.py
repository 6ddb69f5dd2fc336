"""GPU smoke run of the PyTorch port (fyrox_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line; any failure exits non-zero before the
last line:
  device   — needs a CUDA card; prints its name and power limit, TF32 off;
  build    — builds the port's CUDA kernels from csrc/ (one nvcc per file);
  K4a      — plane_gather kernel vs its plain version at the flagship's
             staged gather shapes, bit-equal;
  K1       — TGS solve kernel vs its plain version on the packed inputs of
             one flagship step after 30 settling ticks, in worlds that
             differ from one another;
  K3bp     — fused_bp kernel vs its plain version on the same settled
             full-width flagship: candidate windows equal as integers, and
             different across worlds;
  K2nc     — narrow_compact kernel vs its plain version on those windows:
             pid, partner body and activity equal, floats within 1e-5, and
             two launches equal bit for bit;
  fused    — one whole fused step (K3 → K2 → K1 kernels) vs the same step
             through the plain versions, at K1's bounds;
  small    — a small flagship on the card agrees with the same flagship on
             the CPU over 30 ticks (fused route, worlds differing);
  mixed    — a capsule / cuboid / ball pile on a halfspace, card vs CPU over
             30 ticks; all 9 manifold combos run on the card;
  K2route  — the pile on a finite big cuboid (K2 route: PyTorch broadphase,
             narrow_compact, K1), card vs CPU over 30 ticks;
  slice    — the full-width flagship (100 bones / 50k vertices / 1000
             bodies), WORLDS worlds, fused route: CALLS rolls of TICKS engine
             ticks + skinning, timed, launch counts checked;
  staged   — the same flagship on the staged route (fused=False) from the
             slice's last state, STAGED ticks, timed, launch counts checked;
  profile  — torch.profiler over PROFILED ticks of each route, from the
             slice's last state: device
             events (kernels, copies, fills) per tick and the device's busy
             share.
Then one JSON line describing the kernels, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

WORLDS = 128    # the flagship's batch in bench.py
TICKS = 20      # engine ticks per roll, as bench.py scans
CALLS = 3       # timed rolls after one warm-up roll
STAGED = 5      # staged-route ticks, timed after one warm-up tick
PROFILED = 3    # ticks under the profiler, per route
CARD = ""
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps):
    """Mean milliseconds per call of fn on the card (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, n_ops):
    """Least time for the work: bytes over HBM rate vs operations over the
    float32 peak; returns (ms, "bytes" | "operations")."""
    t_b, t_o = n_bytes / HBM_BYTES_S * 1e3, n_ops / F32_OPS_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def distinct_worlds(engine, w, device, seed=0):
    """engine.init_state(w) with seeded per-world jitter of the dynamic
    bodies' positions (±5 cm) and velocities (±0.5 m/s), so that no two
    worlds hold the same state and a kernel that reads another world's
    slice disagrees with its plain version."""
    st = engine.init_state(w, device=device)
    return st._replace(physics=jitter(st.physics, engine.physics, device,
                                      seed))


def jitter(ph, t, device, seed):
    from fyrox_tpu_torch.physics.world import DYNAMIC
    rng = np.random.default_rng(seed)
    dyn = torch.as_tensor(t.body_type == DYNAMIC, device=device)
    dyn = dyn[None, :, None].float()

    def noise(scale):
        return torch.as_tensor(rng.uniform(-scale, scale, ph.position.shape)
                               .astype(np.float32), device=device) * dyn

    return ph._replace(position=ph.position + noise(0.05),
                       linvel=ph.linvel + noise(0.5))


def all_differ(x):
    """True when no two worlds (leading axis) of x are equal."""
    return torch.unique(x.flatten(1), dim=0).shape[0] == x.shape[0]


def reset_all_launches():
    from fyrox_tpu_torch.physics import fused_step, plane_ops, tgs_kernel
    plane_ops.reset_launches()
    tgs_kernel.reset_launches()
    fused_step.reset_launches()


def all_launches():
    from fyrox_tpu_torch.physics import fused_step, plane_ops, tgs_kernel
    return dict(fused_bp=fused_step.launches("fused_bp"),
                narrow_compact=fused_step.launches("narrow_compact"),
                solve_tgs=tgs_kernel.launches(),
                plane_gather=plane_ops.launches())


def phase_device():
    global CARD
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    import fyrox_tpu_torch
    fyrox_tpu_torch.disable_tf32()
    log(f"[device] {torch.cuda.get_device_name(0)} | {CARD} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")


def phase_build():
    from fyrox_tpu_torch import kernels
    kernels.library()
    log(f"[build] kernels built/loaded in {kernels.build_seconds():.1f} s "
        f"from {kernels.CSRC}")


def phase_plane_gather(engine):
    from fyrox_tpu_torch.physics import plane_ops
    t = engine.physics
    sc = t.grid
    cg, c = int(sc.grid_cols.size), t.num_colliders
    rng = np.random.default_rng(0)
    # (attributes, rows, gathered columns): the narrowphase partner gather
    # per present class, the broadphase sort and the broadphase walk
    shapes = [(19, c, cg * sc.nslot(k)) for k in range(3) if sc.nslot(k)]
    shapes += [(10, cg, cg), (10, cg, cg * sc.s_walk)]
    worst = 0.0
    t_k = t_p = t_lib = 0.0
    moved = 0
    for a, n, k in shapes:
        planes = torch.as_tensor(rng.standard_normal((WORLDS, a, n)).astype(
            np.float32), device="cuda")
        idx = torch.as_tensor(rng.integers(-n // 8, n + n // 8, (WORLDS, k)
                                           ).astype(np.int32), device="cuda")
        got = plane_ops.plane_gather(planes, idx)
        ref = plane_ops.plane_gather_plain(planes, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"plane_gather differs from its plain version at "
                 f"[{WORLDS},{a},{n}] x [{WORLDS},{k}]")
        worst = max(worst, (got - ref).abs().max().item())
        t_k += cuda_ms(lambda: plane_ops.plane_gather(planes, idx), 20)
        t_p += cuda_ms(lambda: plane_ops.plane_gather_plain(planes, idx), 20)
        # the library yardstick: one torch.gather over a copy padded with a
        # zero column, out-of-range indices sent to it (set-up not timed)
        padded = torch.cat([planes, planes.new_zeros((WORLDS, a, 1))], 2)
        ok = (idx >= 0) & (idx < n)
        lib_idx = torch.where(ok, idx, n).long()[:, None, :].expand(
            WORLDS, a, k)
        if not torch.equal(torch.gather(padded, 2, lib_idx), ref):
            fail("the torch.gather yardstick of plane_gather disagrees")
        t_lib += cuda_ms(lambda: torch.gather(padded, 2, lib_idx), 20)
        moved += nbytes(planes, idx, got)
    b_ms, b_by = bound_ms(moved, 0)
    log(f"[K4a] plane_gather bit-equal to plain on {len(shapes)} flagship "
        f"shapes (W={WORLDS}); kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
        f"torch.gather {t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}) per "
        f"tick's set of staged gathers")
    return dict(name="plane_gather", route="cuda",
                source="fyrox_tpu_torch/csrc/plane_gather.cu",
                replaces="fyrox_tpu/physics/pallas_ops.py:171",
                max_abs_err=worst, ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=t_lib)


def settled_inputs(engine):
    """The settled full-width flagship: W distinct worlds after 30 ticks,
    and the fused step's inputs (body planes, warm carries)."""
    from fyrox_tpu_torch.physics import fused_step
    from fyrox_tpu_torch.physics import world as phys_mod
    state = distinct_worlds(engine, WORLDS, "cuda")
    for _ in range(30):
        state = engine.step(state)
    t = engine.physics
    accel, angvel = phys_mod.external_accelerations(state.physics, t,
                                                    engine.dt)
    body, warm_lam, warm_pid = fused_step._inputs(state.physics, t, accel,
                                                  angvel)
    return state, accel, angvel, body, warm_lam, warm_pid


def k1_ops(s, cg, w, p):
    """Float operations of K1 per call: a hand count of csrc/tgs_solve.cu
    per contact slot (prep 250; per substep warm start 60 + 120 per PGS pass
    + depth update 52; restitution 100; per stabilisation pass 103). Every
    slot is processed, active or not."""
    per_slot = 250 + p.n_sub * (60 + 120 * p.n_pgs + 52) + 100 + 103 * p.n_stab
    return per_slot * s * cg * w


def phase_solver(engine, inputs):
    from fyrox_tpu_torch.physics import slab2, tgs_kernel
    state, accel, angvel = inputs[:3]
    t = engine.physics
    dt = engine.dt
    packed, _ = slab2.solver_inputs(state.physics, t, dt, accel, angvel)
    params = tgs_kernel.solver_params(t, dt)
    n_act = int(packed[0][:, 9].sum().item())
    if not (all_differ(packed[0]) and all_differ(packed[2])):
        fail("the solver's packed inputs repeat across worlds")
    got_b, got_l = tgs_kernel.solve_tgs(*packed, params)
    ref_b, ref_l = tgs_kernel.solve_tgs_plain(*packed, params)
    torch.cuda.synchronize()
    err_pos = (got_b[:, 6:9] - ref_b[:, 6:9]).abs().max().item()
    err_vel = (got_b[:, 0:6] - ref_b[:, 0:6]).abs().max().item()
    err_q = (got_b[:, 9:13] - ref_b[:, 9:13]).abs().max().item()
    lam_excess = ((got_l - ref_l).abs()
                  - (1e-3 * ref_l.abs() + 1e-5)).max().item()
    err_lam = (got_l - ref_l).abs().max().item()
    if not (torch.isfinite(got_b).all() and torch.isfinite(got_l).all()):
        fail("solve_tgs kernel produced non-finite values")
    if n_act == 0:
        fail("no active contacts after 30 settling ticks")
    # bounds: ten times the JAX package's own bounds between two
    # implementations of one cold step (pos 1e-6, vel 1e-5, lambda 1e-4),
    # for the card's different summation order
    if err_pos > 1e-5 or err_q > 1e-5 or err_vel > 1e-4 or lam_excess > 0:
        fail(f"solve_tgs kernel vs plain: pos {err_pos:.3g} (1e-5), quat "
             f"{err_q:.3g} (1e-5), vel {err_vel:.3g} (1e-4), lambda "
             f"{err_lam:.3g} (1e-3 rel + 1e-5)")
    ms_k = cuda_ms(lambda: tgs_kernel.solve_tgs(*packed, params), 10)
    ms_p = cuda_ms(lambda: tgs_kernel.solve_tgs_plain(*packed, params), 3)
    w, _, s, cg = packed[0].shape
    b_ms, b_by = bound_ms(nbytes(*packed, got_b, got_l),
                          k1_ops(s, cg, w, params))
    log(f"[K1] solve_tgs matches plain on a settled flagship step "
        f"(W={WORLDS} distinct worlds, {n_act} active contact points): pos "
        f"{err_pos:.3g}, quat {err_q:.3g}, vel {err_vel:.3g}, lambda "
        f"{err_lam:.3g}; kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    return dict(name="solve_tgs", route="cuda",
                source="fyrox_tpu_torch/csrc/tgs_solve.cu",
                replaces="fyrox_tpu/physics/pallas_solver.py:816",
                max_abs_err=max(err_pos, err_vel, err_q, err_lam),
                ms=ms_k, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def bp_ops(t, w):
    """Operations of fused_bp per call, counted with every walk at its cap
    of s_walk slots (an upper bound; the bytes bound it anyway): pose 3 per
    collider; AABB and keys 80 per grid collider; a bitonic sort of n² log²
    n / 4 compare-swaps; 18 binary searches of log2(Cg) steps; 20 per walked
    slot."""
    cg, c = int(t.grid.grid_cols.size), t.num_colliders
    np2 = 1 << max(cg - 1, 0).bit_length()
    lg = max(np2.bit_length() - 1, 1)
    per_world = (3 * c + 80 * cg + np2 // 2 * lg * (lg + 1) // 2
                 + cg * (18 * lg + 20 * int(t.grid.s_walk)))
    return per_world * w


# float operations per valid candidate pair by canonical kind combo: hand
# counts of csrc/np_planes.cuh (a multiply, add, compare, divide or square
# root is one), plus 55 per pair for the two rotations, the prediction
# distance, friction and restitution
_COMBO_OPS = {(0, 0): 26, (0, 1): 115, (0, 2): 64, (0, 5): 21, (2, 2): 121,
              (1, 2): 246, (2, 5): 45, (1, 1): 1690, (1, 5): 540}


def combo_census(t, jv):
    """Valid candidate pairs of jv [W,NS,Cg] by canonical kind combo."""
    from fyrox_tpu_torch._util import const
    from fyrox_tpu_torch.physics import fused_step
    fs = fused_step._statics(t)
    kinds = const(fs.kinds, jv.device).long()
    ki = kinds[const(fs.grid_cols, jv.device).long()][None, None, :]
    ok = jv >= 0
    kj = kinds[jv.clamp(min=0).long()]
    code = (torch.minimum(ki, kj) * 16 + torch.maximum(ki, kj))[ok]
    vals, counts = torch.unique(code, return_counts=True)
    return {(int(v) // 16, int(v) % 16): int(n)
            for v, n in zip(vals.tolist(), counts.tolist())}


def phase_bp(engine, inputs):
    from fyrox_tpu_torch.physics import fused_step
    body = inputs[3]
    t = engine.physics
    dt = engine.dt
    jv, col = fused_step.bp_candidates(t, body, dt)
    jv_p, col_p = fused_step.bp_candidates_plain(t, body, dt)
    torch.cuda.synchronize()
    if not torch.equal(jv, jv_p):
        fail(f"fused_bp windows differ from the plain version at "
             f"{int((jv != jv_p).sum())} of {jv.numel()} entries")
    if not torch.equal(col, col_p):
        fail(f"fused_bp collider planes differ from the plain version by "
             f"{(col - col_p).abs().max().item():.3g}")
    if not all_differ(jv):
        fail("the candidate windows repeat across worlds")
    n_valid = int((jv >= 0).sum())
    ms_k = cuda_ms(lambda: fused_step.bp_candidates(t, body, dt), 20)
    ms_p = cuda_ms(lambda: fused_step.bp_candidates_plain(t, body, dt), 5)
    fs = fused_step._statics(t)
    statics = sum(a.nbytes for a in (fs.col_body, fs.shape, fs.kinds,
                                     fs.dyn, fs.col_sta, fs.col_off,
                                     fs.sweep_cap, fs.grid_cols, fs.cls_tab,
                                     fs.jv_big))
    # the kernel reads 10 of the 26 body planes
    moved = body.numel() * 4 * 10 // 26 + statics + nbytes(jv, col)
    b_ms, b_by = bound_ms(moved, bp_ops(t, WORLDS))
    log(f"[K3bp] fused_bp windows equal to plain as integers (W={WORLDS} "
        f"distinct worlds, {n_valid} valid candidates), collider planes "
        f"bit-equal; kernel {ms_k:.4f} ms, plain {ms_p:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    return dict(name="fused_bp", route="cuda",
                source="fyrox_tpu_torch/csrc/fused_bp.cu",
                replaces="fyrox_tpu/physics/pallas_step.py:794",
                max_abs_err=0.0, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=None), (jv, col)


def phase_nc(engine, inputs, windows):
    from fyrox_tpu_torch.physics import fused_step
    _, _, _, body, warm_lam, warm_pid = inputs
    jv, col = windows
    t = engine.physics
    got = fused_step.narrow_compact(t, col, jv, warm_lam, warm_pid)
    again = fused_step.narrow_compact(t, col, jv, warm_lam, warm_pid)
    ref = fused_step.narrow_compact_plain(t, col, jv, warm_lam, warm_pid)
    torch.cuda.synchronize()
    con, body_j, pid = got
    con_p, body_j_p, pid_p = ref
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("narrow_compact: two launches on the same inputs differ")
    if not (torch.equal(pid, pid_p) and torch.equal(body_j, body_j_p)):
        fail(f"narrow_compact pids / partner bodies differ from plain at "
             f"{int((pid != pid_p).sum())} / {int((body_j != body_j_p).sum())}"
             " slots")
    if not torch.equal(con[:, 9], con_p[:, 9]):
        fail("narrow_compact activity differs from plain")
    err = (con - con_p).abs().max().item()
    # the same float32 operations in the same order: 1e-5 leaves room for
    # nothing but rounding
    if not (err <= 1e-5 and torch.isfinite(con).all()):
        fail(f"narrow_compact planes differ from plain by {err:.3g} (1e-5)")
    n_act = int(con[:, 9].sum())
    matched = int((con[:, 12] != 0).sum())
    if n_act == 0 or matched == 0:
        fail(f"narrow_compact: {n_act} active slots, {matched} warm-started")
    ms_k = cuda_ms(lambda: fused_step.narrow_compact(
        t, col, jv, warm_lam, warm_pid), 20)
    ms_p = cuda_ms(lambda: fused_step.narrow_compact_plain(
        t, col, jv, warm_lam, warm_pid), 3)
    fs = fused_step._statics(t)
    census = combo_census(t, jv)
    ops = (sum(n * (_COMBO_OPS.get(k, 0) + 55) for k, n in census.items())
           + 10 * fs.wd * jv.shape[0] * jv.shape[2])
    statics = sum(a.nbytes for a in (fs.col_body, fs.kinds, fs.col_sta,
                                     fs.grid_cols))
    b_ms, b_by = bound_ms(nbytes(col, jv, warm_lam, warm_pid, *got)
                          + statics, ops)
    log(f"[K2nc] narrow_compact equal to plain on pid, partner body and "
        f"activity, planes within {err:.3g}, two launches bit-equal "
        f"({n_act} active slots, {matched} warm-started); kernel "
        f"{ms_k:.4f} ms, plain {ms_p:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(name="narrow_compact", route="cuda",
                source="fyrox_tpu_torch/csrc/narrow_compact.cu",
                replaces="fyrox_tpu/physics/pallas_step.py:641",
                max_abs_err=err, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def phase_fused_step(engine, inputs):
    """One whole fused step through the kernels vs through the plain
    versions, on the card, from the same inputs."""
    from fyrox_tpu_torch._util import const
    from fyrox_tpu_torch.physics import fused_step, slab2, tgs_kernel
    state, accel, angvel, body, warm_lam, warm_pid = inputs
    t = engine.physics
    dt = engine.dt
    got_b, got_l, got_pid = fused_step.fused_full_step(state.physics, t, dt,
                                                       accel, angvel)
    jv, col = fused_step.bp_candidates_plain(t, body, dt)
    con, body_j, pid = fused_step.narrow_compact_plain(t, col, jv, warm_lam,
                                                       warm_pid)
    ref_b, ref_l = tgs_kernel.solve_tgs_plain(
        con, body_j, body, const(slab2._ctx(t).grid_body, body.device),
        tgs_kernel.solver_params(t, dt))
    torch.cuda.synchronize()
    err_pos = (got_b[:, 6:13] - ref_b[:, 6:13]).abs().max().item()
    err_vel = (got_b[:, 0:6] - ref_b[:, 0:6]).abs().max().item()
    lam_excess = ((got_l - ref_l).abs()
                  - (1e-3 * ref_l.abs() + 1e-5)).max().item()
    if not torch.equal(got_pid, pid):
        fail("the fused step's point identities differ from the plain step")
    if err_pos > 1e-5 or err_vel > 1e-4 or lam_excess > 0:
        fail(f"fused step vs plain: pos/quat {err_pos:.3g} (1e-5), vel "
             f"{err_vel:.3g} (1e-4), lambda over 1e-3 rel + 1e-5 by "
             f"{lam_excess:.3g}")
    log(f"[fused] one fused step (fused_bp → narrow_compact → solve_tgs) "
        f"matches the plain step (W={WORLDS}): pos/quat {err_pos:.3g}, vel "
        f"{err_vel:.3g}, lambda {(got_l - ref_l).abs().max().item():.3g}, "
        f"pids equal")


def card_vs_cpu(label, t, state_cpu, ticks, step):
    """Step the same state on the card and on the CPU; return (dp, dv,
    live contact points, card states per tick)."""
    from fyrox_tpu_torch import convert
    gpu = convert.physics_state(convert.to_numpy(state_cpu), device="cuda")
    cpu = state_cpu
    seen = []
    for _ in range(ticks):
        seen.append(gpu)
        gpu = step(gpu)
        cpu = step(cpu)
    dp = (gpu.position.cpu() - cpu.position).abs().max().item()
    dv = (gpu.linvel.cpu() - cpu.linvel).abs().max().item()
    live = int((cpu.warm_pair >= 0).sum())
    # the CPU test suite's trajectory bounds between two implementations
    # of the same 30-step trajectory (dp 5e-4, dv 5e-3)
    if not (dp < 5e-4 and dv < 5e-3 and live > 0):
        fail(f"{label}: card vs CPU dp {dp:.3g}, dv {dv:.3g}, live contact "
             f"points {live}")
    if not all_differ(cpu.position):
        fail(f"{label}: the worlds are equal")
    return dp, dv, live, seen


def phase_small():
    """A small flagship on the card agrees with the same one on the CPU."""
    from fyrox_tpu_torch.animation import skinning
    from fyrox_tpu_torch.models import build_flagship
    from fyrox_tpu_torch.physics import fused_step
    engine, skin = build_flagship(n_bones=10, n_verts=300, n_bodies=192)
    if not fused_step.supports_fused_bp(engine.physics):
        fail("the small flagship is outside the K3 scope")
    gpu = distinct_worlds(engine, 4, "cuda")
    cpu = distinct_worlds(engine, 4, "cpu")
    reset_all_launches()
    for _ in range(30):
        gpu = engine.step(gpu)
        cpu = engine.step(cpu)
    n = all_launches()

    def skinned(st):
        bm = skinning.bone_matrices(st.scene.globals_, skin)
        return skinning.skin_positions_dense(bm, skin).cpu()

    dp = (gpu.physics.position.cpu() - cpu.physics.position).abs().max()
    dv = (gpu.physics.linvel.cpu() - cpu.physics.linvel).abs().max()
    dvert = (skinned(gpu) - skinned(cpu)).abs().max()
    contacts = int((cpu.physics.warm_pair >= 0).sum())
    if not all_differ(cpu.physics.position):
        fail("the small flagship's worlds are equal")
    if n["fused_bp"] != 30 or n["narrow_compact"] != 30 or n["plane_gather"]:
        fail(f"the small flagship did not take the K3 route: {n}")
    if not (dp < 5e-4 and dv < 5e-3 and dvert < 1e-3 and contacts > 0):
        fail(f"card vs CPU on the small flagship: dp {dp:.3g}, dv {dv:.3g},"
             f" skinned {dvert:.3g}, live contact points {contacts}")
    log(f"[small] card == CPU over 30 ticks on the fused route (W=4 distinct"
        f" worlds, 192 bodies, {contacts} live contact points): dp "
        f"{dp:.3g}, dv {dv:.3g}, skinned {dvert:.3g}")


def pile_scene(big_cuboid=False, n=48, seed=5):
    """Capsules, balls and cuboids at seeded random orientations, on a
    halfspace or on a finite static cuboid platform (broadphase-big, so
    the K2 route)."""
    from fyrox_tpu_torch.physics import (BALL, CAPSULE, CUBOID, HALFSPACE,
                                         BodyType, PhysicsBuilder)
    rng = np.random.default_rng(seed)
    rot = np.random.default_rng(seed + 100)
    pb = PhysicsBuilder()
    if big_cuboid:
        g = pb.add_body(body_type=BodyType.STATIC, position=(0.0, -0.2, 0.0))
        pb.add_collider(g, CUBOID, [4.0, 0.2, 4.0], friction=0.7)
    else:
        g = pb.add_body(body_type=BodyType.STATIC)
        pb.add_collider(g, HALFSPACE, [], friction=0.7)
    for i in range(n):
        p = (rng.uniform(-1.2, 1.2), 0.4 + 0.3 * (i // 8),
             rng.uniform(-1.2, 1.2))
        q = rot.standard_normal(4)
        b = pb.add_body(position=p,
                        rotation=tuple(float(x) for x in q / np.linalg.norm(q)))
        if i % 3 == 0:
            pb.add_collider(b, CAPSULE, [0.15, 0.12], friction=0.5)
        elif i % 3 == 1:
            pb.add_collider(b, BALL, [0.2], friction=0.5, restitution=0.2)
        else:
            pb.add_collider(b, CUBOID, [0.18, 0.18, 0.18], friction=0.5)
    return pb, pb.build(broadphase="slab")


def phase_piles():
    from fyrox_tpu_torch.physics import fused_step
    from fyrox_tpu_torch.physics import world as phys_mod
    dt = 1.0 / 60.0

    def step(st):
        return phys_mod.step_physics(st, t, dt)

    # all 9 combos on the card, K3 route
    pb, t = pile_scene()
    if not fused_step.supports_fused_bp(t):
        fail("the mixed pile is outside the K3 scope")
    st0 = jitter(phys_mod.init_physics_state(pb.initial_pose(), t, 4,
                                             device="cpu"), t, "cpu", 7)
    reset_all_launches()
    dp, dv, live, seen = card_vs_cpu("mixed pile", t, st0, 30, step)
    n = all_launches()
    census = {}
    for st in seen:
        accel, angvel = phys_mod.external_accelerations(st, t, dt)
        body = fused_step._inputs(st, t, accel, angvel)[0]
        for k, v in combo_census(t, fused_step.bp_candidates(
                t, body, dt)[0]).items():
            census[k] = census.get(k, 0) + v
    if len(census) != 9 or n["fused_bp"] != 30:
        fail(f"mixed pile: combos {sorted(census)}, launches {n}")
    log(f"[mixed] capsule/ball/cuboid pile, card == CPU over 30 ticks on the"
        f" K3 route (W=4 distinct worlds, {live} live contact points, all 9 "
        f"kind combos among {sum(census.values())} candidate pairs): dp "
        f"{dp:.3g}, dv {dv:.3g}")
    # the K2 route
    pb, t = pile_scene(big_cuboid=True)
    if not (fused_step.supports_fused(t)
            and not fused_step.supports_fused_bp(t)):
        fail("the platform pile is not in the K2-only scope")
    st0 = jitter(phys_mod.init_physics_state(pb.initial_pose(), t, 4,
                                             device="cpu"), t, "cpu", 8)
    reset_all_launches()
    dp, dv, live, _ = card_vs_cpu("platform pile", t, st0, 30, step)
    n = all_launches()
    if n["fused_bp"] or n["narrow_compact"] != 30 or n["solve_tgs"] != 30:
        fail(f"the platform pile did not take the K2 route: {n}")
    log(f"[K2route] pile on a finite cuboid platform, card == CPU over 30 "
        f"ticks on the K2 route (W=4 distinct worlds, {live} live contact "
        f"points; launches {n}): dp {dp:.3g}, dv {dv:.3g}")


def check_state(state, verts, skin):
    leaves = [state.scene.position, state.scene.rotation,
              state.scene.globals_, state.physics.position,
              state.physics.rotation, state.physics.linvel,
              state.physics.angvel, state.physics.warm_n,
              state.animation.anim.time, verts]
    if not all(bool(torch.isfinite(x).all()) for x in leaves):
        fail("non-finite engine state")
    if tuple(verts.shape) != (WORLDS, skin.num_vertices, 3):
        fail(f"skinned vertices have shape {tuple(verts.shape)}")
    live = int((state.physics.warm_pair >= 0).sum())
    if live == 0:
        fail("no live contact points: physics did no work")
    return live


def phase_slice(engine, skin):
    from fyrox_tpu_torch.animation import skinning
    from fyrox_tpu_torch.physics import fused_step
    if not fused_step.supports_fused_bp(engine.physics):
        fail("the flagship is outside the K3 scope")
    state = engine.init_state(WORLDS, device="cuda")

    def roll(state):
        for _ in range(TICKS):
            state = engine.step(state)
        bm = skinning.bone_matrices(state.scene.globals_, skin)
        verts = skinning.skin_positions_dense(bm, skin)
        return state, verts

    state, verts = roll(state)                      # warm-up
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        state, verts = roll(state)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    n = all_launches()
    n_ticks = TICKS * CALLS
    want = dict(fused_bp=n_ticks, narrow_compact=n_ticks, solve_tgs=n_ticks,
                plane_gather=0)
    if n != want:
        fail(f"fused slice launches {n}, want {want}")
    live = check_state(state, verts, skin)
    rate = WORLDS * n_ticks / elapsed
    log(f"[slice] fused route (K3), flagship {skin.num_bones} bones / "
        f"{skin.num_vertices} verts / {engine.physics.num_bodies - 1} "
        f"bodies, W={WORLDS}: {rate:.1f} env·steps/s ({CALLS} x {TICKS} "
        f"ticks + skinning in {elapsed:.3f} s, {live} live contact points; "
        f"launches per tick: fused_bp 1, narrow_compact 1, solve_tgs 1, "
        f"plane_gather 0) on {CARD}")
    return n, state


def phase_staged(engine, skin, state):
    """The staged route from the fused slice's last state (bodies landed)."""
    from fyrox_tpu_torch.animation import skinning
    sc = engine.physics.grid
    gathers_per_tick = 2 + sum(1 for k in range(3) if sc.nslot(k))
    state = engine.step(state, fused=False)          # warm-up
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    for _ in range(STAGED):
        state = engine.step(state, fused=False)
    bm = skinning.bone_matrices(state.scene.globals_, skin)
    verts = skinning.skin_positions_dense(bm, skin)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    n = all_launches()
    want = dict(fused_bp=0, narrow_compact=0, solve_tgs=STAGED,
                plane_gather=STAGED * gathers_per_tick)
    if n != want:
        fail(f"staged roll launches {n}, want {want}")
    live = check_state(state, verts, skin)
    rate = WORLDS * STAGED / elapsed
    log(f"[staged] staged route (fused=False), same flagship, W={WORLDS}: "
        f"{rate:.1f} env·steps/s ({STAGED} ticks + skinning in "
        f"{elapsed:.3f} s, {live} live contact points; launches per tick: "
        f"plane_gather {gathers_per_tick}, solve_tgs 1) on {CARD}")
    return n


def phase_profile(engine, settled):
    """Device events per tick and the device's busy share, per route, from
    the slice's last state."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for label, fused in (("fused", True), ("staged", False)):
        state = settled
        for _ in range(2):
            state = engine.step(state, fused=fused)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            state = engine.step(state, fused=fused)
        torch.cuda.synchronize()
        tick_ms = (time.perf_counter() - t0) * 1e3 / PROFILED
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                state = engine.step(state, fused=fused)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in kernels)
        busy_us, end = 0.0, -1.0
        for a, b in spans:                    # union of device intervals
            if b > end:
                busy_us += b - max(a, end)
                end = b
        if not kernels:
            log(f"[profile] {label} route: the profiler recorded no device "
                f"events (not measured)")
            continue
        busy_ms = busy_us / 1e3 / PROFILED
        out[label] = (len(kernels) / PROFILED, busy_ms, tick_ms)
        log(f"[profile] {label} route, W={WORLDS}: "
            f"{len(kernels) / PROFILED:.1f} device events per tick (kernels, "
            f"copies and fills), "
            f"{busy_ms:.3f} ms of device time per {tick_ms:.3f} ms "
            f"unprofiled tick (busy share {busy_ms / tick_ms:.3f}) on {CARD}")
    return out


def main():
    phase_device()
    phase_build()
    from fyrox_tpu_torch.models import build_flagship
    t0 = time.perf_counter()
    engine, skin = build_flagship(n_bones=100, n_verts=50_000,
                                  n_bodies=1000)
    log(f"[setup] flagship templates built in "
        f"{time.perf_counter() - t0:.1f} s")
    k4 = phase_plane_gather(engine)
    inputs = settled_inputs(engine)
    k1 = phase_solver(engine, inputs)
    kbp, windows = phase_bp(engine, inputs)
    knc = phase_nc(engine, inputs, windows)
    phase_fused_step(engine, inputs)
    del inputs, windows
    phase_small()
    phase_piles()
    n_fused, settled = phase_slice(engine, skin)
    n_staged = phase_staged(engine, skin, settled)
    phase_profile(engine, settled)
    for k in (kbp, knc, k1):
        k["launches"] = n_fused[k["name"]]
    k4["launches"] = n_staged["plane_gather"]
    print(json.dumps({"kernels": [kbp, knc, k1, k4]}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
