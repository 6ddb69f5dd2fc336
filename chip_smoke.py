"""GPU smoke run of the PyTorch port (fyrox_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line; any failure exits non-zero before the
last line:
  1. device  — needs a CUDA card; prints its name and power limit and
               turns TF32 off;
  2. build   — builds the port's CUDA kernels from csrc/ (nvcc);
  3. K4a     — plane_gather kernel vs its plain version at the flagship's
               gather shapes, bit-equal;
  4. K1      — TGS solve kernel vs its plain version on the packed inputs of
               one flagship step after 30 settling ticks, in worlds that
               differ from one another;
  5. small   — a small flagship on the card agrees with the same flagship
               on the CPU (plain versions) over 30 ticks, worlds differing;
  6. slice   — the full-width flagship (100 bones / 50k vertices / 1000
               bodies), WORLDS worlds: CALLS rolls of TICKS engine ticks +
               skinning, timed, with the kernels' launch counts checked.
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
CARD = ""


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


def distinct_worlds(engine, w, device, seed=0):
    """engine.init_state(w) with seeded per-world jitter of the dynamic
    bodies' positions (±5 cm) and velocities (±0.5 m/s), so that no two
    worlds hold the same state and a kernel that reads another world's
    slice disagrees with its plain version."""
    from fyrox_tpu_torch.physics.world import DYNAMIC
    st = engine.init_state(w, device=device)
    ph = st.physics
    rng = np.random.default_rng(seed)
    dyn = torch.as_tensor(engine.physics.body_type == DYNAMIC, device=device)
    dyn = dyn[None, :, None].float()

    def noise(scale):
        return torch.as_tensor(rng.uniform(-scale, scale, ph.position.shape)
                               .astype(np.float32), device=device) * dyn

    return st._replace(physics=ph._replace(
        position=ph.position + noise(0.05), linvel=ph.linvel + noise(0.5)))


def all_differ(x):
    """True when no two worlds (leading axis) of x are equal."""
    return torch.unique(x.flatten(1), dim=0).shape[0] == x.shape[0]


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
    t_k = t_p = 0.0
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
    log(f"[K4a] plane_gather bit-equal to plain on {len(shapes)} flagship "
        f"shapes (W={WORLDS}); kernel {t_k:.4f} ms, plain {t_p:.4f} ms per "
        f"tick's set of gathers")
    return dict(name="plane_gather", route="cuda",
                source="fyrox_tpu_torch/csrc/plane_gather.cu",
                replaces="fyrox_tpu/physics/pallas_ops.py:171",
                max_abs_err=worst, ms=t_k, plain_ms=t_p)


def phase_solver(engine):
    from fyrox_tpu_torch.physics import slab2, tgs_kernel
    from fyrox_tpu_torch.physics import world as phys_mod
    state = distinct_worlds(engine, WORLDS, "cuda")
    for _ in range(30):
        state = engine.step(state)
    t = engine.physics
    dt = engine.dt
    accel, angvel = phys_mod.external_accelerations(state.physics, t, dt)
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
    log(f"[K1] solve_tgs matches plain on a settled flagship step "
        f"(W={WORLDS} distinct worlds, {n_act} active contact points): pos "
        f"{err_pos:.3g}, quat {err_q:.3g}, vel {err_vel:.3g}, lambda "
        f"{err_lam:.3g}; kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms")
    return dict(name="solve_tgs", route="cuda",
                source="fyrox_tpu_torch/csrc/tgs_solve.cu",
                replaces="fyrox_tpu/physics/pallas_solver.py:816",
                max_abs_err=max(err_pos, err_vel, err_q, err_lam),
                ms=ms_k, plain_ms=ms_p)


def phase_small():
    """A small flagship on the card agrees with the same one on the CPU."""
    from fyrox_tpu_torch.animation import skinning
    from fyrox_tpu_torch.models import build_flagship
    engine, skin = build_flagship(n_bones=10, n_verts=300, n_bodies=192)
    gpu = distinct_worlds(engine, 4, "cuda")
    cpu = distinct_worlds(engine, 4, "cpu")
    for _ in range(30):
        gpu = engine.step(gpu)
        cpu = engine.step(cpu)

    def skinned(st):
        bm = skinning.bone_matrices(st.scene.globals_, skin)
        return skinning.skin_positions_dense(bm, skin).cpu()

    dp = (gpu.physics.position.cpu() - cpu.physics.position).abs().max()
    dv = (gpu.physics.linvel.cpu() - cpu.physics.linvel).abs().max()
    dvert = (skinned(gpu) - skinned(cpu)).abs().max()
    contacts = int((cpu.physics.warm_pair >= 0).sum())
    if not all_differ(cpu.physics.position):
        fail("the small flagship's worlds are equal")
    # the CPU test suite's trajectory bounds between two implementations
    # of the same step (dp 5e-4, dv 5e-3 after 30 steps; skin 1e-3)
    if not (dp < 5e-4 and dv < 5e-3 and dvert < 1e-3 and contacts > 0):
        fail(f"card vs CPU on the small flagship: dp {dp:.3g}, dv {dv:.3g},"
             f" skinned {dvert:.3g}, live contact points {contacts}")
    log(f"[small] card == CPU over 30 ticks (W=4 distinct worlds, 192 "
        f"bodies, {contacts} live contact points): dp {dp:.3g}, dv "
        f"{dv:.3g}, skinned {dvert:.3g}")


def phase_slice(engine, skin):
    from fyrox_tpu_torch.animation import skinning
    from fyrox_tpu_torch.physics import plane_ops, tgs_kernel
    sc = engine.physics.grid
    gathers_per_tick = 2 + sum(1 for k in range(3) if sc.nslot(k))
    state = engine.init_state(WORLDS, device="cuda")

    def roll(state):
        for _ in range(TICKS):
            state = engine.step(state)
        bm = skinning.bone_matrices(state.scene.globals_, skin)
        verts = skinning.skin_positions_dense(bm, skin)
        return state, verts

    state, verts = roll(state)                      # warm-up
    torch.cuda.synchronize()
    plane_ops.reset_launches()
    tgs_kernel.reset_launches()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        state, verts = roll(state)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    n_k1, n_k4 = tgs_kernel.launches(), plane_ops.launches()
    n_ticks = TICKS * CALLS
    if n_k1 != n_ticks:
        fail(f"solve_tgs launched {n_k1} times in {n_ticks} ticks")
    if n_k4 != n_ticks * gathers_per_tick:
        fail(f"plane_gather launched {n_k4} times in {n_ticks} ticks, want "
             f"{gathers_per_tick} per tick")
    leaves = [state.scene.position, state.scene.rotation,
              state.scene.globals_, state.physics.position,
              state.physics.rotation, state.physics.linvel,
              state.physics.angvel, state.physics.warm_n,
              state.animation.anim.time, verts]
    if not all(bool(torch.isfinite(x).all()) for x in leaves):
        fail("non-finite engine state after the slice")
    if tuple(verts.shape) != (WORLDS, skin.num_vertices, 3):
        fail(f"skinned vertices have shape {tuple(verts.shape)}")
    live = int((state.physics.warm_pair >= 0).sum())
    if live == 0:
        fail("no live contact points after the slice: physics did no work")
    rate = WORLDS * n_ticks / elapsed
    log(f"[slice] flagship {skin.num_bones} bones / {skin.num_vertices} "
        f"verts / {engine.physics.num_bodies - 1} bodies, W={WORLDS}: "
        f"{rate:.1f} env·steps/s ({CALLS} x {TICKS} ticks + skinning in "
        f"{elapsed:.3f} s, {live} live contact points) on {CARD}")
    return n_k1, n_k4


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
    k1 = phase_solver(engine)
    phase_small()
    n_k1, n_k4 = phase_slice(engine, skin)
    k1["launches"], k4["launches"] = n_k1, n_k4
    print(json.dumps({"kernels": [k1, k4]}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
