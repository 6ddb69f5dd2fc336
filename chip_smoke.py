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
             differ from one another; two launches bit-equal; the live
             slots it visited per pass;
  K3bp     — fused_bp kernel vs its plain version on the same settled
             full-width flagship: candidate windows equal as integers and
             different across worlds, collider planes bit-equal, two
             launches bit-equal;
  K2nc     — narrow_compact kernel vs its plain version on those windows:
             pid, partner body and activity equal, floats within 1e-5, and
             two launches equal bit for bit;
  fused    — one whole fused step (K3 → K2 → K1 kernels) vs the same step
             through the plain versions, at K1's bounds;
  rank     — on that settled flagship, the count-rank broadphase windows
             (rank_rows → K4b) equal the sort windows (argsort → K4a) as
             integers, demand included;
  bp-audit — bp_demand_stats and overflow_stats of the settled flagship,
             printed against the caps; equal card vs CPU on 16 worlds;
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
Then the reuse flagship (the flagship at broadphase_period 4, windows
16 / 8 / 12, walk 64), which takes the K2 route with the broadphase in
PyTorch, count rank:
  K2nc-reuse — narrow_compact vs its plain version on the K2 route's
             windows of the settled reuse flagship (69 window rows a
             collider), with K2nc's checks;
  K4b      — plane_scatter vs its plain version on the inputs of one
             count-rank rebuild of the settled flagship (W distinct
             worlds): bit-equal on that row permutation, within 1e-6 on
             random inputs with repeats and out-of-range indices,
             bit-equal to the float32 sums in ascending k on three buckets
             of ~1,000 indices each, two launches bit-equal;
  reuse-small — a 192-collider fast-fall scene, card vs CPU over 40 ticks
             (W=4): the same rebuild ticks and cached windows, K4b launched
             once a rebuild;
  reuse    — the full-width reuse slice through Engine.step: CALLS rolls of
             TICKS ticks + skinning, timed; launches per tick (fused_bp 0,
             narrow_compact 1, solve_tgs 1, K4b and K4a one each per
             rebuild); then the host's rebuild read, timed.
Then the jointed flagship (the flagship + 16 hanging chains with COM
offsets + 4 ragdoll spines: 76 joints), which takes the staged route:
  K1joint  — the TGS solve kernel with its joint tables and COM planes vs its
             plain version on one settled step (W worlds made distinct by
             jitter), at K1's bounds; two launches bit-equal;
  jointed-small — a small scene with all four joint kinds and COM offsets,
             card vs CPU over 30 ticks (W=4);
  jointed  — the full-width jointed slice through Engine.step: CALLS rolls of
             TICKS ticks + skinning, timed; launches per tick (K1 1 with joint
             tables, K4a one per gather, no fused kernel); every chain's tip
             within reach of its anchor.
Then the flagship with a 2,000-body pile (past one block's shared memory):
  K1big    — W distinct worlds, 30 settling ticks, then BIG_TICKS fused ticks
             with the launches counted (fused_bp, narrow_compact, solve_tgs
             one each a tick); on the next step fused_bp and narrow_compact
             with K3bp's and K2nc's checks (2,000 grid colliders), and K1's
             global-memory variant vs its plain version, at K1's bounds,
             two launches bit-equal, timed against its bound.
Then the render path (bench_render.py's scene and config, W=16 at 256x256,
worlds made distinct by seeded jitter of the mesh nodes):
  K5full   — the tile raster kernel, full variant, vs its plain version on
             the camera pass of one frame and on the knife-edge inputs
             (k5_knife_edges): z, idx, w0, w1 bit-equal, two launches
             bit-equal; slots per tile, the split of the long tiles,
             covered pairs and the bound;
  K5depth  — the depth-only variant on the batched cascade pass (3 x 16
             maps), the same checks;
  render-audit — per-pass true bin demand against the caps (424; 896 for
             the cascades) and each culled cascade's in-footprint count
             against its budget; fails at demand >= cap or count >= budget;
  render-cpu — a small frame (2 worlds, 32x32) on the card agrees with the
             same frame on the CPU;
  render   — the full-width slice: RENDER_FRAMES timed frames after a
             warm-up, frames/s and ms/frame/world, K5 launched exactly
             twice per frame;
  render-profile — device events per frame and the device's busy share.
Then one JSON line describing the kernels, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}. Each kernel's `ms` (and
`plain_ms`, `library_ms`) is CUDA-event time over a run of calls, which
counts the host's issue between launches where a launch is shorter than its
issue; `device_ms` (and `library_device_ms`) is CUDA-event time over the
same calls queued behind a spin kernel, which the card runs back to back.
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


def device_ms(fn, reps):
    """Mean milliseconds of the card per call of fn, without the host's
    issue: CUDA events around reps calls queued behind a spin kernel
    (torch.cuda._sleep), so that the card runs them back to back. The spin
    is lengthened until the host has queued every call before it ends."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        if cycles >= 1 << 32:
            fail("device_ms: the host could not queue the calls behind a "
                 "spin of 2^32 cycles")
        cycles <<= 2


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


# ---------------------------------------------------------------- jointed
# The jointed flagship: the flagship's character and 1,000-body pile at its
# slab settings, plus 16 hanging chains (tests/test_pallas_solver.py:120-148
# with COM offsets) and 4 standing ragdoll spines
# (tests/test_ragdoll.py:14-33). 76 joints, COM offsets on every chain link.
CHAINS = 16
SPINES = 4


def port_lib():
    """The port's builders, as the scene helpers below take them."""
    import types
    from fyrox_tpu_torch.models import character
    from fyrox_tpu_torch.physics import (BALL, CAPSULE, CUBOID, HALFSPACE,
                                         BodyType, JointKind, PhysicsBuilder)
    from fyrox_tpu_torch.scene import RagdollBuilder, SceneBuilder
    return types.SimpleNamespace(
        build_character_scene=character.build_character_scene,
        build_pile_scene=character.build_pile_scene,
        PhysicsBuilder=PhysicsBuilder, SceneBuilder=SceneBuilder,
        RagdollBuilder=RagdollBuilder, BodyType=BodyType,
        JointKind=JointKind, BALL=BALL, CAPSULE=CAPSULE, CUBOID=CUBOID,
        HALFSPACE=HALFSPACE)


def add_chain(lib, pb, base, kinds, com=(0.06, -0.04, 0.02), axis=(0, 0, 1)):
    """A static anchor (0.05 m ball) at `base` and one capsule link (0.18
    half-height, 0.1 radius) per joint kind, spaced 0.55 m along +x, each
    collider offset by `com` (a centre-of-mass offset); anchors (0.25, 0,
    0) / (-0.3, 0, 0). Returns the link bodies."""
    anchor = pb.add_body(body_type=lib.BodyType.STATIC, position=base)
    pb.add_collider(anchor, lib.BALL, [0.05])
    prev, links = anchor, []
    for i, kind in enumerate(kinds):
        b = pb.add_body(position=(base[0] + 0.55 * (i + 1), base[1], base[2]))
        pb.add_collider(b, lib.CAPSULE, [0.18, 0.1], friction=0.5, offset=com)
        pb.add_joint(kind, prev, b, anchor_a=(0.25, 0, 0) if i else (0, 0, 0),
                     anchor_b=(-0.3, 0, 0), axis=axis)
        prev = b
        links.append(b)
    return links


def add_spine(lib, sb, pb, x, z, tag):
    """A standing 4-limb ragdoll spine (0.4 m capsules, radius 0.08, ball
    joints) bound to 4 new root pivots. Returns its RagdollTemplate."""
    bones = [sb.add_pivot(f"{tag}_bone{i}", position=(x, 0.3 + 0.4 * i, z))
             for i in range(4)]
    rb = lib.RagdollBuilder(pb)
    limbs = []
    for i in range(4):
        limbs.append(rb.add_limb(bones[i], (x, 0.3 + 0.4 * i, z),
                                 (x, 0.3 + 0.4 * (i + 1), z), radius=0.08,
                                 parent=limbs[-1] if limbs else None))
    return rb.build()


def jointed_flagship_scene(lib, n_bones=100, n_verts=50_000, n_bodies=1000,
                           chains=CHAINS, spines=SPINES, seed=0):
    """The jointed flagship through one package's builders `lib`. Returns
    (scene template, physics template, animation set, machine, bones,
    skin arrays, chain anchor positions, ragdoll templates)."""
    sb, aset, mt, bones, skin = lib.build_character_scene(
        n_bones=n_bones, n_verts=n_verts, seed=seed)
    pb, _ = lib.build_pile_scene(sb, n_bodies=n_bodies, seed=seed + 1)
    k = lib.JointKind
    anchors = []
    for c in range(chains):
        a = 2.0 * np.pi * c / chains
        base = (float(6.0 * np.cos(a)), 2.4, float(6.0 * np.sin(a)))
        add_chain(lib, pb, base, [k.REVOLUTE, k.BALL, k.REVOLUTE, k.BALL])
        anchors.append(base)
    rds = []
    for r in range(spines):
        a = 2.0 * np.pi * (r + 0.5) / spines
        rds.append(add_spine(lib, sb, pb, float(8.0 * np.cos(a)),
                             float(8.0 * np.sin(a)), f"spine{r}"))
    sb.add_camera("main_camera", position=(0, 3.0, -10.0))
    pt = pb.build(broadphase="slab", slab_window=(12, 8, 10), slab_active=16,
                  slab_walk=48)
    return sb.build(), pt, aset, mt, bones, skin, anchors, rds


def jointed_engine(**kw):
    """The port's Engine and SkinTemplate of the jointed flagship, plus the
    chain anchors and ragdoll templates."""
    from fyrox_tpu_torch.animation import SkinTemplate
    from fyrox_tpu_torch.engine import Engine
    from fyrox_tpu_torch.scene import graph, init_state
    template, pt, aset, mt, bones, (verts, idx4, w4), anchors, rds = \
        jointed_flagship_scene(port_lib(), **kw)
    st = graph.update_hierarchical_data(init_state(template, 1, device="cpu"),
                                        template)
    inv_bind = np.linalg.inv(st.globals_[0].numpy()[np.asarray(bones)])
    skin = SkinTemplate(bones=np.asarray(bones, np.int32),
                        inv_bind=inv_bind.astype(np.float32), vertices=verts,
                        bone_indices=idx4, bone_weights=w4)
    return (Engine(template=template, physics=pt, animations=aset,
                   machine=mt), skin, anchors, rds)


def joint_zoo(lib):
    """A small jointed physics scene: a hanging chain whose four links take
    the four joint kinds (REVOLUTE, BALL, FIXED, PRISMATIC along the chain)
    with COM offsets, a second chain of ball joints, a loose ball landing on
    the first, and 12 boxes and balls on the ground."""
    pb = lib.PhysicsBuilder()
    g = pb.add_body(body_type=lib.BodyType.STATIC)
    pb.add_collider(g, lib.HALFSPACE, [], friction=0.6)
    k = lib.JointKind
    add_chain(lib, pb, (0.0, 2.4, 0.0),
              [k.REVOLUTE, k.BALL, k.FIXED, k.PRISMATIC], axis=(1, 0, 0))
    add_chain(lib, pb, (-1.0, 2.0, 1.5), [k.BALL] * 3, com=(0.0, 0.05, 0.0))
    ball = pb.add_body(position=(1.1, 3.2, 0.0))
    pb.add_collider(ball, lib.BALL, [0.2], friction=0.5, restitution=0.1)
    for i in range(12):
        b = pb.add_body(position=(-1.5 + 0.5 * (i % 6), 0.4 + 0.5 * (i // 6),
                                  -1.0))
        if i % 2:
            pb.add_collider(b, lib.BALL, [0.2], friction=0.5)
        else:
            pb.add_collider(b, lib.CUBOID, [0.18, 0.18, 0.18], friction=0.5)
    return pb, pb.build(broadphase="slab")


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
                plane_gather=plane_ops.launches("plane_gather"),
                plane_scatter=plane_ops.launches("plane_scatter"))


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
    t_k = t_p = t_lib = dev_k = dev_lib = 0.0
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
        dev_k += device_ms(lambda: plane_ops.plane_gather(planes, idx), 20)
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
        dev_lib += device_ms(lambda: torch.gather(padded, 2, lib_idx), 20)
        moved += nbytes(planes, idx, got)
    b_ms, b_by = bound_ms(moved, 0)
    log(f"[K4a] plane_gather bit-equal to plain on {len(shapes)} flagship "
        f"shapes (W={WORLDS}); kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
        f"torch.gather {t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}) per "
        f"tick's set of staged gathers; device time: kernel {dev_k:.4f} ms, "
        f"torch.gather {dev_lib:.4f} ms")
    return dict(name="plane_gather", route="cuda",
                source="fyrox_tpu_torch/csrc/plane_gather.cu",
                replaces="fyrox_tpu/physics/pallas_ops.py:171",
                max_abs_err=worst, ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=t_lib, device_ms=dev_k,
                library_device_ms=dev_lib)


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


def k1_against_plain(label, packed, params):
    """K1 (no joints, no COM) vs its plain version on packed inputs: K1's
    bounds, two launches bit-equal, the kernel's visited slots equal to
    the inputs' live slots; then kernel and plain timed against the bound.
    Returns (max error, the errors as text, kernel ms, kernel device ms,
    plain ms, bound ms, bound by, visited slots per world)."""
    from fyrox_tpu_torch.physics import tgs_kernel
    got_b, got_l = tgs_kernel.solve_tgs(*packed, params)
    visited = tgs_kernel.visited_slots().clone()
    again_b, again_l = tgs_kernel.solve_tgs(*packed, params)
    ref_b, ref_l = tgs_kernel.solve_tgs_plain(*packed, params)
    torch.cuda.synchronize()
    if not (torch.equal(got_b, again_b) and torch.equal(got_l, again_l)):
        fail(f"{label}: two launches on the same inputs differ")
    if not torch.equal(visited, tgs_kernel.live_slots(packed[0])):
        fail(f"{label}: the kernel visited other slots than the live ones")
    err_pos = (got_b[:, 6:9] - ref_b[:, 6:9]).abs().max().item()
    err_vel = (got_b[:, 0:6] - ref_b[:, 0:6]).abs().max().item()
    err_q = (got_b[:, 9:13] - ref_b[:, 9:13]).abs().max().item()
    lam_excess = ((got_l - ref_l).abs()
                  - (1e-3 * ref_l.abs() + 1e-5)).max().item()
    err_lam = (got_l - ref_l).abs().max().item()
    if not (torch.isfinite(got_b).all() and torch.isfinite(got_l).all()):
        fail(f"{label}: solve_tgs kernel produced non-finite values")
    # bounds: ten times the JAX package's own bounds between two
    # implementations of one cold step (pos 1e-6, vel 1e-5, lambda 1e-4),
    # for the card's different summation order
    if err_pos > 1e-5 or err_q > 1e-5 or err_vel > 1e-4 or lam_excess > 0:
        fail(f"{label}: solve_tgs kernel vs plain: pos {err_pos:.3g} (1e-5), "
             f"quat {err_q:.3g} (1e-5), vel {err_vel:.3g} (1e-4), lambda "
             f"{err_lam:.3g} (1e-3 rel + 1e-5)")
    ms_k = cuda_ms(lambda: tgs_kernel.solve_tgs(*packed, params), 10)
    dev_k = device_ms(lambda: tgs_kernel.solve_tgs(*packed, params), 10)
    # the same launch without substeps and stabilisation passes: the prep
    # (list build, effective masses), the restitution pass and the output
    lean = params._replace(n_sub=0, n_stab=0)
    ms_prep = cuda_ms(lambda: tgs_kernel.solve_tgs(*packed, lean), 10)
    ms_p = cuda_ms(lambda: tgs_kernel.solve_tgs_plain(*packed, params), 3)
    w, _, s, cg = packed[0].shape
    b_ms, b_by = bound_ms(nbytes(*packed, got_b, got_l),
                          k1_ops(s, cg, w, params))
    errs = (f"pos {err_pos:.3g}, quat {err_q:.3g}, vel {err_vel:.3g}, "
            f"lambda {err_lam:.3g}; without substeps and stabilisation "
            f"{ms_prep:.3f} ms; device time {dev_k:.3f} ms")
    return (max(err_pos, err_vel, err_q, err_lam), errs, ms_k, dev_k, ms_p,
            b_ms, b_by, visited)


def k1_record(name, err, ms_k, dev_k, ms_p, b_ms, b_by):
    return dict(name=name, route="cuda",
                source="fyrox_tpu_torch/csrc/tgs_solve.cu",
                replaces="fyrox_tpu/physics/pallas_solver.py:816",
                max_abs_err=err, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, device_ms=dev_k,
                library_device_ms=None)


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
    if n_act == 0:
        fail("no active contact points after 30 settling ticks")
    err, errs, ms_k, dev_k, ms_p, b_ms, b_by, visited = k1_against_plain(
        "K1", packed, params)
    w, _, s, cg = packed[0].shape
    n_vis = int(visited.sum())
    log(f"[K1] solve_tgs matches plain on a settled flagship step "
        f"(W={WORLDS} distinct worlds, {n_act} active contact points): "
        f"{errs}; two launches bit-equal; live slots visited per pass "
        f"{n_vis} of {w * s * cg} ({n_vis / (w * cg):.3f} of {s} per "
        f"collider, {int(visited.min())}-{int(visited.max())} per world); "
        f"kernel {ms_k:.3f} ms, plain "
        f"{ms_p:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    return k1_record("solve_tgs", err, ms_k, dev_k, ms_p, b_ms, b_by)


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


def bp_against_plain(label, t, body, dt):
    """K3 vs its plain version: windows equal as integers, collider planes
    bit-equal, two launches bit-equal, windows different across worlds.
    Returns (jv, col) and the number of valid candidates."""
    from fyrox_tpu_torch.physics import fused_step
    jv, col = fused_step.bp_candidates(t, body, dt)
    again = fused_step.bp_candidates(t, body, dt)
    jv_p, col_p = fused_step.bp_candidates_plain(t, body, dt)
    torch.cuda.synchronize()
    if not (torch.equal(jv, again[0]) and torch.equal(col, again[1])):
        fail(f"{label}: fused_bp: two launches on the same inputs differ")
    if not torch.equal(jv, jv_p):
        fail(f"{label}: fused_bp windows differ from the plain version at "
             f"{int((jv != jv_p).sum())} of {jv.numel()} entries")
    if not torch.equal(col, col_p):
        fail(f"{label}: fused_bp collider planes differ from the plain "
             f"version by {(col - col_p).abs().max().item():.3g}")
    if not all_differ(jv):
        fail(f"{label}: the candidate windows repeat across worlds")
    return (jv, col), int((jv >= 0).sum())


def nc_against_plain(label, t, col, jv, warm_lam, warm_pid):
    """K2 vs its plain version: pid, partner body and activity equal,
    planes within 1e-5, two launches bit-equal, some slots active and
    warm-started. Returns (outputs, max error, active, warm-started)."""
    from fyrox_tpu_torch.physics import fused_step
    got = fused_step.narrow_compact(t, col, jv, warm_lam, warm_pid)
    again = fused_step.narrow_compact(t, col, jv, warm_lam, warm_pid)
    ref = fused_step.narrow_compact_plain(t, col, jv, warm_lam, warm_pid)
    torch.cuda.synchronize()
    con, body_j, pid = got
    con_p, body_j_p, pid_p = ref
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{label}: narrow_compact: two launches on the same inputs "
             "differ")
    if not (torch.equal(pid, pid_p) and torch.equal(body_j, body_j_p)):
        fail(f"{label}: narrow_compact pids / partner bodies differ from "
             f"plain at {int((pid != pid_p).sum())} / "
             f"{int((body_j != body_j_p).sum())} slots")
    if not torch.equal(con[:, 9], con_p[:, 9]):
        fail(f"{label}: narrow_compact activity differs from plain")
    err = (con - con_p).abs().max().item()
    # the same float32 operations in the same order: 1e-5 leaves room for
    # nothing but rounding
    if not (err <= 1e-5 and torch.isfinite(con).all()):
        fail(f"{label}: narrow_compact planes differ from plain by "
             f"{err:.3g} (1e-5)")
    n_act = int(con[:, 9].sum())
    matched = int((con[:, 12] != 0).sum())
    if n_act == 0 or matched == 0:
        fail(f"{label}: narrow_compact: {n_act} active slots, {matched} "
             "warm-started")
    return got, err, n_act, matched


def k2_route_windows(t, body, dt):
    """The K2 route's inputs to narrow_compact: collider planes and the
    PyTorch slab broadphase's windows (sort rank)."""
    from fyrox_tpu_torch.physics import broadphase as bp
    from fyrox_tpu_torch.physics import fused_step
    fs = fused_step._statics(t)
    col = fused_step.collider_planes(t, body, dt).contiguous()
    amin, amax = fused_step._aabbs(t, col)
    cands = bp.slab_candidates(t.grid, fs.cx.col_body, fs.cx.dyn_col, amin,
                               amax, tight_delta=fused_step._tight_delta())
    return col, fused_step._jv_from_candidates(fs, cands)


def phase_bp(engine, inputs):
    from fyrox_tpu_torch.physics import fused_step
    body = inputs[3]
    t = engine.physics
    dt = engine.dt
    (jv, col), n_valid = bp_against_plain("K3bp", t, body, dt)
    ms_k = cuda_ms(lambda: fused_step.bp_candidates(t, body, dt), 20)
    dev_k = device_ms(lambda: fused_step.bp_candidates(t, body, dt), 20)
    ms_p = cuda_ms(lambda: fused_step.bp_candidates_plain(t, body, dt), 5)
    fs = fused_step._statics(t)
    statics = sum(a.nbytes for a in (fs.col_body, fs.shape, fs.kinds,
                                     fs.dyn, fs.col_sta, fs.col_off,
                                     fs.sweep_cap, fs.grid_cols, fs.cls_tab,
                                     fs.jv_big))
    # the kernel reads 10 of the 29 body planes
    moved = body.numel() * 4 * 10 // 29 + statics + nbytes(jv, col)
    b_ms, b_by = bound_ms(moved, bp_ops(t, WORLDS))
    log(f"[K3bp] fused_bp windows equal to plain as integers (W={WORLDS} "
        f"distinct worlds, {n_valid} valid candidates), collider planes "
        f"bit-equal, two launches bit-equal; kernel {ms_k:.4f} ms (device time {dev_k:.4f}), plain "
        f"{ms_p:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(name="fused_bp", route="cuda",
                source="fyrox_tpu_torch/csrc/fused_bp.cu",
                replaces="fyrox_tpu/physics/pallas_step.py:794",
                max_abs_err=0.0, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, device_ms=dev_k,
                library_device_ms=None), (jv, col)


def phase_nc(engine, inputs, windows):
    from fyrox_tpu_torch.physics import fused_step
    _, _, _, body, warm_lam, warm_pid = inputs
    jv, col = windows
    t = engine.physics
    got, err, n_act, matched = nc_against_plain("K2nc", t, col, jv, warm_lam,
                                                warm_pid)
    ms_k = cuda_ms(lambda: fused_step.narrow_compact(
        t, col, jv, warm_lam, warm_pid), 20)
    dev_k = device_ms(lambda: fused_step.narrow_compact(
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
        f"{ms_k:.4f} ms (device time {dev_k:.4f}), plain {ms_p:.3f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    return dict(name="narrow_compact", route="cuda",
                source="fyrox_tpu_torch/csrc/narrow_compact.cu",
                replaces="fyrox_tpu/physics/pallas_step.py:641",
                max_abs_err=err, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, device_ms=dev_k,
                library_device_ms=None)


def fused_inputs(engine, state):
    """The fused step's body planes and warm carries at `state`."""
    from fyrox_tpu_torch.physics import fused_step
    from fyrox_tpu_torch.physics import world as phys_mod
    t = engine.physics
    accel, angvel = phys_mod.external_accelerations(state.physics, t,
                                                    engine.dt)
    return fused_step._inputs(state.physics, t, accel, angvel)


def phase_nc_reuse(engine, state):
    """narrow_compact on the settled reuse flagship's K2-route windows
    (16 / 8 / 12, walk 64: 69 window rows a collider) vs plain."""
    from fyrox_tpu_torch.physics import fused_step
    t = engine.physics
    body, warm_lam, warm_pid = fused_inputs(engine, state)
    col, jv = k2_route_windows(t, body, engine.dt)
    fs = fused_step._statics(t)
    _, err, n_act, matched = nc_against_plain("K2nc-reuse", t, col, jv,
                                              warm_lam, warm_pid)
    dev_k = device_ms(lambda: fused_step.narrow_compact(
        t, col, jv, warm_lam, warm_pid), 20)
    log(f"[K2nc-reuse] narrow_compact on the reuse flagship's windows "
        f"({fs.wd} window rows, {fs.ns} candidate rows, W={WORLDS}) equal to "
        f"plain on pid, partner body and activity, planes within {err:.3g}, "
        f"two launches bit-equal ({n_act} active slots, {matched} "
        f"warm-started); device time {dev_k:.4f} ms")


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


def card_vs_cpu(label, t, state_cpu, ticks, step, bounds=(5e-4, 5e-3)):
    """Step the same state on the card and on the CPU; return (dp, dv,
    live contact points, card states per tick). `bounds`: (dp, dv); the
    default is the CPU test suite's trajectory bounds between two
    implementations of the same 30-step trajectory."""
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
    if not (dp < bounds[0] and dv < bounds[1] and live > 0):
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


# ---------------------------------------------------------------- reuse
# Temporal broadphase reuse: the flagship at broadphase_period 4 with the
# JAX package's reuse windows (16 / 8 / 12, walk 64; FYROX_SLAB_BP_PERIOD=4),
# count rank. K3 rebuilds every tick, so this flagship takes the K2 route:
# the one full-width fused path whose broadphase runs in PyTorch, and so
# the one that runs K4b (once a rebuild, with K4a for the walk).
PERIOD = 4
AUDIT_WORLDS = 16    # worlds of the settled flagship held card vs CPU
REUSE_SMALL_TICKS = 40
READ_TICKS = 10      # instrumented ticks timing the rebuild read


def slab_aabbs(t, physics, dt):
    """The staged step's fat AABBs of a state, [W,C,3] x 2."""
    from fyrox_tpu_torch.physics import slab2
    from fyrox_tpu_torch.physics.planes import scale3
    cx = slab2._ctx(t)
    cpos, _, crot9, lv_c = slab2._pose(cx, physics)
    amin, amax = slab2._aabb_planes(cx, t, cpos, crot9, scale3(lv_c, dt),
                                    slab2._margin(t))
    return torch.stack(amin, -1), torch.stack(amax, -1)


def phase_rank(engine, inputs):
    """The count-rank windows (rank_rows → K4b) equal the sort windows
    (argsort → K4a) as integers on the card, at the settled flagship."""
    from fyrox_tpu_torch.physics import broadphase as bp
    from fyrox_tpu_torch.physics import fused_step, slab2
    t = engine.physics
    cx = slab2._ctx(t)
    amin, amax = slab_aabbs(t, inputs[0].physics, engine.dt)
    out = {rank: bp.slab_candidates(t.grid, cx.col_body, cx.dyn_col, amin,
                                    amax, tight_delta=fused_step._tight_delta(),
                                    rank=rank, return_demand=True)
           for rank in bp.RANKS}
    torch.cuda.synchronize()
    (cs, ds), (cc, dc) = out["sort"], out["count"]
    for c in range(3):
        for f in bp.SlabCandidates._fields:
            if not torch.equal(getattr(cs[c], f), getattr(cc[c], f)):
                fail(f"rank: count-rank class {c} {f} differs from sort")
        for k in ("class_valid", "class_tight"):
            if not torch.equal(ds[k][c], dc[k][c]):
                fail(f"rank: count-rank {k}[{c}] differs from sort")
    if not torch.equal(ds["walk_total"], dc["walk_total"]):
        fail("rank: count-rank walk demand differs from sort")
    valid = sum(int(c.valid.sum()) for c in cc)
    if valid == 0 or not all_differ(cc[0].pid):
        fail(f"rank: {valid} valid candidates, or windows repeat across worlds")
    log(f"[rank] settled flagship (W={WORLDS} distinct worlds): the count-rank"
        f" windows (rank_rows → plane_scatter) equal the sort windows "
        f"(argsort → plane_gather) as integers, pids and demand included "
        f"({valid} valid candidates)")


def world_slice(physics, n):
    """The first n worlds of a physics state."""
    return type(physics)(*(x[:n] if isinstance(x, torch.Tensor) else x
                           for x in physics))


def phase_bp_audit(engine, inputs):
    """bp_demand_stats and overflow_stats of the settled flagship on the
    card, against the caps; the same on the CPU for AUDIT_WORLDS worlds."""
    from fyrox_tpu_torch import convert
    from fyrox_tpu_torch.physics import slab2
    t = engine.physics
    ph = inputs[0].physics
    dem = slab2.bp_demand_stats(t, ph)
    ovf = slab2.overflow_stats(t, ph)
    sub = world_slice(ph, AUDIT_WORLDS)
    cpu = convert.physics_state(convert.to_numpy(sub), device="cpu")
    for fn in (slab2.bp_demand_stats, slab2.overflow_stats):
        on_card, on_cpu = fn(t, sub), fn(t, cpu)
        if on_card != on_cpu:
            fail(f"bp-audit: {fn.__name__} card {on_card} vs CPU {on_cpu}")
    if ovf["max_active_points"] == 0:
        fail("bp-audit: no active contact points in the settled flagship")
    cls = "; ".join(
        f"class {c} max {d['max_valid']} / cap {d['cap']} ({d['dropped']} "
        f"dropped; tight max {d['max_tight']}, {d['tight_dropped']} dropped)"
        for c, d in ((c, dem[f"class{c}"]) for c in range(3)) if d["cap"])
    log(f"[bp-audit] settled flagship (period 1, W={WORLDS}) on the card: "
        f"walk max {dem['max_walk']} / {dem['s_walk']} "
        f"({dem['walk_dropped']} dropped); {cls}; active points max "
        f"{ovf['max_active_points']} / s_active {ovf['s_active']} (mean "
        f"{ovf['mean_active_points']:.3f}, {ovf['dropped_points']} dropped; "
        f"tight max {ovf['max_tight_points']}, "
        f"{ovf['tight_dropped_points']} dropped); both equal card vs CPU as "
        f"integers on {AUDIT_WORLDS} worlds")
    return dem, ovf


def capture_k4b_inputs(engine, state):
    """The K4b inputs of one count-rank rebuild of a reuse-flagship state
    (forced by age 0), as the main path calls the dispatch point."""
    from fyrox_tpu_torch.physics import plane_ops, slab2
    seen = []
    dispatch = plane_ops.plane_scatter

    def spy(vals, idx, n):
        seen.append((vals, idx, n))
        return dispatch(vals, idx, n)

    plane_ops.plane_scatter = spy
    try:
        ph = state.physics._replace(
            bp_age=torch.zeros_like(state.physics.bp_age))
        slab2.reuse_candidates(ph, engine.physics, engine.dt, "count")
    finally:
        plane_ops.plane_scatter = dispatch
    torch.cuda.synchronize()
    if len(seen) != 1:
        fail(f"one count-rank rebuild made {len(seen)} plane_scatter calls")
    return seen[0]


def scatter_sum_bound(vals, idx, n):
    """Per output of plane_scatter, the error bound of a float32 sum of its
    m terms in any order against the exact sum: m·2⁻²⁴·Σ|v| (float64)."""
    from fyrox_tpu_torch.physics import plane_ops
    terms = plane_ops.plane_scatter_plain(torch.ones_like(vals).double(),
                                          idx, n)
    mag = plane_ops.plane_scatter_plain(vals.abs().double(), idx, n)
    return terms * 2.0 ** -24 * mag


def scatter_in_order(vals, idx, n):
    """plane_scatter as K4b promises to round it: each output the float32
    sum of its values in ascending k, from 0. One scatter_add_ per k, each
    adding one value into each (world, attribute) row, so no two adds meet
    and each rounds once; out-of-range indices land in a spare column."""
    w, a, k = vals.shape
    out = torch.zeros((w, a, n + 1), dtype=vals.dtype, device=vals.device)
    safe = torch.where((idx >= 0) & (idx < n), idx, n).long()
    for j in range(k):
        out.scatter_add_(2, safe[:, None, j:j + 1].expand(w, a, 1),
                         vals[:, :, j:j + 1])
    return out[..., :n]


def phase_k4b(inputs):
    """K4b vs its plain version on a rebuild's permutation, and on random
    inputs with repeats and out-of-range indices."""
    from fyrox_tpu_torch.physics import plane_ops
    vals, idx, n = inputs
    w, a, k = vals.shape
    if (w, a, k, n) != (WORLDS, 16, 1000, 1000):
        fail(f"K4b: captured shapes {tuple(vals.shape)} into {n} rows")
    perm = torch.arange(n, device=idx.device).expand(w, n)
    if not (torch.equal(torch.sort(idx.long(), 1).values, perm)
            and all_differ(vals) and all_differ(idx)):
        fail("K4b: the captured indices are not per-world permutations, or "
             "worlds repeat")

    def kernel():
        return plane_ops.plane_scatter(vals, idx, n)

    def plain():
        return plane_ops.plane_scatter_plain(vals, idx, n)

    got, again, ref = kernel(), kernel(), plain()
    rng = np.random.default_rng(11)
    rv = torch.as_tensor(rng.uniform(-1, 1, (w, a, 3 * k)).astype(np.float32),
                         device="cuda")
    ri = torch.as_tensor(rng.integers(-n // 10, n + n // 10, (w, 3 * k))
                         .astype(np.int32), device="cuda")
    rgot, ragain = (plane_ops.plane_scatter(rv, ri, n) for _ in range(2))
    rref = plane_ops.plane_scatter_plain(rv, ri, n)
    # one bucket: every index in one of three rows, ~1,000 values a row
    bi = torch.as_tensor(rng.choice([0, n // 2, n - 1], (w, 3 * k))
                         .astype(np.int32), device="cuda")
    bgot, bagain = (plane_ops.plane_scatter(rv, bi, n) for _ in range(2))
    bref = plane_ops.plane_scatter_plain(rv, bi, n)
    torch.cuda.synchronize()
    if not (torch.equal(got, again) and torch.equal(rgot, ragain)
            and torch.equal(bgot, bagain)):
        fail("K4b: two launches on the same inputs differ")
    # sums of ~1,000 values: bit-equal to the float32 sums in ascending k;
    # and kernel vs plain (whose order is its own) within twice the float32
    # bound of a sum of m terms in any order, m·2⁻²⁴·Σ|v| (Higham)
    border = scatter_in_order(rv, bi, n)
    if not torch.equal(bgot, border):
        fail(f"K4b: kernel differs from the ascending-k float32 sums on three"
             f" buckets at {int((bgot != border).sum())} entries")
    b_rel = (bref.double() - bgot).abs().div(
        2 * scatter_sum_bound(rv, bi, n)).nan_to_num().max().item()
    if not b_rel <= 1.0:
        fail(f"K4b: kernel vs plain on three buckets at {b_rel:.3g} of twice "
             f"the float32 summation bound")
    if not torch.equal(got, ref):
        fail(f"K4b: kernel differs from plain on the rebuild's permutation at"
             f" {int((got != ref).sum())} entries")
    # sums of ~3 values in [-1, 1) in another order: a few ulps of 3
    err = (rgot - rref).abs().max().item()
    if not err <= 1e-6:
        fail(f"K4b: kernel vs plain with repeats {err:.3g} (1e-6)")
    # the library yardstick: one scatter_add_ into a zeroed copy with a
    # spare column for the dropped indices (index set-up not timed)
    lib_idx = torch.where((idx >= 0) & (idx < n), idx, n).long()[
        :, None, :].expand(w, a, k)

    def library():
        return torch.zeros((w, a, n + 1), device="cuda").scatter_add_(
            2, lib_idx, vals)

    if not torch.equal(library()[..., :n], ref):
        fail("K4b: the scatter_add_ yardstick disagrees")
    # a launch takes a few µs of the card: CUDA events around a run of
    # calls (ms, as for every kernel) count the host's issue between
    # launches too; device_ms does not
    ms_k, ms_lib = cuda_ms(kernel, 50), cuda_ms(library, 50)
    ms_p = cuda_ms(plain, 20)
    dev_k, dev_lib = device_ms(kernel, 50), device_ms(library, 50)
    b_ms, b_by = bound_ms(nbytes(vals, idx, got), w * a * k)
    log(f"[K4b] plane_scatter bit-equal to plain on a count-rank rebuild's "
        f"row permutation [{w},{a},{k}] → {n} rows (W={WORLDS} distinct "
        f"worlds), within {err:.3g} with repeats and out-of-range indices, "
        f"bit-equal to the ascending-k sums on three buckets ({b_rel:.3g} of "
        f"twice the summation bound from plain), two launches bit-equal; "
        f"CUDA events over 50 calls: kernel {ms_k:.4f} ms, plain "
        f"{ms_p:.4f} ms, scatter_add_ {ms_lib:.4f} ms; device time: kernel "
        f"{dev_k:.4f} ms, scatter_add_ {dev_lib:.4f} ms (zeroed copy "
        f"included); bound {b_ms:.4f} ms ({b_by})")

    return dict(name="plane_scatter", route="cuda",
                source="fyrox_tpu_torch/csrc/plane_scatter.cu",
                replaces="fyrox_tpu/physics/pallas_ops.py:219",
                max_abs_err=err, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=ms_lib, device_ms=dev_k,
                library_device_ms=dev_lib)


def fall_scene(n=190):
    """tests/test_bp_reuse.py:127-155's fast-fall scene (190 cuboids and
    balls 6 m apart, 3 m up) at period 4, plus one static 0.6 m ball that
    sizes the hash cell, so that the falling bodies keep sweep headroom and
    reuse ticks happen between rebuilds: 192 colliders."""
    from fyrox_tpu_torch.physics import (BALL, CUBOID, HALFSPACE, BodyType,
                                         PhysicsBuilder)
    pb = PhysicsBuilder()
    g = pb.add_body(body_type=BodyType.STATIC)
    pb.add_collider(g, HALFSPACE, [0, 0, 0], friction=0.5)
    post = pb.add_body(body_type=BodyType.STATIC, position=(-6.0, 0.6, -6.0))
    pb.add_collider(post, BALL, [0.6])
    for i in range(n):
        b = pb.add_body(position=(6.0 * (i % 14), 3.0 + 0.02 * i,
                                  6.0 * (i // 14)))
        if i % 2:
            pb.add_collider(b, CUBOID, [0.3, 0.2, 0.25])
        else:
            pb.add_collider(b, BALL, [0.25])
    return pb, pb.build(broadphase="slab", broadphase_period=PERIOD)


def phase_reuse_small():
    """The fast-fall scene, count rank, W=4 worlds with seeded velocities:
    card vs CPU over REUSE_SMALL_TICKS ticks, the same rebuild ticks, and
    K4b launched once a rebuild."""
    from fyrox_tpu_torch import convert
    from fyrox_tpu_torch.physics import fused_step
    from fyrox_tpu_torch.physics import world as phys_mod
    pb, t = fall_scene()
    if not fused_step.supports_fused(t) or fused_step.supports_fused_bp(t):
        fail("the fast-fall scene is not on the K2 route")
    cpu = phys_mod.init_physics_state(pb.initial_pose(), t, 4, device="cpu")
    rng = np.random.default_rng(12)
    dyn = torch.as_tensor(t.body_type == phys_mod.DYNAMIC)[None, :, None]
    lv = torch.as_tensor(rng.uniform(-3, 3, cpu.linvel.shape).astype(
        np.float32)) * dyn
    av = torch.as_tensor(rng.uniform(-5, 5, cpu.angvel.shape).astype(
        np.float32)) * dyn
    cpu = cpu._replace(linvel=lv, angvel=av)
    gpu = convert.physics_state(convert.to_numpy(cpu), device="cuda")
    reset_all_launches()
    ages_g, ages_c = [], []
    for _ in range(REUSE_SMALL_TICKS):
        gpu = phys_mod.step_physics(gpu, t, 1.0 / 60.0, bp_rank="count")
        cpu = phys_mod.step_physics(cpu, t, 1.0 / 60.0, bp_rank="count")
        ages_g.append(gpu.bp_age.cpu())
        ages_c.append(cpu.bp_age)
    n = all_launches()
    if not torch.equal(torch.stack(ages_g), torch.stack(ages_c)):
        fail("reuse-small: the card rebuilt on other ticks than the CPU")
    rebuilds = sum(int(x[0]) == 1 for x in ages_c)
    want = dict(fused_bp=0, narrow_compact=REUSE_SMALL_TICKS,
                solve_tgs=REUSE_SMALL_TICKS, plane_gather=rebuilds,
                plane_scatter=rebuilds)
    if n != want or not 1 < rebuilds < REUSE_SMALL_TICKS:
        fail(f"reuse-small: launches {n}, want {want} ({rebuilds} rebuilds)")
    for c in range(3):
        for x, y in zip(gpu.bp_cache[0][c], cpu.bp_cache[0][c]):
            if not torch.equal(x.cpu(), y):
                fail(f"reuse-small: cached class {c} candidates differ")
    dp = (gpu.position.cpu() - cpu.position).abs().max().item()
    dv = (gpu.linvel.cpu() - cpu.linvel).abs().max().item()
    live = int((cpu.warm_pair >= 0).sum())
    if not (dp < 5e-4 and dv < 5e-3 and live > 0
            and all_differ(cpu.position)):
        fail(f"reuse-small: card vs CPU dp {dp:.3g}, dv {dv:.3g}, live "
             f"contact points {live}")
    log(f"[reuse-small] fast-fall scene ({t.num_colliders} colliders, period"
        f" {PERIOD}, count rank, K2 route), card == CPU over "
        f"{REUSE_SMALL_TICKS} ticks (W=4 distinct worlds): {rebuilds} "
        f"rebuilds on the same ticks, cached windows equal, dp {dp:.3g}, dv "
        f"{dv:.3g}, {live} live contact points; launches {n}")


def settled_reuse(engine):
    """The reuse flagship, W distinct worlds after 30 count-rank ticks."""
    state = distinct_worlds(engine, WORLDS, "cuda")
    for _ in range(30):
        state = engine.step(state, bp_rank="count")
    return state


def phase_reuse(engine, skin):
    """The full-width reuse slice: Engine.step(bp_rank="count") on the
    period-4 flagship, W worlds, K2 route: CALLS rolls of TICKS ticks +
    skinning, timed as the slice; then READ_TICKS instrumented ticks that
    time the host's rebuild read."""
    from fyrox_tpu_torch.animation import skinning
    from fyrox_tpu_torch.physics import broadphase as bp
    from fyrox_tpu_torch.physics import fused_step, slab2
    t = engine.physics
    if fused_step.supports_fused_bp(t) or not fused_step.supports_fused(t):
        fail("the reuse flagship is not on the K2 route")
    walks = [0]
    walk = bp.slab_candidates

    def counted(*a, **k):
        walks[0] += 1
        return walk(*a, **k)

    def roll(state):
        for _ in range(TICKS):
            state = engine.step(state, bp_rank="count")
        bm = skinning.bone_matrices(state.scene.globals_, skin)
        return state, skinning.skin_positions_dense(bm, skin)

    state = engine.init_state(WORLDS, device="cuda")
    state, verts = roll(state)                      # warm-up
    torch.cuda.synchronize()
    bp.slab_candidates = counted     # one broadphase walk per rebuild
    try:
        reset_all_launches()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            state, verts = roll(state)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        n = all_launches()
    finally:
        bp.slab_candidates = walk
    n_ticks = TICKS * CALLS
    rebuilds = walks[0]
    want = dict(fused_bp=0, narrow_compact=n_ticks, solve_tgs=n_ticks,
                plane_gather=rebuilds, plane_scatter=rebuilds)
    if n != want or rebuilds == 0:
        fail(f"reuse slice launches {n}, want {want}")
    live = check_state(state, verts, skin)
    dem = slab2.bp_demand_stats(t, state.physics, period=PERIOD)
    # the host's read: a synchronise ahead of each reuse decision takes the
    # wait that the read would take; the decision then reads at once
    waits, calls = [], []
    decide = slab2.reuse_candidates

    def timed(*a, **k):
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = decide(*a, **k)
        calls.append(time.perf_counter() - t1)
        waits.append(t1 - t0)
        return out

    slab2.reuse_candidates = timed
    try:
        for _ in range(READ_TICKS):
            state = engine.step(state, bp_rank="count")
        torch.cuda.synchronize()
    finally:
        slab2.reuse_candidates = decide
    wait_ms = 1e3 * sum(waits) / len(waits)
    call_ms = 1e3 * sum(calls) / len(calls)
    rate = WORLDS * n_ticks / elapsed
    cls = ", ".join(f"class {c} max {dem[f'class{c}']['max_valid']} / "
                    f"{dem[f'class{c}']['cap']} ({dem[f'class{c}']['dropped']}"
                    f" dropped, tight {dem[f'class{c}']['tight_dropped']})"
                    for c in range(3) if dem[f"class{c}"]["cap"])
    log(f"[reuse] K2 route with temporal broadphase reuse (period {PERIOD}, "
        f"count rank), flagship {skin.num_bones} bones / {skin.num_vertices}"
        f" verts / {t.num_bodies - 1} bodies, W={WORLDS}: {rate:.1f} "
        f"env·steps/s ({CALLS} x {TICKS} ticks + skinning in {elapsed:.3f} s,"
        f" {elapsed * 1e3 / n_ticks:.3f} ms a tick, {live} live contact "
        f"points); {rebuilds} rebuilds in {n_ticks} ticks "
        f"({rebuilds / n_ticks:.3f} a tick); launches per tick: fused_bp 0, "
        f"narrow_compact 1, solve_tgs 1, plane_scatter and plane_gather "
        f"{rebuilds / n_ticks:.3f} (one each per rebuild); the rebuild read "
        f"waits {wait_ms:.3f} ms for the device and decides in "
        f"{call_ms:.3f} ms a tick ({READ_TICKS} instrumented ticks); demand "
        f"of the last timed state (tick {TICKS + n_ticks}, period {PERIOD}):"
        f" walk max {dem['max_walk']} / "
        f"{dem['s_walk']}, {cls} on {CARD}")
    return n


# float operations of K1's joint passes per joint and world, a hand count
# of csrc/tgs_solve.cu: the point constraint 330 and the angular lock 190
# per substep (with the body sums), the position pass 70 per stabilisation
# pass; and of the COM terms per body: 60 at load, 60 per substep, 40 per
# stabilisation pass
def k1_joint_ops(n_joints, n_bodies, w, p):
    per_joint = p.n_sub * (330 + 190) + 70 * p.n_stab
    per_body = 60 + 60 * p.n_sub + 40 * p.n_stab
    return (per_joint * n_joints + per_body * n_bodies) * w


def jointed_inputs(engine):
    """The settled jointed flagship: W distinct worlds after 30 ticks, and
    its staged step's packed K1 inputs and joint tables."""
    from fyrox_tpu_torch.physics import slab2
    from fyrox_tpu_torch.physics import world as phys_mod
    state = distinct_worlds(engine, WORLDS, "cuda", seed=5)
    for _ in range(30):
        state = engine.step(state)
    t = engine.physics
    accel, angvel = phys_mod.external_accelerations(state.physics, t,
                                                    engine.dt)
    packed, _ = slab2.solver_inputs(state.physics, t, engine.dt, accel,
                                    angvel)
    cx = slab2._ctx(t)
    return packed, cx.has_com, slab2.joint_tables(cx, "cuda")


def phase_solver_jointed(engine):
    """K1 with its joint tables and COM planes vs its plain version."""
    from fyrox_tpu_torch.physics import tgs_kernel
    t = engine.physics
    packed, has_com, joints = jointed_inputs(engine)
    params = tgs_kernel.solver_params(t, engine.dt)
    if not (has_com and joints is not None
            and joints.body_a.shape[0] == t.joints.num_joints):
        fail("the jointed flagship lost its joints or COM offsets")
    if not (all_differ(packed[0]) and all_differ(packed[2])):
        fail("the jointed solver's packed inputs repeat across worlds")
    kw = dict(has_com=has_com, joints=joints)
    got_b, got_l = tgs_kernel.solve_tgs(*packed, params, **kw)
    again_b, again_l = tgs_kernel.solve_tgs(*packed, params, **kw)
    ref_b, ref_l = tgs_kernel.solve_tgs_plain(*packed, params, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(got_b, again_b) and torch.equal(got_l, again_l)):
        fail("solve_tgs with joints: two launches on the same inputs differ")
    if not (torch.isfinite(got_b).all() and torch.isfinite(got_l).all()):
        fail("solve_tgs with joints produced non-finite values")
    err_pos = (got_b[:, 6:9] - ref_b[:, 6:9]).abs().max().item()
    err_vel = (got_b[:, 0:6] - ref_b[:, 0:6]).abs().max().item()
    err_q = (got_b[:, 9:13] - ref_b[:, 9:13]).abs().max().item()
    err_lam = (got_l - ref_l).abs().max().item()
    lam_excess = ((got_l - ref_l).abs()
                  - (1e-3 * ref_l.abs() + 1e-5)).max().item()
    n_act = int(packed[0][:, 9].sum().item())
    # The same solve in float64: a float32 solve of this scene carries
    # ~1.5e-4 m/s of rounding in its joint bodies' velocities, because the
    # joint bias turns one ulp of a position 6-8 m from the origin (4.8e-7
    # m) into 0.2/h = 48 /s x 4.8e-7 = 2.3e-5 m/s per joint and substep.
    # So the velocities are held to 3e-4 (twice that) and, on top, the
    # kernel must sit no farther from the float64 solve than the plain
    # float32 version does (+1e-5); pos, quat and lambda keep K1's bounds.
    j64 = joints._replace(jtab=joints.jtab.double())
    ref64, _ = tgs_kernel.solve_tgs_plain(
        packed[0].double(), packed[1], packed[2].double(), packed[3], params,
        has_com=has_com, joints=j64)
    k_vs_64 = (got_b[:, 0:6].double() - ref64[:, 0:6]).abs().max().item()
    p_vs_64 = (ref_b[:, 0:6].double() - ref64[:, 0:6]).abs().max().item()
    if (err_pos > 1e-5 or err_q > 1e-5 or err_vel > 3e-4 or lam_excess > 0
            or k_vs_64 > p_vs_64 + 1e-5):
        fail(f"solve_tgs with joints vs plain: pos {err_pos:.3g} (1e-5), "
             f"quat {err_q:.3g} (1e-5), vel {err_vel:.3g} (3e-4), lambda "
             f"{err_lam:.3g} (1e-3 rel + 1e-5); vel vs float64 kernel "
             f"{k_vs_64:.3g}, plain {p_vs_64:.3g}")
    ms_k = cuda_ms(lambda: tgs_kernel.solve_tgs(*packed, params, **kw), 10)
    dev_k = device_ms(lambda: tgs_kernel.solve_tgs(*packed, params, **kw),
                      10)
    ms_p = cuda_ms(lambda: tgs_kernel.solve_tgs_plain(*packed, params, **kw),
                   3)
    w, _, s, cg = packed[0].shape
    nj, nb = int(joints.body_a.shape[0]), packed[2].shape[2]
    b_ms, b_by = bound_ms(
        nbytes(*packed, *joints, got_b, got_l),
        k1_ops(s, cg, w, params) + k1_joint_ops(nj, nb, w, params))
    log(f"[K1joint] solve_tgs with {nj} joints and COM offsets matches plain "
        f"on a settled jointed-flagship step (W={WORLDS} distinct worlds, "
        f"{nb} bodies, {n_act} active contact points): pos {err_pos:.3g}, "
        f"quat {err_q:.3g}, vel {err_vel:.3g}, lambda {err_lam:.3g}; vel "
        f"vs float64 kernel {k_vs_64:.3g}, plain {p_vs_64:.3g}; two "
        f"launches bit-equal; kernel {ms_k:.3f} ms (device time "
        f"{dev_k:.3f}), plain {ms_p:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(name="solve_tgs_jointed", route="cuda",
                source="fyrox_tpu_torch/csrc/tgs_solve.cu",
                replaces="fyrox_tpu/physics/pallas_solver.py:816",
                max_abs_err=max(err_pos, err_vel, err_q, err_lam),
                ms=ms_k, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, device_ms=dev_k, library_device_ms=None)


# ---------------------------------------------------------------- K1big
# The flagship with a 2,000-body pile: past the 1,614 bodies whose planes
# fit one block's shared memory, so K1 takes its global-memory variant.
BIG_BODIES = 2000
BIG_TICKS = 5


def phase_k1_big():
    """build_flagship(n_bodies=2000) at W distinct worlds on the fused
    route: 30 settling ticks, then BIG_TICKS ticks with the launches
    counted; then fused_bp, narrow_compact and K1 on the next step's inputs
    vs their plain versions (K3 and K2 as in K3bp / K2nc, K1 at its
    bounds), timed."""
    from fyrox_tpu_torch.models import build_flagship
    from fyrox_tpu_torch.physics import fused_step, slab2, tgs_kernel
    from fyrox_tpu_torch.physics import world as phys_mod
    t0 = time.perf_counter()
    engine, _ = build_flagship(n_bones=100, n_verts=50_000,
                               n_bodies=BIG_BODIES)
    t = engine.physics
    nb, cg = t.num_bodies, int(t.grid.grid_cols.size)
    if not fused_step.supports_fused_bp(t):
        fail("K1big: the 2,000-body flagship is outside the K3 scope")
    if not tgs_kernel._layout(nb, cg, int(t.grid.s_active), False, 0)[0]:
        fail(f"K1big: {nb} bodies fit one block: not the global variant")
    # a raise here (the fault this variant repairs) ends the run non-zero
    state = distinct_worlds(engine, WORLDS, "cuda", seed=7)
    for _ in range(30):
        state = engine.step(state)
    torch.cuda.synchronize()
    reset_all_launches()
    for _ in range(BIG_TICKS):
        state = engine.step(state)
    torch.cuda.synchronize()
    n = all_launches()
    want = dict(fused_bp=BIG_TICKS, narrow_compact=BIG_TICKS,
                solve_tgs=BIG_TICKS, plane_gather=0, plane_scatter=0)
    if n != want:
        fail(f"K1big: launches {n}, want {want}")
    ph = state.physics
    if not (torch.isfinite(ph.position).all()
            and torch.isfinite(ph.linvel).all()):
        fail("K1big: non-finite body state")
    live = int((ph.warm_pair >= 0).sum())
    if live == 0:
        fail("K1big: no live contact points: physics did no work")
    body, warm_lam, warm_pid = fused_inputs(engine, state)
    (jv, col), n_valid = bp_against_plain("K1big", t, body, engine.dt)
    _, err_nc, n_act, _ = nc_against_plain("K1big", t, col, jv, warm_lam,
                                           warm_pid)
    dev_bp = device_ms(lambda: fused_step.bp_candidates(t, body, engine.dt),
                       20)
    dev_nc = device_ms(lambda: fused_step.narrow_compact(
        t, col, jv, warm_lam, warm_pid), 20)
    del jv, col, warm_lam, warm_pid
    log(f"[K1big] K3 fused_bp on {cg} grid colliders: windows equal to "
        f"plain as integers ({n_valid} valid candidates), collider planes "
        f"and two launches bit-equal, device time {dev_bp:.4f} ms; K2 "
        f"narrow_compact equal on pid, partner body and activity, planes "
        f"within {err_nc:.3g}, two launches bit-equal ({n_act} active "
        f"slots), device time {dev_nc:.4f} ms")
    accel, angvel = phys_mod.external_accelerations(ph, t, engine.dt)
    packed, _ = slab2.solver_inputs(ph, t, engine.dt, accel, angvel)
    params = tgs_kernel.solver_params(t, engine.dt)
    if not (all_differ(packed[0]) and all_differ(packed[2])):
        fail("K1big: the solver's packed inputs repeat across worlds")
    err, errs, ms_k, dev_k, ms_p, b_ms, b_by, visited = k1_against_plain(
        "K1big", packed, params)
    log(f"[K1big] flagship with {BIG_BODIES} bodies ({nb} with the ground, "
        f"{cg} grid colliders, {tgs_kernel.smem_bytes(nb, cg)} B > "
        f"{tgs_kernel.SMEM_LIMIT} B of shared memory), W={WORLDS}: "
        f"{BIG_TICKS} fused ticks with launches {n}, {live} live contact "
        f"points (set up in {time.perf_counter() - t0:.1f} s); K1 "
        f"(global-memory variant) matches plain on the next step: {errs}; "
        f"two launches bit-equal; {int(visited.sum())} live slots visited "
        f"per pass; kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    return k1_record("solve_tgs_big", err, ms_k, dev_k, ms_p, b_ms,
                     b_by), n


def staged_gathers(t):
    """K4a launches of one staged tick: the broadphase sort and walk, and
    one narrowphase partner gather per window class present."""
    return 2 + sum(1 for k in range(3) if t.grid.nslot(k))


def phase_jointed_small():
    """The joint zoo (all four joint kinds, COM offsets) on the card vs the
    CPU over 30 ticks, on the staged route with K1's joint tables."""
    from fyrox_tpu_torch.physics import fused_step
    from fyrox_tpu_torch.physics import world as phys_mod
    pb, t = joint_zoo(port_lib())
    if fused_step.supports_fused(t):
        fail("the joint zoo is inside the fused scope")
    st0 = jitter(phys_mod.init_physics_state(pb.initial_pose(), t, 4,
                                             device="cpu"), t, "cpu", 9)
    reset_all_launches()
    # the JAX package's bounds between its two implementations of a
    # jointed, COM-offset 40-step trajectory (test_pallas_solver.py:
    # 185-203: dp 2e-3, dv 2e-2)
    dp, dv, live, _ = card_vs_cpu(
        "joint zoo", t, st0, 30,
        lambda st: phys_mod.step_physics(st, t, 1.0 / 60.0), (2e-3, 2e-2))
    n = all_launches()
    want = dict(fused_bp=0, narrow_compact=0, solve_tgs=30,
                plane_gather=30 * staged_gathers(t), plane_scatter=0)
    if n != want:
        fail(f"the joint zoo's launches {n}, want {want}")
    kinds = sorted(set(int(k) for k in t.joints.kind))
    log(f"[jointed-small] joint zoo ({t.joints.num_joints} joints of kinds "
        f"{kinds}, COM offsets), card == CPU over 30 ticks on the staged "
        f"route (W=4 distinct worlds, {live} live contact points; launches "
        f"{n}): dp {dp:.3g}, dv {dv:.3g}")


def phase_jointed(engine, skin, anchors):
    """The full-width jointed slice: Engine.step on the jointed flagship,
    W worlds, CALLS rolls of TICKS ticks + skinning, timed."""
    from fyrox_tpu_torch.animation import skinning
    from fyrox_tpu_torch.physics import fused_step
    t = engine.physics
    if fused_step.supports_fused(t):
        fail("the jointed flagship is inside the fused scope")
    state = engine.init_state(WORLDS, device="cuda")

    def roll(state):
        for _ in range(TICKS):
            state = engine.step(state)
        bm = skinning.bone_matrices(state.scene.globals_, skin)
        return state, skinning.skin_positions_dense(bm, skin)

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
    gathers = staged_gathers(t)
    want = dict(fused_bp=0, narrow_compact=0, solve_tgs=n_ticks,
                plane_gather=n_ticks * gathers, plane_scatter=0)
    if n != want:
        fail(f"jointed slice launches {n}, want {want}")
    live = check_state(state, verts, skin)
    # every chain hangs: its tip within chain reach of its anchor
    # (test_pallas_solver.py:190-193), in every world
    pos = state.physics.position
    tips = [a + 4 for a in chain_anchor_bodies(t)]
    reach = (pos[:, tips] - torch.as_tensor(np.asarray(anchors, np.float32),
                                            device=pos.device)[None])
    far = float(reach.norm(dim=-1).max())
    if not far < 2.6:
        fail(f"a chain tip is {far:.3f} m from its anchor (2.6 m reach)")
    rate = WORLDS * n_ticks / elapsed
    log(f"[jointed] staged route with K1's joint tables (supports_fused "
        f"False), jointed flagship {skin.num_bones} bones / "
        f"{skin.num_vertices} verts / {t.num_bodies} bodies / "
        f"{t.joints.num_joints} joints, W={WORLDS}: {rate:.1f} env·steps/s "
        f"({CALLS} x {TICKS} ticks + skinning in {elapsed:.3f} s, {live} live"
        f" contact points, farthest chain tip {far:.3f} m; launches per "
        f"tick: solve_tgs 1 with joint tables, plane_gather {gathers}, "
        f"fused_bp 0, narrow_compact 0) on {CARD}")
    return n


def chain_anchor_bodies(t):
    """Body index of each chain's static anchor: a static body whose next
    four bodies are joined to it and to one another in a line."""
    ja, jb = np.asarray(t.joints.body_a), np.asarray(t.joints.body_b)
    static = np.asarray(t.body_type) != 0
    return [int(a) for a, b in zip(ja, jb) if static[a] and b == a + 1]


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
                plane_gather=0, plane_scatter=0)
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
    gathers_per_tick = staged_gathers(engine.physics)
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
                plane_gather=STAGED * gathers_per_tick, plane_scatter=0)
    if n != want:
        fail(f"staged roll launches {n}, want {want}")
    live = check_state(state, verts, skin)
    rate = WORLDS * STAGED / elapsed
    log(f"[staged] staged route (fused=False), same flagship, W={WORLDS}: "
        f"{rate:.1f} env·steps/s ({STAGED} ticks + skinning in "
        f"{elapsed:.3f} s, {live} live contact points; launches per tick: "
        f"plane_gather {gathers_per_tick}, solve_tgs 1) on {CARD}")
    return n


def device_events(prof):
    """(device events, microseconds of device time as the union of their
    intervals) of a torch.profiler run."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, -1.0
    for a, b in spans:                        # union of device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return kernels, busy_us


def phase_profile(engine, settled):
    """Device events per tick and the device's busy share, per route, from
    the slice's last state."""
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
        kernels, busy_us = device_events(prof)
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


# ---------------------------------------------------------------- render
# bench_render.py's configuration, not cut: 16 worlds at 256 x 256, a 40 m
# ground + 32 cubes + 32 spheres, one directional light with 3-cascade CSM
RENDER_WORLDS = 16
RENDER_SIZE = 256
RENDER_FRAMES = 5    # timed frames after one warm-up frame
RENDER_PROFILED = 3  # frames under the profiler
# float operations K5 must spend on a (pixel, slot) pair whose three edge
# tests pass, a hand count: five affine forms of 2 multiplies and 2 adds,
# two subtracts, one divide, eight compares. K5's bound counts these for the
# covered pairs only (k5_covered_pairs): a pair that an edge test rejects
# needs no z, and csrc/tile_raster.cu skips most such pairs unevaluated.
K5_OPS = 31


def render_scene(n_worlds, device, seed=0):
    """The bench scene (bench_render.py:31-72) with its render template
    and config, W worlds whose mesh nodes are moved by seeded jitter
    (±5 cm), so that no two worlds render the same images."""
    from fyrox_tpu_torch.render import (RenderConfig, build_render_template,
                                        make_cube, make_plane, make_sphere)
    from fyrox_tpu_torch.scene import NodeType, SceneBuilder, graph
    from fyrox_tpu_torch.scene import init_state
    sb = SceneBuilder()
    sb.add_mesh(make_plane(40.0, albedo=(0.5, 0.5, 0.5)), name="ground")
    rng = np.random.default_rng(0)
    for i in range(64):
        x, z = rng.uniform(-10, 10, 2)
        if i % 2:
            sb.add_mesh(make_cube(1.0, albedo=(0.7, 0.3, 0.2)),
                        position=(x, 0.5, z))
        else:
            sb.add_mesh(make_sphere(0.5, slices=8, stacks=8,
                                    albedo=(0.2, 0.4, 0.7)),
                        position=(x, 0.5, z))
    tilt = (np.sin(np.pi / 3), 0.0, 0.0, np.cos(np.pi / 3))
    sb.add_light("directional", rotation=tilt, intensity=2.0)
    look_down = (np.sin(np.pi / 8), 0.0, 0.0, np.cos(np.pi / 8))
    sb.add_camera("cam", position=(0, 8.0, -14.0), rotation=look_down)
    t = sb.build()
    st = init_state(t, n_worlds, device=device)
    mesh = torch.as_tensor(t.node_type == NodeType.MESH, device=device)
    noise = np.random.default_rng(seed).uniform(
        -0.05, 0.05, tuple(st.position.shape)).astype(np.float32)
    st = st._replace(position=st.position + torch.as_tensor(
        noise, device=device) * mesh[None, :, None].float())
    st = graph.update_hierarchical_data(st, t)
    cfg = RenderConfig(width=RENDER_SIZE, height=RENDER_SIZE, shadows=True,
                       cascade_tri_budget=(0.05, 1.0, 0.75), k_per_tile=424,
                       csm_k_per_tile=896)
    return t, build_render_template(t), st, cfg


def capture_k5_inputs(t, rt, st, cfg):
    """The K5 inputs of one frame of the main path, as it calls the
    dispatch point (launches made here are not counted)."""
    from fyrox_tpu_torch.render import render_frame, tile_raster
    seen = []
    dispatch = tile_raster.visibility

    def spy(*args, **kw):
        seen.append((args, kw.get("depth_only", False)))
        return dispatch(*args, **kw)

    tile_raster.visibility = spy
    try:
        render_frame(st, t, rt, cfg)
    finally:
        tile_raster.visibility = dispatch
    torch.cuda.synchronize()
    return seen


def k5_covered_pairs(feats, ids, count, height, width, tile_h, tile_w):
    """The (pixel, walked slot) pairs whose e0, e1, e2 >= 0, by
    visibility_plain's arithmetic on the same inputs: the pairs that any
    implementation of K5 has to finish."""
    from fyrox_tpu_torch.render import tile_raster
    b = feats.shape[0]
    nty, ntx = height // tile_h, width // tile_w
    nt, k = nty * ntx, ids.shape[-1]
    rows = torch.gather(feats, 1, ids.reshape(b, nt * k, 1).long().expand(
        b, nt * k, 16)).reshape(b, nt, k, 16)
    cnt = count.reshape(b, nt, 1, 1)
    px, py = tile_raster._pixel_centres(nty, ntx, tile_h, tile_w,
                                        feats.device)
    total = 0
    for j in range(int(count.max()) if count.numel() else 0):
        f = rows[:, :, j, :, None, None]

        def aff(i):
            return f[:, :, i] * px + f[:, :, i + 1] * py + f[:, :, i + 2]

        e0, e1, s = aff(0), aff(3), aff(6)
        e2 = s - e0 - e1
        total += int(((e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (j < cnt)).sum())
    return total


def k5_bytes(feats, ids, count, outs):
    """The bytes K5 has to move: each tile's count and the ids of the slots
    it walks read once, each feature row that some tile of its image walks
    read once, the outputs written once."""
    b, t = feats.shape[:2]
    walked = torch.arange(ids.shape[-1], device=ids.device) < count[..., None]
    img = torch.arange(b, device=ids.device).reshape(b, 1, 1) * t
    rows = torch.unique((ids.long() + img)[walked]).numel()
    return (nbytes(count, *outs) + int(walked.sum()) * ids.element_size()
            + rows * feats.shape[2] * feats.element_size())


def k5_knife_edges(height=16, width=256, tile_h=8, tile_w=128, n_img=2,
                   n_rows=150, seed=0, device="cpu"):
    """K5 inputs on its knife edges, as visibility() takes them. Feature
    rows are written directly from half-integers, so every form rounds
    exactly and an edge through a pixel centre gives e = 0 there (inside):
    vertical and horizontal edges through the centres on K5's warp
    rectangles' borders (every 16 columns) and the tiles' outer rows and
    columns, strips whose e2 is 0 everywhere, diagonal e2 edges through
    centres, rows whose ok flag is 0 or whose W <= 1e-12 over the image
    (both nearest the camera), negative-zero coefficients, z ties (+0
    against -0 among them), W slopes. Each tile walks its rows in its own
    seeded order, most of them more than one 64-row chunk (and more than
    tile_raster.SPLIT_SPAN); one tile walks none."""
    rng = np.random.default_rng(seed)
    xs = sorted({0.5, width - 0.5} | {c + d for c in range(16, width, 16)
                                      for d in (-0.5, 0.5)})
    ys = sorted({0.5, height - 0.5} | {c + d for c in range(tile_h, height,
                                                            tile_h)
                                       for d in (-0.5, 0.5)})

    def centre(edges, n):
        if rng.random() < 0.7:
            return float(rng.choice(edges))
        return float(rng.integers(0, n)) + 0.5

    def nz():
        return -0.0 if rng.random() < 0.5 else 0.0

    feats = np.zeros((n_img, n_rows, 16), np.float32)
    for b in range(n_img):
        z_seen = []
        for r in range(n_rows):
            cx, cy = centre(xs, width), centre(ys, height)
            cx1, cy1 = centre(xs, width), centre(ys, height)
            kind = int(rng.integers(0, 4))
            if kind == 0:                  # vertical strip, e2 = 0
                x0, x1 = sorted((cx, cx1))
                e0, e1, sr = (1, nz(), -x0), (-1, nz(), x1), (nz(), nz(),
                                                             x1 - x0)
            elif kind == 1:                # horizontal strip, e2 = 0
                y0, y1 = sorted((cy, cy1))
                e0, e1, sr = (nz(), 1, -y0), (nz(), -1, y1), (nz(), nz(),
                                                             y1 - y0)
            elif kind == 2:                # a quadrant
                sx, sy = rng.choice([-1.0, 1.0], 2)
                e0, e1 = (sx, nz(), -sx * cx), (nz(), sy, -sy * cy)
                sr = (nz(), nz(), 4096.0)
            else:                          # e2 = cx1 + cy1 - px - py
                e0, e1 = (1, nz(), -cx), (nz(), 1, -cy)
                sr = (nz(), nz(), cx1 + cy1 - cx - cy)
            z0 = (float(rng.choice(z_seen)) if z_seen and rng.random() < 0.2
                  else float(rng.choice([0.0, -0.0])) if rng.random() < 0.1
                  else float(rng.uniform(-0.9, 0.9)))
            z_seen.append(z0)
            zr = (float(rng.choice([0.0, -0.0, 2.0 ** -10])), nz(), z0)
            wr, ok = (nz(), nz(), 1.0), 1.0
            special = rng.random()
            if special < 0.1:              # not ok, nearest, covering
                ok, zr = 0.0, (0.0, 0.0, -0.99)
            elif special < 0.2:            # behind the camera everywhere
                zr = (0.0, 0.0, -0.99 * 1e-12)
                wr = [(0.0, 0.0, 1e-12), (1e-15, nz(), 0.0),
                      (nz(), nz(), -1.0)][int(rng.integers(0, 3))]
            elif special < 0.3:            # W crosses 0 over the image
                wr = (2.0 ** -7, nz(), -cx * 2.0 ** -7)
                zr = (0.0, 0.0, z0 * 2.0 ** -2)
            feats[b, r] = (*e0, *e1, *sr, *zr, *wr, ok)
    nt = (height // tile_h) * (width // tile_w)
    k = -(-n_rows // 8) * 8
    ids = np.zeros((n_img, nt, k), np.int32)
    count = np.full((n_img, nt), n_rows, np.int32)
    for b in range(n_img):
        for t in range(nt):
            ids[b, t, :n_rows] = rng.permutation(n_rows)
            if rng.random() < 0.3:
                count[b, t] = rng.integers(1, n_rows + 1)
    count[0, 0] = 0

    def dev(a):
        return torch.as_tensor(a, device=device)

    return (dev(feats), dev(ids), dev(count), height, width, tile_h, tile_w)


def phase_k5(inputs, depth_only):
    """One K5 variant vs its plain version at the main path's shapes."""
    from fyrox_tpu_torch.render import tile_raster
    args = next(a for a, d in inputs if d == depth_only)
    feats, ids, count, h, w, th, tw = args
    label = "K5depth" if depth_only else "K5full"
    if not all_differ(feats):
        fail(f"{label}: the images' feature rows repeat")

    def kernel():
        return tile_raster._visibility_cuda(*args, depth_only=depth_only)

    def plain():
        return tile_raster.visibility_plain(*args, depth_only=depth_only)

    got, again, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    parts, span = tile_raster.split_parts()
    got = (got,) if depth_only else got
    again = (again,) if depth_only else again
    ref = (ref,) if depth_only else ref
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{label}: two launches on the same inputs differ")
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        diffs = [int((a != b).sum()) for a, b in zip(got, ref)]
        fail(f"{label}: kernel differs from its plain version at {diffs} "
             f"entries (z{'' if depth_only else ', idx, w0, w1'})")
    z = got[0]
    hit = float((z < 1e8).float().mean())
    if not (all_differ(z) and hit > 0.05):
        fail(f"{label}: images repeat, or {hit:.3f} of pixels hit")
    edges = k5_knife_edges(device="cuda")
    got_e = tile_raster._visibility_cuda(*edges, depth_only=depth_only)
    ref_e = tile_raster.visibility_plain(*edges, depth_only=depth_only)
    got_e = (got_e,) if depth_only else got_e
    ref_e = (ref_e,) if depth_only else ref_e
    if not all(torch.equal(a, b) for a, b in zip(got_e, ref_e)):
        fail(f"{label}: kernel differs from its plain version on the "
             f"knife-edge inputs (k5_knife_edges)")
    ms_k = cuda_ms(kernel, 20)
    dev_k = device_ms(kernel, 20)
    ms_p = cuda_ms(plain, 2)
    walked = int(count.sum())
    covered = k5_covered_pairs(*args)
    moved = k5_bytes(feats, ids, count, got)
    b_ms, b_by = bound_ms(moved, covered * K5_OPS)
    old_ms, _ = bound_ms(0, walked * th * tw * K5_OPS)
    cnt = count.flatten().float()
    log(f"[{label}] tile_raster {'depth-only' if depth_only else 'full'} "
        f"bit-equal to plain (z{'' if depth_only else ', idx, w0, w1'}) on "
        f"{feats.shape[0]} distinct images of {h}x{w}, K={ids.shape[2]}, "
        f"and on the knife-edge inputs; {walked} walked slots (per tile "
        f"mean {float(cnt.mean()):.1f}, p99 "
        f"{float(cnt.quantile(0.99)):.0f}, max {int(cnt.max())}), "
        f"{covered} covered (pixel, slot) pairs of {walked * th * tw} "
        f"walked, {int((count > span).sum())} tiles above {span} slots "
        f"split into {parts} parts, "
        f"{hit:.3f} of pixels hit; two launches bit-equal; kernel "
        f"{ms_k:.4f} ms (device time {dev_k:.4f}), plain {ms_p:.3f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}: {moved} bytes moved, covered pairs "
        f"x {K5_OPS} ops; walked pairs x {K5_OPS} ops would read "
        f"{old_ms:.4f})")
    return dict(name="tile_raster_depth" if depth_only else "tile_raster_full",
                route="cuda", source="fyrox_tpu_torch/csrc/tile_raster.cu",
                replaces="fyrox_tpu/render/pallas_raster.py:352",
                max_abs_err=0.0, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, device_ms=dev_k,
                library_device_ms=None)


def phase_render_audit(t, rt, st, cfg):
    """Per-pass true bin demand against its cap, and each culled cascade's
    in-footprint count against its budget, on the full-width slice."""
    from fyrox_tpu_torch.render import render_frame_demand
    from fyrox_tpu_torch.render.shadows import cascade_budgets
    foot = []
    _, demand, caps = render_frame_demand(st, t, rt, cfg, footprint=foot)
    dmax = [int(d) for d in demand.max(0).values.tolist()]
    budgets = cascade_budgets(cfg.cascade_tri_budget, rt.num_triangles)
    counts = iter((int(n.max()), b) for n, b in foot)
    per_cascade = [next(counts) if b else (None, "full") for b in budgets]
    log(f"[render-audit] bin demand max / cap per pass (camera, cascades "
        f"0-2): {list(zip(dmax, caps))}; in-footprint max / budget per "
        f"cascade: {per_cascade} of T={rt.num_triangles}")
    over = [(p, d, k) for p, (d, k) in enumerate(zip(dmax, caps)) if d >= k]
    if over or len(caps) != 4:
        fail(f"render-audit: bin overflow (pass, demand, cap) {over}")
    if any(n is not None and n >= b for n, b in per_cascade):
        fail(f"render-audit: a cascade's in-footprint count reaches its "
             f"budget: {per_cascade}")
    return dmax, caps, per_cascade


def phase_render_cpu():
    """A small frame (2 worlds, 32 x 32) on the card agrees with the same
    frame on the CPU."""
    from fyrox_tpu_torch import convert
    from fyrox_tpu_torch.render import CsmConfig, render_frame_demand
    t, rt, st, cfg = render_scene(2, "cpu", seed=3)
    cfg = cfg._replace(width=32, height=32, csm=CsmConfig(map_size=64))
    gpu = convert.scene_state(convert.to_numpy(st), device="cuda")
    cpu_color, cpu_dem, caps = render_frame_demand(st, t, rt, cfg)
    gpu_color, gpu_dem, gpu_caps = render_frame_demand(gpu, t, rt, cfg)
    err = (gpu_color.cpu() - cpu_color).abs()
    # 99.9 % of the values within 1e-4: sums over short axes run in other
    # orders on the two devices, and a pixel on a triangle's edge whose
    # coverage flips on a last-bit difference moves by its whole color
    frac = float((err <= 1e-4).float().mean())
    if not (frac >= 0.999 and caps == gpu_caps
            and float(cpu_color.abs().sum()) > 0):
        fail(f"render-cpu: card vs CPU colors {float(err.max()):.3g} max, "
             f"{frac:.4f} within 1e-4; caps {gpu_caps} vs {caps}")
    log(f"[render-cpu] 2 worlds, 32x32: card == CPU, colors max "
        f"{float(err.max()):.3g} ({frac:.4f} of values within 1e-4); demand "
        f"card {gpu_dem.max(0).values.tolist()} / CPU "
        f"{cpu_dem.max(0).values.tolist()}, caps {caps}")


def phase_render(t, rt, st, cfg):
    """The full-width render slice: one warm-up frame, then RENDER_FRAMES
    timed frames; K5 must launch exactly twice per frame."""
    from fyrox_tpu_torch.render import render_frame, tile_raster
    color, _ = render_frame(st, t, rt, cfg)                  # warm-up
    torch.cuda.synchronize()
    tile_raster.reset_launches()
    t0 = time.perf_counter()
    for _ in range(RENDER_FRAMES):
        color, gbuf = render_frame(st, t, rt, cfg)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    n = dict(full=tile_raster.launches("full"),
             depth=tile_raster.launches("depth"))
    if n != dict(full=RENDER_FRAMES, depth=RENDER_FRAMES):
        fail(f"render slice launches {n}, want {RENDER_FRAMES} of each")
    shape = (RENDER_WORLDS, RENDER_SIZE, RENDER_SIZE, 3)
    cover = float(gbuf.mask.float().mean())
    if not (tuple(color.shape) == shape and bool(torch.isfinite(color).all())
            and float(color.abs().sum()) > 0 and cover > 0.1):
        fail(f"render slice: color {tuple(color.shape)}, coverage {cover}, "
             "empty or not finite")
    fps = RENDER_WORLDS * RENDER_FRAMES / elapsed
    frame_ms = elapsed * 1e3 / RENDER_FRAMES
    log(f"[render] deferred + CSM, bench_render scene (T={rt.num_triangles}"
        f"), W={RENDER_WORLDS}, {RENDER_SIZE}x{RENDER_SIZE}: {fps:.1f} "
        f"frames/s, {frame_ms:.3f} ms per frame of all worlds, "
        f"{frame_ms / RENDER_WORLDS:.4f} ms/frame/world ({RENDER_FRAMES} "
        f"frames in {elapsed:.3f} s, coverage {cover:.3f}; K5 launches per "
        f"frame: full 1, depth 1) on {CARD}")
    return n


def phase_render_profile(t, rt, st, cfg):
    """Device events per frame and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile
    from fyrox_tpu_torch.render import render_frame
    render_frame(st, t, rt, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RENDER_PROFILED):
        render_frame(st, t, rt, cfg)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3 / RENDER_PROFILED
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(RENDER_PROFILED):
            render_frame(st, t, rt, cfg)
        torch.cuda.synchronize()
    kernels, busy_us = device_events(prof)
    if not kernels:
        log("[render-profile] the profiler recorded no device events (not "
            "measured)")
        return
    busy_ms = busy_us / 1e3 / RENDER_PROFILED
    top = sorted(((e.key, e.device_time_total / 1e3 / RENDER_PROFILED)
                  for e in prof.key_averages()
                  if getattr(e, "device_time_total", 0) > 0),
                 key=lambda kv: -kv[1])[:6]
    log(f"[render-profile] W={RENDER_WORLDS}: "
        f"{len(kernels) / RENDER_PROFILED:.1f} device events per frame, "
        f"{busy_ms:.3f} ms of device time per {frame_ms:.3f} ms unprofiled "
        f"frame (busy share {busy_ms / frame_ms:.3f}); top device ms per "
        f"frame: " + ", ".join(f"{k[:48]} {v:.3f}" for k, v in top)
        + f" on {CARD}")


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
    phase_rank(engine, inputs)
    phase_bp_audit(engine, inputs)
    del inputs, windows
    phase_small()
    phase_piles()
    n_fused, settled = phase_slice(engine, skin)
    n_staged = phase_staged(engine, skin, settled)
    phase_profile(engine, settled)
    del engine, skin, settled
    t0 = time.perf_counter()
    engine, skin = build_flagship(n_bones=100, n_verts=50_000, n_bodies=1000,
                                  broadphase_period=PERIOD)
    log(f"[setup] reuse flagship templates built in "
        f"{time.perf_counter() - t0:.1f} s")
    reuse_state = settled_reuse(engine)
    phase_nc_reuse(engine, reuse_state)
    k4b = phase_k4b(capture_k4b_inputs(engine, reuse_state))
    del reuse_state
    phase_reuse_small()
    n_reuse = phase_reuse(engine, skin)
    del engine, skin
    t0 = time.perf_counter()
    engine, skin, anchors, _ = jointed_engine()
    log(f"[setup] jointed flagship templates built in "
        f"{time.perf_counter() - t0:.1f} s")
    k1j = phase_solver_jointed(engine)
    phase_jointed_small()
    n_jointed = phase_jointed(engine, skin, anchors)
    del engine, skin
    k1b, n_big = phase_k1_big()
    scene = render_scene(RENDER_WORLDS, "cuda")
    inputs = capture_k5_inputs(*scene)
    k5f = phase_k5(inputs, depth_only=False)
    k5d = phase_k5(inputs, depth_only=True)
    del inputs
    phase_render_audit(*scene)
    phase_render_cpu()
    n_render = phase_render(*scene)
    phase_render_profile(*scene)
    for k in (kbp, knc, k1):
        k["launches"] = n_fused[k["name"]]
    k4["launches"] = n_staged["plane_gather"]
    k5f["launches"] = n_render["full"]
    k5d["launches"] = n_render["depth"]
    k1j["launches"] = n_jointed["solve_tgs"]
    k4b["launches"] = n_reuse["plane_scatter"]
    k1b["launches"] = n_big["solve_tgs"]
    records = [kbp, knc, k1, k4, k5f, k5d, k1j, k4b, k1b]
    print(json.dumps({"kernels": records}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
