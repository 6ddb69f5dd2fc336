"""The port's two physics routes on one CUDA card: alternating pairs of
fresh processes, and a per-stage breakdown of each route's engine tick.

    python3 route_bench.py [--pairs N]

Each side of a pair is a fresh process (``route_bench.py --one fused`` or
``--one staged``) that builds the full-width flagship (100 bones / 50k
vertices / 1000 bodies, W=128), runs one warm-up roll of 20 engine ticks +
skinning, then times ROLLS such rolls ending in torch.cuda.synchronize()
(env·steps/s). Pairs alternate their order: fused first, then staged first.
Then one fresh process per route (``--stages ROUTE``) settles the flagship
for 40 ticks and times the tick's stages one at a time between
torch.cuda.synchronize() calls (host clock, mean of REPS calls each).
Prints one line per measurement and, last, a JSON summary. Needs one card.
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

WORLDS = 128
TICKS = 20
ROLLS = 2
REPS = 5


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def flagship():
    from fyrox_tpu_torch.models import build_flagship
    return build_flagship(n_bones=100, n_verts=50_000, n_bodies=1000)


def one(route):
    """One side of a pair: env·steps/s of ROLLS timed rolls."""
    from fyrox_tpu_torch.animation import skinning
    engine, skin = flagship()
    fused = route == "fused"
    state = engine.init_state(WORLDS, device="cuda")

    def roll(state):
        for _ in range(TICKS):
            state = engine.step(state, fused=fused)
        bm = skinning.bone_matrices(state.scene.globals_, skin)
        return state, skinning.skin_positions_dense(bm, skin)

    state, _ = roll(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ROLLS):
        state, verts = roll(state)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if not bool(torch.isfinite(verts).all()):
        raise SystemExit("non-finite skinned vertices")
    print(json.dumps({"route": route, "seconds": elapsed,
                      "rate": WORLDS * TICKS * ROLLS / elapsed}))


def host_ms(fn):
    """Mean host milliseconds of fn between synchronisations."""
    fn()
    out = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return 1e3 * float(np.mean(out))


def stages(route):
    """The stages of Engine.step (engine.py) timed one at a time."""
    from fyrox_tpu_torch._util import const
    from fyrox_tpu_torch.animation import player as player_mod
    from fyrox_tpu_torch.animation import skinning
    from fyrox_tpu_torch.physics import fused_step, slab2, tgs_kernel
    from fyrox_tpu_torch.physics import world as phys_mod
    from fyrox_tpu_torch.scene import graph as graph_mod
    engine, skin = flagship()
    fused = route == "fused"
    t, dt = engine.physics, engine.dt
    state = engine.init_state(WORLDS, device="cuda")
    for _ in range(40):
        state = engine.step(state, fused=fused)
    sc, ph, an = state.scene, state.physics, state.animation
    params = torch.zeros((WORLDS, 1), dtype=torch.bool, device="cuda")
    accel, angvel = phys_mod.external_accelerations(ph, t, dt)
    out = {
        "tick": host_ms(lambda: engine.step(state, fused=fused)),
        "animation (ABSM)": host_ms(lambda: player_mod.step_absm(
            engine.animations, engine.machine, an.anim, an.machine, params,
            sc.position, sc.rotation, sc.scale, dt)),
        "scene graph, pre-physics": host_ms(lambda: graph_mod.step(
            sc, engine.template, dt,
            update_hierarchy=not engine._bodies_at_root())),
        "physics step": host_ms(lambda: phys_mod.step_physics(
            ph, t, dt, fused=fused)),
        "body sync + hierarchy refresh": host_ms(
            lambda: graph_mod.update_hierarchical_data(
                engine._sync_bodies_to_nodes(sc, ph), engine.template)),
        "skinning (per roll)": host_ms(lambda: skinning.skin_positions_dense(
            skinning.bone_matrices(sc.globals_, skin), skin)),
    }
    p = tgs_kernel.solver_params(t, dt)
    if fused:
        body, wl, wp = fused_step._inputs(ph, t, accel, angvel)
        jv, col = fused_step.bp_candidates(t, body, dt)
        con, bj, _ = fused_step.narrow_compact(t, col, jv, wl, wp)
        cb = const(slab2._ctx(t).grid_body, body.device)
        out.update({
            "— packing (body planes, warm carries)": host_ms(
                lambda: fused_step._inputs(ph, t, accel, angvel)),
            "— fused_bp": host_ms(lambda: fused_step.bp_candidates(
                t, body, dt)),
            "— narrow_compact": host_ms(lambda: fused_step.narrow_compact(
                t, col, jv, wl, wp)),
            "— solve_tgs": host_ms(lambda: tgs_kernel.solve_tgs(
                con, bj, body, cb, p)),
        })
    else:
        packed, _ = slab2.solver_inputs(ph, t, dt, accel, angvel)
        out.update({
            "— pre-solve (pose … warm match)": host_ms(
                lambda: slab2.solver_inputs(ph, t, dt, accel, angvel)),
            "— solve_tgs": host_ms(lambda: tgs_kernel.solve_tgs(*packed, p)),
        })
    print(json.dumps({"route": route, "stages_ms": out}))


def run_child(*args):
    proc = subprocess.run([sys.executable, __file__, *args],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{' '.join(args)} failed:\n{proc.stdout}\n"
                         f"{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--one", choices=("fused", "staged"))
    ap.add_argument("--stages", choices=("fused", "staged"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("route_bench.py needs a CUDA card")
    import fyrox_tpu_torch
    fyrox_tpu_torch.disable_tf32()
    if args.one:
        return one(args.one)
    if args.stages:
        return stages(args.stages)
    name = card()
    print(f"[card] {name}", flush=True)
    rates = {"fused": [], "staged": []}
    wins = 0
    for i in range(args.pairs):
        order = ("fused", "staged") if i % 2 == 0 else ("staged", "fused")
        got = {r: run_child("--one", r)["rate"] for r in order}
        for r in order:
            rates[r].append(got[r])
        wins += got["fused"] > got["staged"]
        print(f"[pair {i}] order {order[0]} first: fused "
              f"{got['fused']:.1f}, staged {got['staged']:.1f} env·steps/s",
              flush=True)
    summary = {"card": name, "pairs": args.pairs, "fused_wins": wins}
    for r, v in rates.items():
        q1, med, q3 = np.percentile(v, [25, 50, 75])
        summary[r] = dict(median=med, q1=q1, q3=q3, rates=v)
        print(f"[{r}] median {med:.1f} env·steps/s (quartiles {q1:.1f}-"
              f"{q3:.1f}) over {len(v)} fresh processes", flush=True)
    for r in ("fused", "staged"):
        st = run_child("--stages", r)["stages_ms"]
        summary[f"{r}_stages_ms"] = st
        print(f"[stages {r}] " + ", ".join(f"{k} {v:.3f} ms"
                                           for k, v in st.items()),
              flush=True)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
