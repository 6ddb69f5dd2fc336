"""The port's counterpart of bench.py: env·steps/s of the flagship world on
one CUDA card, timed through Engine.rollout.

    python3 bench_torch.py [--worlds 128] [--bodies 1000] [--verts 50000]
                           [--bones 100] [--steps 20] [--calls 5]
                           [--processes 3] [--scaling]

Workload (bench.py:47-69, 90-98): build_flagship(n_bones, n_verts,
n_bodies) at W worlds; a roll is Engine.rollout(state, steps), one
captured CUDA graph of the engine tick replayed `steps` times (the JAX
package's one lax.scan dispatch), then bone_matrices +
skin_positions_dense. One warm-up roll (it captures the tick), then
`calls` timed rolls ending in torch.cuda.synchronize(). Each measurement
runs in a fresh process (``--one W``), `--processes` of them, and the value
is their median: single-process readings of this host-bound program spread
widely. ``--scaling`` sweeps W over 32..512, prints the table and reports
the best W, as bench.py's FYROX_BENCH_SCALING does (this script writes no
file). Prints one JSON line last: metric, value, unit, the physics route
that ran (K3, K2, staged or dense) and the card's name and power limit
(nvidia-smi). Needs one CUDA card; there is no CPU mode.
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

SCALING_WORLDS = (32, 64, 128, 256, 512)


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def route(t):
    """The physics route Engine.step takes for template t (fused=True)."""
    from fyrox_tpu_torch.physics import fused_step
    if t.grid is None:
        return "dense"
    if fused_step.supports_fused_bp(t):
        return "K3"
    return "K2" if fused_step.supports_fused(t) else "staged"


def one(args, worlds):
    """One fresh process's measurement: env·steps/s of `calls` rolls."""
    from fyrox_tpu_torch.animation import skinning
    from fyrox_tpu_torch.models import build_flagship
    engine, skin = build_flagship(n_bones=args.bones, n_verts=args.verts,
                                  n_bodies=args.bodies)
    state = engine.init_state(worlds, device="cuda")
    params = torch.zeros((worlds, 1), dtype=torch.bool, device="cuda")

    def roll(state):
        state = engine.rollout(state, args.steps, machine_params=params)
        bm = skinning.bone_matrices(state.scene.globals_, skin)
        return state, skinning.skin_positions_dense(bm, skin)

    t0 = time.perf_counter()
    state, verts = roll(state)                      # warm-up: captures
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(args.calls):
        state, verts = roll(state)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if not bool(torch.isfinite(verts).all()):
        raise SystemExit("non-finite skinned vertices")
    print(json.dumps({"worlds": worlds, "route": route(engine.physics),
                      "warmup_seconds": setup,
                      "rate": worlds * args.steps * args.calls / elapsed}))


def measure(args, worlds):
    """Median env·steps/s over `processes` fresh processes at W worlds."""
    flags = [f"--{k}={getattr(args, k)}" for k in
             ("bodies", "verts", "bones", "steps", "calls")]
    runs = []
    for _ in range(args.processes):
        proc = subprocess.run([sys.executable, __file__, "--one",
                               str(worlds), *flags], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise SystemExit(f"bench_torch.py --one {worlds} failed:\n"
                             f"{proc.stdout}\n{proc.stderr}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    rates = [r["rate"] for r in runs]
    print(f"[W={worlds}] " + ", ".join(f"{r:.1f}" for r in rates)
          + f" env·steps/s over {len(rates)} fresh processes (route "
          f"{runs[0]['route']})", flush=True)
    return float(np.median(rates)), rates, runs[0]["route"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=128)
    ap.add_argument("--bodies", type=int, default=1000)
    ap.add_argument("--verts", type=int, default=50_000)
    ap.add_argument("--bones", type=int, default=100)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--processes", type=int, default=3)
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--one", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch.py needs a CUDA card")
    import fyrox_tpu_torch
    fyrox_tpu_torch.disable_tf32()
    if args.one is not None:
        return one(args, args.one)
    name = card()
    print(f"[card] {name}", flush=True)
    if args.scaling:
        table = {w: measure(args, w) for w in SCALING_WORLDS}
        print("[scaling] worlds: median env·steps/s")
        for w, (med, _, _) in table.items():
            print(f"[scaling] {w}: {med:.1f}")
        worlds = max(table, key=lambda w: table[w][0])
    else:
        worlds = args.worlds
        table = {worlds: measure(args, worlds)}
    value, rates, rt = table[worlds]
    print(json.dumps({
        "metric": f"env_steps_per_sec (W={worlds}, {args.bones} bones/"
                  f"{args.verts} verts skinned, {args.bodies}-body pile, "
                  f"Engine.rollout of {args.steps} ticks)",
        "value": round(value, 1), "unit": "env·steps/s", "route": rt,
        "card": name, "processes": rates}))


if __name__ == "__main__":
    main()
