"""The port's counterpart of bench_render.py: frames/s of the deferred +
CSM render of W worlds on one CUDA card, timed through the captured frame.

    python3 bench_render_torch.py [--worlds 16] [--size 256]

Workload (bench_render.py:31-72): a 40 m ground, 32 cubes and 32 spheres
placed by default_rng(0), a tilted directional light with a 3-cascade
CSM, the bench camera; W worlds at size x size, bin caps 424 (camera) /
896 (cascades), cascade budgets 0.05 / 1.0 / 0.75. Before timing, the
bin-demand audit (render_frame_demand on one world) refuses to time when
any pass's demand reaches its cap, as bench_render.py does: binning
would have dropped triangles. A timed frame is one call of
render.CapturedFrame (the state copied into one captured CUDA graph of
render_frame, replayed, its outputs cloned out; the JAX package's
jax.jit of render_frame) followed by torch.cuda.synchronize(); a process
reports the median of its frames after a warm-up call that captures.
Each measurement runs in a fresh process, three of them, and the value
is their median. The same process also times the eager render_frame,
for comparison. Prints one JSON line last: frames/s, ms a frame a world,
the eager frames/s and the card's name and power limit (nvidia-smi).
Needs one CUDA card; there is no CPU mode.
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

PROCESSES = 3
FRAMES = 30          # timed frames a process, after one warm-up call
CAPS = dict(k_per_tile=424, csm_k_per_tile=896)
BUDGETS = (0.05, 1.0, 0.75)


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bench_scene(worlds, size, device="cuda"):
    """(scene template, render template, state, config) of bench_render's
    workload, built with the port's builders."""
    from fyrox_tpu_torch.render import (RenderConfig, build_render_template,
                                        make_cube, make_plane, make_sphere)
    from fyrox_tpu_torch.scene import SceneBuilder, graph, init_state
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
    st = graph.update_hierarchical_data(init_state(t, worlds, device=device),
                                        t)
    cfg = RenderConfig(width=size, height=size, shadows=True,
                       cascade_tri_budget=BUDGETS, **CAPS)
    return t, build_render_template(t), st, cfg


def audit(t, rt, st, cfg):
    """Per-pass bin demand of one world against the caps; exits non-zero
    where a pass reaches its cap (the frame would drop triangles)."""
    from fyrox_tpu_torch.render import render_frame_demand
    one = type(st)(*(x[:1] if isinstance(x, torch.Tensor) else x
                     for x in st))
    _, demand, caps = render_frame_demand(one, t, rt, cfg)
    dmax = [int(d) for d in demand.max(0).values.tolist()]
    print(json.dumps({"bin_demand_max": dmax, "bin_caps": caps}),
          flush=True)
    over = [(p, d, k) for p, (d, k) in enumerate(zip(dmax, caps)) if d >= k]
    if over:
        raise SystemExit(f"bin overflow: (pass, demand, cap) {over}; the "
                         "run is invalid and is not timed")


def frame_times(fn, frames):
    """Seconds of each of `frames` synchronised calls, after one warm-up
    call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(frames):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def one(args):
    """One fresh process's measurement."""
    from fyrox_tpu_torch.render import CapturedFrame, render_frame
    t, rt, st, cfg = bench_scene(args.worlds, args.size)
    audit(t, rt, st, cfg)
    frame = CapturedFrame(t, rt, cfg)
    t0 = time.perf_counter()
    color, gbuf = frame(st)                     # captures
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    want, _ = render_frame(st, t, rt, cfg)
    if not torch.equal(color, want):
        raise SystemExit("the captured frame differs from render_frame")
    cover = float(gbuf.mask.float().mean())
    if not (bool(torch.isfinite(color).all()) and cover > 0.1):
        raise SystemExit(f"empty or non-finite frame (coverage {cover})")
    captured = float(np.median(frame_times(lambda: frame(st), FRAMES)))
    eager = float(np.median(frame_times(
        lambda: render_frame(st, t, rt, cfg), FRAMES)))
    fg = frame.graph(st)
    print(json.dumps({"rate": args.worlds / captured,
                      "eager_rate": args.worlds / eager,
                      "capture_seconds": fg.capture_seconds,
                      "pool_bytes": fg.pool_bytes,
                      "warmup_seconds": setup}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=16)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_render_torch.py needs a CUDA card")
    import fyrox_tpu_torch
    fyrox_tpu_torch.disable_tf32()
    if args.one:
        return one(args)
    name = card()
    print(f"[card] {name}", flush=True)
    runs = []
    for _ in range(PROCESSES):
        proc = subprocess.run([sys.executable, __file__, "--one",
                               f"--worlds={args.worlds}",
                               f"--size={args.size}"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"bench_render_torch.py --one failed:\n"
                             f"{proc.stdout}\n{proc.stderr}")
        lines = proc.stdout.strip().splitlines()
        print(lines[0], flush=True)                   # the audit
        runs.append(json.loads(lines[-1]))
    rates = [r["rate"] for r in runs]
    eager = [r["eager_rate"] for r in runs]
    value = float(np.median(rates))
    capture = ", ".join(f"{r['capture_seconds']:.3f}" for r in runs)
    print(f"[frames/s] captured {', '.join(f'{r:.1f}' for r in rates)}; "
          f"eager {', '.join(f'{r:.1f}' for r in eager)} over {PROCESSES} "
          f"fresh processes; capture {capture} s, graph pool "
          f"{runs[0]['pool_bytes'] / 2**20:.1f} MiB", flush=True)
    print(json.dumps({
        "metric": f"deferred+CSM frames/s (W={args.worlds}, {args.size}x"
                  f"{args.size}, 65 meshes, dir light 3-cascade CSM, "
                  "CapturedFrame replays)",
        "value": round(value, 1), "unit": "frames/s",
        "ms_per_frame_per_world": round(1e3 / value, 4),
        "eager_frames_per_sec": round(float(np.median(eager)), 1),
        "card": name, "processes": rates}))


if __name__ == "__main__":
    main()
