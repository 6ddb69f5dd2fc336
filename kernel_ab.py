"""Times the K1, K4b, K3, K2 and K5 kernels of one tree of the PyTorch port
on one card.

    python3 kernel_ab.py [--root DIR] [--kernels NAME,...] [--tail]

Imports `fyrox_tpu_torch` and `chip_smoke.py` from DIR (default: the
directory of this script), builds that tree's kernels, and times, on the
inputs that chip_smoke.py's phases give them:
  solve_tgs          — K1 on the packed inputs of one step of the settled
                       flagship (W=128 distinct worlds, 30 ticks);
  solve_tgs_jointed  — K1 with joint tables and COM planes on one step of
                       the settled jointed flagship;
  plane_scatter      — K4b on a [128, 16, 1000] → 1000 per-world row
                       permutation made from a seed (the count-rank
                       rebuild's shape and kind);
  scatter_add_       — one scatter_add_ into a zeroed copy with a spare
                       column, the same function on the same inputs;
  fused_bp           — K3 on the body planes of the settled flagship's
                       next step (held to its plain version first:
                       windows equal as integers, collider planes
                       bit-equal);
  narrow_compact     — K2 on those windows (held to its plain version
                       first: pid, partner body and activity equal);
  tile_raster_full   — K5, full variant, on the camera pass of one frame
                       of chip_smoke.render_scene (W=16, 256 x 256), as
                       chip_smoke.capture_k5_inputs catches it;
  tile_raster_depth  — K5, depth-only, on that frame's cascade pass (both
                       held bit for bit to visibility_plain first; each
                       prints its slots per tile: mean, p99, max);
each by CUDA events around a run of calls (`ms`) and around the same
calls queued behind a spin kernel, which the card runs back to back
without the host's issue (`device_ms`), as chip_smoke.py's kernels line. K4b's output is held to its plain version bit for bit
first. Prints the card's name and power limit, then one JSON line.

To compare a parent commit with this one on the same card, unpack the
parent with `git archive` into a git-ignored directory and run both in one
session, alternating: parent, change, change, parent.

--tail asks, per K5 pass, whether its longest tiles set its time: the
device time of the same launch with every tile's count set to 0 (`empty`),
with only the longest tile's count kept (`longest`: that block's own walk),
with only the longest 1 % kept (`top1`), and with the longest 1 % set to 0
(`rest`: the kernel without its tail).
"""
import argparse
import json
import os
import subprocess
import sys


def cuda_ms(torch, fn, reps):
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


def device_ms(torch, fn, reps):
    """Mean milliseconds of the card per call of fn, without the host's
    issue (as chip_smoke.device_ms): CUDA events around reps calls queued
    behind a spin kernel, lengthened until the host has queued them all
    before it ends."""
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
            sys.exit("device_ms: the host could not queue the calls behind "
                     "a spin of 2^32 cycles")
        cycles <<= 2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--kernels", default="solve_tgs,solve_tgs_jointed,"
                    "plane_scatter,fused_bp,narrow_compact,"
                    "tile_raster_full,tile_raster_depth",
                    help="comma-separated names of the kernels to time "
                    "(plane_scatter brings scatter_add_)")
    ap.add_argument("--tail", action="store_true",
                    help="time each K5 pass with its tiles' counts cut "
                    "(see the module's doc)")
    args = ap.parse_args()
    names = set(args.kernels.split(","))
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_ab.py needs a CUDA card")
    import chip_smoke as cs
    import fyrox_tpu_torch
    from fyrox_tpu_torch.models import build_flagship
    from fyrox_tpu_torch.physics import fused_step, plane_ops, slab2, tgs_kernel
    if not fyrox_tpu_torch.__file__.startswith(root):
        sys.exit(f"fyrox_tpu_torch came from {fyrox_tpu_torch.__file__}, "
                 f"not from {root}")
    fyrox_tpu_torch.disable_tf32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    out = dict(root=root, card=card)

    def both(name, fn):
        out[name] = dict(ms=cuda_ms(torch, fn, args.reps),
                         device_ms=device_ms(torch, fn, args.reps))

    k5 = {"tile_raster_full": False, "tile_raster_depth": True}
    if names & set(k5):
        from fyrox_tpu_torch.render import tile_raster
        inputs = cs.capture_k5_inputs(*cs.render_scene(cs.RENDER_WORLDS,
                                                       "cuda"))
        for name, depth in k5.items():
            if name not in names:
                continue
            a = next(a for a, d in inputs if d == depth)
            got = tile_raster._visibility_cuda(*a, depth_only=depth)
            ref = tile_raster.visibility_plain(*a, depth_only=depth)
            got, ref = ((got,), (ref,)) if depth else (got, ref)
            if not all(torch.equal(x, y) for x, y in zip(got, ref)):
                sys.exit(f"{name} differs from its plain version")

            def launch(count, a=a, depth=depth):
                return tile_raster._visibility_cuda(
                    *a[:2], count, *a[3:], depth_only=depth)

            both(name, lambda: launch(a[2]))
            cnt = a[2].flatten().float()
            out[name]["slots_per_tile"] = dict(
                mean=float(cnt.mean()), p99=float(cnt.quantile(0.99)),
                max=int(cnt.max()), tiles=cnt.numel())
            del got, ref
            if args.tail:
                order = torch.argsort(a[2].flatten(), descending=True)
                top = order[:max(1, cnt.numel() // 100)]
                cuts = dict(empty=torch.zeros_like(a[2]),
                            longest=torch.zeros_like(a[2]),
                            top1=torch.zeros_like(a[2]),
                            rest=a[2].clone())
                cuts["longest"].view(-1)[order[0]] = a[2].view(-1)[order[0]]
                cuts["top1"].view(-1)[top] = a[2].view(-1)[top]
                cuts["rest"].view(-1)[top] = 0
                out[name]["tail_device_ms"] = {
                    k: device_ms(torch, lambda c=c: launch(c), args.reps)
                    for k, c in cuts.items()}
        del inputs
    if not names & {"solve_tgs", "solve_tgs_jointed", "plane_scatter",
                    "fused_bp", "narrow_compact"}:
        print(card)
        print(json.dumps(out), flush=True)
        return

    engine, _ = build_flagship(n_bones=100, n_verts=50_000, n_bodies=1000)
    state, accel, angvel, body, warm_lam, warm_pid = cs.settled_inputs(engine)
    t, dt = engine.physics, engine.dt
    if "solve_tgs" in names:
        packed, _ = slab2.solver_inputs(state.physics, t, dt, accel, angvel)
        params = tgs_kernel.solver_params(t, dt)
        both("solve_tgs", lambda: tgs_kernel.solve_tgs(*packed, params))
        del packed
    if "fused_bp" in names or "narrow_compact" in names:
        jv, col = fused_step.bp_candidates(t, body, dt)
        jv_p, col_p = fused_step.bp_candidates_plain(t, body, dt)
        if not (torch.equal(jv, jv_p) and torch.equal(col, col_p)):
            sys.exit("fused_bp differs from its plain version")
        got = fused_step.narrow_compact(t, col, jv, warm_lam, warm_pid)
        ref = fused_step.narrow_compact_plain(t, col, jv, warm_lam, warm_pid)
        if not (torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
                and torch.equal(got[0][:, 9], ref[0][:, 9])):
            sys.exit("narrow_compact differs from its plain version")
        del got, ref, jv_p, col_p
        if "fused_bp" in names:
            both("fused_bp", lambda: fused_step.bp_candidates(t, body, dt))
        if "narrow_compact" in names:
            both("narrow_compact", lambda: fused_step.narrow_compact(
                t, col, jv, warm_lam, warm_pid))
        del jv, col
    del engine, state, body, warm_lam, warm_pid

    if "solve_tgs_jointed" in names:
        engine = cs.jointed_engine()[0]
        packed, has_com, joints = cs.jointed_inputs(engine)
        params = tgs_kernel.solver_params(engine.physics, engine.dt)
        both("solve_tgs_jointed", lambda: tgs_kernel.solve_tgs(
            *packed, params, has_com=has_com, joints=joints))
        del engine, packed, joints
    if "plane_scatter" not in names:
        print(card)
        print(json.dumps(out), flush=True)
        return

    w, a, n = cs.WORLDS, 16, 1000
    rng = np.random.default_rng(0)
    vals = torch.as_tensor(rng.standard_normal((w, a, n)).astype(np.float32),
                           device="cuda")
    idx = torch.as_tensor(np.stack([rng.permutation(n) for _ in range(w)])
                          .astype(np.int32), device="cuda")
    got = plane_ops.plane_scatter(vals, idx, n)
    if not torch.equal(got, plane_ops.plane_scatter_plain(vals, idx, n)):
        sys.exit("plane_scatter differs from its plain version")
    lib_idx = idx.long()[:, None, :].expand(w, a, n)
    both("plane_scatter", lambda: plane_ops.plane_scatter(vals, idx, n))
    both("scatter_add_", lambda: torch.zeros(
        (w, a, n + 1), device="cuda").scatter_add_(2, lib_idx, vals))
    print(card)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
