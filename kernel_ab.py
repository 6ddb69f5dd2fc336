"""Times the K1, K4b, K3 and K2 kernels of one tree of the PyTorch port on
one card.

    python3 kernel_ab.py [--root DIR] [--kernels NAME,...]

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
each by CUDA events around a run of calls (`ms`) and around the same
calls queued behind a spin kernel, which the card runs back to back
without the host's issue (`device_ms`), as chip_smoke.py's kernels line. K4b's output is held to its plain version bit for bit
first. Prints the card's name and power limit, then one JSON line.

To compare a parent commit with this one on the same card, unpack the
parent with `git archive` into a git-ignored directory and run both in one
session, alternating: parent, change, change, parent.
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
                    "plane_scatter,fused_bp,narrow_compact",
                    help="comma-separated names of the kernels to time "
                    "(plane_scatter brings scatter_add_)")
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
