"""Times the K1, K4a, K4b, K3, K2 and K5 kernels of one tree of the PyTorch
port on one card.

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
  plane_gather,      — K4a on the calls one tick of each caller makes, caught
  gather_rows          at the tree's own entry points (plane_gather and
                       gather_rows, wherever a module holds them) and timed
                       as the path makes them (a parent's gather_rows is its
                       transpose copy and plane-form launch): k4a_staged
                       (the flagship on the staged route, 10 ticks settled),
                       k4a_dense (build_flagship(), 20 ticks), k4a_pile
                       (the terrain pile, dense, 20 ticks), k4a_grid
                       (chip_smoke.grid_engine(), 10 ticks), k4a_heights and
                       k4a_hulls (the terrain flagship's shared tables, 10
                       ticks); each also gives host µs a call (a host clock
                       around unsynchronised calls, as chip_smoke.host_us)
                       and torch.gather on the same inputs and layout, and
                       k4a_dense and k4a_grid the replayed tick's device
                       events and device ms (profiler, chip_smoke.profiled);
each by CUDA events around a run of calls (`ms`) and around the same
calls queued behind a spin kernel, which the card runs back to back
without the host's issue (`device_ms`), as chip_smoke.py's kernels line. K4a's and K4b's outputs are held to their plain versions bit
for bit first. Prints the card's name and power limit, then one JSON line.

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
import time


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


def host_us(torch, fn, calls=1000, group=250):
    """Host microseconds a call of fn: a host clock around groups of
    `group` unsynchronised calls, synchronised between groups."""
    fn()
    total = 0.0
    for _ in range(calls // group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(group):
            fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total * 1e6 / (calls // group * group)


def catch_k4a(step):
    """The K4a calls step() makes, as (entry point, args): every module of
    the tree that holds plane_ops.plane_gather or plane_ops.gather_rows
    gets a spy for the call; a call made inside another (a parent's
    gather_rows calls plane_gather) or asking for the plain version is not
    caught."""
    from fyrox_tpu_torch.physics import plane_ops
    targets = {n: getattr(plane_ops, n) for n in ("plane_gather",
                                                    "gather_rows")}
    calls, depth, patched = [], [0], []

    def spy_of(name, orig):
        def spy(*a, **kw):
            if depth[0] == 0 and not kw.get("plain"):
                calls.append((name, a, kw))
            depth[0] += 1
            try:
                return orig(*a, **kw)
            finally:
                depth[0] -= 1
        return spy

    spies = {n: spy_of(n, f) for n, f in targets.items()}
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("fyrox_tpu_torch"):
            for n, f in targets.items():
                if getattr(mod, n, None) is f:
                    setattr(mod, n, spies[n])
                    patched.append((mod, n, f))
    try:
        step()
    finally:
        for mod, n, f in patched:
            setattr(mod, n, f)
    return [(targets[n], n, a, kw) for n, a, kw in calls]


def gather_yardstick(torch, name, table, idx):
    """torch.gather of the K4a call's function on the same layout: the
    table broadcast over the worlds, a zero row or column appended where
    an index is out of range (set-up)."""
    w, k = idx.shape
    dim = 2 if name == "plane_gather" else 1
    n = table.shape[dim]
    ok = (idx >= 0) & (idx < n)
    if not bool(ok.all()):
        pad = list(table.shape)
        pad[dim] = 1
        table = torch.cat([table, table.new_zeros(pad)], dim)
        idx = torch.where(ok, idx, torch.full_like(idx, n))
    table = table.expand(w, -1, -1)
    li = idx.long()
    li = (li[:, None, :].expand(w, table.shape[1], k) if dim == 2
          else li[..., None].expand(w, k, table.shape[2]))
    return table, dim, li


def k4a_sets(cs, build_flagship, torch):
    """(set name, engine, calls) of each K4a caller, one at a time."""
    def settled(engine, ticks, seed, **kw):
        state = cs.distinct_worlds(engine, cs.WORLDS, "cuda", seed=seed)
        for _ in range(ticks):
            state = engine.step(state, **kw)
        torch.cuda.synchronize()
        return state

    engine, _ = build_flagship(n_bones=100, n_verts=50_000, n_bodies=1000)
    state = settled(engine, 10, 2)
    yield "k4a_staged", engine, state, catch_k4a(
        lambda: engine.step(state, fused=False))
    engine, _ = build_flagship()
    state = settled(engine, 20, 23)
    yield "k4a_dense", engine, state, catch_k4a(lambda: engine.step(state))
    engine, _ = cs.terrain_engine(cs.TERRAIN_PILE, broadphase="dense")
    state = settled(engine, 20, 23)
    yield "k4a_pile", engine, state, catch_k4a(lambda: engine.step(state))
    engine, _ = cs.grid_engine()
    state = settled(engine, 10, 23)
    yield "k4a_grid", engine, state, catch_k4a(lambda: engine.step(state))
    engine, _ = cs.terrain_engine(cs.TERRAIN_FLAGSHIP, **cs.TERRAIN_BUILD)
    state = settled(engine, 10, 31)
    calls = catch_k4a(lambda: engine.step(state))
    shared = [c for c in calls if c[2][0].shape[0] == 1]
    yield "k4a_heights", engine, state, [
        c for c in shared if c[1] == "plane_gather" and c[2][0].shape[1] == 4]
    yield "k4a_hulls", engine, state, [
        c for c in shared if not (c[1] == "plane_gather"
                                  and c[2][0].shape[1] == 4)]


def host_breakdown(torch, plane_ops):
    """Host µs a call of each step of a planar gather_rows at the dense
    solver's widest shape (x [128, 65, 20], idx [128, 7,328]): the checks,
    the output's allocation, the ctypes call with its launch, the whole
    call; and torch.gather with its allocation, for a tree whose
    plane_ops resolves its C entry points once (_c_fn)."""
    x = torch.randn((128, 65, 20), device="cuda")
    idx = torch.randint(0, 65, (128, 7328), device="cuda", dtype=torch.int32)
    out = x.new_empty((128, 20, 7328))
    fn = plane_ops._c_fn("plane_gather")
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), idx.data_ptr(), out.data_ptr(), 128, 20, 65, 7328,
            65 * 20, 1, 0, stream)
    li = idx.long()[..., None].expand(128, 7328, 20)
    steps = dict(
        checks=lambda: plane_ops._check("gather_rows", x, idx, "x", True,
                                        plane_ops._GATHER_IDX),
        new_empty=lambda: x.new_empty((128, 20, 7328)),
        ctypes_launch=lambda: fn(*args),
        gather_rows=lambda: plane_ops.gather_rows(x, idx, planar=True),
        torch_gather=lambda: torch.gather(x, 1, li))
    return {k: host_us(torch, f) for k, f in steps.items()}


def time_k4a(cs, build_flagship, torch, out, reps):
    """Each K4a caller's set of calls, bit-equal to the plain versions
    (gather_rows_plain where the tree has it, else torch.gather) and timed
    as it was made: ms, device_ms, host µs a call, torch.gather's ms and
    device ms on the same inputs; the dense and grid ticks replayed under
    the profiler."""
    for name, engine, state, calls in k4a_sets(cs, build_flagship, torch):
        if not calls:
            sys.exit(f"{name}: no K4a call caught")
        lib = [gather_yardstick(torch, n, *a) for _, n, a, _ in calls]
        for (fn, n, a, kw), y in zip(calls, lib):
            got = fn(*a, **kw)
            want = torch.gather(*y)
            if n == "gather_rows" and got.shape != want.shape:
                sys.exit(f"{name}: gather_rows gave {tuple(got.shape)}")
            if not (torch.equal(got, fn(*a, **kw)) and torch.equal(got, want)):
                sys.exit(f"{name}: {n} differs from torch.gather or itself")

        def run():
            return [fn(*a, **kw) for fn, _, a, kw in calls]

        def run_lib():
            return [torch.gather(*y) for y in lib]

        # at most ~600 launches behind device_ms's spin and ~500 in a group
        # of host_us's unsynchronised calls (a parent's gather_rows makes
        # two: the copy and the launch)
        sub = max(1, min(reps, 300 // len(calls)))
        group = max(1, 250 // len(calls))
        out[name] = dict(
            calls=len(calls),
            forms=sorted({(n, tuple(a[0].shape), tuple(a[1].shape),
                           str(a[1].dtype)[6:], a[0].is_contiguous(),
                           bool(kw.get("planar"))) for _, n, a, kw in calls}),
            ms=cuda_ms(torch, run, reps), device_ms=device_ms(torch, run, sub),
            host_us_per_call=host_us(torch, run, 4 * group, group) / len(
                calls),
            torch_gather_ms=cuda_ms(torch, run_lib, reps),
            torch_gather_device_ms=device_ms(torch, run_lib, sub),
            torch_gather_host_us_per_call=host_us(
                torch, run_lib, 4 * group, group) / len(calls),
            device_ms_each=[round(device_ms(
                torch, lambda c=c: c[0](*c[2], **c[3]), reps), 5)
                for c in calls[:8]])
        if name in ("k4a_dense", "k4a_grid", "k4a_hulls"):
            ticks = 1 if name == "k4a_hulls" else 3
            rolled = engine.rollout(state, 2)
            torch.cuda.synchronize()
            n_prof, events, dev = cs.profiled(
                lambda: engine.rollout(rolled, ticks), ticks, name)
            out[name]["replayed_tick"] = dict(kernels=n_prof, events=events,
                                              device_ms=dev)
        print(name, json.dumps(out[name]), flush=True)
        del engine, state, calls, lib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--kernels", default="solve_tgs,solve_tgs_jointed,"
                    "plane_scatter,fused_bp,narrow_compact,"
                    "tile_raster_full,tile_raster_depth",
                    help="comma-separated names of the kernels to time "
                    "(plane_scatter brings scatter_add_; plane_gather or "
                    "gather_rows brings every K4a caller's set)")
    ap.add_argument("--rows-out", choices=("path", "rows", "planar"),
                    default="path", help="K4a: the output layout of every "
                    "gather_rows call (a tree whose gather_rows takes "
                    "`planar`): as the path asks, contiguous rows, or "
                    "attribute-major")
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
    if args.rows_out != "path":
        path_rows = plane_ops.gather_rows

        def forced_rows(x, idx, plain=False, planar=False):
            return path_rows(x, idx, plain=plain,
                             planar=args.rows_out == "planar")

        plane_ops.gather_rows = forced_rows
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    out = dict(root=root, card=card,
               rows_out=args.rows_out)

    def both(name, fn):
        out[name] = dict(ms=cuda_ms(torch, fn, args.reps),
                         device_ms=device_ms(torch, fn, args.reps))

    if names & {"plane_gather", "gather_rows"}:
        if hasattr(plane_ops, "_c_fn"):
            out["k4a_host_us"] = host_breakdown(torch, plane_ops)
            print("k4a_host_us", json.dumps(out["k4a_host_us"]), flush=True)
        time_k4a(cs, build_flagship, torch, out, args.reps)
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
