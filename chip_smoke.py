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
             share;
  rollout  — Engine.rollout (one captured CUDA graph of the tick, replayed):
             TICKS replayed ticks equal TICKS eager ticks bit for bit from
             distinct worlds; K3, K2 and K1 once a tick in a replayed roll
             (the profiler's kernel names: the wrappers' counters do not see
             replays); env·steps/s with skinning of eager and of captured
             rolls in turns, device events per replayed tick, its device time
             and copy-back, the busy share, the capture's seconds and the
             graph pool's size;
  health   — world_health and restore_unhealthy on the rolled state with a
             NaN injected into one world.
Then the animation breadth and the real-asset flagship:
  anim-small — W=4, the card against the CPU from the same state: ANIM_TICKS
             ticks of the plain AnimationPlayer, of a machine with a
             blend-space state and of a layered machine (bone mask, float
             weight and sampling-point parameters), gather skinning (and
             against dense on the card), blend shapes and sprite frames;
             a root-motion walker with a particle emitter through
             Engine.step (the body driven by the root delta); its replayed
             roll equals its eager ticks bit for bit, and a replay draws
             from the counter in the graph's buffer;
  real-asset — build_flagship(n_bodies=1000, real_asset=
             make_character_fbx(100, 50,000)) on the plain player: the
             write and import seconds, W distinct worlds, TICKS eager ticks
             with the launches counted (K3, K2, K1 once a tick), TICKS
             replayed ticks equal to them bit for bit, world_health, the
             mesh at bind pose before and moved after; a replayed roll's
             kernels, device events and device ms; env·steps/s with
             skinning, eager and through rollout in turns; the peak memory
             of an eager tick and of a replayed roll.
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
             rebuild); then the host's rebuild read, timed;
  rollout-reuse — Engine.rollout at period 4 steps eagerly (no capture) and
             equals ROLL_REUSE Engine.step ticks bit for bit.
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
             within reach of its anchor;
  rollout-jointed — ROLL_JOINTED replayed ticks equal eager ticks bit for
             bit; K1 once and K4a once per gather a tick in a replayed roll.
Then the flagship with a 2,000-body pile (past one block's shared memory):
  K1big    — W distinct worlds, 30 settling ticks, then BIG_TICKS fused ticks
             with the launches counted (fused_bp, narrow_compact, solve_tgs
             one each a tick); on the next step fused_bp and narrow_compact
             with K3bp's and K2nc's checks (2,000 grid colliders), and K1's
             global-memory variant vs its plain version, at K1's bounds,
             two launches bit-equal, timed against its bound.
Then the chain forest (256 hanging chains, 1,024 joints, COM offsets):
  K1joint-many — W distinct worlds, 30 settling ticks, MANY_TICKS staged
             ticks with the launches counted; K1 with its joint tables in
             global memory vs its plain version on the next step, at
             K1joint's bounds, two launches bit-equal, timed against its
             bound.
Then the dense broadphase path (every scene under 192 colliders):
  dense-small — tests/test_oracle.py's mixed cluster and a 4-limb ragdoll
             (3 ball joints), card vs CPU over 20 ticks (W=4), dp < 5e-4,
             dv < 5e-3; K4a and K4b launched dense_launches(t) times a
             tick;
  dense    — build_flagship() with its defaults (100 bones, 50,000
             vertices, 64 bodies: 2,080 pairs, 3,664 contact slots), W
             distinct worlds: TICKS eager Engine.step ticks with the
             launches counted (K4a 13 and K4b 14 a tick, nothing else);
             TICKS replayed ticks equal them bit for bit; a replayed roll's
             kernels, device events and device ms (profiler); env·steps/s
             with skinning of eager and captured rolls in turns;
  dense-K4 — K4a and K4b on one settled dense tick's calls (idx [W,
             7,328], 65 body rows): bit-equal to their plain versions (the
             scatter's on CPU copies, whose sums run in ascending k as the
             kernel's do), two launches bit-equal, the tick's set timed
             against its bound, its plain version and torch.gather /
             scatter_add_;
  health   — world_health and restore_unhealthy on the rolled dense state.
Then hulls, scenery and queries (chip_smoke.terrain_pile):
  terrain-small — a 16-body pile of cylinders, hull clouds, cones, balls
             and cuboids over a 9 x 9 heightfield and a 4-triangle trimesh
             ramp, on the dense and on the slab broadphase: each of 30 card
             ticks against the same tick on the CPU (W=4), at card_vs_cpu's
             bounds (the scene's trajectories part at the rounding level,
             so whole trajectories are not compared); launches a tick;
  terrain  — the terrain flagship (the flagship's character and 1,000-body
             pile over a 129 x 129 heightfield, 64 m square, every 8th body
             a 12-point hull cloud, every 8th + 4 a cylinder; slab windows
             32 / 20 / 20, walk 128, 48 active points, as build()
             arguments), W distinct
             worlds, staged route: TICKS eager ticks with the launches
             counted (K1 once a tick, K4a by kind: heights, hull rows,
             per-world planes); one tick under sync debug mode "error";
             the tick's peak memory; TICKS replayed ticks equal the eager
             ones bit for bit; a replayed roll's kernels, device events,
             device ms and busy share; env·steps/s with skinning of eager
             and captured rolls; K1 (COM planes) on the settled step's
             packed inputs vs its plain version; K4a at the heights and
             hull-row shapes (one table every world reads) bit-equal to
             plain, timed against torch.gather; the broadphase audit,
             equal card vs CPU on 2 worlds;
  queries  — cast_ray (16 x 16 fan a world) and sphere_cast (8 x 8,
             radius 0.1) on the settled terrain flagship: ms a call; hits,
             colliders and bodies equal card vs CPU on 8 worlds;
  terrain-dense — the terrain pile (build_flagship()'s 64-body pile over a
             33 x 33 heightfield and the ramp, cylinders, hull clouds and
             cones; dense) through the dense phase's checks, one tick under
             sync debug mode, the tick's peak memory, and K4a / K4b on one
             settled tick's calls against their plain versions.
Then the render path (bench_render.py's scene and config, W=16 at 256x256,
worlds made distinct by seeded jitter of the mesh nodes):
  K5full   — the tile raster kernel, full variant, vs its plain version on
             every camera-pass call of one frame and on the knife-edge inputs
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
Then the features frame (features_scene: the bench scene + textured ground
and cubes, a spot and a point light with shadow maps, HZB occlusion, 4
transparent panes, 16 sprites, 2 decals, a LOD group, 2 rectangles, light
shafts and a skybox; W=16 at 256x256, caps FEATURES_CAPS):
  render-features-small — W=2 at 32x32: each feature alone and all
             together in both raster modes, card vs CPU from the same state
             (99.9 % of the colours within 1e-4, all within 2e-3; caps
             equal);
  K5 features frame — every K5 call of the homogeneous frame (the
             camera pass, the 64x64 occlusion prepass, the cascades, the
             128x128 spot map and the 6 x 64x64 point faces, each one
             launch over every world) launched twice and held bit for bit
             against visibility_plain at its own shape;
  K5clip   — K5's affine variant, full on the clipped frame's camera pass
             and depth-only on its occlusion prepass (2T clipped rows),
             and on the affine knife-edge inputs (k5_knife_edges_affine):
             bit-equal to visibility_plain(affine=True), two launches
             bit-equal, timed against its bound (the bytes of an affine
             row's 10 columns); the clipped frame's 2DH map launches are
             held as the homogeneous frame's;
  render-features — the full-width frame in each raster mode: the
             bin-demand audit of its 12 passes (fails at demand >= cap),
             RENDER_FRAMES timed frames after a warm-up with K5's launches
             per frame by variant (homogeneous: full 1, depth 4; clipped:
             full_affine 1, depth_affine 1, depth 3), frames/s, and the
             profiler's device events, device ms and busy share.
  render-captured — render.CapturedFrame (one CUDA graph a frame) on the
             bench frame and the features frame in both raster modes, W
             worlds: K5 counted at its warm-up and capture (2 x a frame's
             launches), replays equal eager render_frame bit for bit
             (colour and every G-buffer field) from that state and from
             another; a replayed frame's device events, device ms and K5
             launches by variant (profiler); frames/s of replays against
             eager frames in turns; the capture's seconds and graph pool;
             then the bench frame's graph freed and captured again while
             the others live, every graph replaying bit-equal to eager, and
             each graph owning a K5 scratch no other holds;
  render-extras-small — the streaming rasterizer (both cull modes, near
             clip), a probe capture with its irradiance, ambient, prefilter
             and specular terms, post_process (bloom, LUT, FXAA) and SSAO,
             card vs CPU on seeded inputs;
  unbinned — slab and grid builds of scenes no collider of which can
             enter their broadphase (a halfspace under bodies with no
             collider, and no collider at all): the dense pairs, 20 ticks
             card vs CPU.
Then the audio mixer, the grid broadphase and the terrain brush:
  audio-small — the small flagship with audio (8 bones, 4 bodies, W=4,
             the character's root moved per world): 20 ticks each
             followed by render_audio(128), card vs CPU from the same
             state, blocks within 1e-5, playheads and `playing` equal;
  audio    — build_flagship(100, 50,000, 1,000, with_audio=True), W
             worlds: TICKS eager ticks (K3, K2, K1 once a tick, the audio
             state carried unchanged), TICKS replayed ticks equal them bit
             for bit, a replayed roll's kernels by name, device events and
             device ms; env·steps/s through rollout; render_audio(513): ms,
             device ms, device events and blocks/s; the blocks finite and
             panned to the source's side;
  bus-binaural — bus.process (a low-pass + reverb child bus under the
             primary) over 3 blocks and render_block_binaural (model and a
             measured ring), card vs CPU within 1e-5; the bus loop's ms a
             513-sample block;
  grid-small — a 64-body grid pile and a jointed stack (grid_pile,
             jointed_stack) on broadphase="grid", W=4: each of 20 card
             ticks against the same tick on the CPU from the card's state;
             K4a and K4b grid_launches(t) times a tick;
  grid     — the flagship's character and 1,000-body pile on the grid
             broadphase (grid_engine), W worlds: the demand against every
             cap and window with its drops, TICKS eager ticks (K4a and K4b
             grid_launches(t) a tick, nothing else), TICKS replayed ticks
             equal them bit for bit, a replayed roll's kernels, device
             events and device ms, env·steps/s with skinning, the tick's
             peak memory; then the tick's K4a and K4b calls bit-equal to
             their plain versions and timed (hold_k4: the
             plane_gather_grid and plane_scatter_grid records);
  brush    — apply_stroke in each mode and shape on a 257² map, card vs
             CPU within 1e-5, and add_chunked_terrain's 16-chunk scene
             rendered card vs CPU.
Then the game loop (script.Executor with scripts, a HUD over the captured
frame, checkpoints, debug_step, pathfinding and the lightmap bake):
  game     — game_engine() (build_flagship(n_bodies=1000) + a navmesh
             floor), W distinct worlds: GAME_TICKS Executor ticks (the
             fused tick captured, K3 / K2 / K1 counted at its warm-up and
             capture) with a flying camera, a nav agent steering one pile
             body, a behavior tree and per-tick PerformanceStatistics,
             equal bit for bit to the same script calls and eager ticks by
             hand; a run saved at tick GAME_SAVE_AT, loaded into a fresh
             state and resumed equals the whole run; debug_step finds
             nothing on its state and names "nan" and the physics stage
             for a NaN velocity; ms a tick, env·steps/s, a tick's device
             events and kernels (profiler), the checked tick against a
             plain eager tick;
  game_frame — examples/example_game.py's game (24 dense crates, a
             checkered ground, the crate hum) at FRAME_WORLDS worlds:
             FRAME_TICKS Executor ticks, render_audio(256) a tick and in
             on_frame a 128² shadowed CapturedFrame with the HUD (an
             energy bar and a 4-digit step counter) composed over it;
             K4a, K4b and K5 counted; the bin-demand audit; a W=2 run held
             tick by tick against the CPU (dense bounds) and its frames at
             FRAME_KEEP against the CPU's; frames/s of the whole loop;
  ui       — examples/example_hud.py's scene (hud_scene) through
             render.CapturedFrame at UI_WORLDS worlds moved apart, UI_SIZE²,
             under hud_ui's 30-widget tree (the example's window, stack and
             bars, a grid, a wrap panel, a scroll viewer over a text block,
             a text box, a progress bar bound to the tick) in write_ttf's
             TrueType font: UI_TICKS ticks of a replayed frame, one scripted
             OS event to InputState and the UI (hud_event, ui_event), update
             / layout / draw, render_ui through a FontAtlas and compose_over
             on the card, each tick's composed frames equal bit for bit to
             the CPU's compose_over of the frames copied to the CPU; text
             rects inked, 5x7 and TrueType images unlike; host ms of layout,
             draw and render_ui a tick, the atlas build, compose_over's
             device ms, frames/s of the loop with the UI and without it;
  navfield — distance_field on a walled 256² grid graph, 128 sources, as
             many rounds as its longest shortest path: equal to a host BFS
             for every source and to host A* for 8; ms a call;
  lightmap — bake_vertex_ao (32 rays) and bake_direct_light over the
             bench scene (T = 4,482): card vs CPU on 256 vertices, ms and
             vertices/s.
Then the content path (files written to a temporary directory, read back
through one ResourceManager, then stepped, rendered and edited):
  assets   — a .glb of the flagship's character (100 bones, 50,000
             vertices, 4 influences, its walk clip as quaternion rotation
             and translation channels), a 64-node .rgs in Fyrox's graph
             layout and a .wav hum, requested (the .glb twice: the same
             Resource) and loaded; the imported flagship (the pile, slab,
             the hum on bone 0) at W distinct worlds: TICKS eager ticks
             with the launches counted (K3, K2, K1 once a tick), TICKS
             replayed ticks equal to them bit for bit, world_health, K3 /
             K2 / K1 once a replayed tick by the profiler, device events
             and ms, env·steps/s with skinning, W=2 card vs CPU over TICKS
             ticks at card_vs_cpu's bounds; an EditorSession over it at
             W=1 (translate, undo, redo, play EDITOR_PLAY s, stop: the
             snapshot and undo after play equal the states taken before,
             bit for bit); the .rgs scene's update_hierarchical_data at W
             card == CPU bit for bit, inspect_scene and diff_scenes (a
             moved node counts 1); a 24 x 96 autotiled tilemap level with
             64 dim2 balls (dense: K4a and K4b dense_launches(t) a tick, a
             replayed roll equal to eager and counted by the profiler,
             env·steps/s) and its CapturedFrame at W=16, 256² with CSM (K5
             full and depth counted at the capture and on a replay, the
             bin audit under LEVEL_CAPS, frames/s).
Then one JSON line describing the kernels, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}. Each kernel's `ms` (and
`plain_ms`, `library_ms`) is CUDA-event time over a run of calls, which
counts the host's issue between launches where a launch is shorter than its
issue; `device_ms` (and `library_device_ms`) is CUDA-event time over the
same calls queued behind a spin kernel, which the card runs back to back.
"""
import collections
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
ROLL_JOINTED = 10   # jointed-flagship ticks, eager vs replayed
PROFILED_JOINTED = 2    # replayed jointed ticks under the profiler
ROLL_REUSE = 5      # reuse-flagship ticks, eager vs rollout
CARD = ""
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


def log(msg):
    print(msg, flush=True)


def fail(msg):
    """Print the miss on standard output and standard error (a caller that
    keeps only the end of one stream still sees it), then exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
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


# The chain forest: CHAINS_MANY of the jointed flagship's hanging 4-link
# chains (COM offsets) over a halfspace, 1,024 distinct joints: past the
# 128 joints of the TPU kernel and, at B = 1,281, past what fits in one
# block's shared memory beside the body planes, so K1 keeps its joint tables
# in global memory. The chains hang 1.5 m apart in x (their swings cross)
# and 0.35 m in z, within 6.6 m of the origin as the jointed flagship's
# are: the joint bias turns a position's float32 rounding into velocity,
# so farther bodies would part float32 solves by more. (Repeating a joint
# table on the same bodies instead would apply each joint's Jacobi impulse
# once per copy, and the solve diverges.)
CHAINS_MANY = 256


def chain_forest(lib, n_chains=CHAINS_MANY, cols=8):
    """Hanging chains (add_chain) on a grid of `cols` columns over a
    halfspace, at the jointed flagship's slab settings."""
    pb = lib.PhysicsBuilder()
    g = pb.add_body(body_type=lib.BodyType.STATIC)
    pb.add_collider(g, lib.HALFSPACE, [], friction=0.6)
    k = lib.JointKind
    rows = -(-n_chains // cols)
    for c in range(n_chains):
        base = (1.5 * (c % cols - (cols - 1) / 2), 2.4,
                0.35 * (c // cols - (rows - 1) / 2))
        add_chain(lib, pb, base, [k.REVOLUTE, k.BALL, k.REVOLUTE, k.BALL])
    return pb, pb.build(broadphase="slab", slab_window=(12, 8, 10),
                        slab_active=16, slab_walk=48)


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


def k1_against_plain(label, packed, params, has_com=False):
    """K1 (no joints; COM planes where `has_com`) vs its plain version on
    packed inputs: K1's bounds, two launches bit-equal, the kernel's
    visited slots equal to the inputs' live slots; then kernel and plain
    timed against the bound. Returns (max error, the errors as text,
    kernel ms, kernel device ms, plain ms, bound ms, bound by, visited
    slots per world)."""
    from fyrox_tpu_torch.physics import tgs_kernel
    kw = dict(has_com=has_com)
    got_b, got_l = tgs_kernel.solve_tgs(*packed, params, **kw)
    visited = tgs_kernel.visited_slots().clone()
    again_b, again_l = tgs_kernel.solve_tgs(*packed, params, **kw)
    ref_b, ref_l = tgs_kernel.solve_tgs_plain(*packed, params, **kw)
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
    ms_k = cuda_ms(lambda: tgs_kernel.solve_tgs(*packed, params, **kw), 10)
    dev_k = device_ms(lambda: tgs_kernel.solve_tgs(*packed, params, **kw),
                      10)
    # the same launch without substeps and stabilisation passes: the prep
    # (list build, effective masses), the restitution pass and the output
    lean = params._replace(n_sub=0, n_stab=0)
    ms_prep = cuda_ms(lambda: tgs_kernel.solve_tgs(*packed, lean, **kw), 10)
    ms_p = cuda_ms(lambda: tgs_kernel.solve_tgs_plain(*packed, params, **kw),
                   3)
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
    # the dense layout keeps every pair in its slots: its live ones hold
    # a normal impulse
    live = int((cpu.warm_pair >= 0).sum() if t.grid is not None
               else (cpu.warm_n > 0).sum())
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
    # the dense layout keeps every pair in its slots: its live ones hold
    # a normal impulse
    live = int((cpu.warm_pair >= 0).sum() if t.grid is not None
               else (cpu.warm_n > 0).sum())
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


def k1_joint_against_plain(label, packed, params, joints):
    """K1 with joint tables and COM planes vs its plain version on packed
    inputs: two launches bit-equal, K1's position, quaternion and lambda
    bounds, velocities within 3e-4 and no farther from a float64 solve than
    the plain float32 one; then timed against its bound. Returns (the
    errors and times as text, the kernels-line record without name)."""
    from fyrox_tpu_torch.physics import tgs_kernel
    kw = dict(has_com=True, joints=joints)
    got_b, got_l = tgs_kernel.solve_tgs(*packed, params, **kw)
    again_b, again_l = tgs_kernel.solve_tgs(*packed, params, **kw)
    ref_b, ref_l = tgs_kernel.solve_tgs_plain(*packed, params, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(got_b, again_b) and torch.equal(got_l, again_l)):
        fail(f"{label}: two launches on the same inputs differ")
    if not (torch.isfinite(got_b).all() and torch.isfinite(got_l).all()):
        fail(f"{label}: solve_tgs produced non-finite values")
    err_pos = (got_b[:, 6:9] - ref_b[:, 6:9]).abs().max().item()
    err_vel = (got_b[:, 0:6] - ref_b[:, 0:6]).abs().max().item()
    err_q = (got_b[:, 9:13] - ref_b[:, 9:13]).abs().max().item()
    err_lam = (got_l - ref_l).abs().max().item()
    lam_excess = ((got_l - ref_l).abs()
                  - (1e-3 * ref_l.abs() + 1e-5)).max().item()
    # The same solve in float64: a float32 solve of a jointed scene carries
    # ~1.5e-4 m/s of rounding in its joint bodies' velocities, because the
    # joint bias turns one ulp of a position 6-8 m from the origin (4.8e-7
    # m) into 0.2/h = 48 /s x 4.8e-7 = 2.3e-5 m/s per joint and substep.
    # So the velocities are held to 3e-4 (twice that) and, on top, the
    # kernel must sit no farther from the float64 solve than the plain
    # float32 version does (+1e-5); pos, quat and lambda keep K1's bounds.
    ref64, _ = tgs_kernel.solve_tgs_plain(
        packed[0].double(), packed[1], packed[2].double(), packed[3], params,
        has_com=True, joints=joints._replace(jtab=joints.jtab.double()))
    k_vs_64 = (got_b[:, 0:6].double() - ref64[:, 0:6]).abs().max().item()
    p_vs_64 = (ref_b[:, 0:6].double() - ref64[:, 0:6]).abs().max().item()
    if (err_pos > 1e-5 or err_q > 1e-5 or err_vel > 3e-4 or lam_excess > 0
            or k_vs_64 > p_vs_64 + 1e-5):
        fail(f"{label} vs plain: pos {err_pos:.3g} (1e-5), quat "
             f"{err_q:.3g} (1e-5), vel {err_vel:.3g} (3e-4), lambda "
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
    text = (f"pos {err_pos:.3g}, quat {err_q:.3g}, vel {err_vel:.3g}, "
            f"lambda {err_lam:.3g}; vel vs float64 kernel {k_vs_64:.3g}, "
            f"plain {p_vs_64:.3g}; two launches bit-equal; kernel "
            f"{ms_k:.3f} ms (device time {dev_k:.3f}), plain {ms_p:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
    return text, dict(route="cuda", source="fyrox_tpu_torch/csrc/tgs_solve.cu",
                      replaces="fyrox_tpu/physics/pallas_solver.py:816",
                      max_abs_err=max(err_pos, err_vel, err_q, err_lam),
                      ms=ms_k, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by,
                      library_ms=None, device_ms=dev_k,
                      library_device_ms=None)


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
    n_act = int(packed[0][:, 9].sum().item())
    text, rec = k1_joint_against_plain("K1joint", packed, params, joints)
    log(f"[K1joint] solve_tgs with {t.joints.num_joints} joints and COM "
        f"offsets matches plain on a settled jointed-flagship step "
        f"(W={WORLDS} distinct worlds, {packed[2].shape[2]} bodies, {n_act}"
        f" active contact points): {text}")
    return dict(name="solve_tgs_jointed", **rec)


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


MANY_TICKS = 5


def phase_k1_many():
    """The chain forest (1,024 joints, COM offsets) at W distinct worlds on
    the staged route: 30 settling ticks, then MANY_TICKS ticks with the
    launches counted; then K1 with its joint tables in global memory vs its
    plain version on the next step, at K1joint's bounds, two launches
    bit-equal, timed against its bound."""
    from fyrox_tpu_torch.physics import slab2, tgs_kernel
    from fyrox_tpu_torch.physics import world as phys_mod
    t0 = time.perf_counter()
    pb, t = chain_forest(port_lib())
    cx = slab2._ctx(t)
    nb, cg, nj = t.num_bodies, cx.cg, t.joints.num_joints
    big, jglobal, _ = tgs_kernel._layout(nb, cg, cx.s_active, cx.has_com, nj)
    if nj < 1000 or big or not jglobal:
        fail(f"K1joint-many: {nj} joints, layout big {big}, joint tables "
             f"global {jglobal}: want >= 1,000 joints in global memory")
    dt = 1.0 / 60.0
    state = jitter(phys_mod.init_physics_state(pb.initial_pose(), t, WORLDS,
                                               device="cuda"), t, "cuda", 17)
    for _ in range(30):
        state = phys_mod.step_physics(state, t, dt)
    torch.cuda.synchronize()
    reset_all_launches()
    for _ in range(MANY_TICKS):
        state = phys_mod.step_physics(state, t, dt)
    torch.cuda.synchronize()
    n = all_launches()
    want = dict(fused_bp=0, narrow_compact=0, solve_tgs=MANY_TICKS,
                plane_gather=MANY_TICKS * staged_gathers(t), plane_scatter=0)
    if n != want:
        fail(f"K1joint-many: launches {n}, want {want}")
    if not (torch.isfinite(state.position).all()
            and torch.isfinite(state.linvel).all()):
        fail("K1joint-many: non-finite body state")
    accel, angvel = phys_mod.external_accelerations(state, t, dt)
    packed, _ = slab2.solver_inputs(state, t, dt, accel, angvel)
    joints = slab2.joint_tables(cx, "cuda")
    params = tgs_kernel.solver_params(t, dt)
    if not (all_differ(packed[0]) and all_differ(packed[2])):
        fail("K1joint-many: the solver's packed inputs repeat across worlds")
    n_act = int(packed[0][:, 9].sum().item())
    if n_act == 0:
        fail("K1joint-many: no active contact points")
    text, rec = k1_joint_against_plain("K1joint-many", packed, params,
                                       joints)
    log(f"[K1joint-many] chain forest ({CHAINS_MANY} chains, {nj} joints, "
        f"{nb} bodies, COM offsets; {tgs_kernel.smem_bytes(nb, cg, True, nj)}"
        f" B > {tgs_kernel.SMEM_LIMIT} B: joint tables in global memory, "
        f"body planes in shared memory), W={WORLDS} distinct worlds, set up "
        f"in {time.perf_counter() - t0:.1f} s: {MANY_TICKS} staged ticks "
        f"with launches {n}; K1 matches plain on the next step ({n_act} "
        f"active contact points): {text}")
    return dict(name="solve_tgs_joints_global", **rec), n


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


# ---------------------------------------------------------------- rollout
# Engine.rollout replays one captured CUDA graph of a period-1 tick. The
# wrappers' launch counters count the capture, not the replays, so these
# phases count a replayed roll's kernels by name from the profiler.
KERNEL_NAMES = dict(fused_bp="fused_bp_kernel",
                    narrow_compact="narrow_compact_kernel",
                    solve_tgs="tgs_solve_kernel",
                    plane_gather="plane_gather_kernel",
                    plane_scatter="plane_scatter_kernel")


def same_state(label, got, want):
    """Fail unless every tensor of two engine states is equal, bit for bit.
    Returns the number of tensors."""
    from fyrox_tpu_torch.engine import _leaves
    a, b = _leaves(got), _leaves(want)
    bad = [i for i, (x, y) in enumerate(zip(a, b))
           if x.shape != y.shape or not torch.equal(x, y)]
    if len(a) != len(b) or bad:
        fail(f"{label}: {len(bad)} of {len(b)} state tensors differ from "
             f"eager steps (tensors {bad[:8]})")
    return len(b)


def profile_record(fn):
    """(device events, busy microseconds) of one run of fn under the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_events(prof)


# profiles of one replay taken until two agree on its counted kernels
PROFILE_TRIES = 4
# (label, the counted kernels of each record) where a replay needed more
# than two records
PROFILE_REDONE = []


def agreed_record(label, fn, count):
    """(device events, busy microseconds, count(events)) of fn, which
    replays the same device work on every call (captured graphs), from a
    profile whose counted kernels another profile confirms. The profiler's
    record of a replay can lack device events (seen on the H100: a
    replayed 20-tick level roll recorded 251 of its 260 K4a and 270 of its
    280 K4b launches; a replayed level frame 966-1,005 device events from
    one graph). So fn is profiled until two records give the same
    count(events), the kernels the caller checks, and that record is
    returned; a record that lost one of them disagrees with a complete
    one. Fails when no two of PROFILE_TRIES records agree."""
    seen = []
    for _ in range(PROFILE_TRIES):
        events, busy_us = profile_record(fn)
        if not events:
            fail(f"{label}: the profiler recorded no device events")
        n = count(events)
        if n in seen:
            if len(seen) > 1:
                PROFILE_REDONE.append((label, seen + [n]))
            return events, busy_us, n
        seen.append(n)
    fail(f"{label}: no two of {PROFILE_TRIES} profiles of the same replayed "
         f"work counted the same kernels: {seen}")


def stage_profile(fn, reps):
    """(device events, device ms) per call of fn, one profile of reps
    calls: a measurement, no count is checked."""
    events, busy_us = profile_record(lambda: [fn() for _ in range(reps)])
    if not events:
        fail("the profiler recorded no device events of a stage")
    return len(events) / reps, busy_us / 1e3 / reps


def profiled(fn, ticks, label="replayed roll"):
    """fn (ticks engine ticks, replayed) under the profiler, from a record
    that another confirms (agreed_record): the kernels of KERNEL_NAMES by
    name, device events per tick and device ms per tick."""
    kernels, busy_us, n = agreed_record(label, fn, kernel_counts)
    return n, len(kernels) / ticks, busy_us / 1e3 / ticks


def kernel_counts(events):
    """Launches of the kernels of KERNEL_NAMES among profiler events."""
    return {k: sum(1 for e in events if v in e.name)
            for k, v in KERNEL_NAMES.items()}


def two_capture_tick(engine, state):
    """The other form a captured roll could take, for measurement: graph A
    ticks static buffers S0 into its own outputs O_A with no copy, graph B
    ticks O_A and copies its outputs into S0. A capture cannot choose its
    outputs' addresses, so the pair still needs that one copy to close the
    cycle: one copy every two ticks where Engine.rollout's graph copies
    every tick. Returns (replay of the pair, the buffers S0)."""
    from fyrox_tpu_torch.engine import CapturedTick, _copy_all, _leaves
    pair = CapturedTick(engine, state, None, True, "sort")
    pair._step()                             # warm-up, result dropped
    torch.cuda.synchronize()
    graph_a, graph_b = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph_a):
        out_a = pair._step()
    with torch.cuda.graph(graph_b):
        src, dst = pair._copy_back(_leaves(engine.step(out_a)))
        _copy_all(dst, src)
    torch.cuda.synchronize()

    def replay():
        graph_a.replay()
        graph_b.replay()

    return replay, pair.static


def phase_rollout(engine, skin):
    """Engine.rollout on the flagship at W worlds (K3 route): TICKS
    replayed ticks equal TICKS eager ticks bit for bit, from distinct
    worlds; K3, K2 and K1 launch once a tick in a replayed roll (profiler);
    env·steps/s of eager and of captured rolls with skinning, device events
    per tick, the busy share, the capture's seconds and the graph pool."""
    from fyrox_tpu_torch.animation import skinning
    from fyrox_tpu_torch.engine import _copy_all, _leaves
    state0 = distinct_worlds(engine, WORLDS, "cuda", seed=11)
    eager = state0
    for _ in range(TICKS):
        eager = engine.step(eager)
    rolled = engine.rollout(state0, TICKS)
    torch.cuda.synchronize()
    tick = engine.captured_tick(state0)
    n_leaves = same_state("rollout", rolled, eager)
    same_state("rollout from the same state again",
               engine.rollout(state0, TICKS), eager)
    n, events, dev_ms = profiled(lambda: engine.rollout(rolled, TICKS),
                                 TICKS, "rollout")
    want = dict(fused_bp=TICKS, narrow_compact=TICKS, solve_tgs=TICKS,
                plane_gather=0, plane_scatter=0)
    if n != want:
        fail(f"rollout: kernels of a replayed roll {n}, want {want}")
    # the captured tick's copy of its outputs into its input buffers: the
    # same copies (of every state tensor, its most), queued alone
    copy_ms = device_ms(lambda: _copy_all(_leaves(tick.static),
                                          _leaves(rolled)), 20)
    # against the two-capture form (one copy every two ticks): device ms a
    # tick, in turns, each run of ~21 ticks from the same state (the pile's
    # contacts, and so the kernels' work, change from tick to tick); both
    # forms tick as eager steps do
    pair, pair_state = two_capture_tick(engine, state0)
    pair()
    same_state("two-capture tick", pair_state,
               engine.step(engine.step(state0)))
    form_ms = {"copy-back": [], "two-capture": []}
    for label in ("copy-back", "two-capture") * 2 + ("two-capture",
                                                     "copy-back") * 2:
        _copy_all(_leaves(tick.static), _leaves(rolled))
        _copy_all(_leaves(pair_state), _leaves(rolled))
        if label == "copy-back":
            form_ms[label].append(device_ms(tick.graph.replay, 20))
        else:
            form_ms[label].append(device_ms(pair, 10) / 2)
    del pair, pair_state

    def eager_roll(state):
        for _ in range(TICKS):
            state = engine.step(state)
        return state

    def graph_roll(state):
        return engine.rollout(state, TICKS)

    rates, tick_ms = {}, {}
    for label, roll in (("eager", eager_roll), ("rollout", graph_roll),
                        ("eager", eager_roll), ("rollout", graph_roll)):
        def skinned(state):
            state = roll(state)
            bm = skinning.bone_matrices(state.scene.globals_, skin)
            return state, skinning.skin_positions_dense(bm, skin)

        state, verts = skinned(rolled)                 # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            state, verts = skinned(state)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        check_state(state, verts, skin)
        rates.setdefault(label, []).append(WORLDS * TICKS * CALLS / elapsed)
        t0 = time.perf_counter()
        roll(state)
        torch.cuda.synchronize()
        tick_ms.setdefault(label, []).append(
            (time.perf_counter() - t0) * 1e3 / TICKS)
    busy = dev_ms / min(tick_ms["rollout"])
    log(f"[rollout] Engine.rollout, flagship, fused route (K3), W={WORLDS}: "
        f"{TICKS} replayed ticks equal {TICKS} eager ticks bit for bit "
        f"({n_leaves} state tensors, distinct worlds); replayed roll's "
        f"kernels {n}; env·steps/s with skinning ({CALLS} x {TICKS} ticks, "
        f"eager, rollout, eager, rollout): eager "
        f"{', '.join(f'{r:.1f}' for r in rates['eager'])}, rollout "
        f"{', '.join(f'{r:.1f}' for r in rates['rollout'])}; ms a tick "
        f"without skinning: eager "
        f"{', '.join(f'{m:.3f}' for m in tick_ms['eager'])}, rollout "
        f"{', '.join(f'{m:.3f}' for m in tick_ms['rollout'])}; replayed "
        f"tick: {events:.1f} device events, {dev_ms:.3f} ms of device time "
        f"(a copy of every state tensor, the copy-back's most: "
        f"{copy_ms:.4f} ms), busy share {busy:.3f}; device ms a tick queued "
        f"back to back, in turns from one state: copy-back "
        f"{', '.join(f'{m:.4f}' for m in form_ms['copy-back'])} (median "
        f"{np.median(form_ms['copy-back']):.4f}), two-capture "
        f"{', '.join(f'{m:.4f}' for m in form_ms['two-capture'])} (median "
        f"{np.median(form_ms['two-capture']):.4f}); capture "
        f"{tick.capture_seconds:.3f} s, graph pool "
        f"{tick.pool_bytes / 2**20:.1f} MiB on {CARD}")
    return rolled


def phase_rollout_jointed(engine):
    """Engine.rollout on the jointed flagship (staged route, K1's joint
    tables): ROLL_JOINTED replayed ticks equal eager ticks bit for bit; K1
    once and K4a staged_gathers times a tick in a replayed roll."""
    t = engine.physics
    state0 = distinct_worlds(engine, WORLDS, "cuda", seed=13)
    eager = state0
    t0 = time.perf_counter()
    for _ in range(ROLL_JOINTED):
        eager = engine.step(eager)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / ROLL_JOINTED
    rolled = engine.rollout(state0, ROLL_JOINTED)
    torch.cuda.synchronize()
    n_leaves = same_state("jointed rollout", rolled, eager)
    gathers = staged_gathers(t)
    # ~5,000 device events a tick: a short roll (agreed_record profiles
    # it at least twice)
    n, events, dev_ms = profiled(
        lambda: engine.rollout(rolled, PROFILED_JOINTED), PROFILED_JOINTED,
        "jointed rollout")
    want = dict(fused_bp=0, narrow_compact=0, solve_tgs=PROFILED_JOINTED,
                plane_gather=PROFILED_JOINTED * gathers, plane_scatter=0)
    if n != want:
        fail(f"jointed rollout: kernels of a replayed roll {n}, want {want}")
    t0 = time.perf_counter()
    engine.rollout(rolled, ROLL_JOINTED)
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) * 1e3 / ROLL_JOINTED
    log(f"[rollout-jointed] Engine.rollout, jointed flagship "
        f"({t.joints.num_joints} joints, staged route), W={WORLDS}: "
        f"{ROLL_JOINTED} replayed ticks equal eager ticks bit for bit "
        f"({n_leaves} state tensors); replayed roll's kernels {n} "
        f"(solve_tgs 1 and plane_gather {gathers} a tick); {events:.1f} "
        f"device events and {dev_ms:.3f} ms of device time a replayed tick;"
        f" ms a tick: eager {eager_ms:.3f}, rollout {graph_ms:.3f} on {CARD}")


def phase_rollout_reuse(engine):
    """Engine.rollout on the reuse flagship (period 4) steps eagerly on the
    card (no graph) and equals its eager steps bit for bit."""
    state0 = distinct_worlds(engine, WORLDS, "cuda", seed=19)
    eager = state0
    for _ in range(ROLL_REUSE):
        eager = engine.step(eager, bp_rank="count")
    rolled = engine.rollout(state0, ROLL_REUSE, bp_rank="count")
    torch.cuda.synchronize()
    if getattr(engine, "_captured", None):
        fail("reuse rollout: a period-4 template was captured")
    n_leaves = same_state("reuse rollout", rolled, eager)
    log(f"[rollout-reuse] Engine.rollout, reuse flagship (period "
        f"{PERIOD}, count rank), W={WORLDS}: {ROLL_REUSE} eager ticks inside"
        f" rollout (no capture: one host read a tick) equal {ROLL_REUSE} "
        f"Engine.step ticks bit for bit ({n_leaves} state tensors)")


def phase_health(engine, state):
    """world_health and restore_unhealthy on a card state with a NaN
    injected into one world."""
    from fyrox_tpu_torch.engine import _leaves, restore_unhealthy, world_health
    if not bool(world_health(state).all()):
        fail("health: a rolled flagship world is unhealthy")
    sick_world = 5
    pos = state.physics.position.clone()
    pos[sick_world, 3, 1] = float("nan")
    sick = state._replace(physics=state.physics._replace(position=pos))
    ok = world_health(sick)
    want = torch.ones(WORLDS, dtype=torch.bool, device="cuda")
    want[sick_world] = False
    if not torch.equal(ok, want):
        fail(f"health: world_health {ok.nonzero().flatten().tolist()[:8]}..."
             f" want every world but {sick_world}")
    fallback = engine.init_state(WORLDS, device="cuda")
    fixed = restore_unhealthy(sick, fallback)
    for x, s, f in zip(_leaves(fixed), _leaves(sick), _leaves(fallback)):
        if x.shape[:1] != (WORLDS,):
            continue
        keep = torch.arange(WORLDS, device="cuda") != sick_world
        if not (torch.equal(x[keep], s[keep])
                and torch.equal(x[sick_world], f[sick_world])):
            fail("health: restore_unhealthy did not take the fallback's "
                 "values in the sick world only")
    if not bool(world_health(fixed).all()):
        fail("health: a restored world is unhealthy")
    log(f"[health] world_health marks world {sick_world} (one NaN body "
        f"coordinate) of {WORLDS} unhealthy; restore_unhealthy gives it the"
        f" fallback's state and keeps the others bit for bit")


# ---------------------------------------------------------------- animation
# The animation breadth (the plain AnimationPlayer, root motion with its
# body drive, blend spaces, layered machines, blend shapes, gather
# skinning, sprite sheets, particles): plain PyTorch, the same on the card
# and the CPU, so the card is held to the CPU from the same state. Then the
# real-asset flagship: build_flagship(real_asset=make_character_fbx(100,
# 50,000)) with the flagship's 1,000-body pile, on the plain player.
ANIM_W = 4
ANIM_TICKS = 20
ANIM_NODES = 6
REAL_ASSET = dict(n_bones=100, n_verts=50_000)


def _lin(keys):
    return [dict(time=float(t), value=float(v)) for t, v in keys]


def anim_clips(seed=0):
    """Three clips over ANIM_NODES nodes with seeded random position,
    rotation and scale keys (one reversed, one not looping), and a fourth
    that writes +y on every node (the layered machine's wave)."""
    from fyrox_tpu_torch.animation import AnimationSetBuilder
    rng = np.random.default_rng(seed)
    b = AnimationSetBuilder()
    for c, (speed, loop) in enumerate(((1.0, True), (-0.7, True),
                                       (1.3, False))):
        length = float(rng.uniform(0.6, 1.2))
        cid = b.add_clip(f"c{c}", length=length, speed=speed, looping=loop)
        times = np.linspace(0.0, length, 5)
        for node in rng.choice(ANIM_NODES, 4, replace=False):
            kind = int(rng.integers(0, 3))
            lo, hi = (0.5, 1.5) if kind == 2 else (-1.0, 1.0)
            keys = [_lin(zip(times, rng.uniform(lo, hi, 5)))
                    for _ in range(3)]
            (b.add_position_track, b.add_rotation_track,
             b.add_scale_track)[kind](cid, int(node), keys)
    wave = b.add_clip("wave", length=1.0)
    for n in range(ANIM_NODES):
        b.add_position_track(wave, n, [_lin([(0, 0), (1, 0)]),
                                       _lin([(0, 0.1 * n), (1, 1.0)]),
                                       _lin([(0, 0), (1, 0)])])
    return b.build()


def anim_pose(w, device, seed=1):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, (w, ANIM_NODES, 3))
    r = rng.standard_normal((w, ANIM_NODES, 4))
    r /= np.linalg.norm(r, axis=-1, keepdims=True)
    s = rng.uniform(0.5, 1.5, (w, ANIM_NODES, 3))
    return tuple(torch.as_tensor(x.astype(np.float32), device=device)
                 for x in (p, r, s))


def walker_engine(particles=None):
    """A capsule character on a halfspace (dense) whose root clip walks +x
    at 1.2 m/s, with root motion driving its body
    (tests/test_blendspace_rootmotion.py:218-260), and an optional particle
    emitter."""
    from fyrox_tpu_torch.animation import AnimationSetBuilder
    from fyrox_tpu_torch.animation import rootmotion
    from fyrox_tpu_torch.engine import Engine
    from fyrox_tpu_torch.physics import (CAPSULE, HALFSPACE, BodyType,
                                         PhysicsBuilder)
    from fyrox_tpu_torch.scene import SceneBuilder
    sb = SceneBuilder()
    root = sb.add_pivot("char_root", position=(0, 0.9, 0))
    ab = AnimationSetBuilder()
    walk = ab.add_clip("walk", length=1.0, looping=True)
    ab.add_position_track(walk, root, [_lin([(0, 0), (1, 1.2)]),
                                       _lin([(0, 0), (1, 0)]),
                                       _lin([(0, 0), (1, 0)])])
    aset = ab.build()
    pb = PhysicsBuilder()
    g = pb.add_body(body_type=BodyType.STATIC)
    pb.add_collider(g, HALFSPACE, [0, 0, 0])
    body = pb.add_body(node=root, position=(0, 0.9, 0),
                       lock_rotation=(0, 0, 0))
    pb.add_collider(body, CAPSULE, [0.4, 0.3])
    return Engine(template=sb.build(), physics=pb.build(broadphase="dense"),
                  animations=aset, particles=particles,
                  root_motion=rootmotion.build_root_motion(
                      aset, rootmotion.RootMotionSettings(node=root)),
                  root_motion_body=body), body


def held(label, card, cpu, tol):
    """max |card - cpu| over paired tensors; fails above tol."""
    d = max((a.cpu().double() - b.double()).abs().max().item()
            for a, b in zip(card, cpu))
    if not d <= tol:
        fail(f"anim-small {label}: card vs CPU {d:.3g} > {tol:g}")
    return d


def anim_player(dev):
    """ANIM_TICKS plain-player ticks (worlds with different enabled
    clips): poses and clip times each tick."""
    from fyrox_tpu_torch.animation import player, track
    aset = anim_clips()
    a = track.init_animation_state(aset, ANIM_W, device=dev)
    en = np.random.default_rng(2).random((ANIM_W, aset.num_animations)) > 0.3
    a = a._replace(enabled=torch.as_tensor(en, device=dev))
    p, r, s = anim_pose(ANIM_W, dev)
    out = []
    for _ in range(ANIM_TICKS):
        a, p, r, s = player.step_player(aset, a, p, r, s, 1 / 60)
        out += [a.time, p, r, s]
    return out


def blend_space_machine(dev):
    """A machine (idle clip → a 4-point blend space on a bool rule) and a
    layered machine (that machine below, a masked wave layer above with a
    float weight parameter and a sampling point): ANIM_TICKS ticks of
    each, the poses every tick."""
    from fyrox_tpu_torch.animation import (MachineBuilder, blendspace,
                                           machine, player, pose, track)
    aset = anim_clips()
    bst = blendspace.build_blend_space([[0, 0], [1, 0], [1, 1], [0, 1]],
                                       [0, 1, 2, 0])
    mb = MachineBuilder()
    go = mb.add_parameter("go")
    idle = mb.add_state("idle", clip=0)
    loco = mb.add_state("locomotion", blendspace=bst)
    mb.set_entry_state(idle)
    mb.add_transition(idle, loco, go, duration=0.1)
    mt = mb.build()
    wb = MachineBuilder()
    wb.add_state("wave", clip=3)
    lm = machine.LayeredMachine(layers=[
        machine.LayerSpec(machine=mt, sampling_param=0),
        machine.LayerSpec(machine=wb.build(),
                          mask=np.arange(ANIM_NODES) >= ANIM_NODES // 2,
                          weight_param=0)])
    rng = np.random.default_rng(3)
    xy = torch.as_tensor(rng.uniform(-0.5, 1.5, (ANIM_W, 2)).astype(
        np.float32), device=dev)
    prm = machine.make_parameters(ANIM_W, bools=1, floats=1, points=1,
                                  device=dev)
    prm = prm._replace(
        bools=torch.as_tensor(np.arange(ANIM_W)[:, None] % 2 == 0,
                              device=dev),
        floats=torch.as_tensor(rng.uniform(0, 1, (ANIM_W, 1)).astype(
            np.float32), device=dev),
        points=xy[:, None])
    a = track.init_animation_state(aset, ANIM_W, device=dev)
    ms = machine.init_machine_state(mt, ANIM_W, device=dev)
    layers = machine.init_layered_state(lm, ANIM_W, device=dev)
    p, r, s = anim_pose(ANIM_W, dev)
    lp, lr, ls = p, r, s
    out = []
    for _ in range(ANIM_TICKS):
        poses = pose.build_poses(aset, track.sample_tracks(aset, a),
                                 ANIM_NODES)
        ms = machine.update_machine(mt, ms, prm.bools, 1 / 60)
        out += list(machine.evaluate_pose(mt, ms, poses, xy)[:3])
        _, layers, lp, lr, ls = player.step_absm_layered(
            aset, lm, a, layers, prm, lp, lr, ls, 1 / 60)
        out += [lp, lr, ls]
        a = track.tick_times(aset, a, 1 / 60)
    return out


def skin_inputs(dev, b=7, v=3000):
    from fyrox_tpu_torch.animation import SkinTemplate
    rng = np.random.default_rng(4)
    w4 = rng.uniform(0.1, 1, (v, 4)).astype(np.float32)
    skin = SkinTemplate(
        bones=np.arange(b, dtype=np.int32),
        inv_bind=np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
        vertices=rng.uniform(-1, 1, (v, 3)).astype(np.float32),
        bone_indices=rng.integers(0, b, (v, 4)).astype(np.int32),
        bone_weights=w4 / w4.sum(-1, keepdims=True))
    mats = np.tile(np.eye(4, dtype=np.float32), (ANIM_W, b, 1, 1))
    mats[:, :, :3] += rng.uniform(-0.3, 0.3, (ANIM_W, b, 3, 4))
    shapes = (skin.vertices, rng.uniform(-0.1, 0.1, (5, v, 3)).astype(
        np.float32), rng.uniform(0, 100, (ANIM_W, 5)).astype(np.float32))
    return skin, torch.as_tensor(mats, device=dev), shapes


def particle_replays(engine, w):
    """On the card: ANIM_TICKS replayed ticks equal ANIM_TICKS eager ticks
    bit for bit and leave the counter at ANIM_TICKS; a replayed tick from
    the same state with the counter at 0 and at 1 draws different
    newborns (the graph reads the counter from its buffer). Returns the
    replayed state."""
    state = engine.init_state(w, device="cuda")
    eager = state
    for _ in range(ANIM_TICKS):
        eager = engine.step(eager)
    rolled = engine.rollout(state, ANIM_TICKS)
    torch.cuda.synchronize()
    same_state("particle rollout", rolled, eager)
    if int(rolled.particles.step) != ANIM_TICKS:
        fail(f"particle rollout: counter {int(rolled.particles.step)}, want "
             f"{ANIM_TICKS}")
    one = state._replace(particles=state.particles._replace(
        step=state.particles.step + 1))
    t0, t1 = engine.rollout(state, 1), engine.rollout(one, 1)
    born = t0.particles.alive
    if not bool(born.any()) or not torch.equal(born, t1.particles.alive):
        fail("particle rollout: no newborns, or newborns that depend on the "
             "counter's value")
    if bool((t0.particles.velocity[born] == t1.particles.velocity[born])
            .any()):
        fail("particle rollout: a replay at counter 1 drew counter 0's "
             "velocities")
    return rolled


def phase_anim_small():
    """The card against the CPU from the same state for every module of
    the animation breadth, and the particle engine's replays."""
    from fyrox_tpu_torch.animation import skinning, spritesheet
    from fyrox_tpu_torch.scene.particles import ParticleTemplate
    res = {}
    res["player"] = held("player", anim_player("cuda"), anim_player("cpu"),
                         1e-5)
    res["blend-space, layers"] = held("blend-space, layers",
                                      blend_space_machine("cuda"),
                                      blend_space_machine("cpu"), 1e-5)
    skin, mats, (verts, deltas, wts) = skin_inputs("cuda")
    gather = skinning.skin_positions_gather(mats, skin)
    res["gather"] = held("gather skinning", [gather],
                         [skinning.skin_positions_gather(mats.cpu(), skin)],
                         1e-5)
    held("gather vs dense on the card", [gather],
         [skinning.skin_positions_dense(mats, skin).cpu()], 1e-5)
    res["blend shapes"] = held(
        "blend shapes",
        [skinning.apply_blend_shapes(verts, deltas,
                                     torch.as_tensor(wts, device="cuda"))],
        [skinning.apply_blend_shapes(verts, deltas, torch.as_tensor(wts))],
        1e-5)
    sheet = spritesheet.SpriteSheetAnimation(columns=5, rows=3, fps=12.0,
                                             first_frame=1, last_frame=12)
    times = torch.linspace(-0.5, 4.0, 401)
    frames = [spritesheet.current_frame(sheet, x) for x in
              (times.cuda(), times)]
    uvs = [spritesheet.frame_uv_rect(sheet, f) for f in frames]
    if not (torch.equal(frames[0].cpu(), frames[1])
            and torch.equal(uvs[0].cpu(), uvs[1])):
        fail("anim-small spritesheet: card and CPU frames differ")
    # root motion with its body drive, and particles, through Engine.step
    engine, body = walker_engine(ParticleTemplate(max_particles=64,
                                                  emit_rate=90.0, seed=3))
    gpu, cpu = (engine.init_state(ANIM_W, device=d) for d in ("cuda", "cpu"))
    for _ in range(ANIM_TICKS):
        gpu, cpu = engine.step(gpu), engine.step(cpu)
    res["root motion"] = held("root motion body", [gpu.physics.position],
                              [cpu.physics.position], 5e-4)
    res["particles"] = held("particles", [gpu.particles.position,
                                          gpu.particles.velocity,
                                          gpu.particles.lifetime],
                            [cpu.particles.position, cpu.particles.velocity,
                             cpu.particles.lifetime], 1e-5)
    if not torch.equal(gpu.particles.alive.cpu(), cpu.particles.alive):
        fail("anim-small particles: card and CPU alive masks differ")
    walked = float(cpu.physics.position[0, body, 0])
    if not walked > 0.2:
        fail(f"anim-small root motion: the body walked {walked:.3f} m in "
             f"{ANIM_TICKS} ticks")
    particle_replays(engine, ANIM_W)
    log(f"[anim-small] card == CPU, W={ANIM_W}, {ANIM_TICKS} ticks, max "
        f"|card - CPU|: " + ", ".join(f"{k} {v:.3g}" for k, v in res.items())
        + f"; gather skinning == dense; sprite frames and UVs equal; the "
        f"root-motion body walked {walked:.3f} m; {ANIM_TICKS} replayed "
        f"particle ticks equal the eager ones bit for bit, the counter "
        f"advancing the draws")


def phase_real_asset():
    """The real-asset flagship at full width: the FBX written and imported
    (seconds), W distinct worlds, TICKS eager ticks with the launches
    counted (K3, K2, K1 once a tick), TICKS replayed ticks equal to them
    bit for bit, world_health, the mesh at bind pose on the first state
    and moved after the roll; a replayed roll's kernels, device events and
    device ms; env·steps/s with skinning, eager and through rollout in
    turns; the peak memory of an eager tick and of a replayed roll."""
    from fyrox_tpu_torch.animation import skinning
    from fyrox_tpu_torch.engine import world_health
    from fyrox_tpu_torch.models import build_flagship, make_character_fbx
    from fyrox_tpu_torch.physics import fused_step
    t0 = time.perf_counter()
    data = make_character_fbx(**REAL_ASSET)
    t1 = time.perf_counter()
    engine, skin = build_flagship(n_bodies=1000, real_asset=data)
    t2 = time.perf_counter()
    if (skin.num_bones, skin.num_vertices) != (REAL_ASSET["n_bones"],
                                               REAL_ASSET["n_verts"]):
        fail(f"real-asset: imported {skin.num_bones} bones, "
             f"{skin.num_vertices} vertices")
    if engine.machine is not None or not fused_step.supports_fused_bp(
            engine.physics):
        fail("real-asset: not the plain player on the K3 route")

    def skinned(st):
        bm = skinning.bone_matrices(st.scene.globals_, skin)
        return skinning.skin_positions_dense(bm, skin)

    state0 = distinct_worlds(engine, WORLDS, "cuda", seed=23)
    v0 = skinned(state0)
    bind_err = (v0[0] - torch.as_tensor(skin.vertices, device="cuda")
                ).abs().max().item()
    torch.cuda.synchronize()
    reset_all_launches()
    eager = state0
    for _ in range(TICKS):
        eager = engine.step(eager)
    torch.cuda.synchronize()
    n = all_launches()
    want = dict(fused_bp=TICKS, narrow_compact=TICKS, solve_tgs=TICKS,
                plane_gather=0, plane_scatter=0)
    if n != want:
        fail(f"real-asset: launches of {TICKS} eager ticks {n}, want {want}")
    rolled = engine.rollout(state0, TICKS)
    n_leaves = same_state("real-asset rollout", rolled, eager)
    if not bool(world_health(rolled).all()):
        fail("real-asset: a rolled world is unhealthy")
    verts = skinned(rolled)
    check_state(rolled, verts, skin)
    moved = (verts - v0).norm(dim=-1).max().item()
    if not (bind_err < 1e-3 and moved > 0.01):
        fail(f"real-asset: bind-pose error {bind_err:.3g} (want < 1e-3), "
             f"mesh moved {moved:.3g} (want > 0.01)")
    kn, events, dev_ms = profiled(lambda: engine.rollout(rolled, TICKS),
                                  TICKS, "real-asset")
    if kn != want:
        fail(f"real-asset: kernels of a replayed roll {kn}, want {want}")

    def eager_roll(st):
        for _ in range(TICKS):
            st = engine.step(st)
        return st

    rates = {}
    for label, roll in (("eager", eager_roll),
                        ("rollout", lambda st: engine.rollout(st, TICKS))) * 2:
        st, v = roll(rolled), None
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(CALLS):
            st = roll(st)
            v = skinned(st)
        torch.cuda.synchronize()
        check_state(st, v, skin)
        rates.setdefault(label, []).append(
            WORLDS * TICKS * CALLS / (time.perf_counter() - t))
    peak = {}
    for label, fn in (("eager tick", lambda: engine.step(rolled)),
                      ("replayed roll",
                       lambda: engine.rollout(rolled, TICKS))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peak[label] = (torch.cuda.max_memory_allocated() - base) / 2**30
    tick = engine.captured_tick(state0)
    log(f"[real-asset] make_character_fbx({REAL_ASSET['n_bones']}, "
        f"{REAL_ASSET['n_verts']}) {len(data) / 2**20:.2f} MiB in "
        f"{t1 - t0:.2f} s; [import] fbx_to_engine + pile + slab template in "
        f"{t2 - t1:.2f} s ({skin.num_bones} bones, {skin.num_vertices} "
        f"vertices, {engine.animations.rot_node.size} rotation tracks, "
        f"{engine.physics.num_bodies - 1} bodies); W={WORLDS}: {TICKS} "
        f"replayed ticks equal {TICKS} eager ticks bit for bit ({n_leaves} "
        f"state tensors, distinct worlds); eager launches a tick: fused_bp "
        f"1, narrow_compact 1, solve_tgs 1, plane_gather 0; world_health "
        f"all true; bind-pose error {bind_err:.3g}, mesh moved {moved:.3f};"
        f" replayed roll's kernels {kn}; replayed tick: {events:.1f} device"
        f" events, {dev_ms:.3f} ms of device time; env·steps/s with "
        f"skinning ({CALLS} x {TICKS} ticks, in turns): eager "
        f"{', '.join(f'{r:.1f}' for r in rates['eager'])}, rollout "
        f"{', '.join(f'{r:.1f}' for r in rates['rollout'])}; peak memory "
        f"above the state: eager tick {peak['eager tick']:.2f} GiB, "
        f"replayed roll {peak['replayed roll']:.2f} GiB; capture "
        f"{tick.capture_seconds:.3f} s, graph pool "
        f"{tick.pool_bytes / 2**20:.1f} MiB on {CARD}")


# ---------------------------------------------------------------- dense
# The dense broadphase path: every scene under 192 colliders, the default
# build_flagship() (64 bodies: 2,080 pairs, 3,664 contact slots) among
# them. Its solver's gathers are K4a launches and its scatters (contacts
# and joints) K4b launches; nothing on it uses float atomics.
DENSE_SMALL_TICKS = 20
DENSE_PROFILED = 3     # replayed dense ticks under the profiler (~3,000
                       # device events a tick)


def dense_launches(t):
    """(K4a, K4b) launches a dense tick makes (physics/solver.py): the
    prep's count scatter and gather; per substep the warm start's scatter,
    per PGS pass a gather and a scatter, the end-of-substep gather; the
    restitution's gather and scatter; per stabilisation pass a scatter and
    a gather (not after the last). Joints add two gathers and two scatters
    per substep and one of each per position pass."""
    sub, pgs, stab = t.n_substeps, t.n_pgs, t.n_stabilization
    gathers = 1 + sub * (pgs + 1) + 1 + max(stab - 1, 0)
    scatters = 1 + sub * (1 + pgs) + 1 + stab
    if t.joints is not None and t.joints.num_joints:
        gathers += 2 * sub + stab
        scatters += 2 * sub + stab
    return gathers, scatters


def dense_small_scene():
    """tests/test_oracle.py's mixed cluster (balls, cuboids, capsules) and,
    beside it, tests/test_ragdoll.py's 4-limb chain (capsules, ball joints)
    on one halfspace; 14 colliders, dense broadphase."""
    from fyrox_tpu_torch.physics import (BALL, CAPSULE, CUBOID, HALFSPACE,
                                         BodyType, PhysicsBuilder)
    from fyrox_tpu_torch.scene import RagdollBuilder, SceneBuilder
    rng = np.random.default_rng(3)
    pb = PhysicsBuilder()
    g = pb.add_body(body_type=BodyType.STATIC)
    pb.add_collider(g, HALFSPACE, [], friction=0.5, restitution=0.2)
    shapes = [(BALL, [0.25]), (CUBOID, [0.2, 0.25, 0.2]),
              (CAPSULE, [0.2, 0.15])]
    for i in range(9):
        kind, params = shapes[i % 3]
        p = (rng.uniform(-0.8, 0.8), 0.5 + 0.5 * (i // 3),
             rng.uniform(-0.8, 0.8))
        b = pb.add_body(position=p)
        pb.add_collider(b, kind, params, friction=0.4, restitution=0.1)
    sb = SceneBuilder()
    rb = RagdollBuilder(pb)
    limbs = []
    for i in range(4):
        head, tail = (2.5, 0.3 + i * 0.4, 0.0), (2.5, 0.7 + i * 0.4, 0.0)
        bone = sb.add_pivot(f"bone{i}", position=head)
        limbs.append(rb.add_limb(bone, head, tail, radius=0.08,
                                 parent=limbs[-1] if limbs else None))
    rb.build()
    return pb, pb.build(broadphase="dense")


def phase_dense_small():
    """The small dense scene, card vs CPU over DENSE_SMALL_TICKS ticks at
    W=4 distinct worlds, within card_vs_cpu's bounds; K4a and K4b launched
    dense_launches(t) times a tick on the card."""
    from fyrox_tpu_torch.physics import world as phys_mod
    pb, t = dense_small_scene()
    if t.grid is not None or t.joints is None or t.joints.num_joints != 3:
        fail("dense-small: the scene is not a jointed dense scene")
    cpu = phys_mod.init_physics_state(pb, t, 4, device="cpu")
    cpu = jitter(cpu, t, "cpu", seed=3)
    reset_all_launches()
    dp, dv, live, _ = card_vs_cpu(
        "dense-small", t, cpu, DENSE_SMALL_TICKS,
        lambda s: phys_mod.step_physics(s, t, 1.0 / 60.0))
    n = all_launches()
    gathers, scatters = dense_launches(t)
    want = dict(fused_bp=0, narrow_compact=0, solve_tgs=0,
                plane_gather=gathers * DENSE_SMALL_TICKS,
                plane_scatter=scatters * DENSE_SMALL_TICKS)
    if n != want:
        fail(f"dense-small: launches {n}, want {want}")
    log(f"[dense-small] mixed cluster + 4-limb ragdoll ({t.num_pairs} "
        f"pairs, {t.flat_layout()[1]} contact slots, "
        f"{t.joints.num_joints} joints), card == CPU over "
        f"{DENSE_SMALL_TICKS} ticks (W=4 distinct worlds, {live} live "
        f"contact slots): dp {dp:.3g} (bound 5e-4), dv {dv:.3g} (bound "
        f"5e-3); K4a {gathers} and K4b {scatters} launches a tick")


def capture_dense_calls(engine, state):
    """The K4a and K4b calls of one eager dense tick from `state`, as the
    main path makes them: ([(planes, idx)], [(vals, idx, n)])."""
    from fyrox_tpu_torch.physics import plane_ops
    gathers, scatters = [], []
    pg, ps = plane_ops.plane_gather, plane_ops.plane_scatter

    def spy_gather(planes, idx):
        gathers.append((planes, idx))
        return pg(planes, idx)

    def spy_scatter(vals, idx, n):
        scatters.append((vals, idx, n))
        return ps(vals, idx, n)

    plane_ops.plane_gather, plane_ops.plane_scatter = spy_gather, spy_scatter
    try:
        engine.step(state)
    finally:
        plane_ops.plane_gather, plane_ops.plane_scatter = pg, ps
    torch.cuda.synchronize()
    return gathers, scatters


def phase_dense_k4(engine, calls, tag="dense"):
    """K4a and K4b on one dense flagship tick's calls (a settled state, W
    distinct worlds): each bit-equal to its plain version (the gather's on
    the card; the scatter's on CPU copies, which sums in ascending k as
    the kernel does, and the card's ascending-k float32 sums), two launches
    bit-equal; the tick's set of calls timed against its bound, its plain
    version and one PyTorch call a launch (torch.gather, scatter_add_)."""
    gathers, scatters = calls
    t = engine.physics
    k2, b = 2 * t.flat_layout()[1], t.num_bodies
    ng, ns = dense_launches(t)
    if (len(gathers), len(scatters)) != (ng, ns):
        fail(f"{tag} K4: {len(gathers)} gathers and {len(scatters)} "
             f"scatters in a tick, want {ng} and {ns}")
    for planes, idx in gathers:
        if (planes.shape[0], planes.shape[2], tuple(idx.shape)) != (
                WORLDS, b, (WORLDS, k2)):
            fail(f"{tag} K4a: shapes {tuple(planes.shape)} x "
                 f"{tuple(idx.shape)}")
    for vals, idx, n in scatters:
        if (vals.shape[0], vals.shape[2], n, tuple(idx.shape)) != (
                WORLDS, k2, b, (WORLDS, k2)):
            fail(f"{tag} K4b: shapes {tuple(vals.shape)} → {n} rows")
    return hold_k4(tag, gathers, scatters,
                   f"idx [{WORLDS},{k2}], {b} body rows")


def hold_k4(tag, gathers, scatters, shapes):
    """K4a and K4b on one tick's calls: each bit-equal to its plain version
    (the gather's on the card; the scatter's on CPU copies, which sums in
    ascending k as the kernel does, and the card's ascending-k float32
    sums), two launches bit-equal; the tick's set of calls timed against
    its bound, its plain version and one PyTorch call a launch
    (torch.gather, scatter_add_). `shapes` describes the calls for the
    log. Returns the two kernel records (plane_gather_<tag>,
    plane_scatter_<tag>)."""
    from fyrox_tpu_torch.physics import plane_ops
    if not all_differ(scatters[-1][0]):
        fail(f"{tag} K4b: the captured worlds repeat")
    # K4a: a gather moves values, bit-equal to torch.gather's
    for planes, idx in gathers:
        got, again = (plane_ops.plane_gather(planes, idx) for _ in range(2))
        if not (torch.equal(got, again) and torch.equal(
                got, plane_ops.plane_gather_plain(planes, idx))):
            fail(f"{tag} K4a: kernel differs from its plain version or "
                 "from itself")
    # K4b: sums of ~50-400 values a body in ascending k
    worst_rel = 0.0
    for vals, idx, n in scatters:
        got, again = (plane_ops.plane_scatter(vals, idx, n) for _ in range(2))
        ref = plane_ops.plane_scatter_plain(vals.cpu(), idx.cpu(), n)
        if not (torch.equal(got, again) and torch.equal(got.cpu(), ref)):
            fail(f"{tag} K4b: kernel differs from its plain version on CPU "
                 f"copies at {int((got.cpu() != ref).sum())} entries, or "
                 f"from itself")
        rel = (plane_ops.plane_scatter_plain(vals, idx, n).double() - got
               ).abs().div(2 * scatter_sum_bound(vals, idx, n)
                           ).nan_to_num().max().item()
        worst_rel = max(worst_rel, rel)
    vals, idx, n = max(scatters, key=lambda c: c[0].shape[1])
    if not torch.equal(plane_ops.plane_scatter(vals, idx, n),
                       scatter_in_order(vals, idx, n)):
        fail(f"{tag} K4b: kernel differs from the card's ascending-k sums")
    if not worst_rel <= 1.0:
        fail(f"{tag} K4b: kernel vs the card's plain version (atomics) at "
             f"{worst_rel:.3g} of twice the float32 summation bound")

    def run(fn, cs):
        return lambda: [fn(*c) for c in cs]

    lib_g = [(planes, idx.long()[:, None, :].expand(
        planes.shape[0], planes.shape[1], idx.shape[1]))
        for planes, idx in gathers]
    # an index K4b drops (below 0: a row past its body's window) goes to
    # a spare column of the library call's output
    lib_s = [(vals, torch.where(idx < 0, n, idx).long()[:, None, :].expand(
        vals.shape), n + int(bool((idx < 0).any())))
             for vals, idx, n in scatters]
    for (planes, li), (planes2, idx) in zip(lib_g, gathers):
        if not torch.equal(torch.gather(planes, 2, li),
                           plane_ops.plane_gather(planes2, idx)):
            fail(f"{tag} K4a: the torch.gather yardstick disagrees")

    def lib_scatter(vals, li, n):
        return torch.zeros((vals.shape[0], vals.shape[1], n),
                           device="cuda").scatter_add_(2, li, vals)

    recs = []
    for name, kern, plain, lib, lib_fn, cs, ops in (
            (f"plane_gather_{tag}", plane_ops.plane_gather,
             plane_ops.plane_gather_plain, lib_g,
             lambda p, li: torch.gather(p, 2, li), gathers, 0),
            (f"plane_scatter_{tag}", plane_ops.plane_scatter,
             plane_ops.plane_scatter_plain, lib_s, lib_scatter, scatters,
             sum(v.numel() for v, _, _ in scatters))):
        ms_k, ms_p = cuda_ms(run(kern, cs), 20), cuda_ms(run(plain, cs), 10)
        ms_lib = cuda_ms(run(lib_fn, lib), 20)
        # at most ~600 launches queued behind the spin: a fuller launch
        # queue blocks the host until the spin ends
        reps = min(20, max(1, 600 // (2 * len(cs))))
        dev_k, dev_lib = device_ms(run(kern, cs), reps), device_ms(
            run(lib_fn, lib), reps)
        outs = [kern(*c) for c in cs]
        moved = sum(nbytes(c[0], c[1], o) for c, o in zip(cs, outs))
        b_ms, b_by = bound_ms(moved, ops)
        src = "gather" if "gather" in name else "scatter"
        recs.append(dict(name=name, route="cuda",
                         source=f"fyrox_tpu_torch/csrc/plane_{src}.cu",
                         replaces=("fyrox_tpu/physics/pallas_ops.py:171"
                                   if src == "gather" else
                                   "fyrox_tpu/physics/pallas_ops.py:219"),
                         max_abs_err=0.0, ms=ms_k, plain_ms=ms_p,
                         bound_ms=b_ms, bound_by=b_by, library_ms=ms_lib,
                         device_ms=dev_k, library_device_ms=dev_lib))
        log(f"[{tag}-K4] {name}: a {tag} tick's {len(cs)} calls "
            f"(W={WORLDS} distinct worlds, {shapes}, attribute rows "
            f"{sorted({c[0].shape[1] for c in cs})}) "
            f"bit-equal to plain, two launches bit-equal; CUDA events over "
            f"the set: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, "
            f"{'torch.gather' if src == 'gather' else 'scatter_add_'} "
            f"{ms_lib:.4f} ms; device time: kernel {dev_k:.4f} ms, library "
            f"{dev_lib:.4f} ms; bound {b_ms:.4f} ms ({b_by}) on {CARD}")
    log(f"[{tag}-K4] plane_scatter vs the card's plain version (atomics): "
        f"{worst_rel:.3g} of twice the float32 summation bound; bit-equal "
        f"to the ascending-k float32 sums on the widest call")
    return recs


def dense_stages(engine, state, reps=3):
    """Device ms and device events (profiler: the union of the kernels'
    intervals, so the gaps between launches do not count) of the dense tick's
    stages from `state`, per call over `reps` calls after a warm-up: the
    whole eager tick, its physics step, and the physics step's broadphase
    + narrowphase (world.dense_contacts); the solve (with the external
    accelerations, warm start, locks and damping) and the rest of the
    tick (ABSM, hierarchy, body sync, refresh) are the differences."""
    from fyrox_tpu_torch.physics import world as phys_mod
    t, dt = engine.physics, engine.dt
    fns = dict(tick=lambda: engine.step(state),
               physics=lambda: phys_mod.step_physics(state.physics, t, dt),
               contacts=lambda: phys_mod.dense_contacts(state.physics, t,
                                                        dt))
    out = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        events, dev = stage_profile(fn, reps)
        out[name] = (dev, events)
    out["solve"] = tuple(a - b for a, b in zip(out["physics"],
                                               out["contacts"]))
    out["rest"] = tuple(a - b for a, b in zip(out["tick"], out["physics"]))
    return out


def phase_dense(engine, skin, label="dense", bodies=65):
    """The default build_flagship() (dense broadphase) at W distinct
    worlds, through the entry points: TICKS eager Engine.step ticks with
    the launches counted (K4a and K4b dense_launches(t) a tick, no other
    kernel); TICKS replayed ticks equal them bit for bit; a replayed
    roll's kernels, device events and device ms by the profiler;
    env·steps/s with skinning of eager and captured rolls in turns."""
    from fyrox_tpu_torch.animation import skinning
    t = engine.physics
    if t.grid is not None or t.num_bodies != bodies:
        fail(f"{label}: the scene did not take the dense broadphase")
    state0 = distinct_worlds(engine, WORLDS, "cuda", seed=23)
    torch.cuda.synchronize()
    reset_all_launches()
    eager = state0
    t0 = time.perf_counter()
    for _ in range(TICKS):
        eager = engine.step(eager)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / TICKS
    n = all_launches()
    gathers, scatters = dense_launches(t)
    want = dict(fused_bp=0, narrow_compact=0, solve_tgs=0,
                plane_gather=gathers * TICKS, plane_scatter=scatters * TICKS)
    if n != want:
        fail(f"{label}: launches of {TICKS} eager ticks {n}, want {want}")
    rolled = engine.rollout(state0, TICKS)
    torch.cuda.synchronize()
    tick = engine.captured_tick(state0)
    n_leaves = same_state(f"{label} rollout", rolled, eager)
    same_state(f"{label} rollout from the same state again",
               engine.rollout(state0, TICKS), eager)
    n_prof, events, dev_ms = profiled(
        lambda: engine.rollout(rolled, DENSE_PROFILED), DENSE_PROFILED,
        label)
    want_prof = dict(fused_bp=0, narrow_compact=0, solve_tgs=0,
                     plane_gather=gathers * DENSE_PROFILED,
                     plane_scatter=scatters * DENSE_PROFILED)
    if n_prof != want_prof:
        fail(f"{label}: kernels of a replayed roll {n_prof}, want {want_prof}")

    def eager_roll(state):
        for _ in range(TICKS):
            state = engine.step(state)
        return state

    def graph_roll(state):
        return engine.rollout(state, TICKS)

    rates, tick_ms = {}, {}
    for kind, roll in (("eager", eager_roll), ("rollout", graph_roll),
                       ("eager", eager_roll), ("rollout", graph_roll)):
        def skinned(state):
            state = roll(state)
            bm = skinning.bone_matrices(state.scene.globals_, skin)
            return state, skinning.skin_positions_dense(bm, skin)

        state, verts = skinned(rolled)                 # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            state, verts = skinned(state)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        check_state(state, verts, skin)
        live = int((state.physics.warm_n > 0).sum())
        if live == 0:
            fail(f"{label}: no contact slot holds an impulse")
        rates.setdefault(kind, []).append(WORLDS * TICKS * CALLS / elapsed)
        t0 = time.perf_counter()
        roll(state)
        torch.cuda.synchronize()
        tick_ms.setdefault(kind, []).append(
            (time.perf_counter() - t0) * 1e3 / TICKS)
    busy = dev_ms / min(tick_ms["rollout"])
    stages = dense_stages(engine, state)
    log(f"[{label}] stages of an eager tick from the last roll's state, "
        f"device ms (profiler) / device events per call: " + ", ".join(
            f"{k} {v[0]:.3f} / {v[1]:.0f}" for k, v in stages.items())
        + f" on {CARD}")
    log(f"[{label}] {label} scene (dense broadphase: {t.num_bodies} "
        f"bodies, {t.num_pairs} pairs, {t.flat_layout()[1]} contact slots), "
        f"W={WORLDS}: {TICKS} eager ticks launch K4a {gathers} and K4b "
        f"{scatters} times a tick and no other kernel ({eager_ms:.3f} ms a "
        f"tick); {TICKS} replayed ticks equal them bit for bit ({n_leaves} "
        f"state tensors); replayed roll's kernels {n_prof} over "
        f"{DENSE_PROFILED} ticks; env·steps/s with skinning ({CALLS} x "
        f"{TICKS} ticks, eager, rollout, eager, rollout): eager "
        f"{', '.join(f'{r:.1f}' for r in rates['eager'])}, rollout "
        f"{', '.join(f'{r:.1f}' for r in rates['rollout'])}; ms a tick "
        f"without skinning: eager "
        f"{', '.join(f'{m:.3f}' for m in tick_ms['eager'])}, rollout "
        f"{', '.join(f'{m:.3f}' for m in tick_ms['rollout'])}; replayed "
        f"tick: {events:.1f} device events, {dev_ms:.3f} ms of device time,"
        f" busy share {busy:.3f}; {live} contact slots holding an impulse; "
        f"capture "
        f"{tick.capture_seconds:.3f} s, graph pool "
        f"{tick.pool_bytes / 2**20:.1f} MiB on {CARD}")
    return n, rolled


# ---------------------------------------------------------------- terrain
# Hulls, scenery and rays on the card. The terrain flagship: the flagship's
# character and its 1,000-body pile over a 129 x 129 heightfield (64 m
# square, gentle hills) in place of the halfspace, every 8th body a CONVEX
# 12-point cloud and every 8th + 4 a cylinder (slab, staged route). The
# terrain pile: build_flagship()'s 64-body pile over a 33 x 33 heightfield
# (16 m square) and a static 4-triangle trimesh ramp, every 8th body a
# cylinder, every 8th + 2 a CONVEX cloud and every 8th + 4 a cone (dense).
TERRAIN_FLAGSHIP = dict(n_bodies=1000, res=129, size=64.0, ramp=False,
                        kinds={0: 6, 4: 3})            # CONVEX, CYLINDER
TERRAIN_PILE = dict(n_bodies=64, res=33, size=16.0, ramp=True,
                    kinds={0: 3, 2: 6, 4: 4})          # CYLINDER, CONVEX, CONE
# replayed terrain ticks under the profiler: one (~25,000 device events;
# agreed_record profiles it at least twice)
TERRAIN_PROFILED = 1
QUERY_WORLDS = 8       # worlds of the query phase held card vs CPU


def hills(res, size, amp=0.3):
    """Heights [res,res] of gentle hills over a size x size square: two
    crossed sines of wavelength size/4 and size/3, amplitude `amp`."""
    x = np.linspace(-0.5 * size, 0.5 * size, res)
    xx, zz = np.meshgrid(x, x)
    return (0.5 * amp * (np.sin(xx * 8 * np.pi / size + 0.3)
                         + np.cos(zz * 6 * np.pi / size - 0.7))
            ).astype(np.float32)


# a shallow ramp, four triangles fanned round its centre: from y = 0.1 at
# x = -0.5 down to y = -0.3 at x = 1.5, 3 m wide in z, turned 30 degrees
# about +y. An unturned ramp's normals have z = 0 exactly, where the
# solver's tangent basis switches branch (n_z >= 0), and the last bits of a
# normal (XLA fuses multiply-adds, PyTorch does not) then pick the branch.
def _ramp():
    quad = np.asarray([[(-0.5, 0.1, -1.5), (-0.5, 0.1, 1.5), (0.5, -0.1, 0.0)],
                       [(-0.5, 0.1, 1.5), (1.5, -0.3, 1.5), (0.5, -0.1, 0.0)],
                       [(1.5, -0.3, 1.5), (1.5, -0.3, -1.5), (0.5, -0.1, 0.0)],
                       [(1.5, -0.3, -1.5), (-0.5, 0.1, -1.5),
                        (0.5, -0.1, 0.0)]], np.float64)
    c, s = np.cos(np.pi / 6), np.sin(np.pi / 6)
    rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    return (quad @ rot.T).astype(np.float32)


RAMP = _ramp()


def terrain_pile(pb, sb=None, node_type=None, n_bodies=64, res=33,
                 size=16.0, ramp=True, kinds=None, seed=1):
    """The pile of build_pile_scene (same positions and seed) over a
    heightfield at y = -0.4 and, with `ramp`, the trimesh ramp: body i takes
    kinds[i % 8] (6 CONVEX: a 12-point cloud of radius 0.25; 3 CYLINDER
    [0.22, 0.2]; 4 CONE [0.25, 0.22]), else a ball (odd i) or a cuboid.
    pb: either package's PhysicsBuilder; sb / node_type: a SceneBuilder and
    its NodeType to give each body a node (None: standalone bodies).
    Returns pb."""
    rng = np.random.default_rng(seed)
    cloud_rng = np.random.default_rng(seed + 100)
    g = pb.add_body(body_type=1, position=(0.0, -0.4, 0.0))
    pb.add_collider(g, 7, heights=hills(res, size), size=(size, size),
                    friction=0.6)
    if ramp:
        r = pb.add_body(body_type=1)
        pb.add_collider(r, 8, triangles=RAMP, friction=0.5)
    grid = max(int(np.ceil(n_bodies ** (1.0 / 3.0))), 1)
    for i in range(n_bodies):
        gx, gy, gz = i % grid, (i // grid) % grid, i // (grid * grid)
        pos = ((gx - grid / 2) * 0.7 + rng.uniform(-0.05, 0.05),
               0.6 + gy * 0.7,
               (gz - grid / 2) * 0.7 + rng.uniform(-0.05, 0.05))
        node = -1
        if sb is not None:
            node = sb.add_node(f"body{i}", node_type=node_type.RIGID_BODY,
                               position=pos,
                               bbox=(np.full(3, -0.3), np.full(3, 0.3)))
        b = pb.add_body(node=node, position=pos)
        kind = (kinds or {}).get(i % 8)
        if kind == 6:
            pts = cloud_rng.normal(size=(12, 3))
            pts = 0.25 * pts / np.linalg.norm(pts, axis=1, keepdims=True)
            pb.add_collider(b, 6, points=pts, friction=0.5)
        elif kind == 3:
            pb.add_collider(b, 3, [0.22, 0.2], friction=0.5)
        elif kind == 4:
            pb.add_collider(b, 4, [0.25, 0.22], friction=0.5)
        elif i % 2:
            pb.add_collider(b, 0, [0.25], friction=0.5, restitution=0.1)
        else:
            pb.add_collider(b, 1, [0.22, 0.22, 0.22], friction=0.5)
    return pb


def terrain_engine(scene, **build_kw):
    """The port's Engine of a terrain scene (TERRAIN_FLAGSHIP or
    TERRAIN_PILE) with build_flagship()'s character (100 bones, 50,000
    vertices); `build_kw` go to PhysicsBuilder.build. Returns (Engine,
    SkinTemplate)."""
    from fyrox_tpu_torch.models import character
    from fyrox_tpu_torch.physics import PhysicsBuilder
    from fyrox_tpu_torch.scene import NodeType
    sb, aset, mt, bones, skin_data = character.build_character_scene(
        n_bones=100, n_verts=50_000, seed=0)
    pb = terrain_pile(PhysicsBuilder(), sb, NodeType, **scene)
    return character.assemble_flagship(sb, pb.build(**build_kw), aset, mt,
                                       bones, skin_data)


TERRAIN_SMALL = dict(n_bodies=16, res=9, size=6.0, ramp=True,
                     kinds={0: 3, 2: 6, 4: 4})
TERRAIN_SMALL_TICKS = 30
# the terrain flagship's slab windows, as build() arguments. The flagship's
# (12 / 8 / 10, walk 48, 16 active points) drop most of the settling
# pile's demand on the hills (measured on one H100: walk 77, class 0 25,
# active points 35); these cover the demand measured with wide windows
# (walk 98, classes 25 / 15 / 16, active points 36 at W = 2 on the CPU)
TERRAIN_BUILD = dict(broadphase="slab", slab_window=(32, 20, 20),
                     slab_active=48, slab_walk=128)


def card_vs_cpu_steps(label, t, state_cpu, ticks, step,
                      bounds=(5e-4, 5e-3)):
    """Step a state on the card `ticks` times and hold every tick against
    the same tick on the CPU from a copy of the card's state: the largest
    (dp, dv) of one tick, within card_vs_cpu's bounds. For scenes whose
    trajectories part at the float32 rounding level (hull faces on
    scenery: a 1e-7 relative change of the positions grows to ~2e-3 m in
    23 ticks on the CPU alone), where a whole trajectory compares the
    scene's chaos, not the two devices. Returns (dp, dv, live contacts)."""
    from fyrox_tpu_torch import convert
    gpu = convert.physics_state(convert.to_numpy(state_cpu), device="cuda")
    dp = dv = 0.0
    for _ in range(ticks):
        cpu = step(convert.physics_state(convert.to_numpy(gpu),
                                         device="cpu"))
        gpu = step(gpu)
        dp = max(dp, (gpu.position.cpu() - cpu.position).abs().max().item())
        dv = max(dv, (gpu.linvel.cpu() - cpu.linvel).abs().max().item())
    live = int((cpu.warm_pair >= 0).sum() if t.grid is not None
               else (cpu.warm_n > 0).sum())
    if not (dp < bounds[0] and dv < bounds[1] and live > 0):
        fail(f"{label}: card vs CPU dp {dp:.3g}, dv {dv:.3g}, live contact "
             f"points {live}")
    if not all_differ(cpu.position):
        fail(f"{label}: the worlds are equal")
    return dp, dv, live


def phase_terrain_small():
    """The small terrain pile (16 bodies: cylinders, hull clouds, cones,
    balls, cuboids over a 9 x 9 heightfield and the trimesh ramp) on the
    dense and on the slab broadphase at W=4 distinct worlds: every one of
    TERRAIN_SMALL_TICKS card ticks held against the same tick on the CPU
    (card_vs_cpu_steps), within card_vs_cpu's bounds; the dense step
    launches K4a and K4b dense_launches(t) times a tick, the slab step
    (staged route) K1 once a tick, K4a and no fused kernel."""
    from fyrox_tpu_torch.physics import PhysicsBuilder
    from fyrox_tpu_torch.physics import world as phys_mod
    for broadphase in ("dense", "slab"):
        pb = terrain_pile(PhysicsBuilder(), **TERRAIN_SMALL)
        t = pb.build(broadphase=broadphase)
        cpu = jitter(phys_mod.init_physics_state(pb, t, 4, device="cpu"), t,
                     "cpu", seed=4)
        reset_all_launches()
        dp, dv, live = card_vs_cpu_steps(
            f"terrain-small {broadphase}", t, cpu, TERRAIN_SMALL_TICKS,
            lambda s: phys_mod.step_physics(s, t, 1.0 / 60.0))
        n = all_launches()
        if broadphase == "dense":
            g, sc = dense_launches(t)
            want = dict(fused_bp=0, narrow_compact=0, solve_tgs=0,
                        plane_gather=g * TERRAIN_SMALL_TICKS,
                        plane_scatter=sc * TERRAIN_SMALL_TICKS)
            ok = n == want
        else:
            want = "solve_tgs once a tick, K4a, no fused kernel or K4b"
            ok = (n["solve_tgs"] == TERRAIN_SMALL_TICKS
                  and n["plane_gather"] > 0 and n["fused_bp"] == 0
                  and n["narrow_compact"] == 0 and n["plane_scatter"] == 0)
        if not ok:
            fail(f"terrain-small {broadphase}: launches {n}, want {want}")
        log(f"[terrain-small] {broadphase}: {t.num_colliders} colliders, "
            f"card == CPU on each of {TERRAIN_SMALL_TICKS} ticks from the "
            f"card's state (W=4 distinct worlds, {live} live contacts): "
            f"worst dp {dp:.3g} (bound 5e-4), dv {dv:.3g} (bound 5e-3); "
            f"launches {n}")


class GatherSpy:
    """Counts (and with `keep`, keeps) the K4a calls of the main path by
    kind while installed: "heights" (a heightfield's shared [1,4,Rz·Rx]
    corner table), "hulls" (the shared [1,256,C] hull rows), "worlds"
    (per-world planes)."""

    def __init__(self, keep=False):
        from fyrox_tpu_torch.physics import plane_ops
        self.ops, self.keep = plane_ops, keep
        self.count = dict(heights=0, hulls=0, worlds=0)
        self.calls = dict(heights=[], hulls=[], worlds=[])

    @staticmethod
    def kind(planes):
        if planes.shape[0] != 1:
            return "worlds"
        return "heights" if planes.shape[1] == 4 else "hulls"

    def __enter__(self):
        self.orig = self.ops.plane_gather

        def spy(planes, idx):
            k = self.kind(planes)
            self.count[k] += 1
            if self.keep:
                self.calls[k].append((planes, idx))
            return self.orig(planes, idx)

        self.ops.plane_gather = spy
        return self

    def __exit__(self, *exc):
        self.ops.plane_gather = self.orig


def shared_gather_record(name, calls, launches):
    """K4a on a tick's calls of one shared-table kind (W distinct worlds):
    bit-equal to its plain version, two launches bit-equal; the set timed
    against its bound (the table read once, the indices, the output),
    its plain version and torch.gather on the table broadcast over the
    worlds (stride 0, no copy)."""
    from fyrox_tpu_torch.physics import plane_ops
    for planes, idx in calls:
        got, again = (plane_ops.plane_gather(planes, idx) for _ in range(2))
        if not (torch.equal(got, again) and torch.equal(
                got, plane_ops.plane_gather_plain(planes, idx))):
            fail(f"{name}: kernel differs from its plain version or from "
                 f"itself")
    if not all_differ(calls[-1][1]):
        fail(f"{name}: the worlds' indices repeat")
    lib = [(p.expand(i.shape[0], -1, -1), i.long()[:, None, :].expand(
        i.shape[0], p.shape[1], i.shape[1])) for p, i in calls]
    for (p, li), c in zip(lib, calls):
        if not torch.equal(torch.gather(p, 2, li),
                           plane_ops.plane_gather(*c)):
            fail(f"{name}: the torch.gather yardstick disagrees")

    def run(fn, cs):
        return lambda: [fn(*c) for c in cs]

    # device_ms queues its calls behind one spin: keep them within the
    # card's queue of pending launches (~1,000)
    reps = max(1, min(20, 800 // len(calls)))
    ms_k = cuda_ms(run(plane_ops.plane_gather, calls), 20)
    ms_p = cuda_ms(run(plane_ops.plane_gather_plain, calls), 10)
    ms_lib = cuda_ms(run(lambda p, li: torch.gather(p, 2, li), lib), 20)
    dev_k = device_ms(run(plane_ops.plane_gather, calls), reps)
    dev_lib = device_ms(run(lambda p, li: torch.gather(p, 2, li), lib),
                        reps)
    outs = [plane_ops.plane_gather(*c) for c in calls]
    b_ms, b_by = bound_ms(sum(nbytes(p, i, o) for (p, i), o
                              in zip(calls, outs)), 0)
    shapes = sorted({(tuple(p.shape), tuple(i.shape)) for p, i in calls})
    log(f"[terrain-K4a] {name}: a settled terrain tick's {len(calls)} "
        f"calls at {shapes} bit-equal to plain, two launches bit-equal; "
        f"CUDA events over the set: kernel {ms_k:.4f} ms, plain {ms_p:.4f} "
        f"ms, torch.gather {ms_lib:.4f} ms; device time: kernel "
        f"{dev_k:.4f} ms, torch.gather {dev_lib:.4f} ms; bound {b_ms:.4f} "
        f"ms ({b_by}); {launches} launches on the main path on {CARD}")
    return dict(name=name, route="cuda",
                source="fyrox_tpu_torch/csrc/plane_gather.cu",
                replaces="fyrox_tpu/physics/pallas_ops.py:171",
                launches=launches, max_abs_err=0.0, ms=ms_k, plain_ms=ms_p,
                bound_ms=b_ms, bound_by=b_by, library_ms=ms_lib,
                device_ms=dev_k, library_device_ms=dev_lib)


def sync_free_tick(label, engine, state):
    """One eager tick under torch.cuda's sync debug mode "error": a
    synchronising call (a host read, a pageable copy) raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    out = None
    try:
        out = engine.step(state)
    except RuntimeError:
        import traceback
        torch.cuda.set_sync_debug_mode(0)
        fail(f"{label}: an eager tick synchronises with the card:\n"
             + "".join(traceback.format_exc().splitlines(True)[-12:]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out


def skinned_rates(engine, skin, state):
    """env·steps/s with skinning of one eager roll and one Engine.rollout
    roll of TICKS ticks each (the graph captured and the caches warm
    before), and their ms a tick. Returns (rates, tick_ms, the last
    state)."""
    from fyrox_tpu_torch.animation import skinning

    def eager_roll(st):
        for _ in range(TICKS):
            st = engine.step(st)
        return st

    rates, tick_ms = {}, {}
    for kind, roll in (("eager", eager_roll),
                       ("rollout", lambda st: engine.rollout(st, TICKS))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = roll(state)
        bm = skinning.bone_matrices(state.scene.globals_, skin)
        verts = skinning.skin_positions_dense(bm, skin)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        check_state(state, verts, skin)
        rates[kind] = WORLDS * TICKS / elapsed
        tick_ms[kind] = elapsed * 1e3 / TICKS
    return rates, tick_ms, state


def terrain_stages(engine, state, reps=2):
    """Device ms and device events (profiler) per call of an eager
    terrain tick's stages from `state`: the tick, its physics step, the
    step's contacts (slab2.contacts: broadphase, narrowphase, compaction),
    and the contacts again without the hull parts and without the
    scenery parts (the slab context's tables emptied for the
    measurement), whose differences give those parts; the solve and the
    rest of the tick are differences too."""
    from fyrox_tpu_torch.physics import slab2
    from fyrox_tpu_torch.physics import world as phys_mod
    t, dt = engine.physics, engine.dt
    cx = slab2._ctx(t)
    ph = state.physics

    def measure(fn):
        fn()
        torch.cuda.synchronize()
        events, dev = stage_profile(fn, reps)
        return dev, events

    def contacts():
        return slab2.contacts(ph, t, dt)

    out = dict(tick=measure(lambda: engine.step(state)),
               physics=measure(lambda: phys_mod.step_physics(ph, t, dt)),
               contacts=measure(contacts))
    parts, scenery = cx.cx_parts, cx.scenery
    try:
        cx.cx_parts = {}
        no_hulls = measure(contacts)
        cx.cx_parts, cx.scenery = parts, []
        no_scenery = measure(contacts)
    finally:
        cx.cx_parts, cx.scenery = parts, scenery

    def minus(a, b):
        return tuple(x - y for x, y in zip(a, b))

    out["hull parts"] = minus(out["contacts"], no_hulls)
    out["scenery parts"] = minus(out["contacts"], no_scenery)
    out["solve and the step's rest"] = minus(out["physics"], out["contacts"])
    out["rest of the tick"] = minus(out["tick"], out["physics"])
    return out


def phase_terrain(engine, skin):
    """The terrain flagship (slab, staged route) at W distinct worlds
    through the entry points: TICKS eager ticks with the launches counted
    (K1 once a tick, K4a by kind, no fused kernel, no K4b); one more tick
    under sync debug mode; the tick's peak memory; TICKS replayed ticks
    equal the eager ones bit for bit; a replayed roll's kernels, device
    events and device ms (profiler) and the busy share; env·steps/s with
    skinning of eager and captured rolls; K1 on the settled step's packed
    inputs (contacts with hulls and the heightfield, COM planes) and K4a
    at the heights and hull shapes against their plain versions; the
    broadphase audit. Returns (kernel records, the settled state)."""
    from fyrox_tpu_torch import convert
    from fyrox_tpu_torch.physics import fused_step, slab2, tgs_kernel
    from fyrox_tpu_torch.physics import world as phys_mod
    t, dt = engine.physics, engine.dt
    cx = slab2._ctx(t)
    if (t.grid is None or cx.hull_rows is None or not cx.scenery
            or fused_step.supports_fused(t)):
        fail("terrain: the terrain flagship is not a staged slab scene with "
             "hulls and a heightfield")
    state0 = distinct_worlds(engine, WORLDS, "cuda", seed=31)
    torch.cuda.synchronize()
    reset_all_launches()
    eager = state0
    t0 = time.perf_counter()
    with GatherSpy() as spy:
        for _ in range(TICKS):
            eager = engine.step(eager)
        torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / TICKS
    n, per_kind = all_launches(), dict(spy.count)
    if not (n["solve_tgs"] == TICKS and n["fused_bp"] == 0
            and n["narrow_compact"] == 0 and n["plane_scatter"] == 0
            and n["plane_gather"] == sum(per_kind.values())
            and per_kind["heights"] == TICKS and per_kind["hulls"] > 0
            and per_kind["hulls"] % TICKS == 0):
        fail(f"terrain: launches of {TICKS} eager ticks {n}, K4a by kind "
             f"{per_kind}")
    nxt = sync_free_tick("terrain", engine, eager)
    del nxt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    engine.step(eager)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    rolled = engine.rollout(state0, TICKS)
    torch.cuda.synchronize()
    tick = engine.captured_tick(state0)
    n_leaves = same_state("terrain rollout", rolled, eager)
    n_prof, events, dev_ms = profiled(
        lambda: engine.rollout(rolled, TERRAIN_PROFILED), TERRAIN_PROFILED,
        "terrain")
    if not (n_prof["solve_tgs"] == TERRAIN_PROFILED and n_prof["fused_bp"] == 0
            and n_prof["narrow_compact"] == 0
            and n_prof["plane_gather"] == n["plane_gather"] // TICKS
            * TERRAIN_PROFILED):
        fail(f"terrain: kernels of a replayed roll {n_prof}")
    rates, tick_ms, settled = skinned_rates(engine, skin, rolled)
    busy = dev_ms / tick_ms["rollout"]
    live = int((settled.physics.warm_pair >= 0).sum())
    if live == 0:
        fail("terrain: no live contact point after the rolls")
    log(f"[terrain] terrain flagship ({t.num_bodies} bodies, "
        f"{t.num_colliders} colliders: {int((t.col_shape == 6).sum())} "
        f"hulls, {int((t.col_shape == 3).sum())} cylinders, a "
        f"{t.hf_heights.shape[1]} x {t.hf_heights.shape[2]} heightfield; "
        f"windows {t.grid.s_class}, s_active {t.grid.s_active}, walk "
        f"{t.grid.s_walk}), W={WORLDS}: {TICKS} eager ticks launch K1 "
        f"once, K4a {n['plane_gather'] // TICKS} times (heights "
        f"{per_kind['heights'] // TICKS}, hull rows "
        f"{per_kind['hulls'] // TICKS}, per-world "
        f"{per_kind['worlds'] // TICKS}) a tick and no fused kernel "
        f"({eager_ms:.3f} ms a tick); an eager tick makes no synchronising "
        f"call; peak memory of a tick {peak / 2**30:.3f} GiB "
        f"({(peak - base) / 2**30:.3f} GiB above the state); {TICKS} "
        f"replayed ticks equal them bit for bit ({n_leaves} state tensors);"
        f" replayed roll's kernels {n_prof} over {TERRAIN_PROFILED} tick; "
        f"env·steps/s with skinning (a roll of {TICKS} ticks each): eager "
        f"{rates['eager']:.1f}, rollout {rates['rollout']:.1f} "
        f"({tick_ms['eager']:.3f} and {tick_ms['rollout']:.3f} ms a tick); "
        f"replayed "
        f"tick: {events:.1f} device events, {dev_ms:.3f} ms of device time, "
        f"busy share {busy:.3f}; {live} live contact points; capture "
        f"{tick.capture_seconds:.3f} s, graph pool "
        f"{tick.pool_bytes / 2**20:.1f} MiB on {CARD}")

    stages = terrain_stages(engine, settled)
    log(f"[terrain] stages of an eager tick from the settled state, device "
        f"ms (profiler) / device events per call: " + ", ".join(
            f"{k} {v[0]:.3f} / {v[1]:.0f}" for k, v in stages.items())
        + f" on {CARD}")

    # K1 on the settled step's packed inputs
    accel, angvel = phys_mod.external_accelerations(settled.physics, t, dt)
    packed, _ = slab2.solver_inputs(settled.physics, t, dt, accel, angvel)
    params = tgs_kernel.solver_params(t, dt)
    if not (all_differ(packed[0]) and all_differ(packed[2])):
        fail("terrain: the solver's packed inputs repeat across worlds")
    err, errs, ms_k, dev_k, ms_p, b_ms, b_by, visited = k1_against_plain(
        "K1terrain", packed, params, has_com=cx.has_com)
    n_act = int(packed[0][:, 9].sum().item())
    log(f"[K1terrain] solve_tgs (COM planes {cx.has_com}) matches plain on "
        f"a settled terrain-flagship step (W={WORLDS} distinct worlds, "
        f"{n_act} active contact points with hulls and the heightfield): "
        f"{errs}; two launches bit-equal; live slots visited "
        f"{int(visited.sum())}; kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}) on {CARD}")
    k1 = k1_record("solve_tgs_terrain", err, ms_k, dev_k, ms_p, b_ms, b_by)
    k1["launches"] = n["solve_tgs"]

    # K4a at the heights and hull shapes, on one settled tick's calls
    with GatherSpy(keep=True) as spy:
        engine.step(settled)
        torch.cuda.synchronize()
    recs = [k1]
    for kind, name in (("heights", "plane_gather_heights"),
                       ("hulls", "plane_gather_hulls")):
        recs.append(shared_gather_record(name, spy.calls[kind],
                                         per_kind[kind]))

    # broadphase audit: card vs CPU on a few worlds
    ph = settled.physics
    dem = slab2.bp_demand_stats(t, ph)
    ovf = slab2.overflow_stats(t, ph)
    sub = world_slice(ph, 2)
    cpu = convert.physics_state(convert.to_numpy(sub), device="cpu")
    for fn in (slab2.bp_demand_stats, slab2.overflow_stats):
        on_card, on_cpu = fn(t, sub), fn(t, cpu)
        if on_card != on_cpu:
            fail(f"terrain bp-audit: {fn.__name__} card {on_card} vs CPU "
                 f"{on_cpu}")
    cls = "; ".join(
        f"class {c} max {d['max_valid']} / cap {d['cap']} ({d['dropped']} "
        f"dropped; tight max {d['max_tight']}, {d['tight_dropped']} dropped)"
        for c, d in ((c, dem[f"class{c}"]) for c in range(3)) if d["cap"])
    log(f"[terrain-bp-audit] settled terrain flagship (W={WORLDS}): walk max "
        f"{dem['max_walk']} / {dem['s_walk']} ({dem['walk_dropped']} "
        f"dropped); {cls}; active points max {ovf['max_active_points']} / "
        f"s_active {ovf['s_active']} (mean {ovf['mean_active_points']:.3f}, "
        f"{ovf['dropped_points']} dropped; tight max "
        f"{ovf['max_tight_points']}, {ovf['tight_dropped_points']} "
        f"dropped); both equal card vs CPU as integers on 2 worlds")
    return recs, settled


def phase_terrain_dense(engine, skin):
    """The terrain pile (dense) through phase_dense's checks (launches a
    tick, replayed == eager, profiler, rates), one tick under sync debug
    mode, the tick's peak memory, and K4a / K4b on one settled tick's
    calls against their plain versions."""
    n, rolled = phase_dense(engine, skin, label="terrain-dense",
                            bodies=TERRAIN_PILE["n_bodies"] + 2)
    sync_free_tick("terrain-dense", engine, rolled)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.step(rolled)
    torch.cuda.synchronize()
    log(f"[terrain-dense] peak memory of a tick "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; an eager tick "
        f"makes no synchronising call")
    recs = phase_dense_k4(engine, capture_dense_calls(engine, rolled),
                          tag="terrain_dense")
    recs[0]["launches"] = n["plane_gather"]
    recs[1]["launches"] = n["plane_scatter"]
    return recs


def ray_fan(n_side, w, device, height=20.0, spread=0.6, length=25.0):
    """An n_side x n_side fan of rays a world from (0, height, 0) down over
    ±spread of the length: (origin, direction) [w, n_side², 3]."""
    a = np.linspace(-spread, spread, n_side)
    aa, bb = np.meshgrid(a, a)
    d = np.stack([aa, -np.ones_like(aa), bb], -1).reshape(-1, 3) * length
    o = np.broadcast_to(np.array([0.0, height, 0.0]), d.shape)
    def rep(x):
        return torch.as_tensor(np.ascontiguousarray(np.broadcast_to(
            x, (w,) + x.shape)).astype(np.float32), device=device)
    return rep(o), rep(d)


def phase_queries(engine, state):
    """cast_ray (a 16 x 16 fan a world) and sphere_cast (8 x 8, radius
    0.1) on the settled terrain flagship at W worlds: ms a call (CUDA
    events); hits, colliders and bodies equal card vs CPU on QUERY_WORLDS
    worlds, times of impact within 1e-5."""
    from fyrox_tpu_torch import convert
    from fyrox_tpu_torch.physics import queries
    t = engine.physics
    ph = state.physics
    cpu = convert.physics_state(convert.to_numpy(world_slice(
        ph, QUERY_WORLDS)), device="cpu")
    out = []
    for name, n_side, fn in (
            ("cast_ray", 16, lambda s, o, d: queries.cast_ray(s, t, o, d)),
            ("sphere_cast", 8,
             lambda s, o, d: queries.sphere_cast(s, t, o, d, 0.1))):
        o, d = ray_fan(n_side, WORLDS, "cuda")
        got = fn(ph, o, d)
        ms = cuda_ms(lambda: fn(ph, o, d), 5)
        ref = fn(cpu, o[:QUERY_WORLDS].cpu(), d[:QUERY_WORLDS].cpu())
        hit = ref["hit"]
        for k in ("hit", "collider", "body"):
            if not torch.equal(got[k][:QUERY_WORLDS].cpu(), ref[k]):
                fail(f"queries: {name} {k} differs card vs CPU")
        dt = (got["toi"][:QUERY_WORLDS].cpu()[hit] - ref["toi"][hit]).abs()
        if not (int(hit.sum()) > 0 and int((~hit).sum()) > 0
                and float(dt.max()) < 1e-5):
            fail(f"queries: {name} hits {int(hit.sum())}, toi card vs CPU "
                 f"{float(dt.max()):.3g}")
        out.append(f"{name} ({n_side * n_side} rays a world) {ms:.3f} ms a "
                   f"call, {int(got['hit'].sum())} hits of "
                   f"{got['hit'].numel()}, toi card vs CPU "
                   f"{float(dt.max()):.3g}")
    log(f"[queries] settled terrain flagship, W={WORLDS}: " + "; ".join(out)
        + f"; hits, colliders and bodies equal card vs CPU on "
        f"{QUERY_WORLDS} worlds on {CARD}")


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
K5_OPS_AFFINE = 24   # w0, w1 and z forms, w2, six tests, four selects


def render_scene(n_worlds, device, seed=0):
    """The bench scene (bench_render.py:31-72: features_frame with no
    feature) with its render template and the bench's config, W worlds
    whose mesh nodes are moved by seeded jitter (±5 cm), so that no two
    worlds render the same images."""
    from fyrox_tpu_torch.render import RenderConfig
    t, rt, st, _ = features_frame(n_worlds, device, features=frozenset(),
                                  seed=seed)
    cfg = RenderConfig(width=RENDER_SIZE, height=RENDER_SIZE, shadows=True,
                       cascade_tri_budget=(0.05, 1.0, 0.75), k_per_tile=424,
                       csm_k_per_tile=896)
    return t, rt, st, cfg


# The features frame: the bench scene plus every feature of render_frame
# (textured ground and cubes, a spot and a point light with shadow maps,
# HZB occlusion, transparent panes, sprites, decals, a LOD group,
# rectangles, light shafts and a skybox), rendered in both raster modes.
FEATURES = ("textures", "spot", "point", "occlusion", "transparent",
            "sprites", "decals", "lod", "rectangles", "shafts", "skybox",
            "gradient", "clipped")
FEATURES_FRAME = frozenset(FEATURES) - {"gradient", "clipped"}
# bin caps that no pass of the full-width features frame reaches (its
# render-features audit prints the demand against them). The spot and
# point maps bin a caster that is not wholly in front of the light's plane
# into every tile (its 2DH bbox is the whole map, as in the JAX package),
# so their demand nears T (4,718 rows) and k_per_tile exceeds T: those
# passes, the camera pass and the prepass bin at min(k_per_tile, rows)
FEATURES_CAPS = dict(k_per_tile=8192, csm_k_per_tile=1024)


def render_lib():
    """The port's render builders, as features_scene takes them."""
    import types
    from fyrox_tpu_torch import render
    from fyrox_tpu_torch.scene import SceneBuilder
    return types.SimpleNamespace(
        SceneBuilder=SceneBuilder, make_plane=render.make_plane,
        make_cube=render.make_cube, make_sphere=render.make_sphere,
        Texture=render.Texture, Material=render.Material,
        SkyBox=render.SkyBox, gradient_faces=render.gradient_faces)


def features_scene(lib, features=FEATURES_FRAME, n_obj=64, tex_size=256,
                   n_sprites=16, seed=0, generic=False):
    """The bench scene (render_scene's: a 40 m ground, n_obj cubes and
    spheres, one directional light, the bench camera) plus the parts of
    `features` (names from FEATURES), built with either package's builders
    (`lib`, as render_lib()): "textures" a tex_size² albedo and a
    metallic-roughness texture on the ground (numpy, from `seed`) and 4
    cubes whose Material binds the albedo as "diffuseTexture"; "spot" /
    "point" a spot and a point light with radii; "transparent" 4 panes at
    alpha 0.4; "sprites" n_sprites billboards; "decals" 2 decals; "lod" a
    LOD group (a cube near, a sphere far, at the camera's distance); and
    "rectangles" 2 rectangles, one textured. `generic` gives every
    triangle a back-face determinant far from rounding noise, so that two
    packages decide each triangle's validity alike (the cubes turn by
    seeded rotations, the spheres lose their zero-area pole triangles,
    the directional light tilts about a generic axis)."""
    rng = np.random.default_rng(seed)
    turn = np.random.default_rng(7)
    sb = lib.SceneBuilder()

    def cube(size, **kw):
        q = turn.standard_normal(4) if generic else None
        return lib.make_cube(size, **kw), (
            None if q is None else tuple(q / np.linalg.norm(q)))

    def sphere(**kw):
        m = lib.make_sphere(0.5, slices=8, stacks=8, **kw)
        if generic:
            p = m.positions[m.triangles]
            area = np.linalg.norm(np.cross(p[:, 1] - p[:, 0],
                                           p[:, 2] - p[:, 0]), axis=-1)
            m.triangles = m.triangles[area > 1e-6]
        return m

    ground = {}
    tex = None
    if "textures" in features or "rectangles" in features:
        tex = lib.Texture.from_array(rng.uniform(
            0.3, 1.0, (tex_size, tex_size, 3)).astype(np.float32))
    if "textures" in features:
        ground = dict(albedo_texture=tex, mr_texture=lib.Texture.from_array(
            rng.uniform(0.2, 1.0, (tex_size, tex_size, 3)).astype(
                np.float32)))
    sb.add_mesh(lib.make_plane(40.0, albedo=(0.5, 0.5, 0.5), **ground),
                name="ground")
    pos = np.random.default_rng(0)
    for i in range(n_obj):
        x, z = pos.uniform(-10, 10, 2)
        if i % 2:
            m, q = cube(1.0, albedo=(0.7, 0.3, 0.2))
            sb.add_mesh(m, position=(x, 0.5, z), rotation=q)
        else:
            sb.add_mesh(sphere(albedo=(0.2, 0.4, 0.7)), position=(x, 0.5, z))
    tilt = (np.sin(np.pi / 3), 0.0, 0.0, np.cos(np.pi / 3))
    if generic:
        axis = np.array([1.0, 0.3, 0.2]) / np.linalg.norm([1.0, 0.3, 0.2])
        tilt = tuple(np.append(axis * np.sin(0.55), np.cos(0.55)))
    sb.add_light("directional", rotation=tilt, intensity=2.0)
    down = (np.sin(np.pi / 4), 0.0, 0.0, np.cos(np.pi / 4))   # +Z → -Y
    if "textures" in features:
        mat = lib.Material(albedo=(0.9, 0.9, 0.9)).bind("diffuseTexture",
                                                        tex)
        for i in range(4):
            m, q = cube(1.2, material=mat)
            sb.add_mesh(m, position=(-6.0 + 4.0 * i, 0.6, -4.0), rotation=q)
    if "spot" in features:
        sb.add_light("spot", position=(2.0, 6.0, -2.0), rotation=down,
                     color=(1.0, 0.9, 0.7), radius=20.0,
                     hotspot=np.deg2rad(50.0), intensity=3.0)
    if "point" in features:
        sb.add_light("point", position=(-3.0, 3.0, 1.0),
                     color=(0.6, 0.8, 1.0), radius=15.0, intensity=3.0)
    if "transparent" in features:
        stand = (np.sin(-np.pi / 4), 0.0, 0.0, np.cos(-np.pi / 4))
        for i in range(4):
            sb.add_mesh(lib.make_plane(2.0, albedo=(0.3, 0.9, 0.4),
                                       alpha=0.4),
                        position=(-5.0 + 3.3 * i, 1.2, -7.0), rotation=stand)
    if "sprites" in features:
        for i in range(n_sprites):
            x, z = rng.uniform(-8, 8, 2)
            sb.add_sprite(position=(x, 2.0 + rng.uniform(0, 2), z),
                          size=0.3, color=tuple(rng.uniform(0.3, 1.0, 3)))
    if "decals" in features:
        for i, col in enumerate(((1.0, 0.2, 0.2), (0.2, 0.2, 1.0))):
            sb.add_decal(position=(-3.0 + 6.0 * i, 0.0, -2.0),
                         scale=(4.0, 2.0, 4.0), color=col, strength=0.8)
    if "lod" in features:
        m, q = cube(1.0, albedo=(0.9, 0.9, 0.2))
        near = sb.add_mesh(m, position=(1.5, 0.5, -6.0), rotation=q)
        far = sb.add_mesh(sphere(albedo=(0.9, 0.2, 0.9)),
                          position=(1.5, 0.5, -6.0))
        # the bench camera sits 11.07 m away, (11.07 - 0.025) / (2048 -
        # 0.025) = 0.00539: the near cube, which a camera 0.02 m farther
        # off trades for the far sphere
        sb.add_lod_group([(0.0, 0.0054, [near]), (0.0054, 1.0, [far])])
    if "rectangles" in features:
        face = (0.0, 1.0, 0.0, 0.0)          # +Z turned to face the camera
        sb.add_rectangle(position=(-2.5, 2.5, 4.0), scale=(3.0, 2.0, 1.0),
                         rotation=face, color=(1.0, 0.8, 0.6), texture=tex,
                         uv_rect=(0.0, 0.0, 0.5, 0.5))
        sb.add_rectangle(position=(2.5, 2.5, 4.0), scale=(2.0, 2.0, 1.0),
                         rotation=face, color=(0.4, 0.7, 1.0))
    look_down = (np.sin(np.pi / 8), 0.0, 0.0, np.cos(np.pi / 8))
    sb.add_camera("cam", position=(0, 8.0, -14.0), rotation=look_down)
    return sb.build()


def features_config(lib, features=FEATURES_FRAME, size=RENDER_SIZE):
    """The RenderConfig keywords of `features` at size x size (either
    package's config takes them; the JAX package's also wants its
    use_pallas / pallas_interpret / bin_mode): the bench's CSM and
    budgets, FEATURES_CAPS, and the switches of `features` ("occlusion",
    "spot" / "point" maps, "shafts", "skybox", "gradient", "clipped")."""
    kw = dict(width=size, height=size, shadows=True,
              cascade_tri_budget=(0.05, 1.0, 0.75), **FEATURES_CAPS)
    if "occlusion" in features:
        kw.update(occlusion=True, occlusion_size=64, occluder_quantile=0.75)
    if "spot" in features:
        kw.update(spot_shadows=True, spot_shadow_size=128)
    if "point" in features:
        kw.update(point_shadows=True, point_shadow_size=64)
    if "shafts" in features:
        kw.update(light_shafts=True)
    if "skybox" in features:
        kw.update(skybox=lib.SkyBox(lib.gradient_faces(
            (0.15, 0.3, 0.7), (0.8, 0.8, 0.75), size=16)))
    if "gradient" in features:
        kw.update(sky_zenith=(0.1, 0.2, 0.5), sky_horizon=(0.7, 0.7, 0.7))
    if "clipped" in features:
        kw.update(raster_mode="clipped")
    return kw


def capture_k5_calls(t, rt, st, cfg):
    """Every K5 call of one frame, as (args, depth_only, affine), in the
    frame's order (launches made here are not counted)."""
    from fyrox_tpu_torch.render import render_frame, tile_raster
    seen = []
    dispatch = tile_raster.visibility

    def spy(*args, **kw):
        seen.append((args, kw.get("depth_only", False),
                     kw.get("affine", False)))
        return dispatch(*args, **kw)

    tile_raster.visibility = spy
    try:
        render_frame(st, t, rt, cfg)
    finally:
        tile_raster.visibility = dispatch
    torch.cuda.synchronize()
    return seen


def capture_k5_inputs(t, rt, st, cfg):
    """The (args, depth_only) of one frame's K5 calls (kernel_ab.py's
    view of capture_k5_calls)."""
    return [(a, d) for a, d, _ in capture_k5_calls(t, rt, st, cfg)]


def k5_covered_pairs(feats, ids, count, height, width, tile_h, tile_w,
                     affine=False):
    """The (pixel, walked slot) pairs whose e0, e1, e2 >= 0 (w0, w1, w2 >=
    0 for affine rows), by visibility_plain's arithmetic on the same
    inputs: the pairs that any implementation of K5 has to finish."""
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

        e0, e1 = aff(0), aff(3)
        e2 = (1.0 if affine else aff(6)) - e0 - e1
        total += int(((e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (j < cnt)).sum())
    return total


def k5_bytes(feats, ids, count, outs, affine=False):
    """The bytes K5 has to move: each tile's count and the ids of the slots
    it walks read once, the columns of each feature row that some tile of
    its image walks read once (16 for 2DH rows, the first 10 of affine
    ones: w0, w1 and z forms and the ok flag), the outputs written once."""
    b, t = feats.shape[:2]
    walked = torch.arange(ids.shape[-1], device=ids.device) < count[..., None]
    img = torch.arange(b, device=ids.device).reshape(b, 1, 1) * t
    rows = torch.unique((ids.long() + img)[walked]).numel()
    cols = 10 if affine else feats.shape[2]
    return (nbytes(count, *outs) + int(walked.sum()) * ids.element_size()
            + rows * cols * feats.element_size())


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


def k5_knife_edges_affine(height=16, width=256, tile_h=8, tile_w=128,
                          n_img=2, n_rows=150, seed=0, device="cpu"):
    """k5_knife_edges for K5's affine variant: screen-affine rows (w0, w1,
    z forms, ok in column 9) written from half-integers and powers of two,
    so that every form rounds exactly: w0 and w1 zero on pixel centres on
    the warp rectangles' borders and the tiles' outer rows and columns,
    w2 = (1 - w0) - w1 zero on diagonals through centres, z ranges that
    cross -1 or 1 inside a tile, rows whose ok flag is 0 nearest the
    camera, negative-zero coefficients and z ties (+0 against -0 among
    them). Each tile walks its rows in its own seeded order; one tile
    walks none."""
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

    sc = 2.0 ** -9                      # w0, w1 < 1 over a 256-px image
    feats = np.zeros((n_img, n_rows, 16), np.float32)
    for b in range(n_img):
        z_seen = []
        for r in range(n_rows):
            cx, cy = centre(xs, width), centre(ys, height)
            sx, sy = rng.choice([-1.0, 1.0], 2) * sc
            kind = int(rng.integers(0, 3))
            if kind == 0:                  # a quadrant corner at (cx, cy)
                w0, w1 = (sx, nz(), -sx * cx), (nz(), sy, -sy * cy)
            elif kind == 1:                # w2 = 0 on a diagonal
                d = 2.0 ** -int(rng.integers(3, 6))
                w0, w1 = (d, nz(), -d * cx), (nz(), d, -d * cy)
            else:                          # a vertical strip, w2 >= 0
                w0 = (sx, nz(), -sx * cx)
                w1 = (nz(), nz(), float(rng.choice([0.0, 0.25, 0.5])))
            z0 = (float(rng.choice(z_seen)) if z_seen and rng.random() < 0.2
                  else float(rng.choice([0.0, -0.0])) if rng.random() < 0.1
                  else float(rng.uniform(-0.9, 0.9)))
            if kind == 1 and rng.random() < 0.5:     # diagonals in front
                z0 = float(rng.uniform(-0.98, -0.9))
            z_seen.append(z0)
            zr = (float(rng.choice([0.0, -0.0, 2.0 ** -10])), nz(), z0)
            ok = 1.0
            special = rng.random()
            if special < 0.1:              # not ok, nearest, covering
                ok, zr = 0.0, (0.0, 0.0, -0.99)
            elif special < 0.25:           # z crosses -1 or 1 in the image
                zr = (float(rng.choice([-1.0, 1.0])) * 2.0 ** -6, nz(),
                      float(rng.choice([-1.0, 1.0])) - cx * 2.0 ** -6)
            feats[b, r, :10] = (*w0, *w1, *zr, ok)
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


def k5_variant(depth_only, affine):
    return ("K5clip " if affine else "K5") + ("depth" if depth_only
                                              else "full")


def hold_k5(label, calls):
    """Every K5 call of `calls` (capture_k5_calls' (args, depth_only,
    affine)) launched twice and held bit for bit against its plain version
    on the same inputs (z, and idx, w0, w1 where full), each at the shape
    the frame gave it. Returns the number of calls held."""
    from fyrox_tpu_torch.render import tile_raster
    seen = []
    for args, depth_only, affine in calls:
        feats, ids, count, h, w, th, tw = args
        name = k5_variant(depth_only, affine)
        kw = dict(depth_only=depth_only, affine=affine)
        got = tile_raster._visibility_cuda(*args, **kw)
        torch.cuda.synchronize()
        parts, span = tile_raster.split_parts()
        again = tile_raster._visibility_cuda(*args, **kw)
        ref = tile_raster.visibility_plain(*args, **kw)
        got, again, ref = ((x,) if depth_only else x
                           for x in (got, again, ref))
        shape = (f"{name} {feats.shape[0]} images of {h}x{w}, tiles "
                 f"{th}x{tw}, {feats.shape[1]} rows, K={ids.shape[2]}, max "
                 f"count {int(count.max())}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{label}: {shape}: two launches on the same inputs differ")
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            diffs = [int((a != b).sum()) for a, b in zip(got, ref)]
            fail(f"{label}: {shape}: kernel differs from its plain version "
                 f"at {diffs} entries")
        hit = float((got[0] < 1e8).float().mean())
        if hit <= 0.0:
            fail(f"{label}: {shape}: no pixel hit")
        seen.append(f"{shape}, {int((count > span).sum())} tiles split into "
                    f"{parts} parts, {hit:.3f} hit")
    log(f"[{label}] {len(seen)} K5 calls bit-equal to plain, two launches "
        f"each equal: " + "; ".join(seen))
    return len(seen)


def phase_k5(calls, depth_only, affine=False):
    """One K5 variant vs its plain version at the main path's shapes: every
    call of the variant among a frame's K5 calls (capture_k5_calls, held by
    hold_k5) and the knife-edge inputs, bit for bit, twice; the first call
    timed against its bound."""
    from fyrox_tpu_torch.render import tile_raster
    label = k5_variant(depth_only, affine)
    mine = [c for c in calls if c[1] == depth_only and c[2] == affine]
    hold_k5(label, mine)
    args = mine[0][0]
    feats, ids, count, h, w, th, tw = args
    if not all_differ(feats):
        fail(f"{label}: the images' feature rows repeat")

    def kernel(a=args):
        return tile_raster._visibility_cuda(*a, depth_only=depth_only,
                                            affine=affine)

    def plain(a=args):
        return tile_raster.visibility_plain(*a, depth_only=depth_only,
                                            affine=affine)

    got = kernel()
    torch.cuda.synchronize()
    parts, span = tile_raster.split_parts()
    got = (got,) if depth_only else got
    z = got[0]
    hit = float((z < 1e8).float().mean())
    if not (all_differ(z) and hit > 0.05):
        fail(f"{label}: images repeat, or {hit:.3f} of pixels hit")
    edges = (k5_knife_edges_affine if affine else k5_knife_edges)(
        device="cuda")
    got_e, ref_e = ((x,) if depth_only else x
                    for x in (kernel(edges), plain(edges)))
    if not all(torch.equal(a, b) for a, b in zip(got_e, ref_e)):
        fail(f"{label}: kernel differs from its plain version on the "
             f"knife-edge inputs")
    ms_k = cuda_ms(kernel, 20)
    dev_k = device_ms(kernel, 20)
    ms_p = cuda_ms(plain, 2)
    walked = int(count.sum())
    covered = k5_covered_pairs(*args, affine=affine)
    moved = k5_bytes(feats, ids, count, got, affine=affine)
    ops = K5_OPS_AFFINE if affine else K5_OPS
    b_ms, b_by = bound_ms(moved, covered * ops)
    old_ms, _ = bound_ms(0, walked * th * tw * ops)
    cnt = count.flatten().float()
    log(f"[{label}] tile_raster {'affine ' if affine else ''}"
        f"{'depth-only' if depth_only else 'full'} bit-equal to plain "
        f"(z{'' if depth_only else ', idx, w0, w1'}) on its {len(mine)} "
        f"calls (above) and on the knife-edge inputs; timed on the first, "
        f"{feats.shape[0]} distinct images of {h}x{w} ({feats.shape[1]} "
        f"rows), K={ids.shape[2]}: {walked} walked "
        f"slots (per tile mean {float(cnt.mean()):.1f}, p99 "
        f"{float(cnt.quantile(0.99)):.0f}, max {int(cnt.max())}), "
        f"{covered} covered (pixel, slot) pairs of {walked * th * tw} "
        f"walked, {int((count > span).sum())} tiles above {span} slots "
        f"split into {parts} parts, {hit:.3f} of pixels hit; two launches "
        f"bit-equal; kernel {ms_k:.4f} ms (device time {dev_k:.4f}), plain "
        f"{ms_p:.3f} ms, bound {b_ms:.4f} ms ({b_by}: {moved} bytes moved, "
        f"covered pairs x {ops} ops; walked pairs x {ops} ops would read "
        f"{old_ms:.4f}) on {CARD}")
    return dict(name="tile_raster_" + ("depth" if depth_only else "full")
                + ("_affine" if affine else ""),
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


def features_frame(n_worlds, device, size=RENDER_SIZE,
                   features=FEATURES_FRAME, seed=0, **scene_kw):
    """(template, render template, state, config) of the features frame:
    features_scene at full width unless asked otherwise, W worlds whose
    mesh nodes are jittered ±5 cm from `seed`, as render_scene's."""
    from fyrox_tpu_torch.render import (CsmConfig, RenderConfig,
                                        build_render_template)
    from fyrox_tpu_torch.scene import NodeType, graph, init_state
    lib = render_lib()
    t = features_scene(lib, features, **scene_kw)
    st = init_state(t, n_worlds, device=device)
    mesh = torch.as_tensor(t.node_type == NodeType.MESH, device=device)
    noise = np.random.default_rng(seed).uniform(
        -0.05, 0.05, tuple(st.position.shape)).astype(np.float32)
    st = st._replace(position=st.position + torch.as_tensor(
        noise, device=device) * mesh[None, :, None].float())
    st = graph.update_hierarchical_data(st, t)
    kw = features_config(lib, features, size)
    csm = CsmConfig() if size == RENDER_SIZE else CsmConfig(map_size=64)
    return t, build_render_template(t), st, RenderConfig(csm=csm, **kw)


def phase_render_features_small():
    """W = 2 at 32 x 32: each feature alone and all together (both raster
    modes), the card against the CPU from the same state, at the
    whole-frame bar (99.9 % of the colour values within 1e-4, every value
    within 2e-3) with the same caps."""
    from fyrox_tpu_torch import convert
    from fyrox_tpu_torch.render import render_frame_demand
    cases = [(f,) for f in FEATURES] + [tuple(FEATURES_FRAME),
                                        tuple(FEATURES_FRAME) + ("clipped",)]
    worst = 0.0
    for feats in cases:
        feats = frozenset(feats) | ({"occlusion"} if feats == ("clipped",)
                                    else set())
        t, rt, st, cfg = features_frame(2, "cpu", size=32, features=feats,
                                        seed=3, n_obj=8, tex_size=32,
                                        n_sprites=4)
        gpu = convert.scene_state(convert.to_numpy(st), device="cuda")
        cpu_color, _, caps = render_frame_demand(st, t, rt, cfg)
        gpu_color, _, gpu_caps = render_frame_demand(gpu, t, rt, cfg)
        err = (gpu_color.cpu() - cpu_color).abs()
        frac = float((err <= 1e-4).float().mean())
        if not (frac >= 0.999 and float(err.max()) <= 2e-3
                and caps == gpu_caps and float(cpu_color.abs().sum()) > 0
                and bool(torch.isfinite(gpu_color).all())):
            fail(f"render-features-small {sorted(feats)}: card vs CPU "
                 f"colours {float(err.max()):.3g} max, {frac:.5f} within "
                 f"1e-4; caps {gpu_caps} vs {caps}")
        worst = max(worst, float(err.max()))
    log(f"[render-features-small] {len(cases)} frames (each of "
        f"{len(FEATURES)} features alone, all together in both modes), 2 "
        f"worlds, 32x32: card == CPU, colours max {worst:.3g}")


def phase_render_features(t, rt, st, cfg):
    """The full-width features frame in both raster modes: the bin-demand
    audit (no pass at its cap), RENDER_FRAMES timed frames after a
    warm-up with K5's launches by variant, then the profiler's device
    events, device ms and busy share per frame. Returns the launches of
    the clipped mode's timed frames."""
    from torch.profiler import ProfilerActivity, profile
    from fyrox_tpu_torch.render import (render_frame, render_frame_demand,
                                        tile_raster)
    out = {}
    for mode in ("homogeneous", "clipped"):
        c = cfg._replace(raster_mode=mode)
        _, demand, caps = render_frame_demand(st, t, rt, c)
        dmax = [int(d) for d in demand.max(0).values.tolist()]
        over = [(p, d, k) for p, (d, k) in enumerate(zip(dmax, caps))
                if d >= k]
        if over or len(caps) != 12:
            fail(f"render-features {mode}: bin overflow (pass, demand, cap) "
                 f"{over} of {len(caps)} passes")
        color, gbuf = render_frame(st, t, rt, c)              # warm-up
        torch.cuda.synchronize()
        tile_raster.reset_launches()
        t0 = time.perf_counter()
        for _ in range(RENDER_FRAMES):
            color, gbuf = render_frame(st, t, rt, c)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        n = dict(tile_raster._LAUNCHES)
        affine = mode == "clipped"
        want = dict(full=0 if affine else 1, depth=3 if affine else 4,
                    full_affine=1 if affine else 0,
                    depth_affine=1 if affine else 0)
        if n != {k: v * RENDER_FRAMES for k, v in want.items()}:
            fail(f"render-features {mode}: K5 launches {n} in "
                 f"{RENDER_FRAMES} frames, want {want} a frame")
        cover = float(gbuf.mask.float().mean())
        if not (tuple(color.shape) == (RENDER_WORLDS, RENDER_SIZE,
                                       RENDER_SIZE, 3)
                and bool(torch.isfinite(color).all()) and cover > 0.1
                and all_differ(color)):
            fail(f"render-features {mode}: colour {tuple(color.shape)}, "
                 f"coverage {cover}, not finite or worlds equal")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(RENDER_PROFILED):
                render_frame(st, t, rt, c)
            torch.cuda.synchronize()
        events, busy_us = device_events(prof)
        frame_ms = elapsed * 1e3 / RENDER_FRAMES
        fps = RENDER_WORLDS * RENDER_FRAMES / elapsed
        busy_ms = busy_us / 1e3 / RENDER_PROFILED
        top = sorted(((e.key, e.device_time_total / 1e3 / RENDER_PROFILED)
                      for e in prof.key_averages()
                      if getattr(e, "device_time_total", 0) > 0),
                     key=lambda kv: -kv[1])[:5]
        log(f"[render-features] {mode}, T={rt.num_triangles} (+"
            f"{2 * rt.sprite_node.shape[0]} sprite triangles), W="
            f"{RENDER_WORLDS}, {RENDER_SIZE}x{RENDER_SIZE}: bin demand max "
            f"/ cap per pass (prepass, camera, cascades 0-2, spot, point "
            f"faces 0-5) {list(zip(dmax, caps))}; {fps:.1f} frames/s, "
            f"{frame_ms:.3f} ms per frame of all worlds; K5 launches per "
            f"frame {want}; {len(events) / RENDER_PROFILED:.1f} device "
            f"events and {busy_ms:.3f} ms of device time per frame (busy "
            f"share {busy_ms / frame_ms:.3f}); top device ms per frame: "
            + ", ".join(f"{k[:40]} {v:.3f}" for k, v in top)
            + f"; coverage {cover:.3f} on {CARD}")
        out[mode] = n
    return out["clipped"]


# ---------------------------------------------------------------- captured
# render.CapturedFrame: one CUDA graph a frame. The K5 wrappers count the
# capture's warm-up and capture; a replay's K5 launches come from the
# profiler's kernel names.
def same_frame(label, got, want):
    """Fail unless two (colour, GBuffer) results are equal bit for bit;
    returns the number of tensors held."""
    a = [got[0], *got[1]]
    b = [want[0], *want[1]]
    bad = [i for i, (x, y) in enumerate(zip(a, b))
           if (x is None) != (y is None)
           or (x is not None and (x.shape != y.shape
                                  or not torch.equal(x, y)))]
    if bad:
        fail(f"{label}: {len(bad)} of {len(b)} outputs differ from eager "
             f"render_frame (colour and GBuffer fields {bad})")
    return sum(x is not None for x in b)


def moved_state(st, seed):
    """The state with every node's global translation moved by seeded
    noise (±5 cm): another frame of the same shapes."""
    noise = np.random.default_rng(seed).uniform(
        -0.05, 0.05, tuple(st.globals_.shape[:2]) + (3,)).astype(np.float32)
    g = st.globals_.clone()
    g[..., :3, 3] += torch.as_tensor(noise, device=st.globals_.device)
    return st._replace(globals_=g)


def k5_profiled(events):
    """K5 walk launches by variant name among profiler kernel events (the
    template arguments <DEPTH_ONLY, AFFINE> of tile_raster_kernel), and
    the plan kernel's launches."""
    n = {k: 0 for k in ("full", "depth", "full_affine", "depth_affine",
                        "plan")}
    for e in events:
        if "tile_raster_plan" in e.name:
            n["plan"] += 1
        elif "tile_raster_kernel<" in e.name:
            args = e.name.split("tile_raster_kernel<", 1)[1].split(">")[0]
            depth, affine = (a.strip() in ("true", "1", "(bool)1")
                             for a in args.split(","))
            n[("depth" if depth else "full")
              + ("_affine" if affine else "")] += 1
    return n


def frame_launches(cfg, rt):
    """K5 launches of one frame by variant, as the pipeline issues them."""
    from fyrox_tpu_torch.render.lighting import DIRECTIONAL, POINT, SPOT
    affine = cfg.raster_mode == "clipped"
    kinds = set(int(k) for k in rt.light_kind)
    maps = cfg.shadows * ((DIRECTIONAL in kinds)
                          + (cfg.spot_shadows and SPOT in kinds)
                          + (cfg.point_shadows and POINT in kinds))
    n = dict(full=0, depth=maps, full_affine=0, depth_affine=0)
    n["full_affine" if affine else "full"] += 1
    if cfg.occlusion:
        n["depth_affine" if affine else "depth"] += 1
    return n


def phase_render_captured(bench, feat):
    """render.CapturedFrame on the bench frame and the features frame in
    both raster modes at full width: counted launches, bit-equal replays,
    the replayed frame's device events, device ms and K5 launches, frames/s
    of replays against eager frames, capture seconds and pool bytes; then
    a freed graph captured again. Returns K5's replayed launches a frame
    by variant, per case."""
    import gc
    from fyrox_tpu_torch.render import (CapturedFrame, render_frame,
                                        tile_raster)
    t_f, rt_f, st_f, cfg_f = feat
    cases = [("bench", *bench),
             ("features homogeneous", t_f, rt_f, st_f,
              cfg_f._replace(raster_mode="homogeneous")),
             ("features clipped", t_f, rt_f, st_f,
              cfg_f._replace(raster_mode="clipped"))]
    frames, replayed = {}, {}
    for label, t, rt, st, cfg in cases:
        frame = CapturedFrame(t, rt, cfg)
        tile_raster.reset_launches()
        got = frame(st)                              # warm-up + capture
        torch.cuda.synchronize()
        counted = dict(tile_raster._LAUNCHES)
        per = frame_launches(cfg, rt)
        if counted != {k: 2 * v for k, v in per.items()} or not any(
                counted.values()):
            fail(f"render-captured {label}: K5 counted {counted} at the "
                 f"capture, want twice a frame's {per}")
        n_out = same_frame(f"render-captured {label}", got,
                           render_frame(st, t, rt, cfg))
        other = moved_state(st, 5)
        same_frame(f"render-captured {label}, another state", frame(other),
                   render_frame(other, t, rt, cfg))
        fg = frame.graph(st)
        frame(st)
        torch.cuda.synchronize()
        events, busy_us, n = agreed_record(
            f"render-captured {label}",
            lambda: [fg.graph.replay() for _ in range(RENDER_PROFILED)],
            k5_profiled)
        walk = {k: n[k] // RENDER_PROFILED for k in per}
        if walk != per or any(n[k] % RENDER_PROFILED for k in per):
            fail(f"render-captured {label}: K5 launches of "
                 f"{RENDER_PROFILED} replays {n}, want {per} a frame")
        replayed[label] = dict(walk, plan=n["plan"] / RENDER_PROFILED)
        dev_ms = busy_us / 1e3 / RENDER_PROFILED
        rates = {}
        for kind in ("eager", "captured", "eager", "captured"):
            fn = ((lambda: render_frame(st, t, rt, cfg)) if kind == "eager"
                  else (lambda: frame(st)))
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(RENDER_FRAMES):
                fn()
            torch.cuda.synchronize()
            rates.setdefault(kind, []).append(
                RENDER_WORLDS * RENDER_FRAMES / (time.perf_counter() - t0))
        frame_ms = RENDER_WORLDS * 1e3 / max(rates["captured"])
        log(f"[render-captured] {label}, W={RENDER_WORLDS}, "
            f"{cfg.width}x{cfg.height}: replays equal eager render_frame bit "
            f"for bit ({n_out} outputs, two states); K5 counted at the "
            f"capture {counted}; a replayed frame: "
            f"{len(events) / RENDER_PROFILED:.1f} device events, "
            f"{dev_ms:.3f} ms of device time (busy share "
            f"{dev_ms / frame_ms:.3f} of the fastest replayed frame, "
            f"{frame_ms:.3f} ms with the copy-in and clone-out), K5 launches "
            f"{replayed[label]}; frames/s (eager, captured, eager, captured) "
            f"eager {', '.join(f'{r:.1f}' for r in rates['eager'])}, "
            f"captured {', '.join(f'{r:.1f}' for r in rates['captured'])}; "
            f"capture {fg.capture_seconds:.3f} s, graph pool "
            f"{fg.pool_bytes / 2**20:.1f} MiB on {CARD}")
        frames[label] = (frame, t, rt, st, cfg)
    # free the bench frame's graph, capture it again while the features
    # graphs live: each graph keeps a K5 scratch of its own, none of which
    # the stream-keyed cache holds, and every graph replays as eager does
    _, t, rt, st, cfg = frames["bench"]
    del frames["bench"]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    frames["bench again"] = (CapturedFrame(t, rt, cfg), t, rt, st, cfg)
    frames["bench again"][0](st)
    owned = []
    for label, (frame, t, rt, st, cfg) in frames.items():
        other = moved_state(st, 9)
        same_frame(f"render-captured {label} after a recapture",
                   frame(other), render_frame(other, t, rt, cfg))
        fg = frame.graph(other)
        if fg.scratch is not None:
            owned.append(fg.scratch[0].data_ptr())
    cached = {v[0].data_ptr() for v in tile_raster._SCRATCH.values()}
    if len(set(owned)) != len(owned) or cached & set(owned) or not owned:
        fail(f"render-captured: graphs' K5 scratch {owned} shared, or held "
             f"by the stream cache {sorted(cached)}")
    log(f"[render-captured] the bench graph freed and captured again: all "
        f"{len(frames)} graphs replay bit-equal to eager frames from a new "
        f"state; {len(owned)} graphs own a K5 scratch each, none shared or "
        f"held by the stream-keyed cache")
    del frames
    gc.collect()
    return replayed


def stream_tris(rng, t=60, crossing=True):
    """Clip-space triangles with a perspective's depth row (z = a w + b)
    and per-vertex attributes, numpy; a quarter cross w = 0."""
    xy = (rng.uniform(-0.9, 0.9, (t, 1, 2))
          + rng.uniform(-0.35, 0.35, (t, 3, 2)))
    w = rng.uniform(0.6, 3.0, (t, 1, 1)) + rng.uniform(-0.05, 0.05, (t, 3, 1))
    if crossing:
        w[: t // 4, 0, 0] = rng.uniform(-1.0, -0.2, t // 4)
    clip = np.concatenate([xy * w, (100.1 * w - 20.0) / 99.9, w], -1)
    attrs = {name: rng.uniform(-1, 1, (t, 3, c)).astype(np.float32)
             for name, c in (("albedo", 3), ("normal", 3), ("position", 3),
                             ("material", 2), ("emission", 3))}
    return clip.astype(np.float32), attrs, rng.uniform(size=t) > 0.1


def phase_render_extras_small():
    """The streaming rasterizer, reflection probes, post-processing and
    SSAO, card against CPU on seeded inputs."""
    from fyrox_tpu_torch.render import post, probe, raster, ssao
    from fyrox_tpu_torch.scene import camera
    rng = np.random.default_rng(21)
    worst = {}

    def both(fn, *args, **kw):
        """fn on CPU tensors and on card copies; (cpu, card on the CPU)."""
        def to(x, dev):
            if isinstance(x, np.ndarray):
                return torch.as_tensor(x, device=dev)
            if isinstance(x, dict):
                return {k: to(v, dev) for k, v in x.items()}
            if isinstance(x, raster.GBuffer):
                return raster.GBuffer(*(None if v is None else v.to(dev)
                                        for v in x))
            return x
        cpu = fn(*(to(a, "cpu") for a in args),
                 **{k: to(v, "cpu") for k, v in kw.items()})
        card = fn(*(to(a, "cuda") for a in args),
                  **{k: to(v, "cuda") for k, v in kw.items()})
        torch.cuda.synchronize()
        return cpu, card

    def held(label, cpu, card, tol, flips=0):
        c, g = [x.float().cpu().reshape(-1, x.shape[-1] if x.dim() else 1)
                for x in (cpu, card)]
        bad = (g - c).abs().amax(-1) > tol
        worst[label] = float((g - c).abs().max())
        if int(bad.sum()) > flips or not bool(torch.isfinite(g).all()):
            fail(f"render-extras-small {label}: card vs CPU "
                 f"{worst[label]:.3g} max, {int(bad.sum())} rows past {tol}")

    gbufs = {}
    for cull in (True, False):
        clip, attrs, valid = stream_tris(rng)
        cpu, card = both(raster.rasterize, np.stack([clip, clip[::-1]]),
                         attrs, 48, 48, tri_valid=np.stack([valid, valid]),
                         chunk=16, backface_cull=cull)
        if int((cpu.mask != card.mask.cpu()).sum()) > 2 or not bool(
                cpu.mask.any()):
            fail(f"render-extras-small rasterize cull={cull}: masks differ "
                 "or nothing hit")
        both_hit = (cpu.mask & card.mask.cpu())[..., None]
        for f in ("depth", "albedo", "normal", "position", "material"):
            c, g = getattr(cpu, f), getattr(card, f).cpu()
            if f == "depth":
                c, g = c[..., None], g[..., None]
            held(f"rasterize {f}", c * both_hit, g * both_hit, 1e-5, 2)
        gbufs[cull] = cpu
    g = gbufs[True]
    tris = rng.uniform(-4, 4, (40, 1, 3)) + rng.uniform(-0.6, 0.6, (40, 3, 3))
    attrs = {k: rng.uniform(0, 1, (40, 3, c)).astype(np.float32)
             for k, c in (("albedo", 3), ("normal", 3), ("position", 3),
                          ("material", 2), ("emission", 3))}
    faces, faces_g = both(probe.capture_probe, tris.astype(np.float32),
                          attrs, np.zeros(3, np.float32), face_size=16,
                          chunk=32)
    held("capture_probe", faces, faces_g, 1e-5, 4)
    held("face_irradiance", probe.face_irradiance(faces),
         probe.face_irradiance(faces.cuda()), 1e-6)
    pre, pre_g = both(probe.prefilter_specular, faces.numpy(), out_size=4)
    held("prefilter_specular", pre, pre_g, 1e-5)
    color = rng.uniform(0, 1, (2, 48, 48, 3)).astype(np.float32)
    cams = rng.uniform(-3, 3, (2, 3)).astype(np.float32)
    held("apply_probe_ambient", *both(
        probe.apply_probe_ambient, color, g, rng.uniform(
            0, 2, (6, 3)).astype(np.float32), probe_inv=np.diag(
                [0.3, 0.3, 0.3, 1.0]).astype(np.float32)), 1e-5)
    held("apply_probe_specular", *both(
        probe.apply_probe_specular, color, g, cams, pre.numpy()), 1e-5, 8)
    hdr = rng.uniform(0, 1.2, (2, 48, 48, 3)).astype(np.float32)
    hdr[:, 10:14, 10:14] += 4.0
    held("post_process", *both(post.post_process, hdr, post.PostConfig(
        color_grading_lut=post.identity_lut(8) ** 0.8)), 1e-5)
    vp = camera.view_projection(torch.eye(4)[None].expand(2, 4, 4), 1.0,
                                1.0, 0.05, 50.0)
    held("compute_ssao", *both(ssao.compute_ssao, g, vp.numpy(), cams),
         1e-5, 8)
    log(f"[render-extras-small] card == CPU: "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))


def phase_unbinned():
    """Slab and grid builds with no grid-eligible collider take the dense
    pairs and step on the card as on the CPU."""
    from fyrox_tpu_torch.physics import (HALFSPACE, PhysicsBuilder,
                                         init_physics_state, step_physics)
    out = []
    for ground in (True, False):
        for bp in ("slab", "grid"):
            pb = PhysicsBuilder()
            if ground:
                pb.add_collider(pb.add_body(body_type=1), HALFSPACE, [])
            for i in range(4):
                pb.add_body(position=(0.5 * i, 1.0 + 0.3 * i, 0.0))
            t = pb.build(broadphase=bp)
            if t.grid is not None or len(t.pair_a):
                fail(f"unbinned {bp}: grid {t.grid}, {len(t.pair_a)} pairs")
            cpu = init_physics_state(pb, t, 4, device="cpu")
            card = init_physics_state(pb, t, 4, device="cuda")
            for _ in range(20):
                cpu = step_physics(cpu, t, 1 / 60)
                card = step_physics(card, t, 1 / 60)
            err = float((card.position.cpu() - cpu.position).abs().max())
            if err > 1e-6 or not float(card.position[0, -1, 1]) < 1.9:
                fail(f"unbinned {bp}: card vs CPU {err:.3g}, or no fall")
            out.append(f"{bp} {'halfspace' if ground else 'no collider'} "
                       f"{err:.3g}")
    log(f"[unbinned] slab and grid builds with no grid collider take the "
        f"dense pairs (0 here) and step 20 ticks on the card as on the CPU "
        f"(positions max card - CPU: {', '.join(out)})")


# ---------------------------------------------------------------- audio
# The audio mixer: the flagship with a hum on its first bone and a
# listener on the camera. A tick carries the audio leaves unchanged; the
# mixer runs in Engine.render_audio, outside the captured tick.
AUDIO_SMALL = dict(n_bones=8, n_verts=128, n_bodies=4)
AUDIO_SMALL_W = 4
AUDIO_SMALL_BLOCK = 128
AUDIO_RENDERS = 20     # timed render_audio(513) calls
BUS_BLOCKS = 3         # 513-sample blocks through the bus graph


def audio_worlds(engine, w, device, seed=0):
    """distinct_worlds with the character's root pivot moved per world
    along x (-8 .. 8 m) and z, and the playheads started apart, so that
    each world's source sits elsewhere against the camera's ears."""
    from fyrox_tpu_torch.scene import graph as graph_mod
    st = distinct_worlds(engine, w, device, seed)
    pos = st.scene.position.clone()
    xs = torch.linspace(-8.0, 8.0, w, device=pos.device)
    pos[:, 0, 0] = xs
    pos[:, 0, 2] = 2.0 * torch.cos(xs)
    scene = graph_mod.update_hierarchical_data(
        st.scene._replace(position=pos), engine.template)
    audio = st.audio._replace(playhead=torch.arange(
        w, dtype=torch.float32, device=pos.device)[:, None].expand_as(
        st.audio.playhead).contiguous() * 333.25)
    return st._replace(scene=scene, audio=audio)


def expected_pan(engine, state):
    """Per world [W,S]: the listener-space pan the mixer should apply,
    the source direction · the listener's +X axis from the globals."""
    at = engine.audio_template()
    g = state.scene.globals_
    src = g[:, torch.as_tensor(at.src_node, device=g.device).long(), :3, 3]
    lg = g[:, at.listener_node]
    d = src - lg[:, None, :3, 3]
    d = d / d.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    right = lg[:, None, :3, 0] / lg[:, None, :3, 0].norm(dim=-1,
                                                         keepdim=True)
    return (d * right).sum(-1)


def phase_audio_small():
    """The small flagship with audio (W=4, worlds apart): 20 ticks, each
    followed by render_audio(block_len=128), on the card and on the CPU
    from the same state: every block within 1e-5, `playing` and the
    playheads equal."""
    from fyrox_tpu_torch import convert
    from fyrox_tpu_torch.models import build_flagship
    engine, _ = build_flagship(**AUDIO_SMALL, with_audio=True)
    cpu = audio_worlds(engine, AUDIO_SMALL_W, "cpu", seed=5)
    gpu = convert.engine_state(convert.to_numpy(cpu), device="cuda")
    worst = loud = 0.0
    for _ in range(TICKS):
        cpu, gpu = engine.step(cpu), engine.step(gpu)
        bc, cpu = engine.render_audio(cpu, block_len=AUDIO_SMALL_BLOCK)
        bg, gpu = engine.render_audio(gpu, block_len=AUDIO_SMALL_BLOCK)
        worst = max(worst, (bg.cpu() - bc).abs().max().item())
        loud = max(loud, bc.abs().max().item())
        if not (torch.equal(gpu.audio.playing.cpu(), cpu.audio.playing)
                and torch.equal(gpu.audio.playhead.cpu(),
                                cpu.audio.playhead)):
            fail("audio-small: playheads or `playing` differ card vs CPU")
    if not (worst <= 1e-5 and loud > 1e-3 and all_differ(bc)):
        fail(f"audio-small: blocks card vs CPU {worst:.3g} (bound 1e-5), "
             f"loudest {loud:.3g}, worlds distinct {all_differ(bc)}")
    log(f"[audio-small] flagship with audio ({AUDIO_SMALL}, W="
        f"{AUDIO_SMALL_W} distinct worlds): {TICKS} ticks, each followed by "
        f"render_audio({AUDIO_SMALL_BLOCK}); blocks card vs CPU within "
        f"{worst:.3g} (bound 1e-5, loudest sample {loud:.3f}); playheads "
        f"and `playing` equal")


def phase_audio():
    """The full-width flagship with audio (100 bones, 50,000 vertices,
    1,000 bodies), W worlds: TICKS eager ticks (K3, K2, K1 once a tick);
    TICKS replayed ticks equal them bit for bit, audio leaves carried; a
    replayed roll's kernels by the profiler's names, device events and
    device ms; env·steps/s through rollout; render_audio(513): ms and
    device ms a call, blocks/s; the blocks finite and panned to the
    source's side in every world. Returns the eager launches."""
    from fyrox_tpu_torch.models import build_flagship
    t0 = time.perf_counter()
    engine, skin = build_flagship(n_bones=100, n_verts=50_000,
                                  n_bodies=1000, with_audio=True)
    build_s = time.perf_counter() - t0
    at = engine.audio_template()
    if at is None or at.src_node.size != 1:
        fail("audio: the flagship has no sound source")
    state0 = audio_worlds(engine, WORLDS, "cuda", seed=29)
    torch.cuda.synchronize()
    reset_all_launches()
    eager = state0
    for _ in range(TICKS):
        eager = engine.step(eager)
    torch.cuda.synchronize()
    n = all_launches()
    want = dict(fused_bp=TICKS, narrow_compact=TICKS, solve_tgs=TICKS,
                plane_gather=0, plane_scatter=0)
    if n != want:
        fail(f"audio: launches of {TICKS} eager ticks {n}, want {want}")
    for a, b in zip(eager.audio, state0.audio):
        if not torch.equal(a, b):
            fail("audio: a tick changed the audio state")
    rolled = engine.rollout(state0, TICKS)
    n_leaves = same_state("audio rollout", rolled, eager)
    kn, events, dev_ms = profiled(lambda: engine.rollout(rolled, TICKS),
                                  TICKS, "audio")
    if kn != want:
        fail(f"audio: kernels of a replayed roll {kn}, want {want}")
    st = engine.rollout(rolled, TICKS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        st = engine.rollout(st, TICKS)
    torch.cuda.synchronize()
    rate = WORLDS * TICKS * CALLS / (time.perf_counter() - t0)
    block, after = engine.render_audio(rolled, block_len=513)
    if not (tuple(block.shape) == (WORLDS, 513, 2)
            and bool(torch.isfinite(block).all())):
        fail(f"audio: blocks {tuple(block.shape)}, finite "
             f"{bool(torch.isfinite(block).all())}")
    pan = expected_pan(engine, rolled)[:, 0]
    side = (block[..., 1] ** 2).mean(1) - (block[..., 0] ** 2).mean(1)
    clear = pan.abs() > 0.2
    wrong = int((clear & (torch.sign(side) != torch.sign(pan))).sum())
    if wrong or int(clear.sum()) < WORLDS // 4:
        fail(f"audio: the pan follows the source in "
             f"{int(clear.sum()) - wrong} of {int(clear.sum())} worlds")
    if not torch.equal(after.audio.playhead,
                       torch.remainder(rolled.audio.playhead + 513.0,
                                       float(at.buffers.lengths[0]))):
        fail("audio: render_audio did not advance the playheads by 513")
    ms = cuda_ms(lambda: engine.render_audio(rolled, block_len=513),
                 AUDIO_RENDERS)
    a_events, a_dev = stage_profile(
        lambda: engine.render_audio(rolled, block_len=513), 1)
    # at most ~600 launches queued behind device_ms's spin
    dms = device_ms(lambda: engine.render_audio(rolled, block_len=513),
                    max(1, min(AUDIO_RENDERS, int(600 // a_events))))
    log(f"[audio] flagship with audio (100 bones, 50,000 vertices, 1,000 "
        f"bodies; a {at.buffers.lengths[0]}-sample hum on bone 0, ears on "
        f"the camera; built in {build_s:.1f} s), W={WORLDS}: {TICKS} eager "
        f"ticks launch K3, K2, K1 once a tick and leave the audio state "
        f"as it was; {TICKS} replayed ticks equal them bit for bit "
        f"({n_leaves} state tensors, audio leaves carried); replayed "
        f"roll's kernels {kn}; replayed tick: {events:.1f} device events, "
        f"{dev_ms:.3f} ms of device time; {rate:.1f} env·steps/s through "
        f"rollout ({CALLS} x {TICKS} ticks, no skinning); render_audio(513):"
        f" {ms:.4f} ms a call (CUDA events), {dms:.4f} ms of device time "
        f"({a_dev:.4f} by the profiler), {a_events:.0f} device events, "
        f"{WORLDS / ms * 1e3:.0f} blocks/s; "
        f"blocks finite, the pan on the source's side in all "
        f"{int(clear.sum())} worlds with |pan| > 0.2 on {CARD}")
    return n


def phase_bus_binaural():
    """bus.process (a low-pass and reverb child bus under the primary bus)
    over BUS_BLOCKS 513-sample blocks and render_block_binaural (8
    sources; the spherical-head model and a measured ring) on the card
    against the CPU, within 1e-5; the bus loop's ms a block."""
    from fyrox_tpu_torch.sound import binaural, bus
    rng = np.random.default_rng(13)
    g = bus.BusGraph.build([
        dict(parent=-1, gain=0.9),
        dict(parent=0, gain=0.7, effects=[
            ("biquad", bus.biquad_coeffs("lowpass", 800.0)),
            ("reverb", 0.5)])])
    sg, sc = bus.init_state(g, device="cuda"), bus.init_state(g, device="cpu")
    worst = 0.0
    for _ in range(BUS_BLOCKS):
        blk = torch.as_tensor(rng.normal(0, 0.3, (2, 513, 2)).astype(
            np.float32))
        og, sg = bus.process(g, blk.cuda(), sg)
        oc, sc = bus.process(g, blk, sc)
        worst = max(worst, (og.cpu() - oc).abs().max().item())
        for a, b in zip(sg, sc):
            worst = max(worst, (a.cpu().float() - b.float()).abs().max()
                        .item())
    blk = blk.cuda()
    ms_bus = cuda_ms(lambda: bus.process(g, blk, sg), 2)
    mono = rng.normal(0, 0.5, (8, 513)).astype(np.float32)
    az = rng.uniform(-np.pi, np.pi, 8).astype(np.float32)
    gains = rng.uniform(0.2, 1.0, 8).astype(np.float32)
    ring = binaural.HrirSphere(np.linspace(0, 2 * np.pi, 12, endpoint=False),
                               rng.normal(size=(12, 2, 32)))
    worst_b = 0.0
    for sph in (None, ring):
        outs = [binaural.render_block_binaural(
            torch.as_tensor(mono, device=d), torch.as_tensor(az, device=d),
            torch.as_tensor(gains, device=d), hrir_sphere=sph)
            for d in ("cuda", "cpu")]
        worst_b = max(worst_b, (outs[0].cpu() - outs[1]).abs().max().item())
    args = [torch.as_tensor(x, device="cuda") for x in (mono, az, gains)]
    ms_bin = cuda_ms(lambda: binaural.render_block_binaural(*args), 10)
    if not (worst <= 1e-5 and worst_b <= 1e-5):
        fail(f"bus-binaural: card vs CPU bus {worst:.3g}, binaural "
             f"{worst_b:.3g} (bound 1e-5)")
    log(f"[bus-binaural] bus.process (primary ← low-pass 800 Hz + reverb "
        f"child), {BUS_BLOCKS} blocks of 513 samples: card == CPU within "
        f"{worst:.3g} (block and state; bound 1e-5); the per-sample loop "
        f"{ms_bus:.1f} ms a block on the card (CUDA events); "
        f"render_block_binaural (8 sources, model and 12-direction ring): "
        f"card == CPU within {worst_b:.3g}, {ms_bin:.3f} ms a call on {CARD}")


# ---------------------------------------------------------------- grid
# The grid broadphase: the hash-grid walk with a global per-class
# compaction into directed pair lists, the per-class narrowphase and the
# directed TGS solve, whose gathers run on K4a and whose windowed segment
# sums run on K4b (one launch a class segment each time).
GRID_SMALL_TICKS = 20
GRID_PROFILED = 3


def grid_pile(lib, n=24, seed=1):
    """n bodies (balls, cuboids, capsules in turn) in a loose lattice over
    a halfspace (restitution 0.2); lib: either package's physics names.
    Returns the PhysicsBuilder."""
    rng = np.random.default_rng(seed)
    pb = lib.PhysicsBuilder()
    g = pb.add_body(body_type=lib.BodyType.STATIC)
    pb.add_collider(g, lib.HALFSPACE, [], friction=0.6, restitution=0.2)
    side = max(int(np.ceil(n ** (1.0 / 3.0))), 1)
    for i in range(n):
        gx, gy, gz = i % side, (i // side) % side, i // (side * side)
        pos = ((gx - side / 2) * 0.7 + rng.uniform(-0.05, 0.05),
               0.6 + gy * 0.7,
               (gz - side / 2) * 0.7 + rng.uniform(-0.05, 0.05))
        b = pb.add_body(position=pos)
        if i % 3 == 0:
            pb.add_collider(b, lib.BALL, [0.25], friction=0.5,
                            restitution=0.1)
        elif i % 3 == 1:
            pb.add_collider(b, lib.CUBOID, [0.22, 0.22, 0.22], friction=0.5)
        else:
            pb.add_collider(b, lib.CAPSULE, [0.2, 0.15], friction=0.5)
    return pb


def jointed_stack(lib):
    """Four 0.6 m boxes stacked on a halfspace, ball-jointed corner to
    corner, a capsule pendulum on a revolute joint off the top box and a
    collider offset (a centre-of-mass offset) on the second box. Returns
    the PhysicsBuilder."""
    pb = lib.PhysicsBuilder()
    g = pb.add_body(body_type=lib.BodyType.STATIC)
    pb.add_collider(g, lib.HALFSPACE, [], friction=0.8)
    boxes = []
    for k in range(4):
        b = pb.add_body(position=(0.05 * k, 0.31 + 0.62 * k, 0.0))
        pb.add_collider(b, lib.CUBOID, [0.3, 0.3, 0.3], friction=0.7,
                        offset=(0.05, 0.0, 0.0) if k == 1 else (0, 0, 0))
        boxes.append(b)
    for a, b in zip(boxes, boxes[1:]):
        pb.add_joint(lib.JointKind.BALL, a, b, anchor_a=(0.3, 0.31, 0.3),
                     anchor_b=(0.3, -0.31, 0.3))
    pend = pb.add_body(position=(0.9, 2.2, 0.0))
    pb.add_collider(pend, lib.CAPSULE, [0.2, 0.1], friction=0.5)
    pb.add_joint(lib.JointKind.REVOLUTE, boxes[-1], pend,
                 anchor_a=(0.35, 0.0, 0.0), anchor_b=(-0.4, 0.0, 0.0),
                 axis=(0.0, 0.0, 1.0))
    return pb


def grid_launches(t):
    """(K4a, K4b) launches of one grid tick (physics/solver.py
    solve_tgs_directed), per class segment: the prep's count scatter and
    gather, the restitution target's gather; per substep the warm start's
    scatter, per PGS pass a gather and a scatter, the end-of-substep
    gather; the restitution's gather and scatter; per stabilisation pass a
    scatter and a gather (not after the last). Joints add dense_launches'
    joint passes."""
    segs = sum(1 for c in t.grid.caps if c > 0)
    sub, pgs, stab = t.n_substeps, t.n_pgs, t.n_stabilization
    gathers = segs * (2 + sub * (pgs + 1) + 1 + max(stab - 1, 0))
    scatters = segs * (1 + sub * (1 + pgs) + 1 + stab)
    if t.joints is not None and t.joints.num_joints:
        gathers += 2 * sub + stab
        scatters += 2 * sub + stab
    return gathers, scatters


def grid_engine(n_bodies=1000):
    """The flagship's character (100 bones, 50,000 vertices) and its
    n_bodies pile as build_flagship builds them, the pile on
    broadphase="grid" (build_flagship takes no broadphase). Returns
    (Engine, SkinTemplate)."""
    from fyrox_tpu_torch.models import character
    sb, aset, mt, bones, skin_data = character.build_character_scene(
        n_bones=100, n_verts=50_000, seed=0)
    pb, _ = character.build_pile_scene(sb, n_bodies=n_bodies, seed=1)
    return character.assemble_flagship(sb, pb.build(broadphase="grid"), aset,
                                       mt, bones, skin_data)


def phase_grid_small():
    """A 64-body pile (balls, cuboids, capsules) and the jointed stack on
    the grid broadphase at W=4 distinct worlds: each of GRID_SMALL_TICKS
    card ticks held against the same tick on the CPU from the card's state
    (card_vs_cpu_steps); K4a and K4b launched grid_launches(t) times a
    tick, no other kernel."""
    from fyrox_tpu_torch.physics import world as phys_mod
    lib = port_lib()
    for label, pb in (("pile", grid_pile(lib, n=64)),
                      ("jointed stack", jointed_stack(lib))):
        t = pb.build(broadphase="grid")
        cpu = jitter(phys_mod.init_physics_state(pb, t, 4, device="cpu"), t,
                     "cpu", seed=6)
        reset_all_launches()
        dp, dv, live = card_vs_cpu_steps(
            f"grid-small {label}", t, cpu, GRID_SMALL_TICKS,
            lambda s: phys_mod.step_physics(s, t, 1.0 / 60.0))
        g, sc = grid_launches(t)
        want = dict(fused_bp=0, narrow_compact=0, solve_tgs=0,
                    plane_gather=g * GRID_SMALL_TICKS,
                    plane_scatter=sc * GRID_SMALL_TICKS)
        n = all_launches()
        if n != want:
            fail(f"grid-small {label}: launches {n}, want {want}")
        log(f"[grid-small] {label} ({t.num_colliders} colliders, caps "
            f"{t.grid.caps}, "
            f"{0 if t.joints is None else t.joints.num_joints} joints): card "
            f"== CPU on each of {GRID_SMALL_TICKS} ticks from the card's "
            f"state (W=4 distinct worlds, {live} live pairs): worst dp "
            f"{dp:.3g} (bound 5e-4), dv {dv:.3g} (bound 5e-3); K4a {g} and "
            f"K4b {sc} launches a tick")


def grid_demand(t, physics):
    """The grid's demand against every cap and window on `physics`:
    broadphase_stats (pairs a class against its cap, pairs a body against
    windows_body) and the walk (candidates in a collider's nine ranges
    against the window). Returns (stats, walk max, colliders past the
    window summed over the worlds, a text line)."""
    from fyrox_tpu_torch.physics import broadphase as bp_mod
    from fyrox_tpu_torch.physics import world as phys_mod
    stats = bp_mod.broadphase_stats(t, physics)
    amin, amax, _, _ = phys_mod.grid_aabbs(physics, t)
    col_body = np.asarray(t.col_body)
    _, walk = bp_mod.grid_candidates(
        t.grid, col_body, np.asarray(t.body_type)[col_body] == 0, amin,
        amax, return_demand=True)
    walk_max, over = int(walk.max()), int((walk > t.grid.window).sum())
    parts = [f"walk {walk_max} of window {t.grid.window} ({over} collider "
             f"walks past it, their extra candidates dropped)"]
    for cls, d in stats.items():
        if d["cap"] == 0:
            continue
        parts.append(
            f"class {cls}: {d['needed']} pairs of cap {d['cap']}"
            f"{' (DROPS)' if d['needed'] > d['cap'] else ''}, "
            f"{d['max_pairs_per_body']} a body of window "
            f"{d['window_body']}"
            f"{' (DROPS)' if d['max_pairs_per_body'] > d['window_body'] else ''}")
    return stats, walk_max, over, "; ".join(parts)


def grid_stages(engine, state, reps=2):
    """Device ms and device events (profiler) of the grid tick's stages
    from `state`, per call over `reps` calls after a warm-up: the whole
    eager tick, its physics step, the broadphase + narrowphase
    (world.grid_contacts) and the candidate walk and compaction alone
    (grid_aabbs + grid_candidates); the narrowphase, the solve and the
    rest of the tick are the differences."""
    from fyrox_tpu_torch.physics import broadphase as bp_mod
    from fyrox_tpu_torch.physics import world as phys_mod
    t, dt = engine.physics, engine.dt
    col_body = np.asarray(t.col_body)
    dyn = np.asarray(t.body_type)[col_body] == 0

    def candidates():
        amin, amax, _, _ = phys_mod.grid_aabbs(state.physics, t)
        return bp_mod.grid_candidates(t.grid, col_body, dyn, amin, amax)

    fns = dict(tick=lambda: engine.step(state),
               physics=lambda: phys_mod.step_physics(state.physics, t, dt),
               contacts=lambda: phys_mod.grid_contacts(state.physics, t),
               candidates=candidates)
    out = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        events, dev = stage_profile(fn, reps)
        out[name] = (dev, events)
    out["narrowphase"] = tuple(a - b for a, b in zip(out["contacts"],
                                                     out["candidates"]))
    out["solve"] = tuple(a - b for a, b in zip(out["physics"],
                                               out["contacts"]))
    out["rest"] = tuple(a - b for a, b in zip(out["tick"], out["physics"]))
    return out


def phase_grid(engine, skin):
    """The grid flagship (grid_engine), W distinct worlds: TICKS eager ticks
    with the launches counted (K4a and K4b grid_launches(t) a tick, no
    other kernel); the demand against every cap and window, printed with
    its drops; TICKS replayed ticks equal them bit for bit; a replayed
    roll's kernels, device events and device ms (profiler); env·steps/s
    with skinning of eager and captured rolls; the device time of the
    tick's stages (grid_stages); the peak memory of a tick. Returns (eager
    launches, the rolled state)."""
    from fyrox_tpu_torch.animation import skinning
    from fyrox_tpu_torch.physics.broadphase import GridConfig
    t = engine.physics
    if not isinstance(t.grid, GridConfig):
        fail("grid: the flagship did not take the grid broadphase")
    state0 = distinct_worlds(engine, WORLDS, "cuda", seed=31)
    torch.cuda.synchronize()
    reset_all_launches()
    eager = state0
    t0 = time.perf_counter()
    for _ in range(TICKS):
        eager = engine.step(eager)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / TICKS
    n = all_launches()
    g, sc = grid_launches(t)
    want = dict(fused_bp=0, narrow_compact=0, solve_tgs=0,
                plane_gather=g * TICKS, plane_scatter=sc * TICKS)
    if n != want:
        fail(f"grid: launches of {TICKS} eager ticks {n}, want {want}")
    _, _, _, demand = grid_demand(t, eager.physics)
    rolled = engine.rollout(state0, TICKS)
    n_leaves = same_state("grid rollout", rolled, eager)
    tick = engine.captured_tick(state0)
    want_prof = dict(fused_bp=0, narrow_compact=0, solve_tgs=0,
                     plane_gather=g * GRID_PROFILED,
                     plane_scatter=sc * GRID_PROFILED)
    kn, events, dev_ms = profiled(
        lambda: engine.rollout(rolled, GRID_PROFILED), GRID_PROFILED,
        "grid")
    if kn != want_prof:
        fail(f"grid: kernels of a replayed roll {kn}, want {want_prof}")
    rates = {}
    for kind in ("eager", "rollout"):
        def roll(st, kind=kind):
            if kind == "rollout":
                return engine.rollout(st, TICKS)
            for _ in range(TICKS):
                st = engine.step(st)
            return st

        st = roll(rolled)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = roll(st)
        verts = skinning.skin_positions_dense(
            skinning.bone_matrices(st.scene.globals_, skin), skin)
        torch.cuda.synchronize()
        rates[kind] = WORLDS * TICKS / (time.perf_counter() - t0)
        check_state(st, verts, skin)
    live = int((rolled.physics.warm_pair >= 0).sum())
    if live == 0:
        fail("grid: no live pair")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    engine.step(rolled)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    stages = grid_stages(engine, rolled)
    log(f"[grid] demand after {TICKS} ticks (W={WORLDS}): {demand}")
    log(f"[grid] stages of an eager tick from the rolled state, device ms "
        f"(profiler) / device events per call: " + ", ".join(
            f"{k} {v[0]:.3f} / {v[1]:.0f}" for k, v in stages.items())
        + f" on {CARD}")
    log(f"[grid] grid flagship (100 bones, 50,000 vertices, {t.num_bodies - 1}"
        f" bodies on broadphase=\"grid\": cell {t.grid.cell:.3f} m, caps "
        f"{t.grid.caps}, windows {t.grid.window} / {t.grid.windows_body}), "
        f"W={WORLDS}: {TICKS} eager ticks launch K4a {g} and K4b {sc} times a "
        f"tick and no other kernel ({eager_ms:.3f} ms a tick); {TICKS} "
        f"replayed ticks equal them bit for bit ({n_leaves} state tensors);"
        f" replayed roll's kernels {kn} over {GRID_PROFILED} ticks; "
        f"replayed tick: {events:.1f} device events, {dev_ms:.3f} ms of "
        f"device time; env·steps/s with skinning ({TICKS} ticks): eager "
        f"{rates['eager']:.1f}, rollout {rates['rollout']:.1f}; {live} "
        f"live pairs; peak memory of an eager tick above the state "
        f"{peak:.2f} GiB; capture {tick.capture_seconds:.3f} s, graph pool "
        f"{tick.pool_bytes / 2**20:.1f} MiB on {CARD}")
    return n, rolled


def phase_grid_k4(engine, state):
    """K4a and K4b on one grid flagship tick's calls (a rolled state, W
    distinct worlds): the shapes each class segment gives them (idx [W,2P]
    and [W,P], B body rows), then hold_k4's checks and timings. Returns
    the plane_gather_grid and plane_scatter_grid records."""
    gathers, scatters = capture_dense_calls(engine, state)
    t = engine.physics
    b = t.num_bodies
    ng, ns = grid_launches(t)
    if (len(gathers), len(scatters)) != (ng, ns):
        fail(f"grid K4: {len(gathers)} gathers and {len(scatters)} scatters "
             f"in a tick, want {ng} and {ns}")
    caps = {c for c in t.grid.caps if c > 0}
    for planes, idx in gathers:
        if not (planes.shape[0] == WORLDS and planes.shape[2] == b
                and idx.shape[0] == WORLDS and idx.shape[1] // 2 in caps):
            fail(f"grid K4a: shapes {tuple(planes.shape)} x "
                 f"{tuple(idx.shape)}")
    for vals, idx, n in scatters:
        if not (vals.shape[0] == WORLDS and n == b
                and idx.shape[1] in caps and vals.shape[2] == idx.shape[1]):
            fail(f"grid K4b: shapes {tuple(vals.shape)} → {n} rows")
    return hold_k4("grid", gathers, scatters,
                   f"idx [{WORLDS}, 2 x cap] / [{WORLDS}, cap] for caps "
                   f"{sorted(caps)}, {b} body rows")


# ---------------------------------------------------------------- brush
BRUSH_RES = 257
BRUSH_STAMPS = 16


def chunked_scene(lib, res=65):
    """A res x res hill map (64 m) split by add_chunked_terrain into 4 x 4
    chunks, a directional light and a camera under it looking up (the
    terrain mesh faces down, as the JAX package's does); lib: a namespace
    with SceneBuilder and terrain."""
    sb = lib.SceneBuilder()
    terr = lib.terrain.Terrain(hills(res, 64.0), 64.0, 64.0,
                               (-32.0, 0.0, -32.0))
    pairs = lib.terrain.add_chunked_terrain(sb, terr, chunks=(4, 4),
                                            lod_split=0.2, decimate=4)
    sb.add_light("directional", rotation=(0.5, 0.0, 0.0, 0.866))
    sb.add_camera("cam", position=(0.0, -6.0, -30.0),
                  rotation=(-0.2, 0.0, 0.0, 0.98), z_near=0.1, z_far=100.0)
    return pairs, sb.build()


def phase_brush():
    """apply_stroke in each mode (circle and transformed rectangle, a
    BRUSH_STAMPS-stamp stroke on a BRUSH_RES² map) on the card against the
    CPU, within 1e-5; add_chunked_terrain's scene (16 chunks, hi and lo
    meshes switched by LOD groups) rendered on the card against the CPU
    (W=2, 64²: 99.9 % of the colours within 1e-4, all within 2e-3)."""
    import types
    from fyrox_tpu_torch import render
    from fyrox_tpu_torch.scene import SceneBuilder, brush, graph, init_state
    from fyrox_tpu_torch.scene import terrain
    rng = np.random.default_rng(17)
    h = rng.normal(0, 1, (BRUSH_RES, BRUSH_RES)).astype(np.float32)
    pts = np.cumsum(rng.uniform(0.5, 3.0, (BRUSH_STAMPS, 2)), 0) + 20.0
    worst, ms = 0.0, {}
    for mode in ("raise", "assign", "flatten", "smooth"):
        for shape in ("circle", "rect"):
            b = brush.Brush(shape=shape, radius=12.0, width=20.0, length=6.0,
                            mode=mode, amount=1.5, value=-2.0,
                            kernel_radius=3, hardness=0.3, alpha=0.8,
                            transform=((0.8, -0.6), (0.6, 0.8)))
            hc = torch.as_tensor(h)
            hg = hc.cuda()
            got = brush.apply_stroke(hg, b, pts, cell_size=0.5)
            want = brush.apply_stroke(hc, b, pts, cell_size=0.5)
            worst = max(worst, (got.cpu() - want).abs().max().item())
            if (want - hc).abs().max().item() < 0.1:
                fail(f"brush: the {mode} {shape} stroke changed nothing")
            if shape == "circle":
                ms[mode] = cuda_ms(lambda: brush.apply_stroke(
                    hg, b, pts, cell_size=0.5), 5)
    if worst > 1e-5:
        fail(f"brush: apply_stroke card vs CPU {worst:.3g} (bound 1e-5)")
    lib = types.SimpleNamespace(SceneBuilder=SceneBuilder, terrain=terrain)
    pairs, t = chunked_scene(lib)
    rt = render.build_render_template(t)
    cfg = render.RenderConfig(width=64, height=64, shadows=False)
    frames = []
    for dev in ("cuda", "cpu"):
        st = graph.update_hierarchical_data(init_state(t, 2, device=dev), t)
        frames.append(render.render_frame(st, t, rt, cfg)[0].cpu())
    d = (frames[0] - frames[1]).abs()
    near = float((d <= 1e-4).float().mean())
    lit = float((frames[1].sum(-1) > 0).float().mean())
    if not (near >= 0.999 and d.max().item() <= 2e-3 and lit > 0.2):
        fail(f"brush: the chunked terrain frame card vs CPU: {near:.4f} "
             f"within 1e-4, max {d.max().item():.3g}, lit {lit:.3f}")
    log(f"[brush] apply_stroke (raise, assign, flatten, smooth; circle and "
        f"transformed rectangle; {BRUSH_STAMPS} stamps on {BRUSH_RES}²): "
        f"card == CPU within {worst:.3g} (bound 1e-5); ms a stroke "
        f"(circle): " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f"; add_chunked_terrain: {len(pairs)} chunks, {len(t.meshes)} "
        f"meshes, {len(rt.lod_obj)} LOD entries; its 64² frame (W=2) on "
        f"the card == CPU for {near * 100:.2f} % of the colours within "
        f"1e-4, max {d.max().item():.3g}; {lit * 100:.1f} % of the pixels "
        f"lit on {CARD}")



# ------------------------------------------------------------------- game
# The game loop on the flagship: script.Executor over the fused K3 → K2 →
# K1 tick (build_flagship(n_bodies=1000) plus a navmesh floor), W = 128,
# with a camera controller, a nav agent driving one pile body, a behavior
# tree and per-tick statistics; checkpoints and the checked tick.
GAME_TICKS = 60          # Executor.run(1.0) at 60 Hz
GAME_NAV_BODY = 1        # the pile's first body (a cuboid on its floor)
GAME_SAVE_AT = 30        # the tick after which the resumed run saves
FRAME_WORLDS = 16        # example_game.py's loop at W = 16
FRAME_TICKS = 120
FRAME_KEEP = (30, 60, 90, 120)     # ticks whose frames card and CPU hold
NAV_SIDE = 256           # navfield: a 256 x 256 grid graph
NAV_SOURCES = 128
NAV_ASTAR = 8
LIGHTMAP_RAYS = 32
LIGHTMAP_CPU_VERTS = 256


def ring_navmesh(half=6.0, cell=3.0):
    """A square floor of cell-sized quads around the pile (the four
    central cells left out), vertices in np.unique's lexicographic order
    so the navmesh's vertex weld keeps their indices."""
    xs = np.arange(-half, half + 1e-6, cell)
    n = len(xs)
    verts = np.asarray([(x, 0.0, z) for x in xs for z in xs], np.float32)
    tris = []
    for i in range(n - 1):
        for j in range(n - 1):
            if abs(xs[i] + cell / 2) < cell and abs(xs[j] + cell / 2) < cell:
                continue                       # the central hole
            a, b = i * n + j, (i + 1) * n + j
            tris += [(a, b, b + 1), (a, b + 1, a + 1)]
    return verts, np.asarray(tris, np.int32)


def game_engine(n_bones=100, n_verts=50_000, n_bodies=1000):
    """build_flagship(n_bodies=1000) with a NavigationalMesh node (the ring
    floor) added before the camera. Returns (Engine, SkinTemplate)."""
    from fyrox_tpu_torch.models import character
    sb, aset, mt, bones, skin_data = character.build_character_scene(
        n_bones=n_bones, n_verts=n_verts, seed=0)
    pb, _ = character.build_pile_scene(sb, n_bodies=n_bodies, seed=1)
    sb.add_navmesh(*ring_navmesh(), name="floor")
    pt = pb.build(broadphase="slab", slab_window=character.SLAB_WINDOW,
                  slab_active=character.SLAB_ACTIVE,
                  slab_walk=character.SLAB_WALK)
    return character.assemble_flagship(sb, pt, aset, mt, bones, skin_data)


class GameScripts:
    """The four scripts of the game phase, made from the initial state and
    a seed: a FlyingCameraController on main_camera (seeded per-world mouse
    and move inputs), a nav script (BatchedNavAgents planned once on the
    template's navmesh from the nav body's start to a seeded goal per
    world; each tick steer writes the body's x / z linvel), a behavior
    tree (selector(sequence(moving, on its path), camera pitched up)) over
    [W, 3] leaf statuses derived from the state each tick, and a
    PerformanceStatistics around each tick. ``states`` / ``load`` carry
    the scripts' tensors through a checkpoint."""

    def __init__(self, engine, state, seed=0):
        from fyrox_tpu_torch.script import Script
        from fyrox_tpu_torch.scripts import FlyingCameraController
        from fyrox_tpu_torch.utils import (BatchedNavAgents,
                                           BehaviorTreeBuilder, Status,
                                           template_navmesh)
        from fyrox_tpu_torch.utils.stats import PerformanceStatistics
        dev = state.scene.position.device
        w = state.scene.num_worlds
        rng = np.random.default_rng(seed)
        cam = engine.template.names.index("main_camera")
        self.camera = FlyingCameraController(cam, w, speed=2.0,
                                             device=dev)
        self.camera.set_input(
            mouse_delta=rng.uniform(-3, 3, (w, 2)).astype(np.float32),
            move_axes=rng.uniform(-1, 1, (w, 2)).astype(np.float32))
        agents = BatchedNavAgents(radius=0.1)
        start = state.physics.position[:, GAME_NAV_BODY].cpu().numpy()
        start[:, 1] = 0.0
        goal = np.stack([rng.uniform(3.5, 5.5, w), np.zeros(w),
                         rng.uniform(-5.5, 5.5, w)], -1).astype(np.float32)
        self.nav = agents.plan(template_navmesh(engine.template), start,
                               goal, device=dev)
        b = BehaviorTreeBuilder()
        root = b.selector()
        seq = b.sequence(parent=root)
        b.leaf(seq)
        b.leaf(seq)
        b.leaf(root)
        tree = b.build(root)
        self.status = torch.zeros(w, dtype=torch.int32, device=dev)
        self.hist = torch.zeros((w, 3), dtype=torch.int32, device=dev)
        self.stats = PerformanceStatistics()
        outer = self
        planar = torch.tensor([1.0, 0.0, 1.0], device=dev)

        class Nav(Script):
            def on_update(self, ctx):
                ph = ctx.state.physics
                pos = ph.position[:, GAME_NAV_BODY] * planar
                vel, outer.nav = agents.steer(outer.nav, pos, 1.5, ctx.dt)
                lv = ph.linvel.clone()
                lv[:, GAME_NAV_BODY, 0] = vel[:, 0]
                lv[:, GAME_NAV_BODY, 2] = vel[:, 2]
                ctx.state = ctx.state._replace(physics=ph._replace(
                    linvel=lv))

        class Behave(Script):
            def on_update(self, ctx):
                s, f, r = Status.SUCCESS, Status.FAILURE, Status.RUNNING
                v = ctx.state.physics.linvel[:, GAME_NAV_BODY]
                moving = v[:, 0] * v[:, 0] + v[:, 2] * v[:, 2] > 1.0
                going = outer.nav.wp < outer.nav.length
                up = outer.camera.pitch > 0
                leaves = torch.stack([torch.where(moving, s, f),
                                      torch.where(going, r, s),
                                      torch.where(up, s, f)], 1)
                outer.status = tree.tick(leaves)
                outer.hist = outer.hist + torch.nn.functional.one_hot(
                    outer.status.long(), 3).to(torch.int32)

        class Stats(Script):
            """Closes the last tick's measurement and opens this one's
            (scripts and tick), waiting for the card at each close."""
            open = None

            def on_update(self, ctx):
                self.close()
                self.open = outer.stats.measure("tick", block_on=ctx.state)
                self.open.__enter__()

            def close(self):
                if self.open is not None:
                    self.open.__exit__(None, None, None)
                    self.open = None

        self.scripts = [self.camera, Nav(), Behave(), Stats()]

    def states(self):
        return (self.camera.yaw, self.camera.pitch, self.nav, self.status,
                self.hist)

    def load(self, states):
        (self.camera.yaw, self.camera.pitch, self.nav, self.status,
         self.hist) = states

    def close(self):
        self.scripts[-1].close()


def game_run(engine, state, seconds, scripts=None, executor=True):
    """`seconds` of the game from `state`: through script.Executor (its
    ticks captured on the card), or with executor=False the same script
    calls and eager Engine.step ticks by hand. Returns (state, scripts)."""
    from fyrox_tpu_torch.script import Executor, ScriptProcessor
    scripts = scripts or GameScripts(engine, state)
    if executor:
        ex = Executor(engine, state)
        for s in scripts.scripts:
            ex.scripts.add(s)
        out = ex.run(seconds)
    else:
        sp = ScriptProcessor()
        for s in scripts.scripts:
            sp.add(s)
        out = state
        for _ in range(round(seconds * 60)):
            out = engine.step(sp.update(engine, out, 1.0 / 60.0))
    if out.scene.position.is_cuda:
        torch.cuda.synchronize()
    scripts.close()
    return out, scripts


def same_game(label, got, want):
    """Fail unless two game runs end equal, bit for bit: every state
    tensor and every script tensor."""
    (gs, gscr), (ws, wscr) = got, want
    same_state(label, gs, ws)
    from fyrox_tpu_torch.engine import _leaves
    a, b = _leaves(gscr.states()), _leaves(wscr.states())
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail(f"{label}: the scripts' tensors differ")


def phase_game():
    """The game loop on the flagship: 60 Executor ticks (captured) with
    four scripts equal the same script calls and eager ticks by hand; a
    run saved at tick 30, loaded into a fresh state and finished equals
    the uninterrupted run; debug_step passes its state and names the
    physics stage for a NaN velocity. Returns the records to print."""
    import tempfile
    from fyrox_tpu_torch.engine import debug_step
    from fyrox_tpu_torch.io import load_state, save_state
    t0 = time.perf_counter()
    engine, _ = game_engine()
    st0 = distinct_worlds(engine, WORLDS, "cuda", seed=11)
    log(f"[setup] game flagship (+ navmesh floor) built in "
        f"{time.perf_counter() - t0:.1f} s")
    if not engine._capturable():
        fail("game: the flagship's tick does not capture")
    reset_all_launches()
    run_a = game_run(engine, st0, 1.0)
    n = all_launches()
    if not (n["fused_bp"] and n["narrow_compact"] and n["solve_tgs"]) or \
            n["plane_gather"] or n["plane_scatter"]:
        fail(f"game: launches of the Executor's run {n}")
    if int(run_a[0].scene.time[0] * 60 + 0.5) != GAME_TICKS:
        fail("game: the Executor ran another number of ticks")
    reset_all_launches()
    run_b = game_run(engine, st0, 1.0, executor=False)
    n_eager = all_launches()
    same_game("game: Executor (captured ticks) vs eager ticks by hand",
              run_a, run_b)
    nav = run_a[1].nav
    hist = run_a[1].hist.sum(0).tolist()
    # the timed run, the tick captured already (the scripts' host path
    # planning before the clock starts)
    scripts_c = GameScripts(engine, st0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    run_c = game_run(engine, st0, 1.0, scripts=scripts_c)
    wall = time.perf_counter() - t1
    same_game("game: a second Executor run", run_c, run_a)
    tick_ms = run_c[1].stats.mean_ms("tick")
    from fyrox_tpu_torch.script import Executor
    ex = Executor(engine, run_c[0])
    for s in run_c[1].scripts[:3]:
        ex.scripts.add(s)
    kn, events, dev_ms = profiled(lambda: ex.run(3 / 60), 3, "game")
    if not (kn["fused_bp"] == kn["narrow_compact"] == kn["solve_tgs"]
            == 3):
        fail(f"game: a replayed tick's kernels {kn}")
    # save at tick 30, load into a fresh state, finish
    first = game_run(engine, st0, GAME_SAVE_AT / 60)
    with tempfile.TemporaryDirectory() as tmp:
        path = tmp + "/game.npz"
        t2 = time.perf_counter()
        save_state((first[0], first[1].states()), path)
        save_s = time.perf_counter() - t2
        size = __import__("os").path.getsize(path)
        fresh_state = engine.init_state(WORLDS)
        fresh = GameScripts(engine, fresh_state)
        loaded, states = load_state((fresh_state, fresh.states()), path)
    fresh.load(states)
    resumed = game_run(engine, loaded, (GAME_TICKS - GAME_SAVE_AT) / 60,
                       scripts=fresh)
    same_game("game: saved at tick 30, loaded and resumed", resumed, run_a)
    # the checked tick
    dbg = debug_step(engine)
    err, _ = dbg(run_a[0])
    if err.get() is not None:
        fail(f"game: debug_step flags the healthy state: {err.get()}")
    ph = run_a[0].physics
    lv = ph.linvel.clone()
    lv[0, GAME_NAV_BODY, 0] = float("nan")
    bad, _ = dbg(run_a[0]._replace(physics=ph._replace(linvel=lv)))
    msg = bad.get()
    if msg is None or not msg.startswith("nan in stage physics"):
        fail(f"game: debug_step on a NaN velocity says {msg!r}")
    s = run_a[0]
    plain_ms = cuda_ms(lambda: engine.step(s), 5)
    debug_ms = cuda_ms(lambda: dbg(s)[0].get(), 5)
    log(f"[game] build_flagship(n_bodies=1000) + navmesh floor, W={WORLDS} "
        f"distinct worlds, {GAME_TICKS} Executor ticks (fused K3 → K2 → "
        f"K1, captured) with a flying camera, a nav agent (paths of "
        f"{int(nav.length.min())}-{int(nav.length.max())} waypoints, "
        f"{int((nav.wp >= nav.length).sum())} of {WORLDS} done), a behavior "
        f"tree (root statuses S/F/R over all ticks {hist}) and per-tick "
        f"stats: equal to eager ticks by hand bit for bit (eager launches "
        f"{n_eager}); launches of the Executor's run {n} (warm-up and "
        f"capture); save at tick {GAME_SAVE_AT} ({size / 2**20:.1f} MiB, "
        f"{save_s:.2f} s), load into a fresh state, resume: equal to the "
        f"uninterrupted run bit for bit; debug_step: None on its state, "
        f"{msg!r} on a NaN velocity")
    log(f"[game] {tick_ms:.3f} ms a tick (PerformanceStatistics: scripts + "
        f"captured tick, synchronised), {WORLDS * GAME_TICKS / wall:.1f} "
        f"env·steps/s over the run ({wall * 1e3:.1f} ms); a tick under "
        f"the profiler: {events:.1f} device events, {dev_ms:.3f} ms of "
        f"device time, kernels {kn} over 3 ticks; checked tick "
        f"(debug_step + get) {debug_ms:.3f} ms against a plain eager tick "
        f"{plain_ms:.3f} ms ({debug_ms / plain_ms:.2f}x) on {CARD}")


# ------------------------------------------------------------- game_frame
def game_frame_scene(num_crates=24, seed=0):
    """The port's counterpart of examples/example_game.py's build: a 24 m
    checkered ground, a tilted directional light, a camera with a
    listener, num_crates crates (cube meshes under rigid-body nodes) over
    a halfspace (dense broadphase), and a 220 Hz hum on the first crate.
    Returns the Engine."""
    from fyrox_tpu_torch.engine import Engine
    from fyrox_tpu_torch.physics import (CUBOID, HALFSPACE, BodyType,
                                         PhysicsBuilder)
    from fyrox_tpu_torch.render import Texture, make_cube, make_plane
    from fyrox_tpu_torch.scene import NodeType, SceneBuilder
    from fyrox_tpu_torch.sound.engine import SAMPLE_RATE
    rng = np.random.default_rng(seed)
    res = 16
    y, x = np.mgrid[0:res, 0:res]
    cell = ((x * 4 // res) + (y * 4 // res)) % 2
    checker = np.where(cell[..., None] == 0,
                       np.asarray([0.55, 0.55, 0.6], np.float32),
                       np.asarray([0.25, 0.3, 0.25], np.float32))
    sb = SceneBuilder()
    ground = make_plane(24.0, albedo=(1.0, 1.0, 1.0))
    ground.albedo_texture = Texture.from_array(checker.astype(np.float32))
    sb.add_mesh(ground, name="ground")
    tilt = (np.sin(np.pi / 5), 0.0, 0.0, np.cos(np.pi / 5))
    sb.add_light("directional", rotation=tilt, intensity=1.8)
    cam = sb.add_camera("cam", position=(0, 6.0, -12.0),
                        rotation=(np.sin(np.pi / 14), 0, 0,
                                  np.cos(np.pi / 14)))
    sb.add_listener("ears", parent=cam)
    pb = PhysicsBuilder()
    g = pb.add_body(body_type=BodyType.STATIC)
    pb.add_collider(g, HALFSPACE, [], friction=0.6)
    crates = []
    for i in range(num_crates):
        p = (rng.uniform(-4, 4), 1.0 + 0.9 * i % 7, rng.uniform(-4, 4))
        node = sb.add_node(f"crate{i}", node_type=NodeType.RIGID_BODY,
                           position=p,
                           bbox=(np.full(3, -0.35), np.full(3, 0.35)))
        sb.add_mesh(make_cube(0.6, albedo=(0.75, 0.45, 0.2)),
                    name=f"crate{i}_mesh", parent=node)
        b = pb.add_body(node=node, position=p)
        pb.add_collider(b, CUBOID, [0.3, 0.3, 0.3], friction=0.5)
        crates.append(node)
    t = np.arange(SAMPLE_RATE // 4) / SAMPLE_RATE
    hum = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    sb.add_sound(hum, name="crate_hum", parent=crates[0], radius=1.0,
                 max_distance=30.0)
    return Engine(template=sb.build(), physics=pb.build(broadphase="dense"))


def frame_loop(engine, state, frame, hud, keep=(), every=None):
    """example_game.py's loop: FRAME_TICKS Executor ticks, each after a
    script that mixes render_audio(256), and in on_frame the frame
    (render.CapturedFrame) with the HUD (each world's kinetic-energy bar
    and a 4-digit step counter) composed over it, every tick. keep: the
    ticks whose composed frames and states are kept; every: a list that
    each tick's state is appended to. Returns (state, {tick: (frames,
    state)}, audio peak, seconds)."""
    from fyrox_tpu_torch.script import Executor, Script
    from fyrox_tpu_torch.ui import compose_over
    w = state.scene.num_worlds
    dev = state.scene.position.device
    peak = []

    class Hum(Script):
        def on_update(self, ctx):
            block, ctx.state = ctx.engine.render_audio(ctx.state,
                                                       block_len=256)
            peak.append(block.abs().amax())

    kept, tick = {}, [0]

    def on_frame(s):
        tick[0] += 1
        if every is not None:
            every.append(s)
        color, _ = frame(s.scene)
        ke = 0.5 * (s.physics.linvel ** 2).sum((1, 2))
        overlay = hud.render({
            "energy": torch.clamp(ke / 100.0, 0.0, 1.0),
            "step": torch.full((w,), tick[0], dtype=torch.int32,
                               device=dev)})
        out = compose_over(color, overlay)
        if tick[0] in keep:
            kept[tick[0]] = (out, s)

    ex = Executor(engine, state)
    ex.scripts.add(Hum())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ex.run(FRAME_TICKS / 60, on_frame=on_frame)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, kept, float(torch.stack(peak).max()), \
        time.perf_counter() - t0


def phase_game_frame():
    """examples/example_game.py's game at W = 16 on the card: dense
    physics (K4a, K4b), render.CapturedFrame (K5) with shadows at 128²,
    render_audio(256) each tick and a HUD composed over every frame;
    the bin-demand audit; a W = 2 run against the same run on the CPU."""
    from fyrox_tpu_torch import convert
    from fyrox_tpu_torch.render import (CapturedFrame, RenderConfig,
                                        build_render_template,
                                        render_frame_demand, tile_raster)
    from fyrox_tpu_torch.ui import Hud, compose_over
    engine = game_frame_scene()
    t = engine.template
    rt = build_render_template(t)
    cfg = RenderConfig(width=128, height=128, shadows=True)
    frame = CapturedFrame(t, rt, cfg)
    hud = (Hud(128, 128).add_bar("energy", x=8, y=8, w=112, h=6)
           .add_counter("step", x=8, y=18, digits=4, scale=1))

    def start(w, device):
        st = engine.init_state(w, device=device)
        return st._replace(physics=jitter(st.physics, engine.physics,
                                          device, seed=5))

    st = start(FRAME_WORLDS, "cuda")
    reset_all_launches()
    tile_raster.reset_launches()
    out, _, peak, _ = frame_loop(engine, st, frame, hud)
    n = all_launches()
    n.update(full=tile_raster.launches("full"),
             depth=tile_raster.launches("depth"))
    if not (n["plane_gather"] and n["plane_scatter"] and n["full"]
            and n["depth"]) or n["fused_bp"] or n["solve_tgs"]:
        fail(f"game_frame: launches of the loop {n}")
    if not (0.0 < peak < 10.0):
        fail(f"game_frame: audio peak {peak}")
    # the timed loop: the tick and the frame captured already
    out2, kept, _, secs = frame_loop(engine, st, frame, hud,
                                     keep=(FRAME_TICKS,))
    same_state("game_frame: a second loop", out2, out)
    frames = kept[FRAME_TICKS][0]
    if not (frames.shape == (FRAME_WORLDS, 128, 128, 3)
            and bool(torch.isfinite(frames).all())
            and float(frames.std()) > 0.01 and all_differ(frames)):
        fail("game_frame: the composed frames are not finite, distinct "
             "images")
    _, demand, caps = render_frame_demand(out.scene, t, rt, cfg)
    dmax = [int(d) for d in demand.max(0).values.tolist()]
    over = [(p, d, k) for p, (d, k) in enumerate(zip(dmax, caps)) if d >= k]
    if over:
        fail(f"game_frame: bin overflow (pass, demand, cap) {over}")
    # W = 2: the card's run held tick by tick against the CPU, each CPU
    # tick (render_audio(256), then Engine.step) from the card's state
    # before it; the composed frames at FRAME_KEEP rendered on the CPU
    # from the card's state. Whole runs part: the crates' contacts
    # amplify the devices' last-bit differences (3.4 cm after 120 ticks
    # on an H100 against the CPU)
    gpu = start(2, "cuda")
    seen = [gpu]
    _, gk, _, _ = frame_loop(engine, gpu, frame, hud, keep=FRAME_KEEP,
                             every=seen)
    worst = [0.0, 0.0, 0.0, 1.0]
    for k in range(1, FRAME_TICKS + 1):
        prev = convert.engine_state(convert.to_numpy(seen[k - 1]),
                                    device="cpu")
        _, cs = engine.render_audio(prev, block_len=256)
        cs = engine.step(cs)
        gs = seen[k]
        worst[0] = max(worst[0], float((gs.physics.position.cpu()
                                        - cs.physics.position).abs().max()))
        worst[1] = max(worst[1], float((gs.physics.linvel.cpu()
                                        - cs.physics.linvel).abs().max()))
        if not torch.equal(gs.audio.playhead.cpu(), cs.audio.playhead):
            fail(f"game_frame: card vs CPU playheads differ at tick {k}")
        if k in FRAME_KEEP:
            sc = convert.scene_state(convert.to_numpy(gs.scene), device="cpu")
            color, _ = frame(sc)
            ke = 0.5 * (gs.physics.linvel.cpu() ** 2).sum((1, 2))
            cf = compose_over(color, hud.render({
                "energy": torch.clamp(ke / 100.0, 0.0, 1.0),
                "step": torch.full((2,), k, dtype=torch.int32)}))
            err = (gk[k][0].cpu() - cf).abs()
            worst[2] = max(worst[2], float(err.max()))
            worst[3] = min(worst[3], float((err <= 1e-4).float().mean()))
    if not (worst[0] < 5e-4 and worst[1] < 5e-3 and worst[3] >= 0.999):
        fail(f"game_frame: card vs CPU tick by tick: dp {worst[0]:.3g}, dv "
             f"{worst[1]:.3g}; frames at ticks {FRAME_KEEP}: colours "
             f"{worst[2]:.3g} max, {worst[3]:.4f} within 1e-4")
    log(f"[game_frame] example_game.py's game: {len(engine.physics.body_type) - 1} "
        f"crates (dense, {engine.physics.num_pairs} pairs), 16² checker "
        f"ground, crate hum, W={FRAME_WORLDS} distinct worlds, "
        f"{FRAME_TICKS} Executor ticks each with render_audio(256) "
        f"(peak {peak:.3f}) and a 128² shadowed CapturedFrame + HUD "
        f"composed in on_frame: launches of the first loop {n} (the "
        f"tick's and the frame's warm-ups and captures); bin demand "
        f"{list(zip(dmax, caps))}; W=2, each of {FRAME_TICKS} card ticks "
        f"against the CPU from the card's state: dp {worst[0]:.3g} (bound "
        f"5e-4), dv {worst[1]:.3g} (bound 5e-3), playheads equal; frames "
        f"at ticks {FRAME_KEEP}: colours {worst[2]:.3g} max, "
        f"{worst[3]:.4f} within 1e-4 (bound 0.999)")
    log(f"[game_frame] the whole loop: {FRAME_TICKS / secs:.1f} frames/s "
        f"({FRAME_TICKS * FRAME_WORLDS / secs:.1f} world-frames/s; "
        f"{secs * 1e3 / FRAME_TICKS:.3f} ms a tick + audio + frame + HUD) "
        f"on {CARD}")


# --------------------------------------------------------------------- ui
UI_WORLDS = 16           # example_hud.py's scene at W = 16
UI_SIZE = 128            # its frame and screen, pixels a side
UI_TICKS = 60
UI_FONT_PX = 9           # the FontAtlas every text command draws with
UI_STATES = 4            # moved scene states the loop's ticks cycle over
MODIFIERS = ("Shift", "Control", "Alt")


def hud_scene():
    """examples/example_hud.py's scene with the port's builders: ground,
    two lit cubes, a directional light with shadows and the camera.
    Returns the template."""
    from fyrox_tpu_torch.render import make_cube, make_plane
    from fyrox_tpu_torch.scene import SceneBuilder
    sb = SceneBuilder()
    sb.add_mesh(make_plane(20.0, albedo=(0.45, 0.5, 0.4)), name="ground")
    sb.add_mesh(make_cube(1.0, albedo=(0.8, 0.3, 0.2)), position=(0, 0.5, 4))
    sb.add_mesh(make_cube(1.0, albedo=(0.2, 0.4, 0.8)), position=(2, 0.5, 6))
    tilt = (np.sin(np.pi / 3), 0.0, 0.0, np.cos(np.pi / 3))
    sb.add_light("directional", rotation=tilt, intensity=2.0)
    down = (np.sin(np.pi / 10), 0.0, 0.0, np.cos(np.pi / 10))
    sb.add_camera("cam", position=(0, 3.0, -4.0), rotation=down)
    return sb.build()


def hud_ui(core, size=UI_SIZE):
    """The loop's widget tree with either package's ui.core module:
    example_hud.py's STATS window (a stack of two texts) and health bar, a
    3 x 2 grid of labels, a wrap panel of six buttons, a scroll viewer over
    a five-line text block, a text box and a progress bar; 30 widgets.
    Returns (ui, {name: handle})."""
    W_ = core.Widget
    ui = core.UserInterface((size, size))
    h = {}
    h["stats"] = ui.add(W_(kind="window", title="STATS", width=70.0,
                           height=46.0, margin=(4, 4, 0, 0),
                           title_height=14.0,
                           background=(0.05, 0.05, 0.1, 0.65)))
    body = ui.add(W_(kind="stack"), h["stats"])
    h["fps"] = ui.add(W_(kind="text", text="FPS 60", height=14.0), body)
    h["hp"] = ui.add(W_(kind="text", text="HP 87", height=14.0), body)
    h["bar"] = ui.add(W_(kind="border", width=100.0, height=8.0,
                         margin=(4, float(size - 16), 0, 0),
                         background=(0.2, 0.0, 0.0, 0.9),
                         foreground=(0.9, 0.9, 0.9, 1.0)))
    h["fill"] = ui.add(W_(kind="border", width=87.0, height=8.0,
                          background=(0.1, 0.8, 0.1, 0.9)), h["bar"])
    h["grid"] = ui.add(W_(kind="grid", width=46.0, height=39.0,
                          margin=(78, 4, 0, 0), rows=[("strict", 13.0)] * 3,
                          columns=[("strict", 23.0), ("stretch",)],
                          background=(0.1, 0.1, 0.1, 0.5)))
    for i, s in enumerate(("X", "1", "Y", "2", "Z", "3")):
        ui.add(W_(kind="text", text=s, font_size=8.0, grid_row=i // 2,
                  grid_column=i % 2), h["grid"])
    h["wrap"] = ui.add(W_(kind="wrap", orientation="horizontal", width=60.0,
                          margin=(4, 54, 0, 0)))
    for s in "ABCDEF":
        h["btn" + s] = ui.add(W_(kind="button", text=s, font_size=8.0),
                              h["wrap"])
    h["scroll"] = ui.add(W_(kind="scroll", width=58.0, height=30.0,
                            margin=(66, 54, 0, 0),
                            background=(0.0, 0.0, 0.0, 0.4)))
    lines = ui.add(W_(kind="stack"), h["scroll"])
    for i in range(5):
        ui.add(W_(kind="text", text=f"LOG {i}", font_size=8.0), lines)
    h["name"] = ui.add(W_(kind="textbox", text="hero", width=58.0,
                          height=14.0, font_size=8.0, margin=(66, 88, 0, 0)))
    h["tick"] = ui.add(W_(kind="progress", width=120.0, height=6.0,
                          margin=(4, 104, 0, 0),
                          foreground=(0.9, 0.8, 0.2, 1.0)))
    ui.update_layout()
    return ui, h


def hud_event(ui, h, k):
    """The loop's OS event at tick k (an InputState event dict), aimed at
    the widgets' current rects: focus the text box and edit it (End,
    shift-selection, typing, Backspace, Enter), Tab focus, wheel the
    scroll viewer down and up, click a wrapped button and drag the STATS
    window by its title, with mouse moves between."""
    def at(name, dx=0.5, dy=0.5):
        r = ui.nodes.borrow(h[name]).actual_rect
        return {"type": "mouse_move", "x": r.x + r.w * dx,
                "y": r.y + r.h * dy}

    def key(name, up=False):
        return {"type": "key_up" if up else "key_down", "key": name}

    script = [at("name"), {"type": "mouse_down", "button": 0},
              {"type": "mouse_up", "button": 0}, key("End"), key("Shift"),
              key("Left"), key("Left"), key("Shift", True), key("7"),
              key("Backspace"), key("x"), key("Home"), key("Right"),
              key("Delete"), key("Enter"), key("Tab"), key("Tab"),
              at("scroll"), {"type": "wheel", "delta": -6.0},
              {"type": "wheel", "delta": -6.0},
              {"type": "wheel", "delta": 4.0}, at("btnC"),
              {"type": "mouse_down", "button": 0},
              {"type": "mouse_up", "button": 0},
              at("stats", 0.5, 0.1), {"type": "mouse_down", "button": 0},
              {"type": "mouse_move", "x": 40.0, "y": 8.0},
              {"type": "mouse_up", "button": 0}]
    if k < len(script):
        return script[k]
    return {"type": "mouse_move", "x": float(k % 13) * 9.0,
            "y": float(k % 7) * 17.0}


def ui_event(inp, ev):
    """The UserInterface event of an OS event that InputState inp has just
    taken (None where the UI has none): a press of button 0 clicks at the
    pointer, a move with it held drags from where the pointer was, the
    wheel scrolls at the pointer, and a key press other than a modifier is
    a key with the held modifiers."""
    t = ev.get("type")
    x, y = inp.mouse_position
    if t == "mouse_down" and ev["button"] == 0:
        return {"type": "click", "x": x, "y": y}
    if t == "mouse_move" and 0 in inp.mouse_buttons:
        dx, dy = inp.mouse_delta
        return {"type": "drag", "x": x - dx, "y": y - dy, "dx": dx,
                "dy": dy}
    if t == "wheel":
        return {"type": "scroll", "x": x, "y": y, "dy": ev["delta"]}
    if t == "key_down" and ev["key"] not in MODIFIERS:
        return {"type": "key", "key": ev["key"],
                "shift": "Shift" in inp.keys_down,
                "ctrl": "Control" in inp.keys_down,
                "alt": "Alt" in inp.keys_down}
    return None


def hud_tick(ui, h, inp, k, dt=1 / 60):
    """One tick of the loop's UI: the tick's OS event to inp and, through
    ui_event, to ui; the bound widgets (HP text, the bar's fill, the
    progress bar) set from the tick; ui.update(dt) and update_layout().
    Returns the messages the tick polled."""
    ev = hud_event(ui, h, k)
    inp.process_event(ev)
    uev = ui_event(inp, ev)
    if uev is not None:
        ui.process_os_event(uev)
    ui.nodes.borrow(h["hp"]).text = f"HP {87 - k // 6}"
    ui.nodes.borrow(h["fill"]).width = float(87 - k // 6)
    ui.nodes.borrow(h["tick"]).progress = (k + 1) / UI_TICKS
    ui.update(dt)
    ui.update_layout()
    inp.end_frame()
    msgs = []
    m = ui.poll_message()
    while m is not None:
        msgs.append(m)
        m = ui.poll_message()
    return msgs


def uninked_text(cmds, img):
    """The text commands (of text in a rect of at least a pixel a side,
    inside the screen) whose rects hold no covered pixel of img; [] when
    every one is inked."""
    H, W = img.shape[:2]
    bare = []
    for c in cmds:
        b = c.bounds
        if c.kind != "text" or not str(c.text).strip() or b.w < 1 or \
                b.h < 1 or b.x < 0 or b.y < 0 or b.x + b.w > W or \
                b.y + b.h > H:
            continue
        if not (img[int(b.y):int(np.ceil(b.y + b.h)),
                    int(b.x):int(np.ceil(b.x + b.w)), 3] > 0).any():
            bare.append((c.text, (b.x, b.y, b.w, b.h)))
    return bare


def phase_ui():
    """examples/example_hud.py on the card: its scene through
    render.CapturedFrame (K5) at W = UI_WORLDS, UI_SIZE², worlds moved
    apart, under hud_ui's tree drawn with a TrueType font (write_ttf):
    UI_TICKS ticks, each one replayed frame, one scripted OS event to
    InputState and the UI, update / layout / draw, render_ui through a
    FontAtlas and compose_over on the card. Every tick's composed frames
    equal the CPU's compose_over of the replayed frames copied to the CPU,
    bit for bit; then the loop timed with the UI and without it."""
    from fyrox_tpu_torch import render
    from fyrox_tpu_torch.input import InputState
    from fyrox_tpu_torch.render import tile_raster
    from fyrox_tpu_torch.scene import graph, init_state
    from fyrox_tpu_torch.ui import compose_over, core, render_ui
    from fyrox_tpu_torch.ui.font import FontAtlas, TtfFont
    t = hud_scene()
    rt = render.build_render_template(t)
    cfg = render.RenderConfig(width=UI_SIZE, height=UI_SIZE, shadows=True,
                              sky_zenith=(0.3, 0.5, 0.8),
                              sky_horizon=(0.8, 0.85, 0.9))
    frame = render.CapturedFrame(t, rt, cfg)
    st = graph.update_hierarchical_data(init_state(t, UI_WORLDS,
                                                   device="cuda"), t)
    states = [moved_state(st, seed) for seed in range(UI_STATES)]
    t0 = time.perf_counter()
    font = TtfFont(write_ttf())
    atlas = FontAtlas(font, UI_FONT_PX)
    atlas_s = time.perf_counter() - t0
    tile_raster.reset_launches()
    frame(states[0])
    n5 = dict(full=tile_raster.launches("full"),
              depth=tile_raster.launches("depth"))
    if not (n5["full"] and n5["depth"]):
        fail(f"ui: K5 launches of the frame's capture {n5}")

    # the checked loop
    ui, h = hud_ui(core)
    inp = InputState()
    n_msgs, n_cmds, worst = 0, 0, 0
    for k in range(UI_TICKS):
        color = frame(states[k % UI_STATES])[0]
        n_msgs += len(hud_tick(ui, h, inp, k))
        cmds = ui.draw()
        n_cmds = max(n_cmds, len(cmds))
        img = render_ui(cmds, UI_SIZE, UI_SIZE, font=atlas)
        out = compose_over(color, img)
        want = compose_over(color.cpu(), img)
        if not torch.equal(out.cpu(), want):
            fail(f"ui: tick {k}: the card's compose_over differs from the "
                 f"CPU's by {float((out.cpu() - want).abs().max()):.3g}")
        bare = uninked_text(cmds, img)
        if bare:
            fail(f"ui: tick {k}: text rects with no covered pixel {bare}")
    plain = render_ui(cmds, UI_SIZE, UI_SIZE)
    if np.array_equal(plain, img) or not (plain[..., 3] > 0).any():
        fail("ui: the 5x7 and TrueType paths give the same image")
    if not (out.shape == (UI_WORLDS, UI_SIZE, UI_SIZE, 3)
            and bool(torch.isfinite(out).all()) and all_differ(out)):
        fail("ui: the composed frames are not finite, distinct images")
    box = ui.nodes.borrow(h["name"])
    if box.text == "hero" or inp.mouse_buttons or n_msgs == 0:
        fail(f"ui: the script did not reach the UI (text {box.text!r}, "
             f"{n_msgs} messages)")

    # the timed loops: with the UI (its host stages timed), then without
    ui, h = hud_ui(core)
    inp = InputState()
    host = np.zeros(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(UI_TICKS):
        color = frame(states[k % UI_STATES])[0]
        a = time.perf_counter()
        hud_tick(ui, h, inp, k)
        b = time.perf_counter()
        cmds = ui.draw()
        c = time.perf_counter()
        img = render_ui(cmds, UI_SIZE, UI_SIZE, font=atlas)
        d = time.perf_counter()
        host += (b - a, c - b, d - c)
        out = compose_over(color, img)
    torch.cuda.synchronize()
    with_ui = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in range(UI_TICKS):
        color = frame(states[k % UI_STATES])[0]
    torch.cuda.synchronize()
    without = time.perf_counter() - t0
    ui_dev = torch.as_tensor(img, device="cuda")
    comp_dev = device_ms(lambda: compose_over(color, ui_dev), 20)
    comp_host = cuda_ms(lambda: compose_over(color, img), 20)
    host_ms = host * 1e3 / UI_TICKS
    log(f"[ui] example_hud.py's scene (ground, 2 cubes, shadowed "
        f"directional light) through CapturedFrame at W={UI_WORLDS}, "
        f"{UI_SIZE}² (K5 at the capture {n5}), under a "
        f"{len(list(ui.nodes.iter()))}-widget tree in a {len(write_ttf())}"
        f"-byte TrueType font (write_ttf) at {UI_FONT_PX} px: {UI_TICKS} "
        f"ticks of one OS event each ({n_msgs} UI messages, up to {n_cmds} "
        f"draw commands), every composed frame equal bit for bit to the "
        f"CPU's compose_over of the replayed frame; text rects inked; 5x7 "
        f"and TrueType images differ; text box edited to {box.text!r}")
    log(f"[ui] host ms a tick: layout (event + update + update_layout) "
        f"{host_ms[0]:.4f}, draw {host_ms[1]:.4f}, render_ui "
        f"{host_ms[2]:.4f}; FontAtlas build (parse + {UI_FONT_PX} px "
        f"atlas) once {atlas_s * 1e3:.2f} ms; compose_over device ms "
        f"{comp_dev:.4f} (UI image on the card), {comp_host:.4f} ms with "
        f"the image's upload (CUDA events); on {CARD}")
    log(f"[ui] frames/s of the loop: with the UI "
        f"{UI_TICKS / with_ui:.1f} ({with_ui * 1e3 / UI_TICKS:.3f} ms a "
        f"tick), without it (replayed frame only) {UI_TICKS / without:.1f} "
        f"({without * 1e3 / UI_TICKS:.3f} ms a tick); on {CARD}")


# --------------------------------------------------------------- navfield
def walled_grid(side=NAV_SIDE, every=32):
    """A side x side grid with a wall every `every` columns, open at the
    top and the bottom row in turn: a serpentine whose longest shortest
    path is far longer than the open grid's diameter."""
    blocked = []
    for k, x in enumerate(range(every, side, every)):
        gap = side - 1 if k % 2 == 0 else 0
        blocked += [y * side + x for y in range(side) if y != gap]
    return blocked


def phase_navfield():
    """distance_field on a walled 256² grid graph, 128 sources, with
    enough rounds for the longest shortest path: equal to the hop counts
    of a host BFS (scipy) for every source, and to host A* costs for 8."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path
    from fyrox_tpu_torch.utils import (astar_search, build_grid_graph,
                                       distance_field, pack_adjacency)
    t0 = time.perf_counter()
    blocked = walled_grid()
    verts, nbrs = build_grid_graph(NAV_SIDE, NAV_SIDE, blocked)
    idx, w = pack_adjacency(verts, nbrs)
    n = len(verts)
    rows = np.repeat(np.arange(n), [len(b) for b in nbrs])
    graph = csr_matrix((np.ones(len(rows)), (rows, np.concatenate(
        [b for b in nbrs if b] or [[]]).astype(np.int64))), shape=(n, n))
    rng = np.random.default_rng(17)
    free = np.setdiff1d(np.arange(n), blocked)
    src = rng.choice(free, NAV_SOURCES, replace=False)
    hops = shortest_path(graph, unweighted=True, indices=src)
    iters = int(hops[np.isfinite(hops)].max()) + 1
    setup = time.perf_counter() - t0
    sources = torch.as_tensor(src, device="cuda")
    dist = distance_field(idx, w, sources, num_iters=iters)
    want = torch.as_tensor(hops.astype(np.float32), device="cuda")
    if not torch.equal(dist, want):
        fail(f"navfield: distance_field differs from the BFS hop counts "
             f"({int((dist != want).sum())} of {dist.numel()})")
    goals = rng.choice(free, NAV_ASTAR)
    t1 = time.perf_counter()
    for k, (s, g) in enumerate(zip(src[:NAV_ASTAR], goals)):
        path = astar_search(verts, nbrs, int(s), int(g))
        cost = len(path) - 1 if path else float("inf")
        if float(dist[k, g]) != cost:
            fail(f"navfield: A* cost {cost} from {s} to {g}, field "
                 f"{float(dist[k, g])}")
    astar_s = time.perf_counter() - t1
    ms = cuda_ms(lambda: distance_field(idx, w, sources, num_iters=iters), 2)
    default = int(2 * np.sqrt(n) + 8)
    short = distance_field(idx, w, sources)
    unreached = int(torch.isinf(short).sum() - torch.isinf(dist).sum())
    log(f"[navfield] distance_field on a {NAV_SIDE}² grid graph (N={n}, "
        f"4-connected, {len(blocked)} wall vertices, serpentine), "
        f"Wb={NAV_SOURCES} sources, {iters} rounds (the longest shortest "
        f"path + 1; the default {default} leaves {unreached} vertex-source "
        f"pairs at inf): equal to a host BFS for every source and to host "
        f"A* for {NAV_ASTAR} ({astar_s:.1f} s on the host); {ms:.2f} ms a call "
        f"({ms / iters * 1e3:.1f} µs a round of [{NAV_SOURCES}, {n}, 4]); "
        f"graph set-up {setup:.1f} s on the host; on {CARD}")


# --------------------------------------------------------------- lightmap
def world_triangles(t, rt, st, world=0):
    """(vertex positions [V,3], normals [V,3], triangle soup [T,3,3]) of
    the render template in world `world`'s global transforms."""
    g = st.globals_[world, torch.as_tensor(rt.vert_node.astype(np.int64),
                                           device=st.globals_.device)]
    p = torch.as_tensor(rt.positions, device=g.device)
    nrm = torch.as_tensor(rt.normals, device=g.device)
    wp = (g[:, :3, :3] @ p[:, :, None])[..., 0] + g[:, :3, 3]
    wn = (g[:, :3, :3] @ nrm[:, :, None])[..., 0]
    wn = wn / torch.linalg.vector_norm(wn, dim=-1, keepdim=True)
    tris = wp[torch.as_tensor(rt.triangles.astype(np.int64),
                              device=g.device)]
    return wp, wn, tris


def phase_lightmap():
    """bake_vertex_ao (32 rays) and bake_direct_light over bench_render.py's
    scene (T = 4,482): card against CPU on 256 vertices; ms and
    vertices/s over every vertex."""
    from fyrox_tpu_torch.utils import lightmap
    t, rt, st, _ = render_scene(1, "cuda")
    pos, nrm, tris = world_triangles(t, rt, st)
    v, tcount = pos.shape[0], tris.shape[0]
    sub = torch.as_tensor(np.random.default_rng(23).choice(
        v, LIGHTMAP_CPU_VERTS, replace=False), device="cuda")
    sun = (0.4, -1.0, 0.3)
    ao_ms = cuda_ms(lambda: lightmap.bake_vertex_ao(
        pos, nrm, tris, n_rays=LIGHTMAP_RAYS, max_dist=4.0), 2)
    dl_ms = cuda_ms(lambda: lightmap.bake_direct_light(
        pos, nrm, tris, light_dir=sun), 2)
    ao = lightmap.bake_vertex_ao(pos, nrm, tris, n_rays=LIGHTMAP_RAYS,
                                 max_dist=4.0)
    dl = lightmap.bake_direct_light(pos, nrm, tris, light_dir=sun)
    cpu = [x.cpu() for x in (pos[sub], nrm[sub], tris)]
    cao = lightmap.bake_vertex_ao(*cpu, n_rays=LIGHTMAP_RAYS, max_dist=4.0,
                                  device="cpu")
    cdl = lightmap.bake_direct_light(*cpu, light_dir=sun, device="cpu")
    dao = float((ao[sub].cpu() - cao).abs().max())
    ddl = float((dl[sub].cpu() - cdl).abs().max())
    if not (dao == 0.0 and ddl <= 1e-6 and bool(torch.isfinite(ao).all())
            and 0.0 < float(ao.mean()) < 1.0 and float(dl.max()) > 0.1):
        fail(f"lightmap: card vs CPU AO {dao:.3g}, direct {ddl:.3g}; AO mean "
             f"{float(ao.mean()):.3f}")
    rows = max(1, lightmap.RAY_TRI_BUDGET // tcount)
    log(f"[lightmap] bench_render.py's scene (V={v}, T={tcount}): "
        f"bake_vertex_ao ({LIGHTMAP_RAYS} rays) {ao_ms:.2f} ms "
        f"({v / ao_ms * 1e3:.0f} vertices/s, AO mean {float(ao.mean()):.3f}),"
        f" bake_direct_light {dl_ms:.2f} ms ({v / dl_ms * 1e3:.0f} "
        f"vertices/s); rays in batches of {rows} ({rows // LIGHTMAP_RAYS} "
        f"vertices of AO) so a [rays, T] intermediate holds at most 2^24 "
        f"floats; card vs CPU on "
        f"{LIGHTMAP_CPU_VERTS} vertices: AO equal, direct light {ddl:.3g} "
        f"max on {CARD}")


# ---------------------------------------------------------------- assets
# The content path: files written here (the packages have no glTF or .rgs
# scene writer), read back through the port's loaders and the resource
# manager, then stepped, rendered and edited on the card.
ASSET_BONES = 100
ASSET_VERTS = 50_000
ASSET_BODIES = 1000
RGS_NODES = 64
LEVEL_ROWS, LEVEL_COLS = 24, 96    # the tilemap level's cells
LEVEL_BALLS = 64
LEVEL_SIZE = 256                   # the level's frame, pixels a side
LEVEL_CAPS = dict(k_per_tile=2048, csm_k_per_tile=4096)
EDITOR_PLAY = 0.5                  # seconds of play mode at 60 Hz
# Data.TypeUuid of the Fyrox node types that io.rgs_scene maps
FYROX_TYPES = dict(
    pivot="57c125ff-e54d-44c0-a9b1-17b8451a1e8d",
    camera="198d3aca-433c-4ce1-bb25-3190699b757f",
    mesh="caaf9d7b-bd74-48ce-b7cc-57e9dc65c2e6",
    sprite="60fd7e34-46c1-4ae9-8803-1f5f4c48695a",
    point_light="12639b99-e1cf-46a8-a34a-c3cc5db8b22e",
    spot_light="23658785-7ceb-4d25-8baa-5200cc2db7b0",
    directional_light="8b210ffc-f1fa-4b8b-b4a5-afc10a9a9d9e",
    sound="28621735-8cd1-4fad-8faf-ecd24bf8aa99",
    listener="2c7dabc1-5666-4256-b020-01532701e4c6")


def euler_to_quat(ex, ey, ez):
    """[K, 4] (x, y, z, w) quaternions of the engine's Euler rotation
    tracks (R = Rz Ry Rx, the order io.gltf's conversion inverts)."""
    cx, sx = np.cos(np.asarray(ex) / 2), np.sin(np.asarray(ex) / 2)
    cy, sy = np.cos(np.asarray(ey) / 2), np.sin(np.asarray(ey) / 2)
    cz, sz = np.cos(np.asarray(ez) / 2), np.sin(np.asarray(ez) / 2)
    return np.stack([sx * cy * cz - cx * sy * sz,
                     cx * sy * cz + sx * cy * sz,
                     cx * cy * sz - sx * sy * cz,
                     cx * cy * cz + sx * sy * sz], -1)


def write_glb(nodes, skin=None, channels=(), clip="clip",
              weights_dtype=np.float32):
    """A binary glTF 2.0 container (.glb) of
      nodes: dicts with name, parent (-1 for roots) and either matrix
        ([4, 4], row-major as numpy holds it) or translation / rotation
        (x, y, z, w) / scale;
      skin: dict(node, joints, inv_bind [B, 4, 4], positions [V, 3],
        triangles [T, 3], joints4 [V, 4], weights4 [V, 4]): one mesh
        primitive on `node`, skinned to the glTF nodes `joints`; weights
        written as float32, or as normalised uint8 / uint16;
      channels: (node, path, times [K], values [K, 3 or 4]) LINEAR
        samplers of one clip."""
    import struct
    blob = bytearray()
    views, accessors = [], []

    def add(arr, ctype, kind):
        arr = np.ascontiguousarray(arr)
        while len(blob) % 4:
            blob.append(0)
        views.append(dict(buffer=0, byteOffset=len(blob),
                          byteLength=arr.nbytes))
        blob.extend(arr.tobytes())
        accessors.append(dict(bufferView=len(views) - 1, componentType=ctype,
                              count=int(arr.shape[0]), type=kind))
        return len(accessors) - 1

    docs = []
    for i, n in enumerate(nodes):
        d = {"name": n["name"]}
        if n.get("matrix") is not None:
            d["matrix"] = np.asarray(n["matrix"], np.float64).T.reshape(
                16).tolist()
        for key in ("translation", "rotation", "scale"):
            if n.get(key) is not None:
                d[key] = np.asarray(n[key], np.float64).tolist()
        kids = [j for j, c in enumerate(nodes) if c["parent"] == i]
        if kids:
            d["children"] = kids
        docs.append(d)
    doc = {"asset": {"version": "2.0"}, "nodes": docs,
           "scenes": [{"nodes": [i for i, n in enumerate(nodes)
                                 if n["parent"] < 0]}]}
    if skin is not None:
        wd = np.dtype(weights_dtype)
        w4 = np.asarray(skin["weights4"], np.float32)
        if wd != np.float32:
            w4 = np.round(w4 * np.iinfo(wd).max).astype(wd)
        ctype = {np.dtype(np.float32): 5126, np.dtype(np.uint8): 5121,
                 np.dtype(np.uint16): 5123}[wd]
        prim = {"attributes": {
            "POSITION": add(np.asarray(skin["positions"], np.float32),
                            5126, "VEC3"),
            "JOINTS_0": add(np.asarray(skin["joints4"], np.uint16), 5123,
                            "VEC4"),
            "WEIGHTS_0": add(w4, ctype, "VEC4")},
            "indices": add(np.asarray(skin["triangles"], np.uint32)
                           .reshape(-1), 5125, "SCALAR")}
        doc["meshes"] = [{"primitives": [prim]}]
        ibm = np.asarray(skin["inv_bind"], np.float32).transpose(0, 2, 1)
        doc["skins"] = [{"joints": [int(j) for j in skin["joints"]],
                         "inverseBindMatrices": add(ibm.reshape(-1, 16), 5126,
                                                    "MAT4")}]
        docs[skin["node"]].update(mesh=0, skin=0)
    if channels:
        samplers, chans = [], []
        for node, path, times, values in channels:
            values = np.asarray(values, np.float32)
            samplers.append(dict(
                input=add(np.asarray(times, np.float32), 5126, "SCALAR"),
                output=add(values, 5126, f"VEC{values.shape[1]}"),
                interpolation="LINEAR"))
            chans.append(dict(sampler=len(samplers) - 1,
                              target=dict(node=int(node), path=path)))
        doc["animations"] = [dict(name=clip, samplers=samplers,
                                  channels=chans)]
    while len(blob) % 4:
        blob.append(0)
    doc["buffers"] = [{"byteLength": len(blob)}]
    doc["bufferViews"] = views
    doc["accessors"] = accessors
    text = json.dumps(doc).encode()
    text += b" " * (-len(text) % 4)
    body = (struct.pack("<II", len(text), 0x4E4F534A) + text
            + struct.pack("<II", len(blob), 0x004E4942) + bytes(blob))
    return struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body


def character_glb(n_bones=ASSET_BONES, n_verts=ASSET_VERTS, seed=0):
    """The flagship's character (models.character.build_character_scene:
    its bone tree, its dense-weight skin of 4 influences a vertex and its
    walk clip) as a .glb: the skin's inverse binds from the bind pose, the
    clip's Euler rotation tracks as quaternion rotation channels, and a
    translation channel on the character's root (a 5 cm bob)."""
    from fyrox_tpu_torch.models import build_character_scene
    from fyrox_tpu_torch.scene import graph, init_state
    sb, aset, _, bones, (verts, idx4, w4) = build_character_scene(
        n_bones=n_bones, n_verts=n_verts, seed=seed, with_machine=False)
    t = sb.build()
    bind = graph.update_hierarchical_data(init_state(t, 1, device="cpu"),
                                          t).globals_[0].numpy()
    nodes = [dict(name=r.name, parent=r.parent, translation=r.position,
                  rotation=r.rotation, scale=r.scale) for r in sb._nodes]
    nodes.append(dict(name="character_mesh", parent=-1))
    rc = aset.rot_curves
    channels = []
    for k in np.flatnonzero(aset.rot_anim == aset.names.index("walk")):
        rows = 3 * k + np.arange(3)
        nk = int(rc.n_keys[rows[0]])
        ex, ey, ez = (rc.values[r, :nk].astype(np.float64) for r in rows)
        channels.append((int(aset.rot_node[k]), "rotation",
                         rc.times[rows[0], :nk], euler_to_quat(ex, ey, ez)))
    times = np.linspace(0.0, 1.0, 5)
    bob = np.zeros((5, 3))
    bob[:, 1] = 0.05 * np.sin(2 * np.pi * times)
    channels.append((0, "translation", times, bob))
    tris = np.arange(3 * (n_verts // 3)).reshape(-1, 3)
    skin = dict(node=len(nodes) - 1, joints=bones,
                inv_bind=np.linalg.inv(bind[np.asarray(bones)]),
                positions=verts, triangles=tris, joints4=idx4, weights4=w4)
    return write_glb(nodes, skin=skin, channels=channels, clip="walk")


def fyrox_scene(n_nodes=RGS_NODES, seed=0, moved=None):
    """A Fyrox scene's Visitor tree in the graph layout Scene::save writes
    (Scene → Graph → Pool → Records → ItemN → Payload → Data → NodeData),
    for io.visitor.write_rgs: n_nodes live nodes cycling through the node
    types io.rgs_scene maps, two free pool slots, one item in seven in the
    legacy ItemData layout, typed nodes with their fields under NodeData →
    Base, names as plain, inheritable and legacy blob fields, transforms
    as inheritable regions and inline fields, pivot terms on some nodes
    (identity ones too), hidden nodes, and parents that point at earlier
    live slots or at a free slot (loaded as roots). `moved`: the index of
    a live node whose position moves 1 m along x."""
    import uuid
    from fyrox_tpu_torch.io.visitor import VisitorNode
    rng = np.random.default_rng(seed)
    kinds = list(FYROX_TYPES)
    free = (5, n_nodes // 2 + 3)
    root = VisitorNode("__ROOT__")
    records = VisitorNode("Records")
    parent_node = root
    for name in ("Scene", "Graph", "Pool"):
        node = VisitorNode(name)
        parent_node.children.append(node)
        parent_node = node
    parent_node.children.append(records)
    live = []
    for s in range(n_nodes + len(free)):
        item = VisitorNode(f"Item{s}")
        records.children.append(item)
        holder = item
        if s % 7 == 3:
            holder = VisitorNode("ItemData")
            item.children.append(holder)
        payload = VisitorNode("Payload")
        holder.children.append(payload)
        if s in free:
            payload.add("IsSome", "u8", 0)
            continue
        i = len(live)
        payload.add("IsSome", "u8", 1)
        data = VisitorNode("Data")
        payload.children.append(data)
        kind = kinds[i % len(kinds)]
        data.add("TypeUuid", "uuid", uuid.UUID(FYROX_TYPES[kind]).bytes)
        nd = VisitorNode("NodeData")
        data.children.append(nd)
        base = nd
        if kind != "pivot":
            base = VisitorNode("Base")
            nd.children.append(base)
        name = f"{kind}{i}"
        if i % 3 == 0:
            base.add("Name", "string", name)
        else:
            region = VisitorNode("Name")
            if i % 3 == 1:
                region.add("Value", "string", name)
            else:
                raw = name.encode()
                region.add("Length", "u32", len(raw)).add("Data", "blob", raw)
            base.children.append(region)
        tf = VisitorNode("Transform")
        base.children.append(tf)

        def field(name, kind, value, inline):
            if inline:
                tf.add(name, kind, value)
            else:
                region = VisitorNode(name)
                region.add("Value", kind, value)
                tf.children.append(region)

        pos = rng.uniform(-2.0, 2.0, 3).astype(np.float32)
        if i == moved:
            pos[0] += 1.0
        q = rng.normal(size=4)
        field("LocalPosition", "vec3f32", pos, i % 2 == 0)
        field("LocalRotation", "quat",
              (q / np.linalg.norm(q)).astype(np.float32), i % 2 == 1)
        field("LocalScale", "vec3f32",
              rng.uniform(0.5, 1.5, 3).astype(np.float32), i % 4 == 0)
        if i % 11 == 1:
            pre = rng.normal(size=4)
            field("PreRotation", "quat",
                  (pre / np.linalg.norm(pre)).astype(np.float32), False)
        if i % 13 == 2:
            field("RotationPivot", "vec3f32",
                  rng.uniform(-0.5, 0.5, 3).astype(np.float32), True)
        if i % 5 == 4:          # identity terms load as absent
            field("ScalingOffset", "vec3f32", np.zeros(3, np.float32), False)
        if i % 9 == 8:
            base.add("Visibility", "bool", False)
        elif i % 2:
            region = VisitorNode("Visibility")
            region.add("Value", "bool", True)
            base.children.append(region)
        if i:
            par = VisitorNode("Parent")
            if i % 17 == 16:
                par.add("Index", "u32", free[0]).add("Generation", "u32", 1)
            elif i % 6:
                p = live[int(rng.integers(max(0, i - 8), i))]
                par.add("Index", "u32", p).add("Generation", "u32", 1)
            else:
                par.add("Index", "u32", 0).add("Generation", "u32", 0)
            base.children.append(par)
        live.append(s)
    return root


def wav_bytes(samples, rate):
    """A mono 16-bit PCM WAV file of float samples in [-1, 1]."""
    import io as io_mod
    import wave
    buf = io_mod.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2")
                      .tobytes())
    return buf.getvalue()


# ------------------------------------------------------------------ fonts
# A TrueType font that chip_smoke.write_ttf writes, since no font file ships
# with the repo and the card's machine has none: 1,000 units an em, each
# printable ASCII character drawn on a 5 x 7 grid of 100-unit pixels.
TTF_UPEM = 1000
TTF_ASCENT, TTF_DESCENT, TTF_GAP = 800, -200, 90
TTF_PX = 100
# kerning pairs (left, right, units) of the font's kern table
TTF_KERN = (("A", "V", -80), ("V", "A", -80), ("T", "o", -60),
            ("L", "T", -50), ("1", "1", -40), ("P", "a", -30))
# characters that are composite glyphs: (component, flags, dx, dy,
# transform) each; flags 1 = word arguments, 8 = one scale, 0x40 = x and y
# scales, 0x80 = a 2 x 2 matrix (the MORE_COMPONENTS and XY_VALUES bits are
# added by the writer). Lowercase letters are their capitals at 3/4 scale.
TTF_COMPOSITES = {
    ":": ((".", 1, 0, 0, ()), (".", 1, 0, 400, ())),
    ";": ((".", 1, 0, 400, ()), (",", 1, 0, 0, ())),
    "/": (("|", 0x80, -60, 0, (1.0, 0.3, 0.0, 1.0)),),
    "_": (("-", 1 | 0x40, 0, -300, (1.0, 0.5)),),
    "`": (("'", 0, 30, 0, ()),),
    **{chr(c): ((chr(c - 32), 1 | 8, 40, 0, (0.75,)),)
       for c in range(ord("a"), ord("z") + 1)},
}


def ttf_pattern(ch):
    """The 5 x 7 pattern of a simple glyph (rows of 5-bit integers, the
    most significant bit leftmost): the port's bitmap font where it has
    the character, else bits seeded by its code."""
    from fyrox_tpu_torch.ui.renderer import FONT_5X7
    fixed = {"|": (0x04,) * 7, "'": (0x04, 0x04, 0x08, 0, 0, 0, 0)}
    if ch in fixed or ch in FONT_5X7:
        return fixed.get(ch) or FONT_5X7[ch]
    bits = np.random.default_rng(ord(ch)).random((7, 5)) < 0.45
    return tuple(int(sum(1 << (4 - c) for c in range(5) if row[c]))
                 for row in bits)


def ttf_contours(ch):
    """A simple glyph's contours, lists of (x, y, on_curve) in font units
    (y up, clockwise): a run of lit pixels in a row is a bar whose left end
    is rounded by two off-curve points (a quadratic curve through an
    implied on-curve midpoint); '.' is a dot of four off-curve points only,
    and .notdef a box with a hole."""
    if ch == ".notdef":
        return [[(50, 700, 1), (550, 700, 1), (550, 0, 1), (50, 0, 1)],
                [(150, 100, 1), (450, 100, 1), (450, 600, 1), (150, 600, 1)]]
    if ch == ".":
        return [[(220, 80, 0), (300, 160, 0), (380, 80, 0), (300, 0, 0)]]
    out = []
    for r, bits in enumerate(ttf_pattern(ch)):
        c = 0
        while c < 5:
            if not bits & (1 << (4 - c)):
                c += 1
                continue
            e = c
            while e + 1 < 5 and bits & (1 << (3 - e)):
                e += 1
            x0, x1 = 50 + c * TTF_PX, 50 + (e + 1) * TTF_PX
            y0 = (6 - r) * TTF_PX
            y1 = y0 + TTF_PX
            out.append([(x0 + 25, y1, 1), (x1, y1, 1), (x1, y0, 1),
                        (x0 + 25, y0, 1), (x0, y0, 0), (x0, y1, 0)])
            c = e + 1
    return out


def _ttf_simple(contours):
    """glyf bytes of a simple glyph: short and long deltas, 'same' flags
    and run-length flags with the repeat bit."""
    import struct
    pts = [p for c in contours for p in c]
    ends = list(np.cumsum([len(c) for c in contours]) - 1)
    xs, ys = [p[0] for p in pts], [p[1] for p in pts]
    out = struct.pack(">hhhhh", len(contours), min(xs), min(ys), max(xs),
                      max(ys))
    out += struct.pack(f">{len(ends)}HH", *ends, 0)     # no instructions
    flags, xb, yb = [], b"", b""
    px = py = 0
    for x, y, on in pts:
        f = 1 if on else 0
        for d, short, same, fmt in ((x - px, 2, 16, "x"), (y - py, 4, 32,
                                                           "y")):
            if d == 0:
                f |= same
                continue
            if abs(d) < 256:
                f |= short | (same if d > 0 else 0)
                enc = bytes([abs(d)])
            else:
                enc = struct.pack(">h", d)
            if fmt == "x":
                xb += enc
            else:
                yb += enc
        flags.append(f)
        px, py = x, y
    fb = bytearray()
    i = 0
    while i < len(flags):
        j = i
        while j + 1 < len(flags) and flags[j + 1] == flags[i] and j - i < 255:
            j += 1
        fb += bytes([flags[i] | 8, j - i]) if j > i else bytes([flags[i]])
        i = j + 1
    return out + bytes(fb) + xb + yb


def _ttf_advance(ch):
    """(advance, left side bearing) of a simple glyph: its ink and 100
    units after it."""
    xs = [p[0] for c in ttf_contours(ch) for p in c] or [0]
    return max(xs) + 100, min(xs)


def _ttf_composite(parts, gid_of):
    import struct
    out = struct.pack(">hhhhh", -1, 0, -200, 700, 700)
    for k, (comp, flags, dx, dy, tf) in enumerate(parts):
        f = flags | 2 | (0x20 if k + 1 < len(parts) else 0)
        out += struct.pack(">HH", f, gid_of[comp])
        out += struct.pack(">hh" if f & 1 else ">bb", dx, dy)
        out += b"".join(struct.pack(">h", int(round(v * 16384))) for v in tf)
    return out


def write_ttf(long_loca=False, cmap_shift=0):
    """The bytes of a TrueType font: head, hhea, maxp, cmap (format 4: one
    segment by idDelta, one through glyphIdArray), loca (short, or long
    with long_loca), glyf, hmtx (the last two glyphs share the last
    advance) and kern (format 0). Glyphs: .notdef, the space (no outline),
    then every printable ASCII character; composites per TTF_COMPOSITES.
    cmap_shift maps 'A'..'~' to the glyphs that many places on: another
    font of the same length."""
    import struct
    chars = [chr(c) for c in range(33, 127)]
    names = [".notdef", " "] + chars
    gid_of = {n: i for i, n in enumerate(names)}
    glyphs, adv, lsb = [], [], []
    for n in names:
        if n == " ":
            glyphs.append(b"")
            adv.append(400)
            lsb.append(0)
        elif n in TTF_COMPOSITES:
            glyphs.append(_ttf_composite(TTF_COMPOSITES[n], gid_of))
            base = _ttf_advance(TTF_COMPOSITES[n][0][0])[0]
            adv.append(base * 3 // 4 + 60 if n.islower() else base)
            lsb.append(0)
        else:
            conts = ttf_contours(n)
            glyphs.append(_ttf_simple(conts) if conts else b"")
            a, s = _ttf_advance(n)
            adv.append(a)
            lsb.append(s)
    glyphs = [g + b"\0" * (-len(g) % 4) for g in glyphs]
    offs = np.concatenate([[0], np.cumsum([len(g) for g in glyphs])])
    n_glyphs, n_hm = len(names), len(names) - 2
    loca = (struct.pack(f">{len(offs)}I", *offs) if long_loca
            else struct.pack(f">{len(offs)}H", *(offs // 2)))
    head = struct.pack(">IIIIHHqqhhhhHHhhh", 0x10000, 0x10000, 0, 0x5F0F3CF5,
                       0, TTF_UPEM, 0, 0, 0, -200, 700, 700, 0, 8, 2,
                       int(long_loca), 0)
    hhea = struct.pack(">Ihhh" + "H" + "hhh" + "hhh" + "hhhh" + "hH",
                       0x10000, TTF_ASCENT, TTF_DESCENT, TTF_GAP, max(adv),
                       0, 0, 700, 1, 0, 0, 0, 0, 0, 0, 0, n_hm)
    maxp = struct.pack(">IH", 0x5000, n_glyphs)
    hmtx = b"".join(struct.pack(">Hh", a, s)
                    for a, s in zip(adv[:n_hm], lsb[:n_hm]))
    hmtx += struct.pack(f">{n_glyphs - n_hm}h", *lsb[n_hm:])
    # cmap: 32..64 by idDelta, 65..126 through glyphIdArray, then 0xFFFF
    segs = [(32, 64, -31, 0), (65, 126, 0, 4), (0xFFFF, 0xFFFF, 1, 0)]
    sc = len(segs)
    ids = [gid_of[chr(65 + (c - 65 + cmap_shift) % 62)]
           for c in range(65, 127)]
    sub = struct.pack(f">{sc}H", *(s[1] for s in segs)) + b"\0\0"
    sub += struct.pack(f">{sc}H", *(s[0] for s in segs))
    sub += struct.pack(f">{sc}h", *(s[2] for s in segs))
    sub += struct.pack(f">{sc}H", *(s[3] for s in segs))
    sub += struct.pack(f">{len(ids)}H", *ids)
    sub = struct.pack(">HHHHHHH", 4, 14 + len(sub), 0, 2 * sc, 4, 1,
                      2 * sc - 4) + sub
    cmap = struct.pack(">HHHHI", 0, 1, 3, 1, 12) + sub
    pairs = sorted((gid_of[a], gid_of[b], v) for a, b, v in TTF_KERN)
    kern_sub = struct.pack(">HHHH", len(pairs), 0, 0, 0) + b"".join(
        struct.pack(">HHh", *p) for p in pairs)
    kern = struct.pack(">HHHHH", 0, 1, 0, 6 + len(kern_sub), 1) + kern_sub
    tables = dict(head=head, hhea=hhea, maxp=maxp, cmap=cmap, loca=loca,
                  glyf=b"".join(glyphs), hmtx=hmtx, kern=kern)
    tags = sorted(tables)
    out = struct.pack(">IHHHH", 0x10000, len(tags), 128, 3, 16 * len(tags)
                      - 128)
    off = 12 + 16 * len(tags)
    body = b""
    for tag in tags:
        data = tables[tag]
        pad = data + b"\0" * (-len(data) % 4)
        csum = sum(struct.unpack(f">{len(pad) // 4}I", pad)) & 0xFFFFFFFF
        out += tag.encode() + struct.pack(">III", csum, off + len(body),
                                          len(data))
        body += pad
    return out + body


def level_tilemap(tm_mod, rows=LEVEL_ROWS, cols=LEVEL_COLS):
    """A side-view 2D level as a TileMap (tm_mod: either package's
    scene.tilemap module): a three-row floor, a fixed pattern
    of floating platforms and pillars, and one-way ledges, autotiled so
    that every solid cell with open air above it turns to the grass-top
    tile. Rows grow upwards (+y), cells are 0.5 m. Returns the autotiled
    TileMap."""
    ts = tm_mod.TileSet()
    air = ts.add(solid=False, color=(0.5, 0.7, 0.9),
                 properties={"cost": 1.0})
    rock = ts.add(solid=True, color=(0.45, 0.4, 0.35),
                  properties={"cost": 10.0})
    grass = ts.add(solid=True, color=(0.25, 0.7, 0.2),
                   properties={"cost": 10.0})
    ledge = ts.add(solid=False, color=(0.6, 0.45, 0.25),
                   properties={"cost": 2.0})
    grid = np.full((rows, cols), tm_mod.EMPTY, np.int64)
    grid[rows - 1] = air                         # the sky's top row
    grid[:3] = rock
    for k in range(cols // 12):
        x0 = 12 * k + 2
        y0 = 5 + (3 * k) % (rows - 10)
        grid[y0:y0 + 2, x0:x0 + 7] = rock        # a platform
        grid[3:3 + 2 + k % 3, x0 + 9] = rock     # a pillar
        grid[y0 + 4, x0 + 1:x0 + 5] = ledge
    # autotile_bitmask's north is the row above in array order, which is
    # the cell below in this side view: cells whose south is open get
    # grass (bit 4, S, clear)
    table = {m: grass for m in range(256) if not (m & 16)}
    tm = tm_mod.TileMap(tile_set=ts, grid=grid, cell_size=0.5)
    return tm_mod.apply_autotile(tm, {rock}, table)


def imported_flagship(scene, hum=None, n_bodies=ASSET_BODIES):
    """The flagship on a loaded GltfScene, built as the FBX one is
    (models.assemble_imported: the pile, slab and the fused route at
    n_bodies >= 192, a camera; with the hum, a Sound on the skin's first
    bone and a listener on the camera), on a copy of the scene's builder
    so that the loaded resource stays as it was. Returns (Engine,
    SkinTemplate)."""
    import copy
    from fyrox_tpu_torch.models import assemble_imported
    return assemble_imported(copy.deepcopy(scene.builder), scene.skins[0],
                             scene.animations.build(), n_bodies=n_bodies,
                             hum=hum)


def level_engine(tm, n_balls=LEVEL_BALLS, seed=0):
    """The tilemap level as a game scene: the level's mesh, a tilted
    directional light, a camera looking at the level's face, its merged
    solid boxes as static cuboids through tilemap_to_physics, and n_balls
    dim2 balls (sphere meshes on 2D rigid-body nodes) dropped over it.
    Returns the Engine."""
    from fyrox_tpu_torch.engine import Engine
    from fyrox_tpu_torch.physics.dim2 import Physics2DBuilder
    from fyrox_tpu_torch.render import make_sphere
    from fyrox_tpu_torch.scene import NodeType, SceneBuilder, tilemap
    rng = np.random.default_rng(seed)
    rows, cols = tm.grid.shape
    cs = tm.cell_size
    sb = SceneBuilder()
    sb.add_mesh(tilemap.tilemap_mesh(tm), name="level")
    # the quads face +z: the light and the camera look along -z (turned
    # about y), the light tilted down by pi / 8
    sb.add_light("directional", intensity=1.6, rotation=(
        0.0, np.cos(np.pi / 16), -np.sin(np.pi / 16), 0.0))
    sb.add_camera("cam", position=(cols * cs / 2, rows * cs / 2, 30.0),
                  rotation=(0.0, 1.0, 0.0, 0.0))
    p2 = Physics2DBuilder()
    tilemap.tilemap_to_physics(tm, p2.pb)
    for i in range(n_balls):
        p = (rng.uniform(1.0, cols * cs - 1.0),
             rows * cs * 0.5 + rng.uniform(0.0, rows * cs * 0.4))
        node = sb.add_node(f"ball{i}", node_type=NodeType.RIGID_BODY_2D,
                           position=(p[0], p[1], 0.0),
                           bbox=(np.full(3, -0.2), np.full(3, 0.2)))
        sb.add_mesh(make_sphere(0.2, slices=8, stacks=6),
                    name=f"ball{i}_mesh", parent=node)
        b = p2.add_body(node=node, position=p)
        p2.add_circle(b, 0.2, friction=0.4, restitution=0.2)
    return Engine(template=sb.build(), physics=p2.build())


def clone_state(state):
    from fyrox_tpu_torch.engine import _map
    return _map(torch.clone, state)


def phase_assets():
    """The content path at full width: a .glb of the flagship's character,
    a 64-node .rgs scene and a .wav hum written to a temporary directory
    and requested through one ResourceManager (one of them twice); the
    imported flagship (W worlds: TICKS eager ticks counted, a replayed
    roll equal to them, K3 / K2 / K1 once a replayed tick by the
    profiler, env·steps/s, device ms and events; W = 2 card vs CPU); an
    EditorSession over it; the .rgs graph pass card vs CPU and the scene
    tools; the tilemap level (dense K4a / K4b ticks at W, a CapturedFrame
    at W = 16 with K5 and the bin audit)."""
    import io as io_mod
    import os
    import tempfile
    from fyrox_tpu_torch import convert, tools
    from fyrox_tpu_torch.animation import skinning
    from fyrox_tpu_torch.editor import EditorSession
    from fyrox_tpu_torch.engine import world_health
    from fyrox_tpu_torch.io import load_scene, write_rgs
    from fyrox_tpu_torch.physics import fused_step
    from fyrox_tpu_torch.render import (CapturedFrame, RenderConfig,
                                        build_render_template,
                                        render_frame_demand, tile_raster)
    from fyrox_tpu_torch.resource import ResourceManager, ResourceState
    from fyrox_tpu_torch.scene import graph, init_state, tilemap
    from fyrox_tpu_torch.sound.engine import SAMPLE_RATE
    t_phase = time.perf_counter()
    want = dict(fused_bp=TICKS, narrow_compact=TICKS, solve_tgs=TICKS,
                plane_gather=0, plane_scatter=0)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {ext: os.path.join(tmp, "asset" + ext)
                 for ext in (".glb", ".rgs", ".wav")}
        t0 = time.perf_counter()
        ts = np.arange(SAMPLE_RATE // 5) / SAMPLE_RATE
        files = {".glb": character_glb(), ".rgs": write_rgs(fyrox_scene()),
                 ".wav": wav_bytes(0.3 * np.sin(2 * np.pi * 160 * ts),
                                   SAMPLE_RATE)}
        for ext, data in files.items():
            with open(paths[ext], "wb") as f:
                f.write(data)
        t1 = time.perf_counter()
        rm = ResourceManager()
        res = {ext: rm.request(p) for ext, p in paths.items()}
        again = rm.request(paths[".glb"])
        for r in res.values():
            r.wait(120)
        t2 = time.perf_counter()
        rm.shutdown()
    bad = {e: (r.state, r.error) for e, r in res.items()
           if r.state != ResourceState.OK}
    if bad or again is not res[".glb"]:
        fail(f"assets: resource manager {bad}, the second request of the "
             f".glb {'is' if again is res['.glb'] else 'is not'} the first")
    gltf, scene_t, hum = (res[e].data for e in (".glb", ".rgs", ".wav"))
    engine, skin = imported_flagship(gltf, hum=hum)
    t3 = time.perf_counter()
    if (skin.num_bones, skin.num_vertices) != (ASSET_BONES, ASSET_VERTS) \
            or not fused_step.supports_fused_bp(engine.physics) \
            or engine.template.sounds["node"].size != 1:
        fail(f"assets: imported {skin.num_bones} bones, {skin.num_vertices}"
             f" vertices, fused route "
             f"{fused_step.supports_fused_bp(engine.physics)}")
    log(f"[assets] files written in {t1 - t0:.3f} s (.glb "
        f"{len(files['.glb']) / 2**20:.2f} MiB, .rgs {len(files['.rgs'])} B"
        f", .wav {len(files['.wav'])} B); ResourceManager: 4 requests (the "
        f".glb twice, the same Resource back), all OK in {t2 - t1:.3f} s "
        f"(import: read, parse, decode); the imported flagship's templates"
        f" (pile, slab, hum on bone 0, camera) in {t3 - t2:.3f} s")

    # -- the imported flagship at full width
    def skinned(st):
        return skinning.skin_positions_dense(
            skinning.bone_matrices(st.scene.globals_, skin), skin)

    state0 = distinct_worlds(engine, WORLDS, "cuda", seed=41)
    bind_err = (skinned(state0)[0] - torch.as_tensor(
        skin.vertices, device="cuda")).abs().max().item()
    torch.cuda.synchronize()
    reset_all_launches()
    eager = state0
    for _ in range(TICKS):
        eager = engine.step(eager)
    torch.cuda.synchronize()
    n = all_launches()
    if n != want:
        fail(f"assets: launches of {TICKS} eager ticks {n}, want {want}")
    rolled = engine.rollout(state0, TICKS)
    n_leaves = same_state("assets: imported flagship rollout", rolled, eager)
    moved = (skinned(rolled) - skinned(state0)).norm(dim=-1).max().item()
    if not (bool(world_health(rolled).all()) and bind_err < 1e-3
            and moved > 0.01):
        fail(f"assets: health {world_health(rolled).all()}, bind-pose error"
             f" {bind_err:.3g}, mesh moved {moved:.3g}")
    kn, events, dev_ms = profiled(lambda: engine.rollout(rolled, TICKS),
                                  TICKS, "assets: imported flagship")
    if kn != want:
        fail(f"assets: kernels of a replayed roll {kn}, want {want}")
    st = engine.rollout(rolled, TICKS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        st = engine.rollout(st, TICKS)
        v = skinned(st)
    torch.cuda.synchronize()
    rate = WORLDS * TICKS * CALLS / (time.perf_counter() - t0)
    check_state(st, v, skin)
    gpu = distinct_worlds(engine, 2, "cuda", seed=43)
    cpu = convert.engine_state(convert.to_numpy(gpu), device="cpu")
    for _ in range(TICKS):
        gpu = engine.step(gpu)
        cpu = engine.step(cpu)
    dp = (gpu.physics.position.cpu() - cpu.physics.position).abs().max()
    dv = (gpu.physics.linvel.cpu() - cpu.physics.linvel).abs().max()
    dvert = (skinned(gpu).cpu() - skinned(cpu)).abs().max()
    live = int((cpu.physics.warm_pair >= 0).sum())
    if not (dp < 5e-4 and dv < 5e-3 and dvert < 1e-3 and live > 0
            and all_differ(cpu.physics.position)):
        fail(f"assets: imported flagship card vs CPU dp {dp:.3g}, dv "
             f"{dv:.3g}, skinned {dvert:.3g}, live contact points {live}")
    log(f"[assets] imported flagship ({skin.num_bones} bones, "
        f"{skin.num_vertices} vertices, 4 influences, "
        f"{engine.animations.rot_node.size} rotation and "
        f"{engine.animations.pos_node.size} translation tracks from "
        f"quaternion / translation channels, {engine.physics.num_bodies - 1}"
        f" bodies), W={WORLDS} distinct worlds: eager launches a tick "
        f"fused_bp 1, narrow_compact 1, solve_tgs 1; {TICKS} replayed ticks "
        f"equal {TICKS} eager ticks bit for bit ({n_leaves} state tensors); "
        f"world_health all true; bind-pose error {bind_err:.3g}, mesh moved"
        f" {moved:.3f}; replayed roll's kernels {kn} (K3, K2, K1 once a "
        f"tick); replayed tick: {events:.1f} device events, {dev_ms:.3f} ms"
        f" of device time; {rate:.1f} env·steps/s with skinning through "
        f"rollout ({CALLS} x {TICKS} ticks); W=2 card vs CPU over {TICKS} "
        f"ticks: dp {dp:.3g} (bound 5e-4), dv {dv:.3g} (bound 5e-3), "
        f"skinned {dvert:.3g} (bound 1e-3), {live} live contact points, on "
        f"{CARD}")

    # -- the editor over the imported flagship at W = 1
    edit0 = engine.init_state(1, device="cuda")
    before = clone_state(edit0)
    es = EditorSession(engine, edit0)
    bone = int(skin.bones[0])
    es.translate(bone, (0.0, 0.5, 0.0))
    moved_state = es.state
    kept = clone_state(moved_state)
    es.undo()
    same_state("editor: undo", es.state, before)
    es.redo()
    es.play(update_rate=60.0)
    played = es.tick(EDITOR_PLAY)
    ticks = round(EDITOR_PLAY * 60)
    if torch.equal(played.physics.position, moved_state.physics.position):
        fail("editor: play mode did not move the bodies")
    back = es.stop()
    same_state("editor: the snapshot after stop", back, kept)
    same_state("editor: the state before play", moved_state, kept)
    es.undo()
    same_state("editor: undo after play", es.state, before)
    same_state("editor: the first state", edit0, before)
    dy = float((kept.scene.globals_[0, bone, 1, 3]
                - before.scene.globals_[0, bone, 1, 3]).cpu())
    if abs(dy - 0.5) > 1e-5:
        fail(f"editor: the moved bone rose {dy}, want 0.5")
    log(f"[assets] editor over the imported flagship (W=1, card): "
        f"translate bone {bone} by 0.5 m (global y +{dy:.6f}), undo equal to"
        f" the first state bit for bit, redo, play {EDITOR_PLAY} s "
        f"({ticks} Executor ticks, replays of the captured tick), stop: the "
        f"snapshot equals the state before play bit for bit, undo after "
        f"play equals the first state, which no tick wrote")
    del engine, skin, state0, eager, rolled, st, v, es, kept, before

    # -- the .rgs scene: graph pass card vs CPU, inspect and diff
    noise = np.random.default_rng(47).uniform(
        -0.05, 0.05, (WORLDS, scene_t.num_nodes, 3)).astype(np.float32)
    ws = init_state(scene_t, WORLDS, device="cpu")
    ws = ws._replace(position=ws.position + torch.as_tensor(noise))
    want_g = graph.update_hierarchical_data(ws, scene_t)
    got_g = graph.update_hierarchical_data(
        convert.scene_state(convert.to_numpy(ws), device="cuda"), scene_t)
    for name in ("globals_", "global_visibility", "global_enabled"):
        diff = getattr(got_g, name).cpu() != getattr(want_g, name)
        if diff.any():
            nodes = torch.nonzero(diff.reshape(WORLDS, scene_t.num_nodes, -1)
                                  .any(2).any(0)).flatten().tolist()
            fail(f"assets: .rgs graph pass, {name} card != CPU at nodes "
                 f"{nodes[:16]} (depths {scene_t.depth[nodes[:16]]})")
    buf = io_mod.StringIO()
    tools.inspect_scene(scene_t, out=buf)
    lines = buf.getvalue().splitlines()
    other = load_scene(write_rgs(fyrox_scene(moved=7)))
    n_same = tools.diff_scenes(scene_t, scene_t, out=io_mod.StringIO())
    n_moved = tools.diff_scenes(scene_t, other, out=io_mod.StringIO())
    kinds = sorted(set(int(k) for k in scene_t.node_type))
    if not (scene_t.num_nodes == RGS_NODES and len(lines) == RGS_NODES + 1
            and n_same == 0 and n_moved == 1 and len(kinds) == 9):
        fail(f"assets: .rgs scene {scene_t.num_nodes} nodes, inspect "
             f"{len(lines)} lines, diff {n_same} / {n_moved}, kinds {kinds}")
    log(f"[assets] .rgs scene: {scene_t.num_nodes} nodes of {len(kinds)} "
        f"node types (depth {int(scene_t.depth.max())}, pivot terms on "
        f"{int((scene_t.init_pre_rotation != [0, 0, 0, 1]).any(1).sum())} "
        f"pre-rotations); update_hierarchical_data at W={WORLDS} card == "
        f"CPU bit for bit (globals, visibility, enabled); inspect_scene "
        f"{len(lines)} lines; diff_scenes: itself 0, one node moved 1")

    # -- the tilemap level: dense physics at W, a captured frame at W = 16
    tm = level_tilemap(tilemap)
    engine = level_engine(tm)
    t = engine.physics
    n_cols = t.num_colliders
    if t.grid is not None or n_cols >= 192:
        fail(f"assets: the level ({n_cols} colliders) is not dense")
    state0 = engine.init_state(WORLDS, device="cuda")
    state0 = state0._replace(physics=jitter(state0.physics, t, "cuda",
                                            seed=53))
    reset_all_launches()
    eager = state0
    for _ in range(TICKS):
        eager = engine.step(eager)
    torch.cuda.synchronize()
    n = all_launches()
    gathers, scatters = dense_launches(t)
    want_l = dict(fused_bp=0, narrow_compact=0, solve_tgs=0,
                  plane_gather=gathers * TICKS,
                  plane_scatter=scatters * TICKS)
    if n != want_l:
        fail(f"assets: level launches of {TICKS} eager ticks {n}, want "
             f"{want_l}")
    rolled = engine.rollout(state0, TICKS)
    same_state("assets: level rollout", rolled, eager)
    kn_l, events_l, dev_ms_l = profiled(
        lambda: engine.rollout(rolled, TICKS), TICKS, "assets: level")
    if (kn_l["plane_gather"], kn_l["plane_scatter"]) != (
            gathers * TICKS, scatters * TICKS):
        fail(f"assets: level kernels of a replayed roll {kn_l}")
    st = engine.rollout(rolled, TICKS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        st = engine.rollout(st, TICKS)
    torch.cuda.synchronize()
    rate_l = WORLDS * TICKS * CALLS / (time.perf_counter() - t0)
    if not bool(world_health(st).all()):
        fail("assets: a level world is unhealthy")
    tmpl = engine.template
    rt = build_render_template(tmpl)
    cfg = RenderConfig(width=LEVEL_SIZE, height=LEVEL_SIZE, shadows=True,
                       **LEVEL_CAPS)
    s16 = engine.init_state(16, device="cuda")
    s16 = s16._replace(physics=jitter(s16.physics, t, "cuda", seed=59))
    scene16 = engine.rollout(s16, TICKS).scene
    frame = CapturedFrame(tmpl, rt, cfg)
    tile_raster.reset_launches()
    color, _ = frame(scene16)
    torch.cuda.synchronize()
    counted = {k: tile_raster.launches(k) for k in ("full", "depth")}
    per_frame = frame_launches(cfg, rt)
    if counted != {k: 2 * per_frame[k] for k in ("full", "depth")}:
        fail(f"assets: level frame K5 launches {counted} at the capture, "
             f"a frame's {per_frame}")
    kernels, busy_us, k5 = agreed_record("assets: level frame",
                                         lambda: frame(scene16), k5_profiled)
    if (k5["full"], k5["depth"]) != (per_frame["full"], per_frame["depth"]):
        fail(f"assets: a replayed level frame's K5 launches {k5}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RENDER_FRAMES):
        color, _ = frame(scene16)
    torch.cuda.synchronize()
    fps = RENDER_FRAMES / (time.perf_counter() - t0)
    _, demand, caps = render_frame_demand(scene16, tmpl, rt, cfg)
    dmax = [int(d) for d in demand.max(0).values.tolist()]
    over = [(p, d, k) for p, (d, k) in enumerate(zip(dmax, caps)) if d >= k]
    if over or not (bool(torch.isfinite(color).all())
                    and float(color.std()) > 0.01 and all_differ(color)):
        fail(f"assets: level frame: bin overflow {over}, or not finite, "
             f"distinct images")
    log(f"[assets] tilemap level: {LEVEL_ROWS} x {LEVEL_COLS} cells "
        f"autotiled ({int((tm.grid >= 0).sum())} quads), "
        f"{n_cols - LEVEL_BALLS} merged boxes through tilemap_to_physics + "
        f"{LEVEL_BALLS} dim2 balls, dense ({t.num_pairs} pairs); W={WORLDS}:"
        f" eager launches a tick K4a {gathers}, K4b {scatters}; "
        f"{TICKS} replayed ticks equal eager bit for bit; replayed roll's "
        f"kernels {kn_l}; replayed tick {events_l:.1f} device events, "
        f"{dev_ms_l:.3f} ms of device time; {rate_l:.1f} env·steps/s "
        f"through rollout; CapturedFrame at W=16, {LEVEL_SIZE}² with CSM: "
        f"K5 counted at the capture {counted}, a replayed frame's K5 {k5},"
        f" {len(kernels)} device events, {busy_us / 1e3:.3f} ms of device "
        f"time; {fps:.1f} frames/s ({16 * fps:.1f} world-frames/s); bin "
        f"demand {list(zip(dmax, caps))} on {CARD}")
    log(f"[assets] phase took {time.perf_counter() - t_phase:.1f} s")


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
    rolled = phase_rollout(engine, skin)
    phase_health(engine, rolled)
    del engine, skin, settled, rolled
    phase_anim_small()
    phase_real_asset()
    phase_dense_small()
    t0 = time.perf_counter()
    engine, skin = build_flagship()
    log(f"[setup] dense flagship (build_flagship() defaults) templates "
        f"built in {time.perf_counter() - t0:.1f} s")
    n_dense, rolled = phase_dense(engine, skin)
    kg_dense, ks_dense = phase_dense_k4(engine,
                                        capture_dense_calls(engine, rolled))
    phase_health(engine, rolled)
    del engine, skin, rolled
    phase_terrain_small()
    t0 = time.perf_counter()
    engine, skin = terrain_engine(TERRAIN_FLAGSHIP, **TERRAIN_BUILD)
    log(f"[setup] terrain flagship templates built in "
        f"{time.perf_counter() - t0:.1f} s")
    terrain_recs, settled = phase_terrain(engine, skin)
    phase_queries(engine, settled)
    del engine, skin, settled
    engine, skin = terrain_engine(TERRAIN_PILE, broadphase="dense")
    terrain_recs += phase_terrain_dense(engine, skin)
    del engine, skin
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
    phase_rollout_reuse(engine)
    del engine, skin
    t0 = time.perf_counter()
    engine, skin, anchors, _ = jointed_engine()
    log(f"[setup] jointed flagship templates built in "
        f"{time.perf_counter() - t0:.1f} s")
    k1j = phase_solver_jointed(engine)
    phase_jointed_small()
    n_jointed = phase_jointed(engine, skin, anchors)
    phase_rollout_jointed(engine)
    del engine, skin
    k1b, n_big = phase_k1_big()
    k1m, n_many = phase_k1_many()
    scene = render_scene(RENDER_WORLDS, "cuda")
    calls = capture_k5_calls(*scene)
    k5f = phase_k5(calls, depth_only=False)
    k5d = phase_k5(calls, depth_only=True)
    del calls
    phase_render_audit(*scene)
    phase_render_cpu()
    n_render = phase_render(*scene)
    phase_render_profile(*scene)
    del scene
    phase_render_features_small()
    feat = features_frame(RENDER_WORLDS, "cuda")
    hold_k5("K5 features frame", capture_k5_calls(*feat))
    calls = capture_k5_calls(*feat[:3], feat[3]._replace(
        raster_mode="clipped"))
    k5fa = phase_k5(calls, depth_only=False, affine=True)
    k5da = phase_k5(calls, depth_only=True, affine=True)
    hold_k5("K5 clipped features frame, 2DH maps",
            [c for c in calls if not c[2]])
    del calls
    n_feat = phase_render_features(*feat)
    replayed = phase_render_captured(render_scene(RENDER_WORLDS, "cuda"),
                                     feat)
    del feat
    phase_render_extras_small()
    phase_unbinned()
    phase_audio_small()
    n_audio = phase_audio()
    phase_bus_binaural()
    phase_grid_small()
    t0 = time.perf_counter()
    engine, skin = grid_engine()
    log(f"[setup] grid flagship templates built in "
        f"{time.perf_counter() - t0:.1f} s")
    n_grid, rolled = phase_grid(engine, skin)
    kg_grid, ks_grid = phase_grid_k4(engine, rolled)
    del engine, skin, rolled
    phase_brush()
    phase_game()
    phase_game_frame()
    phase_ui()
    phase_navfield()
    phase_lightmap()
    phase_assets()
    for k in (kbp, knc, k1):
        k["launches"] = n_fused[k["name"]]
    k4["launches"] = n_staged["plane_gather"]
    k5f["launches"] = n_render["full"]
    k5d["launches"] = n_render["depth"]
    k5fa["launches"] = n_feat["full_affine"]
    k5da["launches"] = n_feat["depth_affine"]
    # a replayed CapturedFrame's K5 launches (profiler; the counters see
    # only the capture)
    k5f["replayed_launches_per_frame"] = replayed["bench"]["full"]
    k5d["replayed_launches_per_frame"] = replayed["bench"]["depth"]
    k5fa["replayed_launches_per_frame"] = replayed["features clipped"][
        "full_affine"]
    k5da["replayed_launches_per_frame"] = replayed["features clipped"][
        "depth_affine"]
    k1j["launches"] = n_jointed["solve_tgs"]
    k4b["launches"] = n_reuse["plane_scatter"]
    k1b["launches"] = n_big["solve_tgs"]
    k1m["launches"] = n_many["solve_tgs"]
    kg_dense["launches"] = n_dense["plane_gather"]
    ks_dense["launches"] = n_dense["plane_scatter"]
    kg_grid["launches"] = n_grid["plane_gather"]
    ks_grid["launches"] = n_grid["plane_scatter"]
    if n_audio["solve_tgs"] != TICKS:
        fail(f"audio: K1 launches {n_audio}")
    log(f"[profiler] replays whose counted kernels needed more than two "
        f"profiles to agree (label, counts of each record): "
        f"{PROFILE_REDONE}")
    records = [kbp, knc, k1, k4, k5f, k5d, k5fa, k5da, k1j, k4b, k1b, k1m,
               kg_dense, ks_dense] + terrain_recs + [kg_grid, ks_grid]
    print(json.dumps({"kernels": records}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
