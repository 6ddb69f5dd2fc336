"""Engine facade: one batched engine tick over the world batch
(Engine::update, fyrox-impl engine/mod.rs:1616).

    1. animation writes node local transforms: the ABSM, or the plain
       AnimationPlayer (clips overwriting in order), with root motion
       extracted when the engine has it (AnimationPlayer::update)
    2. hierarchical data (skipped when every body node is a scene root:
       the post-physics refresh recomputes everything)
    3. physics step (PhysicsWorld::update); with root motion, the
       character body's horizontal velocity is set from the root delta
       first
    4. body poses written back into their nodes' local transforms
    5. hierarchy refresh so consumers see post-physics globals
    6. particle systems (ParticleSystem::update)

A tick carries the audio state (the Sound nodes' mixer state) unchanged:
its playheads advance per rendered block (``Engine.render_audio``), not
per tick, the reference's audio-thread cadence.

``Engine.rollout`` runs N ticks; on the card it replays one captured CUDA
graph of a tick (the JAX package's one ``lax.scan`` dispatch).
``world_health`` / ``restore_unhealthy`` find and reset diverged worlds;
``debug_step`` is the checked tick (the JAX package's checkify step).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from fyrox_tpu_torch import disable_tf32
from fyrox_tpu_torch._util import const, resolve_device, static_copy
from fyrox_tpu_torch.animation import machine as machine_mod
from fyrox_tpu_torch.animation import player as player_mod
from fyrox_tpu_torch.animation import rootmotion as rm_mod
from fyrox_tpu_torch.animation import track as track_mod
from fyrox_tpu_torch.core import quat
from fyrox_tpu_torch.core import transform as tfm
from fyrox_tpu_torch.physics import plane_ops
from fyrox_tpu_torch.physics import world as phys_mod
from fyrox_tpu_torch.scene import graph as graph_mod
from fyrox_tpu_torch.scene import particles as particles_mod
from fyrox_tpu_torch.scene.state import WorldState, init_state
from fyrox_tpu_torch.scene.template import SceneTemplate
from fyrox_tpu_torch.sound import scene as sound_scene
from fyrox_tpu_torch.sound.engine import DistanceModel

__all__ = ["Engine", "EngineState", "AnimState", "DEFAULT_DT",
           "world_health", "restore_unhealthy", "debug_step", "StepError",
           "DebugStepError"]

DEFAULT_DT = 1.0 / 60.0  # executor.rs:87

# the checks of a debug_step tick in progress (a _Checks); None otherwise,
# and then a tick checks nothing
_CHECKS = None


class AnimState(NamedTuple):
    anim: Optional[track_mod.AnimationState] = None
    machine: Optional[machine_mod.MachineState] = None
    rootmotion: Optional[rm_mod.RootMotionState] = None


class EngineState(NamedTuple):
    scene: WorldState
    physics: Optional[phys_mod.PhysicsState] = None
    animation: Optional[AnimState] = None
    particles: Optional[particles_mod.ParticleState] = None
    # the Sound nodes' mixer state (sound.engine.SourceState, [W,S]);
    # playheads advance per rendered block
    audio: Optional[NamedTuple] = None


@dataclass
class Engine:
    """Holds the static templates; all dynamics live in EngineState.

    root_motion: when set, the player pins the root bone and the tick
    drives the physics body `root_motion_body` horizontally with the
    extracted delta (Animation::update_root_motion, lib.rs:498)."""
    template: SceneTemplate
    physics: Optional[phys_mod.PhysicsTemplate] = None
    animations: Optional[track_mod.AnimationSet] = None
    machine: Optional[machine_mod.MachineTemplate] = None
    particles: Optional[particles_mod.ParticleTemplate] = None
    dt: float = DEFAULT_DT
    root_motion: Optional[rm_mod.RootMotionData] = None
    root_motion_body: int = -1

    def init_state(self, num_worlds: int, device="cuda",
                   body_pose=None) -> EngineState:
        """Initial state of num_worlds worlds, on the card unless `device`
        says otherwise (raises where there is no card)."""
        device = resolve_device(device)
        if device.type == "cuda":
            disable_tf32()
        scene = init_state(self.template, num_worlds, device)
        scene = graph_mod.update_hierarchical_data(scene, self.template)
        phys = None
        if self.physics is not None:
            if body_pose is None:
                # bodies start at their nodes' initial global poses;
                # standalone bodies (node -1) keep their builder pose
                bn = self.physics.body_node
                g = scene.globals_[0, torch.as_tensor(
                    np.maximum(bn, 0).astype(np.int64), device=device)]
                pos, rot, _ = tfm.decompose_mat4(g)
                pos, rot = pos.cpu().numpy(), rot.cpu().numpy()
                has_node = (bn >= 0)[:, None]
                if self.physics.init_body_pos is not None:
                    pos = np.where(has_node, pos, self.physics.init_body_pos)
                    rot = np.where(has_node, rot, self.physics.init_body_rot)
                body_pose = (pos, rot)
            phys = phys_mod.init_physics_state(body_pose, self.physics,
                                               num_worlds, device)
        anim = None
        if self.animations is not None:
            a = track_mod.init_animation_state(self.animations, num_worlds,
                                               device)
            m = (machine_mod.init_machine_state(self.machine, num_worlds,
                                               device)
                 if self.machine is not None else None)
            rm = (rm_mod.init_root_motion_state(self.root_motion, num_worlds,
                                                device)
                  if self.root_motion is not None else None)
            anim = AnimState(anim=a, machine=m, rootmotion=rm)
        parts = (particles_mod.init_particles(self.particles, num_worlds,
                                              device)
                 if self.particles is not None else None)
        at = self.audio_template()
        audio = (sound_scene.init_audio_state(at, num_worlds, device)
                 if at is not None else None)
        return EngineState(scene=scene, physics=phys, animation=anim,
                           particles=parts, audio=audio)

    def audio_template(self):
        """The packed Sound / Listener layout (sound.scene.AudioTemplate),
        built once; None where the scene has no Sound node."""
        if not hasattr(self, "_audio_template"):
            self._audio_template = sound_scene.build_audio_template(
                self.template)
        return self._audio_template

    def render_audio(self, state: EngineState, block_len: int = 513,
                     distance_model=None):
        """Mix one stereo block per world from the CURRENT scene state
        (scene/sound/mod.rs sync + fyrox-sound SoundContext::render).
        Returns (block [W, block_len, 2], the state with advanced
        playheads); the state given is not written. Runs outside a
        captured tick: ``rollout`` carries the audio leaves unchanged."""
        at = self.audio_template()
        if at is None or state.audio is None:
            raise ValueError("scene has no Sound nodes (SceneBuilder"
                             ".add_sound): nothing to render")
        dm = (DistanceModel.INVERSE if distance_model is None
              else distance_model)
        block, audio = sound_scene.render_scene_audio(
            at, state.audio, state.scene.globals_, block_len=block_len,
            distance_model=dm)
        return block, state._replace(audio=audio)

    def step(self, state: EngineState, machine_params=None,
             dt: Optional[float] = None, fused=True,
             bp_rank="sort") -> EngineState:
        """One engine tick. machine_params: [W,P] bool ABSM rules.
        fused=False keeps physics on the staged path; bp_rank ("sort" or
        "count") is the slab broadphase's rank (world.step_physics)."""
        dt = self.dt if dt is None else dt
        scene = state.scene
        anim = state.animation

        # ---- 1. animation ----
        rm_delta = None
        if anim is not None and self.animations is not None:
            if self.root_motion is not None and anim.rootmotion is not None:
                a, rm, p, r, s, rm_delta = player_mod.step_player_root_motion(
                    self.animations, self.root_motion, anim.anim,
                    anim.rootmotion, scene.position, scene.rotation,
                    scene.scale, dt)
                anim = AnimState(anim=a, machine=anim.machine, rootmotion=rm)
                scene = scene._replace(position=p, rotation=r, scale=s)
            elif self.machine is not None and anim.machine is not None:
                if machine_params is None:
                    machine_params = torch.zeros(
                        (scene.num_worlds,
                         max(len(self.machine.param_names), 1)),
                        dtype=torch.bool, device=scene.position.device)
                a, m, p, r, s = player_mod.step_absm(
                    self.animations, self.machine, anim.anim, anim.machine,
                    machine_params, scene.position, scene.rotation,
                    scene.scale, dt)
                anim = AnimState(anim=a, machine=m)
            else:
                a, p, r, s = player_mod.step_player(
                    self.animations, anim.anim, scene.position,
                    scene.rotation, scene.scale, dt)
                anim = AnimState(anim=a, machine=anim.machine,
                                 rootmotion=anim.rootmotion)
            # as the JAX package: an engine with root motion applies only
            # the root-motion branch's pose
            if self.root_motion is None:
                scene = scene._replace(position=p, rotation=r, scale=s)
            if _CHECKS is not None:
                _CHECKS.stage("animation", animation=anim, scene=scene)

        # ---- 2. hierarchy (pre-physics) ----
        skip_pre = (state.physics is not None and self.physics is not None
                    and self._bodies_at_root())
        scene = graph_mod.step(scene, self.template, dt,
                               update_hierarchy=not skip_pre)
        if _CHECKS is not None:
            _CHECKS.stage("hierarchy", scene=scene)

        # ---- 3+4+5. physics, body → node sync, refresh ----
        phys = state.physics
        if phys is not None and self.physics is not None:
            if rm_delta is not None and self.root_motion_body >= 0:
                phys = self._drive_root_body(phys, rm_delta, dt)
            phys = phys_mod.step_physics(phys, self.physics, dt, fused=fused,
                                         bp_rank=bp_rank)
            if _CHECKS is not None:
                _CHECKS.stage("physics", physics=phys)
            scene = self._sync_bodies_to_nodes(scene, phys)
            if _CHECKS is not None:
                _CHECKS.stage("sync", scene=scene)
            scene = graph_mod.update_hierarchical_data(scene, self.template)
            if _CHECKS is not None:
                _CHECKS.stage("refresh", scene=scene)

        # ---- 6. particle systems ----
        parts = state.particles
        if parts is not None and self.particles is not None:
            parts = particles_mod.step_particles(parts, self.particles, dt)
            if _CHECKS is not None:
                _CHECKS.stage("particles", particles=parts)
        return EngineState(scene=scene, physics=phys, animation=anim,
                           particles=parts, audio=state.audio)

    def _drive_root_body(self, phys, rm_delta, dt):
        """The character body's x and z velocity from the root delta
        rotated into the body's frame, over dt; gravity and contacts keep
        the vertical axis. Out of place, with no host read."""
        bi = self.root_motion_body
        wd = quat.rotate(phys.rotation[:, bi], rm_delta) / dt
        lv = phys.linvel.clone()
        lv[:, bi, 0] = wd[:, 0]
        lv[:, bi, 2] = wd[:, 2]
        return phys._replace(linvel=lv)

    def rollout(self, state: EngineState, num_steps: int,
                machine_params=None, fused=True,
                bp_rank="sort") -> EngineState:
        """num_steps engine ticks: what num_steps calls of ``step`` with
        the same arguments compute, bit for bit (fyrox_tpu's
        ``Engine.rollout``, one ``lax.scan``).

        CPU tensors take the plain loop. On the card, a template whose
        broadphase rebuilds every tick (period 1: the K3, K2, staged and
        jointed routes; the dense and grid broadphases) replays one
        captured CUDA graph of a tick num_steps times; the graph is
        captured on first use and kept on the engine per (device, W,
        machine-params shape, dt, fused, bp_rank). A template with temporal broadphase reuse (period > 1)
        steps eagerly on the card: its rebuild-or-reuse decision is a host
        read of one scalar a tick, which a captured graph cannot hold.
        The caller's state is never written: a roll on the card returns
        fresh tensors."""
        if num_steps < 0:
            raise ValueError(f"rollout: num_steps {num_steps} < 0")
        if not state.scene.position.is_cuda or not self._capturable():
            for _ in range(num_steps):
                state = self.step(state, machine_params, fused=fused,
                                  bp_rank=bp_rank)
            return state
        if num_steps == 0:
            return state
        tick = self.captured_tick(state, machine_params, fused, bp_rank)
        return tick.run(state, machine_params, num_steps)

    def captured_tick(self, state: EngineState, machine_params=None,
                      fused=True, bp_rank="sort") -> "CapturedTick":
        """The cached captured tick that ``rollout`` replays for this state's
        device and shapes (captured here on first use)."""
        dev = state.scene.position.device
        key = (str(dev), state.scene.num_worlds,
               None if machine_params is None
               else (tuple(machine_params.shape), machine_params.dtype),
               self.dt, bool(fused), bp_rank)
        if getattr(self, "_captured", None) is None:
            self._captured = {}
        tick = self._captured.get(key)
        if tick is None:
            tick = CapturedTick(self, state, machine_params, fused, bp_rank)
            tick.capture()
            self._captured[key] = tick
        return tick

    def _capturable(self) -> bool:
        """Whether a tick holds no host read: every template but a slab
        one with temporal broadphase reuse (slab2.reuse_candidates). The
        dense and grid broadphases have no reuse and always capture."""
        from fyrox_tpu_torch.physics.broadphase import SlabConfig
        return (self.physics is None
                or not isinstance(self.physics.grid, SlabConfig)
                or int(getattr(self.physics, "broadphase_period", 1)
                       or 1) == 1)

    def _bodies_at_root(self) -> bool:
        if getattr(self, "_bodies_at_root_cache", None) is None:
            bn = self.physics.body_node
            nodes = bn[bn >= 0]
            self._bodies_at_root_cache = bool(
                (self.template.parent[nodes] < 0).all()) if len(nodes) \
                else True
        return self._bodies_at_root_cache

    def _sync_bodies_to_nodes(self, scene: WorldState,
                              phys: phys_mod.PhysicsState) -> WorldState:
        """Body world poses → node local transforms, decomposed against
        the parent's global transform (physics/mod.rs:1447-1475)."""
        bn = self.physics.body_node
        mask = bn >= 0
        if not mask.any():
            return scene
        dev = scene.position.device
        if getattr(self, "_sync_idx", None) is None:
            nodes = bn[mask].astype(np.int64)
            parents = self.template.parent[nodes].astype(np.int64)
            self._sync_idx = (nodes, np.nonzero(mask)[0].astype(np.int64),
                              np.maximum(parents, 0), parents >= 0)
        nodes, bidx, parents0, has_parent = self._sync_idx
        bpos = phys.position[:, const(bidx, dev)]
        brot = phys.rotation[:, const(bidx, dev)]
        if has_parent.any():
            pg = scene.globals_[:, const(parents0, dev)]
            local_m = tfm.mat4_mul(tfm.invert_affine(pg), tfm.compose_trs(
                bpos, brot, torch.ones_like(bpos)))
            lp, lr, _ = tfm.decompose_mat4(local_m)
            hp = const(has_parent, dev)[None, :, None]
            bpos = torch.where(hp, lp, bpos)
            brot = torch.where(hp, lr, brot)
        position = scene.position.clone()
        rotation = scene.rotation.clone()
        node_idx = const(nodes, dev)
        position[:, node_idx] = bpos
        rotation[:, node_idx] = brot
        return scene._replace(position=position, rotation=rotation)


# --------------------------------------------------------------------------
# rollout: one tick captured as a CUDA graph
# --------------------------------------------------------------------------

def _leaves(tree) -> list:
    """The tensors of a state, depth first in field order (the order of
    jax.tree_util.tree_leaves over the same NamedTuples; None has none)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [leaf for field in tree for leaf in _leaves(field)]
    return []


def _map(fn, tree, *others):
    """A state of the same structure with fn(leaf, *the others' leaves) at
    every tensor; anything else is kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *others)
    if isinstance(tree, tuple):
        fields = [_map(fn, f, *(o[i] for o in others))
                  for i, f in enumerate(tree)]
        return type(tree)(*fields) if hasattr(tree, "_fields") \
            else tuple(fields)
    return tree


def _copy_all(dst, src):
    """dst[i].copy_(src[i]) for every i: one multi-tensor copy per dtype
    (a list of mixed dtypes would take one copy kernel a tensor)."""
    groups = {}
    for d, s in zip(dst, src):
        pair = groups.setdefault(d.dtype, ([], []))
        pair[0].append(d)
        pair[1].append(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


class CapturedTick:
    """One engine tick captured as a CUDA graph on static state buffers.

    The captured tick reads the state from its static buffers and ends by
    copying its outputs back into them, so a replay advances them by one
    tick; ``run`` copies the caller's state in, replays, and clones the
    result out once a roll. Before the capture, one eager tick on the
    static buffers (its result dropped) builds what the step caches on
    first use with host copies, which a capture must not see: the device
    constants (``_util.const``, and ``_util.const_rows``: the dense
    solver's per-world index tables), K1's CSR lists
    (``tgs_kernel._csr``), the body → node sync indices and the fused
    route's static tables. The
    wrappers' launch counters count the warm-up and the capture, not the
    replays (a profiler's kernel names count those)."""

    def __init__(self, engine: Engine, state: EngineState, machine_params,
                 fused, bp_rank):
        self.static = _map(static_copy, state)
        self.params = (None if machine_params is None
                       else static_copy(machine_params))
        self._step = lambda: engine.step(self.static, self.params,
                                         fused=fused, bp_rank=bp_rank)
        self.graph = None
        self.capture_seconds = self.pool_bytes = None

    def advance(self):
        """One tick on the static buffers, its outputs copied back into
        them: the work the graph holds."""
        src, dst = self._copy_back(_leaves(self._step()))
        _copy_all(dst, src)

    def capture(self):
        """The warm-up tick (its result dropped), then the capture of
        ``advance``; records the capture's seconds and the bytes its
        private memory pool took."""
        dev = self.static.scene.position.device
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._step()
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            with torch.cuda.graph(graph):
                # read inside: entering a capture empties the allocator's
                # cache
                reserved = torch.cuda.memory_reserved(dev)
                self.advance()
            torch.cuda.synchronize(dev)
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph = graph

    def _copy_back(self, out):
        """(sources, destinations) of the tick's copy into the static
        buffers: an output that is its own static buffer needs no copy; one
        that shares memory with another static buffer is cloned first, so
        that no copy reads a buffer an earlier copy wrote."""
        static = _leaves(self.static)
        if len(out) != len(static):
            raise RuntimeError("rollout: a tick changed the state's "
                               "structure")
        ptrs = {x.untyped_storage().data_ptr() for x in static}
        src, dst = [], []
        for o, x in zip(out, static):
            if o.data_ptr() == x.data_ptr() and o.stride() == x.stride():
                continue
            if o.untyped_storage().data_ptr() in ptrs:
                o = o.clone()
            src.append(o)
            dst.append(x)
        return src, dst

    def run(self, state: EngineState, machine_params,
            num_steps: int) -> EngineState:
        """num_steps replays from `state`; fresh tensors out."""
        static, given = _leaves(self.static), _leaves(state)
        if [x.shape for x in static] != [x.shape for x in given]:
            raise ValueError("rollout: the state's tensors do not match the "
                             "captured tick's")
        _copy_all(static, given)
        if machine_params is not None:
            self.params.copy_(machine_params)
        with torch.cuda.device(static[0].device):
            for _ in range(num_steps):
                self.graph.replay()
        return _map(torch.clone, self.static)


# --------------------------------------------------------------------------
# world health
# --------------------------------------------------------------------------

def world_health(state: EngineState) -> torch.Tensor:
    """Per-world validity mask [W] bool: True where no floating tensor of
    the state holds a NaN (fyrox_tpu's ``world_health``). Every floating
    leaf whose leading axis is W counts, W being the first floating
    leaf's. NaN only: +inf is a legitimate sentinel (node lifetimes, empty
    depth buffers), and a diverged world reaches NaN through the first
    inf - inf or 0 * inf it touches."""
    leaves = [x for x in _leaves(state) if x.is_floating_point()]
    w = leaves[0].shape[0]
    ok = torch.ones((w,), dtype=torch.bool, device=leaves[0].device)
    for x in leaves:
        if x.ndim == 0 or x.shape[0] != w or x.numel() == 0:
            continue
        ok = ok & ~torch.isnan(x).reshape(w, -1).any(1)
    return ok


def restore_unhealthy(state: EngineState,
                      fallback: EngineState) -> EngineState:
    """Every world that world_health marks false takes `fallback`'s values
    (of every tensor whose leading axis is W); healthy worlds keep theirs
    (fyrox_tpu's ``restore_unhealthy``)."""
    ok = world_health(state)

    def fix(cur, fb):
        if cur.ndim == 0 or cur.shape[0] != ok.shape[0]:
            return cur
        return torch.where(ok.reshape((-1,) + (1,) * (cur.ndim - 1)), cur,
                           fb)

    return _map(fix, state, fallback)


# --------------------------------------------------------------------------
# debug_step: the checked tick
# --------------------------------------------------------------------------

class DebugStepError(RuntimeError):
    """What ``StepError.throw`` raises."""


class StepError:
    """The verdict of one ``debug_step`` tick (checkify's Error): device
    flags, read once by ``get`` or ``throw``."""

    def __init__(self, flags):
        self._flags = flags         # [(kind, stage, tensor name, flag)]
        self._read = False
        self._msg = None

    def get(self):
        """None for a healthy tick; else "<kind> in stage <stage>: <tensor>"
        of the first check that fired (kind "nan", "inf" or "index"), in
        stage order. One host read, the first time."""
        if not self._read and self._flags:
            hit = torch.stack([f for *_, f in self._flags]).cpu().tolist()
            self._msg = next((f"{kind} in stage {stage}: {name}"
                              for (kind, stage, name, _), h in
                              zip(self._flags, hit) if h), None)
        self._read = True
        return self._msg

    def throw(self):
        """Raise DebugStepError where a check fired."""
        msg = self.get()
        if msg is not None:
            raise DebugStepError(msg)

    def __repr__(self):
        return f"StepError({self.get()!r})"


def _named_leaves(prefix, tree):
    """(dotted field path, tensor) of every tensor in a nest of
    NamedTuples / tuples."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or [
            str(i) for i in range(len(tree))]
        for name, field in zip(names, tree):
            yield from _named_leaves(f"{prefix}.{name}", field)


class _Checks:
    """The flags of one checked tick. ``stage`` flags every NaN, and every
    inf but in `lifetime` (+inf is its "unlimited" sentinel), in a stage's
    floating outputs; ``index`` flags a gather index out of range (the
    physics wrappers of K4a / K4b report theirs through
    ``plane_ops._INDEX_CHECKS``), attributed to the stage that ends
    next."""

    def __init__(self):
        self.flags = []
        self.pending = []

    def index(self, name, bad):
        self.pending.append((name, bad))

    def stage(self, stage, **values):
        self.pending += plane_ops._INDEX_CHECKS or []
        if plane_ops._INDEX_CHECKS:
            plane_ops._INDEX_CHECKS.clear()
        for name, bad in self.pending:
            self.flags.append(("index", stage, name, bad))
        self.pending = []
        for prefix, tree in values.items():
            for name, x in _named_leaves(prefix, tree):
                if not x.is_floating_point() or x.numel() == 0:
                    continue
                self.flags.append(("nan", stage, name, torch.isnan(x).any()))
                if not name.endswith(".lifetime"):
                    self.flags.append(("inf", stage, name,
                                       torch.isinf(x).any()))


def _checked_indices(engine: Engine, state: EngineState, checks: _Checks):
    """Flag the ABSM's state indices (MachineState.current / source) that
    are no valid index of the machine's states (below -n or at n and
    above: a negative one counts from the end, as in numpy), and return
    the state with those set to 0, so that the tick's gathers stay in
    range and the card's context survives (checkify's errors can be
    recovered: a device assert cannot)."""
    anim = state.animation
    if anim is None or anim.machine is None or engine.machine is None:
        return state
    n = len(engine.machine.state_names)
    ms = anim.machine
    fixed = {}
    for f in ("current", "source"):
        idx = getattr(ms, f)
        bad = (idx < -n) | (idx >= n)
        checks.index(f"animation.machine.{f}", bad.any())
        fixed[f] = torch.where(bad, torch.zeros_like(idx), idx)
    return state._replace(animation=anim._replace(
        machine=ms._replace(**fixed)))


def debug_step(engine: Engine, **step_kwargs):
    """The checked tick: the counterpart of the JAX package's checkify step
    (float and index checks over a whole step; the reference's debug-assert
    builds and catch_unwind around physics, physics/mod.rs:1188).

    Returns step_fn(state, **kw) -> (StepError, new_state). The tick is
    ``engine.step(state, **step_kwargs, **kw)`` with device-side flags kept
    after each of its stages (animation, hierarchy, physics, sync,
    refresh, particles): any NaN, and any inf outside the lifetime
    sentinel, in the stage's floating outputs; the ABSM's state indices
    read from the state; and the index tensors given to K4a
    (``plane_gather``) and K4b (``plane_scatter``), where -1 (K4b's
    dropped row, K4a's zero row) is no error. ``error.get()`` reads the
    flags once and names the kind ("nan", "inf" or "index"), the stage and
    the tensor; ``error.throw()`` raises ``DebugStepError``. The fused
    hand kernels (K3, K2, K1) and K5 are checked at the stage boundaries,
    by their outputs, not inside the kernels. An out-of-range ABSM index
    is flagged and then read as 0, so the tick stays in range. No check
    runs in a plain ``Engine.step``. A debug tool: eager only, never
    captured, its cost against a plain tick is in PERF.md."""

    def step(state, **kw):
        global _CHECKS
        checks = _Checks()
        state = _checked_indices(engine, state, checks)
        _CHECKS, plane_ops._INDEX_CHECKS = checks, []
        try:
            out = engine.step(state, **step_kwargs, **kw)
            checks.stage("end")
        finally:
            _CHECKS, plane_ops._INDEX_CHECKS = None, None
        return StepError(checks.flags), out

    return step
