"""Particle systems, batched (fyrox-impl scene/particle_system/: seeded
deterministic emission, particle_system/mod.rs:68-82; sphere, cuboid and
cylinder emitters).

Every world's pool is a fixed [W, P] slot array; dead slots are masked and
re-used by emission. The draws are the JAX package's counter-based streams
(``core.threefry``): the tick's key folds the step counter into the seed's
key, each world takes its key by split, and each quantity its own
``fold_in`` stream (10: positions, 11: directions, 12: speeds, 13:
lifetimes, 14: sizes). The counter is a 0-d device tensor, so a captured
tick draws anew on every replay.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch._util import const, resolve_device
from fyrox_tpu_torch.core import threefry

__all__ = ["EmitterKind", "ParticleTemplate", "ParticleState",
           "init_particles", "step_particles"]


class EmitterKind:
    SPHERE, CUBOID, CYLINDER = 0, 1, 2


@dataclass
class ParticleTemplate:
    max_particles: int = 256
    emit_rate: float = 60.0          # particles/sec
    emitter_kind: int = EmitterKind.SPHERE
    emitter_size: tuple = (0.5, 0.5, 0.5)  # radius / half-extents / (r, h, -)
    initial_speed: tuple = (0.5, 2.0)      # min/max
    lifetime: tuple = (1.0, 3.0)
    size: tuple = (0.05, 0.15)
    acceleration: tuple = (0.0, -9.81, 0.0)
    seed: int = 0

    def host_arrays(self):
        """(acceleration, emitter_size) as float32 [3] host arrays, made
        once, so that a step's device constants come from the cache (a
        captured tick copies nothing from the host)."""
        key = (tuple(self.acceleration), tuple(self.emitter_size))
        if getattr(self, "_host", (None,))[0] != key:
            self._host = (key, np.asarray(key[0], np.float32).reshape(3),
                          np.asarray(key[1], np.float32).reshape(3))
        return self._host[1:]


class ParticleState(NamedTuple):
    position: torch.Tensor   # [W,P,3] emitter-local
    velocity: torch.Tensor   # [W,P,3]
    lifetime: torch.Tensor   # [W,P] remaining seconds (<= 0 dead)
    size: torch.Tensor       # [W,P]
    alive: torch.Tensor      # [W,P] bool
    spawn_debt: torch.Tensor  # [W] fractional emission accumulator
    step: torch.Tensor       # [] int32 RNG counter


def init_particles(t: ParticleTemplate, num_worlds: int,
                   device="cuda") -> ParticleState:
    device = resolve_device(device)
    w, p = num_worlds, t.max_particles

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ParticleState(position=zeros(w, p, 3), velocity=zeros(w, p, 3),
                         lifetime=zeros(w, p), size=zeros(w, p),
                         alive=zeros(w, p, dtype=torch.bool),
                         spawn_debt=zeros(w),
                         step=zeros(dtype=torch.int32))


def _norm(v):
    return torch.sqrt(torch.sum(v * v, -1, keepdim=True))


def _emit_positions(t: ParticleTemplate, key, p: int):
    """Emitter-local birth positions [W,P,3] from stream 10's keys [W]."""
    u = threefry.uniform(key, (p, 3), -1.0, 1.0)
    if t.emitter_kind == EmitterKind.SPHERE:
        d = u / torch.clamp(_norm(u), min=1e-6)
        r = threefry.uniform(threefry.fold_in(key, 1), (p,)) ** (1 / 3)
        return d * (r * t.emitter_size[0])[..., None]
    if t.emitter_kind == EmitterKind.CUBOID:
        return u * const(t.host_arrays()[1], u.device)
    ang = threefry.uniform(threefry.fold_in(key, 2), (p,)) * 2 * np.pi
    rad = torch.sqrt(threefry.uniform(threefry.fold_in(key, 3), (p,)))
    r, h = t.emitter_size[0], t.emitter_size[1]
    return torch.stack([torch.cos(ang) * rad * r, u[..., 1] * h,
                        torch.sin(ang) * rad * r], -1)


def step_particles(state: ParticleState, t: ParticleTemplate,
                   dt) -> ParticleState:
    """One tick: age, integrate, then emit into the first dead slots."""
    w, p = state.lifetime.shape
    dev = state.lifetime.device
    lifetime = state.lifetime - dt
    alive = state.alive & (lifetime > 0.0)
    acc = const(t.host_arrays()[0], dev)
    vel = state.velocity + dt * acc
    pos = state.position + dt * vel

    debt = state.spawn_debt + t.emit_rate * dt
    n_spawn = torch.floor(debt).to(torch.int32)
    debt = debt - n_spawn

    key = threefry.fold_in(threefry.prng_key(t.seed, dev), state.step)
    wkeys = threefry.split(key, w)                         # [W] words

    dead = ~alive
    dead_rank = torch.cumsum(dead.to(torch.int32), dim=1)
    newborn = dead & (dead_rank <= n_spawn[:, None])

    p0 = _emit_positions(t, threefry.fold_in(wkeys, 10), p)
    dirs = threefry.normal(threefry.fold_in(wkeys, 11), (p, 3))
    dirs = dirs / torch.clamp(_norm(dirs), min=1e-6)
    spd = threefry.uniform(threefry.fold_in(wkeys, 12), (p,),
                           *t.initial_speed)
    lt = threefry.uniform(threefry.fold_in(wkeys, 13), (p,), *t.lifetime)
    sz = threefry.uniform(threefry.fold_in(wkeys, 14), (p,), *t.size)

    nb3 = newborn[..., None]
    return ParticleState(position=torch.where(nb3, p0, pos),
                         velocity=torch.where(nb3, dirs * spd[..., None], vel),
                         lifetime=torch.where(newborn, lt, lifetime),
                         size=torch.where(newborn, sz, state.size),
                         alive=alive | newborn, spawn_debt=debt,
                         step=state.step + 1)
