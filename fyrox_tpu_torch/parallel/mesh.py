"""Device-mesh parallelism: shard the world axis over devices.

Worlds are independent by construction, so sharding is pure data
parallelism (fyrox_tpu's parallel/mesh.py):

  * a 1-D mesh ("worlds",) of torch devices, every visible card by default
  * every [W, ...] tensor of an EngineState split on axis 0 into equal
    shards, one per mesh entry, each on its device; scalars replicated
  * cross-shard work only for the rollout's metrics (mean body speed,
    world count), reduced onto the mesh's first device

PyTorch has no shard_map: a sharded state is a list of per-shard states,
and a sharded call issues every shard's work before it reads anything
back, so shards on different cards overlap. A device may appear more than
once in a mesh: shards of one W on one card share that card's captured
tick (``Engine.captured_tick``), which is safe because its ``run`` copies
a shard in and returns fresh tensors.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Tuple

import torch

from fyrox_tpu_torch._util import resolve_device
from fyrox_tpu_torch.engine import _leaves, _map

__all__ = ["world_mesh", "shard_state", "make_sharded_step",
           "make_sharded_rollout", "unshard_state"]


@dataclass(frozen=True)
class WorldMesh:
    """A 1-D mesh: the devices of the shards, in shard order."""
    devices: Tuple[torch.device, ...]
    axis_name: str = "worlds"

    @property
    def size(self) -> int:
        return len(self.devices)


def world_mesh(devices=None, axis_name="worlds") -> WorldMesh:
    """A mesh over `devices` (every visible CUDA device by default; raises
    where there is none). The CPU is used only when asked, e.g.
    ``world_mesh(["cpu", "cpu"])``."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "world_mesh: no CUDA device is visible; pass the devices, "
                "e.g. world_mesh([\"cpu\", \"cpu\"]), to shard on the CPU")
        devices = [f"cuda:{i}" for i in range(n)]
    devs = []
    for d in devices:
        d = resolve_device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        devs.append(d)
    if not devs:
        raise ValueError("world_mesh: no devices")
    return WorldMesh(tuple(devs), axis_name)


def _on(device):
    """The device's context for the work issued inside it."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def shard_state(state, mesh: WorldMesh) -> list:
    """The state split into mesh.size shards, shard i on mesh.devices[i]:
    every tensor with ndim >= 1 in equal parts along axis 0, scalars
    copied to every shard. Refuses a leading axis that the shard count
    does not divide."""
    n = mesh.size
    for x in _leaves(state):
        if x.ndim >= 1 and x.shape[0] % n:
            raise ValueError(
                f"shard_state: a leading axis of {x.shape[0]} does not "
                f"split into {n} equal shards")

    def part(x, i, dev):
        if x.ndim == 0:
            return x.to(dev, copy=True)
        k = x.shape[0] // n
        return x[i * k:(i + 1) * k].to(dev, copy=True)

    return [_map(lambda x, i=i, d=d: part(x, i, d), state)
            for i, d in enumerate(mesh.devices)]


def unshard_state(shards: list):
    """One state from its shards, on the first shard's device: tensors
    with ndim >= 1 concatenated along axis 0, scalars taken from the first
    shard."""
    dev = _leaves(shards[0])[0].device

    def join(x, *rest):
        if x.ndim == 0:
            return x.to(dev, copy=True)
        return torch.cat([x.to(dev)] + [r.to(dev) for r in rest])

    return _map(join, shards[0], *shards[1:])


def _check(shards, mesh):
    if len(shards) != mesh.size:
        raise ValueError(f"sharded call: {len(shards)} shards for a mesh of "
                         f"{mesh.size} devices")


def make_sharded_step(engine, mesh: WorldMesh):
    """fn(shards) -> shards: one ``engine.step`` per shard on its device."""
    def step(shards: list) -> list:
        _check(shards, mesh)
        out = []
        for s, dev in zip(shards, mesh.devices):
            with _on(dev):
                out.append(engine.step(s))
        return out

    return step


def make_sharded_rollout(engine, mesh: WorldMesh, num_steps: int,
                         with_metrics=True):
    """fn(shards) -> (shards, metrics): ``engine.rollout`` of num_steps
    ticks per shard on its device. The metrics are reduced across the
    shards onto the first device: ``mean_body_speed`` is the mean of the
    shards' mean linear speeds (equal shards: the global mean) and
    ``total_worlds`` the sum of their world counts."""
    def roll(shards: list) -> Tuple[List, dict]:
        _check(shards, mesh)
        out = []
        for s, dev in zip(shards, mesh.devices):
            with _on(dev):
                out.append(engine.rollout(s, num_steps))
        if not with_metrics:
            return out, {}
        first = mesh.devices[0]
        speeds = []
        for s, dev in zip(out, mesh.devices):
            with _on(dev):
                speeds.append(
                    torch.zeros((), device=dev) if s.physics is None
                    else torch.linalg.vector_norm(s.physics.linvel,
                                                  dim=-1).mean())
        worlds = sum(s.scene.position.shape[0] for s in out)
        metrics = {
            "mean_body_speed": torch.stack(
                [x.to(first) for x in speeds]).mean(),
            "total_worlds": torch.tensor(float(worlds), device=first),
        }
        return out, metrics

    return roll
