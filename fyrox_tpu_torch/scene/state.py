"""WorldState: the dynamic, batched half of a scene ([W, ...] tensors),
field for field the layout of ``fyrox_tpu.scene.state.WorldState``."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from fyrox_tpu_torch._util import resolve_device, tile
from fyrox_tpu_torch.scene.template import SceneTemplate

__all__ = ["WorldState", "init_state"]


class WorldState(NamedTuple):
    position: torch.Tensor          # [W,N,3] local transforms
    rotation: torch.Tensor          # [W,N,4]
    scale: torch.Tensor             # [W,N,3]
    visibility: torch.Tensor        # [W,N] bool
    enabled: torch.Tensor           # [W,N] bool
    lifetime: torch.Tensor          # [W,N] f32, +inf = unlimited
    alive: torch.Tensor             # [W,N] bool
    globals_: torch.Tensor          # [W,N,4,4] derived
    global_visibility: torch.Tensor
    global_enabled: torch.Tensor
    time: torch.Tensor              # [W] f32
    pre_rotation: Optional[torch.Tensor] = None
    post_rotation: Optional[torch.Tensor] = None
    rotation_offset: Optional[torch.Tensor] = None
    rotation_pivot: Optional[torch.Tensor] = None
    scaling_offset: Optional[torch.Tensor] = None
    scaling_pivot: Optional[torch.Tensor] = None

    @property
    def num_worlds(self) -> int:
        return self.position.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.position.shape[1]


def init_state(template: SceneTemplate, num_worlds: int,
               device="cuda") -> WorldState:
    """Broadcast the template's initial values into a [W, ...] state, on
    the card unless `device` says otherwise."""
    device = resolve_device(device)
    w, n = num_worlds, template.num_nodes
    f32 = torch.float32

    def opt(a):
        return None if a is None else tile(a.astype(np.float32), w, device)

    return WorldState(
        position=tile(template.init_position, w, device, f32),
        rotation=tile(template.init_rotation, w, device, f32),
        scale=tile(template.init_scale, w, device, f32),
        visibility=tile(template.init_visibility.astype(bool), w, device),
        enabled=tile(template.init_enabled.astype(bool), w, device),
        lifetime=tile(template.init_lifetime, w, device, f32),
        alive=torch.ones((w, n), dtype=torch.bool, device=device),
        globals_=torch.eye(4, dtype=f32, device=device).expand(
            w, n, 4, 4).contiguous(),
        global_visibility=torch.ones((w, n), dtype=torch.bool, device=device),
        global_enabled=torch.ones((w, n), dtype=torch.bool, device=device),
        time=torch.zeros((w,), dtype=f32, device=device),
        pre_rotation=opt(template.init_pre_rotation),
        post_rotation=opt(template.init_post_rotation),
        rotation_offset=opt(template.init_rotation_offset),
        rotation_pivot=opt(template.init_rotation_pivot),
        scaling_offset=opt(template.init_scaling_offset),
        scaling_pivot=opt(template.init_scaling_pivot),
    )
