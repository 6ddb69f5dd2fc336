"""Small helpers shared by the port's modules."""
from __future__ import annotations

import numpy as np
import torch

_CONST_CACHE: dict = {}


def const(arr, device, dtype=None) -> torch.Tensor:
    """Device copy of a host numpy constant, cached per (array, device).

    Templates hold numpy arrays that never change after build; the step
    functions ask for them every tick, so each array crosses to a device
    once. The cache keeps a reference to the source array, so its id()
    cannot be reused by another array while the entry lives."""
    device = torch.device(device)
    key = (id(arr), str(device), dtype)
    hit = _CONST_CACHE.get(key)
    if hit is not None and hit[0] is arr:
        return hit[1]
    t = torch.tensor(np.asarray(arr), device=device)   # a copy, never a view
    if dtype is not None:
        t = t.to(dtype)
    _CONST_CACHE[key] = (arr, t)
    return t


def tile(a: np.ndarray, w: int, device, dtype=None) -> torch.Tensor:
    """Host array [...] → contiguous [W, ...] tensor on `device`."""
    t = torch.tensor(np.asarray(a), device=device)
    if dtype is not None:
        t = t.to(dtype)
    return t.unsqueeze(0).expand((w,) + tuple(t.shape)).contiguous()
