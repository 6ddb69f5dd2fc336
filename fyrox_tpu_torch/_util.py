"""Small helpers shared by the port's modules."""
from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=None)
def _host_value(value, dtype):
    return np.asarray(value, dtype)


def value_const(value, device, dtype=np.float32) -> torch.Tensor:
    """Device copy of a small constant given by value (a float or a tuple
    of floats), made once per (value, dtype, device) as ``const`` makes
    it: a frame that asks for it again copies nothing from the host."""
    return const(_host_value(value, np.dtype(dtype).str), device)


def resolve_device(device) -> torch.device:
    """The device of an entry point: the card unless the caller asks for
    another. Raises where the card is asked for and there is none; nothing
    carries on on the CPU by itself."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fyrox_tpu_torch runs on a CUDA card unless asked otherwise, and "
            "torch.cuda.is_available() is False here; pass device=\"cpu\" "
            "to run the plain PyTorch versions on the CPU")
    return device


def tile(a: np.ndarray, w: int, device, dtype=None) -> torch.Tensor:
    """Host array [...] → contiguous [W, ...] tensor on `device`."""
    t = torch.tensor(np.asarray(a), device=device)
    if dtype is not None:
        t = t.to(dtype)
    return t.unsqueeze(0).expand((w,) + tuple(t.shape)).contiguous()


def const_rows(arr, device, w, dtype=None) -> torch.Tensor:
    """Contiguous [W, N] device copy of a host constant [N] repeated for
    W worlds, cached per (array, device, dtype, W) as ``const`` caches: a
    per-world index table built once, so that a step (and a CUDA graph
    capture of it) copies nothing from the host."""
    key = ("rows", id(arr), str(torch.device(device)), dtype, w)
    hit = _CONST_CACHE.get(key)
    if hit is not None and hit[0] is arr:
        return hit[1]
    t = const(arr, device, dtype).unsqueeze(0).expand(w, -1).contiguous()
    _CONST_CACHE[key] = (arr, t)
    return t


def dot3(a, b):
    """a·b over the last axis (3), summed in index order, so that the card
    and the CPU round it alike (torch.sum's reduction order differs
    between them)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def sqrt_rn(x):
    """The correctly rounded square root on either device: the card's
    float32 sqrt is; the CPU's is not always, its float64 one rounded to
    float32 is."""
    return torch.sqrt(x) if x.is_cuda else torch.sqrt(x.double()).to(x.dtype)


def static_copy(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x: a CUDA graph's static input buffer."""
    return torch.empty_like(x, memory_format=torch.contiguous_format
                            ).copy_(x)
