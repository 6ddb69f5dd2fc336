"""Plane gather (K4a): ``out[w, a, k] = planes[w, a, idx[w, k]]``, where
an index below 0 or at or above N reads 0.

Replaces ``fyrox_tpu/physics/pallas_ops.py:171 plane_gather`` (a one-hot
MXU matmul on the TPU). On the card it is ``csrc/plane_gather.cu``; a CPU
tensor takes ``plane_gather_plain``. It moves values and does no
arithmetic, so the two agree bit for bit.
"""
from __future__ import annotations

import torch

__all__ = ["plane_gather", "plane_gather_plain", "gather_rows", "launches",
           "reset_launches"]

_LAUNCHES = 0


def launches() -> int:
    return _LAUNCHES


def reset_launches():
    global _LAUNCHES
    _LAUNCHES = 0


def plane_gather_plain(planes, idx):
    """planes [W,A,N] f32, idx [W,K] int → [W,A,K]."""
    w, a, n = planes.shape
    k = idx.shape[1]
    idx = idx.long()
    ok = (idx >= 0) & (idx < n)
    safe = torch.where(ok, idx, torch.zeros_like(idx))
    out = torch.gather(planes, 2, safe[:, None, :].expand(w, a, k))
    return torch.where(ok[:, None, :], out, torch.zeros_like(out))


def _plane_gather_cuda(planes, idx):
    from fyrox_tpu_torch import kernels
    global _LAUNCHES
    if planes.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError("plane_gather: planes must be float32 and idx int32,"
                        f" got {planes.dtype} / {idx.dtype}")
    if planes.dim() != 3 or idx.dim() != 2 or idx.shape[0] != planes.shape[0]:
        raise ValueError(f"plane_gather: shapes {tuple(planes.shape)} / "
                         f"{tuple(idx.shape)}, want [W,A,N] / [W,K]")
    if idx.device != planes.device:
        raise ValueError("plane_gather: planes and idx on different devices")
    if not (planes.is_contiguous() and idx.is_contiguous()):
        raise ValueError("plane_gather: inputs must be contiguous")
    w, a, n = planes.shape
    k = idx.shape[1]
    out = torch.empty((w, a, k), dtype=torch.float32, device=planes.device)
    if out.numel() == 0:
        return out
    lib = kernels.library()
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    err = lib.fyrox_plane_gather(planes.data_ptr(), idx.data_ptr(),
                                 out.data_ptr(), w, a, n, k, stream)
    kernels.check(err, "fyrox_plane_gather")
    _LAUNCHES += 1
    return out


def plane_gather(planes, idx):
    """Dispatch: CPU tensors → plain version; CUDA tensors → the kernel
    (which raises on anything it does not take)."""
    if planes.is_cuda:
        return _plane_gather_cuda(planes, idx)
    return plane_gather_plain(planes, idx)


def gather_rows(x, idx, plain=False):
    """x [W,B,D] gathered at rows idx [W,K] → [W,K,D]; out-of-range rows
    read zero. Runs as a plane gather on the attribute-major layout (its
    plain version where `plain`, on either device)."""
    planes = x.transpose(1, 2).contiguous()                 # [W,D,B]
    gather = plane_gather_plain if plain else plane_gather
    out = gather(planes, idx.to(torch.int32).contiguous())
    return out.transpose(1, 2)
