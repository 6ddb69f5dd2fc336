"""Plane gather (K4a) and plane scatter (K4b), and the row-major helpers of
the slab broadphase.

- K4a ``plane_gather``: ``out[w, a, k] = planes[w, a, idx[w, k]]``, where an
  index below 0 or at or above N reads 0; planes [1, A, N] is one table
  that every world reads (world stride 0), so that a table shared by the
  worlds (heightfield corners, hull rows) is not copied W times. Replaces
  ``fyrox_tpu/physics/pallas_ops.py:171 plane_gather``; on the card it is
  ``csrc/plane_gather.cu``.
- K4b ``plane_scatter``: ``out[w, a, b] = Σ_k vals[w, a, k]·[idx[w, k] == b]``,
  where an index below 0 or at or above N drops. Replaces
  ``fyrox_tpu/physics/pallas_ops.py:219 plane_scatter``; on the card it is
  ``csrc/plane_scatter.cu``.

Both ran as one-hot MXU matmuls on the TPU. A CPU tensor takes the plain
version (``plane_gather_plain``, ``plane_scatter_plain``); a CUDA tensor
takes the kernel, which raises on anything it does not take. The gather
moves values and the scatter of a permutation adds one value to zero, so
kernel and plain version agree bit for bit there.
"""
from __future__ import annotations

import torch

__all__ = ["plane_gather", "plane_gather_plain", "gather_rows",
           "plane_scatter", "plane_scatter_plain", "scatter_rows",
           "rank_rows", "count_lt", "launches", "reset_launches"]

_LAUNCHES = {"plane_gather": 0, "plane_scatter": 0}
# a list while engine.debug_step runs a tick: each call appends
# (name, device flag of an index below -1 or at or above N); None otherwise
_INDEX_CHECKS = None


def launches(name: str) -> int:
    """Kernel launches of `name` ("plane_gather" or "plane_scatter")."""
    return _LAUNCHES[name]


def reset_launches():
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _check(fn, x, idx, x_name, shared=False):
    """Raise unless x [W,A,*] float32 and idx [W,K] int32 are contiguous,
    on one device and of matching worlds (x may have one world where
    `shared`)."""
    if x.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"{fn}: {x_name} must be float32 and idx int32, got "
                        f"{x.dtype} / {idx.dtype}")
    if x.dim() != 3 or idx.dim() != 2 or (
            idx.shape[0] != x.shape[0] and not (shared and x.shape[0] == 1)):
        raise ValueError(f"{fn}: shapes {tuple(x.shape)} / "
                         f"{tuple(idx.shape)}, want [W,A,*] / [W,K]")
    if idx.device != x.device:
        raise ValueError(f"{fn}: {x_name} and idx on different devices")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{fn}: inputs must be contiguous")


def _launch(name, out, *args):
    """Call the C entry point fyrox_<name> on the tensors' stream."""
    from fyrox_tpu_torch import kernels
    lib = kernels.library()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = getattr(lib, f"fyrox_{name}")(*args, stream)
    kernels.check(err, f"fyrox_{name}")
    _LAUNCHES[name] += 1
    return out


# --------------------------------------------------------------------------
# K4a: gather
# --------------------------------------------------------------------------

def plane_gather_plain(planes, idx):
    """planes [W,A,N] (or [1,A,N], read by every world) f32, idx [W,K]
    int → [W,A,K]."""
    _, a, n = planes.shape
    w, k = idx.shape
    planes = planes.expand(w, a, n)
    idx = idx.long()
    ok = (idx >= 0) & (idx < n)
    safe = torch.where(ok, idx, torch.zeros_like(idx))
    out = torch.gather(planes, 2, safe[:, None, :].expand(w, a, k))
    return torch.where(ok[:, None, :], out, torch.zeros_like(out))


def _plane_gather_cuda(planes, idx):
    _check("plane_gather", planes, idx, "planes", shared=True)
    wp, a, n = planes.shape
    w, k = idx.shape
    out = torch.empty((w, a, k), dtype=torch.float32, device=planes.device)
    if out.numel() == 0:
        return out
    return _launch("plane_gather", out, planes.data_ptr(), idx.data_ptr(),
                   out.data_ptr(), w, a, n, k, 0 if wp == 1 else a * n)


def _note_indices(name, idx, n):
    """Under engine.debug_step: flag any index below -1 or at or above n
    (-1 is the padding row both kernels take by design)."""
    if _INDEX_CHECKS is not None and idx.numel():
        _INDEX_CHECKS.append((f"{name} idx", ((idx < -1) | (idx >= n)).any()))


def plane_gather(planes, idx):
    """Dispatch: CPU tensors → plain version; CUDA tensors → the kernel
    (which raises on anything it does not take)."""
    _note_indices("plane_gather", idx, planes.shape[2])
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


# --------------------------------------------------------------------------
# K4b: scatter-add
# --------------------------------------------------------------------------

def plane_scatter_plain(vals, idx, n):
    """vals [W,A,K] f32, idx [W,K] int → [W,A,n] sums; out-of-range
    indices drop (they land in a spare column that is cut off)."""
    w, a, k = vals.shape
    idx = idx.long()
    safe = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    out = torch.zeros((w, a, n + 1), dtype=vals.dtype, device=vals.device)
    wi = torch.arange(w, device=vals.device)[:, None, None].expand(w, a, k)
    ai = torch.arange(a, device=vals.device)[None, :, None].expand(w, a, k)
    out.index_put_((wi, ai, safe[:, None, :].expand(w, a, k)), vals,
                   accumulate=True)
    return out[..., :n]


def _plane_scatter_cuda(vals, idx, n):
    _check("plane_scatter", vals, idx, "vals")
    if vals.shape[2] != idx.shape[1]:
        raise ValueError(f"plane_scatter: vals {tuple(vals.shape)} and idx "
                         f"{tuple(idx.shape)} differ in K")
    w, a, k = vals.shape
    out = torch.empty((w, a, n), dtype=torch.float32, device=vals.device)
    if out.numel() == 0:
        return out
    return _launch("plane_scatter", out, vals.data_ptr(), idx.data_ptr(),
                   out.data_ptr(), w, a, k, n)


def plane_scatter(vals, idx, n):
    """Dispatch: CPU tensors → plain version; CUDA tensors → the kernel
    (which raises on anything it does not take)."""
    _note_indices("plane_scatter", idx, n)
    if vals.is_cuda:
        return _plane_scatter_cuda(vals, idx, n)
    return plane_scatter_plain(vals, idx, n)


def scatter_rows(x, idx, n_out, plain=False):
    """x [W,K,D] scatter-added into rows idx [W,K] → [W,n_out,D];
    out-of-range and negative indices drop. With a bijective idx (a
    rank_rows permutation) this is an exact row permutation. Runs as a
    plane scatter on the attribute-major layout (its plain version where
    `plain`, on either device)."""
    planes = x.transpose(1, 2).contiguous()                 # [W,D,K]
    scatter = plane_scatter_plain if plain else plane_scatter
    out = scatter(planes, idx.to(torch.int32).contiguous(), n_out)
    return out.transpose(1, 2)


def rank_rows(key):
    """Stable ascending rank per row: rank[w, i] is the position key[w, i]
    takes in a stable sort of key[w] (the inverse of a stable argsort),
    counted as #{j : (key[j], j) < (key[i], i)}. For int32 keys,
    (key << 32 | index) orders those pairs as one int64, so the count is
    one compare-reduce over [W,N,N]."""
    n = key.shape[1]
    ii = torch.arange(n, device=key.device)
    kx = (key.long() << 32) | ii[None]                      # [W,N] distinct
    return (kx[:, None, :] < kx[:, :, None]).sum(-1, dtype=torch.int32)


def count_lt(skey, q, strict=True):
    """Per-row counting rank: out[w, j] = #{k : skey[w, k] < q[w, j]}
    (<= when not `strict`); skey [W,K] need not be sorted, q [W,Q]. One
    compare-reduce over [W,Q,K]: the broadphase counts its range bounds by
    searchsorted over the sorted keys instead, which gives the same counts
    without the [W,Q,K] intermediate."""
    hit = (skey[:, None, :] < q[:, :, None]) if strict else \
        (skey[:, None, :] <= q[:, :, None])
    return hit.sum(-1, dtype=torch.int32)
