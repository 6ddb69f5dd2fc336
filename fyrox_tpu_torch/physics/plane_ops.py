"""Plane gather (K4a) and plane scatter (K4b), and the row-major helpers of
the slab broadphase.

- K4a, one kernel (``csrc/plane_gather.cu``) in two layouts; an index
  below 0 or at or above N reads 0, and a table of one world ([1, ...])
  is read by every world (world stride 0), so that a table shared by the
  worlds (heightfield corners, hull rows) is not copied W times:
  ``plane_gather`` ``out[w, a, k] = planes[w, a, idx[w, k]]`` for callers
  that hold attribute-major planes, and ``gather_rows`` ``out[w, k, :] =
  x[w, idx[w, k], :]`` for row-major tables, one launch with no transpose:
  a contiguous [W, K, D] out, or (``planar``) one in attribute-major
  memory for callers that go on by attribute slices. Replaces
  ``fyrox_tpu/physics/pallas_ops.py:171 plane_gather`` and ``:248
  gather_rows``. Both forms count as ``launches("plane_gather")``.
- K4b ``plane_scatter``: ``out[w, a, b] = Σ_k vals[w, a, k]·[idx[w, k] == b]``,
  where an index below 0 or at or above N drops. Replaces
  ``fyrox_tpu/physics/pallas_ops.py:219 plane_scatter``; on the card it is
  ``csrc/plane_scatter.cu``.

Both ran as one-hot MXU matmuls on the TPU. A CPU tensor takes the plain
version (``plane_gather_plain``, ``gather_rows_plain``,
``plane_scatter_plain``); a CUDA tensor takes the kernel, which raises on
anything it does not take. The gather moves values and the scatter of a
permutation adds one value to zero, so kernel and plain version agree bit
for bit there.
"""
from __future__ import annotations

import torch

from fyrox_tpu_torch import kernels

__all__ = ["plane_gather", "plane_gather_plain", "gather_rows",
           "gather_rows_plain", "plane_scatter", "plane_scatter_plain",
           "scatter_rows", "rank_rows", "count_lt", "launches",
           "reset_launches"]

_LAUNCHES = {"plane_gather": 0, "plane_scatter": 0}
# a list while engine.debug_step runs a tick: each call appends
# (name, device flag of an index below -1 or at or above N); None otherwise
_INDEX_CHECKS = None
# the C entry points, each resolved at its first launch
_FNS = {}
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_I32_MAX = 2**31 - 1
_F32, _I64 = torch.float32, torch.int64
_GATHER_IDX = (torch.int32, torch.int64)


def launches(name: str) -> int:
    """Kernel launches of `name` ("plane_gather", both K4a forms, or
    "plane_scatter")."""
    return _LAUNCHES[name]


def reset_launches():
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _check(fn, x, idx, x_name, shared=False, idx_types=(torch.int32,)):
    """Raise unless x [W,*,*] float32 and idx [W,K] (of idx_types) are
    contiguous, on one device and of matching worlds (x may have one world
    where `shared`)."""
    if (x.dtype is _F32 and idx.dtype in idx_types and x.dim() == 3
            and idx.dim() == 2 and (idx.shape[0] == x.shape[0]
                                    or shared and x.shape[0] == 1)
            and x.get_device() == idx.get_device() and x.is_contiguous()
            and idx.is_contiguous()):
        return
    if x.dtype != torch.float32 or idx.dtype not in idx_types:
        raise TypeError(f"{fn}: {x_name} must be float32 and idx "
                        f"{' or '.join(map(str, idx_types))}, got "
                        f"{x.dtype} / {idx.dtype}")
    if x.dim() != 3 or idx.dim() != 2 or (
            idx.shape[0] != x.shape[0] and not (shared and x.shape[0] == 1)):
        raise ValueError(f"{fn}: shapes {tuple(x.shape)} / "
                         f"{tuple(idx.shape)}, want [W,*,*] / [W,K]")
    if idx.get_device() != x.get_device():
        raise ValueError(f"{fn}: {x_name} and idx on different devices")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{fn}: inputs must be contiguous")


def _c_fn(name):
    """The C entry point fyrox_<name>, resolved once."""
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = getattr(kernels.library(), f"fyrox_{name}")
    return fn


def _launch(name, counter, out, *args):
    """Call the C entry point fyrox_<name> on the current stream of out's
    device; count it under `counter`."""
    err = _c_fn(name)(*args, _raw_stream(out.get_device()))
    if err:
        kernels.check(err, f"fyrox_{name}")
    _LAUNCHES[counter] += 1
    return out


# --------------------------------------------------------------------------
# K4a: gather, plane form and row form
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
    _check("plane_gather", planes, idx, "planes", True, _GATHER_IDX)
    wp, a, n = planes.shape
    w, k = idx.shape
    if a * n > _I32_MAX or a * k > _I32_MAX:
        raise ValueError(f"plane_gather: [{wp},{a},{n}] x [{w},{k}] past "
                         f"32-bit offsets")
    out = planes.new_empty((w, a, k))
    if w * a * k == 0:
        return out
    err = _c_fn("plane_gather")(
        planes.data_ptr(), idx.data_ptr(), out.data_ptr(), w, a, n, k,
        0 if wp == 1 else a * n, 0, idx.dtype is _I64,
        _raw_stream(out.get_device()))
    if err:
        kernels.check(err, "fyrox_plane_gather")
    _LAUNCHES["plane_gather"] += 1
    return out


def _note_indices(name, idx, n):
    """Under engine.debug_step: flag any index below -1 or at or above n
    (-1 is the padding row both kernels take by design)."""
    if _INDEX_CHECKS is not None and idx.numel():
        _INDEX_CHECKS.append((f"{name} idx", ((idx < -1) | (idx >= n)).any()))


def plane_gather(planes, idx):
    """Dispatch: CPU tensors → plain version; CUDA tensors → the kernel
    (which raises on anything it does not take)."""
    if _INDEX_CHECKS is not None:
        _note_indices("plane_gather", idx, planes.shape[2])
    if planes.is_cuda:
        return _plane_gather_cuda(planes, idx)
    return plane_gather_plain(planes, idx)


def gather_rows_plain(x, idx, planar=False):
    """x [W,B,D] (or [1,B,D], read by every world) f32, idx [W,K] int →
    [W,K,D]: row idx[w, k] of world w, zero where the index is below 0 or
    at or above B; contiguous, or with `planar` a view of attribute-major
    [W,D,K] memory, as gather_rows gives it."""
    if planar:
        return plane_gather_plain(x.transpose(1, 2), idx).transpose(1, 2)
    _, b, d = x.shape
    w, k = idx.shape
    idx = idx.long()
    ok = (idx >= 0) & (idx < b)
    safe = torch.where(ok, idx, torch.zeros_like(idx))
    out = torch.gather(x.expand(w, b, d), 1, safe[..., None].expand(w, k, d))
    return torch.where(ok[..., None], out, torch.zeros_like(out))


def _gather_rows_cuda(x, idx, planar=False):
    # a planar gather reads x row-major ([B,D] a world) or attribute-major
    # ([D,B] a world: an earlier planar gather's output)
    rows_major = x.is_contiguous()
    _check("gather_rows", x if rows_major or not planar else x.transpose(1, 2),
           idx, "x", True, _GATHER_IDX)
    wx, b, d = x.shape
    w, k = idx.shape
    if b * d > _I32_MAX or k * d > _I32_MAX:
        raise ValueError(f"gather_rows: [{wx},{b},{d}] x [{w},{k}] past "
                         f"32-bit offsets")
    stride = 0 if wx == 1 else b * d
    # planar: [W,K,D] over attribute-major memory, allocated so
    out = (x.new_empty_strided((w, k, d), (d * k, 1, k)) if planar
           else x.new_empty((w, k, d)))
    if w * k * d:
        ptrs = x.data_ptr(), idx.data_ptr(), out.data_ptr()
        stream = _raw_stream(out.get_device())
        if planar:
            err = _c_fn("plane_gather")(*ptrs, w, d, b, k, stride,
                                        rows_major, idx.dtype is _I64, stream)
        else:
            err = _c_fn("gather_rows")(*ptrs, w, b, d, k, stride,
                                       idx.dtype is _I64, stream)
        if err:
            kernels.check(err, "fyrox_plane_gather" if planar
                          else "fyrox_gather_rows")
        _LAUNCHES["plane_gather"] += 1
    return out


def gather_rows(x, idx, plain=False, planar=False):
    """x [W,B,D] (or [1,B,D], read by every world) gathered at rows idx
    [W,K] (int32 or int64) → [W,K,D]; out-of-range rows read zero. One K4a
    launch on the card, no copy: a contiguous [W,K,D], or with `planar` a
    view of attribute-major [W,D,K] memory (each attribute's K values
    contiguous, the layout in which callers that go on by attribute slices
    read fastest; x may then also be such a view). Dispatch: CPU tensors,
    or `plain`, → gather_rows_plain; CUDA tensors → the kernel (which
    raises on anything it does not take)."""
    if plain:
        return gather_rows_plain(x, idx, planar)
    if _INDEX_CHECKS is not None:
        _note_indices("gather_rows", idx, x.shape[1])
    if x.is_cuda:
        return _gather_rows_cuda(x, idx, planar)
    return gather_rows_plain(x, idx, planar)


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
    return _launch("plane_scatter", "plane_scatter", out, vals.data_ptr(),
                   idx.data_ptr(), out.data_ptr(), w, a, k, n)


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
