"""Batched Hermite keyframe curves (fyrox-math/src/curve.rs).

A ``CurveSet`` packs C curves of up to K keys as padded host arrays:

    times/values/lt/rt [C, K] f32, kinds [C, K] i32 (0 Constant,
    1 Linear, 2 Cubic), n_keys [C] i32

Sampling follows the reference: clamp outside the key range, dispatch on
the left key's kind, cubic tangents scaled by |p1 - p0|.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch._util import const

__all__ = ["CurveSet", "pack_curves", "sample"]

CONSTANT, LINEAR, CUBIC = 0, 1, 2


class CurveSet(NamedTuple):
    times: np.ndarray     # [C, K] f32
    values: np.ndarray    # [C, K] f32
    kinds: np.ndarray     # [C, K] i32
    lt: np.ndarray        # [C, K] f32 left tangents
    rt: np.ndarray        # [C, K] f32 right tangents
    n_keys: np.ndarray    # [C] i32


def pack_curves(curves, max_keys=None, dtype=np.float32) -> CurveSet:
    """Host-side packing of key lists (dicts with ``time``, ``value`` and
    optional ``kind``, ``lt``, ``rt``). Padding repeats the last key."""
    n = len(curves)
    k = max(max(len(c) for c in curves) if curves else 1, 1)
    if max_keys is not None:
        k = max(k, max_keys)
    times = np.zeros((n, k), dtype)
    values = np.zeros((n, k), dtype)
    kinds = np.full((n, k), LINEAR, np.int32)
    lt = np.zeros((n, k), dtype)
    rt = np.zeros((n, k), dtype)
    n_keys = np.zeros((n,), np.int32)
    for i, keys in enumerate(curves):
        keys = sorted(keys, key=lambda kk: kk["time"])
        n_keys[i] = len(keys)
        for j, key in enumerate(keys):
            times[i, j] = key["time"]
            values[i, j] = key["value"]
            kinds[i, j] = key.get("kind", LINEAR)
            lt[i, j] = key.get("lt", 0.0)
            rt[i, j] = key.get("rt", 0.0)
        if len(keys) > 0:
            times[i, len(keys):] = times[i, len(keys) - 1]
            values[i, len(keys):] = values[i, len(keys) - 1]
    return CurveSet(times, values, kinds, lt, rt, n_keys)


def _cubicf(p0, p1, t, m0, m1):
    t2 = t * t
    t3 = t2 * t
    scale = torch.abs(p1 - p0)
    return ((2.0 * t3 - 3.0 * t2 + 1.0) * p0
            + (t3 - 2.0 * t2 + t) * m0 * scale
            + (-2.0 * t3 + 3.0 * t2) * p1
            + (t3 - t2) * m1 * scale)


def sample(cs: CurveSet, t: torch.Tensor):
    """Sample every curve at times t [..., C] → [..., C]."""
    dev = t.device
    times = const(cs.times, dev)                       # [C,K]
    n_keys = const(cs.n_keys, dev).long()              # [C]
    c, k = times.shape
    t = t.to(times.dtype)
    lead = t.shape[:-1]
    key_idx = torch.arange(k, device=dev)
    valid = key_idx[None, :] < n_keys[:, None]         # [C,K]
    # right key: first valid key with time > t, else the last key
    gt = valid & (times > t[..., None])                # [...,C,K]
    n1 = torch.clamp(n_keys - 1, min=0)
    first_gt = torch.argmax(gt.to(torch.uint8), dim=-1)
    right = torch.where(gt.any(-1), first_gt, n1.expand_as(first_gt))
    left = torch.clamp(right - 1, min=0)

    def g(name, idx):
        a = const(getattr(cs, name), dev).expand(lead + (c, k))
        return torch.gather(a, -1, idx[..., None])[..., 0]

    lt_time, rt_time = g("times", left), g("times", right)
    lv, rv = g("values", left), g("values", right)
    lkind, rkind = g("kinds", left), g("kinds", right)
    l_rt = g("rt", left)
    r_lt = g("lt", right)

    span = rt_time - lt_time
    tt = torch.where(torch.abs(span) < 1e-20, torch.zeros_like(span),
                     (t - lt_time) / torch.where(span == 0,
                                                 torch.ones_like(span), span))
    step_v = torch.where(tt >= 1.0, rv, lv)
    lerp_v = lv + (rv - lv) * tt
    m1 = torch.where(rkind == CUBIC, r_lt, torch.zeros_like(r_lt))
    cubic_v = _cubicf(lv, rv, tt, l_rt, m1)
    out = torch.where(lkind == CONSTANT, step_v,
                      torch.where(lkind == LINEAR, lerp_v, cubic_v))
    first_t, first_v = times[:, 0], const(cs.values, dev)[:, 0]
    last = n1.expand(lead + (c,))
    last_t, last_v = g("times", last), g("values", last)
    out = torch.where(t <= first_t, first_v,
                      torch.where(t >= last_t, last_v, out))
    return torch.where(n_keys > 0, out, torch.zeros_like(out))
