"""Slab and grid broadphases: a hash-grid walk into static per-collider
candidate windows (``fyrox_tpu.physics.broadphase`` slab path), or into a
global per-class compaction (its grid path, ``grid_candidates``: the
walk's survivors compact into ``GridConfig.caps[c]`` directed pairs a
world, the first in slot order kept and the rest dropped).

The slab path:

1. quantize each grid collider's fat-AABB min corner to coarse x/y cells
   and a fine z grid, pack (x, y, z) into one int key and order the
   colliders stably by key: by a stable argsort and a row gather (rank
   "sort"), or by the counting rank ``plane_ops.rank_rows`` and a row
   scatter through K4b ``plane_scatter`` (rank "count", the JAX package's
   ``FYROX_BP_RANK=count``); both give the same windows;
2. each collider walks the 9 (dx, dy) neighbour columns over the exact
   z-interval into a raw window of ``s_walk`` slots;
3. survivors (distinct bodies, one dynamic, fat-AABB overlap) compact per
   manifold-size class into ``s_class[c]`` slots, pairs whose tight AABBs
   overlap first: the rapier prediction-distance AABBs (``tight_delta``),
   or, under temporal broadphase reuse, the current step's own AABBs
   beside the period-fattened ones (``amin_tight`` / ``amax_tight``);
4. "big" colliders (halfspaces, heightfields, trimeshes) get one static
   slot per class.

Candidates are directed: (i, j) comes from i's window and (j, i) from j's.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from fyrox_tpu_torch._util import const
from fyrox_tpu_torch.physics import shapes as sh
from fyrox_tpu_torch.physics.plane_ops import (gather_rows, rank_rows,
                                               scatter_rows)

__all__ = ["CLASS_NPTS", "KIND_POINTS", "pair_class_table", "SlabConfig",
           "build_slab_config", "SlabCandidates", "class_windows",
           "slab_candidates", "compact_slots", "RANKS", "GridConfig",
           "build_grid_config", "CandidateSet", "grid_candidates",
           "broadphase_stats"]

RANKS = ("sort", "count")

_QBITS_XY = 9
_QRANGE_XY = 1 << _QBITS_XY
_QHALF_XY = _QRANGE_XY // 2
_QBITS_Z = 13
_QRANGE_Z = 1 << _QBITS_Z
_QHALF_Z = _QRANGE_Z // 2
_ZFINE = 8

CLASS_NPTS = (1, 2, 4)

# manifold points per canonical effective-kind pair
KIND_POINTS = {
    (sh.BALL, sh.BALL): 1, (sh.BALL, sh.CUBOID): 1, (sh.BALL, sh.CAPSULE): 1,
    (sh.BALL, sh.HALFSPACE): 1, (sh.CUBOID, sh.CUBOID): 4,
    (sh.CUBOID, sh.CAPSULE): 2, (sh.CUBOID, sh.HALFSPACE): 4,
    (sh.CAPSULE, sh.CAPSULE): 1, (sh.CAPSULE, sh.HALFSPACE): 2,
    (sh.BALL, sh.CONVEX): 1, (sh.CUBOID, sh.CONVEX): 4,
    (sh.CAPSULE, sh.CONVEX): 2, (sh.HALFSPACE, sh.CONVEX): 4,
    (sh.CONVEX, sh.CONVEX): 4,
    (sh.BALL, sh.HEIGHTFIELD): 1, (sh.CAPSULE, sh.HEIGHTFIELD): 2,
    (sh.CUBOID, sh.HEIGHTFIELD): 4, (sh.CONVEX, sh.HEIGHTFIELD): 4,
    (sh.BALL, sh.TRIMESH): 1, (sh.CAPSULE, sh.TRIMESH): 2,
    (sh.CUBOID, sh.TRIMESH): 4, (sh.CONVEX, sh.TRIMESH): 4,
}


def pair_class_table():
    """[9,9] manifold-size class (0: 1 pt, 1: 2 pts, 2: 4 pts) per kind
    pair; cylinder/cone mirror their capsule proxy."""
    tab = np.zeros((sh.NUM_KINDS, sh.NUM_KINDS), np.int32)
    npts_to_class = {1: 0, 2: 1, 4: 2}
    for (ka, kb), npts in KIND_POINTS.items():
        tab[ka, kb] = npts_to_class[npts]
        tab[kb, ka] = npts_to_class[npts]
    for t in (sh.CYLINDER, sh.CONE):
        tab[t, :] = tab[sh.CAPSULE, :]
        tab[:, t] = tab[:, sh.CAPSULE]
        for u in (sh.CYLINDER, sh.CONE):
            tab[t, u] = tab[sh.CAPSULE, sh.CAPSULE]
    return tab


def _eff_kind(t):
    return sh.CAPSULE if t in (sh.CYLINDER, sh.CONE) else t


@dataclass
class SlabConfig:
    """Static per-collider slot layout (host numpy)."""
    grid_cols: np.ndarray      # [Cg] collider index in the grid
    big_cols: np.ndarray       # [Nbig] unbounded static colliders
    cell: float
    s_class: Tuple[int, int, int]
    kinds: np.ndarray          # [C] effective kind
    cls_tab: np.ndarray = None
    present: Tuple[bool, bool, bool] = (True, True, True)
    sweep_cap: np.ndarray = None   # [C] max CCD sweep per collider
    num_colliders: int = 0
    num_bodies: int = 0
    s_walk: int = 48
    s_active: int = 16

    def nslot(self, cls):
        if not self.present[cls]:
            return 0
        return self.s_class[cls] + int(self.big_cols.size)


def build_slab_config(col_shape, col_params, col_body, body_type,
                      margin, window=(12, 6, 10), walk=48, big_factor=8.0,
                      active_window=16, extent_hint=None):
    """Host-side slab layout; None when no collider is grid-eligible."""
    nc = int(col_shape.shape[0])
    if nc == 0:
        return None
    bound = np.zeros(nc, np.float64)
    for i in range(nc):
        t = int(col_shape[i])
        p = np.asarray(col_params[i], np.float64)
        if t == sh.BALL:
            bound[i] = p[0]
        elif t == sh.CUBOID:
            bound[i] = float(np.linalg.norm(p[:3]))
        elif t == sh.CAPSULE:
            bound[i] = float(np.linalg.norm([p[1], p[0] + p[1], p[1]]))
        elif t in (sh.CYLINDER, sh.CONE):
            bound[i] = float(np.linalg.norm([p[1], p[0], p[1]]))
        elif t == sh.CONVEX:
            bound[i] = p[0]          # the hull's radius bound
        else:
            # halfspace and scenery: broadphase-big partners, one static
            # slot per grid collider per class
            bound[i] = np.inf
    finite = np.isfinite(bound)
    med = np.median(bound[finite]) if finite.any() else 1.0
    big = ~finite | (bound > big_factor * max(med, 1e-6))
    dyn = body_type[col_body] == 0
    if np.any(big & dyn):
        raise ValueError("dynamic colliders cannot be broadphase-big")
    grid_cols = np.flatnonzero(~big).astype(np.int32)
    big_cols = np.flatnonzero(big).astype(np.int32)
    if grid_cols.size == 0:
        return None
    cell = float(2.0 * bound[grid_cols].max() + 2.0 * margin)
    if extent_hint is not None:
        addressable = (_QHALF_XY - 2) * cell
        if float(extent_hint) > addressable:
            warnings.warn(
                f"slab broadphase: scene extent {float(extent_hint):.1f} "
                f"exceeds the ±{addressable:.1f} addressable key range; "
                "colliders beyond it alias into border cells")
    kinds = np.asarray([_eff_kind(int(k)) for k in col_shape], np.int32)
    nb = int(body_type.shape[0])
    cls_tab = pair_class_table()
    present = np.zeros(3, bool)
    for ka in np.unique(kinds[grid_cols]):
        for kb in np.unique(kinds):
            present[cls_tab[ka, kb]] = True
    if isinstance(window, int):
        window = (window, window, window)
    s_class = tuple(int(window[c]) if present[c] else 0 for c in range(3))
    sweep_cap = np.maximum(
        cell - 2.0 * (np.where(np.isfinite(bound), bound, 0.0) + margin),
        0.0).astype(np.float32)
    return SlabConfig(grid_cols=grid_cols, big_cols=big_cols, cell=cell,
                      s_class=s_class, kinds=kinds, cls_tab=cls_tab,
                      present=tuple(bool(p) for p in present),
                      sweep_cap=sweep_cap, num_colliders=nc, num_bodies=nb,
                      s_walk=int(walk), s_active=int(active_window))


class SlabCandidates(NamedTuple):
    """[W,K] slot tensors, K = Cg * nslot(c), collider-major."""
    j_real: torch.Tensor    # partner collider (0 where ~valid)
    body_j: torch.Tensor
    valid: torch.Tensor
    swap: torch.Tensor      # canonical order flips (kind_i, i) > (kind_j, j)
    pid: torch.Tensor       # i*C + j warm-start identity, -1 invalid


def _pack_xyz(qx, qy, qz):
    """Coarse x/y cells + fine z cell → one non-negative int32 key."""
    qxc = torch.clamp(qx + _QHALF_XY, 0, _QRANGE_XY - 1)
    qyc = torch.clamp(qy + _QHALF_XY, 0, _QRANGE_XY - 1)
    qzc = torch.clamp(qz + _QHALF_Z, 0, _QRANGE_Z - 1)
    return ((qxc << (_QBITS_XY + _QBITS_Z)) | (qyc << _QBITS_Z)) | qzc


def _floor_i32(x):
    return torch.floor(x).to(torch.int32)


def _statics(sc: SlabConfig, col_body, dyn_col):
    """Per-config host tables, cached on the config."""
    st = getattr(sc, "_torch_statics", None)
    if st is None:
        gc = sc.grid_cols
        kind_i_g = sc.kinds[gc]
        st = dict(
            # cell sizes as float32 device scalars: dividing by a tensor is
            # IEEE division on both devices (PyTorch turns a division by a
            # Python float on the card into a product with its reciprocal)
            cell=np.float32(sc.cell), zfine=np.float32(sc.cell / _ZFINE),
            attr_static=np.stack([gc.astype(np.float32),
                                  kind_i_g.astype(np.float32),
                                  col_body[gc].astype(np.float32),
                                  dyn_col[gc].astype(np.float32)], axis=1),
            gidx=gc.astype(np.int64),
            i_body_g=col_body[gc].astype(np.int32),
            i_dyn_g=dyn_col[gc].astype(bool),
            row_tab=sc.cls_tab[kind_i_g].astype(np.int64),  # [Cg,9]
            big_cols=sc.big_cols.astype(np.int64),
            body_big=col_body[sc.big_cols].astype(np.int32),
            dyn_big=dyn_col[sc.big_cols].astype(bool),
            kind_big=sc.kinds[sc.big_cols].astype(np.int32),
            cls_big=sc.cls_tab[kind_i_g][:, sc.kinds[sc.big_cols]].astype(
                np.int32),                                  # [Cg,Nbig]
        )
        for c in range(3):
            i_static = np.repeat(gc, sc.nslot(c)).astype(np.int32)
            st[f"i_static{c}"] = i_static
            st[f"kind_i{c}"] = sc.kinds[i_static].astype(np.int32)
        sc._torch_statics = st
    return st


def compact_slots(mask, first, values, s_out):
    """Pack the True entries of mask [W,Cg,Sw] into s_out slots per row,
    `first` entries ahead of the rest, each group in slot order. values:
    list of [W,Cg,Sw] tensors → list of [W,Cg,s_out] (0 where unfilled).
    Returns (packed values, count of True per row)."""
    mf = mask.to(torch.int32)
    tf = (first & mask).to(torch.int32)
    sf = mf - tf
    lpos_t = torch.cumsum(tf, dim=2) - tf
    n_t = tf.sum(dim=2, keepdim=True)
    lpos_s = n_t + torch.cumsum(sf, dim=2) - sf
    lpos = torch.where(tf > 0, lpos_t, lpos_s)
    keep = mask & (lpos < s_out)
    dst = torch.where(keep, lpos, torch.full_like(lpos, s_out)).long()
    w, cg = mask.shape[:2]
    out = []
    for v in values:
        buf = torch.zeros((w, cg, s_out + 1), dtype=v.dtype, device=v.device)
        buf.scatter_(2, dst, v)   # unfilled/overflow sources land in slot s_out
        out.append(buf[..., :s_out])
    return out, mf.sum(dim=2)


def class_windows(sc: SlabConfig, col_body, dyn_col, amin, amax,
                  tight_delta=None, amin_tight=None, amax_tight=None,
                  rank="sort", plain=False):
    """Stages 1-3 for the grid colliders. amin/amax [W,C,3] fat AABBs;
    the tight tier is amin_tight/amax_tight [W,C,3] where given, else the
    fat AABBs shrunk by tight_delta, else none. Returns (windows, aabb6,
    walk_total): per manifold class c (None where absent) the compacted
    partners (j_real, kind_j, body_j) [W,Cg,s_class[c]] (0 where unfilled)
    with the counts of valid and of tight pairs [W,Cg]; the full AABBs
    [W,C,6]; and the raw walk demand [W,Cg]. plain: gather and scatter
    rows in PyTorch even on the card (no K4a / K4b launches)."""
    if rank not in RANKS:
        raise ValueError(f"rank {rank!r}, want one of {RANKS}")
    col_body = np.asarray(col_body)
    dyn_col = np.asarray(dyn_col)
    st = _statics(sc, col_body, dyn_col)
    dev = amin.device
    w = amin.shape[0]
    cg = int(sc.grid_cols.size)
    gsel = const(st["gidx"], dev)

    aabb6 = torch.cat([amin, amax], dim=-1)                     # [W,C,6]
    gaabb = aabb6[:, gsel]                                      # [W,Cg,6]
    gmin, gmax = gaabb[..., :3], gaabb[..., 3:]
    cell = const(st["cell"], dev)
    zfine = const(st["zfine"], dev)
    qx = _floor_i32(gmin[..., 0] / cell)
    qy = _floor_i32(gmin[..., 1] / cell)
    qz = _floor_i32(gmin[..., 2] / zfine)
    key = _pack_xyz(qx, qy, qz)                                 # [W,Cg]

    # per-grid-collider rows [j_real, kind, body, dyn, aabb6 (+ tight
    # aabb6)], exact in f32, put into key order
    two_tier = amin_tight is not None
    parts = [const(st["attr_static"], dev).expand(w, cg, 4), gaabb]
    if two_tier:
        gtaabb = torch.cat([amin_tight, amax_tight], dim=-1)[:, gsel]
        parts.append(gtaabb)
    attrs = torch.cat(parts, dim=-1)                            # [W,Cg,10|16]
    na = attrs.shape[-1]
    if rank == "count":
        # the keys go into sorted order by an integer scatter (packed keys
        # reach 2^31, past float32's exact integers)
        rk = rank_rows(key)
        skey = torch.zeros_like(key).scatter_(1, rk.long(), key)
        sorted_a = scatter_rows(attrs, rk, cg, plain=plain)
    else:
        order = torch.argsort(key, dim=1, stable=True)
        skey = torch.gather(key, 1, order)
        sorted_a = gather_rows(attrs, order, plain=plain)

    qz_lo = _floor_i32((gmin[..., 2] - sc.cell) / zfine)
    qz_hi = _floor_i32(gmax[..., 2] / zfine)
    q_lo, q_hi = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            q_lo.append(_pack_xyz(qx + dx, qy + dy, qz_lo))
            q_hi.append(_pack_xyz(qx + dx, qy + dy, qz_hi))
    # #keys < q and #keys <= q: binary searches over the sorted keys
    lo9 = torch.searchsorted(skey, torch.stack(q_lo, -1).reshape(w, -1)
                             ).reshape(w, cg, 9)
    hi9 = torch.searchsorted(skey, torch.stack(q_hi, -1).reshape(w, -1),
                             right=True).reshape(w, cg, 9)
    cnt9 = hi9 - lo9
    pfx9 = torch.cumsum(cnt9, dim=-1)
    pfx_ex = pfx9 - cnt9
    total = pfx9[..., -1]

    # ---- stage 1: walk the 9 ranges into a raw window of s_walk slots;
    # slot m lies in range r with pfx_ex[r] <= m < pfx9[r] ----
    s_walk = sc.s_walk
    m = torch.arange(s_walk, device=dev).expand(w, cg, s_walk).contiguous()
    r = torch.clamp(torch.searchsorted(pfx9.contiguous(), m, right=True),
                    max=8)
    pos = torch.gather(lo9, 2, r) + m - torch.gather(pfx_ex, 2, r)
    in_window = m < torch.clamp(total, max=s_walk)[..., None]
    pos = torch.clamp(torch.where(in_window, pos, torch.zeros_like(pos)),
                      0, max(cg - 1, 0))

    slot_a = gather_rows(sorted_a, pos.reshape(w, -1), plain=plain).reshape(
        w, cg, s_walk, na)
    jr_w = slot_a[..., 0].to(torch.int32)
    kind_w = slot_a[..., 1].to(torch.int32)
    body_w = slot_a[..., 2].to(torch.int32)
    dyn_w = slot_a[..., 3] > 0.5
    jmin_w, jmax_w = slot_a[..., 4:7], slot_a[..., 7:10]

    gidx = gsel[None, :, None]
    i_body_g = const(st["i_body_g"], dev)[None, :, None]
    i_dyn_g = const(st["i_dyn_g"], dev)[None, :, None]
    imin = gaabb[..., None, :3]
    imax = gaabb[..., None, 3:]
    valid_w = (in_window & (jr_w != gidx) & (body_w != i_body_g)
               & (i_dyn_g | dyn_w)
               & torch.all((imin <= jmax_w) & (imax >= jmin_w), dim=-1))
    if two_tier:
        jtmin_w, jtmax_w = slot_a[..., 10:13], slot_a[..., 13:16]
        tight_w = valid_w & torch.all(
            (gtaabb[..., None, :3] <= jtmax_w)
            & (gtaabb[..., None, 3:] >= jtmin_w), dim=-1)
    elif tight_delta is not None:
        d2 = 2.0 * tight_delta
        tight_w = valid_w & torch.all((imin <= jmax_w - d2)
                                      & (imax >= jmin_w + d2), dim=-1)
    else:
        tight_w = valid_w

    # manifold class of each walked slot: row per scanning collider,
    # column by the partner's kind
    row_tab = const(st["row_tab"], dev)                         # [Cg,9]
    cls_w = torch.gather(row_tab[None].expand(w, cg, 9), 2,
                         kind_w.long().clamp(0, 8)).to(torch.int32)

    out = []
    for c in range(3):
        if sc.nslot(c) == 0:
            out.append(None)
            continue
        in_c = cls_w == c
        tight_c = tight_w & in_c
        packed, n_valid = compact_slots(valid_w & in_c, tight_c,
                                        [jr_w, kind_w, body_w],
                                        sc.s_class[c])
        out.append((packed, n_valid, tight_c.sum(dim=2)))
    return out, aabb6, total


def slab_candidates(sc: SlabConfig, col_body, dyn_col, amin, amax,
                    tight_delta=None, amin_tight=None, amax_tight=None,
                    rank="sort", return_demand=False) -> List[SlabCandidates]:
    """Hash-grid walk into the static slot layout, one SlabCandidates per
    manifold class. amin/amax [W,C,3] fat AABBs. The tight tier, whose
    pairs pack first, is amin_tight/amax_tight where given (temporal
    reuse: the current step's AABBs beside the period-fattened ones), else
    the fat AABBs shrunk by tight_delta (their surplus over the
    rapier-equivalent ones). rank: "sort" or "count" (class_windows).
    return_demand: also return {"walk_total": [W,Cg], "class_valid": 3 x
    [W,Cg], "class_tight": 3 x [W,Cg]}, the counts the windows had to hold
    (zeros for an absent class)."""
    windows, aabb6, total = class_windows(
        sc, col_body, dyn_col, amin, amax, tight_delta, amin_tight,
        amax_tight, rank)
    st = _statics(sc, np.asarray(col_body), np.asarray(dyn_col))
    dev = amin.device
    w = amin.shape[0]
    cg = int(sc.grid_cols.size)
    nbig = int(sc.big_cols.size)

    if nbig:
        gaabb = aabb6[:, const(st["gidx"], dev)]
        imin, imax = gaabb[..., None, :3], gaabb[..., None, 3:]
        i_body_g = const(st["i_body_g"], dev)[None, :, None]
        i_dyn_g = const(st["i_dyn_g"], dev)[None, :, None]
        bidx = const(st["big_cols"], dev)
        jr_b = bidx.to(torch.int32)[None, None].expand(w, cg, nbig)
        body_b = const(st["body_big"], dev)[None, None].expand(w, cg, nbig)
        bmin = aabb6[:, bidx, :3][:, None]
        bmax = aabb6[:, bidx, 3:][:, None]
        bvalid = ((body_b != i_body_g)
                  & (i_dyn_g | const(st["dyn_big"], dev)[None, None])
                  & torch.all((imin <= bmax) & (imax >= bmin), dim=-1))

    out = []
    demand = {"walk_total": total, "class_valid": [], "class_tight": []}
    for c in range(3):
        nslot_c = sc.nslot(c)
        if nslot_c == 0:
            z = torch.zeros((w, 0), dtype=torch.int32, device=dev)
            zb = torch.zeros((w, 0), dtype=torch.bool, device=dev)
            out.append(SlabCandidates(z, z, zb, zb, z))
            for k in ("class_valid", "class_tight"):
                demand[k].append(torch.zeros_like(total))
            continue
        s_c = sc.s_class[c]
        (j_real, kind_j, body_j), n_valid, n_tight = windows[c]
        demand["class_valid"].append(n_valid)
        demand["class_tight"].append(n_tight)
        k_ar = torch.arange(s_c, device=dev)
        cvalid = k_ar[None, None, :] < n_valid[..., None]
        if nbig:
            big_ok = bvalid & (const(st["cls_big"], dev)[None] == c)
            j_real = torch.cat([j_real, jr_b], dim=2)
            kind_j = torch.cat([kind_j, const(st["kind_big"], dev)[
                None, None].expand(w, cg, nbig)], dim=2)
            body_j = torch.cat([body_j, body_b], dim=2)
            cvalid = torch.cat([cvalid, big_ok], dim=2)
        k_slots = cg * nslot_c
        j_real = j_real.reshape(w, k_slots)
        kind_j = kind_j.reshape(w, k_slots)
        body_j = body_j.reshape(w, k_slots)
        valid = cvalid.reshape(w, k_slots)
        i_static = const(st[f"i_static{c}"], dev)[None]
        kind_i = const(st[f"kind_i{c}"], dev)[None]
        swap = (kind_i > kind_j) | ((kind_i == kind_j) & (i_static > j_real))
        pid = torch.where(valid, i_static * sc.num_colliders + j_real,
                          torch.full_like(j_real, -1))
        out.append(SlabCandidates(j_real=j_real, body_j=body_j, valid=valid,
                                  swap=swap, pid=pid))
    if return_demand:
        return out, demand
    return out


# --------------------------------------------------------------------------
# grid broadphase: hash-grid walk + global per-class stream compaction
# (fyrox_tpu/physics/broadphase.py:93-330)
# --------------------------------------------------------------------------

@dataclass
class GridConfig:
    """Host-side static layout of the grid broadphase (hangs off
    PhysicsTemplate.grid): every grid collider walks a window of `window`
    candidate slots, plus one slot per big collider; the survivors of each
    manifold class compact into `caps[c]` directed pairs a world."""
    grid_cols: np.ndarray          # [Cg] collider indices in the grid
    big_cols: np.ndarray           # [Nbig] oversized / unbounded colliders
    cell: float                    # grid cell size
    window: int                    # S: neighbour candidate slots a collider
    caps: Tuple[int, int, int]     # compaction width per manifold class
    windows_body: Tuple[int, int, int]   # Mw: max pairs a body per class
    cls_tab: np.ndarray            # [9,9] manifold class per kind pair
    slot_i: np.ndarray = None      # [Cg*(S+Nbig)] scanning collider a slot
    _kinds: np.ndarray = None      # [C] effective kind
    _kind_i: np.ndarray = None     # [Cg*(S+Nbig)]
    _num_colliders: int = 0

    @property
    def n_slots(self):
        return int(self.slot_i.shape[0])


def build_grid_config(col_shape, col_params, col_body, body_type,
                      margin, window=48, caps=None, windows_body=None,
                      big_factor=8.0):
    """Cell size, big colliders and the static slot map; None where no
    collider is grid-eligible. Halfspaces, hulls and scenery are big (and
    must be static): the grid step runs no hull routine."""
    nc = int(col_shape.shape[0])
    if nc == 0:
        return None
    bound = np.zeros(nc, np.float64)
    for i in range(nc):
        t = int(col_shape[i])
        p = np.asarray(col_params[i], np.float64)
        if t == sh.BALL:
            bound[i] = p[0]
        elif t == sh.CUBOID:
            bound[i] = float(np.linalg.norm(p[:3]))
        elif t in (sh.CAPSULE, sh.CYLINDER, sh.CONE):
            bound[i] = p[0] + p[1]
        else:                       # halfspace, hulls and scenery
            bound[i] = np.inf
    finite = np.isfinite(bound)
    med = np.median(bound[finite]) if finite.any() else 1.0
    big = ~finite | (bound > big_factor * max(med, 1e-6))
    dyn = body_type[col_body] == 0
    if np.any(big & dyn):
        raise ValueError("dynamic colliders cannot be broadphase-big "
                         "(unbounded or oversized shapes must be static)")
    grid_cols = np.flatnonzero(~big).astype(np.int32)
    big_cols = np.flatnonzero(big).astype(np.int32)
    if grid_cols.size == 0:
        return None
    cell = float(2.0 * bound[grid_cols].max() + 2.0 * margin)
    cls_tab = pair_class_table()
    kinds = np.asarray([_eff_kind(int(k)) for k in col_shape], np.int32)
    present = np.zeros(3, bool)
    for ka in np.unique(kinds[grid_cols]):
        for kb in np.unique(kinds):
            present[cls_tab[ka, kb]] = True
    if caps is None:
        # ~12 directed grid partners a collider plus the big-pair slots,
        # split across the classes that can occur
        cg = int(grid_cols.size)
        base = 12 * cg + 4 * cg * big_cols.size
        npresent = max(int(present.sum()), 1)
        caps = tuple(-(-base // npresent) if present[c] else 0
                     for c in range(3))
    else:
        caps = tuple(int(c) if present[k] else 0 for k, c in enumerate(caps))
    if windows_body is None:
        windows_body = (48, 16, 32)
    nslot = window + big_cols.size
    slot_i = np.repeat(grid_cols, nslot)
    return GridConfig(grid_cols=grid_cols, big_cols=big_cols, cell=cell,
                      window=int(window), caps=tuple(int(c) for c in caps),
                      windows_body=tuple(int(m) for m in windows_body),
                      cls_tab=cls_tab, slot_i=slot_i, _kinds=kinds,
                      _kind_i=kinds[slot_i], _num_colliders=nc)


class CandidateSet(NamedTuple):
    """One manifold class's compacted directed pair list [W,P]."""
    ia: torch.Tensor       # scanning collider (ascending within a row)
    ib: torch.Tensor       # partner collider
    valid: torch.Tensor    # bool
    pid: torch.Tensor      # int32 ia*C+ib (warm-start identity), -1 invalid


def _grid_statics(gb: GridConfig, col_body, dyn_col):
    """Per-config host tables, cached on the config."""
    st = getattr(gb, "_torch_statics", None)
    if st is None:
        i_static = gb.slot_i.astype(np.int64)
        st = dict(
            cell=np.float32(gb.cell), zfine=np.float32(gb.cell / _ZFINE),
            gcols=gb.grid_cols.astype(np.int64),
            i_static=i_static, i_static32=gb.slot_i.astype(np.int32),
            body_i=col_body[i_static].astype(np.int32),
            dyn_i=dyn_col[i_static].astype(bool),
            col_body=col_body.astype(np.int32),
            dyn_col=dyn_col.astype(bool),
            big_cols=gb.big_cols.astype(np.int64),
            kind_i=gb._kind_i.astype(np.int64),
            kinds=gb._kinds.astype(np.int64),
            cls_tab=gb.cls_tab.astype(np.int32),
            m=np.arange(gb.window, dtype=np.int64))
        st["targets"] = [np.arange(1, cap + 1, dtype=np.int64)
                         for cap in gb.caps]
        gb._torch_statics = st
    return st


def grid_candidates(gb: GridConfig, col_body, dyn_col, amin, amax,
                    return_demand=False) -> List[CandidateSet]:
    """Directed candidate pairs per manifold class.

    col_body [C] and dyn_col [C] are host arrays; amin / amax [W,C,3] fat
    world AABBs. Returns one CandidateSet per class (a cap of zero gives
    an empty set); with return_demand also the walk's demand [W,Cg] (the
    candidates in each collider's nine ranges, of which `window` fit)."""
    col_body = np.asarray(col_body)
    dyn_col = np.asarray(dyn_col)
    st = _grid_statics(gb, col_body, dyn_col)
    dev = amin.device
    w = amin.shape[0]
    cg = int(gb.grid_cols.size)
    s_grid = gb.window
    nbig = int(gb.big_cols.size)
    gcols = const(st["gcols"], dev)
    cell = const(st["cell"], dev)
    zfine = const(st["zfine"], dev)

    gmin = amin[:, gcols]
    gmax = amax[:, gcols]
    qx = _floor_i32(gmin[..., 0] / cell)                        # [W,Cg]
    qy = _floor_i32(gmin[..., 1] / cell)
    qz = _floor_i32(gmin[..., 2] / zfine)
    key = _pack_xyz(qx, qy, qz)
    order = torch.argsort(key, dim=1, stable=True)
    skey = torch.gather(key, 1, order)

    # nine (dx, dy) column ranges over the exact z-interval: a z-overlapping
    # partner j is registered at min_j in [min_i - cell, max_i]
    qz_lo = _floor_i32((gmin[..., 2] - gb.cell) / zfine)
    qz_hi = _floor_i32(gmax[..., 2] / zfine)
    q_lo, q_hi = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            q_lo.append(_pack_xyz(qx + dx, qy + dy, qz_lo))
            q_hi.append(_pack_xyz(qx + dx, qy + dy, qz_hi))
    lo9 = torch.searchsorted(skey, torch.stack(q_lo, -1).reshape(w, -1)
                             ).reshape(w, cg, 9)
    hi9 = torch.searchsorted(skey, torch.stack(q_hi, -1).reshape(w, -1),
                             right=True).reshape(w, cg, 9)
    cnt9 = hi9 - lo9
    pfx9 = torch.cumsum(cnt9, dim=-1)            # inclusive prefix
    pfx_ex = pfx9 - cnt9
    total = pfx9[..., -1]                        # [W,Cg]

    # the window walk: slot m lies in the range r with pfx_ex[r] <= m <
    # pfx9[r], the first r whose inclusive prefix passes m (a search over
    # the 9 prefixes in place of the JAX package's [W,Cg,S,9] mask: the
    # same integers); slots past the demand read position 0
    m = const(st["m"], dev).expand(w, cg, s_grid).contiguous()
    r = torch.clamp(torch.searchsorted(pfx9.contiguous(), m, right=True),
                    max=8)
    pos = torch.gather(lo9, 2, r) + m - torch.gather(pfx_ex, 2, r)
    in_window = m < torch.clamp(total, max=s_grid)[..., None]
    pos = torch.clamp(torch.where(in_window, pos, torch.zeros_like(pos)),
                      0, max(cg - 1, 0))
    jg = torch.gather(order, 1, pos.reshape(w, -1))
    j = gcols[jg].reshape(w, cg, s_grid)                        # collider
    if nbig:
        jbig = const(st["big_cols"], dev)[None, None].expand(w, cg, nbig)
        j = torch.cat([j, jbig], dim=2)
        in_window = torch.cat([in_window, torch.ones(
            (w, cg, nbig), dtype=torch.bool, device=dev)], dim=2)
    jf = j.reshape(w, -1)                                       # [W,slots]

    i_static = const(st["i_static"], dev)
    body_j = const(st["col_body"], dev)[jf]
    dyn_j = const(st["dyn_col"], dev)[jf]
    valid = (in_window.reshape(w, -1) & (jf != i_static[None])
             & (body_j != const(st["body_i"], dev)[None])
             & (const(st["dyn_i"], dev)[None] | dyn_j))
    # fat-AABB overlap (i side static-indexed, j side gathered)
    amin_i, amax_i = amin[:, i_static], amax[:, i_static]
    rows = torch.arange(w, device=dev)[:, None]
    amin_j, amax_j = amin[rows, jf], amax[rows, jf]
    valid = valid & torch.all((amin_i <= amax_j) & (amax_i >= amin_j), -1)
    sets = _compact_classes(gb, st, jf, valid, w)
    if return_demand:
        return sets, total
    return sets


def _compact_classes(gb: GridConfig, st, jf, valid, w):
    """Split the candidate slots by manifold class and stream-compact each
    into its cap: the first `cap` valid slots in slot order; the rest
    drop."""
    dev = jf.device
    kind_j = const(st["kinds"], dev)[jf]                        # [W,slots]
    cls = const(st["cls_tab"], dev)[const(st["kind_i"], dev)[None], kind_j]
    i_static = const(st["i_static32"], dev)
    c_total = int(gb._num_colliders)
    n_slots = jf.shape[1]
    out = []
    for c, cap in enumerate(gb.caps):
        if cap <= 0:
            z = torch.zeros((w, 0), dtype=torch.int32, device=dev)
            out.append(CandidateSet(z, z, torch.zeros(
                (w, 0), dtype=torch.bool, device=dev), z))
            continue
        mask = valid & (cls == c)
        csum = torch.cumsum(mask.to(torch.int32), dim=1)        # [W,slots]
        targets = const(st["targets"][c], dev)[None].expand(w, cap)
        pos = torch.searchsorted(csum, targets.contiguous())
        sel_valid = targets <= csum[:, -1:]
        pos = torch.clamp(pos, 0, n_slots - 1)
        ia = i_static[pos]                                       # [W,cap]
        ib = torch.gather(jf, 1, pos).to(torch.int32)
        pid = torch.where(sel_valid, ia * c_total + ib,
                          torch.full_like(ia, -1))
        out.append(CandidateSet(ia=ia, ib=ib, valid=sel_valid, pid=pid))
    return out


def broadphase_stats(t, state):
    """Diagnostic: per-class candidate demand of the CURRENT state of a
    grid template (fyrox_tpu's broadphase_stats): per manifold class the
    pairs needed (max over worlds) against the configured cap, and the
    most pairs a body holds against windows_body. Overflow drops contacts
    without a word; size the caps and windows from this."""
    from fyrox_tpu_torch.physics import world as wm
    gb = t.grid
    dev = state.position.device
    cpos, crot = wm._collider_world(state, t)
    ctype = const(t.col_shape, dev)
    cparams = const(t.col_params, dev)
    margin = t.allowed_linear_error + 0.05
    he = sh.shape_aabb_half_extents(ctype[None], cparams[None], crot) + margin
    amin, amax = cpos - he, cpos + he
    col_body = np.asarray(t.col_body)
    dyn_col = np.asarray(t.body_type)[col_body] == 0
    sets = grid_candidates(gb, col_body, dyn_col, amin, amax)
    out = {}
    b = int(np.asarray(t.body_type).shape[0])
    for cls, cs in enumerate(sets):
        if cs.ia.shape[1] == 0:
            out[cls] = dict(needed=0, cap=gb.caps[cls])
            continue
        v = cs.valid.cpu().numpy()
        bs = col_body[cs.ia.cpu().numpy()]
        per_body = np.zeros((v.shape[0], b), np.int64)
        for wi in range(v.shape[0]):
            np.add.at(per_body[wi], bs[wi][v[wi]], 1)
        out[cls] = dict(needed=int(v.sum(axis=1).max()), cap=gb.caps[cls],
                        max_pairs_per_body=int(per_body.max()),
                        window_body=gb.windows_body[cls])
    return out
