"""Fused route of the slab physics step: the ports of the JAX package's
fused Pallas programs, K3 ``fyrox_tpu/physics/pallas_step.py:794
fused_full_step_pallas`` and K2 ``:641 fused_step_pallas``.

The JAX package runs pose → AABB → broadphase → narrowphase → compaction
→ TGS solve as one resident program per world (K3; K2 leaves the
broadphase outside). On Hopper the program is cut where the JAX split mode
cuts it, for reasons of its own: one world's contact planes (~1 MB) do not
fit the 227 KB of shared memory a block may use, the narrowphase wants
tiles of consecutive grid colliders (whole 128-byte rows of contact planes
per store), and the solve a CTA per world with the bodies in shared memory
(K1). So a step is

    K3: fused_bp (csrc/fused_bp.cu) → narrow_compact (csrc/narrow_compact.cu)
        → solve_tgs (K1, csrc/tgs_solve.cu): three launches;
    K2: PyTorch pose, AABBs and slab broadphase (or, under temporal
        broadphase reuse, its cached windows) → narrow_compact → solve_tgs.

The window planes never reach device memory. A CPU tensor takes each
kernel's plain version (``bp_candidates_plain``, ``narrow_compact_plain``:
the staged path's own stages, re-packed); a CUDA tensor takes the kernel,
or raises. Layouts, per world:

    body     [W,29,B]    f32  the K1 body planes (tgs_kernel)
    col      [W,10,C]    f32  collider position 3, rotation 4, sweep v·dt 3
    jv       [W,NS,Cg]   i32  candidate windows, -1 invalid: the rows of
                              class c start at row0_c, s_class[c] walked
                              partners (tight tier first), then nbig static
                              big-partner rows
    warm_lam [W,3,S,Cg]  f32  last step's impulses; warm_pid [W,S,Cg] i32
    con      [W,15,S,Cg] f32  K1's contact planes, λ₀ warm-matched
    body_j, pid [W,S,Cg] i32
"""
from __future__ import annotations

import numpy as np
import torch

from fyrox_tpu_torch._util import const
from fyrox_tpu_torch.physics import broadphase as bp_mod
from fyrox_tpu_torch.physics import shapes as sh
from fyrox_tpu_torch.physics import slab2, tgs_kernel
from fyrox_tpu_torch.physics.planes import q_to_rot9, scale3

__all__ = ["supports_fused", "supports_fused_bp", "collider_planes",
           "bp_candidates", "bp_candidates_plain", "narrow_compact",
           "narrow_compact_plain", "fused_step", "fused_full_step",
           "bp_smem_bytes", "nc_smem_bytes", "launches", "reset_launches"]

_LAUNCHES = {"fused_bp": 0, "narrow_compact": 0}
_NC_TILES = (32, 16, 8, 4, 2, 1)   # narrow_compact: grid colliders a block
                                   # takes, widest first (see _nc_tile)
_MAX_WALK = 64        # fused_bp keeps a walk window's flags in 64-bit masks
_MAX_ROWS = 256       # narrow_compact packs window flags in 8 × 32 bits
_BP_PARTS = 0         # fused_bp blocks per world; 0: as many as fill the
                      # card's resident blocks, 64+ grid colliders each


def launches(name: str) -> int:
    """Kernel launches of `name` ("fused_bp" or "narrow_compact")."""
    return _LAUNCHES[name]


def reset_launches():
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# scope
# --------------------------------------------------------------------------

def supports_fused(t) -> bool:
    """K2 scope (pallas_step.supports_fused): no joints, no centre-of-mass
    offsets and at least one window class. Jointed and COM templates take
    the staged route, whose K1 call carries the joint tables; hulls and
    scenery raise in slab2._ctx before a route is chosen."""
    joints = getattr(t, "joints", None)
    return (not np.any(np.asarray(t.com_local))
            and (joints is None or joints.num_joints == 0)
            and any(t.grid.nslot(c) for c in range(3)))


def supports_fused_bp(t) -> bool:
    """K3 scope (pallas_step.supports_fused_bp): K2 scope, period-1
    rebuilds, and every broadphase-big collider a halfspace, so that its
    partner rows are static."""
    if not supports_fused(t):
        return False
    if int(getattr(t, "broadphase_period", 1) or 1) > 1:
        return False
    big = t.grid.big_cols
    return big.size == 0 or bool(
        np.all(np.asarray(t.col_shape)[big] == sh.HALFSPACE))


# --------------------------------------------------------------------------
# static tables (host numpy, built once per template; device copies by
# _util.const). Index vectors, not the TPU's one-hot incidences.
# --------------------------------------------------------------------------

class _Statics:
    def __init__(self, t):
        cx = slab2._ctx(t)
        sc = t.grid
        self.cx = cx
        layout, row0 = [], 0
        for cls in range(3):
            ns = sc.nslot(cls)
            if ns:
                layout.append((cls, ns, row0))
                row0 += ns
        self.class_layout = tuple(layout)
        self.ns = row0
        self.nslots = tuple(sc.nslot(c) for c in range(3))
        self.wd = sum(n * bp_mod.CLASS_NPTS[c]
                      for c, n in enumerate(self.nslots))
        self.nbig = int(sc.big_cols.size)
        self.col_body = cx.col_body.astype(np.int32)              # [C]
        self.kinds = cx.kinds.astype(np.int32)                    # [C]
        self.shape = cx.shape.astype(np.int32)                    # [C]
        self.dyn = cx.dyn_col.astype(np.int32)                    # [C]
        self.grid_cols = cx.grid_cols.astype(np.int32)            # [Cg]
        self.sweep_cap = np.asarray(sc.sweep_cap, np.float32)     # [C]
        self.cls_tab = np.ascontiguousarray(sc.cls_tab, np.int32)  # [9,9]
        # params6, friction, restitution [8,C]; offset pos3, rot4 [7,C]
        self.col_sta = np.ascontiguousarray(np.concatenate(
            [cx.params.T, cx.fric[None], cx.rest[None]], 0), np.float32)
        self.col_off = np.ascontiguousarray(np.concatenate(
            [cx.col_pos.T, cx.col_rot.T], 0), np.float32)
        # static big-partner rows (slab2._build_fused_bp_statics): valid
        # wherever bodies differ, one side is dynamic and the class fits;
        # a halfspace's AABB test is conservative, and the pairs it would
        # reject give inactive manifolds that compact away
        gi = cx.grid_cols
        kind_i = sc.kinds[gi]
        rows = []
        for cls, _ns, _r0 in layout:
            for bidx in sc.big_cols:
                ok = ((cx.col_body[bidx] != cx.col_body[gi])
                      & (cx.dyn_col[gi] | bool(cx.dyn_col[bidx]))
                      & (sc.cls_tab[kind_i, int(sc.kinds[bidx])] == cls))
                rows.append(np.where(ok, int(bidx), -1).astype(np.int32))
        self.jv_big = (np.stack(rows) if rows
                       else np.full((1, cx.cg), -1, np.int32))   # [NSB,Cg]
        # fused_bp's per-collider grid index (-1: big) and per-grid-index
        # static words: collider; body << 5 | kind (0-8) << 1 | dynamic
        self.col_grid = np.full(cx.c, -1, np.int32)
        self.col_grid[gi] = np.arange(cx.cg, dtype=np.int32)
        self.grid_stat = np.stack([
            gi, cx.col_body[gi].astype(np.int64) << 5
            | np.clip(cx.kinds[gi], 0, 8).astype(np.int64) << 1
            | cx.dyn_col[gi].astype(np.int64)]).astype(np.int32)  # [2,Cg]


def _statics(t) -> _Statics:
    if getattr(t, "_torch_fused_statics", None) is None:
        t._torch_fused_statics = _Statics(t)
    return t._torch_fused_statics


def _tight_delta() -> float:
    from fyrox_tpu_torch.physics.world import (PREDICTION_DISTANCE,
                                               SPECULATIVE_MARGIN)
    return SPECULATIVE_MARGIN - PREDICTION_DISTANCE


def bp_smem_bytes(n_grid_colliders: int, cand_rows: int) -> int:
    """The least shared memory one fused_bp block needs: the sort's (key,
    index) words and the AABBs of every grid collider, cls_tab, a row map,
    and a window tile one collider wide. The kernel adds the static word
    table (8 B a grid collider) and a wider tile where they fit."""
    return 32 * n_grid_colliders + 4 * (81 + cand_rows) + 8 * cand_rows


def nc_smem_bytes(window_rows: int, cand_rows: int, slots: int,
                  tile: int) -> int:
    """Shared memory of one narrow_compact block of `tile` grid colliders:
    their 18 collider words and 2 ints, per candidate row the partner, the
    pair's 7 words and a work-list entry, per window row its 5 point words
    (on tile + 1 columns) and its pair, per slot the kept row, the kept
    count, the work list's pads (16 buckets, each starting a warp) and the
    33 bucket counters (csrc/narrow_compact.cu)."""
    words = (tile * (20 + 9 * cand_rows + slots + 1)
             + 5 * window_rows * (tile + 1) + window_rows + 16 * 31 + 33)
    return 4 * words


def _nc_tile(window_rows: int, cand_rows: int, slots: int) -> int:
    """narrow_compact's tile: the widest of _NC_TILES whose block fits the
    shared memory a block may use (32 at the flagship and its reuse
    windows; 0 if none does)."""
    return next((tg for tg in _NC_TILES if nc_smem_bytes(
        window_rows, cand_rows, slots, tg) <= tgs_kernel.SMEM_LIMIT), 0)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _split(col):
    return (tuple(col[:, i] for i in range(3)),
            tuple(col[:, i] for i in range(3, 7)),
            tuple(col[:, i] for i in range(7, 10)))


def collider_planes(t, body, dt):
    """Body planes [W,29,B] → collider planes [W,10,C]: world position,
    rotation and sweep v·dt of every collider (slab2's pose stage)."""
    cx = slab2._ctx(t)
    cpos, cq, lv_c = slab2._collider_pose_planes(
        cx, tuple(body[:, 6 + i] for i in range(3)),
        tuple(body[:, 9 + i] for i in range(4)),
        tuple(body[:, i] for i in range(3)))
    return torch.stack(list(cpos) + list(cq) + list(scale3(lv_c, dt)), 1)


def _aabbs(t, col):
    cpos, cq, vs = _split(col)
    amin, amax = slab2._aabb_planes(slab2._ctx(t), t, cpos, q_to_rot9(cq),
                                    vs, slab2._margin(t))
    return torch.stack(amin, -1), torch.stack(amax, -1)


def bp_candidates_plain(t, body, dt):
    """Pose, swept fat AABBs and the slab walk in PyTorch, packed as the
    K3 kernel packs them: (jv [W,NS,Cg] int32, col [W,10,C])."""
    fs = _statics(t)
    cx = fs.cx
    col = collider_planes(t, body, dt)
    amin, amax = _aabbs(t, col)
    windows, _, _ = bp_mod.class_windows(t.grid, cx.col_body, cx.dyn_col,
                                         amin, amax, _tight_delta(),
                                         plain=True)
    dev, w = body.device, body.shape[0]
    jv_big = const(fs.jv_big, dev)
    rows = []
    big_row = 0
    for cls, nslot, _r0 in fs.class_layout:
        (j_real, _kind, _body), n_valid, _ = windows[cls]
        k = torch.arange(nslot - fs.nbig, device=dev)
        rows.append(torch.where(k < n_valid[..., None], j_real,
                                -1).transpose(1, 2))
        rows.append(jv_big[big_row:big_row + fs.nbig][None].expand(
            w, -1, -1))
        big_row += fs.nbig
    return torch.cat(rows, 1).to(torch.int32).contiguous(), col


def _jv_from_candidates(fs, cands):
    """Staged broadphase candidates → jv [W,NS,Cg] (slab2.py:1600-1612)."""
    rows = []
    for cls, nslot, _r0 in fs.class_layout:
        cand = cands[cls]
        w = cand.j_real.shape[0]
        jr = torch.where(cand.valid, cand.j_real, -1)
        rows.append(jr.reshape(w, fs.cx.cg, nslot).transpose(1, 2))
    return torch.cat(rows, 1).to(torch.int32).contiguous()


def narrow_compact_plain(t, col, jv, warm_lam, warm_pid):
    """Narrowphase of every window row, two-tier compaction to S slots and
    warm pid matching in PyTorch (slab2's staged stages on candidates
    rebuilt from jv, as the kernel rebuilds them from static tables).
    Returns (con [W,15,S,Cg], body_j [W,S,Cg], pid [W,S,Cg])."""
    fs = _statics(t)
    cx = fs.cx
    sc = t.grid
    dev, w = jv.device, jv.shape[0]
    st = bp_mod._statics(sc, cx.col_body, cx.dyn_col)
    kinds = const(fs.kinds, dev)
    col_body = const(fs.col_body, dev)
    cands = []
    for cls in range(3):
        nslot = fs.nslots[cls]
        if nslot == 0:
            z = torch.zeros((w, 0), dtype=torch.int32, device=dev)
            zb = torch.zeros((w, 0), dtype=torch.bool, device=dev)
            cands.append(bp_mod.SlabCandidates(z, z, zb, zb, z))
            continue
        row0 = next(r for c, _n, r in fs.class_layout if c == cls)
        jr = jv[:, row0:row0 + nslot].transpose(1, 2).reshape(
            w, cx.cg * nslot)
        valid = jr >= 0
        j_real = torch.clamp(jr, min=0)
        jl = j_real.long()
        i_static = const(st[f"i_static{cls}"], dev)[None]
        kind_i = const(st[f"kind_i{cls}"], dev)[None]
        kind_j = kinds[jl]
        swap = (kind_i > kind_j) | ((kind_i == kind_j) & (i_static > j_real))
        pid = torch.where(valid, i_static * cx.c + j_real, -1)
        cands.append(bp_mod.SlabCandidates(j_real=j_real, body_j=col_body[jl],
                                           valid=valid, swap=swap, pid=pid))
    cpos, cq, vs = _split(col)
    attrs_f, attrs_i = slab2._narrowphase_windows(cx, t, cands, cpos, cq, vs,
                                                  slab2._margin(t), plain=True)
    con = slab2._compact(cx, attrs_f, attrs_i)
    same = (slab2.from_sc(cx, warm_pid) == con.pid).to(torch.float32) \
        * con.act
    lam0 = tuple(slab2.from_sc(cx, warm_lam[:, i]) * same for i in range(3))
    con_planes, body_j = slab2.pack_contacts(cx, con, lam0)
    return con_planes, body_j, slab2.to_sc(cx, con.pid).contiguous()


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _need(cond, exc, msg):
    if not cond:
        raise exc(msg)


def _check_tensor(fn, name, x, dtype, shape, device):
    """Raise unless x is on `device` (the dispatching tensor's card) with
    the dtype, shape and contiguous layout the kernel takes."""
    _need(x.device == device, ValueError, f"{fn}: {name} must be on {device}")
    _need(x.dtype == dtype, TypeError,
          f"{fn}: {name} must be {dtype}, got {x.dtype}")
    _need(tuple(x.shape) == tuple(shape), ValueError,
          f"{fn}: {name} has shape {tuple(x.shape)}, want {tuple(shape)}")
    _need(x.is_contiguous(), ValueError, f"{fn}: {name} must be contiguous")


def _bp_candidates_cuda(t, body, dt):
    from fyrox_tpu_torch import kernels
    fs = _statics(t)
    cx = fs.cx
    sc = t.grid
    dev = body.device
    w = body.shape[0] if body.dim() == 3 else -1
    _check_tensor("bp_candidates", "body", body, torch.float32,
                  (w, tgs_kernel.BODY_ROWS, cx.b), dev)
    need = bp_smem_bytes(cx.cg, fs.ns)
    _need(need <= tgs_kernel.SMEM_LIMIT, ValueError,
          f"bp_candidates: {cx.cg} grid colliders need {need} B of shared "
          f"memory per world, above the {tgs_kernel.SMEM_LIMIT} B a block "
          "may use")
    _need(sc.s_walk <= _MAX_WALK, ValueError,
          f"bp_candidates: walk window {sc.s_walk} above {_MAX_WALK}")
    jv = torch.empty((w, fs.ns, cx.cg), dtype=torch.int32, device=dev)
    col = torch.empty((w, 10, cx.c), dtype=torch.float32, device=dev)
    if w == 0:
        return jv, col
    ptrs = [const(a, dev).data_ptr() for a in (
        fs.col_body, fs.shape, fs.col_sta, fs.col_off, fs.sweep_cap,
        fs.col_grid, fs.grid_stat, fs.cls_tab, fs.jv_big)]
    f32 = np.float32
    lib = kernels.library()
    err = lib.fyrox_fused_bp(
        body.data_ptr(), *ptrs, jv.data_ptr(), col.data_ptr(),
        w, cx.b, cx.c, cx.cg, int(sc.s_walk), *fs.nslots, fs.nbig,
        int(cx.trivial_offsets), _BP_PARTS, tgs_kernel.SMEM_LIMIT,
        float(f32(dt)), float(f32(slab2._margin(t))), float(f32(sc.cell)),
        float(f32(sc.cell / bp_mod._ZFINE)),
        float(f32(2.0 * _tight_delta())),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "fyrox_fused_bp")
    _LAUNCHES["fused_bp"] += 1
    return jv, col


def _narrow_compact_cuda(t, col, jv, warm_lam, warm_pid):
    from fyrox_tpu_torch import kernels
    from fyrox_tpu_torch.physics.world import PREDICTION_DISTANCE
    fs = _statics(t)
    cx = fs.cx
    dev = col.device
    w = col.shape[0] if col.dim() == 3 else -1
    s, cg = cx.s_active, cx.cg
    fn = "narrow_compact"
    _check_tensor(fn, "col", col, torch.float32, (w, 10, cx.c), dev)
    _check_tensor(fn, "jv", jv, torch.int32, (w, fs.ns, cg), dev)
    _check_tensor(fn, "warm_lam", warm_lam, torch.float32, (w, 3, s, cg), dev)
    _check_tensor(fn, "warm_pid", warm_pid, torch.int32, (w, s, cg), dev)
    _need(fs.wd <= _MAX_ROWS, ValueError,
          f"narrow_compact: {fs.wd} window rows per collider, above the "
          f"kernel's {_MAX_ROWS}")
    tile = _nc_tile(fs.wd, fs.ns, s)
    _need(tile > 0, ValueError,
          f"narrow_compact: {fs.wd} window rows and {s} slots need "
          f"{nc_smem_bytes(fs.wd, fs.ns, s, 1)} B of shared memory per "
          "block")
    con = torch.empty((w, tgs_kernel.CON_ROWS, s, cg), dtype=torch.float32,
                      device=dev)
    body_j = torch.empty((w, s, cg), dtype=torch.int32, device=dev)
    pid = torch.empty((w, s, cg), dtype=torch.int32, device=dev)
    if w == 0:
        return con, body_j, pid
    ptrs = [const(a, dev).data_ptr() for a in (
        fs.col_body, fs.kinds, fs.col_sta, fs.grid_cols)]
    f32 = np.float32
    lib = kernels.library()
    err = lib.fyrox_narrow_compact(
        col.data_ptr(), jv.data_ptr(), warm_lam.data_ptr(),
        warm_pid.data_ptr(), *ptrs, con.data_ptr(), body_j.data_ptr(),
        pid.data_ptr(), w, cx.c, cg, s, *fs.nslots, tile,
        float(f32(slab2._margin(t))), float(f32(PREDICTION_DISTANCE)),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "fyrox_narrow_compact")
    _LAUNCHES["narrow_compact"] += 1
    return con, body_j, pid


def bp_candidates(t, body, dt):
    """K3's broadphase stage. CPU tensors → plain version; CUDA tensors →
    csrc/fused_bp.cu (raises on anything it does not take)."""
    if body.is_cuda:
        return _bp_candidates_cuda(t, body, dt)
    return bp_candidates_plain(t, body, dt)


def narrow_compact(t, col, jv, warm_lam, warm_pid):
    """K2's narrowphase + compaction + warm match. CPU tensors → plain
    version; CUDA tensors → csrc/narrow_compact.cu (or raises)."""
    if col.is_cuda:
        return _narrow_compact_cuda(t, col, jv, warm_lam, warm_pid)
    return narrow_compact_plain(t, col, jv, warm_lam, warm_pid)


# --------------------------------------------------------------------------
# the fused steps
# --------------------------------------------------------------------------

def _inputs(state, t, accel, angvel):
    """The step's body planes [W,29,B] and warm carries in K1 layout."""
    if not supports_fused(t):
        raise NotImplementedError(
            "joints and centre-of-mass offsets on the fused route: the "
            "fused kernels do not carry them (step_slab2 sends such "
            "templates to the staged route)")
    cx = slab2._ctx(t)
    body = slab2.pack_body_planes(
        cx, state.position.unbind(-1), state.rotation.unbind(-1),
        state.linvel.unbind(-1), angvel.unbind(-1), accel.unbind(-1))
    warm_lam = torch.stack([slab2.to_sc(cx, x) for x in
                            (state.warm_n, state.warm_t1, state.warm_t2)],
                           1).contiguous()
    warm_pid = slab2.to_sc(cx, state.warm_pair).to(torch.int32).contiguous()
    return body, warm_lam, warm_pid


def _narrow_and_solve(t, dt, body, col, jv, warm_lam, warm_pid):
    cx = slab2._ctx(t)
    con, body_j, pid = narrow_compact(t, col, jv, warm_lam, warm_pid)
    body_out, lam = tgs_kernel.solve_tgs(
        con, body_j, body, const(cx.grid_body, body.device),
        tgs_kernel.solver_params(t, dt))
    return body_out, lam, pid


def fused_step(state, t, dt, accel, angvel, cands=None, bp_rank="sort"):
    """K2 route (pallas_step.fused_step_pallas): pose, AABBs and the slab
    broadphase in PyTorch, then narrow_compact and the K1 solve. `cands`:
    the step's candidates where the caller has them (temporal broadphase
    reuse, slab2.reuse_candidates), else the slab broadphase runs here with
    rank `bp_rank`. Returns (body_out [W,13,B], lam [W,3,S,Cg], pid
    [W,S,Cg])."""
    fs = _statics(t)
    cx = fs.cx
    body, warm_lam, warm_pid = _inputs(state, t, accel, angvel)
    col = collider_planes(t, body, dt)
    if cands is None:
        amin, amax = _aabbs(t, col)
        cands = bp_mod.slab_candidates(t.grid, cx.col_body, cx.dyn_col, amin,
                                       amax, tight_delta=_tight_delta(),
                                       rank=bp_rank)
    jv = _jv_from_candidates(fs, cands)
    return _narrow_and_solve(t, dt, body, col.contiguous(), jv, warm_lam,
                             warm_pid)


def fused_full_step(state, t, dt, accel, angvel):
    """K3 route (pallas_step.fused_full_step_pallas): bp_candidates →
    narrow_compact → the K1 solve. Returns as fused_step."""
    body, warm_lam, warm_pid = _inputs(state, t, accel, angvel)
    jv, col = bp_candidates(t, body, dt)
    return _narrow_and_solve(t, dt, body, col, jv, warm_lam, warm_pid)
