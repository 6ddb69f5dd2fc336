"""Slab physics step (``fyrox_tpu.physics.slab2.step_slab2``).

Scenes in the fused scope take the fused route (physics/fused_step.py:
K3, or K2 where a big collider is finite), as the JAX package does on its
chip; ``fused=False`` keeps them on the staged path of this module (the
JAX package's ``FYROX_NO_FUSED_STEP=1``). Scenes with joints or
centre-of-mass offsets always take the staged path, whose K1 call carries
the joint tables and the COM planes:

    collider pose + swept fat AABBs → slab broadphase windows (or, under
      temporal broadphase reuse, the cached windows; below)
    → per-class plane narrowphase (partner rows through K4a plane_gather)
    → per-collider compaction of active points to ``s_active`` slots,
      rapier-tier points first
    → warm-start matching by point identity
    → the TGS-soft solve (K1, physics/tgs_kernel.py)
    → axis locks, damping, warm carries.

Every contact slot is directed (the twin slot of the partner's window
carries the other half of the impulse), so the solver applies only the
self half of each impulse and Newton's third law holds exactly.

Temporal broadphase reuse (``broadphase_period`` > 1, ``reuse_candidates``)
rebuilds the candidate windows from two-sided, period-fattened AABBs every
``period`` steps, or earlier once a body leaves its cached coverage, and
reuses them in between; such templates take the K2 route (or the staged
path), since K3 rebuilds every step. The rebuild-or-reuse decision is one
for all worlds and is taken on the host, on one scalar read per step, so a
reuse step does none of the rebuild's work.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch._util import const
from fyrox_tpu_torch.physics import broadphase as bp_mod
from fyrox_tpu_torch.physics import np_planes
from fyrox_tpu_torch.physics import shapes as sh
from fyrox_tpu_torch.physics import tgs_kernel
from fyrox_tpu_torch.physics.joints import joint_table
from fyrox_tpu_torch.physics.plane_ops import plane_gather, plane_gather_plain
from fyrox_tpu_torch.physics.planes import (norm3, q_to_rot9, qmul, qrotate,
                                            scale3, splat, sub3, where3,
                                            where_n)

__all__ = ["step_slab2", "contacts", "solver_inputs", "pack_solver_inputs",
           "pack_contacts", "pack_body_planes", "joint_tables",
           "reuse_candidates", "bp_demand_stats", "overflow_stats"]

DYNAMIC = 0


class _Ctx:
    """Static per-template host arrays for the step (cached on the
    template)."""

    def __init__(self, t):
        sc = t.grid
        if not isinstance(sc, bp_mod.SlabConfig):
            raise NotImplementedError("the torch port steps slab templates "
                                      "only (dense and grid broadphases "
                                      "are not ported)")
        shapes_ok = (sh.BALL, sh.CUBOID, sh.CAPSULE, sh.HALFSPACE)
        if not np.all(np.isin(np.asarray(t.col_shape), shapes_ok)):
            raise NotImplementedError("convex hulls, cylinders/cones and "
                                      "heightfield/trimesh scenery")
        self.c, self.b = t.num_colliders, t.num_bodies
        self.cg = int(sc.grid_cols.size)
        self.s_active = int(sc.s_active)
        col_body = np.asarray(t.col_body)
        self.col_body = col_body
        self.dyn_col = (np.asarray(t.body_type)[col_body] == DYNAMIC)
        self.col_pos = np.asarray(t.col_pos, np.float32)
        self.col_rot = np.asarray(t.col_rot, np.float32)
        self.params = np.asarray(t.col_params, np.float32)
        self.shape = np.asarray(t.col_shape)
        self.fric = np.asarray(t.col_friction, np.float32)
        self.rest = np.asarray(t.col_restitution, np.float32)
        self.kinds = np.asarray(sc.kinds)
        self.grid_cols = np.asarray(sc.grid_cols)
        self.grid_body = col_body[self.grid_cols].astype(np.int32)
        self.col_body64 = col_body.astype(np.int64)
        self.grid_cols64 = self.grid_cols.astype(np.int64)
        self.i_static = {c: np.repeat(self.grid_cols, sc.nslot(c))
                         for c in range(3) if sc.nslot(c)}
        # per-class i-side static rows: params6, friction, restitution
        self.i_rows = {c: np.ascontiguousarray(np.concatenate(
            [self.params[i].T, self.fric[i][None], self.rest[i][None]], 0))
            for c, i in self.i_static.items()}
        self.i_kind = {c: self.kinds[i].astype(np.int32)
                       for c, i in self.i_static.items()}
        self.col_pos_rows = np.ascontiguousarray(self.col_pos.T)   # [3,C]
        self.col_rot_rows = np.ascontiguousarray(self.col_rot.T)   # [4,C]
        self.param_rows = np.ascontiguousarray(self.params.T)      # [6,C]
        uniq = set(int(k) for k in np.unique(self.kinds))
        self.combos = {cls: [(ka, kb) for ka, kb in combos
                             if ka in uniq and kb in uniq]
                       for cls, combos in np_planes.CLASS_COMBOS_P.items()}
        self.trivial_offsets = (not np.any(self.col_pos)
                                and np.allclose(self.col_rot[:, :3], 0.0)
                                and np.allclose(self.col_rot[:, 3], 1.0))
        # j-side static gather rows: params6, friction, restitution, kind
        self.j_static = np.concatenate(
            [self.params.T, self.fric[None], self.rest[None],
             self.kinds[None].astype(np.float32)], 0)          # [9,C]
        self.inv_mass = np.asarray(t.inv_mass, np.float32)
        self.inv_inertia = np.asarray(t.inv_inertia_local, np.float32)
        self.ii_rows = np.ascontiguousarray(
            self.inv_inertia.reshape(-1, 9).T)                 # [9,B]
        # body-local COM offsets (zeros for origin-centred bodies); has_com
        # is template-wide, as in the JAX package
        self.com_rows = np.ascontiguousarray(
            np.asarray(t.com_local, np.float32).T)             # [3,B]
        self.has_com = bool(np.any(self.com_rows))
        # static joint tables of the solve: partner bodies and the
        # per-joint rows (joints.joint_table)
        joints = getattr(t, "joints", None)
        self.joints = (joints if joints is not None and joints.num_joints
                       else None)
        if self.joints is not None:
            self.joint_a = np.asarray(self.joints.body_a, np.int32)
            self.joint_b = np.asarray(self.joints.body_b, np.int32)
            self.jtab = joint_table(self.joints)
        # rotation-invariant radius bound per collider (the reuse window's
        # AABBs must cover the bodies' rotation until the next rebuild);
        # the capsule's is the norm of its conservative rotated-box extents,
        # as build_slab_config sizes the cell; unbounded shapes get _HUGE
        p = np.asarray(t.col_params, np.float64)
        br = np.full(self.c, np.inf)
        br = np.where(self.shape == sh.BALL, p[:, 0], br)
        br = np.where(self.shape == sh.CUBOID,
                      np.linalg.norm(p[:, :3], axis=1), br)
        br = np.where(self.shape == sh.CAPSULE,
                      np.sqrt(2 * p[:, 1] ** 2 + (p[:, 0] + p[:, 1]) ** 2), br)
        self.bound_radius = np.where(np.isfinite(br), br,
                                     sh._HUGE).astype(np.float32)
        # static per-body coverage cap of a reuse window: half the smallest
        # sweep cap over the body's grid colliders, less twice its largest
        # collider offset (the offsets' swing room), at least 0
        capb = np.full(self.b, np.inf, np.float32)
        offb = np.zeros(self.b, np.float32)
        gcols = set(int(x) for x in sc.grid_cols)
        for ci in range(self.c):
            bi = int(col_body[ci])
            if ci in gcols:
                capb[bi] = min(capb[bi], 0.5 * float(sc.sweep_cap[ci]))
                offb[bi] = max(offb[bi],
                               float(np.linalg.norm(self.col_pos[ci])))
        self.body_cov_cap = np.maximum(capb - 2.0 * offb, 0.0)


def _ctx(t) -> _Ctx:
    if getattr(t, "_torch_slab2_ctx", None) is None:
        t._torch_slab2_ctx = _Ctx(t)
    return t._torch_slab2_ctx


def _unstack(x):
    return tuple(x.unbind(-1))


def _collider_pose_planes(cx: _Ctx, pos_b, q_b, lv_b):
    """Body planes [W,B] → collider world pose planes [W,C]:
    (position v3, rotation quat4, linear velocity v3)."""
    dev = pos_b[0].device
    idx = const(cx.col_body64, dev)
    bpos = tuple(p[:, idx] for p in pos_b)
    bq = tuple(p[:, idx] for p in q_b)
    lvc = tuple(p[:, idx] for p in lv_b)
    if cx.trivial_offsets:
        return bpos, bq, lvc
    cq = tuple(r[None].expand_as(bq[0])
               for r in const(cx.col_rot_rows, dev).unbind(0))
    cp = tuple(r[None].expand_as(bpos[0])
               for r in const(cx.col_pos_rows, dev).unbind(0))
    wq = qmul(bq, cq)
    cpos = tuple(a + b for a, b in zip(bpos, qrotate(bq, cp)))
    return cpos, wq, lvc


def _aabb_planes(cx: _Ctx, t, cpos, crot9, v_sweep, margin,
                 two_sided=False, extra=0.0):
    """Swept fat AABB planes [W,C] x 6 (amin3, amax3).

    two_sided: the temporal-reuse AABBs. The cached candidates must cover
    motion in any direction and any rotation until the next rebuild, so
    the extents are the rotation-invariant radius bounds and the sweep
    |v_sweep| + `extra` (the gravity drift over the period) inflates both
    sides, clipped at half the sweep cap to keep the whole extent within
    the walk's ±1-cell reach."""
    dev = cpos[0].device
    sc = t.grid
    shp = const(cx.shape, dev)[None]
    p = [r[None] for r in const(cx.param_rows, dev).unbind(0)]
    absm = [torch.abs(r) for r in crot9]

    def rot_box(hx, hy, hz):
        return (absm[0] * hx + absm[1] * hy + absm[2] * hz,
                absm[3] * hx + absm[4] * hy + absm[5] * hz,
                absm[6] * hx + absm[7] * hy + absm[8] * hz)

    ball = (p[0], p[0], p[0])
    box = rot_box(p[0], p[1], p[2])
    cap = rot_box(p[1], p[0] + p[1], p[1])
    huge = splat(sh._HUGE, cpos[0])
    is_ball, is_box, is_cap = shp == sh.BALL, shp == sh.CUBOID, \
        shp == sh.CAPSULE
    he = []
    for i in range(3):
        h = torch.where(is_ball, ball[i], torch.where(
            is_box, box[i], torch.where(is_cap, cap[i], huge)))
        he.append(h + margin)
    cap3 = const(sc.sweep_cap, dev)[None]
    if two_sided:
        br = const(cx.bound_radius, dev)[None] + margin
        he = [br, br, br]
    amin, amax = [], []
    for i in range(3):
        if two_sided:
            ext = torch.minimum(torch.clamp(torch.abs(v_sweep[i]) + extra,
                                            min=0.0), cap3 * 0.5)
            amin.append(cpos[i] - he[i] - ext)
            amax.append(cpos[i] + he[i] + ext)
            continue
        swc = torch.minimum(torch.maximum(v_sweep[i], -cap3), cap3)
        amin.append(cpos[i] - he[i] + torch.clamp(swc, max=0.0))
        amax.append(cpos[i] + he[i] + torch.clamp(swc, min=0.0))
    # halfspace: the actual half-volume along its normal (rotation col 1)
    is_hs = shp == sh.HALFSPACE
    n_hs = (crot9[1], crot9[4], crot9[7])
    for i in range(3):
        amax[i] = torch.where(is_hs, cpos[i] + sh._HUGE * (1.0 - n_hs[i])
                              + margin, amax[i])
        amin[i] = torch.where(is_hs, cpos[i] - sh._HUGE * (1.0 + n_hs[i])
                              - margin, amin[i])
    return amin, amax


class _Contacts(NamedTuple):
    """Compacted per-point contact planes, all [W, Cg*s_active]."""
    n: tuple
    pt: tuple
    depth: torch.Tensor
    act: torch.Tensor      # f32 0/1
    fric: torch.Tensor
    rest: torch.Tensor
    sigma: torch.Tensor    # +1 self == A
    body_j: torch.Tensor   # int32 partner body
    own: torch.Tensor      # manifold size of the point's pair
    pid: torch.Tensor      # int32 point identity (pair*4 + point), -1 idle


_F_NAMES = ("nx", "ny", "nz", "px", "py", "pz", "depth", "act", "fric",
            "rest", "sigma", "own")
_I_NAMES = ("body_j", "pid")


def _gather_planes(planes, idx, plain=False):
    """List of [W,N] planes gathered at rows idx [W,K] → list of [W,K],
    one K4a plane gather for the whole list (its plain version where
    `plain`)."""
    gather = plane_gather_plain if plain else plane_gather
    out = gather(torch.stack(planes, 1).contiguous(),
                 idx.to(torch.int32).contiguous())
    return list(out.unbind(1))


def _narrowphase_windows(cx: _Ctx, t, cands, cpos, cq, v_sweep, margin,
                         plain=False):
    """Per-class plane narrowphase → per-collider candidate point windows:
    dicts name → [W,Cg,Wd] (float attributes, int attributes). Rows are
    point-major within each class, classes in order."""
    sc = t.grid
    dev = cpos[0].device
    w, cg = cpos[0].shape[0], cx.cg
    j_static = const(cx.j_static, dev)                       # [9,C]
    j_attr = (list(cpos) + list(cq)
              + [r[None].expand(w, -1) for r in j_static.unbind(0)]
              + list(v_sweep))                                # 19 × [W,C]
    gidx = const(cx.grid_cols64, dev)
    ig_all = [p[:, gidx] for p in list(cpos) + list(cq) + list(v_sweep)]
    parts_f = {k: [] for k in _F_NAMES}
    parts_i = {k: [] for k in _I_NAMES}

    for cls in range(3):
        cand = cands[cls]
        kp_c = cand.j_real.shape[1]
        if kp_c == 0:
            continue
        nslot_c = sc.nslot(cls)
        npts = bp_mod.CLASS_NPTS[cls]
        jg = _gather_planes(j_attr, cand.j_real, plain)
        j_pos, j_q, j_p6 = tuple(jg[0:3]), tuple(jg[3:7]), tuple(jg[7:13])
        j_fric, j_rest = jg[13], jg[14]
        kind_j = jg[15].to(torch.int32)
        j_vs = tuple(jg[16:19])

        def bcast(p):
            return p[:, :, None].expand(w, cg, nslot_c).reshape(w, kp_c)

        i_pos = tuple(bcast(p) for p in ig_all[0:3])
        i_q = tuple(bcast(p) for p in ig_all[3:7])
        i_vs = tuple(bcast(p) for p in ig_all[7:10])
        i_rows = const(cx.i_rows[cls], dev)
        i_p6 = tuple(r[None].expand(w, kp_c) for r in i_rows[0:6].unbind(0))
        i_fric, i_rest = i_rows[6][None], i_rows[7][None]
        kind_i = const(cx.i_kind[cls], dev)[None]

        pred = margin + norm3(sub3(i_vs, j_vs))
        sw = cand.swap
        eff_a = torch.where(sw, kind_j, kind_i)
        eff_b = torch.where(sw, kind_i, kind_j)
        pos_a, pos_b = where3(sw, j_pos, i_pos), where3(sw, i_pos, j_pos)
        q_a, q_b = where_n(sw, j_q, i_q), where_n(sw, i_q, j_q)
        p6_a, p6_b = where_n(sw, j_p6, i_p6), where_n(sw, i_p6, j_p6)
        m = np_planes.generate_class_planes(
            cls, eff_a, eff_b, pos_a, q_to_rot9(q_a), p6_a, pos_b,
            q_to_rot9(q_b), p6_b, pred, combos_present=cx.combos[cls])

        fric_p = torch.sqrt(torch.clamp(i_fric * j_fric, min=0.0))
        rest_p = torch.maximum(i_rest.expand_as(j_rest), j_rest)
        sigma = torch.where(sw, -1.0, 1.0)
        valid = cand.valid.to(torch.float32)

        def rsh(p):
            return p.expand(w, kp_c).reshape(w, cg, nslot_c)

        for p_i in range(npts):
            parts_f["nx"].append(rsh(m.normal[0]))
            parts_f["ny"].append(rsh(m.normal[1]))
            parts_f["nz"].append(rsh(m.normal[2]))
            parts_f["px"].append(rsh(m.pts[p_i][0]))
            parts_f["py"].append(rsh(m.pts[p_i][1]))
            parts_f["pz"].append(rsh(m.pts[p_i][2]))
            parts_f["depth"].append(rsh(m.depth[p_i]))
            parts_f["act"].append(rsh(m.active[p_i] * valid))
            parts_f["fric"].append(rsh(fric_p))
            parts_f["rest"].append(rsh(rest_p))
            parts_f["sigma"].append(rsh(sigma))
            parts_f["own"].append(rsh(torch.full_like(valid, float(npts))))
            parts_i["body_j"].append(rsh(cand.body_j))
            parts_i["pid"].append(rsh(cand.pid * 4 + p_i))

    attrs_f = {k: torch.cat(v, dim=2) for k, v in parts_f.items()}
    attrs_i = {k: torch.cat(v, dim=2) for k, v in parts_i.items()}
    return attrs_f, attrs_i


def _compact(cx: _Ctx, attrs_f, attrs_i):
    """Per-collider active-point compaction to s_active slots: the rapier
    tier (points within the prediction distance, penetrating ones
    included) packs first, then the speculative band, each in window
    order; points past s_active drop."""
    from fyrox_tpu_torch.physics.world import PREDICTION_DISTANCE
    s = cx.s_active
    act = attrs_f["act"] > 0.5
    pen = act & (attrs_f["depth"] > -PREDICTION_DISTANCE)
    names = _F_NAMES + _I_NAMES
    vals = [attrs_f[k] for k in _F_NAMES] + [attrs_i[k] for k in _I_NAMES]
    packed, n_valid = bp_mod.compact_slots(act, pen, vals, s)
    w, cg = act.shape[:2]
    cols = {k: v.reshape(w, cg * s) for k, v in zip(names, packed)}
    k_ar = torch.arange(s, device=act.device)
    actc = (k_ar[None, None, :] < torch.clamp(n_valid, max=s)[..., None]
            ).to(torch.float32).reshape(w, cg * s)
    return _Contacts(
        n=(cols["nx"], cols["ny"], cols["nz"]),
        pt=(cols["px"], cols["py"], cols["pz"]),
        depth=cols["depth"], act=actc, fric=cols["fric"], rest=cols["rest"],
        sigma=cols["sigma"], body_j=cols["body_j"],
        own=torch.clamp(cols["own"], min=1.0),
        pid=torch.where(actc > 0.5, cols["pid"],
                        torch.full_like(cols["pid"], -1)))


def _ii_world9(q, ii_rows):
    """World inverse inertia planes R I⁻¹ Rᵀ: q 4 × [W,B], ii_rows [9,B]."""
    r = q_to_rot9(q)
    ii = [ii_rows[k][None] for k in range(9)]
    tmp = [r[3 * i] * ii[j] + r[3 * i + 1] * ii[3 + j] + r[3 * i + 2] * ii[6 + j]
           for i in range(3) for j in range(3)]
    return tuple(tmp[3 * i] * r[3 * j] + tmp[3 * i + 1] * r[3 * j + 1]
                 + tmp[3 * i + 2] * r[3 * j + 2]
                 for i in range(3) for j in range(3))


def to_sc(cx: _Ctx, p):
    """Collider-major slots [W, Cg*S] → the K1 layout [W,S,Cg] (a view)."""
    return p.reshape(p.shape[0], cx.cg, cx.s_active).transpose(1, 2)


def from_sc(cx: _Ctx, x):
    """The K1 layout [W,S,Cg] → collider-major slots [W, Cg*S]."""
    return x.transpose(1, 2).reshape(x.shape[0], cx.cg * cx.s_active)


def pack_contacts(cx: _Ctx, con: _Contacts, lam0):
    """Compacted contacts + warm impulses [W,Cg*S] → the K1 layout
    (con [W,15,S,Cg], body_j [W,S,Cg] int32)."""
    con_list = (list(con.n) + list(con.pt)
                + [con.depth, con.fric, con.rest, con.act, con.own,
                   con.sigma] + list(lam0))
    con_planes = torch.stack([to_sc(cx, p) for p in con_list],
                             1).contiguous()
    body_j = to_sc(cx, con.body_j).to(torch.int32).contiguous()
    return con_planes, body_j


def pack_body_planes(cx: _Ctx, pos, q, lv, av, accel):
    """Body state planes [W,B] → the K1 body layout [W,29,B]: lv3 av3 pos3
    q4 acc3 inv_mass inv_inertia_world9 com_local3."""
    w = pos[0].shape[0]
    dev = pos[0].device
    ii0 = _ii_world9(q, const(cx.ii_rows, dev))
    imass = const(cx.inv_mass, dev)[None].expand(w, -1)
    cm = [r[None].expand(w, -1) for r in const(cx.com_rows, dev).unbind(0)]
    return torch.stack(list(lv) + list(av) + list(pos) + list(q)
                       + list(accel) + [imass] + list(ii0) + cm,
                       1).contiguous()


def joint_tables(cx: _Ctx, device):
    """The template's joint tables for the solve, on `device` (None for a
    template without joints)."""
    if cx.joints is None:
        return None
    return tgs_kernel.JointTables(body_a=const(cx.joint_a, device),
                                  body_b=const(cx.joint_b, device),
                                  jtab=const(cx.jtab, device))


def pack_solver_inputs(cx: _Ctx, con: _Contacts, lam0, pos, q, lv, av,
                       accel):
    """Compacted contacts + body planes → the K1 layout
    (con [W,15,S,Cg], body_j [W,S,Cg], body [W,29,B], col_body [Cg])."""
    con_planes, body_j = pack_contacts(cx, con, lam0)
    body = pack_body_planes(cx, pos, q, lv, av, accel)
    return con_planes, body_j, body, const(cx.grid_body, pos[0].device)


def _period(t) -> int:
    return int(getattr(t, "broadphase_period", 1) or 1)


def _margin(t) -> float:
    from fyrox_tpu_torch.physics.world import SPECULATIVE_MARGIN
    return t.allowed_linear_error + SPECULATIVE_MARGIN


def _pose(cx: _Ctx, state):
    """Collider pose planes of a state: (cpos v3, cq quat4, crot9, lv_c v3)."""
    cpos, cq, lv_c = _collider_pose_planes(cx, _unstack(state.position),
                                           _unstack(state.rotation),
                                           _unstack(state.linvel))
    return cpos, cq, q_to_rot9(cq), lv_c


def _stack(planes):
    return torch.stack(planes, -1)


def step_slab2(state, t, dt, accel, angvel, fused=True, bp_rank="sort"):
    """One slab step; returns the new PhysicsState. Scenes in the fused
    scope take the fused route (K3 or K2) unless `fused` is False.
    bp_rank: the slab broadphase's rank, "sort" or "count" (the JAX
    package's FYROX_BP_RANK), wherever the broadphase runs in PyTorch (K3
    ranks inside its kernel)."""
    from fyrox_tpu_torch.physics import fused_step
    cx = _ctx(t)
    bp_cache, bp_age = state.bp_cache, state.bp_age
    if fused and fused_step.supports_fused_bp(t):
        body_out, lam, pid_sc = fused_step.fused_full_step(state, t, dt,
                                                           accel, angvel)
        pid = from_sc(cx, pid_sc)
    else:
        cands = None
        if _period(t) > 1 and state.bp_cache is not None:
            cands, bp_cache, bp_age = reuse_candidates(state, t, dt, bp_rank)
        if fused and fused_step.supports_fused(t):
            body_out, lam, pid_sc = fused_step.fused_step(
                state, t, dt, accel, angvel, cands=cands, bp_rank=bp_rank)
            pid = from_sc(cx, pid_sc)
        else:
            packed, pid = solver_inputs(state, t, dt, accel, angvel,
                                        cands=cands, bp_rank=bp_rank)
            body_out, lam = tgs_kernel.solve_tgs(
                *packed, tgs_kernel.solver_params(t, dt), has_com=cx.has_com,
                joints=joint_tables(cx, packed[0].device))
    lams = tuple(from_sc(cx, lam[:, i]) for i in range(3))
    return _finish_step(state, t, dt, body_out, lams, pid, bp_cache, bp_age)


def reuse_candidates(state, t, dt, bp_rank="sort"):
    """Temporal broadphase reuse (fyrox_tpu/physics/slab2.py:1099-1185).
    Returns (candidates, bp_cache, bp_age) for this step.

    A rebuild walks the slab broadphase over two-sided AABBs fattened by
    |v|·period·dt plus the gravity drift over the period, with this step's
    own AABBs as the tight tier, and caches the windows, the positions and
    a per-body coverage budget (|v|·period·dt + drift, capped by
    ``_Ctx.body_cov_cap``; zero if any window overflowed, so that the next
    step rebuilds too). Between rebuilds the cached windows serve. A
    rebuild happens when bp_age[0] % period == 0, or as soon as any body's
    displacement since the rebuild plus this step's sweep leaves its
    budget; one decision for all worlds, read on the host (one scalar per
    step), and a rebuild restarts the cadence."""
    cx = _ctx(t)
    sc = t.grid
    period = _period(t)
    f32 = np.float32
    dtv = f32(dt)
    span = f32(period) * dtv                       # the reuse horizon, s
    gmag = float(np.linalg.norm(np.asarray(t.gravity, np.float64)))
    # discrete symplectic-Euler drift over the period, 0.5 g T^2 (1 + 1/p),
    # with 1/p more as slack for the last step's sweep; float32 as the
    # JAX package computes it
    extra = float(f32(0.5 * gmag) * (span * span) * f32(1.0 + 2.0 / period))
    cached, pos0, cov0 = state.bp_cache
    need = (torch.abs(state.position - pos0)
            + torch.abs(state.linvel) * float(dtv))
    covered = torch.all(need <= cov0 + 1e-5)
    if not bool(((state.bp_age[0] % period) == 0) | ~covered):
        return list(cached), state.bp_cache, (state.bp_age + 1) % period
    cpos, _, crot9, lv_c = _pose(cx, state)
    margin = _margin(t)
    aminf, amaxf = _aabb_planes(cx, t, cpos, crot9, scale3(lv_c, float(span)),
                                margin, two_sided=True, extra=extra)
    amint, amaxt = _aabb_planes(cx, t, cpos, crot9, scale3(lv_c, dt), margin)
    cands, demand = bp_mod.slab_candidates(
        sc, cx.col_body, cx.dyn_col, _stack(aminf), _stack(amaxf),
        amin_tight=_stack(amint), amax_tight=_stack(amaxt), rank=bp_rank,
        return_demand=True)
    dev = state.position.device
    cov = torch.minimum(torch.abs(state.linvel) * float(span) + extra,
                        const(cx.body_cov_cap, dev)[None, :, None])
    overflow = torch.any(demand["walk_total"] > sc.s_walk)
    for c in range(3):
        if sc.s_class[c]:
            overflow = overflow | torch.any(
                demand["class_valid"][c] > sc.s_class[c])
    cov = torch.where(overflow, torch.zeros_like(cov), cov)
    return cands, (tuple(cands), state.position, cov), \
        torch.ones_like(state.bp_age)


def contacts(state, t, dt, cands=None, bp_rank="sort") -> _Contacts:
    """The step's compacted contacts: collider pose, AABBs, broadphase
    (rank `bp_rank`; skipped where `cands` are given), narrowphase and
    compaction."""
    from fyrox_tpu_torch.physics.world import (PREDICTION_DISTANCE,
                                               SPECULATIVE_MARGIN)
    cx = _ctx(t)
    margin = _margin(t)
    cpos, cq, crot9, lv_c = _pose(cx, state)
    v_sweep = scale3(lv_c, dt)
    if cands is None:
        amin, amax = _aabb_planes(cx, t, cpos, crot9, v_sweep, margin)
        cands = bp_mod.slab_candidates(
            t.grid, cx.col_body, cx.dyn_col, _stack(amin), _stack(amax),
            tight_delta=SPECULATIVE_MARGIN - PREDICTION_DISTANCE,
            rank=bp_rank)
    attrs_f, attrs_i = _narrowphase_windows(cx, t, cands, cpos, cq, v_sweep,
                                            margin)
    return _compact(cx, attrs_f, attrs_i)


def solver_inputs(state, t, dt, accel, angvel, cands=None, bp_rank="sort"):
    """Everything of the step before the solve: contacts (on `cands` where
    given) and warm-start matching. Returns the packed K1 inputs (con,
    body_j, body, col_body) and the new point identities [W,
    Cg*s_active]."""
    con = contacts(state, t, dt, cands, bp_rank)
    # warm start: slots still holding the same contact point identity
    same = (state.warm_pair == con.pid).to(torch.float32) * con.act
    lam0 = (state.warm_n * same, state.warm_t1 * same, state.warm_t2 * same)
    return (pack_solver_inputs(_ctx(t), con, lam0, _unstack(state.position),
                               _unstack(state.rotation),
                               _unstack(state.linvel), _unstack(angvel),
                               _unstack(accel)), con.pid)


def _finish_step(state, t, dt, body_out, lams, pid_new, bp_cache, bp_age):
    """Step tail: locks/damping, warm-carry routing, state pack."""
    from fyrox_tpu_torch.physics.world import (PhysicsState,
                                               _apply_locks_damping)
    bo = body_out.transpose(1, 2)                            # [W,B,13]
    position, rotation, linvel, angvel = _apply_locks_damping(
        state, t, dt, bo[..., 6:9], bo[..., 9:13], bo[..., 0:3],
        bo[..., 3:6])
    return PhysicsState(position=position.contiguous(),
                        rotation=rotation.contiguous(),
                        linvel=linvel.contiguous(),
                        angvel=angvel.contiguous(),
                        force=torch.zeros_like(state.force),
                        torque=torch.zeros_like(state.torque),
                        warm_n=lams[0].contiguous(),
                        warm_t1=lams[1].contiguous(),
                        warm_t2=lams[2].contiguous(),
                        warm_pair=pid_new.contiguous(),
                        bp_cache=bp_cache, bp_age=bp_age)


# --------------------------------------------------------------------------
# diagnostics: demand against the windows (fyrox_tpu/physics/slab2.py:1841)
# --------------------------------------------------------------------------

def bp_demand_stats(t, state, period=1, dt=1.0 / 60.0):
    """Broadphase window demand of the state at a temporal reuse period:
    raw walk-window candidates against s_walk and per-class valid (and
    tight-tier) candidates against s_class. Demand past a window drops
    candidates silently. Returns a dict of Python ints."""
    from fyrox_tpu_torch.physics.world import (PREDICTION_DISTANCE,
                                               SPECULATIVE_MARGIN)
    cx = _ctx(t)
    sc = t.grid
    cpos, _, crot9, lv_c = _pose(cx, state)
    margin = _margin(t)
    if period > 1:
        gmag = float(np.linalg.norm(np.asarray(t.gravity, np.float64)))
        extra = 0.5 * gmag * (period * dt) ** 2
        amin, amax = _aabb_planes(cx, t, cpos, crot9,
                                  scale3(lv_c, dt * period), margin,
                                  two_sided=True, extra=extra)
        amint, amaxt = _aabb_planes(cx, t, cpos, crot9, scale3(lv_c, dt),
                                    margin)
        kw = dict(amin_tight=_stack(amint), amax_tight=_stack(amaxt))
    else:
        amin, amax = _aabb_planes(cx, t, cpos, crot9, scale3(lv_c, dt),
                                  margin)
        kw = dict(tight_delta=SPECULATIVE_MARGIN - PREDICTION_DISTANCE)
    _, demand = bp_mod.slab_candidates(sc, cx.col_body, cx.dyn_col,
                                       _stack(amin), _stack(amax),
                                       return_demand=True, **kw)
    walk = demand["walk_total"].cpu().numpy()
    out = dict(max_walk=int(walk.max()), s_walk=int(sc.s_walk),
               walk_dropped=int(np.maximum(walk - sc.s_walk, 0).sum()))
    for c in range(3):
        nv = demand["class_valid"][c].cpu().numpy()
        nt = demand["class_tight"][c].cpu().numpy()
        cap = sc.s_class[c]
        out[f"class{c}"] = dict(
            max_valid=int(nv.max()), cap=int(cap),
            dropped=int(np.maximum(nv - cap, 0).sum()) if cap else 0,
            max_tight=int(nt.max()),
            tight_dropped=int(np.maximum(nt - cap, 0).sum()) if cap else 0)
    return out


def overflow_stats(t, state):
    """Active-point demand of the state against the s_active compaction
    window: points past it drop. Returns dict(max_active_points,
    mean_active_points, max_tight_points, s_active, dropped_points,
    tight_dropped_points); the tight points are those within rapier's
    prediction distance, which compaction packs first."""
    from fyrox_tpu_torch.physics.world import PREDICTION_DISTANCE
    cx = _ctx(t)
    cpos, cq, crot9, lv_c = _pose(cx, state)
    v_sweep = scale3(lv_c, 1.0 / 60.0)
    margin = _margin(t)
    amin, amax = _aabb_planes(cx, t, cpos, crot9, v_sweep, margin)
    cands = bp_mod.slab_candidates(t.grid, cx.col_body, cx.dyn_col,
                                   _stack(amin), _stack(amax))
    attrs_f, _ = _narrowphase_windows(cx, t, cands, cpos, cq, v_sweep, margin)
    act = attrs_f["act"]
    n_valid = act.sum(dim=2).cpu().numpy()
    n_tight = (act * (attrs_f["depth"] > -PREDICTION_DISTANCE)).sum(
        dim=2).cpu().numpy()
    s = cx.s_active
    return dict(max_active_points=int(n_valid.max()),
                mean_active_points=float(n_valid.mean()),
                max_tight_points=int(n_tight.max()),
                s_active=s,
                dropped_points=int(np.maximum(n_valid - s, 0).sum()),
                tight_dropped_points=int(np.maximum(n_tight - s, 0).sum()))
