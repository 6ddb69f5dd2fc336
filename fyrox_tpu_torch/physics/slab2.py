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
from fyrox_tpu_torch.physics import np_planes, plane_ops
from fyrox_tpu_torch.physics import shapes as sh
from fyrox_tpu_torch.physics import tgs_kernel
from fyrox_tpu_torch.physics.joints import joint_table
from fyrox_tpu_torch.physics.planes import (add3, cross3, dot3, norm3,
                                            q_to_rot9, qmul, qrotate,
                                            rot9_apply, rot9_apply_t, scale3,
                                            splat, sub3, where3, where_n)

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
            raise NotImplementedError(
                "slab2 steps slab templates only; dense and grid templates "
                "take their own routes in physics/world.py")
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
        br = np.where((self.shape == sh.CYLINDER) | (self.shape == sh.CONE),
                      np.sqrt(p[:, 0] ** 2 + 2 * p[:, 1] ** 2), br)
        br = np.where(self.shape == sh.HEIGHTFIELD, p[:, 2], br)
        br = np.where((self.shape == sh.TRIMESH) | (self.shape == sh.CONVEX),
                      p[:, 0], br)
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
        self._hulls(t, sc)
        self._scenery(t, sc)

    def _hulls(self, t, sc):
        """Hull tables of a scene with CONVEX colliders (None elsewhere):
        hull_rows [1, 4·nv + 4·nf, C] (verts, vmask, normals, nmask a
        collider, cut to hull_widths = (nv, nf): the JAX package's
        hull_flat, attribute-major for K4a),
        hull_verts [C,32,3], hull_vmask [C,32]; and per class, for each
        convex combo whose kinds occur, the window columns whose self kind
        is one of the combo's (the only columns that can hold such a pair)
        and their self sides' hull rows [1,R,A] (cx_parts)."""
        from fyrox_tpu_torch.physics import narrowphase as np_mod
        from fyrox_tpu_torch.physics.convex import (MAX_HULL_FACES,
                                                    MAX_HULL_VERTS,
                                                    hull_widths)
        self.hull_rows = self.hull_verts = self.hull_vmask = None
        self.cx_parts = {}
        if t.hulls is None or not np.any(self.shape == sh.CONVEX):
            return
        c = self.c
        hv = np.zeros((c, MAX_HULL_VERTS, 3), np.float32)
        hvm = np.zeros((c, MAX_HULL_VERTS), np.float32)
        hn = np.zeros((c, MAX_HULL_FACES, 3), np.float32)
        hn[..., 1] = 1.0
        hnm = np.zeros((c, MAX_HULL_FACES), np.float32)
        has = np.asarray(t.col_hull) >= 0
        hi = np.maximum(np.asarray(t.col_hull), 0)
        hv[has] = t.hulls.verts[hi[has]]
        hvm[has] = t.hulls.vmask[hi[has]]
        hn[has] = t.hulls.normals[hi[has]]
        hnm[has] = t.hulls.nmask[hi[has]]
        self.hull_verts, self.hull_vmask = hv, hvm
        # the SAT routines' widths: the CONVEX colliders' largest hulls
        cxc = self.shape == sh.CONVEX
        nv, nf = self.hull_widths = hull_widths(hvm[cxc], hnm[cxc])
        flat = np.concatenate([hv[:, :nv].reshape(c, -1), hvm[:, :nv],
                               hn[:, :nf].reshape(c, -1), hnm[:, :nf]], -1)
        self.hull_rows = np.ascontiguousarray(flat.T)[None]  # [1,A,C]
        uniq = set(int(k) for k in np.unique(self.kinds))
        for cls, combos in np_mod.CLASS_COMBOS_CONVEX.items():
            ns = sc.nslot(cls)
            if not ns:
                continue
            k_i = self.kinds[self.i_static[cls]]
            # big partners sit in each window's last slots: never a hull
            grid_slot = (np.arange(k_i.size) % ns) < sc.s_class[cls]
            parts = []
            for ka, kb in combos:
                if ka not in uniq or kb not in uniq:
                    continue
                cols = np.flatnonzero(np.isin(k_i, (ka, kb)) & grid_slot)
                if cols.size:
                    parts.append(((ka, kb), cols.astype(np.int64),
                                  np.ascontiguousarray(
                                      flat[self.i_static[cls][cols]])[None]))
            if parts:
                self.cx_parts[cls] = parts

    def _scenery(self, t, sc):
        """Heightfield and trimesh big partners: their column in the big
        slots, kind and lookup tables (heightfield corners as one [1,4,Rh]
        table, the shifted copies that give a cell's 4 corner heights at
        one index)."""
        self.scenery = []
        big_index = {int(ci): i for i, ci in enumerate(sc.big_cols)}
        for ci in range(self.c):
            k = int(self.shape[ci])
            if k == sh.HEIGHTFIELD:
                hf = int(t.col_hf[ci])
                h = np.asarray(t.hf_heights[hf], np.float32)   # [Rz,Rx]
                rz, rx = h.shape
                h10 = np.concatenate([h[:, 1:], h[:, -1:]], 1)
                h01 = np.concatenate([h[1:], h[-1:]], 0)
                h11 = np.concatenate([h01[:, 1:], h01[:, -1:]], 1)
                corners = np.stack([x.reshape(-1) for x in
                                    (h, h10, h01, h11)])[None]  # [1,4,Rh]
                self.scenery.append(dict(
                    col=ci, kind=k, big=big_index[ci], corners=corners,
                    rz=rz, rx=rx,
                    sx=np.float32(t.hf_size[hf, 0]),
                    sz=np.float32(t.hf_size[hf, 1])))
            elif k == sh.TRIMESH:
                tm = int(t.col_tm[ci])
                self.scenery.append(dict(
                    col=ci, kind=k, big=big_index[ci],
                    tris=np.asarray(t.tm_tris[tm], np.float32),
                    tmask=np.asarray(t.tm_mask[tm], bool)))


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
    cyl = rot_box(p[1], p[0], p[1])
    huge = splat(sh._HUGE, cpos[0])
    is_ball, is_box, is_cap = shp == sh.BALL, shp == sh.CUBOID, \
        shp == sh.CAPSULE
    is_cyl = (shp == sh.CYLINDER) | (shp == sh.CONE)
    # scenery and hulls: their rotation-invariant radius bounds (the
    # heightfield's in p[2], the trimesh's and the hull's in p[0])
    is_hf = shp == sh.HEIGHTFIELD
    is_r0 = (shp == sh.TRIMESH) | (shp == sh.CONVEX)
    he = []
    for i in range(3):
        h = torch.where(is_ball, ball[i], torch.where(
            is_box, box[i], torch.where(is_cap, cap[i], torch.where(
                is_cyl, cyl[i], torch.where(is_hf, p[2], torch.where(
                    is_r0, p[0], huge))))))
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
    gather = (plane_ops.plane_gather_plain if plain
              else plane_ops.plane_gather)
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
        rot_a, rot_b = q_to_rot9(q_a), q_to_rot9(q_b)
        m = np_planes.generate_class_planes(
            cls, eff_a, eff_b, pos_a, rot_a, p6_a, pos_b, rot_b, p6_b, pred,
            combos_present=cx.combos[cls])

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

        # hull combos on the same windows, appended as extra parts (their
        # primitive-pair slots come out inactive and compaction drops them)
        if cls in cx.cx_parts:
            mcx = _convex_parts(cx, cls, cand, sw, eff_a, eff_b, pos_a, rot_a,
                                p6_a, pos_b, rot_b, pred, plain)
            for p_i in range(npts):
                for k, x in zip(("nx", "ny", "nz", "px", "py", "pz"),
                                mcx.normal.unbind(-1)
                                + mcx.points[..., p_i, :].unbind(-1)):
                    parts_f[k].append(rsh(x))
                parts_f["depth"].append(rsh(mcx.depth[..., p_i]))
                parts_f["act"].append(rsh(
                    (mcx.active[..., p_i] & cand.valid).to(torch.float32)))
                parts_f["fric"].append(rsh(fric_p))
                parts_f["rest"].append(rsh(rest_p))
                parts_f["sigma"].append(rsh(sigma))
                parts_f["own"].append(rsh(torch.full_like(valid,
                                                          float(npts))))
                parts_i["body_j"].append(rsh(cand.body_j))
                parts_i["pid"].append(rsh(cand.pid * 4 + p_i))

    if cx.scenery:
        _scenery_parts(cx, t, cands, ig_all, cpos, cq, margin, parts_f,
                       parts_i, plain)

    attrs_f = {k: torch.cat(v, dim=2) for k, v in parts_f.items()}
    attrs_i = {k: torch.cat(v, dim=2) for k, v in parts_i.items()}
    return attrs_f, attrs_i


def _unpack_hull(rows, nv, nf):
    """Hull rows [..., 4·nv + 4·nf] → (verts [...,nv,3], vmask, normals
    [...,nf,3], nmask)."""
    lead = rows.shape[:-1]
    o1, o2 = 3 * nv, 4 * nv
    return (rows[..., :o1].reshape(lead + (nv, 3)),
            rows[..., o1:o2] > 0.5,
            rows[..., o2:o2 + 3 * nf].reshape(lead + (nf, 3)),
            rows[..., o2 + 3 * nf:] > 0.5)


def _convex_parts(cx: _Ctx, cls, cand, sw, eff_a, eff_b, pos_a, rot_a, p6_a,
                  pos_b, rot_b, pred, plain=False):
    """Hull manifolds of class `cls` on its candidate windows
    (fyrox_tpu/physics/slab2.py:560-622): each convex combo runs on the
    window columns whose self kind is one of its kinds (no other column
    can hold such a pair: those get no contact, as in the JAX package), in
    slices of CHUNK_SLOTS slots, with the partner's hull rows through K4a
    from the shared [1,A,C] table and the self side's static; a slot
    takes the combo its kinds match. Returns a Manifold of [W, Kc]
    slots."""
    from fyrox_tpu_torch.physics import narrowphase as np_mod
    gather = (plane_ops.plane_gather_plain if plain
              else plane_ops.plane_gather)
    dev = cand.j_real.device
    w, kp = cand.j_real.shape
    npts = bp_mod.CLASS_NPTS[cls]
    table = const(cx.hull_rows, dev)                       # [1,A,C]
    out = np_mod.Manifold(
        torch.zeros((w, kp, 3), device=dev),
        torch.zeros((w, kp, npts, 3), device=dev),
        torch.full((w, kp, npts), -1e9, device=dev),
        torch.zeros((w, kp, npts), dtype=torch.bool, device=dev))
    step = max(1, np_mod.CHUNK_SLOTS // max(w, 1))

    def v(planes, c_):
        return torch.stack([p.expand(w, kp)[:, c_] for p in planes], -1)

    for (ka, kb), cols_np, rows_np in cx.cx_parts[cls]:
        cols = const(cols_np, dev)
        rows_i = const(rows_np, dev)                       # [1,R,A]
        for r0 in range(0, cols.numel(), step):
            c_ = cols[r0:r0 + step]
            r = c_.numel()
            jh = gather(table, cand.j_real[:, c_].to(torch.int32)
                        .contiguous()).transpose(1, 2)
            ih = rows_i[:, r0:r0 + step].expand_as(jh)
            s_ = sw[:, c_, None]
            hull_a = _unpack_hull(torch.where(s_, jh, ih), *cx.hull_widths)
            hull_b = _unpack_hull(torch.where(s_, ih, jh), *cx.hull_widths)
            m = np_mod.convex_pair(
                ka, hull_a, hull_b, v(p6_a, c_), v(pos_a, c_),
                v(rot_a, c_).reshape(w, r, 3, 3), v(pos_b, c_),
                v(rot_b, c_).reshape(w, r, 3, 3), pred[:, c_])
            hit = (eff_a[:, c_] == ka) & (eff_b[:, c_] == kb)
            m = np_mod.Manifold(m.normal, m.points[..., :npts, :],
                                m.depth[..., :npts], m.active[..., :npts])
            for dst, src in zip(out, m):
                cond = hit.reshape(hit.shape + (1,) * (src.dim() - 2))
                dst[:, c_] = torch.where(cond, src, dst[:, c_])
    return out


def _scenery_parts(cx: _Ctx, t, cands, ig_all, cpos, cq, margin, parts_f,
                   parts_i, plain=False):
    """Heightfield / trimesh big-partner contacts in plane form
    (fyrox_tpu/physics/slab2.py:633-917): every grid collider's samples
    (ball centre, capsule ends, box corners, hull vertices with the
    padding parked at the origin) against each scenery collider, the
    class's deepest samples kept with one shared normal, that of the
    deepest; appended to the windows as width-1 parts per point. The
    heightfield's corner heights come through K4a from one [1,4,Rz·Rx]
    table, one gather for all samples."""
    gather = (plane_ops.plane_gather_plain if plain
              else plane_ops.plane_gather)
    sc = t.grid
    cg, c_total = cx.cg, cx.c
    dev = cpos[0].device
    w = cpos[0].shape[0]
    kind_g = cx.kinds[cx.grid_cols]
    p_g = cx.params[cx.grid_cols]
    pos_g = tuple(ig_all[0:3])
    rot_g = q_to_rot9(tuple(ig_all[3:7]))
    pred_g = margin + _norm3_rn(tuple(ig_all[7:10]))
    if getattr(cx, "_scn_static", None) is None:
        cx._scn_static = _scenery_statics(cx, kind_g, p_g)
    st = cx._scn_static

    def dv(name):
        return const(st[name], dev)[None]

    is_ball, is_cap, is_box = dv("is_ball"), dv("is_cap"), dv("is_box")
    p0 = dv("p0")
    hx, hy, hz = dv("hx"), dv("hy"), dv("hz")
    radius = torch.where(is_ball, p0, torch.where(is_cap, dv("p1"), 0.0))
    ay = (rot_g[1], rot_g[4], rot_g[7])
    n_s = st["n_s"]
    samples, svalid = [], []
    for s_i in range(n_s):
        if s_i < 8:
            csx, csy, csz = _CORNERS[s_i]
            corner = add3(pos_g, rot9_apply(rot_g, (csx * hx, csy * hy,
                                                    csz * hz)))
        if s_i == 0:
            cap_pt = sub3(pos_g, scale3(ay, p0))
            pt = where3(is_box, corner, where3(is_cap, cap_pt, pos_g))
            valid = is_box | is_cap | is_ball
        elif s_i == 1:
            pt = where3(is_box, corner, add3(pos_g, scale3(ay, p0)))
            valid = is_box | is_cap
        elif s_i < 8:
            pt, valid = corner, is_box
        else:
            pt, valid = pos_g, torch.zeros_like(is_box)
        if "hull_v" in st:
            # hull vertices, padding parked at the shape origin (and
            # valid), as scenery.sample_points_for has them
            vloc = tuple(const(st["hull_v"][s_i][i], dev)[None]
                         for i in range(3))
            vm = dv("cx_in_grid")
            pt = where3(vm, add3(pos_g, rot9_apply(rot_g, vloc)), pt)
            valid = valid | vm
        samples.append(pt)
        svalid.append(valid.expand(w, cg))

    for scn in cx.scenery:
        col = scn["col"]
        p_sc = tuple(p[:, col:col + 1] for p in cpos)        # [W,1]
        rot_sc = q_to_rot9(tuple(p[:, col:col + 1] for p in cq))
        if scn["kind"] == sh.HEIGHTFIELD:
            depth_s, pw_s, nw_s = _hf_samples(scn, samples, p_sc, rot_sc,
                                              radius, gather, dev)
        else:
            depth_s, pw_s, nw_s = _tm_samples(scn, samples, p_sc, rot_sc,
                                              radius, cg)
        depth_s = [torch.where(svalid[i], d, -1e9)
                   for i, d in enumerate(depth_s)]
        act_s = [d > -pred_g for d in depth_s]
        gated = [torch.where(a, d, -1e9) for d, a in zip(depth_s, act_s)]
        best = gated[0]
        for d in gated[1:]:
            best = torch.maximum(best, d)
        # the shared normal: minus the deepest active sample's (first hit)
        n_acc = None
        taken = torch.zeros_like(best, dtype=torch.bool)
        for d, nw in zip(gated, nw_s):
            hit = (d == best) & ~taken
            taken = taken | hit
            h = hit.to(torch.float32)
            n_acc = [x * h for x in nw] if n_acc is None else                 [a + x * h for a, x in zip(n_acc, nw)]
        n_pair = tuple(-x for x in n_acc)
        # each sample's rank by gated depth, ties by sample order
        ranks = []
        for i_s in range(n_s):
            r = None
            for j_s in range(n_s):
                if j_s == i_s:
                    continue
                gt = ((gated[j_s] > gated[i_s])
                      | ((gated[j_s] == gated[i_s]) & (j_s < i_s)))
                r = gt.to(torch.int32) if r is None else r + gt
            ranks.append(r)
        pair = st["pairs"][col]
        cls_of = pair["cls_of"]
        for cls in range(3):
            nslot_c = sc.nslot(cls)
            if nslot_c == 0 or not np.any(cls_of == cls):
                continue
            npts = bp_mod.CLASS_NPTS[cls]
            bvalid = cands[cls].valid.reshape(w, cg, nslot_c)[
                :, :, sc.s_class[cls] + scn["big"]]
            gate = (const(pair["cls_mask"][cls], dev)[None] & bvalid).to(
                torch.float32)
            for p_i in range(npts):
                acc = None
                for s_i in range(n_s):
                    m = (ranks[s_i] == p_i).to(torch.float32)
                    vals = [pw_s[s_i][0], pw_s[s_i][1], pw_s[s_i][2],
                            depth_s[s_i], act_s[s_i].to(torch.float32)]
                    acc = [x * m for x in vals] if acc is None else \
                        [a + x * m for a, x in zip(acc, vals)]
                px, py, pz, dsel, asel = acc

                def col3(p):
                    return p.expand(w, cg).reshape(w, cg, 1)

                for k, x in zip(("nx", "ny", "nz", "px", "py", "pz",
                                 "depth"), n_pair + (px, py, pz, dsel)):
                    parts_f[k].append(col3(x))
                parts_f["act"].append(col3(asel * gate))
                parts_f["fric"].append(col3(const(pair["fric"], dev)[None]))
                parts_f["rest"].append(col3(const(pair["rest"], dev)[None]))
                parts_f["sigma"].append(col3(torch.ones_like(px)))
                parts_f["own"].append(col3(torch.full_like(px, float(npts))))
                parts_i["body_j"].append(col3(torch.full(
                    (1, 1), pair["body"], dtype=torch.int32, device=dev)))
                parts_i["pid"].append(col3(const(pair["pid"][p_i], dev)[None]))


_CORNERS = [(sx, sy, sz) for sx in (-1, 1) for sy in (-1, 1)
            for sz in (-1, 1)]


def _norm3_rn(v):
    """norm3 with a correctly rounded square root on either device, so
    the hull and scenery parts round alike on the card and the CPU."""
    from fyrox_tpu_torch.physics.convex import sqrt_rn
    return sqrt_rn(dot3(v, v))


def _normalize3_rn(a, eps=1e-9, fallback=(0.0, 1.0, 0.0)):
    """planes.normalize3 on _norm3_rn."""
    n = _norm3_rn(a)
    inv = 1.0 / torch.clamp(n, min=eps)
    return tuple(torch.where(n > eps, a[i] * inv,
                             torch.full_like(n, fallback[i]))
                 for i in range(3))


def _scenery_statics(cx: _Ctx, kind_g, p_g):
    """Host tables of the scenery parts: the grid colliders' kind masks
    and params, the sample count (8, or the largest grid hull), the hull
    vertices by sample, and per scenery collider its pair class, friction,
    restitution, body and point identities."""
    st = dict(is_ball=kind_g == sh.BALL, is_cap=kind_g == sh.CAPSULE,
              is_box=kind_g == sh.CUBOID,
              p0=np.ascontiguousarray(p_g[:, 0]),
              p1=np.ascontiguousarray(p_g[:, 1]),
              hx=np.ascontiguousarray(p_g[:, 0]),
              hy=np.ascontiguousarray(p_g[:, 1]),
              hz=np.ascontiguousarray(p_g[:, 2]), n_s=8)
    if cx.hull_verts is not None:
        cx_in_grid = cx.shape[cx.grid_cols] == sh.CONVEX
        if np.any(cx_in_grid):
            hv = cx.hull_verts[cx.grid_cols]                   # [Cg,V,3]
            hm = (cx.hull_vmask[cx.grid_cols] > 0) & cx_in_grid[:, None]
            n_s = max(8, int(hm.sum(1).max()))
            st.update(n_s=n_s, cx_in_grid=cx_in_grid, hull_v=[
                [np.ascontiguousarray(np.where(hm[:, s], hv[:, s, i], 0.0)
                                      .astype(np.float32)) for i in range(3)]
                for s in range(n_s)])
    sc_tab = None
    st["pairs"] = {}
    for scn in cx.scenery:
        col = scn["col"]
        if sc_tab is None:
            from fyrox_tpu_torch.physics.broadphase import pair_class_table
            sc_tab = pair_class_table()
        base = (cx.grid_cols.astype(np.int64) * cx.c + col) * 4
        cls_of = sc_tab[kind_g, scn["kind"]]
        st["pairs"][col] = dict(
            cls_of=cls_of, cls_mask=[cls_of == c for c in range(3)],
            fric=np.sqrt(cx.fric[cx.grid_cols] * cx.fric[col]),
            rest=np.maximum(cx.rest[cx.grid_cols], cx.rest[col]),
            body=int(cx.col_body[col]),
            pid=[(base + p_i).astype(np.int32) for p_i in range(4)])
    return st


def _hf_samples(scn, samples, p_sc, rot_sc, radius, gather, dev):
    """Per-sample tangent-plane contacts against one heightfield: lists of
    depth [W,Cg], world point v3, world normal v3."""
    rz, rx = scn["rz"], scn["rx"]
    # device scalars: a division by a tensor is IEEE division on both
    # devices (PyTorch divides a card tensor by a Python float as a
    # product with its reciprocal)
    sx, sz = const(scn["sx"], dev), const(scn["sz"], dev)
    locs = [rot9_apply_t(rot_sc, sub3(pt, p_sc)) for pt in samples]
    from fyrox_tpu_torch.physics.scenery import heightfield_cell
    cells = [heightfield_cell(x, z, rx, rz, sx, sz) for x, _y, z in locs]
    cg = locs[0][0].shape[1]
    idx = torch.cat([j0 * rx + i0 for i0, j0, _, _ in cells], 1)
    hc = gather(const(scn["corners"], dev), idx.contiguous())  # [W,4,S*Cg]
    depth_s, pw_s, nw_s = [], [], []
    for s_i, ((x, y, z), (_i0, _j0, fu, fv)) in enumerate(zip(locs, cells)):
        h00, h10, h01, h11 = hc[:, :, s_i * cg:(s_i + 1) * cg].unbind(1)
        gy = ((h00 * (1 - fu) + h10 * fu) * (1 - fv)
              + (h01 * (1 - fu) + h11 * fu) * fv)
        dhdx = ((h10 - h00) * (1 - fv) + (h11 - h01) * fv) * (rx - 1) / sx
        dhdz = ((h01 - h00) * (1 - fu) + (h11 - h10) * fu) * (rz - 1) / sz
        n_l = _normalize3_rn((-dhdx, torch.ones_like(gy), -dhdz))
        dist = (y - gy) * n_l[1]
        inside = ((torch.abs(x) <= radius + float(scn["sx"]) * 0.5)
                  & (torch.abs(z) <= radius + float(scn["sz"]) * 0.5))
        depth_s.append(torch.where(inside, radius - dist, -1e9))
        pw_s.append(add3(p_sc, rot9_apply(rot_sc, sub3(
            (x, y, z), scale3(n_l, dist)))))
        nw_s.append(rot9_apply(rot_sc, n_l))
    return depth_s, pw_s, nw_s


def _tm_samples(scn, samples, p_sc, rot_sc, radius, cg):
    """Per-sample closest-triangle contacts against one trimesh (a
    running best over the triangles in slices of 32, first index among
    equals as the JAX package's scan keeps it): lists of depth [W,Cg],
    world point v3, world normal v3."""
    from fyrox_tpu_torch.physics.convex import argmin_first
    from fyrox_tpu_torch.physics.scenery import closest_on_triangle
    dev = p_sc[0].device
    n_s = len(samples)
    flat = tuple(torch.cat([pt[i] for pt in samples], 1) for i in range(3))
    loc = torch.stack(rot9_apply_t(rot_sc, sub3(flat, p_sc)), -1)  # [W,N,3]
    tris = const(scn["tris"], dev)
    tmask = const(scn["tmask"], dev)
    e1, e2 = tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    ntri = _normalize3_rn(cross3(e1.unbind(-1), e2.unbind(-1)), eps=1e-12)
    ntri = torch.stack(ntri, -1)                          # [T,3]
    bd = torch.full(loc.shape[:-1], 1e9, device=dev)
    qb = torch.zeros_like(loc)
    nb = torch.zeros_like(loc)
    for t0 in range(0, tris.shape[0], 32):
        tr = tris[t0:t0 + 32]
        q = closest_on_triangle(loc[..., None, :], tr[:, 0], tr[:, 1],
                                tr[:, 2])                 # [W,N,T,3]
        d = _norm3_rn(tuple((loc[..., None, :] - q).unbind(-1)))
        d = torch.where(tmask[t0:t0 + 32], d, 1e9)
        k = argmin_first(d)[..., None]
        dk = torch.gather(d, -1, k)[..., 0]
        better = dk < bd
        bd = torch.where(better, dk, bd)
        qk = torch.gather(q, -2, k[..., None].expand(k.shape + (3,)))[..., 0, :]
        nk = ntri[t0:t0 + 32][k[..., 0]]
        qb = torch.where(better[..., None], qk, qb)
        nb = torch.where(better[..., None], nk, nb)
    qbest, nbest = qb.unbind(-1), nb.unbind(-1)
    dir_raw = sub3(loc.unbind(-1), qbest)
    side = torch.sign(dot3(dir_raw, nbest))
    side = torch.where(side == 0, 1.0, side)
    dlen = _norm3_rn(dir_raw)
    dir_l = where3(dlen > 1e-6,
                   scale3(dir_raw, 1.0 / torch.clamp(dlen, min=1e-9)),
                   scale3(nbest, side))
    rad = torch.clamp(radius, min=0.04).repeat(1, n_s)
    depth_f = rad - bd
    pw_f = add3(p_sc, rot9_apply(rot_sc, qbest))
    nw_f = rot9_apply(rot_sc, dir_l)
    cut = [slice(i * cg, (i + 1) * cg) for i in range(n_s)]
    return ([depth_f[:, sl] for sl in cut],
            [tuple(p[:, sl] for p in pw_f) for sl in cut],
            [tuple(p[:, sl] for p in nw_f) for sl in cut])


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
