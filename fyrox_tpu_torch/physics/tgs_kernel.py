"""TGS-soft contact solve (K1) on the packed per-world layout.

Replaces ``fyrox_tpu/physics/pallas_solver.py:816 solve_tgs_pallas``,
joints (up to 128) and centre-of-mass offsets included. On the card it is
``csrc/tgs_solve.cu`` (one CTA per world, walking only each world's live
slots); a CPU tensor takes ``solve_tgs_plain``, which is the same
computation in PyTorch (the semantics of ``pallas_solver.solve_planes`` and
its joint passes). Any body count runs on the card: a world whose body
planes do not fit a block's shared memory keeps them in global memory.

Layout (see csrc/tgs_solve.cu):
  con [W,15,S,Cg] f32 — n3, pt3, depth, fric, rest, act, own, sigma, lam3
  body_j [W,S,Cg] i32 — partner body of each slot
  body [W,29,B] f32 — lv3, av3, pos3, q4, acc3, inv_mass, inv_inertia9,
                      com_local3
  col_body [Cg] i32 — each grid collider's own body
  joints — JointTables: body_a, body_b [J] i32; jtab [20,J] f32 (kind,
           anchor_a3, anchor_b3, axis_a3, ref_rot4, com_a3, com_b3)
Returns body_out [W,13,B] (lv3, av3, pos3, q4) and lam [W,3,S,Cg].
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch.physics.joints import JTAB_ROWS, MAX_KERNEL_JOINTS
from fyrox_tpu_torch.physics.planes import cross3 as _cross
from fyrox_tpu_torch.physics.planes import dot3 as _dot
from fyrox_tpu_torch.physics.planes import qmul as _qmul

__all__ = ["SolverParams", "JointTables", "solver_params", "solve_tgs",
           "solve_tgs_plain", "smem_bytes", "SMEM_LIMIT", "launches",
           "reset_launches", "live_slots", "visited_slots", "CON_ROWS",
           "BODY_ROWS"]

CON_ROWS = 15
BODY_ROWS = 29
SMEM_LIMIT = 232448            # bytes of shared memory one H100 block may use
_BODY_SMEM_PLANES = 30         # 26 body planes, count, step-start COM3
_J_ERP = 0.2                   # joint velocity bias (pallas_solver._J_ERP)
_J_POS_ERP = 0.5               # joint position pass (_J_POS_ERP)
_ENT_F, _ENT_I = 18, 2         # fields of a live slot in the kernel's list
_MIN_TILE = 128                # least slot-buffer length (csrc/tgs_solve.cu)
# most slot-buffer length of the global-memory variant: the shared memory it
# leaves unused serves as L1 for the body planes
_BIG_TILE = 4096

_LAUNCHES = 0
_VISITED = None


def launches() -> int:
    return _LAUNCHES


def reset_launches():
    global _LAUNCHES
    _LAUNCHES = 0


def visited_slots():
    """The live slots per world [W] int32 that the last kernel launch built
    its list of and walked in every pass (None before the first launch)."""
    return _VISITED


def live_slots(con):
    """Live slots per world [W] of packed contact planes: act != 0 or a
    nonzero warm impulse. The kernel visits these and no others; every
    update of any other slot is an exact zero."""
    lam = con[:, 12:15]
    live = (con[:, 9] != 0) | (lam != 0).any(1)
    return live.flatten(1).sum(1, dtype=torch.int32)


class SolverParams(NamedTuple):
    h: float
    allowed: float
    max_corr: float
    rest_thr: float
    wc: float
    erp: float
    bias_rate: float
    mscale_soft: float
    iscale_soft: float
    msp: float
    n_sub: int
    n_pgs: int
    n_stab: int


class JointTables(NamedTuple):
    """The solve's static joint tables (slab2.joint_tables)."""
    body_a: torch.Tensor      # [J] int32
    body_b: torch.Tensor      # [J] int32
    jtab: torch.Tensor        # [20,J] f32


def solver_params(t, dt) -> SolverParams:
    """Soft-contact constants at substep scale (Box2D-v3 / rapier TGS-soft,
    contact_hertz 30, damping ratio 10), evaluated in float32 like the
    reference's ``_kernel_params``."""
    f = np.float32
    h = f(dt) / f(t.n_substeps)
    omega = f(2.0 * np.pi * 30.0)
    two_zeta = f(20.0)
    csoft = h * omega * (two_zeta + h * omega)
    return SolverParams(
        h=float(h), allowed=float(f(t.allowed_linear_error)),
        max_corr=float(f(t.max_corrective_velocity)),
        rest_thr=float(f(t.restitution_threshold)),
        wc=float(f(t.warmstart_coefficient)), erp=float(f(t.erp)),
        bias_rate=float(omega / (two_zeta + h * omega)),
        mscale_soft=float(csoft / (f(1.0) + csoft)),
        iscale_soft=float(f(1.0) / (f(1.0) + csoft)),
        msp=float(t.mass_split_pow), n_sub=int(t.n_substeps),
        n_pgs=int(t.n_pgs), n_stab=int(t.n_stabilization))


def _world_floats(n_bodies, n_grid_colliders, has_com):
    """The world's body planes (three more with COM offsets), per-collider
    impulse buffer and slot-list offsets, in floats."""
    planes = _BODY_SMEM_PLANES + (3 if has_com else 0)
    return planes * n_bodies + 7 * n_grid_colliders + 1


def _world_smem_floats(n_bodies, n_grid_colliders, has_com):
    """The world's planes and buffers in shared memory, with a copy of the
    body → collider CSR lists."""
    return (_world_floats(n_bodies, n_grid_colliders, has_com) + n_bodies
            + 1 + n_grid_colliders)


def smem_bytes(n_bodies: int, n_grid_colliders: int, has_com=False,
               n_joints=0, n_slots=16) -> int:
    """Least shared memory of one K1 block that holds its world: the body
    planes, the per-collider buffer, the list offsets and the CSR lists,
    with joints the joint table, its per-joint impulse buffer and the two
    body lists, and the shortest slot buffer. Above SMEM_LIMIT the world's
    planes go to global memory instead."""
    return 4 * (_world_smem_floats(n_bodies, n_grid_colliders, has_com)
                + (JTAB_ROWS + 12 + 2) * n_joints
                + 6 * max(n_slots, _MIN_TILE))


def _layout(n_bodies, n_grid_colliders, n_slots, has_com, n_joints):
    """(big, tile): whether the world's planes live in global memory, and
    the slot buffer's length in live slots, from the shapes alone; the
    slot buffer takes the shared memory that is left, up to every slot."""
    big = smem_bytes(n_bodies, n_grid_colliders, has_com, n_joints,
                     n_slots) > SMEM_LIMIT
    room = (SMEM_LIMIT // 4 - (JTAB_ROWS + 12 + 2) * n_joints
            - (0 if big else _world_smem_floats(n_bodies, n_grid_colliders,
                                                has_com)))
    least = max(n_slots, _MIN_TILE)
    if big:
        room = min(room, 6 * max(_BIG_TILE, least))
    if room // 6 < least:
        raise ValueError(
            f"solve_tgs: {n_slots} slots per collider and {n_joints} joints "
            f"leave no room for the slot buffer in {SMEM_LIMIT} B of shared "
            "memory")
    return big, min(room // 6, max(n_slots * n_grid_colliders, least))


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------

def _mv9(m, v):
    return (m[0] * v[0] + m[1] * v[1] + m[2] * v[2],
            m[3] * v[0] + m[4] * v[1] + m[5] * v[2],
            m[6] * v[0] + m[7] * v[1] + m[8] * v[2])


def _qstep(q, w, scale):
    """normalize(q + scale * (ω,0)⊗q)."""
    d = (q[3] * w[0] + w[1] * q[2] - w[2] * q[1],
         q[3] * w[1] - w[0] * q[2] + w[2] * q[0],
         q[3] * w[2] + w[0] * q[1] - w[1] * q[0],
         -w[0] * q[0] - w[1] * q[1] - w[2] * q[2])
    qn = tuple(qc + scale * dc for qc, dc in zip(q, d))
    inv = torch.rsqrt(qn[0] ** 2 + qn[1] ** 2 + qn[2] ** 2 + qn[3] ** 2
                      + 1e-30)
    return tuple(qc * inv for qc in qn)


def _jrot(q, v):
    """Rotate v by the unit quaternion q (x,y,z,w), in the kernel's
    operation order (pallas_solver._jrot)."""
    tx = 2.0 * (q[1] * v[2] - q[2] * v[1])
    ty = 2.0 * (q[2] * v[0] - q[0] * v[2])
    tz = 2.0 * (q[0] * v[1] - q[1] * v[0])
    return (v[0] + q[3] * tx + (q[1] * tz - q[2] * ty),
            v[1] + q[3] * ty + (q[2] * tx - q[0] * tz),
            v[2] + q[3] * tz + (q[0] * ty - q[1] * tx))


def _conj(q):
    return (-q[0], -q[1], -q[2], q[3])


def _skew_sandwich(r, m):
    """skew(r) @ M @ skew(r)ᵀ as 9 values (M row-major)."""
    rx, ry, rz = r
    t0 = (-rz * m[3] + ry * m[6], -rz * m[4] + ry * m[7],
          -rz * m[5] + ry * m[8])
    t1 = (rz * m[0] - rx * m[6], rz * m[1] - rx * m[7],
          rz * m[2] - rx * m[8])
    t2 = (-ry * m[0] + rx * m[3], -ry * m[1] + rx * m[4],
          -ry * m[2] + rx * m[5])

    def col(t):
        return (-rz * t[1] + ry * t[2], rz * t[0] - rx * t[2],
                -ry * t[0] + rx * t[1])

    c0, c1, c2 = col(t0), col(t1), col(t2)
    return (c0[0], c0[1], c0[2], c1[0], c1[1], c1[2], c2[0], c2[1], c2[2])


def _solve3(m, b):
    """3×3 solve through the adjugate (the kernel's, pallas_solver._solve3);
    m row-major with the +1e-9 diagonal already added."""
    c00 = m[4] * m[8] - m[5] * m[7]
    c01 = m[5] * m[6] - m[3] * m[8]
    c02 = m[3] * m[7] - m[4] * m[6]
    det = m[0] * c00 + m[1] * c01 + m[2] * c02
    inv_det = 1.0 / (det + 1e-18)
    c10 = m[2] * m[7] - m[1] * m[8]
    c11 = m[0] * m[8] - m[2] * m[6]
    c12 = m[1] * m[6] - m[0] * m[7]
    c20 = m[1] * m[5] - m[2] * m[4]
    c21 = m[2] * m[3] - m[0] * m[5]
    c22 = m[0] * m[4] - m[1] * m[3]
    return ((c00 * b[0] + c10 * b[1] + c20 * b[2]) * inv_det,
            (c01 * b[0] + c11 * b[1] + c21 * b[2]) * inv_det,
            (c02 * b[0] + c12 * b[1] + c22 * b[2]) * inv_det)


class _Joints:
    """Per-joint gathers and per-body sums of the plain joint passes."""

    def __init__(self, joints: JointTables, nb, h):
        self.ia = joints.body_a.long()
        self.ib = joints.body_b.long()
        jt = [r[None] for r in joints.jtab.unbind(0)]       # 20 × [1,J]
        self.kind = jt[0]
        self.anch_a, self.anch_b = tuple(jt[1:4]), tuple(jt[4:7])
        self.axis, self.ref = tuple(jt[7:10]), tuple(jt[10:14])
        self.com_a, self.com_b = tuple(jt[14:17]), tuple(jt[17:20])
        self.nb = nb
        # 0.2 / h in float32, as the kernel divides
        self.erp_h = float(np.float32(_J_ERP) / np.float32(h))

    @staticmethod
    def gather(planes, idx):
        return tuple(p[:, idx] for p in planes)

    def scatter(self, vals, idx):
        """[W,J] values → [W,B] sums per body, in joint order."""
        st = torch.stack(vals, 1)
        out = torch.zeros(st.shape[:2] + (self.nb,), dtype=st.dtype,
                          device=st.device)
        out.index_add_(2, idx, st)
        return out.unbind(1)

    def add(self, planes, vals_a, vals_b):
        """planes + Σ side-A deltas + Σ side-B deltas."""
        sa = self.scatter(vals_a, self.ia)
        sb = self.scatter(vals_b, self.ib)
        return tuple(p + a + b for p, a, b in zip(planes, sa, sb))

    def velocity_pass(self, lv, av, pos, q, im, ii0):
        """One Jacobi velocity pass over all joints
        (pallas_solver._joint_velocity_planes)."""
        g = self.gather
        ia, ib = self.ia, self.ib
        qa, qb = g(q, ia), g(q, ib)
        pos_a, pos_b = g(pos, ia), g(pos, ib)
        lv_a, av_a, (im_a,), ii_a = (g(lv, ia), g(av, ia), g((im,), ia),
                                     g(ii0, ia))
        lv_b, av_b, (im_b,), ii_b = (g(lv, ib), g(av, ib), g((im,), ib),
                                     g(ii0, ib))
        ra = _jrot(qa, tuple(a - c for a, c in zip(self.anch_a, self.com_a)))
        rb = _jrot(qb, tuple(a - c for a, c in zip(self.anch_b, self.com_b)))
        pa = tuple(p + r for p, r in zip(pos_a, _jrot(qa, self.anch_a)))
        pb = tuple(p + r for p, r in zip(pos_b, _jrot(qb, self.anch_b)))
        va = tuple(x + c for x, c in zip(lv_a, _cross(av_a, ra)))
        vb = tuple(x + c for x, c in zip(lv_b, _cross(av_b, rb)))
        c3 = tuple(b_ - a_ for a_, b_ in zip(pa, pb))
        axis_w0 = _jrot(qa, self.axis)
        is_prism = self.kind == 3.0
        cdot = _dot(c3, axis_w0)
        c3 = tuple(torch.where(is_prism, cc - cdot * ax, cc)
                   for cc, ax in zip(c3, axis_w0))
        verr = tuple(vb_ - va_ + self.erp_h * cc
                     for va_, vb_, cc in zip(va, vb, c3))
        vdot = _dot(verr, axis_w0)
        verr = tuple(torch.where(is_prism, ve - vdot * ax, ve)
                     for ve, ax in zip(verr, axis_w0))
        sa = _skew_sandwich(ra, ii_a)
        sb = _skew_sandwich(rb, ii_b)
        imab = im_a + im_b
        k = [x + y for x, y in zip(sa, sb)]
        for d in (0, 4, 8):
            k[d] = k[d] + imab + 1e-9
        imp = tuple(-i for i in _solve3(k, verr))
        nimp = tuple(-i for i in imp)
        lv_n, av_n = lv, av
        lv = self.add(lv_n, tuple(i * im_a for i in nimp),
                      tuple(i * im_b for i in imp))
        av = self.add(av_n, _mv9(ii_a, _cross(ra, nimp)),
                      _mv9(ii_b, _cross(rb, imp)))
        # the angular locks see the post-point angular velocities, other
        # joints' on the same body included
        av_a, av_b = g(av, ia), g(av, ib)
        rel_w = tuple(b_ - a_ for a_, b_ in zip(av_a, av_b))
        q_err = _qmul(_conj(self.ref), _qmul(_conj(qa), qb))
        sgn = torch.where(q_err[3] >= 0.0, 1.0, -1.0)
        ang_err = _jrot(qa, tuple(2.0 * e * sgn for e in q_err[:3]))
        target = tuple(rw + self.erp_h * ae for rw, ae in zip(rel_w, ang_err))
        tdot = _dot(target, axis_w0)
        t_rev = tuple(tt - tdot * ax for tt, ax in zip(target, axis_w0))
        full = (self.kind == 1.0) | (self.kind == 3.0)
        is_rev = self.kind == 2.0
        ang_t = tuple(torch.where(full, tt, torch.where(
            is_rev, tr, torch.zeros_like(tt))) for tt, tr in zip(target, t_rev))
        k_ang = [x + y for x, y in zip(ii_a, ii_b)]
        for d in (0, 4, 8):
            k_ang[d] = k_ang[d] + 1e-9
        ang_imp = tuple(-i for i in _solve3(k_ang, ang_t))
        av = self.add(av, _mv9(ii_a, tuple(-i for i in ang_imp)),
                      _mv9(ii_b, ang_imp))
        return lv, av

    def position_pass(self, pos, q, im):
        """NGS anchor-separation correction
        (pallas_solver._joint_position_planes)."""
        g = self.gather
        qa, qb = g(q, self.ia), g(q, self.ib)
        pos_a, pos_b = g(pos, self.ia), g(pos, self.ib)
        (im_a,), (im_b,) = g((im,), self.ia), g((im,), self.ib)
        ra, rb = _jrot(qa, self.anch_a), _jrot(qb, self.anch_b)
        c3 = tuple((p_b + r_b) - (p_a + r_a)
                   for p_a, r_a, p_b, r_b in zip(pos_a, ra, pos_b, rb))
        axis_w = _jrot(qa, self.axis)
        is_prism = self.kind == 3.0
        cdot = _dot(c3, axis_w)
        c3 = tuple(torch.where(is_prism, cc - cdot * ax, cc)
                   for cc, ax in zip(c3, axis_w))
        denom = torch.clamp(im_a + im_b, min=1e-9)
        corr = tuple(_J_POS_ERP * cc for cc in c3)
        return self.add(pos, tuple(cc * im_a / denom for cc in corr),
                        tuple(-cc * im_b / denom for cc in corr))


def solve_tgs_plain(con, body_j, body, col_body, p: SolverParams, *,
                    has_com=False, joints: JointTables = None):
    """The whole TGS-soft solve in PyTorch (Jacobi over contact slots,
    mass splitting, self-half impulses, optional joint passes and COM
    tracking; see module docstring)."""
    w, _, s, cg = con.shape
    nb = body.shape[2]
    dev = con.device
    n = (con[:, 0], con[:, 1], con[:, 2])                   # [W,S,Cg]
    pt = (con[:, 3], con[:, 4], con[:, 5])
    depth = con[:, 6]
    fric, rest_c, actf = con[:, 7], con[:, 8], con[:, 9]
    own = torch.clamp(con[:, 10], min=1.0)
    sigma = con[:, 11]
    lam_n, lam_t1, lam_t2 = con[:, 12], con[:, 13], con[:, 14]
    swapped = sigma < 0.0
    bj = body_j.long().reshape(w, 1, s * cg)
    cb = col_body.long()
    jp = None if joints is None else _Joints(joints, nb, p.h)

    def gather(planes):
        """[W,B] body planes → (partner [W,S,Cg], self [W,1,Cg]) lists."""
        st = torch.stack(planes, 1)                         # [W,A,B]
        a = st.shape[1]
        part = torch.gather(st, 2, bj.expand(w, a, s * cg)).view(w, a, s, cg)
        slf = st[:, :, cb][:, :, None, :]
        return ([part[:, i] for i in range(a)], [slf[:, i] for i in range(a)])

    def pick(jv, iv):
        """(side A, side B) of each slot from partner/self values."""
        return (tuple(torch.where(swapped, x, y) for x, y in zip(jv, iv)),
                tuple(torch.where(swapped, y, x) for x, y in zip(jv, iv)))

    def to_bodies(vals):
        """list of [W,S,Cg] self halves → [W,B] sums per body."""
        sums = torch.stack([v.sum(1) for v in vals], 1)      # [W,A,Cg]
        out = torch.zeros((w, len(vals), nb), dtype=sums.dtype, device=dev)
        out.index_add_(2, cb, sums)
        return [out[:, i] for i in range(len(vals))]

    lv = tuple(body[:, i] for i in range(0, 3))
    av = tuple(body[:, i] for i in range(3, 6))
    pos = tuple(body[:, i] for i in range(6, 9))
    q = tuple(body[:, i] for i in range(9, 13))
    acc = tuple(body[:, i] for i in range(13, 16))
    im = body[:, 16]
    ii0 = tuple(body[:, i] for i in range(17, 26))
    cm = tuple(body[:, i] for i in range(26, 29))

    # mass-splitting counts
    count = torch.clamp(to_bodies([actf / own])[0], min=1.0)
    if p.msp == 0.5:
        count = torch.sqrt(count)
    elif p.msp != 1.0:
        count = count ** p.msp

    # lever arms measure from the step-start world centre of mass
    com_w0 = (tuple(x + r for x, r in zip(pos, _jrot(q, cm))) if has_com
              else pos)
    jg, ig = gather([im, count] + list(com_w0) + list(ii0))
    (im_a,), (im_b,) = pick(jg[0:1], ig[0:1])
    (cnt_a,), (cnt_b,) = pick(jg[1:2], ig[1:2])
    cnt_a, cnt_b = cnt_a * own, cnt_b * own
    com_a, com_b = pick(jg[2:5], ig[2:5])
    ii_a, ii_b = pick(jg[5:14], ig[5:14])
    im_s = ig[0]
    r_a = tuple(x - c for x, c in zip(pt, com_a))
    r_b = tuple(x - c for x, c in zip(pt, com_b))
    r_s = tuple(x - c for x, c in zip(pt, ig[2:5]))

    sgn = torch.where(n[2] >= 0.0, 1.0, -1.0)
    a_t = -1.0 / (sgn + n[2])
    b_t = n[0] * n[1] * a_t
    t1 = (1.0 + sgn * n[0] * n[0] * a_t, sgn * b_t, -sgn * n[0])
    t2 = (b_t, sgn + n[1] * n[1] * a_t, -n[1])

    def eff_mass(d):
        xa, xb = _cross(r_a, d), _cross(r_b, d)
        k = (im_a * cnt_a + im_b * cnt_b + cnt_a * _dot(xa, _mv9(ii_a, xa))
             + cnt_b * _dot(xb, _mv9(ii_b, xb)))
        return 1.0 / torch.clamp(k, min=1e-12)

    m_n, m_t1, m_t2 = eff_mass(n), eff_mass(t1), eff_mass(t2)

    def rel(lin, ang):
        jv, iv = gather(list(lin) + list(ang))
        la, lb = pick(jv[0:3], iv[0:3])
        aa, ab = pick(jv[3:6], iv[3:6])
        ca, cbv = _cross(aa, r_a), _cross(ab, r_b)
        return tuple((lb[d] + cbv[d]) - (la[d] + ca[d]) for d in range(3))

    def impulse_sums(imp):
        imp_s = tuple(-sigma * x for x in imp)
        sums = to_bodies([x * im_s for x in imp_s]
                         + list(_cross(r_s, imp_s)))
        return sums[0:3], _mv9(ii0, sums[3:6])

    def apply_imp(lv, av, imp):
        dl, da = impulse_sums(imp)
        return (tuple(x + d for x, d in zip(lv, dl)),
                tuple(x + d for x, d in zip(av, da)))

    v0n = _dot(rel(lv, av), n)
    rest_t = torch.where(v0n < -p.rest_thr, -rest_c * v0n,
                         torch.zeros_like(v0n))
    lam_mx = torch.zeros_like(lam_n)

    for _ in range(p.n_sub):
        lv = tuple(x + p.h * a for x, a in zip(lv, acc))
        if jp is not None:
            lv, av = jp.velocity_pass(lv, av, pos, q, im, ii0)
        lam_n, lam_t1, lam_t2 = lam_n * p.wc, lam_t1 * p.wc, lam_t2 * p.wc
        lv, av = apply_imp(lv, av, tuple(
            lam_n * a + lam_t1 * b + lam_t2 * c for a, b, c in zip(n, t1, t2)))
        sep = -(depth - p.allowed)
        pos_sep = sep > 0.0
        bias = torch.where(pos_sep, sep / p.h,
                           torch.clamp(p.bias_rate * sep, min=-p.max_corr))
        mscale = torch.where(pos_sep, 1.0, p.mscale_soft)
        iscale = torch.where(pos_sep, 0.0, p.iscale_soft)
        for _ in range(p.n_pgs):
            rv = rel(lv, av)
            vn = _dot(rv, n)
            dl = (-m_n * mscale * (vn + bias) - iscale * lam_n) * actf
            new_n = torch.clamp(lam_n + dl, min=0.0)
            vn2 = vn + (new_n - lam_n) / torch.clamp(m_n, min=1e-12)
            spec = torch.where(pos_sep, bias, torch.zeros_like(bias))
            new_n2 = torch.clamp(new_n - m_n * (vn2 + spec) * actf, min=0.0)
            dn = new_n2 - lam_n
            lam_n = new_n2
            max_f = fric * lam_n
            new1 = torch.minimum(torch.maximum(
                lam_t1 - m_t1 * _dot(rv, t1) * actf, -max_f), max_f)
            new2 = torch.minimum(torch.maximum(
                lam_t2 - m_t2 * _dot(rv, t2) * actf, -max_f), max_f)
            d1, d2 = new1 - lam_t1, new2 - lam_t2
            lam_t1, lam_t2 = new1, new2
            lv, av = apply_imp(lv, av, tuple(
                dn * a + d1 * b + d2 * c for a, b, c in zip(n, t1, t2)))
        lam_mx = torch.maximum(lam_mx, lam_n)
        depth = depth - p.h * _dot(rel(lv, av), n)
        q_new = _qstep(q, av, 0.5 * p.h)
        if has_com:
            # the COM moves linearly; the origin follows the new orientation
            com = tuple(x + r + p.h * v
                        for x, r, v in zip(pos, _jrot(q, cm), lv))
            pos = tuple(c - r for c, r in zip(com, _jrot(q_new, cm)))
        else:
            pos = tuple(x + p.h * v for x, v in zip(pos, lv))
        q = q_new

    if jp is not None:
        for _ in range(p.n_stab):
            pos = jp.position_pass(pos, q, im)

    vn = _dot(rel(lv, av), n)
    dl = (torch.clamp(-m_n * (vn - rest_t), min=0.0) * actf
          * (lam_mx > 0.0).to(actf.dtype))
    lv, av = apply_imp(lv, av, tuple(dl * x for x in n))
    lam_n = lam_n + dl

    for _ in range(p.n_stab):
        corr = p.erp * torch.clamp(depth - p.allowed, min=0.0)
        p_imp = m_n * corr * actf
        dpos, dth = impulse_sums(tuple(p_imp * x for x in n))
        pos = tuple(x + d for x, d in zip(pos, dpos))
        if has_com:
            # rotating about the COM shifts the origin by dθ × (−R(q)·cm)
            arm = tuple(-r for r in _jrot(q, cm))
            pos = tuple(x + d for x, d in zip(pos, _cross(dth, arm)))
        q = _qstep(q, dth, 0.5)
        depth = depth - _dot(rel(dpos, dth), n)

    body_out = torch.stack(list(lv) + list(av) + list(pos) + list(q), 1)
    return body_out, torch.stack([lam_n, lam_t1, lam_t2], 1)


# --------------------------------------------------------------------------
# kernel wrapper
# --------------------------------------------------------------------------

_CSR_CACHE: dict = {}


def _csr(col_body: torch.Tensor, n_bodies: int):
    """Body → rows CSR lists (ascending row order) of an index vector:
    each body's grid colliders, or each body's joints on one side."""
    key = (col_body.data_ptr(), n_bodies, str(col_body.device))
    hit = _CSR_CACHE.get(key)
    if hit is not None and hit[0] is col_body:
        return hit[1], hit[2]
    cb = col_body.cpu().numpy().astype(np.int64)
    order = np.argsort(cb, kind="stable").astype(np.int32)
    ptr = np.zeros(n_bodies + 1, np.int32)
    np.add.at(ptr, cb + 1, 1)
    ptr = np.cumsum(ptr).astype(np.int32)
    ptr_t = torch.as_tensor(ptr, device=col_body.device)
    col_t = torch.as_tensor(order, device=col_body.device)
    _CSR_CACHE[key] = (col_body, ptr_t, col_t)
    return ptr_t, col_t


def _check(name, t, device, dtype):
    """Raise unless t is on `device` (the dispatching tensor's card),
    contiguous, with the dtype the kernel takes."""
    if t.device != device:
        raise ValueError(f"solve_tgs: {name} must be on {device}")
    if not t.is_contiguous():
        raise ValueError(f"solve_tgs: {name} must be contiguous")
    if t.dtype != dtype:
        raise TypeError(f"solve_tgs: {name} must be {dtype}")


def _solve_tgs_cuda(con, body_j, body, col_body, p: SolverParams, has_com,
                    joints):
    from fyrox_tpu_torch import kernels
    global _LAUNCHES, _VISITED
    dev = con.device
    for name, t, dtype in (("con", con, torch.float32),
                           ("body_j", body_j, torch.int32),
                           ("body", body, torch.float32),
                           ("col_body", col_body, torch.int32)):
        _check(name, t, dev, dtype)
    w, rows, s, cg = con.shape
    nb = body.shape[2]
    if (rows != CON_ROWS or tuple(body_j.shape) != (w, s, cg)
            or tuple(body.shape) != (w, BODY_ROWS, nb)
            or tuple(col_body.shape) != (cg,)):
        raise ValueError(
            f"solve_tgs: shapes con {tuple(con.shape)}, body_j "
            f"{tuple(body_j.shape)}, body {tuple(body.shape)}, col_body "
            f"{tuple(col_body.shape)} do not match the packed layout")
    nj = 0
    jptrs = [None] * 7
    if joints is not None:
        nj = int(joints.body_a.shape[0])
        _check("joints.body_a", joints.body_a, dev, torch.int32)
        _check("joints.body_b", joints.body_b, dev, torch.int32)
        _check("joints.jtab", joints.jtab, dev, torch.float32)
        if (tuple(joints.body_b.shape) != (nj,)
                or tuple(joints.jtab.shape) != (JTAB_ROWS, nj)):
            raise ValueError("solve_tgs: joint tables do not match "
                             "body_a [J], body_b [J], jtab [20,J]")
        ptr_a, col_a = _csr(joints.body_a, nb)
        ptr_b, col_b = _csr(joints.body_b, nb)
        jptrs = [x.data_ptr() for x in (joints.jtab, joints.body_a,
                                        joints.body_b, ptr_a, col_a, ptr_b,
                                        col_b)]
    big, tile = _layout(nb, cg, s, has_com, nj)
    ptr, col = _csr(col_body, nb)
    body_out = torch.empty((w, 13, nb), dtype=torch.float32, device=dev)
    lam = torch.empty((w, 3, s, cg), dtype=torch.float32, device=dev)
    ent_f = torch.empty((w, _ENT_F, s * cg), dtype=torch.float32, device=dev)
    ent_i = torch.empty((w, _ENT_I, s * cg), dtype=torch.int32, device=dev)
    masks = torch.empty((w, cg * ((s + 31) // 32)), dtype=torch.int32,
                        device=dev)
    visited = torch.empty((w,), dtype=torch.int32, device=dev)
    gws = (torch.empty((w, _world_floats(nb, cg, has_com)),
                       dtype=torch.float32, device=dev) if big else None)
    lib = kernels.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fyrox_tgs_solve(
        con.data_ptr(), body_j.data_ptr(), body.data_ptr(),
        col_body.data_ptr(), ptr.data_ptr(), col.data_ptr(),
        body_out.data_ptr(), lam.data_ptr(), ent_f.data_ptr(),
        ent_i.data_ptr(), masks.data_ptr(), visited.data_ptr(),
        None if gws is None else gws.data_ptr(), *jptrs,
        w, s, cg, nb, nj, int(bool(has_com)), int(big), tile, p.n_sub,
        p.n_pgs, p.n_stab, p.h, p.allowed, p.max_corr, p.rest_thr, p.wc,
        p.erp, p.bias_rate, p.mscale_soft, p.iscale_soft, p.msp, stream)
    kernels.check(err, "fyrox_tgs_solve")
    _LAUNCHES += 1
    _VISITED = visited
    return body_out, lam


def solve_tgs(con, body_j, body, col_body, p: SolverParams, *,
              has_com=False, joints: JointTables = None):
    """Dispatch: CPU tensors → plain version; CUDA tensors → the kernel.
    Joint sets above the kernel's 128 joints raise on both (the JAX
    package's XLA joint passes for them are not ported)."""
    if joints is not None and joints.body_a.shape[0] > MAX_KERNEL_JOINTS:
        raise NotImplementedError(
            f"{joints.body_a.shape[0]} joints: the TGS kernel holds at most "
            f"{MAX_KERNEL_JOINTS}; larger sets take the JAX package's XLA "
            "joint passes (joints.solve_joints_velocity / "
            "joint_position_pass), which are not ported yet")
    if con.is_cuda:
        return _solve_tgs_cuda(con, body_j, body, col_body, p, has_com,
                               joints)
    return solve_tgs_plain(con, body_j, body, col_body, p, has_com=has_com,
                           joints=joints)
