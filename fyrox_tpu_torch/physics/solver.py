"""Batched TGS-soft contact solver of the dense and grid broadphase paths:
the port of ``fyrox_tpu/physics/solver.py`` ``solve_tgs`` and, over the
grid broadphase's directed segments, ``solve_tgs_directed``.

rapier's ``num_solver_iterations = 4`` small steps (substeps) with one PGS
velocity pass each, then ``num_internal_stabilization_iterations = 4``
position passes (fyrox-impl scene/graph/physics/mod.rs:830-908), solved as
dense Jacobi with mass splitting: each body's inverse mass and inertia are
scaled by its contact count (count^mass_split_pow across distinct pairs,
fully over a manifold's own points). Per substep h = dt / n_substeps:

  1. integrate the external acceleration (then the joint velocity pass);
  2. warm start: apply the stored per-substep impulses;
  3. one combined PGS pass per contact point: soft normal (contact spring),
     hard relax, friction pyramid, one impulse application;
  4. integrate positions, advance the tracked penetration.

Then the restitution pass (target -e·v0n, add-only, gated on the max λ
over substeps), the joint position passes and NGS position stabilisation.

Contact → body traffic. The JAX package ran its gathers and scatters as
one-hot incidence matmuls on the TPU's matrix unit. Here every gather is
one K4a ``plane_gather`` launch (``plane_ops.gather_rows``) over the a-side
indices followed by the b-side ones, with the attributes a pass needs
gathered together, and every scatter one K4b ``plane_scatter`` launch
(``plane_ops.scatter_rows``) of the a-side and b-side rows concatenated
along k, linear impulse and torque as 6 attribute rows. K4b sums in
ascending k without float atomics, so a tick repeats bit for bit (a CUDA
graph replay equals an eager tick). A CPU tensor takes the plain versions.
The JAX package adds the a-side sum and then the b-side sum; the single
ascending sum rounds differently at the ulp level.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from fyrox_tpu_torch._util import const
from fyrox_tpu_torch.core import quat
from fyrox_tpu_torch.physics.plane_ops import gather_rows, scatter_rows

__all__ = ["SolverParams", "ContactBatch", "solve_tgs", "DirectedSeg",
           "segment_bounds", "solve_tgs_directed"]


class SolverParams(NamedTuple):
    dt: float
    erp: float = 0.2                       # NGS stabilisation factor
    allowed_linear_error: float = 0.002    # physics/mod.rs:849
    max_corrective_velocity: float = 10.0  # :853
    restitution_threshold: float = 1.0
    n_substeps: int = 4                    # num_solver_iterations (:892)
    n_pgs: int = 1                         # num_internal_pgs_iterations
    n_stabilization: int = 4               # stabilisation iterations
    stabilization_erp: float = 0.2
    warmstart_coefficient: float = 1.0     # physics/mod.rs:877
    # soft contact spring (rapier contact_natural_frequency equivalents)
    contact_hertz: float = 30.0
    contact_damping_ratio: float = 10.0
    # Jacobi mass-splitting exponent across distinct pairs (0.5: sqrt
    # splitting, fyrox_tpu.physics.solver.SolverParams)
    mass_split_pow: float = 0.5


class ContactBatch(NamedTuple):
    """Flattened contact points [W,K].

    index: [W,2K] int32 contiguous, the body of each slot's A side, then
    of each slot's B side (the gather and scatter index). own_pts: [K] host
    array, the manifold size of each slot's own pair (None: 4)."""
    index: torch.Tensor
    normal: torch.Tensor      # [W,K,3] A→B
    point: torch.Tensor       # [W,K,3]
    depth: torch.Tensor       # [W,K]
    friction: torch.Tensor    # [W,K] or [K]
    restitution: torch.Tensor
    active: torch.Tensor      # [W,K] bool
    own_pts: Optional[np.ndarray] = None


def _orthonormal_tangents(n):
    """Two unit tangents orthogonal to n (branch-free Pixar ONB)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t1 = torch.stack([1.0 + sign * n[..., 0] ** 2 * a, sign * b,
                      -sign * n[..., 0]], -1)
    t2 = torch.stack([b, sign + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    return t1, t2


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _make_ops(contacts: ContactBatch, n_bodies: int):
    """(gath, scat) over the batch's contact → body index.

    gath(x [W,B,D]) → (x at body_a, x at body_b), each [W,K,D]: one K4a
    launch. scat(val_a, val_b) [W,K,D] each → [W,B,D], the sums of val_a
    into body_a and val_b into body_b: one K4b launch."""
    idx = contacts.index
    k = idx.shape[1] // 2

    def gath(x):
        g = gather_rows(x, idx)
        return g[:, :k], g[:, k:]

    def scat(val_a, val_b):
        return scatter_rows(torch.cat([val_a, val_b], 1), idx, n_bodies)

    return gath, scat


def solve_tgs(position, rotation, linvel, angvel, com_local, inv_mass,
              inv_inertia_local, gravity_accel, contacts, params:
              SolverParams, warm=None, joints=None):
    """TGS substepped solve + integrate. com_local [B,3] and
    inv_inertia_local [B,3,3] are the template's host arrays; inv_mass
    [W,B]. Returns (pos, rot, linvel, angvel, (λn, λt1, λt2) or None)."""
    from fyrox_tpu_torch.physics import joints as joints_mod
    eps = 1e-12
    dev = position.device
    dtype = position.dtype
    h = params.dt / params.n_substeps
    w, b = position.shape[:2]
    has_contacts = contacts is not None
    has_joints = joints is not None and joints.num_joints > 0
    # the translation state is the body ORIGIN and linvel the COM velocity;
    # where every COM offset is zero the conversion is skipped
    has_com_offset = bool(np.any(com_local))
    com_b = const(com_local, dev)[None].expand(w, b, 3)
    ii_w0 = quat.sandwich_inv_inertia(quat.to_mat3(rotation),
                                      const(inv_inertia_local, dev))

    if has_contacts:
        gath, scat = _make_ops(contacts, b)
        actf = contacts.active.to(dtype)
        n = contacts.normal
        t1, t2 = _orthonormal_tangents(n)
        own = (const(contacts.own_pts, dev) if contacts.own_pts is not None
               else 4.0)
        per_slot = (actf / own)[..., None]
        count = scat(per_slot, per_slot)[..., 0]
        count = torch.clamp(count, min=1.0)
        if params.mass_split_pow != 1.0:
            count = count ** params.mass_split_pow
        com_w0 = position + quat.rotate(rotation, com_b)
        # one gather of everything the prep reads: count | inv_mass | COM |
        # linvel | angvel | world inverse inertia
        ga, gb = gath(torch.cat([count[..., None], inv_mass[..., None],
                                 com_w0, linvel, angvel,
                                 ii_w0.reshape(w, b, 9)], -1))
        cnt_a = ga[..., 0] * own
        cnt_b = gb[..., 0] * own
        im_a_raw = ga[..., 1]
        im_b_raw = gb[..., 1]
        r_a = contacts.point - ga[..., 2:5]
        r_b = contacts.point - gb[..., 2:5]
        # restitution target from the pre-step approach velocity
        va0 = ga[..., 5:8] + _cross(ga[..., 8:11], r_a)
        vb0 = gb[..., 5:8] + _cross(gb[..., 8:11], r_b)
        v0n = torch.sum((vb0 - va0) * n, -1)
        rest_target = torch.where(v0n < -params.restitution_threshold,
                                  -contacts.restitution * v0n, 0.0)
        if warm is None:
            zk = torch.zeros_like(contacts.depth)
            lam_n, lam_t1, lam_t2 = zk, zk, zk
        else:
            lam_n, lam_t1, lam_t2 = (v * actf for v in warm)
        kk = n.shape[1]
        ii_a_k = ga[..., 11:20].reshape(w, kk, 3, 3)
        ii_b_k = gb[..., 11:20].reshape(w, kk, 3, 3)

        def eff_mass(d):
            rxd_a = _cross(r_a, d)
            rxd_b = _cross(r_b, d)
            k_ = (im_a_raw * cnt_a + im_b_raw * cnt_b
                  + cnt_a * torch.sum(rxd_a * quat.mv(ii_a_k, rxd_a), -1)
                  + cnt_b * torch.sum(rxd_b * quat.mv(ii_b_k, rxd_b), -1))
            return 1.0 / torch.clamp(k_, min=eps)

        m_n, m_t1, m_t2 = eff_mass(n), eff_mass(t1), eff_mass(t2)

        def rel_vel(lv_, av_):
            va, vb = gath(torch.cat([lv_, av_], -1))
            return ((vb[..., :3] + _cross(vb[..., 3:], r_b))
                    - (va[..., :3] + _cross(va[..., 3:], r_a)))

        def body_sums(imp):
            """Per body: Σ linear impulse / mass and Σ torque of the
            slots' impulses imp [W,K,3] (A takes -imp, B +imp): [W,B,6]."""
            return scat(torch.cat([-imp * im_a_raw[..., None],
                                   _cross(r_a, -imp)], -1),
                        torch.cat([imp * im_b_raw[..., None],
                                   _cross(r_b, imp)], -1))

        def apply_imp(lv_, av_, imp):
            s = body_sums(imp)
            return lv_ + s[..., :3], av_ + quat.mv(ii_w0, s[..., 3:])

        # soft-spring coefficients at substep scale
        omega = 2.0 * np.pi * params.contact_hertz
        zeta = params.contact_damping_ratio
        csoft = h * omega * (2.0 * zeta + h * omega)
        bias_rate = omega / (2.0 * zeta + h * omega)
        mass_scale_soft = csoft / (1.0 + csoft)
        imp_scale_soft = 1.0 / (1.0 + csoft)
        depth_cur = contacts.depth
        lam_mx = torch.zeros_like(lam_n)

    pos, rot, lv, av = position, rotation, linvel, angvel
    for _ in range(params.n_substeps):
        lv = lv + h * gravity_accel
        if has_joints:
            lv, av = joints_mod.solve_joints_velocity(
                pos, rot, lv, av, inv_mass, ii_w0, joints, h)
        if has_contacts:
            wc = params.warmstart_coefficient
            lam_n, lam_t1, lam_t2 = lam_n * wc, lam_t1 * wc, lam_t2 * wc
            lv, av = apply_imp(lv, av, lam_n[..., None] * n
                               + lam_t1[..., None] * t1
                               + lam_t2[..., None] * t2)
            sep = -(depth_cur - params.allowed_linear_error)
            bias = torch.where(sep > 0.0, sep / h, torch.clamp(
                bias_rate * sep, min=-params.max_corrective_velocity))
            mscale = torch.where(sep > 0.0, 1.0, mass_scale_soft)
            iscale = torch.where(sep > 0.0, 0.0, imp_scale_soft)
            for _pgs in range(params.n_pgs):
                rv = rel_vel(lv, av)
                vn = torch.sum(rv * n, -1)
                dl = (-m_n * mscale * (vn + bias) - iscale * lam_n) * actf
                new_n = torch.clamp(lam_n + dl, min=0.0)
                vn2 = vn + (new_n - lam_n) / m_n
                # hard relax → vn = 0 for touching contacts; separated
                # (speculative) ones keep the sep/h approach limit
                spec = torch.where(sep > 0.0, bias, 0.0)
                dl2 = -m_n * (vn2 + spec) * actf
                new_n2 = torch.clamp(new_n + dl2, min=0.0)
                dn = new_n2 - lam_n
                lam_n = new_n2
                max_f = contacts.friction * lam_n
                vt1 = torch.sum(rv * t1, -1)
                new1 = torch.clamp(lam_t1 - m_t1 * vt1 * actf, -max_f, max_f)
                dt1 = new1 - lam_t1
                lam_t1 = new1
                vt2 = torch.sum(rv * t2, -1)
                new2 = torch.clamp(lam_t2 - m_t2 * vt2 * actf, -max_f, max_f)
                dt2 = new2 - lam_t2
                lam_t2 = new2
                lv, av = apply_imp(lv, av, dn[..., None] * n
                                   + dt1[..., None] * t1
                                   + dt2[..., None] * t2)
            lam_mx = torch.maximum(lam_mx, lam_n)
            vn_end = torch.sum(rel_vel(lv, av) * n, -1)
            depth_cur = depth_cur - h * vn_end
        dq = 0.5 * h * quat.mul(torch.cat([av, torch.zeros_like(av[..., :1])],
                                          -1), rot)
        new_rot = quat.normalize(rot + dq)
        if has_com_offset:
            com = pos + quat.rotate(rot, com_b) + h * lv
            pos = com - quat.rotate(new_rot, com_b)
        else:
            pos = pos + h * lv
        rot = new_rot

    if has_joints:
        for _ in range(params.n_stabilization):
            pos = joints_mod.joint_position_pass(pos, rot, inv_mass, joints)

    if not has_contacts:
        return pos, rot, lv, av, None

    # ---- restitution: one add-only impulse so the separating velocity
    # reaches -e·v0n, gated on the max λ over substeps ----
    vn = torch.sum(rel_vel(lv, av) * n, -1)
    dl = (torch.clamp(-m_n * (vn - rest_target), min=0.0) * actf
          * (lam_mx > 0.0))
    lv, av = apply_imp(lv, av, dl[..., None] * n)
    lam_n = lam_n + dl

    # ---- NGS position stabilisation ----
    depth_ = depth_cur
    for i in range(params.n_stabilization):
        corr = params.stabilization_erp * torch.clamp(
            depth_ - params.allowed_linear_error, min=0.0)
        s = body_sums((m_n * corr * actf)[..., None] * n)
        dpos = s[..., :3]
        dtheta = quat.mv(ii_w0, s[..., 3:])
        pos = pos + dpos
        if has_com_offset:
            # NGS rotates about the COM; the origin sits at -com_off from it
            pos = pos + _cross(dtheta, -quat.rotate(rot, com_b))
        dq = 0.5 * quat.mul(torch.cat([dtheta,
                                       torch.zeros_like(dtheta[..., :1])],
                                      -1), rot)
        rot = quat.normalize(rot + dq)
        if i == params.n_stabilization - 1:
            break                  # the last pass's depths are not read
        da, db = gath(torch.cat([dpos, dtheta], -1))
        rel_corr = ((db[..., :3] + _cross(db[..., 3:], r_b))
                    - (da[..., :3] + _cross(da[..., 3:], r_a)))
        depth_ = depth_ - torch.sum(rel_corr * n, -1)
    return pos, rot, lv, av, (lam_n, lam_t1, lam_t2)


# --------------------------------------------------------------------------
# directed segments: the grid broadphase's solver
# (fyrox_tpu/physics/solver.py:205-598)
# --------------------------------------------------------------------------

class DirectedSeg(NamedTuple):
    """One manifold class's compacted DIRECTED contact segment from the
    grid broadphase, [W,P] pairs of n points each.

    Each physical pair appears twice, once from each body's scan, and the
    twin slots hold the same canonical manifold; the solver applies only
    each slot's *self* half of the impulse, so Newton's third law holds
    exactly and every scatter is a windowed segment sum over `body_self`,
    which ascends within a row (the slots follow the scanning colliders,
    which the builder orders by body)."""
    body_a: torch.Tensor      # [W,P] canonical A body (normal points A→B)
    body_b: torch.Tensor      # [W,P]
    sigma: torch.Tensor       # [W,P] +1 where self is A, else -1
    body_self: torch.Tensor   # [W,P] scanning body
    bounds: torch.Tensor      # [W,B+1] searchsorted(body_self, arange(B+1))
    normal: torch.Tensor      # [W,P,3] canonical A→B
    point: torch.Tensor       # [W,P,n,3]
    depth: torch.Tensor       # [W,P,n]
    active: torch.Tensor      # [W,P,n] bool
    friction: torch.Tensor    # [W,P]
    restitution: torch.Tensor  # [W,P]
    window: int               # Mw: the pairs a body's sum takes, at most


def segment_bounds(body_self, num_bodies):
    """[W,B+1] start offset of each body's run in the sorted body_self."""
    w = body_self.shape[0]
    q = torch.arange(num_bodies + 1, dtype=body_self.dtype,
                     device=body_self.device)[None].expand(w, -1)
    return torch.searchsorted(body_self.contiguous(), q.contiguous())


def _seg_ops(seg: DirectedSeg, n_bodies: int):
    """(gath, scat) of a directed segment.

    gath(x [W,B,D]) → (x at body_a, x at body_b), each [W,P,D]: one K4a
    launch over the a-side then the b-side indices. scat(vals [W,P,D]) →
    [W,B,D], the windowed segment sum (the JAX package's _seg_scatter):
    body b sums the rows bounds[b] .. bounds[b] + window - 1 that lie
    before bounds[b+1]; a row past its body's window drops (index -1 in
    one K4b launch, which sums each body's rows in ascending order)."""
    p = seg.body_a.shape[1]
    idx = torch.cat([seg.body_a, seg.body_b], 1).to(torch.int32).contiguous()
    rows = torch.arange(p, device=idx.device)[None].expand(
        idx.shape[0], p).contiguous()
    # the body whose run [bounds[b], bounds[b+1]) holds each row
    row_body = torch.searchsorted(seg.bounds[:, 1:].contiguous(), rows,
                                  right=True)
    start = torch.gather(seg.bounds, 1, torch.clamp(row_body, max=n_bodies))
    keep = (row_body < n_bodies) & (rows - start < seg.window)
    sidx = torch.where(keep, row_body, torch.full_like(row_body, -1)).to(
        torch.int32)

    def gath(x):
        g = gather_rows(x, idx)
        return g[:, :p], g[:, p:]

    def scat(vals):
        return scatter_rows(vals, sidx, n_bodies)

    return gath, scat


def solve_tgs_directed(position, rotation, linvel, angvel, com_local,
                       inv_mass, inv_inertia_local, gravity_accel, segs,
                       params: SolverParams, warm=None, joints=None):
    """TGS substepped solve over directed contact segments (the grid
    broadphase's path): solve_tgs's semantics, every gather at pair
    granularity (K4a) and every scatter a windowed segment sum (K4b), one
    launch a segment. com_local [B,3] and inv_inertia_local [B,3,3] are the
    template's host arrays, inv_mass [W,B].

    warm: None, or per segment (λn, λt1, λt2) [W,P,n] (already masked to
    the slots still holding the same pair). Returns (pos, rot, linvel,
    angvel, per-segment (λn, λt1, λt2) list)."""
    from fyrox_tpu_torch.physics import joints as joints_mod
    eps = 1e-12
    dev = position.device
    dtype = position.dtype
    h = params.dt / params.n_substeps
    w, b = position.shape[:2]
    segs = [s for s in segs if s.body_a.shape[1] > 0]
    has_contacts = len(segs) > 0
    has_joints = joints is not None and joints.num_joints > 0
    has_com_offset = bool(np.any(com_local))
    com_b = const(com_local, dev)[None].expand(w, b, 3)
    ii_w0 = quat.sandwich_inv_inertia(quat.to_mat3(rotation),
                                      const(inv_inertia_local, dev))
    ops = [_seg_ops(s, b) for s in segs]

    def n_pts(seg):
        return float(seg.active.shape[2])

    preps = []
    if has_contacts:
        # mass splitting: per body the active PAIRS (a manifold's own
        # points split fully through the n factor), count^pow
        count = None
        for seg, (_, scat) in zip(segs, ops):
            actp = (torch.sum(seg.active.to(dtype), dim=2) / n_pts(seg))
            c = scat(actp[..., None])[..., 0]
            count = c if count is None else count + c
        count = torch.clamp(count, min=1.0)
        if params.mass_split_pow != 1.0:
            count = count ** params.mass_split_pow
        com_w0 = position + quat.rotate(rotation, com_b)
        # one gather of the prep's attributes a side: imass | count | com
        # | world inverse inertia
        body14 = torch.cat([inv_mass[..., None], count[..., None], com_w0,
                            ii_w0.reshape(w, b, 9)], -1)
        for seg, (gath, _) in zip(segs, ops):
            pa, pb = gath(body14)
            n = seg.normal
            t1, t2 = _orthonormal_tangents(n)
            own = n_pts(seg)
            im_a, im_b = pa[..., 0], pb[..., 0]
            cnt_a, cnt_b = pa[..., 1] * own, pb[..., 1] * own
            self_a = seg.sigma > 0
            r_a = seg.point - pa[:, :, None, 2:5]               # [W,P,n,3]
            r_b = seg.point - pb[:, :, None, 2:5]
            kk = n.shape[1]
            ii_a = pa[..., 5:14].reshape(w, kk, 1, 3, 3)
            ii_b = pb[..., 5:14].reshape(w, kk, 1, 3, 3)

            def eff_mass(d, r_a=r_a, r_b=r_b, ii_a=ii_a, ii_b=ii_b,
                         im_a=im_a, im_b=im_b, cnt_a=cnt_a, cnt_b=cnt_b):
                rxd_a = _cross(r_a, d)
                rxd_b = _cross(r_b, d)
                k_ = ((im_a * cnt_a + im_b * cnt_b)[..., None]
                      + cnt_a[..., None] * torch.sum(
                          rxd_a * quat.mv(ii_a, rxd_a), -1)
                      + cnt_b[..., None] * torch.sum(
                          rxd_b * quat.mv(ii_b, rxd_b), -1))
                return 1.0 / torch.clamp(k_, min=eps)

            preps.append(dict(
                n3=n[:, :, None, :], t1=t1[:, :, None, :],
                t2=t2[:, :, None, :], actf=seg.active.to(dtype),
                im_s=torch.where(self_a, im_a, im_b),
                r_a=r_a, r_b=r_b,
                r_s=torch.where(self_a[..., None, None], r_a, r_b),
                sgn=-seg.sigma[..., None, None],
                m_n=eff_mass(n[:, :, None, :]),
                m_t1=eff_mass(t1[:, :, None, :]),
                m_t2=eff_mass(t2[:, :, None, :])))

    def rel_vel(k, lv_, av_):
        """[W,P,n,3] relative velocity at each point of segment k."""
        p = preps[k]
        va, vb = ops[k][0](torch.cat([lv_, av_], -1))
        return ((vb[..., None, :3] + _cross(vb[..., None, 3:], p["r_b"]))
                - (va[..., None, :3] + _cross(va[..., None, 3:], p["r_a"])))

    def self_sums(imps):
        """Per body [W,B,6]: Σ linear impulse / mass and Σ torque of the
        SELF halves of imps (per segment [W,P,n,3], A-convention: -imp to
        A, +imp to B)."""
        total = None
        for (_, scat), p, imp in zip(ops, preps, imps):
            imp_s = p["sgn"] * imp
            both = torch.cat([torch.sum(imp_s, dim=2) * p["im_s"][..., None],
                              torch.sum(_cross(p["r_s"], imp_s), dim=2)], -1)
            sc = scat(both)
            total = sc if total is None else total + sc
        return total

    def apply_all(lv_, av_, imps):
        s = self_sums(imps)
        return lv_ + s[..., :3], av_ + quat.mv(ii_w0, s[..., 3:])

    rest_targets = []
    for k, seg in enumerate(segs):
        v0n = torch.sum(rel_vel(k, linvel, angvel) * preps[k]["n3"], -1)
        rest_targets.append(torch.where(
            v0n < -params.restitution_threshold,
            -seg.restitution[..., None] * v0n, torch.zeros_like(v0n)))
    if warm is None:
        lams = [tuple(torch.zeros_like(s.depth) for _ in range(3))
                for s in segs]
    else:
        lams = [tuple(v * p["actf"] for v in wm)
                for wm, p in zip(warm, preps)]

    # soft-spring coefficients at substep scale
    omega = 2.0 * np.pi * params.contact_hertz
    zeta = params.contact_damping_ratio
    csoft = h * omega * (2.0 * zeta + h * omega)
    bias_rate = omega / (2.0 * zeta + h * omega)
    mass_scale_soft = csoft / (1.0 + csoft)
    imp_scale_soft = 1.0 / (1.0 + csoft)

    pos, rot, lv, av = position, rotation, linvel, angvel
    depths = [s.depth for s in segs]
    lam_mxs = [torch.zeros_like(s.depth) for s in segs]
    for _ in range(params.n_substeps):
        lv = lv + h * gravity_accel
        if has_joints:
            lv, av = joints_mod.solve_joints_velocity(
                pos, rot, lv, av, inv_mass, ii_w0, joints, h)
        if has_contacts:
            wc = params.warmstart_coefficient
            lams = [tuple(x * wc for x in lam) for lam in lams]
            lv, av = apply_all(lv, av, [
                lam[0][..., None] * p["n3"] + lam[1][..., None] * p["t1"]
                + lam[2][..., None] * p["t2"] for lam, p in zip(lams, preps)])
            for _pgs in range(params.n_pgs):
                new_lams, imps = [], []
                for k, (seg, p, lam, depth_cur) in enumerate(
                        zip(segs, preps, lams, depths)):
                    lam_n, lam_t1, lam_t2 = lam
                    rv = rel_vel(k, lv, av)
                    vn = torch.sum(rv * p["n3"], -1)
                    sep = -(depth_cur - params.allowed_linear_error)
                    bias = torch.where(sep > 0.0, sep / h, torch.clamp(
                        bias_rate * sep, min=-params.max_corrective_velocity))
                    mscale = torch.where(sep > 0.0, 1.0, mass_scale_soft)
                    iscale = torch.where(sep > 0.0, 0.0, imp_scale_soft)
                    dl = (-p["m_n"] * mscale * (vn + bias)
                          - iscale * lam_n) * p["actf"]
                    new_n = torch.clamp(lam_n + dl, min=0.0)
                    d1 = new_n - lam_n
                    vn2 = vn + d1 / p["m_n"]
                    # hard relax → vn = 0 for touching contacts; separated
                    # (speculative) ones keep the sep/h approach limit
                    spec = torch.where(sep > 0.0, bias, 0.0)
                    dl2 = -p["m_n"] * (vn2 + spec) * p["actf"]
                    new_n2 = torch.clamp(new_n + dl2, min=0.0)
                    dn = new_n2 - lam_n
                    lam_n = new_n2
                    max_f = seg.friction[..., None] * lam_n
                    vt1 = torch.sum(rv * p["t1"], -1)
                    new1 = torch.clamp(lam_t1 - p["m_t1"] * vt1 * p["actf"],
                                       -max_f, max_f)
                    dt1 = new1 - lam_t1
                    lam_t1 = new1
                    vt2 = torch.sum(rv * p["t2"], -1)
                    new2 = torch.clamp(lam_t2 - p["m_t2"] * vt2 * p["actf"],
                                       -max_f, max_f)
                    dt2 = new2 - lam_t2
                    lam_t2 = new2
                    imps.append(dn[..., None] * p["n3"]
                                + dt1[..., None] * p["t1"]
                                + dt2[..., None] * p["t2"])
                    new_lams.append((lam_n, lam_t1, lam_t2))
                lams = new_lams
                lv, av = apply_all(lv, av, imps)
            lam_mxs = [torch.maximum(mx, lam[0])
                       for mx, lam in zip(lam_mxs, lams)]
            depths = [d - h * torch.sum(rel_vel(k, lv, av) * p["n3"], -1)
                      for k, (d, p) in enumerate(zip(depths, preps))]
        dq = 0.5 * h * quat.mul(torch.cat([av, torch.zeros_like(av[..., :1])],
                                          -1), rot)
        new_rot = quat.normalize(rot + dq)
        if has_com_offset:
            com = pos + quat.rotate(rot, com_b) + h * lv
            pos = com - quat.rotate(new_rot, com_b)
        else:
            pos = pos + h * lv
        rot = new_rot

    if has_joints:
        for _ in range(params.n_stabilization):
            pos = joints_mod.joint_position_pass(pos, rot, inv_mass, joints)
    if not has_contacts:
        return pos, rot, lv, av, []

    # ---- restitution, gated on the max λ over substeps ----
    imps, new_lams = [], []
    for k, (seg, p, lam, rt, mx) in enumerate(
            zip(segs, preps, lams, rest_targets, lam_mxs)):
        vn = torch.sum(rel_vel(k, lv, av) * p["n3"], -1)
        dl = (torch.clamp(-p["m_n"] * (vn - rt), min=0.0) * p["actf"]
              * (mx > 0.0))
        imps.append(dl[..., None] * p["n3"])
        new_lams.append((lam[0] + dl, lam[1], lam[2]))
    lams = new_lams
    lv, av = apply_all(lv, av, imps)

    # ---- NGS position stabilisation ----
    for i in range(params.n_stabilization):
        s = self_sums([
            (p["m_n"] * (params.stabilization_erp * torch.clamp(
                d - params.allowed_linear_error, min=0.0)) * p["actf"]
             )[..., None] * p["n3"] for d, p in zip(depths, preps)])
        dpos = s[..., :3]
        dtheta = quat.mv(ii_w0, s[..., 3:])
        pos = pos + dpos
        if has_com_offset:
            pos = pos + _cross(dtheta, -quat.rotate(rot, com_b))
        dq = 0.5 * quat.mul(torch.cat([dtheta,
                                       torch.zeros_like(dtheta[..., :1])],
                                      -1), rot)
        rot = quat.normalize(rot + dq)
        if i == params.n_stabilization - 1:
            break                  # the last pass's depths are not read
        corr6 = torch.cat([dpos, dtheta], -1)
        new_depths = []
        for (gath, _), p, d in zip(ops, preps, depths):
            da, db = gath(corr6)
            rel_corr = ((db[..., None, :3] + _cross(db[..., None, 3:],
                                                    p["r_b"]))
                        - (da[..., None, :3] + _cross(da[..., None, 3:],
                                                      p["r_a"])))
            new_depths.append(d - torch.sum(rel_corr * p["n3"], -1))
        depths = new_depths
    return pos, rot, lv, av, lams
