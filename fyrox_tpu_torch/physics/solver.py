"""Batched TGS-soft contact solver of the dense broadphase path: the port
of ``fyrox_tpu/physics/solver.py`` ``solve_tgs``.

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

__all__ = ["SolverParams", "ContactBatch", "solve_tgs"]


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
