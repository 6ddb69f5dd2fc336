"""TGS-soft contact solve (K1) on the packed per-world layout.

Replaces ``fyrox_tpu/physics/pallas_solver.py:816 solve_tgs_pallas`` for
scenes without joints or centre-of-mass offsets. On the card it is
``csrc/tgs_solve.cu`` (one CTA per world); a CPU tensor takes
``solve_tgs_plain``, which is the same computation in PyTorch (the
semantics of ``slab2._solve_tgs_planes`` / ``pallas_solver.solve_planes``).

Layout (see csrc/tgs_solve.cu):
  con [W,15,S,Cg] f32 — n3, pt3, depth, fric, rest, act, own, sigma, lam3
  body_j [W,S,Cg] i32 — partner body of each slot
  body [W,26,B] f32 — lv3, av3, pos3, q4, acc3, inv_mass, inv_inertia9
  col_body [Cg] i32 — each grid collider's own body
Returns body_out [W,13,B] (lv3, av3, pos3, q4) and lam [W,3,S,Cg].
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch.physics.planes import cross3 as _cross
from fyrox_tpu_torch.physics.planes import dot3 as _dot

__all__ = ["SolverParams", "solver_params", "solve_tgs", "solve_tgs_plain",
           "smem_bytes", "SMEM_LIMIT", "launches", "reset_launches",
           "CON_ROWS", "BODY_ROWS"]

CON_ROWS = 15
BODY_ROWS = 26
SMEM_LIMIT = 232448            # bytes of shared memory one H100 block may use
_BODY_SMEM_PLANES = 30

_LAUNCHES = 0


def launches() -> int:
    return _LAUNCHES


def reset_launches():
    global _LAUNCHES
    _LAUNCHES = 0


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


def smem_bytes(n_bodies: int, n_grid_colliders: int) -> int:
    return 4 * (_BODY_SMEM_PLANES * n_bodies + 6 * n_grid_colliders)


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


def solve_tgs_plain(con, body_j, body, col_body, p: SolverParams):
    """The whole TGS-soft solve in PyTorch (Jacobi over contact slots,
    mass splitting, self-half impulses; see module docstring)."""
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

    # mass-splitting counts
    count = torch.clamp(to_bodies([actf / own])[0], min=1.0)
    if p.msp == 0.5:
        count = torch.sqrt(count)
    elif p.msp != 1.0:
        count = count ** p.msp

    # lever arms measure from the step-start body origins
    jg, ig = gather([im, count] + list(pos) + list(ii0))
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
        q = _qstep(q, av, 0.5 * p.h)
        pos = tuple(x + p.h * v for x, v in zip(pos, lv))

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
        q = _qstep(q, dth, 0.5)
        depth = depth - _dot(rel(dpos, dth), n)

    body_out = torch.stack(list(lv) + list(av) + list(pos) + list(q), 1)
    return body_out, torch.stack([lam_n, lam_t1, lam_t2], 1)


# --------------------------------------------------------------------------
# kernel wrapper
# --------------------------------------------------------------------------

_CSR_CACHE: dict = {}


def _csr(col_body: torch.Tensor, n_bodies: int):
    """Body → grid-collider CSR lists (ascending collider order)."""
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


def _solve_tgs_cuda(con, body_j, body, col_body, p: SolverParams):
    from fyrox_tpu_torch import kernels
    global _LAUNCHES
    tensors = dict(con=con, body_j=body_j, body=body, col_body=col_body)
    for name, t in tensors.items():
        if not t.is_cuda or t.device != con.device:
            raise ValueError(f"solve_tgs: {name} must be on {con.device}")
        if not t.is_contiguous():
            raise ValueError(f"solve_tgs: {name} must be contiguous")
    if con.dtype != torch.float32 or body.dtype != torch.float32:
        raise TypeError("solve_tgs: con/body must be float32")
    if body_j.dtype != torch.int32 or col_body.dtype != torch.int32:
        raise TypeError("solve_tgs: body_j/col_body must be int32")
    w, rows, s, cg = con.shape
    nb = body.shape[2]
    if (rows != CON_ROWS or tuple(body_j.shape) != (w, s, cg)
            or tuple(body.shape) != (w, BODY_ROWS, nb)
            or tuple(col_body.shape) != (cg,)):
        raise ValueError(
            f"solve_tgs: shapes con {tuple(con.shape)}, body_j "
            f"{tuple(body_j.shape)}, body {tuple(body.shape)}, col_body "
            f"{tuple(col_body.shape)} do not match the packed layout")
    need = smem_bytes(nb, cg)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"solve_tgs: {nb} bodies / {cg} grid colliders need {need} B of "
            f"shared memory per world, above the {SMEM_LIMIT} B a block "
            "may use")
    ptr, col = _csr(col_body, nb)
    body_out = torch.empty((w, 13, nb), dtype=torch.float32, device=con.device)
    lam = torch.empty((w, 3, s, cg), dtype=torch.float32, device=con.device)
    scratch = torch.empty((w, 6, s, cg), dtype=torch.float32,
                          device=con.device)
    lib = kernels.library()
    stream = torch.cuda.current_stream(con.device).cuda_stream
    err = lib.fyrox_tgs_solve(
        con.data_ptr(), body_j.data_ptr(), body.data_ptr(),
        col_body.data_ptr(), ptr.data_ptr(), col.data_ptr(),
        body_out.data_ptr(), lam.data_ptr(), scratch.data_ptr(),
        w, s, cg, nb, p.n_sub, p.n_pgs, p.n_stab,
        p.h, p.allowed, p.max_corr, p.rest_thr, p.wc, p.erp, p.bias_rate,
        p.mscale_soft, p.iscale_soft, p.msp, stream)
    kernels.check(err, "fyrox_tgs_solve")
    _LAUNCHES += 1
    return body_out, lam


def solve_tgs(con, body_j, body, col_body, p: SolverParams, *,
              has_com=False, joints=None):
    """Dispatch: CPU tensors → plain version; CUDA tensors → the kernel.
    Joints and centre-of-mass offsets are not ported yet and raise."""
    if joints is not None:
        raise NotImplementedError("joint planes in the TGS solve")
    if has_com:
        raise NotImplementedError("centre-of-mass offsets in the TGS solve")
    if con.is_cuda:
        return _solve_tgs_cuda(con, body_j, body, col_body, p)
    return solve_tgs_plain(con, body_j, body, col_body, p)
