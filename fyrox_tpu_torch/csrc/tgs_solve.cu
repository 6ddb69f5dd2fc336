// K1: the TGS-soft contact solve of one physics step, one CTA per world.
//
// Replaces fyrox_tpu/physics/pallas_solver.py:816 solve_tgs_pallas (kernel
// body _kernel :338 -> solve_planes :357) for scenes without joints and
// without centre-of-mass offsets. It computes what solve_planes computes:
// in-kernel constraint prep (tangent frame, lever arms, effective masses
// with mass-splitting counts, restitution targets), n_sub substeps of
// {gravity, warm start, n_pgs soft PGS passes on the normal and the
// friction cone, position integration}, a restitution pass, and n_stab NGS
// position-stabilisation passes. The plain PyTorch version of the same
// function is fyrox_tpu_torch/physics/tgs_kernel.py:solve_tgs_plain.
//
// Layout (per world w; S contact slots per grid collider, Cg grid
// colliders, B bodies):
//   con      [W,15,S,Cg] f32  n3 pt3 depth fric rest act own sigma lam3
//   body_j   [W,S,Cg]    i32  partner body of each slot
//   body     [W,26,B]    f32  lv3 av3 pos3 q4 acc3 inv_mass inv_inertia9
//   col_body [Cg]        i32  each grid collider's own body
//   csr_ptr  [B+1], csr_col [Cg]  body -> its grid colliders, ascending
//   body_out [W,13,B]    f32  lv3 av3 pos3 q4
//   lam_out  [W,3,S,Cg]  f32  accumulated normal/tangent impulses (state)
//   scratch  [W,6,S,Cg]  f32  m_n m_t1 m_t2 rest_target depth lam_max
//
// Design. The TPU kernel held one world's planes in VMEM; here the body
// planes (30 x B floats, ~120 KB at B=1001) live in dynamic shared memory
// beside a [6,Cg] per-collider impulse buffer, and the contact planes stay
// in global memory (they are read once per pass, mostly from L2). Each
// solver pass is two Jacobi phases separated by __syncthreads():
//   1. collider phase: thread g (striding over Cg) computes its S slots'
//      impulses from the current body velocities (partner by body_j, self by
//      col_body, both from shared memory) and sums their self halves over
//      the slots in slot order into the buffer;
//   2. body phase: thread b sums its colliders' buffer entries through the
//      CSR list in ascending order and updates its velocities.
// There are no float atomics, so a run repeats bit for bit.
//
// Bound: with one CTA per world, W=128 worlds occupy 128 of the H100's 132
// SMs, one CTA each (the shared-memory footprint allows no second one).
// Each pass streams the world's contact planes (~17 floats per slot) from
// L2/HBM and spends a block-wide barrier per phase; at the flagship's
// S*Cg = 16k slots per world the kernel is bound by those loads and by the
// per-SM latency of the serial passes, not by arithmetic. Speed (worlds
// split over a thread-block cluster, TMA-staged contact planes in shared
// memory, skipping the slots past each collider's active count) is later
// work. Capacity: the wrapper refuses shapes whose shared memory exceeds
// the 227 KB a block may use.
#include <cuda_runtime.h>

namespace {

// body planes in shared memory: index f*B + b
enum {
  kLV = 0, kAV = 3, kPOS = 6, kQ = 9, kACC = 13, kIM = 16, kII = 17,
  kCNT = 26, kCOM = 27, kBodySmem = 30
};
// contact planes in global memory
enum {
  cN = 0, cPT = 3, cDEPTH = 6, cFRIC = 7, cREST = 8, cACT = 9, cOWN = 10,
  cSIGMA = 11, cLAM = 12
};
// scratch planes
enum { sMN = 0, sMT1 = 1, sMT2 = 2, sREST = 3, sDEPTH = 4, sLMX = 5 };

struct Params {
  float h, allowed, max_corr, rest_thr, wc, erp, bias_rate, mscale_soft,
      iscale_soft, msp;
  int S, Cg, B, n_sub, n_pgs, n_stab;
};

__device__ __forceinline__ void cross(const float* a, const float* b,
                                      float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// One contact slot's geometry, re-derived from its planes on every pass.
struct Slot {
  float n[3], t1[3], t2[3], ra[3], rb[3], rs[3];
  float sigma, act;
  int ia, ib, is;   // body of side A, side B, self
};

__device__ __forceinline__ void load_slot(const float* con, const int* bj,
                                          const float* sm, int self_b,
                                          int c, int SC, int B, Slot& o) {
  for (int d = 0; d < 3; ++d) o.n[d] = con[(cN + d) * SC + c];
  float pt[3];
  for (int d = 0; d < 3; ++d) pt[d] = con[(cPT + d) * SC + c];
  o.sigma = con[cSIGMA * SC + c];
  o.act = con[cACT * SC + c];
  const int j = bj[c];
  const bool swapped = o.sigma < 0.0f;
  o.ia = swapped ? j : self_b;
  o.ib = swapped ? self_b : j;
  o.is = self_b;
  for (int d = 0; d < 3; ++d) {
    o.ra[d] = pt[d] - sm[(kCOM + d) * B + o.ia];
    o.rb[d] = pt[d] - sm[(kCOM + d) * B + o.ib];
    o.rs[d] = pt[d] - sm[(kCOM + d) * B + self_b];
  }
  // branch-free Pixar orthonormal basis
  const float sgn = o.n[2] >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sgn + o.n[2]);
  const float b = o.n[0] * o.n[1] * a;
  o.t1[0] = 1.0f + sgn * o.n[0] * o.n[0] * a;
  o.t1[1] = sgn * b;
  o.t1[2] = -sgn * o.n[0];
  o.t2[0] = b;
  o.t2[1] = sgn + o.n[1] * o.n[1] * a;
  o.t2[2] = -o.n[1];
}

// relative velocity of B w.r.t. A at the contact point; `lin`/`ang` are the
// shared-memory velocity planes (or the NGS position/rotation deltas)
__device__ __forceinline__ void rel_vel(const Slot& s, const float* sm,
                                        int lin, int ang, int B, float* rv) {
  float la[3], aa[3], lb[3], ab[3], ca[3], cb[3];
  for (int d = 0; d < 3; ++d) {
    la[d] = sm[(lin + d) * B + s.ia];
    aa[d] = sm[(ang + d) * B + s.ia];
    lb[d] = sm[(lin + d) * B + s.ib];
    ab[d] = sm[(ang + d) * B + s.ib];
  }
  cross(aa, s.ra, ca);
  cross(ab, s.rb, cb);
  for (int d = 0; d < 3; ++d) rv[d] = (lb[d] + cb[d]) - (la[d] + ca[d]);
}

// self half of an impulse (A convention) → per-collider sums acc[6]
__device__ __forceinline__ void add_impulse(const Slot& s, const float* imp,
                                            const float* sm, int B,
                                            float* acc) {
  float is[3], tq[3];
  const float im = sm[kIM * B + s.is];
  for (int d = 0; d < 3; ++d) is[d] = -s.sigma * imp[d];
  cross(s.rs, is, tq);
  for (int d = 0; d < 3; ++d) {
    acc[d] += is[d] * im;
    acc[3 + d] += tq[d];
  }
}

__device__ __forceinline__ void mv_ii(const float* sm, int B, int b,
                                      const float* v, float* o) {
  for (int r = 0; r < 3; ++r)
    o[r] = sm[(kII + 3 * r) * B + b] * v[0]
         + sm[(kII + 3 * r + 1) * B + b] * v[1]
         + sm[(kII + 3 * r + 2) * B + b] * v[2];
}

// body phase: sum each body's collider buffers (ascending CSR order)
__device__ __forceinline__ void body_sums(const float* buf, const int* ptr,
                                          const int* col, int Cg, int b,
                                          float* o) {
  for (int k = 0; k < 6; ++k) o[k] = 0.0f;
  for (int e = ptr[b]; e < ptr[b + 1]; ++e) {
    const int g = col[e];
    for (int k = 0; k < 6; ++k) o[k] += buf[k * Cg + g];
  }
}

// lv += Σlin, av += I⁻¹ Σtorque for every body of the world
__device__ void apply_velocity(float* sm, const float* buf, const int* ptr,
                               const int* col, const Params& p) {
  for (int b = threadIdx.x; b < p.B; b += blockDim.x) {
    float s[6], dav[3];
    body_sums(buf, ptr, col, p.Cg, b, s);
    mv_ii(sm, p.B, b, s + 3, dav);
    for (int d = 0; d < 3; ++d) {
      sm[(kLV + d) * p.B + b] += s[d];
      sm[(kAV + d) * p.B + b] += dav[d];
    }
  }
}

// q ← normalize(q + scale * (ω,0)⊗q)
__device__ __forceinline__ void rotate_q(float* sm, int B, int b,
                                         const float* w, float scale) {
  const float q0 = sm[(kQ + 0) * B + b], q1 = sm[(kQ + 1) * B + b];
  const float q2 = sm[(kQ + 2) * B + b], q3 = sm[(kQ + 3) * B + b];
  const float d0 = q3 * w[0] + w[1] * q2 - w[2] * q1;
  const float d1 = q3 * w[1] - w[0] * q2 + w[2] * q0;
  const float d2 = q3 * w[2] + w[0] * q1 - w[1] * q0;
  const float d3 = -w[0] * q0 - w[1] * q1 - w[2] * q2;
  const float n0 = q0 + scale * d0, n1 = q1 + scale * d1;
  const float n2 = q2 + scale * d2, n3 = q3 + scale * d3;
  const float inv =
      1.0f / sqrtf(n0 * n0 + n1 * n1 + n2 * n2 + n3 * n3 + 1e-30f);
  sm[(kQ + 0) * B + b] = n0 * inv;
  sm[(kQ + 1) * B + b] = n1 * inv;
  sm[(kQ + 2) * B + b] = n2 * inv;
  sm[(kQ + 3) * B + b] = n3 * inv;
}

__global__ void __launch_bounds__(512)
tgs_solve_kernel(const float* __restrict__ con_all,
                 const int* __restrict__ bj_all,
                 const float* __restrict__ body_all,
                 const int* __restrict__ col_body,
                 const int* __restrict__ csr_ptr,
                 const int* __restrict__ csr_col,
                 float* __restrict__ body_out_all,
                 float* __restrict__ lam_all,
                 float* __restrict__ scr_all, Params p) {
  extern __shared__ float sm[];
  const int w = blockIdx.x;
  const int B = p.B, Cg = p.Cg, S = p.S;
  const int SC = S * Cg;
  float* buf = sm + kBodySmem * B;            // [6, Cg]
  const float* con = con_all + (size_t)w * 15 * SC;
  const int* bj = bj_all + (size_t)w * SC;
  const float* body = body_all + (size_t)w * 26 * B;
  float* body_out = body_out_all + (size_t)w * 13 * B;
  float* lam = lam_all + (size_t)w * 3 * SC;
  float* scr = scr_all + (size_t)w * 6 * SC;
  const int T = blockDim.x;

  // ---- load body planes; lever arms measure from the step-start origin
  for (int b = threadIdx.x; b < B; b += T) {
    for (int f = 0; f < 26; ++f) sm[f * B + b] = body[f * B + b];
    for (int d = 0; d < 3; ++d) sm[(kCOM + d) * B + b] = body[(kPOS + d) * B + b];
  }
  // ---- mass-splitting counts: Σ act/own per collider, then per body
  for (int g = threadIdx.x; g < Cg; g += T) {
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) {
      const int c = s * Cg + g;
      acc += con[cACT * SC + c] / fmaxf(con[cOWN * SC + c], 1.0f);
    }
    buf[g] = acc;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += T) {
    float cnt = 0.0f;
    for (int e = csr_ptr[b]; e < csr_ptr[b + 1]; ++e) cnt += buf[csr_col[e]];
    cnt = fmaxf(cnt, 1.0f);
    if (p.msp == 0.5f) cnt = sqrtf(cnt);
    else if (p.msp != 1.0f) cnt = powf(cnt, p.msp);
    sm[kCNT * B + b] = cnt;
  }
  __syncthreads();

  // ---- constraint prep: effective masses, restitution targets
  for (int g = threadIdx.x; g < Cg; g += T) {
    const int self_b = col_body[g];
    for (int s = 0; s < S; ++s) {
      const int c = s * Cg + g;
      Slot sl;
      load_slot(con, bj, sm, self_b, c, SC, B, sl);
      const float own = fmaxf(con[cOWN * SC + c], 1.0f);
      const float im_a = sm[kIM * B + sl.ia], im_b = sm[kIM * B + sl.ib];
      const float cnt_a = sm[kCNT * B + sl.ia] * own;
      const float cnt_b = sm[kCNT * B + sl.ib] * own;
      const float* dirs[3] = {sl.n, sl.t1, sl.t2};
      float m[3];
      for (int k = 0; k < 3; ++k) {
        float xa[3], xb[3], ia[3], ib[3];
        cross(sl.ra, dirs[k], xa);
        cross(sl.rb, dirs[k], xb);
        mv_ii(sm, B, sl.ia, xa, ia);
        mv_ii(sm, B, sl.ib, xb, ib);
        const float kk = im_a * cnt_a + im_b * cnt_b + cnt_a * dot(xa, ia)
                       + cnt_b * dot(xb, ib);
        m[k] = 1.0f / fmaxf(kk, 1e-12f);
      }
      float rv[3];
      rel_vel(sl, sm, kLV, kAV, B, rv);
      const float v0n = dot(rv, sl.n);
      const float rest = con[cREST * SC + c];
      scr[sMN * SC + c] = m[0];
      scr[sMT1 * SC + c] = m[1];
      scr[sMT2 * SC + c] = m[2];
      scr[sREST * SC + c] = v0n < -p.rest_thr ? -rest * v0n : 0.0f;
      scr[sDEPTH * SC + c] = con[cDEPTH * SC + c];
      scr[sLMX * SC + c] = 0.0f;
      for (int k = 0; k < 3; ++k) lam[k * SC + c] = con[(cLAM + k) * SC + c];
    }
  }
  __syncthreads();

  for (int sub = 0; sub < p.n_sub; ++sub) {
    for (int b = threadIdx.x; b < B; b += T)
      for (int d = 0; d < 3; ++d)
        sm[(kLV + d) * B + b] += p.h * sm[(kACC + d) * B + b];
    __syncthreads();

    // ---- warm start
    for (int g = threadIdx.x; g < Cg; g += T) {
      const int self_b = col_body[g];
      float acc[6] = {0, 0, 0, 0, 0, 0};
      for (int s = 0; s < S; ++s) {
        const int c = s * Cg + g;
        Slot sl;
        load_slot(con, bj, sm, self_b, c, SC, B, sl);
        const float ln = lam[c] * p.wc;
        const float l1 = lam[SC + c] * p.wc;
        const float l2 = lam[2 * SC + c] * p.wc;
        lam[c] = ln;
        lam[SC + c] = l1;
        lam[2 * SC + c] = l2;
        float imp[3];
        for (int d = 0; d < 3; ++d)
          imp[d] = ln * sl.n[d] + l1 * sl.t1[d] + l2 * sl.t2[d];
        add_impulse(sl, imp, sm, B, acc);
      }
      for (int k = 0; k < 6; ++k) buf[k * Cg + g] = acc[k];
    }
    __syncthreads();
    apply_velocity(sm, buf, csr_ptr, csr_col, p);
    __syncthreads();

    // ---- soft PGS: normal (soft, then hard speculative clamp) + friction
    for (int it = 0; it < p.n_pgs; ++it) {
      for (int g = threadIdx.x; g < Cg; g += T) {
        const int self_b = col_body[g];
        float acc[6] = {0, 0, 0, 0, 0, 0};
        for (int s = 0; s < S; ++s) {
          const int c = s * Cg + g;
          Slot sl;
          load_slot(con, bj, sm, self_b, c, SC, B, sl);
          const float m_n = scr[sMN * SC + c];
          const float sep = -(scr[sDEPTH * SC + c] - p.allowed);
          const float bias = sep > 0.0f ? sep / p.h
                                        : fmaxf(p.bias_rate * sep, -p.max_corr);
          const float mscale = sep > 0.0f ? 1.0f : p.mscale_soft;
          const float iscale = sep > 0.0f ? 0.0f : p.iscale_soft;
          float rv[3];
          rel_vel(sl, sm, kLV, kAV, B, rv);
          const float vn = dot(rv, sl.n);
          const float lam_n = lam[c];
          const float dl = (-m_n * mscale * (vn + bias) - iscale * lam_n)
                         * sl.act;
          const float new_n = fmaxf(lam_n + dl, 0.0f);
          const float vn2 = vn + (new_n - lam_n) / fmaxf(m_n, 1e-12f);
          const float spec = sep > 0.0f ? bias : 0.0f;
          const float new_n2 = fmaxf(new_n - m_n * (vn2 + spec) * sl.act,
                                     0.0f);
          const float dn = new_n2 - lam_n;
          lam[c] = new_n2;
          const float max_f = con[cFRIC * SC + c] * new_n2;
          const float l1 = lam[SC + c], l2 = lam[2 * SC + c];
          const float n1 = fminf(fmaxf(l1 - scr[sMT1 * SC + c] * dot(rv, sl.t1)
                                           * sl.act, -max_f), max_f);
          const float n2 = fminf(fmaxf(l2 - scr[sMT2 * SC + c] * dot(rv, sl.t2)
                                           * sl.act, -max_f), max_f);
          lam[SC + c] = n1;
          lam[2 * SC + c] = n2;
          const float d1 = n1 - l1, d2 = n2 - l2;
          float imp[3];
          for (int d = 0; d < 3; ++d)
            imp[d] = dn * sl.n[d] + d1 * sl.t1[d] + d2 * sl.t2[d];
          add_impulse(sl, imp, sm, B, acc);
        }
        for (int k = 0; k < 6; ++k) buf[k * Cg + g] = acc[k];
      }
      __syncthreads();
      apply_velocity(sm, buf, csr_ptr, csr_col, p);
      __syncthreads();
    }

    // ---- track the peak normal impulse; advance depths by the end-of-
    // substep approach velocity
    for (int g = threadIdx.x; g < Cg; g += T) {
      const int self_b = col_body[g];
      for (int s = 0; s < S; ++s) {
        const int c = s * Cg + g;
        Slot sl;
        load_slot(con, bj, sm, self_b, c, SC, B, sl);
        scr[sLMX * SC + c] = fmaxf(scr[sLMX * SC + c], lam[c]);
        float rv[3];
        rel_vel(sl, sm, kLV, kAV, B, rv);
        scr[sDEPTH * SC + c] -= p.h * dot(rv, sl.n);
      }
    }
    __syncthreads();

    // ---- integrate
    for (int b = threadIdx.x; b < B; b += T) {
      float av[3];
      for (int d = 0; d < 3; ++d) av[d] = sm[(kAV + d) * B + b];
      rotate_q(sm, B, b, av, 0.5f * p.h);
      for (int d = 0; d < 3; ++d)
        sm[(kPOS + d) * B + b] += p.h * sm[(kLV + d) * B + b];
    }
    __syncthreads();
  }

  // ---- restitution (add-only, where the contact carried impulse)
  for (int g = threadIdx.x; g < Cg; g += T) {
    const int self_b = col_body[g];
    float acc[6] = {0, 0, 0, 0, 0, 0};
    for (int s = 0; s < S; ++s) {
      const int c = s * Cg + g;
      Slot sl;
      load_slot(con, bj, sm, self_b, c, SC, B, sl);
      float rv[3];
      rel_vel(sl, sm, kLV, kAV, B, rv);
      const float vn = dot(rv, sl.n);
      const float gate = scr[sLMX * SC + c] > 0.0f ? 1.0f : 0.0f;
      const float dl = fmaxf(-scr[sMN * SC + c] * (vn - scr[sREST * SC + c]),
                             0.0f) * sl.act * gate;
      lam[c] += dl;
      float imp[3];
      for (int d = 0; d < 3; ++d) imp[d] = dl * sl.n[d];
      add_impulse(sl, imp, sm, B, acc);
    }
    for (int k = 0; k < 6; ++k) buf[k * Cg + g] = acc[k];
  }
  __syncthreads();
  apply_velocity(sm, buf, csr_ptr, csr_col, p);
  __syncthreads();
  // velocities are final: write them out, then reuse their shared planes
  // for the NGS position/rotation deltas
  for (int b = threadIdx.x; b < B; b += T) {
    for (int f = 0; f < 6; ++f) {
      body_out[f * B + b] = sm[f * B + b];
      sm[f * B + b] = 0.0f;
    }
  }
  __syncthreads();

  // ---- NGS position stabilisation
  const int kDP = kLV, kDTH = kAV;
  for (int it = 0; it < p.n_stab; ++it) {
    for (int g = threadIdx.x; g < Cg; g += T) {
      const int self_b = col_body[g];
      float acc[6] = {0, 0, 0, 0, 0, 0};
      for (int s = 0; s < S; ++s) {
        const int c = s * Cg + g;
        Slot sl;
        load_slot(con, bj, sm, self_b, c, SC, B, sl);
        const float corr = p.erp * fmaxf(scr[sDEPTH * SC + c] - p.allowed,
                                         0.0f);
        const float p_imp = scr[sMN * SC + c] * corr * sl.act;
        float imp[3];
        for (int d = 0; d < 3; ++d) imp[d] = p_imp * sl.n[d];
        add_impulse(sl, imp, sm, B, acc);
      }
      for (int k = 0; k < 6; ++k) buf[k * Cg + g] = acc[k];
    }
    __syncthreads();
    for (int b = threadIdx.x; b < B; b += T) {
      float s6[6], dth[3];
      body_sums(buf, csr_ptr, csr_col, Cg, b, s6);
      mv_ii(sm, B, b, s6 + 3, dth);
      for (int d = 0; d < 3; ++d) {
        sm[(kPOS + d) * B + b] += s6[d];
        sm[(kDP + d) * B + b] = s6[d];
        sm[(kDTH + d) * B + b] = dth[d];
      }
      rotate_q(sm, B, b, dth, 0.5f);
    }
    __syncthreads();
    for (int g = threadIdx.x; g < Cg; g += T) {
      const int self_b = col_body[g];
      for (int s = 0; s < S; ++s) {
        const int c = s * Cg + g;
        Slot sl;
        load_slot(con, bj, sm, self_b, c, SC, B, sl);
        float rc[3];
        rel_vel(sl, sm, kDP, kDTH, B, rc);
        scr[sDEPTH * SC + c] -= dot(rc, sl.n);
      }
    }
    __syncthreads();
  }

  for (int b = threadIdx.x; b < B; b += T) {
    for (int f = 6; f < 13; ++f) body_out[f * B + b] = sm[f * B + b];
  }
}

}  // namespace

extern "C" int fyrox_tgs_solve(const void* con, const void* body_j,
                               const void* body, const void* col_body,
                               const void* csr_ptr, const void* csr_col,
                               void* body_out, void* lam_out, void* scratch,
                               int W, int S, int Cg, int B, int n_sub,
                               int n_pgs, int n_stab,
                               float h, float allowed, float max_corr,
                               float rest_thr, float wc, float erp,
                               float bias_rate, float mscale_soft,
                               float iscale_soft, float msp, void* stream) {
  Params p{h, allowed, max_corr, rest_thr, wc, erp, bias_rate, mscale_soft,
           iscale_soft, msp, S, Cg, B, n_sub, n_pgs, n_stab};
  const size_t smem = sizeof(float) * ((size_t)kBodySmem * B + 6 * (size_t)Cg);
  cudaError_t err = cudaFuncSetAttribute(
      tgs_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  tgs_solve_kernel<<<W, 512, smem, (cudaStream_t)stream>>>(
      (const float*)con, (const int*)body_j, (const float*)body,
      (const int*)col_body, (const int*)csr_ptr, (const int*)csr_col,
      (float*)body_out, (float*)lam_out, (float*)scratch, p);
  return (int)cudaGetLastError();
}
