// K1: the TGS-soft contact solve of one physics step, one CTA per world.
//
// Replaces fyrox_tpu/physics/pallas_solver.py:816 solve_tgs_pallas (kernel
// body _kernel :338 -> solve_planes :357, joint passes :207-335). It
// computes what solve_planes computes: in-kernel constraint prep (tangent
// frame, lever arms, effective masses with mass-splitting counts,
// restitution targets), n_sub substeps of {gravity, the joint velocity
// pass, warm start, n_pgs soft PGS passes on the normal and the friction
// cone, position integration}, n_stab joint position passes, a restitution
// pass, and n_stab NGS position-stabilisation passes. The plain PyTorch
// version of the same function is
// fyrox_tpu_torch/physics/tgs_kernel.py:solve_tgs_plain.
//
// Layout (per world w; S contact slots per grid collider, Cg grid
// colliders, B bodies, J joints):
//   con      [W,15,S,Cg] f32  n3 pt3 depth fric rest act own sigma lam3
//   body_j   [W,S,Cg]    i32  partner body of each slot
//   body     [W,29,B]    f32  lv3 av3 pos3 q4 acc3 inv_mass inv_inertia9
//                             com_local3
//   col_body [Cg]        i32  each grid collider's own body
//   csr_ptr  [B+1], csr_col [Cg]  body -> its grid colliders, ascending
//   jtab     [20,J]      f32  kind anchor_a3 anchor_b3 axis_a3 ref_rot4
//                             com_a3 com_b3
//   joint_a, joint_b [J] i32  the two bodies of each joint
//   jptr_a/jcol_a, jptr_b/jcol_b  body -> its joints on side A / B
//   body_out [W,13,B]    f32  lv3 av3 pos3 q4
//   lam_out  [W,3,S,Cg]  f32  accumulated normal/tangent impulses (state)
//   scratch  [W,6,S,Cg]  f32  m_n m_t1 m_t2 rest_target depth lam_max
//
// Design. The TPU kernel held one world's planes in VMEM; here the body
// planes (30 x B floats, 33 with COM offsets; ~120 KB at B=1001) live in
// dynamic shared memory beside a [6,Cg] per-collider impulse buffer and,
// with joints, the joint table, a [12,J] per-joint impulse buffer and the
// joints' body lists (~14 KB at J=128); the contact planes stay in global
// memory (they are read once per pass, mostly from L2). Each solver pass is
// two Jacobi phases separated by __syncthreads():
//   1. collider phase: thread g (striding over Cg) computes its S slots'
//      impulses from the current body velocities (partner by body_j, self by
//      col_body, both from shared memory) and sums their self halves over
//      the slots in slot order into the buffer;
//   2. body phase: thread b sums its colliders' buffer entries through the
//      CSR list in ascending order and updates its velocities.
// The joint passes have the same two phases: thread j computes joint j's
// impulse from the shared body planes (a gather is a load; the TPU's
// one-hot dots are gone), then thread b adds its side-A joints' deltas and
// then its side-B joints', each list in ascending joint order. A velocity
// pass runs the point constraints, then (after the bodies took them) the
// angular locks, which read the updated angular velocities. There are no
// float atomics, so a run repeats bit for bit.
//
// Centre-of-mass offsets (template parameter HAS_COM, so the flagship's
// code is unchanged): lever arms measure from the step-start world COM
// pos + R(q0) cm; integration moves the COM by h lv and re-derives the
// origin from the new orientation; an NGS rotation dθ shifts the origin by
// dθ × (−R(q) cm).
//
// Bound: with one CTA per world, W=128 worlds occupy 128 of the H100's 132
// SMs, one CTA each (the shared-memory footprint allows no second one).
// Each pass streams the world's contact planes (~17 floats per slot) from
// L2/HBM and spends a block-wide barrier per phase; at the flagship's
// S*Cg = 16k slots per world the kernel is bound by those loads and by the
// per-SM latency of the serial passes, not by arithmetic. The joint passes
// add four barriers per substep and two per position pass, with at most
// 128 busy threads. Speed (worlds split over a thread-block cluster,
// TMA-staged contact planes in shared memory, skipping the slots past each
// collider's active count) is later work. Capacity: the wrapper refuses
// shapes whose shared memory exceeds the 227 KB a block may use.
#include <cuda_runtime.h>

namespace {

// body planes in shared memory: index f*B + b (kCM only with HAS_COM)
enum {
  kLV = 0, kAV = 3, kPOS = 6, kQ = 9, kACC = 13, kIM = 16, kII = 17,
  kCNT = 26, kCOM = 27, kBodySmem = 30, kCM = 30
};
// the packed body layout in global memory: 26 state rows, then com_local3
enum { kBodyRows = 29, kBodyCM = 26 };
// rows of the joint table in global and shared memory
enum {
  jKIND = 0, jANCH_A = 1, jANCH_B = 4, jAXIS = 7, jREF = 10, jCOM_A = 14,
  jCOM_B = 17, kJRows = 20
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
  int S, Cg, B, J, n_sub, n_pgs, n_stab;
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


// ---------------------------------------------------------------- joints

// v rotated by the unit quaternion q, in pallas_solver._jrot's order
__device__ __forceinline__ void jrot(const float* q, const float* v,
                                     float* o) {
  const float tx = 2.0f * (q[1] * v[2] - q[2] * v[1]);
  const float ty = 2.0f * (q[2] * v[0] - q[0] * v[2]);
  const float tz = 2.0f * (q[0] * v[1] - q[1] * v[0]);
  o[0] = v[0] + q[3] * tx + (q[1] * tz - q[2] * ty);
  o[1] = v[1] + q[3] * ty + (q[2] * tx - q[0] * tz);
  o[2] = v[2] + q[3] * tz + (q[0] * ty - q[1] * tx);
}

// Hamilton product a*b (x,y,z,w)
__device__ __forceinline__ void qmul(const float* a, const float* b,
                                     float* o) {
  o[0] = a[3] * b[0] + a[0] * b[3] + a[1] * b[2] - a[2] * b[1];
  o[1] = a[3] * b[1] - a[0] * b[2] + a[1] * b[3] + a[2] * b[0];
  o[2] = a[3] * b[2] + a[0] * b[1] - a[1] * b[0] + a[2] * b[3];
  o[3] = a[3] * b[3] - a[0] * b[0] - a[1] * b[1] - a[2] * b[2];
}

__device__ __forceinline__ void mv9(const float* m, const float* v, float* o) {
  for (int r = 0; r < 3; ++r)
    o[r] = m[3 * r] * v[0] + m[3 * r + 1] * v[1] + m[3 * r + 2] * v[2];
}

// skew(r) M skew(r)^T, row-major (pallas_solver._skew_sandwich)
__device__ __forceinline__ void skew_sandwich(const float* r, const float* m,
                                              float* o) {
  const float rx = r[0], ry = r[1], rz = r[2];
  const float t[3][3] = {
      {-rz * m[3] + ry * m[6], -rz * m[4] + ry * m[7], -rz * m[5] + ry * m[8]},
      {rz * m[0] - rx * m[6], rz * m[1] - rx * m[7], rz * m[2] - rx * m[8]},
      {-ry * m[0] + rx * m[3], -ry * m[1] + rx * m[4], -ry * m[2] + rx * m[5]}};
  for (int c = 0; c < 3; ++c) {
    o[3 * c] = -rz * t[c][1] + ry * t[c][2];
    o[3 * c + 1] = rz * t[c][0] - rx * t[c][2];
    o[3 * c + 2] = -ry * t[c][0] + rx * t[c][1];
  }
}

// 3x3 solve through the adjugate (pallas_solver._solve3); the +1e-9
// diagonal is added by the caller
__device__ __forceinline__ void solve3(const float* m, const float* b,
                                       float* x) {
  const float c00 = m[4] * m[8] - m[5] * m[7];
  const float c01 = m[5] * m[6] - m[3] * m[8];
  const float c02 = m[3] * m[7] - m[4] * m[6];
  const float det = m[0] * c00 + m[1] * c01 + m[2] * c02;
  const float inv_det = 1.0f / (det + 1e-18f);
  const float c10 = m[2] * m[7] - m[1] * m[8];
  const float c11 = m[0] * m[8] - m[2] * m[6];
  const float c12 = m[1] * m[6] - m[0] * m[7];
  const float c20 = m[1] * m[5] - m[2] * m[4];
  const float c21 = m[2] * m[3] - m[0] * m[5];
  const float c22 = m[0] * m[4] - m[1] * m[3];
  x[0] = (c00 * b[0] + c10 * b[1] + c20 * b[2]) * inv_det;
  x[1] = (c01 * b[0] + c11 * b[1] + c21 * b[2]) * inv_det;
  x[2] = (c02 * b[0] + c12 * b[1] + c22 * b[2]) * inv_det;
}

// shared-memory views of the joint tables
struct JointSmem {
  const float* tab;   // [20,J]
  float* buf;         // [12,J] per-joint deltas
  const int* ja;      // [J]
  const int* jb;      // [J]
  const int *ptr_a, *col_a, *ptr_b, *col_b;   // global CSR lists
  int J;
  __device__ float t(int row, int j) const { return tab[row * J + j]; }
};

__device__ __forceinline__ void load_pose(const float* sm, int B, int b,
                                          float* pos, float* q) {
  for (int d = 0; d < 3; ++d) pos[d] = sm[(kPOS + d) * B + b];
  for (int k = 0; k < 4; ++k) q[k] = sm[(kQ + k) * B + b];
}

__device__ __forceinline__ void load_ii(const float* sm, int B, int b,
                                        float* ii) {
  for (int k = 0; k < 9; ++k) ii[k] = sm[(kII + k) * B + b];
}

// the joint's local axis in world space (from body A's orientation) and
// whether it is prismatic
__device__ __forceinline__ void joint_axis(const JointSmem& js, int j,
                                           const float* qa, float* axis_w) {
  float ax[3];
  for (int d = 0; d < 3; ++d) ax[d] = js.t(jAXIS + d, j);
  jrot(qa, ax, axis_w);
}

__device__ __forceinline__ void project_off(bool on, const float* axis,
                                            float* v) {
  const float vd = dot(v, axis);
  if (on)
    for (int d = 0; d < 3; ++d) v[d] = v[d] - vd * axis[d];
}

// joint j's point impulse → deltas lv_a(0-2) av_a(3-5) lv_b(6-8) av_b(9-11)
__device__ void joint_point(const float* sm, const JointSmem& js, int B,
                            int j, float erp_h) {
  const int a = js.ja[j], b = js.jb[j];
  float pos_a[3], qa[4], pos_b[3], qb[4], ii_a[9], ii_b[9];
  load_pose(sm, B, a, pos_a, qa);
  load_pose(sm, B, b, pos_b, qb);
  load_ii(sm, B, a, ii_a);
  load_ii(sm, B, b, ii_b);
  const float im_a = sm[kIM * B + a], im_b = sm[kIM * B + b];
  float arm_a[3], arm_b[3], anch_a[3], anch_b[3];
  for (int d = 0; d < 3; ++d) {
    anch_a[d] = js.t(jANCH_A + d, j);
    anch_b[d] = js.t(jANCH_B + d, j);
    arm_a[d] = anch_a[d] - js.t(jCOM_A + d, j);
    arm_b[d] = anch_b[d] - js.t(jCOM_B + d, j);
  }
  float ra[3], rb[3], wa[3], wb[3], ca[3], cb[3];
  jrot(qa, arm_a, ra);
  jrot(qb, arm_b, rb);
  jrot(qa, anch_a, wa);
  jrot(qb, anch_b, wb);
  float av_a[3], av_b[3];
  for (int d = 0; d < 3; ++d) {
    av_a[d] = sm[(kAV + d) * B + a];
    av_b[d] = sm[(kAV + d) * B + b];
  }
  cross(av_a, ra, ca);
  cross(av_b, rb, cb);
  float c3[3], axis_w[3], verr[3];
  for (int d = 0; d < 3; ++d)
    c3[d] = (pos_b[d] + wb[d]) - (pos_a[d] + wa[d]);
  joint_axis(js, j, qa, axis_w);
  const bool prism = js.t(jKIND, j) == 3.0f;
  project_off(prism, axis_w, c3);
  for (int d = 0; d < 3; ++d) {
    const float va = sm[(kLV + d) * B + a] + ca[d];
    const float vb = sm[(kLV + d) * B + b] + cb[d];
    verr[d] = vb - va + erp_h * c3[d];
  }
  project_off(prism, axis_w, verr);
  float sa[9], sb[9], k[9], imp[3], nimp[3];
  skew_sandwich(ra, ii_a, sa);
  skew_sandwich(rb, ii_b, sb);
  const float imab = im_a + im_b;
  for (int e = 0; e < 9; ++e) k[e] = sa[e] + sb[e];
  for (int e = 0; e < 9; e += 4) k[e] = k[e] + imab + 1e-9f;
  solve3(k, verr, nimp);          // imp = -K^-1 verr, nimp = -imp
  for (int d = 0; d < 3; ++d) imp[d] = -nimp[d];
  float ta[3], tb[3], da[3], db[3];
  cross(ra, nimp, ta);
  cross(rb, imp, tb);
  mv9(ii_a, ta, da);
  mv9(ii_b, tb, db);
  const int J = js.J;
  for (int d = 0; d < 3; ++d) {
    js.buf[d * J + j] = nimp[d] * im_a;
    js.buf[(3 + d) * J + j] = da[d];
    js.buf[(6 + d) * J + j] = imp[d] * im_b;
    js.buf[(9 + d) * J + j] = db[d];
  }
}

// joint j's angular lock impulse → deltas av_a(0-2) av_b(3-5)
__device__ void joint_lock(const float* sm, const JointSmem& js, int B, int j,
                           float erp_h) {
  const int a = js.ja[j], b = js.jb[j];
  float pos_a[3], qa[4], pos_b[3], qb[4], ii_a[9], ii_b[9];
  load_pose(sm, B, a, pos_a, qa);
  load_pose(sm, B, b, pos_b, qb);
  load_ii(sm, B, a, ii_a);
  load_ii(sm, B, b, ii_b);
  float qa_c[4] = {-qa[0], -qa[1], -qa[2], qa[3]};
  float ref_c[4], q_rel[4], q_err[4];
  for (int k = 0; k < 3; ++k) ref_c[k] = -js.t(jREF + k, j);
  ref_c[3] = js.t(jREF + 3, j);
  qmul(qa_c, qb, q_rel);
  qmul(ref_c, q_rel, q_err);
  const float sgn = q_err[3] >= 0.0f ? 1.0f : -1.0f;
  float e[3], ang_err[3], axis_w[3], target[3];
  for (int d = 0; d < 3; ++d) e[d] = 2.0f * q_err[d] * sgn;
  jrot(qa, e, ang_err);
  joint_axis(js, j, qa, axis_w);
  for (int d = 0; d < 3; ++d) {
    const float rel_w = sm[(kAV + d) * B + b] - sm[(kAV + d) * B + a];
    target[d] = rel_w + erp_h * ang_err[d];
  }
  const float kind = js.t(jKIND, j);
  const bool full = kind == 1.0f || kind == 3.0f;
  const bool rev = kind == 2.0f;
  const float tdot = dot(target, axis_w);
  float ang_t[3];
  for (int d = 0; d < 3; ++d)
    ang_t[d] = full ? target[d] : (rev ? target[d] - tdot * axis_w[d] : 0.0f);
  float k[9], imp[3], nimp[3], da[3], db[3];
  for (int e2 = 0; e2 < 9; ++e2) k[e2] = ii_a[e2] + ii_b[e2];
  for (int e2 = 0; e2 < 9; e2 += 4) k[e2] = k[e2] + 1e-9f;
  solve3(k, ang_t, nimp);         // imp = -K^-1 target, nimp = -imp
  for (int d = 0; d < 3; ++d) imp[d] = -nimp[d];
  mv9(ii_a, nimp, da);
  mv9(ii_b, imp, db);
  const int J = js.J;
  for (int d = 0; d < 3; ++d) {
    js.buf[d * J + j] = da[d];
    js.buf[(3 + d) * J + j] = db[d];
  }
}

// joint j's NGS anchor-separation correction → deltas pos_a(0-2) pos_b(3-5)
__device__ void joint_shift(const float* sm, const JointSmem& js, int B,
                            int j) {
  const int a = js.ja[j], b = js.jb[j];
  float pos_a[3], qa[4], pos_b[3], qb[4], anch_a[3], anch_b[3];
  load_pose(sm, B, a, pos_a, qa);
  load_pose(sm, B, b, pos_b, qb);
  for (int d = 0; d < 3; ++d) {
    anch_a[d] = js.t(jANCH_A + d, j);
    anch_b[d] = js.t(jANCH_B + d, j);
  }
  float ra[3], rb[3], c3[3], axis_w[3];
  jrot(qa, anch_a, ra);
  jrot(qb, anch_b, rb);
  for (int d = 0; d < 3; ++d)
    c3[d] = (pos_b[d] + rb[d]) - (pos_a[d] + ra[d]);
  joint_axis(js, j, qa, axis_w);
  project_off(js.t(jKIND, j) == 3.0f, axis_w, c3);
  const float im_a = sm[kIM * B + a], im_b = sm[kIM * B + b];
  const float denom = fmaxf(im_a + im_b, 1e-9f);
  const int J = js.J;
  for (int d = 0; d < 3; ++d) {
    const float corr = 0.5f * c3[d];
    js.buf[d * J + j] = corr * im_a / denom;
    js.buf[(3 + d) * J + j] = -corr * im_b / denom;
  }
}

// Σ over body b's joints (ascending) of n delta rows starting at row0
__device__ __forceinline__ void joint_sums(const JointSmem& js,
                                           const int* ptr, const int* col,
                                           int b, int row0, int n, float* o) {
  for (int k = 0; k < n; ++k) o[k] = 0.0f;
  for (int e = ptr[b]; e < ptr[b + 1]; ++e) {
    const int j = col[e];
    for (int k = 0; k < n; ++k) o[k] += js.buf[(row0 + k) * js.J + j];
  }
}

// planes f0.. of every body += Σ side-A rows a0.. + Σ side-B rows b0..
__device__ void joint_apply(float* sm, const JointSmem& js, int B, int f0,
                            int n, int a0, int b0) {
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    float sa[6], sb[6];
    joint_sums(js, js.ptr_a, js.col_a, b, a0, n, sa);
    joint_sums(js, js.ptr_b, js.col_b, b, b0, n, sb);
    for (int k = 0; k < n; ++k)
      sm[(f0 + k) * B + b] = sm[(f0 + k) * B + b] + sa[k] + sb[k];
  }
}

// one Jacobi velocity pass over all joints (the point constraints, then
// the angular locks on the updated angular velocities)
__device__ void joint_velocity_pass(float* sm, const JointSmem& js, int B,
                                    float erp_h) {
  for (int j = threadIdx.x; j < js.J; j += blockDim.x)
    joint_point(sm, js, B, j, erp_h);
  __syncthreads();
  joint_apply(sm, js, B, kLV, 6, 0, 6);
  __syncthreads();
  for (int j = threadIdx.x; j < js.J; j += blockDim.x)
    joint_lock(sm, js, B, j, erp_h);
  __syncthreads();
  joint_apply(sm, js, B, kAV, 3, 0, 3);
  __syncthreads();
}

// one joint position pass
__device__ void joint_position_pass(float* sm, const JointSmem& js, int B) {
  for (int j = threadIdx.x; j < js.J; j += blockDim.x)
    joint_shift(sm, js, B, j);
  __syncthreads();
  joint_apply(sm, js, B, kPOS, 3, 0, 3);
  __syncthreads();
}

// ---------------------------------------------------------------- kernel

// shared memory of one block, in floats (tgs_kernel.smem_bytes / 4)
__host__ __device__ constexpr size_t smem_floats(bool has_com, int B, int Cg,
                                                 int J) {
  return (size_t)(kBodySmem + (has_com ? 3 : 0)) * B + 6 * (size_t)Cg
       + (size_t)(kJRows + 12 + 2) * J;
}

template <bool HAS_COM, bool HAS_JOINTS>
__global__ void __launch_bounds__(512)
tgs_solve_kernel(const float* __restrict__ con_all,
                 const int* __restrict__ bj_all,
                 const float* __restrict__ body_all,
                 const int* __restrict__ col_body,
                 const int* __restrict__ csr_ptr,
                 const int* __restrict__ csr_col,
                 float* __restrict__ body_out_all,
                 float* __restrict__ lam_all,
                 float* __restrict__ scr_all,
                 const float* __restrict__ jtab,
                 const int* __restrict__ joint_a,
                 const int* __restrict__ joint_b,
                 const int* __restrict__ jptr_a,
                 const int* __restrict__ jcol_a,
                 const int* __restrict__ jptr_b,
                 const int* __restrict__ jcol_b, Params p) {
  extern __shared__ float sm[];
  const int w = blockIdx.x;
  const int B = p.B, Cg = p.Cg, S = p.S, J = p.J;
  const int SC = S * Cg;
  float* buf = sm + (kBodySmem + (HAS_COM ? 3 : 0)) * B;   // [6, Cg]
  float* jt = buf + 6 * Cg;                                 // [20, J]
  float* jbuf = jt + kJRows * J;                            // [12, J]
  int* jab = reinterpret_cast<int*>(jbuf + 12 * J);         // [2, J]
  const JointSmem js{jt, jbuf, jab, jab + J, jptr_a, jcol_a, jptr_b, jcol_b,
                     J};
  const float erp_h = 0.2f / p.h;
  const float* con = con_all + (size_t)w * 15 * SC;
  const int* bj = bj_all + (size_t)w * SC;
  const float* body = body_all + (size_t)w * kBodyRows * B;
  float* body_out = body_out_all + (size_t)w * 13 * B;
  float* lam = lam_all + (size_t)w * 3 * SC;
  float* scr = scr_all + (size_t)w * 6 * SC;
  const int T = blockDim.x;

  // ---- load body planes; lever arms measure from the step-start world
  // centre of mass (the origin without COM offsets)
  for (int b = threadIdx.x; b < B; b += T) {
    for (int f = 0; f < 26; ++f) sm[f * B + b] = body[f * B + b];
    if constexpr (HAS_COM) {
      float q[4], cm[3], r[3];
      for (int k = 0; k < 4; ++k) q[k] = body[(kQ + k) * B + b];
      for (int d = 0; d < 3; ++d) {
        cm[d] = body[(kBodyCM + d) * B + b];
        sm[(kCM + d) * B + b] = cm[d];
      }
      jrot(q, cm, r);
      for (int d = 0; d < 3; ++d)
        sm[(kCOM + d) * B + b] = body[(kPOS + d) * B + b] + r[d];
    } else {
      for (int d = 0; d < 3; ++d)
        sm[(kCOM + d) * B + b] = body[(kPOS + d) * B + b];
    }
  }
  if constexpr (HAS_JOINTS) {
    for (int i = threadIdx.x; i < kJRows * J; i += T) jt[i] = jtab[i];
    for (int j = threadIdx.x; j < J; j += T) {
      jab[j] = joint_a[j];
      jab[J + j] = joint_b[j];
    }
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
    if constexpr (HAS_JOINTS) joint_velocity_pass(sm, js, B, erp_h);

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

    // ---- integrate (with COM offsets the COM moves linearly and the
    // origin follows the new orientation)
    for (int b = threadIdx.x; b < B; b += T) {
      float av[3], q0[4], cm[3], r0[3], r1[3], q1[4];
      for (int d = 0; d < 3; ++d) av[d] = sm[(kAV + d) * B + b];
      for (int k = 0; k < 4; ++k) q0[k] = sm[(kQ + k) * B + b];
      rotate_q(sm, B, b, av, 0.5f * p.h);
      if constexpr (HAS_COM) {
        for (int k = 0; k < 4; ++k) q1[k] = sm[(kQ + k) * B + b];
        for (int d = 0; d < 3; ++d) cm[d] = sm[(kCM + d) * B + b];
        jrot(q0, cm, r0);
        jrot(q1, cm, r1);
        for (int d = 0; d < 3; ++d) {
          const float com = sm[(kPOS + d) * B + b] + r0[d]
                          + p.h * sm[(kLV + d) * B + b];
          sm[(kPOS + d) * B + b] = com - r1[d];
        }
      } else {
        for (int d = 0; d < 3; ++d)
          sm[(kPOS + d) * B + b] += p.h * sm[(kLV + d) * B + b];
      }
    }
    __syncthreads();
  }

  // ---- joint position passes
  if constexpr (HAS_JOINTS)
    for (int it = 0; it < p.n_stab; ++it) joint_position_pass(sm, js, B);

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
      float shift[3] = {0.0f, 0.0f, 0.0f};
      if constexpr (HAS_COM) {
        // rotating about the COM shifts the origin: dθ × (−R(q) cm)
        float q[4], cm[3], r[3], arm[3];
        for (int k = 0; k < 4; ++k) q[k] = sm[(kQ + k) * B + b];
        for (int d = 0; d < 3; ++d) cm[d] = sm[(kCM + d) * B + b];
        jrot(q, cm, r);
        for (int d = 0; d < 3; ++d) arm[d] = -r[d];
        cross(dth, arm, shift);
      }
      for (int d = 0; d < 3; ++d) {
        sm[(kPOS + d) * B + b] += s6[d];
        if constexpr (HAS_COM) sm[(kPOS + d) * B + b] += shift[d];
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

template <bool HAS_COM, bool HAS_JOINTS>
int launch(const void* con, const void* body_j, const void* body,
           const void* col_body, const void* csr_ptr, const void* csr_col,
           void* body_out, void* lam_out, void* scratch, const void* jtab,
           const void* joint_a, const void* joint_b, const void* jptr_a,
           const void* jcol_a, const void* jptr_b, const void* jcol_b, int W,
           const Params& p, void* stream) {
  const size_t smem =
      sizeof(float) * smem_floats(HAS_COM, p.B, p.Cg, HAS_JOINTS ? p.J : 0);
  auto kern = tgs_solve_kernel<HAS_COM, HAS_JOINTS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<W, 512, smem, (cudaStream_t)stream>>>(
      (const float*)con, (const int*)body_j, (const float*)body,
      (const int*)col_body, (const int*)csr_ptr, (const int*)csr_col,
      (float*)body_out, (float*)lam_out, (float*)scratch, (const float*)jtab,
      (const int*)joint_a, (const int*)joint_b, (const int*)jptr_a,
      (const int*)jcol_a, (const int*)jptr_b, (const int*)jcol_b, p);
  return (int)cudaGetLastError();
}

}  // namespace

// joint pointers may be null when J == 0
extern "C" int fyrox_tgs_solve(const void* con, const void* body_j,
                               const void* body, const void* col_body,
                               const void* csr_ptr, const void* csr_col,
                               void* body_out, void* lam_out, void* scratch,
                               const void* jtab, const void* joint_a,
                               const void* joint_b, const void* jptr_a,
                               const void* jcol_a, const void* jptr_b,
                               const void* jcol_b, int W, int S, int Cg,
                               int B, int J, int has_com, int n_sub,
                               int n_pgs, int n_stab, float h, float allowed,
                               float max_corr, float rest_thr, float wc,
                               float erp, float bias_rate, float mscale_soft,
                               float iscale_soft, float msp, void* stream) {
  Params p{h, allowed, max_corr, rest_thr, wc, erp, bias_rate, mscale_soft,
           iscale_soft, msp, S, Cg, B, J, n_sub, n_pgs, n_stab};
  if (W == 0) return 0;
  const bool joints = J > 0;
#define FYROX_TGS_ARGS                                                     \
  con, body_j, body, col_body, csr_ptr, csr_col, body_out, lam_out,        \
      scratch, jtab, joint_a, joint_b, jptr_a, jcol_a, jptr_b, jcol_b, W, p, \
      stream
  if (has_com && joints) return launch<true, true>(FYROX_TGS_ARGS);
  if (has_com) return launch<true, false>(FYROX_TGS_ARGS);
  if (joints) return launch<false, true>(FYROX_TGS_ARGS);
  return launch<false, false>(FYROX_TGS_ARGS);
#undef FYROX_TGS_ARGS
}
