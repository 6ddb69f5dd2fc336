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
// colliders, B bodies, J joints, SC = S * Cg):
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
//   ent_f    [W,18,SC]   f32  scratch: the live slot list (below)
//   ent_i    [W,2,SC]    i32  scratch: its bodies A and B
//   masks    [W,Cg*⌈S/32⌉] u32  scratch: each collider's live slots as bits
//   live     [W]         i32  the live slots of each world
//   gws      [W,*]       f32  scratch of the global-memory variant: body
//                             planes, collider buffer, list offsets
//
// Design. Only a slot that is live (act != 0, or a nonzero warm impulse)
// changes anything: every update of a dead slot is an exact zero (its act
// multiplies the update, its λ stays 0, and adding a zero leaves a sum as
// it was). So prep builds each world's list of live slots, collider-major
// and in ascending slot order within a collider (no prefix order is assumed
// of the producer), into a compact, slot-contiguous scratch with the fields
// the passes read (normal, point, sign, act, friction, effective masses,
// restitution target, depth, peak and accumulated impulses): thread g
// marks collider g's live slots in bit masks and counts them, a block scan
// turns the counts into list offsets, and thread e fills entry e (coalesced
// stores). Every pass after prep walks that list only: at the flagship's
// mean of 3.8 live slots of 16 per collider, 80 B a slot for 128 worlds
// fit the 50 MB L2. The output λ is written slot by slot at the end, 0 for
// the dead. The tangent frame and the lever arms (from the step-start
// centre of mass, fixed for the solve) are re-derived from the point and
// the normal, which costs fewer bytes than storing them.
//
// Each solver pass is two Jacobi phases separated by __syncthreads():
//   1. slot phase: thread e (striding over the live slots of a tile)
//      computes slot e's impulse from the current body velocities and
//      writes its self half (linear impulse × inverse mass, torque) to a
//      shared slot buffer; after a barrier, thread g sums collider g's
//      slots in slot order into the per-collider buffer. The list goes
//      through in tiles of whole colliders that fit the slot buffer (one
//      or two at the flagship);
//   2. body phase: thread b sums its colliders' buffer entries through the
//      CSR list in ascending order and updates its velocities.
// The joint passes have the same two phases: thread j computes joint j's
// impulse from the body planes (a gather is a load; the TPU's one-hot dots
// are gone), then thread b adds its side-A joints' deltas and then its
// side-B joints', each list in ascending joint order. A velocity pass runs
// the point constraints, then (after the bodies took them) the angular
// locks, which read the updated angular velocities. There are no float
// atomics, so a run repeats bit for bit.
//
// Centre-of-mass offsets (template parameter HAS_COM, so the flagship's
// code is unchanged): lever arms measure from the step-start world COM
// pos + R(q0) cm; integration moves the COM by h lv and re-derives the
// origin from the new orientation; an NGS rotation dθ shifts the origin by
// dθ × (−R(q) cm).
//
// Capacity (template parameter BIG): the body planes (30 x B floats, 33
// with COM offsets), the per-collider buffer, the list offsets and a copy
// of the CSR lists live in dynamic shared memory where they fit beside the
// joint tables and a slot buffer (B <= 1,591 at Cg = 1,000); otherwise the
// planes, buffer and offsets live in a global scratch of the world (~250
// KB at B = 2,000, read through L1/L2; __syncthreads orders the block's
// global writes as it does its shared ones), and the slot buffer is held
// to 4,096 slots so that the rest of the SM's 256 KB serves as L1. The
// wrapper picks the variant from the shapes alone.
//
// Bound: with one CTA per world, W=128 worlds occupy 128 of the H100's 132
// SMs, one CTA each. Each pass streams the world's live slots (~15 floats
// each) from L2 and spends a block-wide barrier per phase: the kernel is
// bound by those loads and by the per-SM latency of the serial passes, not
// by arithmetic. The joint passes add four barriers per substep and two per
// position pass, with at most 128 busy threads.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

// body planes: index f*B + b (kCM only with HAS_COM)
enum {
  kLV = 0, kAV = 3, kPOS = 6, kQ = 9, kACC = 13, kIM = 16, kII = 17,
  kCNT = 26, kCOM = 27, kBodyPlanes = 30, kCM = 30
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
// fields of a live slot (ent_f [18, SC], ent_i [2, SC] per world); eLMX
// holds the slot's `own` until the effective masses are computed
enum {
  eN = 0, ePT = 3, eSIG = 6, eACT = 7, eFRIC = 8, eMN = 9, eMT1 = 10,
  eMT2 = 11, eREST = 12, eDEPTH = 13, eLMX = 14, eLAM = 15, kEntF = 18
};
enum { eIA = 0, eIB = 1, kEntI = 2 };

struct Params {
  float h, allowed, max_corr, rest_thr, wc, erp, bias_rate, mscale_soft,
      iscale_soft, msp;
  int S, Cg, B, J, n_sub, n_pgs, n_stab, tile;
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

// One live slot's geometry, re-derived from its list fields on every pass.
struct Slot {
  float n[3], t1[3], t2[3], ra[3], rb[3], rs[3];
  float sigma, act;
  int ia, ib, is;   // body of side A, side B, self
};

__device__ __forceinline__ void load_slot(const float* ef, const int* ei,
                                          const float* bp, int e, int SC,
                                          int B, Slot& o) {
  for (int d = 0; d < 3; ++d) o.n[d] = ef[(eN + d) * SC + e];
  float pt[3];
  for (int d = 0; d < 3; ++d) pt[d] = ef[(ePT + d) * SC + e];
  o.sigma = ef[eSIG * SC + e];
  o.act = ef[eACT * SC + e];
  o.ia = ei[eIA * SC + e];
  o.ib = ei[eIB * SC + e];
  o.is = o.sigma < 0.0f ? o.ib : o.ia;
  for (int d = 0; d < 3; ++d) {
    o.ra[d] = pt[d] - bp[(kCOM + d) * B + o.ia];
    o.rb[d] = pt[d] - bp[(kCOM + d) * B + o.ib];
    o.rs[d] = pt[d] - bp[(kCOM + d) * B + o.is];
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
// velocity planes (or the NGS position/rotation deltas)
__device__ __forceinline__ void rel_vel(const Slot& s, const float* bp,
                                        int lin, int ang, int B, float* rv) {
  float la[3], aa[3], lb[3], ab[3], ca[3], cb[3];
  for (int d = 0; d < 3; ++d) {
    la[d] = bp[(lin + d) * B + s.ia];
    aa[d] = bp[(ang + d) * B + s.ia];
    lb[d] = bp[(lin + d) * B + s.ib];
    ab[d] = bp[(ang + d) * B + s.ib];
  }
  cross(aa, s.ra, ca);
  cross(ab, s.rb, cb);
  for (int d = 0; d < 3; ++d) rv[d] = (lb[d] + cb[d]) - (la[d] + ca[d]);
}

// self half of an impulse (A convention): linear impulse × inverse mass and
// torque, the six values a collider sums over its slots
__device__ __forceinline__ void self_half(const Slot& s, const float* imp,
                                          const float* bp, int B, float* v) {
  float is[3], tq[3];
  const float im = bp[kIM * B + s.is];
  for (int d = 0; d < 3; ++d) is[d] = -s.sigma * imp[d];
  cross(s.rs, is, tq);
  for (int d = 0; d < 3; ++d) {
    v[d] = is[d] * im;
    v[3 + d] = tq[d];
  }
}

__device__ __forceinline__ void mv_ii(const float* bp, int B, int b,
                                      const float* v, float* o) {
  for (int r = 0; r < 3; ++r)
    o[r] = bp[(kII + 3 * r) * B + b] * v[0]
         + bp[(kII + 3 * r + 1) * B + b] * v[1]
         + bp[(kII + 3 * r + 2) * B + b] * v[2];
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
__device__ void apply_velocity(float* bp, const float* buf, const int* ptr,
                               const int* col, const Params& p) {
  for (int b = threadIdx.x; b < p.B; b += blockDim.x) {
    float s[6], dav[3];
    body_sums(buf, ptr, col, p.Cg, b, s);
    mv_ii(bp, p.B, b, s + 3, dav);
    for (int d = 0; d < 3; ++d) {
      bp[(kLV + d) * p.B + b] += s[d];
      bp[(kAV + d) * p.B + b] += dav[d];
    }
  }
}

// q ← normalize(q + scale * (ω,0)⊗q)
__device__ __forceinline__ void rotate_q(float* bp, int B, int b,
                                         const float* w, float scale) {
  const float q0 = bp[(kQ + 0) * B + b], q1 = bp[(kQ + 1) * B + b];
  const float q2 = bp[(kQ + 2) * B + b], q3 = bp[(kQ + 3) * B + b];
  const float d0 = q3 * w[0] + w[1] * q2 - w[2] * q1;
  const float d1 = q3 * w[1] - w[0] * q2 + w[2] * q0;
  const float d2 = q3 * w[2] + w[0] * q1 - w[1] * q0;
  const float d3 = -w[0] * q0 - w[1] * q1 - w[2] * q2;
  const float n0 = q0 + scale * d0, n1 = q1 + scale * d1;
  const float n2 = q2 + scale * d2, n3 = q3 + scale * d3;
  const float inv =
      1.0f / sqrtf(n0 * n0 + n1 * n1 + n2 * n2 + n3 * n3 + 1e-30f);
  bp[(kQ + 0) * B + b] = n0 * inv;
  bp[(kQ + 1) * B + b] = n1 * inv;
  bp[(kQ + 2) * B + b] = n2 * inv;
  bp[(kQ + 3) * B + b] = n3 * inv;
}

// The live slot list of one world and the buffers the passes share.
struct List {
  float* ef;       // [18, SC] slot fields
  int* ei;         // [3, SC] bodies A, B and the slot index
  int* eptr;       // [Cg + 1] each collider's first slot in the list
  float* buf;      // [6, Cg] per-collider sums
  float* sbuf;     // [6, tile] per-slot self halves of one tile
  int SC, Cg, tile;
};

// One impulse pass's first phase over the live slots: slot_fn(e, v) gives
// slot e's six self-half values; each collider's sum over its slots, in
// slot order, lands in buf. Tiles of whole colliders fit the slot buffer.
template <class F>
__device__ void collider_sums(const List& L, F slot_fn) {
  const int T = blockDim.x, tid = threadIdx.x;
  for (int g0 = 0; g0 < L.Cg;) {
    const int e0 = L.eptr[g0];
    // the last collider boundary within one tile of e0 (a collider holds
    // at most S <= tile slots, so the tile takes at least one collider)
    int lo = g0 + 1, hi = L.Cg;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (L.eptr[mid] - e0 <= L.tile) lo = mid;
      else hi = mid - 1;
    }
    const int g1 = lo, e1 = L.eptr[g1];
    for (int e = e0 + tid; e < e1; e += T) {
      float v[6];
      slot_fn(e, v);
      for (int k = 0; k < 6; ++k) L.sbuf[k * L.tile + (e - e0)] = v[k];
    }
    __syncthreads();
    for (int g = g0 + tid; g < g1; g += T) {
      float acc[6] = {0, 0, 0, 0, 0, 0};
      for (int e = L.eptr[g]; e < L.eptr[g + 1]; ++e)
        for (int k = 0; k < 6; ++k) acc[k] += L.sbuf[k * L.tile + (e - e0)];
      for (int k = 0; k < 6; ++k) L.buf[k * L.Cg + g] = acc[k];
    }
    __syncthreads();
    g0 = g1;
  }
}

// block-wide exclusive scan of n ints in place (n may exceed the block);
// `part` holds blockDim.x ints. Ends with a barrier.
__device__ void exclusive_scan(int* x, int n, int* part) {
  const int T = blockDim.x, tid = threadIdx.x;
  const int run = (n + T - 1) / T;
  const int lo = min(tid * run, n), hi = min(lo + run, n);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += x[i];
  part[tid] = s;
  __syncthreads();
  for (int d = 1; d < T; d <<= 1) {
    const int v = tid >= d ? part[tid - d] : 0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  int base = tid > 0 ? part[tid - 1] : 0;
  for (int i = lo; i < hi; ++i) {
    const int c = x[i];
    x[i] = base;
    base += c;
  }
  __syncthreads();
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

// shared-memory views of the joint tables (the body planes `bp` may be in
// shared or global memory)
struct JointSmem {
  const float* tab;   // [20,J]
  float* buf;         // [12,J] per-joint deltas
  const int* ja;      // [J]
  const int* jb;      // [J]
  const int *ptr_a, *col_a, *ptr_b, *col_b;   // global CSR lists
  int J;
  __device__ float t(int row, int j) const { return tab[row * J + j]; }
};

__device__ __forceinline__ void load_pose(const float* bp, int B, int b,
                                          float* pos, float* q) {
  for (int d = 0; d < 3; ++d) pos[d] = bp[(kPOS + d) * B + b];
  for (int k = 0; k < 4; ++k) q[k] = bp[(kQ + k) * B + b];
}

__device__ __forceinline__ void load_ii(const float* bp, int B, int b,
                                        float* ii) {
  for (int k = 0; k < 9; ++k) ii[k] = bp[(kII + k) * B + b];
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
__device__ void joint_point(const float* bp, const JointSmem& js, int B,
                            int j, float erp_h) {
  const int a = js.ja[j], b = js.jb[j];
  float pos_a[3], qa[4], pos_b[3], qb[4], ii_a[9], ii_b[9];
  load_pose(bp, B, a, pos_a, qa);
  load_pose(bp, B, b, pos_b, qb);
  load_ii(bp, B, a, ii_a);
  load_ii(bp, B, b, ii_b);
  const float im_a = bp[kIM * B + a], im_b = bp[kIM * B + b];
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
    av_a[d] = bp[(kAV + d) * B + a];
    av_b[d] = bp[(kAV + d) * B + b];
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
    const float va = bp[(kLV + d) * B + a] + ca[d];
    const float vb = bp[(kLV + d) * B + b] + cb[d];
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
__device__ void joint_lock(const float* bp, const JointSmem& js, int B, int j,
                           float erp_h) {
  const int a = js.ja[j], b = js.jb[j];
  float pos_a[3], qa[4], pos_b[3], qb[4], ii_a[9], ii_b[9];
  load_pose(bp, B, a, pos_a, qa);
  load_pose(bp, B, b, pos_b, qb);
  load_ii(bp, B, a, ii_a);
  load_ii(bp, B, b, ii_b);
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
    const float rel_w = bp[(kAV + d) * B + b] - bp[(kAV + d) * B + a];
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
__device__ void joint_shift(const float* bp, const JointSmem& js, int B,
                            int j) {
  const int a = js.ja[j], b = js.jb[j];
  float pos_a[3], qa[4], pos_b[3], qb[4], anch_a[3], anch_b[3];
  load_pose(bp, B, a, pos_a, qa);
  load_pose(bp, B, b, pos_b, qb);
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
  const float im_a = bp[kIM * B + a], im_b = bp[kIM * B + b];
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
__device__ void joint_apply(float* bp, const JointSmem& js, int B, int f0,
                            int n, int a0, int b0) {
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    float sa[6], sb[6];
    joint_sums(js, js.ptr_a, js.col_a, b, a0, n, sa);
    joint_sums(js, js.ptr_b, js.col_b, b, b0, n, sb);
    for (int k = 0; k < n; ++k)
      bp[(f0 + k) * B + b] = bp[(f0 + k) * B + b] + sa[k] + sb[k];
  }
}

// one Jacobi velocity pass over all joints (the point constraints, then
// the angular locks on the updated angular velocities)
__device__ void joint_velocity_pass(float* bp, const JointSmem& js, int B,
                                    float erp_h) {
  for (int j = threadIdx.x; j < js.J; j += blockDim.x)
    joint_point(bp, js, B, j, erp_h);
  __syncthreads();
  joint_apply(bp, js, B, kLV, 6, 0, 6);
  __syncthreads();
  for (int j = threadIdx.x; j < js.J; j += blockDim.x)
    joint_lock(bp, js, B, j, erp_h);
  __syncthreads();
  joint_apply(bp, js, B, kAV, 3, 0, 3);
  __syncthreads();
}

// one joint position pass
__device__ void joint_position_pass(float* bp, const JointSmem& js, int B) {
  for (int j = threadIdx.x; j < js.J; j += blockDim.x)
    joint_shift(bp, js, B, j);
  __syncthreads();
  joint_apply(bp, js, B, kPOS, 3, 0, 3);
  __syncthreads();
}

// ---------------------------------------------------------------- kernel

// Shared memory of one block, in floats: with !BIG the body planes, the
// per-collider buffer, the list offsets and a copy of the body → collider
// CSR lists, then (both variants) the joint tables and the slot buffer
// (tgs_kernel._layout computes the same).
__host__ __device__ constexpr size_t world_floats(bool has_com, int B,
                                                  int Cg) {
  return (size_t)(kBodyPlanes + (has_com ? 3 : 0)) * B + 6 * (size_t)Cg
       + (size_t)Cg + 1;
}
__host__ __device__ constexpr size_t smem_floats(bool big, bool has_com,
                                                 int B, int Cg, int J,
                                                 int tile) {
  return (big ? 0 : world_floats(has_com, B, Cg) + (size_t)B + 1 + Cg)
       + (size_t)(kJRows + 12 + 2) * J + 6 * (size_t)tile;
}

template <bool HAS_COM, bool HAS_JOINTS, bool BIG>
__global__ void __launch_bounds__(kThreads)
tgs_solve_kernel(const float* __restrict__ con_all,
                 const int* __restrict__ bj_all,
                 const float* __restrict__ body_all,
                 const int* __restrict__ col_body,
                 const int* __restrict__ csr_ptr,
                 const int* __restrict__ csr_col,
                 float* __restrict__ body_out_all,
                 float* __restrict__ lam_all,
                 float* ef_all, int* ei_all, unsigned* masks_all,
                 int* live_all, float* gws_all,
                 const float* __restrict__ jtab,
                 const int* __restrict__ joint_a,
                 const int* __restrict__ joint_b,
                 const int* __restrict__ jptr_a,
                 const int* __restrict__ jcol_a,
                 const int* __restrict__ jptr_b,
                 const int* __restrict__ jcol_b, Params p) {
  extern __shared__ float smem[];
  const int w = blockIdx.x;
  const int B = p.B, Cg = p.Cg, S = p.S, J = p.J;
  const int SC = S * Cg;
  const int planes = kBodyPlanes + (HAS_COM ? 3 : 0);
  // the world's body planes, collider buffer and list offsets: in shared
  // memory, or (BIG) in the world's global scratch
  float* wmem = BIG ? gws_all + (size_t)w * world_floats(HAS_COM, B, Cg)
                    : smem;
  float* bp = wmem;                                         // [planes, B]
  float* buf = bp + (size_t)planes * B;                     // [6, Cg]
  int* eptr = reinterpret_cast<int*>(buf + 6 * Cg);         // [Cg + 1]
  int* cptr_s = eptr + Cg + 1;                              // [B + 1]
  int* ccol_s = cptr_s + B + 1;                             // [Cg]
  const int* cptr = BIG ? csr_ptr : cptr_s;
  const int* ccol = BIG ? csr_col : ccol_s;
  float* jt = BIG ? smem : reinterpret_cast<float*>(ccol_s + Cg);
  float* jbuf = jt + kJRows * J;                            // [12, J]
  int* jab = reinterpret_cast<int*>(jbuf + 12 * J);         // [2, J]
  float* sbuf = reinterpret_cast<float*>(jab + 2 * J);      // [6, tile]
  const JointSmem js{jt, jbuf, jab, jab + J, jptr_a, jcol_a, jptr_b, jcol_b,
                     J};
  const float erp_h = 0.2f / p.h;
  const float* con = con_all + (size_t)w * 15 * SC;
  const int* bj = bj_all + (size_t)w * SC;
  const float* body = body_all + (size_t)w * kBodyRows * B;
  float* body_out = body_out_all + (size_t)w * 13 * B;
  float* lam = lam_all + (size_t)w * 3 * SC;
  float* ef = ef_all + (size_t)w * kEntF * SC;
  int* ei = ei_all + (size_t)w * kEntI * SC;
  const List L{ef, ei, eptr, buf, sbuf, SC, Cg, p.tile};
  const int T = blockDim.x, tid = threadIdx.x;

  // ---- load body planes; lever arms measure from the step-start world
  // centre of mass (the origin without COM offsets)
  for (int b = tid; b < B; b += T) {
    for (int f = 0; f < 26; ++f) bp[f * B + b] = body[f * B + b];
    if constexpr (HAS_COM) {
      float q[4], cm[3], r[3];
      for (int k = 0; k < 4; ++k) q[k] = body[(kQ + k) * B + b];
      for (int d = 0; d < 3; ++d) {
        cm[d] = body[(kBodyCM + d) * B + b];
        bp[(kCM + d) * B + b] = cm[d];
      }
      jrot(q, cm, r);
      for (int d = 0; d < 3; ++d)
        bp[(kCOM + d) * B + b] = body[(kPOS + d) * B + b] + r[d];
    } else {
      for (int d = 0; d < 3; ++d)
        bp[(kCOM + d) * B + b] = body[(kPOS + d) * B + b];
    }
  }
  if constexpr (!BIG) {
    for (int i = tid; i <= B; i += T) cptr_s[i] = csr_ptr[i];
    for (int i = tid; i < Cg; i += T) ccol_s[i] = csr_col[i];
  }
  if constexpr (HAS_JOINTS) {
    for (int i = tid; i < kJRows * J; i += T) jt[i] = jtab[i];
    for (int j = tid; j < J; j += T) {
      jab[j] = joint_a[j];
      jab[J + j] = joint_b[j];
    }
  }

  // ---- the live slot list. Each collider's live slots go 32 at a time
  // into bit masks (global scratch, the loads unrolled so that many are
  // in flight), their counts are scanned into list offsets, and then
  // thread per slot copies each live slot's fields to its list entry:
  // both passes read the contact planes coalesced.
  const int words = (S + 31) / 32;
  unsigned* masks = masks_all + (size_t)w * Cg * words;
  for (int g = tid; g <= Cg; g += T) {
    int n = 0;
    for (int q = 0; g < Cg && q < words; ++q) {
      const int ns = min(32, S - 32 * q);
      unsigned mask = 0;
#pragma unroll 8
      for (int u = 0; u < ns; ++u) {
        const int c = (32 * q + u) * Cg + g;
        const bool on = (con[cACT * SC + c] != 0.0f)
                      | (con[cLAM * SC + c] != 0.0f)
                      | (con[(cLAM + 1) * SC + c] != 0.0f)
                      | (con[(cLAM + 2) * SC + c] != 0.0f);
        mask |= on ? 1u << u : 0u;
      }
      masks[(size_t)g * words + q] = mask;
      n += __popc(mask);
    }
    eptr[g] = n;
  }
  __syncthreads();
  exclusive_scan(eptr, Cg + 1, reinterpret_cast<int*>(sbuf));
  const int E = eptr[Cg];
  if (tid == 0) live_all[w] = E;
  // list position of slot (s, g), or -1 where the slot is dead
  auto entry_of = [&](int s, int g) {
    const unsigned* mk = masks + (size_t)g * words;
    const unsigned m = mk[s >> 5];
    if (!((m >> (s & 31)) & 1u)) return -1;
    int e = eptr[g];
    for (int q = 0; q < (s >> 5); ++q) e += __popc(mk[q]);
    return e + __popc(m & ((1u << (s & 31)) - 1u));
  };
  // Thread e fills list entry e, so that the list's stores are coalesced:
  // its collider g is the last whose offset is at most e, its slot the
  // (e - eptr[g])-th live bit of g's masks. Four entries a thread at a
  // time, all their loads before any store (the compiler may not move a
  // load of `con` past a store to the list), so they are in flight
  // together.
  const int src[15] = {cN, cN + 1, cN + 2, cPT, cPT + 1, cPT + 2, cLAM,
                       cLAM + 1, cLAM + 2, cSIGMA, cACT, cFRIC, cREST,
                       cDEPTH, cOWN};
  const int dst[15] = {eN, eN + 1, eN + 2, ePT, ePT + 1, ePT + 2, eLAM,
                       eLAM + 1, eLAM + 2, eSIG, eACT, eFRIC, eREST,
                       eDEPTH, eLMX};
  for (int e0 = tid; e0 < E; e0 += 4 * T) {
    int c[4], self_b[4], j[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * T;
      c[u] = -1;
      if (e >= E) continue;
      int lo = 0, hi = Cg - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (eptr[mid] <= e) lo = mid;
        else hi = mid - 1;
      }
      const unsigned* mk = masks + (size_t)lo * words;
      int r = e - eptr[lo], q = 0;
      while (__popc(mk[q]) <= r) r -= __popc(mk[q++]);
      unsigned m = mk[q];
      for (; r > 0; --r) m &= m - 1u;
      c[u] = (32 * q + __ffs((int)m) - 1) * Cg + lo;
      self_b[u] = col_body[lo];
    }
    float f[4][15];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c[u] < 0) continue;
#pragma unroll
      for (int k = 0; k < 15; ++k) f[u][k] = con[src[k] * SC + c[u]];
      j[u] = bj[c[u]];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c[u] < 0) continue;
      const int e = e0 + u * T;
#pragma unroll
      for (int k = 0; k < 15; ++k) ef[dst[k] * SC + e] = f[u][k];
      const bool swapped = f[u][9] < 0.0f;
      ei[eIA * SC + e] = swapped ? j[u] : self_b[u];
      ei[eIB * SC + e] = swapped ? self_b[u] : j[u];
    }
  }
  __syncthreads();
  // mass-splitting counts: Σ act/own over each collider's slots in slot
  // order (a dead slot adds an exact zero), then per body
  for (int g = tid; g < Cg; g += T) {
    float acc = 0.0f;
    for (int e = eptr[g]; e < eptr[g + 1]; ++e)
      acc += ef[eACT * SC + e] / fmaxf(ef[eLMX * SC + e], 1.0f);
    buf[g] = acc;
  }
  __syncthreads();
  for (int b = tid; b < B; b += T) {
    float cnt = 0.0f;
    for (int e = cptr[b]; e < cptr[b + 1]; ++e) cnt += buf[ccol[e]];
    cnt = fmaxf(cnt, 1.0f);
    if (p.msp == 0.5f) cnt = sqrtf(cnt);
    else if (p.msp != 1.0f) cnt = powf(cnt, p.msp);
    bp[kCNT * B + b] = cnt;
  }
  __syncthreads();

  // ---- constraint prep: effective masses, restitution targets
  for (int e = tid; e < E; e += T) {
    Slot sl;
    load_slot(ef, ei, bp, e, SC, B, sl);
    const float own = fmaxf(ef[eLMX * SC + e], 1.0f);
    const float im_a = bp[kIM * B + sl.ia], im_b = bp[kIM * B + sl.ib];
    const float cnt_a = bp[kCNT * B + sl.ia] * own;
    const float cnt_b = bp[kCNT * B + sl.ib] * own;
    const float* dirs[3] = {sl.n, sl.t1, sl.t2};
    float m[3];
    for (int k = 0; k < 3; ++k) {
      float xa[3], xb[3], ia[3], ib[3];
      cross(sl.ra, dirs[k], xa);
      cross(sl.rb, dirs[k], xb);
      mv_ii(bp, B, sl.ia, xa, ia);
      mv_ii(bp, B, sl.ib, xb, ib);
      const float kk = im_a * cnt_a + im_b * cnt_b + cnt_a * dot(xa, ia)
                     + cnt_b * dot(xb, ib);
      m[k] = 1.0f / fmaxf(kk, 1e-12f);
    }
    float rv[3];
    rel_vel(sl, bp, kLV, kAV, B, rv);
    const float v0n = dot(rv, sl.n);
    const float rest = ef[eREST * SC + e];
    ef[eMN * SC + e] = m[0];
    ef[eMT1 * SC + e] = m[1];
    ef[eMT2 * SC + e] = m[2];
    ef[eREST * SC + e] = v0n < -p.rest_thr ? -rest * v0n : 0.0f;
    ef[eLMX * SC + e] = 0.0f;
  }
  __syncthreads();

  for (int sub = 0; sub < p.n_sub; ++sub) {
    for (int b = tid; b < B; b += T)
      for (int d = 0; d < 3; ++d)
        bp[(kLV + d) * B + b] += p.h * bp[(kACC + d) * B + b];
    __syncthreads();
    if constexpr (HAS_JOINTS) joint_velocity_pass(bp, js, B, erp_h);

    // ---- warm start
    collider_sums(L, [&](int e, float* v) {
      Slot sl;
      load_slot(ef, ei, bp, e, SC, B, sl);
      const float ln = ef[eLAM * SC + e] * p.wc;
      const float l1 = ef[(eLAM + 1) * SC + e] * p.wc;
      const float l2 = ef[(eLAM + 2) * SC + e] * p.wc;
      ef[eLAM * SC + e] = ln;
      ef[(eLAM + 1) * SC + e] = l1;
      ef[(eLAM + 2) * SC + e] = l2;
      float imp[3];
      for (int d = 0; d < 3; ++d)
        imp[d] = ln * sl.n[d] + l1 * sl.t1[d] + l2 * sl.t2[d];
      self_half(sl, imp, bp, B, v);
    });
    apply_velocity(bp, buf, cptr, ccol, p);
    __syncthreads();

    // ---- soft PGS: normal (soft, then hard speculative clamp) + friction
    for (int it = 0; it < p.n_pgs; ++it) {
      collider_sums(L, [&](int e, float* v) {
        Slot sl;
        load_slot(ef, ei, bp, e, SC, B, sl);
        // every field is loaded before the first store to the list
        const float m_n = ef[eMN * SC + e], depth = ef[eDEPTH * SC + e];
        const float lam_n = ef[eLAM * SC + e];
        const float l1 = ef[(eLAM + 1) * SC + e];
        const float l2 = ef[(eLAM + 2) * SC + e];
        const float fric = ef[eFRIC * SC + e];
        const float m_t1 = ef[eMT1 * SC + e], m_t2 = ef[eMT2 * SC + e];
        const float sep = -(depth - p.allowed);
        const float bias = sep > 0.0f ? sep / p.h
                                      : fmaxf(p.bias_rate * sep, -p.max_corr);
        const float mscale = sep > 0.0f ? 1.0f : p.mscale_soft;
        const float iscale = sep > 0.0f ? 0.0f : p.iscale_soft;
        float rv[3];
        rel_vel(sl, bp, kLV, kAV, B, rv);
        const float vn = dot(rv, sl.n);
        const float dl = (-m_n * mscale * (vn + bias) - iscale * lam_n)
                       * sl.act;
        const float new_n = fmaxf(lam_n + dl, 0.0f);
        const float vn2 = vn + (new_n - lam_n) / fmaxf(m_n, 1e-12f);
        const float spec = sep > 0.0f ? bias : 0.0f;
        const float new_n2 = fmaxf(new_n - m_n * (vn2 + spec) * sl.act,
                                   0.0f);
        const float dn = new_n2 - lam_n;
        ef[eLAM * SC + e] = new_n2;
        const float max_f = fric * new_n2;
        const float n1 = fminf(fmaxf(l1 - m_t1 * dot(rv, sl.t1) * sl.act,
                                     -max_f), max_f);
        const float n2 = fminf(fmaxf(l2 - m_t2 * dot(rv, sl.t2) * sl.act,
                                     -max_f), max_f);
        ef[(eLAM + 1) * SC + e] = n1;
        ef[(eLAM + 2) * SC + e] = n2;
        const float d1 = n1 - l1, d2 = n2 - l2;
        float imp[3];
        for (int d = 0; d < 3; ++d)
          imp[d] = dn * sl.n[d] + d1 * sl.t1[d] + d2 * sl.t2[d];
        self_half(sl, imp, bp, B, v);
      });
      apply_velocity(bp, buf, cptr, ccol, p);
      __syncthreads();
    }

    // ---- track the peak normal impulse; advance depths by the end-of-
    // substep approach velocity
    for (int e = tid; e < E; e += T) {
      Slot sl;
      load_slot(ef, ei, bp, e, SC, B, sl);
      const float lmx = ef[eLMX * SC + e], lam_n = ef[eLAM * SC + e];
      const float depth = ef[eDEPTH * SC + e];
      float rv[3];
      rel_vel(sl, bp, kLV, kAV, B, rv);
      ef[eLMX * SC + e] = fmaxf(lmx, lam_n);
      ef[eDEPTH * SC + e] = depth - p.h * dot(rv, sl.n);
    }
    __syncthreads();

    // ---- integrate (with COM offsets the COM moves linearly and the
    // origin follows the new orientation)
    for (int b = tid; b < B; b += T) {
      float av[3], q0[4], cm[3], r0[3], r1[3], q1[4];
      for (int d = 0; d < 3; ++d) av[d] = bp[(kAV + d) * B + b];
      for (int k = 0; k < 4; ++k) q0[k] = bp[(kQ + k) * B + b];
      rotate_q(bp, B, b, av, 0.5f * p.h);
      if constexpr (HAS_COM) {
        for (int k = 0; k < 4; ++k) q1[k] = bp[(kQ + k) * B + b];
        for (int d = 0; d < 3; ++d) cm[d] = bp[(kCM + d) * B + b];
        jrot(q0, cm, r0);
        jrot(q1, cm, r1);
        for (int d = 0; d < 3; ++d) {
          const float com = bp[(kPOS + d) * B + b] + r0[d]
                          + p.h * bp[(kLV + d) * B + b];
          bp[(kPOS + d) * B + b] = com - r1[d];
        }
      } else {
        for (int d = 0; d < 3; ++d)
          bp[(kPOS + d) * B + b] += p.h * bp[(kLV + d) * B + b];
      }
    }
    __syncthreads();
  }

  // ---- joint position passes
  if constexpr (HAS_JOINTS)
    for (int it = 0; it < p.n_stab; ++it) joint_position_pass(bp, js, B);

  // ---- restitution (add-only, where the contact carried impulse)
  collider_sums(L, [&](int e, float* v) {
    Slot sl;
    load_slot(ef, ei, bp, e, SC, B, sl);
    float rv[3];
    rel_vel(sl, bp, kLV, kAV, B, rv);
    const float vn = dot(rv, sl.n);
    const float gate = ef[eLMX * SC + e] > 0.0f ? 1.0f : 0.0f;
    const float dl = fmaxf(-ef[eMN * SC + e] * (vn - ef[eREST * SC + e]),
                           0.0f) * sl.act * gate;
    ef[eLAM * SC + e] += dl;
    float imp[3];
    for (int d = 0; d < 3; ++d) imp[d] = dl * sl.n[d];
    self_half(sl, imp, bp, B, v);
  });
  apply_velocity(bp, buf, cptr, ccol, p);
  __syncthreads();
  // velocities are final: write them out, then reuse their planes for the
  // NGS position/rotation deltas
  for (int b = tid; b < B; b += T) {
    for (int f = 0; f < 6; ++f) {
      body_out[f * B + b] = bp[f * B + b];
      bp[f * B + b] = 0.0f;
    }
  }
  __syncthreads();

  // ---- NGS position stabilisation
  const int kDP = kLV, kDTH = kAV;
  for (int it = 0; it < p.n_stab; ++it) {
    collider_sums(L, [&](int e, float* v) {
      Slot sl;
      load_slot(ef, ei, bp, e, SC, B, sl);
      const float corr = p.erp * fmaxf(ef[eDEPTH * SC + e] - p.allowed,
                                       0.0f);
      const float p_imp = ef[eMN * SC + e] * corr * sl.act;
      float imp[3];
      for (int d = 0; d < 3; ++d) imp[d] = p_imp * sl.n[d];
      self_half(sl, imp, bp, B, v);
    });
    for (int b = tid; b < B; b += T) {
      float s6[6], dth[3];
      body_sums(buf, cptr, ccol, Cg, b, s6);
      mv_ii(bp, B, b, s6 + 3, dth);
      float shift[3] = {0.0f, 0.0f, 0.0f};
      if constexpr (HAS_COM) {
        // rotating about the COM shifts the origin: dθ × (−R(q) cm)
        float q[4], cm[3], r[3], arm[3];
        for (int k = 0; k < 4; ++k) q[k] = bp[(kQ + k) * B + b];
        for (int d = 0; d < 3; ++d) cm[d] = bp[(kCM + d) * B + b];
        jrot(q, cm, r);
        for (int d = 0; d < 3; ++d) arm[d] = -r[d];
        cross(dth, arm, shift);
      }
      for (int d = 0; d < 3; ++d) {
        bp[(kPOS + d) * B + b] += s6[d];
        if constexpr (HAS_COM) bp[(kPOS + d) * B + b] += shift[d];
        bp[(kDP + d) * B + b] = s6[d];
        bp[(kDTH + d) * B + b] = dth[d];
      }
      rotate_q(bp, B, b, dth, 0.5f);
    }
    __syncthreads();
    for (int e = tid; e < E; e += T) {
      Slot sl;
      load_slot(ef, ei, bp, e, SC, B, sl);
      float rc[3];
      rel_vel(sl, bp, kDP, kDTH, B, rc);
      ef[eDEPTH * SC + e] -= dot(rc, sl.n);
    }
    __syncthreads();
  }

  for (int b = tid; b < B; b += T) {
    for (int f = 6; f < 13; ++f) body_out[f * B + b] = bp[f * B + b];
  }
  // λ of every slot, coalesced: the list's for the live, 0 for the dead
  // (four slots at a time, their loads in flight together)
  for (int s0 = 0; s0 < S; s0 += 4) {
    for (int g = tid; g < Cg; g += T) {
      float l[4][3];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = s0 + u < S ? entry_of(s0 + u, g) : -1;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          l[u][k] = e < 0 ? 0.0f : ef[(eLAM + k) * SC + e];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (s0 + u < S)
          for (int k = 0; k < 3; ++k)
            lam[k * SC + (s0 + u) * Cg + g] = l[u][k];
    }
  }
}

template <bool HAS_COM, bool HAS_JOINTS, bool BIG>
int launch(const void* con, const void* body_j, const void* body,
           const void* col_body, const void* csr_ptr, const void* csr_col,
           void* body_out, void* lam_out, void* ent_f, void* ent_i,
           void* masks, void* live, void* gws, const void* jtab,
           const void* joint_a,
           const void* joint_b, const void* jptr_a, const void* jcol_a,
           const void* jptr_b, const void* jcol_b, int W, const Params& p,
           void* stream) {
  const size_t smem = sizeof(float) * smem_floats(
      BIG, HAS_COM, p.B, p.Cg, HAS_JOINTS ? p.J : 0, p.tile);
  auto kern = tgs_solve_kernel<HAS_COM, HAS_JOINTS, BIG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<W, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)con, (const int*)body_j, (const float*)body,
      (const int*)col_body, (const int*)csr_ptr, (const int*)csr_col,
      (float*)body_out, (float*)lam_out, (float*)ent_f, (int*)ent_i,
      (unsigned*)masks, (int*)live, (float*)gws, (const float*)jtab,
      (const int*)joint_a,
      (const int*)joint_b, (const int*)jptr_a, (const int*)jcol_a,
      (const int*)jptr_b, (const int*)jcol_b, p);
  return (int)cudaGetLastError();
}

template <bool BIG>
int dispatch(bool has_com, bool joints, const void* con, const void* body_j,
             const void* body, const void* col_body, const void* csr_ptr,
             const void* csr_col, void* body_out, void* lam_out, void* ent_f,
             void* ent_i, void* masks, void* live, void* gws,
             const void* jtab,
             const void* joint_a, const void* joint_b, const void* jptr_a,
             const void* jcol_a, const void* jptr_b, const void* jcol_b,
             int W, const Params& p, void* stream) {
#define FYROX_TGS_ARGS                                                      \
  con, body_j, body, col_body, csr_ptr, csr_col, body_out, lam_out, ent_f, \
      ent_i, masks, live, gws, jtab, joint_a, joint_b, jptr_a, jcol_a,    \
      jptr_b, jcol_b, W, p, stream
  if (has_com && joints) return launch<true, true, BIG>(FYROX_TGS_ARGS);
  if (has_com) return launch<true, false, BIG>(FYROX_TGS_ARGS);
  if (joints) return launch<false, true, BIG>(FYROX_TGS_ARGS);
  return launch<false, false, BIG>(FYROX_TGS_ARGS);
#undef FYROX_TGS_ARGS
}

}  // namespace

// joint pointers may be null when J == 0; gws only with big != 0. `tile`
// is the slot buffer's length in live slots (at least S and 128).
extern "C" int fyrox_tgs_solve(const void* con, const void* body_j,
                               const void* body, const void* col_body,
                               const void* csr_ptr, const void* csr_col,
                               void* body_out, void* lam_out, void* ent_f,
                               void* ent_i, void* masks, void* live,
                               void* gws,
                               const void* jtab, const void* joint_a,
                               const void* joint_b, const void* jptr_a,
                               const void* jcol_a, const void* jptr_b,
                               const void* jcol_b, int W, int S, int Cg,
                               int B, int J, int has_com, int big, int tile,
                               int n_sub, int n_pgs, int n_stab, float h,
                               float allowed, float max_corr, float rest_thr,
                               float wc, float erp, float bias_rate,
                               float mscale_soft, float iscale_soft,
                               float msp, void* stream) {
  Params p{h, allowed, max_corr, rest_thr, wc, erp, bias_rate, mscale_soft,
           iscale_soft, msp, S, Cg, B, J, n_sub, n_pgs, n_stab, tile};
  if (W == 0) return 0;
  if (tile < S || tile * 6 < kThreads) return (int)cudaErrorInvalidValue;
  const bool joints = J > 0;
  if (big)
    return dispatch<true>(has_com, joints, con, body_j, body, col_body,
                          csr_ptr, csr_col, body_out, lam_out, ent_f, ent_i,
                          masks, live, gws, jtab, joint_a, joint_b, jptr_a,
                          jcol_a, jptr_b, jcol_b, W, p, stream);
  return dispatch<false>(has_com, joints, con, body_j, body, col_body,
                         csr_ptr, csr_col, body_out, lam_out, ent_f, ent_i,
                         masks, live, gws, jtab, joint_a, joint_b, jptr_a,
                         jcol_a, jptr_b, jcol_b, W, p, stream);
}
