// K2's narrowphase + compaction stage: every candidate window row's
// manifold, the two-tier compaction of a grid collider's active points to S
// contact slots, and the warm-start pid match, written in K1's layout.
//
// Replaces the narrowphase half of fyrox_tpu/physics/pallas_step.py:641
// fused_step_pallas and :794 fused_full_step_pallas (kernel bodies _kernel
// :603 / _kernel_full :737 → _narrow_compact :383-600; the JAX split mode
// runs it alone as _nc_kernel :623). The plain PyTorch version of the same
// function is fyrox_tpu_torch/physics/fused_step.py:narrow_compact_plain.
//
// Layout (per world w; C colliders, Cg grid colliders, S slots, NS window
// rows of candidates, Wd window rows of points):
//   col      [W,10,C]   f32  collider position 3, rotation 4, sweep v·dt 3
//   jv       [W,NS,Cg]  i32  partner collider per candidate row, -1 invalid
//   warm_lam [W,3,S,Cg] f32, warm_pid [W,S,Cg] i32: last step's carries
//   col_body [C] i32, kinds [C] i32, col_sta [8,C] f32 (params6, friction,
//   restitution), grid_cols [Cg] i32
//   con      [W,15,S,Cg] f32  n3 pt3 depth fric rest act own sigma lam3
//   body_j   [W,S,Cg] i32, pid [W,S,Cg] i32 (-1 where inactive)
//
// Design. One warp per (world, grid collider); a block holds 4 of them.
//   1. Lane p takes candidate row p (pairs in chunks of 32): it rebuilds
//      the pair from static tables (partner kind, body, canonical swap,
//      pid), runs the manifold of its kind combo (np_planes.cuh) and writes
//      its npts point rows into the warp's window in shared memory. Rows
//      are point-major within each class, classes in layout order, as the
//      JAX window is (pallas_step.py:29-32, 514-529); the TPU's padding of
//      a class to a multiple of 8 rows is a Mosaic workaround and is left
//      out, which moves no active row relative to another. Invalid rows
//      skip the manifold: they are inactive and never kept.
//   2. Lanes walk the window in row order, 32 rows at a time: __ballot_sync
//      and __popc prefix counts place the rapier tier (active, depth >
//      -prediction distance) first, then the speculative tier, each in row
//      order; a row lands in slot lpos if lpos < S. Slot k is active iff
//      k < min(active rows, S). No atomics: a run repeats bit for bit.
//   3. Kept rows take their warm impulses where last step's pid in that
//      slot equals theirs; unfilled slots get the plain version's defaults.
// The window never leaves shared memory.
//
// Bound: memory. Per collider the kernel reads NS partner indices, S warm
// slots and the two sides' collider planes (mostly L2 hits), and writes
// 17 x S words of contact planes; the manifold arithmetic (a few hundred
// flops per valid pair) is small beside that. The slot writes are strided
// by Cg (one warp per collider); staging a block's slots in shared memory
// for coalesced stores is later work. Rounding: see np_planes.cuh.
#include <cuda_runtime.h>

#include "np_planes.cuh"

namespace {

using namespace fyrox;

constexpr int kWarps = 4;       // fused_step._NC_WARPS
constexpr int kMaxChunks = 8;   // window rows <= 256 (fused_step._MAX_ROWS)
constexpr int kConRows = 15;
// words of one window row in shared memory, [kRowWords][Wd] per warp
enum {
  rNX = 0, rNY, rNZ, rPX, rPY, rPZ, rDEPTH, rACT, rFRIC, rREST, rSIGMA,
  rOWN, rBJ, rPID, kRowWords
};
// K1 contact plane rows
enum {
  cN = 0, cPT = 3, cDEPTH = 6, cFRIC = 7, cREST = 8, cACT = 9, cOWN = 10,
  cSIGMA = 11, cLAM = 12
};

struct NcParams {
  int W, C, Cg, S;
  int ns[3];       // candidate rows per class, 0 where absent
  int NS, Wd;
  float margin, pred_dist;
};

__device__ __forceinline__ V3 load3(const float* p, int stride, int i) {
  return v3(p[i], p[stride + i], p[2 * stride + i]);
}

__global__ void __launch_bounds__(32 * kWarps)
narrow_compact_kernel(const float* __restrict__ col_all,
                      const int* __restrict__ jv_all,
                      const float* __restrict__ warm_lam_all,
                      const int* __restrict__ warm_pid_all,
                      const int* __restrict__ col_body,
                      const int* __restrict__ kinds,
                      const float* __restrict__ col_sta,
                      const int* __restrict__ grid_cols,
                      float* __restrict__ con_all, int* __restrict__ bj_all,
                      int* __restrict__ pid_all, NcParams p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gw = (long long)blockIdx.x * kWarps + warp;
  if (gw >= (long long)p.W * p.Cg) return;      // whole warps exit together
  const int w = (int)(gw / p.Cg);
  const int g = (int)(gw % p.Cg);
  const int C = p.C, Cg = p.Cg, S = p.S, Wd = p.Wd;
  float* rows = smem + (size_t)warp * kRowWords * Wd;
  int* rows_i = reinterpret_cast<int*>(rows);

  const float* col = col_all + (size_t)w * 10 * C;
  const int ic = grid_cols[g];
  const V3 i_pos = load3(col, C, ic);
  const float i_q[4] = {col[3 * C + ic], col[4 * C + ic], col[5 * C + ic],
                        col[6 * C + ic]};
  const V3 i_vs = load3(col + 7 * C, C, ic);
  const int kind_i = kinds[ic];
  float i_p6[6];
  for (int k = 0; k < 6; ++k) i_p6[k] = col_sta[k * C + ic];
  const float i_fric = col_sta[6 * C + ic], i_rest = col_sta[7 * C + ic];

  // ---- 1. one candidate row per lane: manifold → window rows
  for (int cand = lane; cand < p.NS; cand += 32) {
    int cls = 0, slot = cand, row_off = 0;
    while (slot >= p.ns[cls]) {
      slot -= p.ns[cls];
      row_off += p.ns[cls] * (1 << cls);     // npts = 1, 2, 4
      ++cls;
    }
    const int nslot = p.ns[cls];
    const int npts = 1 << cls;
    const int jr = jv_all[((size_t)w * p.NS + cand) * Cg + g];
    if (jr < 0) {
      for (int pi = 0; pi < npts; ++pi)
        rows[rACT * Wd + row_off + pi * nslot + slot] = 0.0f;
      continue;
    }
    const V3 j_pos = load3(col, C, jr);
    const float j_q[4] = {col[3 * C + jr], col[4 * C + jr], col[5 * C + jr],
                          col[6 * C + jr]};
    const V3 j_vs = load3(col + 7 * C, C, jr);
    const int kind_j = kinds[jr];
    float j_p6[6];
    for (int k = 0; k < 6; ++k) j_p6[k] = col_sta[k * C + jr];
    const float j_fric = col_sta[6 * C + jr], j_rest = col_sta[7 * C + jr];

    const float pred = add(p.margin, norm3(sub3(i_vs, j_vs)));
    // canonical A/B order: (kind, collider index) ascending
    const bool sw = kind_i > kind_j || (kind_i == kind_j && ic > jr);
    const float* qa = sw ? j_q : i_q;
    const float* qb = sw ? i_q : j_q;
    const R9 rot_a = q_to_rot9(qa[0], qa[1], qa[2], qa[3]);
    const R9 rot_b = q_to_rot9(qb[0], qb[1], qb[2], qb[3]);
    Manifold m;
    class_manifold(cls, sw ? kind_j : kind_i, sw ? kind_i : kind_j,
                   sw ? j_pos : i_pos, rot_a, sw ? j_p6 : i_p6,
                   sw ? i_pos : j_pos, rot_b, sw ? i_p6 : j_p6, pred, m);
    const float fric = __fsqrt_rn(mx(mul(i_fric, j_fric), 0.0f));
    const float rest = mx(i_rest, j_rest);
    const int pid_pair = ic * C + jr;
    const int bj = col_body[jr];
    for (int pi = 0; pi < npts; ++pi) {
      const int r = row_off + pi * nslot + slot;
      rows[rNX * Wd + r] = m.normal.x;
      rows[rNY * Wd + r] = m.normal.y;
      rows[rNZ * Wd + r] = m.normal.z;
      rows[rPX * Wd + r] = m.pts[pi].x;
      rows[rPY * Wd + r] = m.pts[pi].y;
      rows[rPZ * Wd + r] = m.pts[pi].z;
      rows[rDEPTH * Wd + r] = m.depth[pi];
      rows[rACT * Wd + r] = m.active[pi];
      rows[rFRIC * Wd + r] = fric;
      rows[rREST * Wd + r] = rest;
      rows[rSIGMA * Wd + r] = sw ? -1.0f : 1.0f;
      rows[rOWN * Wd + r] = (float)npts;
      rows_i[rBJ * Wd + r] = bj;
      rows_i[rPID * Wd + r] = pid_pair * 4 + pi;
    }
  }
  __syncwarp();

  // ---- 2. two-tier compaction by warp ballots, in row order
  unsigned pen_m[kMaxChunks], act_m[kMaxChunks];
  const int chunks = (Wd + 31) >> 5;
  int n_pen = 0, n_act = 0;
  for (int ch = 0; ch < chunks; ++ch) {
    const int r = ch * 32 + lane;
    const bool a = r < Wd && rows[rACT * Wd + r] > 0.5f;
    const bool pe = a && rows[rDEPTH * Wd + r] > -p.pred_dist;
    pen_m[ch] = __ballot_sync(0xffffffffu, pe);
    act_m[ch] = __ballot_sync(0xffffffffu, a);
    n_pen += __popc(pen_m[ch]);
    n_act += __popc(act_m[ch]);
  }
  const unsigned below = (1u << lane) - 1u;
  const int n_keep = n_act < S ? n_act : S;
  float* con = con_all + (size_t)w * kConRows * S * Cg;
  const float* wlam = warm_lam_all + (size_t)w * 3 * S * Cg;
  const int* wpid = warm_pid_all + (size_t)w * S * Cg;
  int* bj_out = bj_all + (size_t)w * S * Cg;
  int* pid_out = pid_all + (size_t)w * S * Cg;
  int pen_before = 0, spec_before = 0;
  for (int ch = 0; ch < chunks; ++ch) {
    const int r = ch * 32 + lane;
    const unsigned spec_m = act_m[ch] & ~pen_m[ch];
    const bool pe = (pen_m[ch] >> lane) & 1u;
    const bool a = (act_m[ch] >> lane) & 1u;
    const int lpos = pe ? pen_before + __popc(pen_m[ch] & below)
                        : n_pen + spec_before + __popc(spec_m & below);
    if (a && lpos < S) {
      const size_t o = (size_t)lpos * Cg + g;
      const size_t SC = (size_t)S * Cg;
      const int pid = rows_i[rPID * Wd + r];
      const float same = wpid[o] == pid ? 1.0f : 0.0f;
      con[cN * SC + o] = rows[rNX * Wd + r];
      con[(cN + 1) * SC + o] = rows[rNY * Wd + r];
      con[(cN + 2) * SC + o] = rows[rNZ * Wd + r];
      con[cPT * SC + o] = rows[rPX * Wd + r];
      con[(cPT + 1) * SC + o] = rows[rPY * Wd + r];
      con[(cPT + 2) * SC + o] = rows[rPZ * Wd + r];
      con[cDEPTH * SC + o] = rows[rDEPTH * Wd + r];
      con[cFRIC * SC + o] = rows[rFRIC * Wd + r];
      con[cREST * SC + o] = rows[rREST * Wd + r];
      con[cACT * SC + o] = 1.0f;
      con[cOWN * SC + o] = mx(rows[rOWN * Wd + r], 1.0f);
      con[cSIGMA * SC + o] = rows[rSIGMA * Wd + r];
      for (int k = 0; k < 3; ++k)
        con[(cLAM + k) * SC + o] = mul(wlam[k * SC + o], same);
      bj_out[o] = rows_i[rBJ * Wd + r];
      pid_out[o] = pid;
    }
    pen_before += __popc(pen_m[ch]);
    spec_before += __popc(spec_m);
  }
  // ---- 3. unfilled slots: the plain version's zeros (own 1, pid -1)
  for (int k = n_keep + lane; k < S; k += 32) {
    const size_t o = (size_t)k * Cg + g;
    const size_t SC = (size_t)S * Cg;
    for (int a = 0; a < kConRows; ++a) con[a * SC + o] = 0.0f;
    con[cOWN * SC + o] = 1.0f;
    bj_out[o] = 0;
    pid_out[o] = -1;
  }
}

}  // namespace

extern "C" int fyrox_narrow_compact(
    const void* col, const void* jv, const void* warm_lam,
    const void* warm_pid, const void* col_body, const void* kinds,
    const void* col_sta, const void* grid_cols, void* con, void* body_j,
    void* pid, int W, int C, int Cg, int S, int ns0, int ns1, int ns2,
    float margin, float pred_dist, void* stream) {
  NcParams p{W, C, Cg, S, {ns0, ns1, ns2}, ns0 + ns1 + ns2,
             ns0 + 2 * ns1 + 4 * ns2, margin, pred_dist};
  const size_t smem = sizeof(float) * kRowWords * (size_t)p.Wd * kWarps;
  cudaError_t err = cudaFuncSetAttribute(
      narrow_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long warps = (long long)W * Cg;
  const int blocks = (int)((warps + kWarps - 1) / kWarps);
  narrow_compact_kernel<<<blocks, 32 * kWarps, smem, (cudaStream_t)stream>>>(
      (const float*)col, (const int*)jv, (const float*)warm_lam,
      (const int*)warm_pid, (const int*)col_body, (const int*)kinds,
      (const float*)col_sta, (const int*)grid_cols, (float*)con,
      (int*)body_j, (int*)pid, p);
  return (int)cudaGetLastError();
}
