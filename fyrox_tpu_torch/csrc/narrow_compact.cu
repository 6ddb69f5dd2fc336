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
// Bound: memory. A world reads NS x Cg partner indices and 4 x S x Cg warm
// words, and writes 17 x S x Cg words (con, body_j, pid: 139 MB at the
// flagship's W = 128, S = 16, Cg = 1,000, past the 50 MB L2); the manifold
// arithmetic, a few hundred flops per valid pair, is small beside that.
// On an H100 the stores run near the memory rate; what is left above the
// bound is the manifold phase's latency: a block's cuboid-cuboid pairs
// (~11 at the flagship) run one long routine in one warp, and blocks in
// flight per SM are capped by shared memory and registers (3 blocks of 8
// warps).
//
// Design. One CTA of 8 warps per (world, tile of TG consecutive grid
// colliders); TG (32, 16, 8 ...) is the widest whose shared memory fits
// (fused_step._nc_tile). Every array is indexed [..., collider of the tile]
// in shared memory, so that each global row (plane, slot) of the tile is
// one run of TG consecutive words, read or written by consecutive threads.
//   0. Stage the tile's own collider planes and its jv rows (coalesced).
//   1. List the tile's valid (candidate row, collider) pairs, bucketed by
//      canonical kind combo, each bucket starting a warp (shared-memory
//      integer counters; the order within a bucket is free, since every
//      pair writes its own cells). A warp then runs one manifold routine of
//      np_planes.cuh over up to 32 real pairs; invalid rows cost nothing
//      beyond their act = 0. A pair's
//      normal, friction, restitution, sign and partner body go to per-pair
//      words, its npts points (position, depth, act) to the window rows,
//      which keep the JAX layout's order: classes in layout order,
//      point-major within a class (pallas_step.py:29-32, 514-529; the TPU's
//      padding of a class to a multiple of 8 rows is a Mosaic workaround,
//      left out, which moves no active row relative to another).
//   2. One warp per collider places its rows, 32 at a time: __ballot_sync
//      and __popc prefix counts put the rapier tier (active, depth >
//      -prediction distance) first, then the speculative tier, each in row
//      order; a row lands in slot lpos if lpos < S. Slot k is active iff
//      k < min(active rows, S). The warp records each slot's window row.
//   3. Threads over (slot, collider), collider fastest, each writing its
//      17 output words: a kept slot its row's words and, where last step's
//      pid in that slot equals its own, the warm impulses; an unfilled slot
//      the plain version's defaults (all 0, own 1, body 0, pid -1). Each
//      warp store is one whole 128-byte row at TG = 32, read straight from
//      the window through the slot's row (no output tile), and the warm
//      carries are read where they are used, as whole rows too.
// The window never leaves shared memory. No atomics on floats and no
// order-dependent sums: a run repeats bit for bit. Rounding: np_planes.cuh.
#include <cuda_runtime.h>

#include "np_planes.cuh"

namespace {

using namespace fyrox;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 8;   // window rows <= 256 (fused_step._MAX_ROWS)
constexpr int kConRows = 15;
constexpr int kBuckets = 16;    // canonical kind combos (4 kinds squared)
// the tile's own colliders, [kOwnWords][TG] floats then [2][TG] ints
enum { oPOS = 0, oQ = 3, oVS = 7, oP6 = 10, oFRIC = 16, oREST = 17,
       kOwnWords };
// per candidate pair, [kPairWords][NS][TG]
enum { pNX = 0, pNY, pNZ, pFRIC, pREST, pSIGMA, pBJ, kPairWords };
// per window row (point), [kPtWords][Wd][TG + 1]
enum { qPX = 0, qPY, qPZ, qDEPTH, qACT, kPtWords };
// K1 contact plane rows
enum {
  cN = 0, cPT = 3, cDEPTH = 6, cFRIC = 7, cREST = 8, cACT = 9, cOWN = 10,
  cSIGMA = 11, cLAM = 12
};

struct NcParams {
  int W, C, Cg, S;
  int ns[3];       // candidate rows per class, 0 where absent
  int NS, Wd, tg;
  float margin, pred_dist;
};

__device__ __forceinline__ int kind_slot(int k) {
  return k == kBall ? 0 : k == kCuboid ? 1 : k == kCapsule ? 2 : 3;
}

// candidate row → (class, slot in class, first window row of the class)
__device__ __forceinline__ void cand_class(const NcParams& p, int cand,
                                           int* cls, int* slot,
                                           int* row_off) {
  int c = 0, s = cand, r = 0;
  while (s >= p.ns[c]) {
    s -= p.ns[c];
    r += p.ns[c] * (1 << c);     // npts = 1, 2, 4
    ++c;
  }
  *cls = c;
  *slot = s;
  *row_off = r;
}

__global__ void __launch_bounds__(kThreads, 3)
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
  const int C = p.C, Cg = p.Cg, S = p.S, NS = p.NS, Wd = p.Wd;
  const int TG = p.tg, TGP = TG + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (Cg + TG - 1) / TG;
  const int w = blockIdx.x / ntiles;
  const int g0 = (blockIdx.x % ntiles) * TG;
  const int nt = min(TG, Cg - g0);

  // shared memory, as fused_step.nc_smem_bytes counts it
  float* own_f = smem;                                   // [kOwnWords][TG]
  int* own_i = reinterpret_cast<int*>(own_f + kOwnWords * TG);  // ic, kind
  int* jt = own_i + 2 * TG;                              // [NS][TG]
  float* pair = reinterpret_cast<float*>(jt + NS * TG);  // [7][NS][TG]
  float* pts = pair + kPairWords * NS * TG;              // [5][Wd][TGP]
  int* srow = reinterpret_cast<int*>(pts + kPtWords * Wd * TGP);  // [S][TG]
  int* nkeep = srow + S * TG;                            // [TG]
  int* rmap = nkeep + TG;                                // [Wd]
  int* list = rmap + Wd;                   // [NS * TG + kBuckets * 31]
  int* bcnt = list + NS * TG + kBuckets * 31;  // counts, cursors, length
  int* pair_i = reinterpret_cast<int*>(pair);

  const float* col = col_all + (size_t)w * 10 * C;

  // ---- 0. stage the tile
  for (int r = tid; r < Wd; r += kThreads) {     // window row → its pair
    int c = 0, base = 0;
    while (r >= base + p.ns[c] * (1 << c)) {
      base += p.ns[c] * (1 << c);
      ++c;
    }
    const int nslot = p.ns[c];
    const int pi = (r - base) / nslot;
    int cand = r - base - pi * nslot;
    for (int k = 0; k < c; ++k) cand += p.ns[k];
    rmap[r] = cand << 4 | c << 2 | pi;
  }
  for (int i = tid; i < 2 * kBuckets + 1; i += kThreads) bcnt[i] = 0;
  for (int i = tid; i < NS * TG + kBuckets * 31; i += kThreads) list[i] = -1;
  for (int i = tid; i < kOwnWords * TG; i += kThreads) {
    const int a = i / TG, t = i - a * TG;
    if (t >= nt) continue;
    const int ic = grid_cols[g0 + t];
    own_f[i] = a < 10 ? col[a * C + ic] : col_sta[(a - 10) * C + ic];
    if (a == 0) {
      own_i[t] = ic;
      own_i[TG + t] = kinds[ic];
    }
  }
  for (int i = tid; i < Wd * TGP; i += kThreads) pts[qACT * Wd * TGP + i] = 0.0f;
  // the valid pairs' canonical kind combos (entry i's waits in pair_i[i]
  // until the manifolds write there)
  for (int i = tid; i < NS * TG; i += kThreads) {
    const int row = i / TG, t = i - row * TG;
    const int jr = t < nt ? jv_all[((size_t)w * NS + row) * Cg + g0 + t] : -1;
    jt[i] = jr;
    if (jr < 0) continue;
    const int ki = kind_slot(kinds[grid_cols[g0 + t]]);
    const int kj = kind_slot(kinds[jr]);
    pair_i[i] = ki < kj ? ki * 4 + kj : kj * 4 + ki;
  }
  __syncthreads();

  // ---- 1. the valid pairs, bucketed by canonical kind combo
  for (int i = tid; i < NS * TG; i += kThreads)
    if (jt[i] >= 0) atomicAdd(&bcnt[pair_i[i]], 1);
  __syncthreads();
  if (tid == 0) {       // each bucket starts a warp: one routine a warp
    int run = 0;
    for (int b = 0; b < kBuckets; ++b) {
      bcnt[kBuckets + b] = run;
      run += (bcnt[b] + 31) & ~31;
    }
    bcnt[2 * kBuckets] = run;
  }
  __syncthreads();
  for (int i = tid; i < NS * TG; i += kThreads) {
    if (jt[i] < 0) continue;
    const int row = i / TG, t = i - row * TG;
    list[atomicAdd(&bcnt[kBuckets + pair_i[i]], 1)] = row << 8 | t;
  }
  __syncthreads();
  const int n_pairs = bcnt[2 * kBuckets];
  for (int e = tid; e < n_pairs; e += kThreads) {
    if (list[e] < 0) continue;         // a bucket's pad
    const int cand = list[e] >> 8, t = list[e] & 255;
    int cls, slot, row_off;
    cand_class(p, cand, &cls, &slot, &row_off);
    const int nslot = p.ns[cls];
    const int npts = 1 << cls;
    const int ic = own_i[t], kind_i = own_i[TG + t];
    const int jr = jt[cand * TG + t];
    const V3 i_pos = v3(own_f[oPOS * TG + t], own_f[(oPOS + 1) * TG + t],
                        own_f[(oPOS + 2) * TG + t]);
    const float i_q[4] = {own_f[oQ * TG + t], own_f[(oQ + 1) * TG + t],
                          own_f[(oQ + 2) * TG + t], own_f[(oQ + 3) * TG + t]};
    const V3 i_vs = v3(own_f[oVS * TG + t], own_f[(oVS + 1) * TG + t],
                       own_f[(oVS + 2) * TG + t]);
    float i_p6[6];
    for (int k = 0; k < 6; ++k) i_p6[k] = own_f[(oP6 + k) * TG + t];
    const float i_fric = own_f[oFRIC * TG + t], i_rest = own_f[oREST * TG + t];
    const V3 j_pos = v3(col[jr], col[C + jr], col[2 * C + jr]);
    const float j_q[4] = {col[3 * C + jr], col[4 * C + jr], col[5 * C + jr],
                          col[6 * C + jr]};
    const V3 j_vs = v3(col[7 * C + jr], col[8 * C + jr], col[9 * C + jr]);
    const int kind_j = kinds[jr];
    float j_p6[6];
    for (int k = 0; k < 6; ++k) j_p6[k] = col_sta[k * C + jr];
    const float j_fric = col_sta[6 * C + jr], j_rest = col_sta[7 * C + jr];

    const float pred = add(p.margin, norm3(sub3(i_vs, j_vs)));
    // canonical A/B order: (kind, collider index) ascending
    const bool sw = kind_i > kind_j || (kind_i == kind_j && ic > jr);
    float qa[4], qb[4], pa6[6], pb6[6];  // selected by value: registers
    for (int k = 0; k < 4; ++k) {
      qa[k] = sw ? j_q[k] : i_q[k];
      qb[k] = sw ? i_q[k] : j_q[k];
    }
    for (int k = 0; k < 6; ++k) {
      pa6[k] = sw ? j_p6[k] : i_p6[k];
      pb6[k] = sw ? i_p6[k] : j_p6[k];
    }
    const R9 rot_a = q_to_rot9(qa[0], qa[1], qa[2], qa[3]);
    const R9 rot_b = q_to_rot9(qb[0], qb[1], qb[2], qb[3]);
    Manifold m;
    class_manifold(cls, sw ? kind_j : kind_i, sw ? kind_i : kind_j,
                   sw ? j_pos : i_pos, rot_a, pa6, sw ? i_pos : j_pos, rot_b,
                   pb6, pred, m);
    const int pc = cand * TG + t;
    const int PS = NS * TG;
    pair[pNX * PS + pc] = m.normal.x;
    pair[pNY * PS + pc] = m.normal.y;
    pair[pNZ * PS + pc] = m.normal.z;
    pair[pFRIC * PS + pc] = __fsqrt_rn(mx(mul(i_fric, j_fric), 0.0f));
    pair[pREST * PS + pc] = mx(i_rest, j_rest);
    pair[pSIGMA * PS + pc] = sw ? -1.0f : 1.0f;
    pair_i[pBJ * PS + pc] = col_body[jr];
#pragma unroll
    for (int pi = 0; pi < 4; ++pi) {
      if (pi >= npts) break;
      const int q = (row_off + pi * nslot + slot) * TGP + t;
      const int QS = Wd * TGP;
      pts[qPX * QS + q] = m.pts[pi].x;
      pts[qPY * QS + q] = m.pts[pi].y;
      pts[qPZ * QS + q] = m.pts[pi].z;
      pts[qDEPTH * QS + q] = m.depth[pi];
      pts[qACT * QS + q] = m.active[pi];
    }
  }
  __syncthreads();

  // ---- 2. two-tier compaction by warp ballots, in row order
  const int chunks = (Wd + 31) >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int t = warp; t < nt; t += kWarps) {
    unsigned pen_m[kMaxChunks], act_m[kMaxChunks];   // registers: unrolled
    int n_pen = 0, n_act = 0;
#pragma unroll
    for (int ch = 0; ch < kMaxChunks; ++ch) {
      if (ch >= chunks) break;
      const int r = ch * 32 + lane;
      const bool a = r < Wd && pts[(qACT * Wd + r) * TGP + t] > 0.5f;
      const bool pe = a && pts[(qDEPTH * Wd + r) * TGP + t] > -p.pred_dist;
      pen_m[ch] = __ballot_sync(0xffffffffu, pe);
      act_m[ch] = __ballot_sync(0xffffffffu, a);
      n_pen += __popc(pen_m[ch]);
      n_act += __popc(act_m[ch]);
    }
    int pen_before = 0, spec_before = 0;
#pragma unroll
    for (int ch = 0; ch < kMaxChunks; ++ch) {
      if (ch >= chunks) break;
      const unsigned spec_m = act_m[ch] & ~pen_m[ch];
      const bool pe = (pen_m[ch] >> lane) & 1u;
      const bool a = (act_m[ch] >> lane) & 1u;
      const int lpos = pe ? pen_before + __popc(pen_m[ch] & below)
                          : n_pen + spec_before + __popc(spec_m & below);
      if (a && lpos < S) srow[lpos * TG + t] = ch * 32 + lane;
      pen_before += __popc(pen_m[ch]);
      spec_before += __popc(spec_m);
    }
    if (lane == 0) nkeep[t] = n_act < S ? n_act : S;
  }
  __syncthreads();

  // ---- 3. the tile's output rows, collider fastest
  const size_t SC = (size_t)S * Cg;
  float* con = con_all + (size_t)w * kConRows * SC;
  const float* wlam = warm_lam_all + (size_t)w * 3 * SC;
  const int* wpid = warm_pid_all + (size_t)w * SC;
  int* bj_out = bj_all + (size_t)w * SC;
  int* pid_out = pid_all + (size_t)w * SC;
  const int PS = NS * TG, QS = Wd * TGP;
  for (int i = tid; i < S * TG; i += kThreads) {
    const int k = i / TG, t = i - k * TG;
    if (t >= nt) continue;
    const size_t o = (size_t)k * Cg + g0 + t;
    if (k >= nkeep[t]) {          // unfilled: the plain version's defaults
      for (int a = 0; a < kConRows; ++a)
        con[a * SC + o] = a == cOWN ? 1.0f : 0.0f;
      bj_out[o] = 0;
      pid_out[o] = -1;
      continue;
    }
    const int r = srow[k * TG + t];
    const int rm = rmap[r];
    const int pc = (rm >> 4) * TG + t, q = r * TGP + t;
    const int pid = (own_i[t] * C + jt[pc]) * 4 + (rm & 3);
    const float same = wpid[o] == pid ? 1.0f : 0.0f;
    con[cN * SC + o] = pair[pNX * PS + pc];
    con[(cN + 1) * SC + o] = pair[pNY * PS + pc];
    con[(cN + 2) * SC + o] = pair[pNZ * PS + pc];
    con[cPT * SC + o] = pts[qPX * QS + q];
    con[(cPT + 1) * SC + o] = pts[qPY * QS + q];
    con[(cPT + 2) * SC + o] = pts[qPZ * QS + q];
    con[cDEPTH * SC + o] = pts[qDEPTH * QS + q];
    con[cFRIC * SC + o] = pair[pFRIC * PS + pc];
    con[cREST * SC + o] = pair[pREST * PS + pc];
    con[cACT * SC + o] = 1.0f;
    con[cOWN * SC + o] = mx((float)(1 << ((rm >> 2) & 3)), 1.0f);
    con[cSIGMA * SC + o] = pair[pSIGMA * PS + pc];
    for (int a = 0; a < 3; ++a)
      con[(cLAM + a) * SC + o] = mul(wlam[a * SC + o], same);
    bj_out[o] = pair_i[pBJ * PS + pc];
    pid_out[o] = pid;
  }
}

}  // namespace

extern "C" int fyrox_narrow_compact(
    const void* col, const void* jv, const void* warm_lam,
    const void* warm_pid, const void* col_body, const void* kinds,
    const void* col_sta, const void* grid_cols, void* con, void* body_j,
    void* pid, int W, int C, int Cg, int S, int ns0, int ns1, int ns2,
    int tg, float margin, float pred_dist, void* stream) {
  NcParams p{W, C, Cg, S, {ns0, ns1, ns2}, ns0 + ns1 + ns2,
             ns0 + 2 * ns1 + 4 * ns2, tg, margin, pred_dist};
  if (tg < 1 || tg > 32 || (tg & (tg - 1)) != 0 || p.Wd > 32 * kMaxChunks)
    return (int)cudaErrorInvalidValue;
  const size_t words = (size_t)tg * (kOwnWords + 2 + p.NS * (kPairWords + 2) +
                                     S + 1) +
                       (size_t)kPtWords * p.Wd * (tg + 1) + p.Wd +
                       kBuckets * 31 + 2 * kBuckets + 1;
  const size_t smem = 4 * words;
  cudaError_t err = cudaFuncSetAttribute(
      narrow_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)W * ((Cg + tg - 1) / tg);
  narrow_compact_kernel<<<(unsigned)blocks, kThreads, smem,
                          (cudaStream_t)stream>>>(
      (const float*)col, (const int*)jv, (const float*)warm_lam,
      (const int*)warm_pid, (const int*)col_body, (const int*)kinds,
      (const float*)col_sta, (const int*)grid_cols, (float*)con,
      (int*)body_j, (int*)pid, p);
  return (int)cudaGetLastError();
}
