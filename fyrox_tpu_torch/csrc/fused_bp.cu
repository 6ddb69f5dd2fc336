// K3's broadphase stage: collider pose, swept fat AABBs, packed hash-grid
// keys, the stable sort, the 9-neighbour range walk and the per-class
// two-tier compaction into the static candidate windows.
//
// Replaces the broadphase half of fyrox_tpu/physics/pallas_step.py:794
// fused_full_step_pallas (kernel body _kernel_full :737 → _bp_candidates
// :152-380). The plain PyTorch version of the same function is
// fyrox_tpu_torch/physics/fused_step.py:bp_candidates_plain (the staged
// slab2 pose/AABB stages and broadphase.class_windows, packed as here).
//
// Layout (per world w; B bodies, C colliders, Cg grid colliders):
//   body      [W,29,B] f32  K1 body planes (lv 0-2, pos 6-8, q 9-12 read)
//   col_body, shape [C] i32; col_sta [8,C] f32 (params6 ...); col_off
//   [7,C] f32 (offset pos3, rot4); sweep_cap [C] f32; col_grid [C] i32
//   (grid index, -1 for a big collider); grid_stat [2,Cg] i32 (collider;
//   body << 5 | kind clamped to 0-8 << 1 | dynamic); cls_tab [9,9] i32;
//   jv_big [NSB,Cg] i32 (static big-partner rows, -1 invalid)
//   jv  [W,NS,Cg] i32 out: per class c, s_class[c] walked partners then
//       nbig big rows; -1 invalid
//   col [W,10,C]  f32 out: collider position 3, rotation 4, sweep v·dt 3
//
// Bound: memory. A world reads 10 of its 29 body planes and the static
// tables and writes 10 x C collider planes and NS x Cg window rows (~100 KB
// at the flagship's shapes); the sort and the walk are shared-memory work.
// On the card the walk is what takes the time: ~45 slot tests a collider,
// each a chain of shared-memory loads.
//
// Design. P CTAs of 16 warps per world, P from the card's resident CTAs and
// W (2 at the flagship's W = 128 on 132 SMs), at least 64 grid colliders a
// CTA (fyrox_fused_bp below). Each CTA repeats the world's cheap stages 1-3
// and walks one slice of its grid colliders; the collider planes are
// written once, each CTA its slice of them.
//   1. Threads over colliders: pose and sweep, once each → col; a grid
//      collider's AABB and its key, packed with its grid index as one
//      64-bit word (key << 32 | index), from the same pose.
//   2. The static word table (collider; body, kind, dyn) and cls_tab go to
//      shared memory (the table stays in global memory where it does not
//      fit), so the walk's chain of loads never leaves shared memory.
//   3. Sort: each warp sorts runs of 64 words in registers (a bitonic
//      network over __shfl_xor_sync, no block barrier), then log2(Cg / 64)
//      merge rounds place each word at its offset in its run plus its rank
//      in the partner run (branchless binary searches, a thread's words in
//      lockstep), two barriers a round: 10 barriers at the flagship where
//      a block bitonic sort takes 55. The words are distinct, so the order
//      is exactly the stable key-then-index order of
//      torch.argsort(stable=True).
//   4. The walk, one thread per grid collider of the slice (up to 512 at
//      once): 18 branchless binary searches, 9 in lockstep, give the 9
//      neighbour ranges (dx-major, then dy); slot m < min(total, s_walk) is
//      taken from range r at lo_r + m - offset_r. A slot passes if its
//      partner is another collider on another body, one side is dynamic
//      and the AABBs overlap; 64-bit masks hold the tight (AABBs
//      overlapping by the tight margin) and per-class slots, and per class
//      the tight tier packs first, then the rest, by popcount prefixes,
//      into the class's walked rows; a kept slot's partner is read again
//      from the sorted words (no per-slot array in local memory). The rows
//      go to a shared tile of the slice, written back a warp per row, with
//      the static big rows.
//      A warp per collider (lanes over the bounds and the slots) was tried
//      first and measured no faster than the one-CTA-per-world bitonic
//      design on an H100: it issues ~450 warp instructions a collider
//      against ~110 here, and the walk is issue- and latency-bound once its
//      loads stay in shared memory.
// No one-hot gathers, no (hi, lo) split, no counting rank: those are TPU
// workarounds. No float atomics: a run repeats bit for bit. Rounding: pose,
// AABB and key use __fmul_rn / __fadd_rn in the plain version's op order
// (np_planes.cuh), and IEEE division by the cell sizes, so a collider lands
// in the same cell as in the plain version and the windows agree as
// integers.
#include <cuda_runtime.h>

#include "np_planes.cuh"

namespace {

using namespace fyrox;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 64;         // words a warp sorts in registers (2^6)
constexpr int kMaxWalk = 64;     // fused_step._MAX_WALK
constexpr int kMaxTile = kThreads;   // grid colliders a CTA walks at once
constexpr int kQBitsXY = 9, kQBitsZ = 13;   // broadphase._QBITS_XY / _Z
constexpr int kQHalfXY = 1 << (kQBitsXY - 1), kQHalfZ = 1 << (kQBitsZ - 1);
constexpr float kHuge = 1.0e9f;  // shapes._HUGE
constexpr unsigned kFull = 0xffffffffu;
// body plane rows (tgs_kernel layout)
enum { bLV = 0, bPOS = 6, bQ = 9 };

struct BpParams {
  int W, B, C, Cg, s_walk;
  int ns[3];      // window rows per class (walked + big), 0 where absent
  int NS, nbig, trivial;
  int parts, tj, stat_smem;   // CTAs per world, tile width, table in smem
  float dt, margin, cell, zfine, d2;
};

struct Pose {
  V3 pos, vs;
  float q[4];
};

// slab2._collider_pose_planes + the sweep v·dt
__device__ Pose collider_pose(const float* body, int B, const int* col_body,
                              const float* col_off, int C, int c,
                              const BpParams& p) {
  const int b = col_body[c];
  const V3 bpos = v3(body[bPOS * B + b], body[(bPOS + 1) * B + b],
                     body[(bPOS + 2) * B + b]);
  const float ax = body[bQ * B + b], ay = body[(bQ + 1) * B + b];
  const float az = body[(bQ + 2) * B + b], aw = body[(bQ + 3) * B + b];
  Pose o;
  if (p.trivial) {
    o.pos = bpos;
    o.q[0] = ax; o.q[1] = ay; o.q[2] = az; o.q[3] = aw;
  } else {
    const V3 off = v3(col_off[c], col_off[C + c], col_off[2 * C + c]);
    const float bx = col_off[3 * C + c], by = col_off[4 * C + c];
    const float bz = col_off[5 * C + c], bw = col_off[6 * C + c];
    // planes.qmul(body q, offset q)
    o.q[0] = sub(add(add(mul(aw, bx), mul(ax, bw)), mul(ay, bz)), mul(az, by));
    o.q[1] = add(add(sub(mul(aw, by), mul(ax, bz)), mul(ay, bw)), mul(az, bx));
    o.q[2] = add(sub(add(mul(aw, bz), mul(ax, by)), mul(ay, bx)), mul(az, bw));
    o.q[3] = sub(sub(sub(mul(aw, bw), mul(ax, bx)), mul(ay, by)), mul(az, bz));
    // planes.qrotate(body q, offset pos): v + 2 (w (u x v) + u x (u x v))
    const V3 u = v3(ax, ay, az);
    const V3 uv = cross3(u, off);
    const V3 uuv = cross3(u, uv);
    const V3 rot = {add(off.x, mul(2.0f, add(mul(aw, uv.x), uuv.x))),
                    add(off.y, mul(2.0f, add(mul(aw, uv.y), uuv.y))),
                    add(off.z, mul(2.0f, add(mul(aw, uv.z), uuv.z)))};
    o.pos = add3(bpos, rot);
  }
  o.vs = v3(mul(body[bLV * B + b], p.dt), mul(body[(bLV + 1) * B + b], p.dt),
            mul(body[(bLV + 2) * B + b], p.dt));
  return o;
}

// slab2._aabb_planes for a ball / cuboid / capsule / cylinder / cone (grid
// colliders; shape is the collider's own tag, 3 and 4 the cylinder and
// the cone)
__device__ void collider_aabb(const Pose& o, int shape, const float* col_sta,
                              int C, int c, float cap, float margin,
                              float* amin, float* amax) {
  const R9 r = q_to_rot9(o.q[0], o.q[1], o.q[2], o.q[3]);
  float a[9];
  for (int k = 0; k < 9; ++k) a[k] = fabsf(r.m[k]);
  const float p0 = col_sta[c], p1 = col_sta[C + c], p2 = col_sta[2 * C + c];
  const bool cyl = shape == 3 || shape == 4;
  float hx, hy, hz;
  if (shape == kCuboid) {
    hx = p0; hy = p1; hz = p2;
  } else if (cyl) {   // cylinder / cone: rot_box(p1, p0, p1)
    hx = p1; hy = p0; hz = p1;
  } else {      // capsule: rot_box(p1, p0 + p1, p1)
    hx = p1; hy = add(p0, p1); hz = p1;
  }
  const float pos[3] = {o.pos.x, o.pos.y, o.pos.z};
  const float vs[3] = {o.vs.x, o.vs.y, o.vs.z};
  for (int i = 0; i < 3; ++i) {
    float he;
    if (shape == kBall)
      he = p0;
    else if (shape == kCuboid || shape == kCapsule || cyl)
      he = add(add(mul(a[3 * i], hx), mul(a[3 * i + 1], hy)),
               mul(a[3 * i + 2], hz));
    else
      he = kHuge;
    he = add(he, margin);
    const float swc = mn(mx(vs[i], -cap), cap);
    amin[i] = add(sub(pos[i], he), mn(swc, 0.0f));
    amax[i] = add(add(pos[i], he), mx(swc, 0.0f));
  }
}

__device__ __forceinline__ int floor_i(float x) { return (int)floorf(x); }

// broadphase._pack_xyz
__device__ __forceinline__ int pack_xyz(int qx, int qy, int qz) {
  const int x = min(max(qx + kQHalfXY, 0), (1 << kQBitsXY) - 1);
  const int y = min(max(qy + kQHalfXY, 0), (1 << kQBitsXY) - 1);
  const int z = min(max(qz + kQHalfZ, 0), (1 << kQBitsZ) - 1);
  return (x << (kQBitsXY + kQBitsZ)) | (y << kQBitsZ) | z;
}

// #sorted keys < q[r] (strict) or <= q[r], over the first n >= 1 words, for
// 9 queries in lockstep: a branchless binary search whose trip count
// depends on n only, so the 9 loads of a step are independent
__device__ __forceinline__ void count_keys9(const unsigned long long* skv,
                                            int n, const unsigned* q,
                                            bool or_equal, int* out) {
  int b[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) b[r] = 0;
  for (int len = n; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int r = 0; r < 9; ++r) {
      const unsigned k = (unsigned)(skv[b[r] + half] >> 32);
      if (k < q[r] || (or_equal && k == q[r])) b[r] += half;
    }
    len -= half;
  }
#pragma unroll
  for (int r = 0; r < 9; ++r) {
    const unsigned k = (unsigned)(skv[b[r]] >> 32);
    out[r] = b[r] + (k < q[r] || (or_equal && k == q[r]));
  }
}

// one compare-exchange step of a 64-word bitonic network held two words a
// lane (element e = lane and lane + 32): keep the min where the pair's
// lower element sorts up, else the max
__device__ __forceinline__ unsigned long long bitonic_step(
    unsigned long long v, int e, int j, int k) {
  const unsigned long long o = __shfl_xor_sync(kFull, v, j);
  const bool keep_min = ((e & j) == 0) == ((e & k) == 0);
  return keep_min ? (v < o ? v : o) : (v > o ? v : o);
}

template <int kPer>
__global__ void __launch_bounds__(kThreads, 2)
fused_bp_kernel(const float* __restrict__ body_all,
                const int* __restrict__ col_body,
                const int* __restrict__ col_shape,
                const float* __restrict__ col_sta,
                const float* __restrict__ col_off,
                const float* __restrict__ sweep_cap,
                const int* __restrict__ col_grid,
                const int* __restrict__ grid_stat,
                const int* __restrict__ cls_tab,
                const int* __restrict__ jv_big, int* __restrict__ jv_all,
                float* __restrict__ col_all, BpParams p) {
  extern __shared__ unsigned long long skv[];     // [Cg] key << 32 | index
  const int B = p.B, C = p.C, Cg = p.Cg, NS = p.NS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w = blockIdx.x / p.parts, part = blockIdx.x % p.parts;
  // shared memory, as fused_step.bp_smem_bytes counts it
  float* aabb = reinterpret_cast<float*>(skv + Cg);      // [6][Cg]
  int* cls_s = reinterpret_cast<int*>(aabb + 6 * Cg);    // [81]
  int* rowinfo = cls_s + 81;                             // [NS] big row or -1
  int* stat_s = rowinfo + NS;                            // [2][Cg] or none
  int* tile = stat_s + (p.stat_smem ? 2 * Cg : 0);       // [NS][tj + 1]
  const int* stat = p.stat_smem ? stat_s : grid_stat;
  const float* body = body_all + (size_t)w * 29 * B;
  float* col = col_all + (size_t)w * 10 * C;
  int* jv = jv_all + (size_t)w * NS * Cg;

  // ---- 1. poses → col (this CTA's slice), grid AABBs and keys
  const int c_per = (C + p.parts - 1) / p.parts;
  const int c_lo = part * c_per, c_hi = min(C, c_lo + c_per);
  for (int c = tid; c < C; c += kThreads) {
    const Pose o = collider_pose(body, B, col_body, col_off, C, c, p);
    if (c >= c_lo && c < c_hi) {
      col[c] = o.pos.x;
      col[C + c] = o.pos.y;
      col[2 * C + c] = o.pos.z;
      for (int k = 0; k < 4; ++k) col[(3 + k) * C + c] = o.q[k];
      col[7 * C + c] = o.vs.x;
      col[8 * C + c] = o.vs.y;
      col[9 * C + c] = o.vs.z;
    }
    const int g = col_grid[c];
    if (g < 0) continue;
    float amin[3], amax[3];
    collider_aabb(o, col_shape[c], col_sta, C, c, sweep_cap[c], p.margin,
                  amin, amax);
    for (int i = 0; i < 3; ++i) {
      aabb[i * Cg + g] = amin[i];
      aabb[(3 + i) * Cg + g] = amax[i];
    }
    const int key = pack_xyz(floor_i(dvd(amin[0], p.cell)),
                             floor_i(dvd(amin[1], p.cell)),
                             floor_i(dvd(amin[2], p.zfine)));
    skv[g] = ((unsigned long long)(unsigned)key << 32) | (unsigned)g;
  }
  // ---- 2. static tables
  for (int i = tid; i < 81; i += kThreads) cls_s[i] = cls_tab[i];
  if (p.stat_smem)
    for (int i = tid; i < 2 * Cg; i += kThreads) stat_s[i] = grid_stat[i];
  for (int row = tid; row < NS; row += kThreads) {
    int r0 = 0, big = 0, info = -1;
    for (int c = 0; c < 3; ++c) {
      if (p.ns[c] == 0) continue;
      const int s_c = p.ns[c] - p.nbig;
      if (row >= r0 + s_c && row < r0 + p.ns[c]) info = big + row - r0 - s_c;
      r0 += p.ns[c];
      big += p.nbig;
    }
    rowinfo[row] = info;
  }
  __syncthreads();

  // ---- 3. sort: runs of 64 in registers, then merge rounds
  for (int run = warp; run * kRun < Cg; run += kWarps) {
    const int i0 = run * kRun + lane, i1 = i0 + 32;
    unsigned long long a = i0 < Cg ? skv[i0] : ~0ull;    // pads sort last
    unsigned long long b = i1 < Cg ? skv[i1] : ~0ull;
    for (int k = 2; k <= kRun; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        if (j == 32) {          // k == 64: the pair lane, lane + 32
          const unsigned long long lo = a < b ? a : b;
          b = a < b ? b : a;
          a = lo;
        } else {
          a = bitonic_step(a, lane, j, k);
          b = bitonic_step(b, lane + 32, j, k);
        }
      }
    if (i0 < Cg) skv[i0] = a;
    if (i1 < Cg) skv[i1] = b;
  }
  __syncthreads();
  {
    unsigned long long x[kPer];
    int pos[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      pos[k] = tid + k * kThreads;
      x[k] = pos[k] < Cg ? skv[pos[k]] : 0ull;
    }
    // each word's rank in its partner run: a branchless search over the
    // run's len slots (past the end: +inf), kPer words in lockstep
    for (int lg = 6, len = kRun; len < Cg; ++lg, len <<= 1) {
      int to[kPer], b[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) b[k] = 0;
      for (int step = len >> 1; step > 0; step >>= 1)
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int lo = ((pos[k] >> lg) ^ 1) << lg, j = lo + b[k] + step - 1;
          if (j < Cg && skv[j] < x[k]) b[k] += step;
        }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int lo = ((pos[k] >> lg) ^ 1) << lg, j = lo + b[k];
        to[k] = (((pos[k] >> lg) & ~1) << lg) + (pos[k] & (len - 1)) + b[k] +
                (j < Cg && skv[j] < x[k]);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (tid + k * kThreads >= Cg) continue;
        skv[to[k]] = x[k];
        pos[k] = to[k];
      }
      __syncthreads();
    }
  }

  // ---- 4. the walk, one thread per grid collider, in tiles of the slice
  const int g_per = (Cg + p.parts - 1) / p.parts;
  const int g_lo = part * g_per, g_hi = min(Cg, g_lo + g_per);
  const int tjp = p.tj + 1;
  for (int cs = g_lo; cs < g_hi; cs += p.tj) {
    const int ncur = min(p.tj, g_hi - cs);
    for (int gl = tid; gl < ncur; gl += kThreads) {
      const int gi = cs + gl;
      const int si = stat[Cg + gi];
      const int body_i = si >> 5, dyn_i = si & 1;
      const int* tab_i = cls_s + 9 * ((si >> 1) & 15);
      float imin[3], imax[3];
      for (int a = 0; a < 3; ++a) {
        imin[a] = aabb[a * Cg + gi];
        imax[a] = aabb[(3 + a) * Cg + gi];
      }
      const int qx = floor_i(dvd(imin[0], p.cell));
      const int qy = floor_i(dvd(imin[1], p.cell));
      const int qz_lo = floor_i(dvd(sub(imin[2], p.cell), p.zfine));
      const int qz_hi = floor_i(dvd(imax[2], p.zfine));
      // the 9 ranges (dx-major, then dy): first sorted position and count
      unsigned q[9];
      int lo[9], cnt[9], total = 0;
#pragma unroll
      for (int r = 0; r < 9; ++r)
        q[r] = (unsigned)pack_xyz(qx + r / 3 - 1, qy + r % 3 - 1, qz_lo);
      count_keys9(skv, Cg, q, false, lo);
#pragma unroll
      for (int r = 0; r < 9; ++r)
        q[r] = (unsigned)pack_xyz(qx + r / 3 - 1, qy + r % 3 - 1, qz_hi);
      count_keys9(skv, Cg, q, true, cnt);
#pragma unroll
      for (int r = 0; r < 9; ++r) {
        cnt[r] -= lo[r];
        total += cnt[r];
      }
      const int n = min(total, p.s_walk);
      // pass 1: slot m < n in range r at lo_r + (m - its range's offset);
      // the tight and per-class masks of the slots that pass
      unsigned long long tight_m = 0, c0 = 0, c1 = 0, c2 = 0;
      int m = 0;
#pragma unroll
      for (int r = 0; r < 9; ++r) {
        const int e_end = min(cnt[r], n - m);
        for (int e = 0; e < e_end; ++e) {
          const int gj = (int)(skv[min(max(lo[r] + e, 0), Cg - 1)] &
                               0xffffffffull);
          const int sj = stat[Cg + gj];
          bool ok = gj != gi && (sj >> 5) != body_i && (dyn_i || (sj & 1));
          bool tight = true;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float jmin = aabb[a * Cg + gj];
            const float jmax = aabb[(3 + a) * Cg + gj];
            ok = ok && imin[a] <= jmax && imax[a] >= jmin;
            tight = tight && imin[a] <= sub(jmax, p.d2) &&
                    imax[a] >= add(jmin, p.d2);
          }
          if (!ok) continue;
          const unsigned long long bit = 1ull << (m + e);
          const int c = tab_i[(sj >> 1) & 15];
          tight_m |= tight ? bit : 0ull;
          c0 |= c == 0 ? bit : 0ull;
          c1 |= c == 1 ? bit : 0ull;
          c2 |= c == 2 ? bit : 0ull;
        }
        m += max(e_end, 0);
      }
      // pass 2: per class, the tight tier packs first, then the rest, into
      // the class's walked rows (unfilled: -1); a kept slot's partner is
      // read again from the sorted words
      const int s0 = p.ns[0] - p.nbig, s1 = p.ns[1] - p.nbig;
      const int s2 = p.ns[2] - p.nbig;
      const int row1 = p.ns[0], row2 = p.ns[0] + p.ns[1];
      if (p.ns[0])
        for (int k = __popcll(c0); k < s0; ++k) tile[k * tjp + gl] = -1;
      if (p.ns[1])
        for (int k = __popcll(c1); k < s1; ++k)
          tile[(row1 + k) * tjp + gl] = -1;
      if (p.ns[2])
        for (int k = __popcll(c2); k < s2; ++k)
          tile[(row2 + k) * tjp + gl] = -1;
      for (unsigned long long rest = c0 | c1 | c2; rest; rest &= rest - 1ull) {
        const int mm = __ffsll((long long)rest) - 1;
        const unsigned long long bit = 1ull << mm, before = bit - 1ull;
        const int c = (c0 & bit) ? 0 : (c1 & bit) ? 1 : 2;
        const unsigned long long cm = c == 0 ? c0 : c == 1 ? c1 : c2;
        const unsigned long long tf = tight_m & cm;
        const int lpos = (tf & bit) ? __popcll(tf & before)
                                    : __popcll(tf) + __popcll(cm & ~tight_m &
                                                              before);
        if (lpos >= (c == 0 ? s0 : c == 1 ? s1 : s2)) continue;
        int at = 0, off = 0;
#pragma unroll
        for (int r = 0; r < 9; ++r) {
          if (mm >= off && mm < off + cnt[r]) at = lo[r] + mm - off;
          off += max(cnt[r], 0);
        }
        const int gj = (int)(skv[min(max(at, 0), Cg - 1)] & 0xffffffffull);
        tile[((c == 0 ? 0 : c == 1 ? row1 : row2) + lpos) * tjp + gl] =
            stat[gj];
      }
    }
    __syncthreads();
    for (int row = warp; row < NS; row += kWarps) {    // a warp per row
      const int big = rowinfo[row];
      for (int gl = lane; gl < ncur; gl += 32)
        jv[(size_t)row * Cg + cs + gl] =
            big >= 0 ? jv_big[(size_t)big * Cg + cs + gl]
                     : tile[row * tjp + gl];
    }
    __syncthreads();
  }
}

template <int kPer>
int launch(const BpParams& p, size_t smem, cudaStream_t stream,
           const float* body, const int* col_body, const int* col_shape,
           const float* col_sta, const float* col_off, const float* sweep_cap,
           const int* col_grid, const int* grid_stat, const int* cls_tab,
           const int* jv_big, int* jv, float* col) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_bp_kernel<kPer>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_bp_kernel<kPer><<<p.W * p.parts, kThreads, smem, stream>>>(
      body, col_body, col_shape, col_sta, col_off, sweep_cap, col_grid,
      grid_stat, cls_tab, jv_big, jv, col, p);
  return (int)cudaGetLastError();
}

// CTAs per world: enough to fill the card's resident CTAs, at least 64 grid
// colliders each
template <int kPer>
int auto_parts(const BpParams& p, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaFuncSetAttribute(fused_bp_kernel<kPer>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_bp_kernel<kPer>, kThreads, smem) != cudaSuccess)
    return 1;
  const int fill = per_sm * sms / p.W, most = p.Cg / 64;
  const int parts = fill < most ? fill : most;
  return parts > 1 ? parts : 1;
}

}  // namespace

extern "C" int fyrox_fused_bp(
    const void* body, const void* col_body, const void* col_shape,
    const void* col_sta, const void* col_off, const void* sweep_cap,
    const void* col_grid, const void* grid_stat, const void* cls_tab,
    const void* jv_big, void* jv, void* col, int W, int B, int C, int Cg,
    int s_walk, int ns0, int ns1, int ns2, int nbig, int trivial, int parts,
    int smem_limit, float dt, float margin, float cell, float zfine, float d2,
    void* stream) {
  BpParams p{W, B, C, Cg, s_walk, {ns0, ns1, ns2}, ns0 + ns1 + ns2, nbig,
             trivial, 1, 1, 0, dt, margin, cell, zfine, d2};
  const int per = (Cg + kThreads - 1) / kThreads;
  if (s_walk > kMaxWalk || Cg < 1 || per > 16 || parts < 0)
    return (int)cudaErrorInvalidValue;
  // shared memory (at most smem_limit bytes): words and AABBs, cls_tab,
  // row info; then the static table where it fits beside a 32-wide tile,
  // then the widest tile that fits, up to kMaxTile
  const size_t limit = (size_t)smem_limit;
  const size_t base = 32 * (size_t)Cg + 4 * (81 + (size_t)p.NS);
  const size_t row_bytes = 4 * (size_t)p.NS;
  p.stat_smem = base + 8 * (size_t)Cg + row_bytes * 33 <= limit;
  const size_t fixed = base + (p.stat_smem ? 8 * (size_t)Cg : 0);
  if (fixed + 2 * row_bytes > limit) return (int)cudaErrorInvalidValue;
  const size_t fit = (limit - fixed) / row_bytes - 1;
  p.tj = fit < (size_t)kMaxTile ? (int)fit : kMaxTile;
  auto smem_of = [&](int t) { return fixed + row_bytes * (t + 1); };
  cudaStream_t st = (cudaStream_t)stream;
  const float* bd = (const float*)body;
  const int *cb = (const int*)col_body, *cs = (const int*)col_shape;
  const float *sta = (const float*)col_sta, *off = (const float*)col_off;
  const float* cap = (const float*)sweep_cap;
  const int *cg = (const int*)col_grid, *gs = (const int*)grid_stat;
  const int *tab = (const int*)cls_tab, *big = (const int*)jv_big;
  int* out_jv = (int*)jv;
  float* out_col = (float*)col;
#define FYROX_BP_LAUNCH(K)                                                 \
  do {                                                                     \
    p.parts = parts > 0 ? parts : auto_parts<K>(p, smem_of(p.tj));         \
    const int slice = (Cg + p.parts - 1) / p.parts;                        \
    if (slice < p.tj) p.tj = slice;                                        \
    return launch<K>(p, smem_of(p.tj), st, bd, cb, cs, sta, off, cap, cg,  \
                     gs, tab, big, out_jv, out_col);                       \
  } while (0)
  if (per <= 2) FYROX_BP_LAUNCH(2);
  if (per <= 4) FYROX_BP_LAUNCH(4);
  if (per <= 8) FYROX_BP_LAUNCH(8);
  FYROX_BP_LAUNCH(16);
#undef FYROX_BP_LAUNCH
}
