// K3's broadphase stage: collider pose, swept fat AABBs, packed hash-grid
// keys, the stable sort, the 9-neighbour range walk and the per-class
// two-tier compaction into the static candidate windows, for one world per
// CTA.
//
// Replaces the broadphase half of fyrox_tpu/physics/pallas_step.py:794
// fused_full_step_pallas (kernel body _kernel_full :737 → _bp_candidates
// :152-380). The plain PyTorch version of the same function is
// fyrox_tpu_torch/physics/fused_step.py:bp_candidates_plain (the staged
// slab2 pose/AABB stages and broadphase.class_windows, packed as here).
//
// Layout (per world w; B bodies, C colliders, Cg grid colliders):
//   body      [W,29,B] f32  K1 body planes (lv 0-2, pos 6-8, q 9-12 read)
//   col_body, shape, kinds, dyn [C] i32; col_sta [8,C] f32 (params6 ...);
//   col_off [7,C] f32 (offset pos3, rot4); sweep_cap [C] f32;
//   grid_cols [Cg] i32; cls_tab [9,9] i32; jv_big [NSB,Cg] i32 (static
//   big-partner rows, -1 invalid)
//   jv  [W,NS,Cg] i32 out: per class c, s_class[c] walked partners then
//       nbig big rows; -1 invalid
//   col [W,10,C]  f32 out: collider position 3, rotation 4, sweep v·dt 3
//
// Design. One CTA per world (W=128 fills 128 of 132 SMs).
//   1. threads over colliders: pose and sweep → col;
//   2. threads over grid colliders: AABB into shared memory, key packed
//      with its grid index as one 64-bit word (key << 32 | index);
//   3. a block bitonic sort of those words in shared memory (pads sort
//      last). The words are distinct, so the order is exactly the stable
//      key-then-index order of torch.argsort(stable=True);
//   4. threads over grid colliders i: lower_bound / upper_bound binary
//      searches give the 9 neighbour ranges (dx-major, then dy); the walk
//      takes slot m < min(total, s_walk) from range r at lo_r + m - pfx_r;
//      each slot's pair passes if its partner is another collider on
//      another body, one side is dynamic and the AABBs overlap; then, per
//      class, the tight tier (AABBs overlapping by the tight margin) packs
//      first and the rest after it into the class's walked slots, and the
//      class's static big rows follow.
// No one-hot gathers, no (hi, lo) split, no counting rank: those are TPU
// workarounds. Rounding: pose, AABB and key use __fmul_rn / __fadd_rn in
// the plain version's op order (np_planes.cuh), and IEEE division by the
// cell sizes, so a collider lands in the same cell as in the plain version
// and the windows agree as integers.
//
// Bound: memory. A world reads 10 of its 29 body planes and the static
// tables, writes 10 x C collider planes and NS x Cg window rows (~100 KB at
// the flagship's shapes); the sort is ~Cg log²Cg / 4 compare-swaps in
// shared memory and the walk ~s_walk slot tests per collider. With one CTA
// per world the sort's barriers serialise each world; splitting a world's
// walk over more CTAs is later work.
#include <cuda_runtime.h>

#include "np_planes.cuh"

namespace {

using namespace fyrox;

constexpr int kThreads = 512;
constexpr int kMaxWalk = 64;     // fused_step._MAX_WALK
constexpr int kQBitsXY = 9, kQBitsZ = 13;   // broadphase._QBITS_XY / _Z
constexpr int kQHalfXY = 1 << (kQBitsXY - 1), kQHalfZ = 1 << (kQBitsZ - 1);
constexpr float kHuge = 1.0e9f;  // shapes._HUGE
// body plane rows (tgs_kernel layout)
enum { bLV = 0, bPOS = 6, bQ = 9 };

struct BpParams {
  int W, B, C, Cg, s_walk;
  int ns[3];      // window rows per class (walked + big), 0 where absent
  int NS, nbig, trivial, np2;
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

// slab2._aabb_planes for a ball / cuboid / capsule (grid colliders)
__device__ void collider_aabb(const Pose& o, int shape, const float* col_sta,
                              int C, int c, float cap, float margin,
                              float* amin, float* amax) {
  const R9 r = q_to_rot9(o.q[0], o.q[1], o.q[2], o.q[3]);
  float a[9];
  for (int k = 0; k < 9; ++k) a[k] = fabsf(r.m[k]);
  const float p0 = col_sta[c], p1 = col_sta[C + c], p2 = col_sta[2 * C + c];
  float hx, hy, hz;
  if (shape == kCuboid) {
    hx = p0; hy = p1; hz = p2;
  } else {      // capsule: rot_box(p1, p0 + p1, p1)
    hx = p1; hy = add(p0, p1); hz = p1;
  }
  const float pos[3] = {o.pos.x, o.pos.y, o.pos.z};
  const float vs[3] = {o.vs.x, o.vs.y, o.vs.z};
  for (int i = 0; i < 3; ++i) {
    float he;
    if (shape == kBall)
      he = p0;
    else if (shape == kCuboid || shape == kCapsule)
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

// #sorted keys < q (strict) or <= q, over the first n words
__device__ __forceinline__ int count_keys(const unsigned long long* skv, int n,
                                          unsigned q, bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const unsigned k = (unsigned)(skv[mid] >> 32);
    if (k < q || (or_equal && k == q)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
fused_bp_kernel(const float* __restrict__ body_all,
                const int* __restrict__ col_body,
                const int* __restrict__ col_shape,
                const int* __restrict__ kinds, const int* __restrict__ dyn,
                const float* __restrict__ col_sta,
                const float* __restrict__ col_off,
                const float* __restrict__ sweep_cap,
                const int* __restrict__ grid_cols,
                const int* __restrict__ cls_tab,
                const int* __restrict__ jv_big, int* __restrict__ jv_all,
                float* __restrict__ col_all, BpParams p) {
  extern __shared__ unsigned long long skv[];     // [np2] key << 32 | index
  float* aabb = reinterpret_cast<float*>(skv + p.np2);   // [6, Cg]
  const int w = blockIdx.x;
  const int B = p.B, C = p.C, Cg = p.Cg;
  const float* body = body_all + (size_t)w * 29 * B;
  float* col = col_all + (size_t)w * 10 * C;
  int* jv = jv_all + (size_t)w * p.NS * Cg;

  // ---- 1. collider planes
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const Pose o = collider_pose(body, B, col_body, col_off, C, c, p);
    col[c] = o.pos.x;
    col[C + c] = o.pos.y;
    col[2 * C + c] = o.pos.z;
    for (int k = 0; k < 4; ++k) col[(3 + k) * C + c] = o.q[k];
    col[7 * C + c] = o.vs.x;
    col[8 * C + c] = o.vs.y;
    col[9 * C + c] = o.vs.z;
  }
  // ---- 2. grid AABBs and keys
  for (int g = threadIdx.x; g < p.np2; g += blockDim.x) {
    if (g >= Cg) {
      skv[g] = ~0ull;
      continue;
    }
    const int c = grid_cols[g];
    const Pose o = collider_pose(body, B, col_body, col_off, C, c, p);
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
  __syncthreads();
  // ---- 3. bitonic sort, ascending
  for (int k = 2; k <= p.np2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p.np2; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = skv[i], b = skv[ixj];
          if ((a > b) == ((i & k) == 0)) {
            skv[i] = b;
            skv[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  // ---- 4. the walk and the per-class two-tier compaction
  for (int gi = threadIdx.x; gi < Cg; gi += blockDim.x) {
    const int ci = grid_cols[gi];
    const int body_i = col_body[ci], dyn_i = dyn[ci];
    const int* tab_i = cls_tab + 9 * min(max(kinds[ci], 0), 8);
    float imin[3], imax[3];
    for (int a = 0; a < 3; ++a) {
      imin[a] = aabb[a * Cg + gi];
      imax[a] = aabb[(3 + a) * Cg + gi];
    }
    const int qx = floor_i(dvd(imin[0], p.cell));
    const int qy = floor_i(dvd(imin[1], p.cell));
    const int qz_lo = floor_i(dvd(sub(imin[2], p.cell), p.zfine));
    const int qz_hi = floor_i(dvd(imax[2], p.zfine));
    int lo[9], cnt[9], total = 0;
    for (int dx = -1, r = 0; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy, ++r) {
        lo[r] = count_keys(skv, Cg, (unsigned)pack_xyz(qx + dx, qy + dy, qz_lo),
                           false);
        cnt[r] = count_keys(skv, Cg, (unsigned)pack_xyz(qx + dx, qy + dy, qz_hi),
                            true) - lo[r];
        total += cnt[r];
      }
    const int n = min(total, p.s_walk);
    int jr_m[kMaxWalk];
    unsigned long long valid_m = 0, tight_m = 0, cls_m[3] = {0, 0, 0};
    int m = 0;
    for (int r = 0; r < 9 && m < n; ++r)
      for (int e = 0; e < cnt[r] && m < n; ++e, ++m) {
        const int pos = min(max(lo[r] + e, 0), Cg - 1);
        const int gj = (int)(skv[pos] & 0xffffffffull);
        const int cj = grid_cols[gj];
        jr_m[m] = cj;
        bool ok = cj != ci && col_body[cj] != body_i && (dyn_i || dyn[cj]);
        bool tight = true;
        for (int a = 0; a < 3 && ok; ++a) {
          const float jmin = aabb[a * Cg + gj], jmax = aabb[(3 + a) * Cg + gj];
          ok = imin[a] <= jmax && imax[a] >= jmin;
          tight = tight && imin[a] <= sub(jmax, p.d2) &&
                  imax[a] >= add(jmin, p.d2);
        }
        if (!ok) continue;
        const unsigned long long bit = 1ull << m;
        valid_m |= bit;
        if (tight) tight_m |= bit;
        cls_m[tab_i[min(max(kinds[cj], 0), 8)]] |= bit;
      }
    int row0 = 0, big_row = 0;
    for (int cls = 0; cls < 3; ++cls) {
      const int ns = p.ns[cls];
      if (ns == 0) continue;
      const int s_c = ns - p.nbig;
      const unsigned long long tf = tight_m & cls_m[cls];
      const unsigned long long sf = valid_m & cls_m[cls] & ~tight_m;
      const int n_t = __popcll(tf);
      const int n_valid = n_t + __popcll(sf);
      for (int k = n_valid; k < s_c; ++k) jv[(row0 + k) * Cg + gi] = -1;
      unsigned long long rest = tf | sf;
      while (rest) {
        const int mm = __ffsll((long long)rest) - 1;
        const unsigned long long before = (1ull << mm) - 1ull;
        const int lpos = ((tf >> mm) & 1ull) ? __popcll(tf & before)
                                             : n_t + __popcll(sf & before);
        if (lpos < s_c) jv[(row0 + lpos) * Cg + gi] = jr_m[mm];
        rest &= rest - 1ull;
      }
      for (int b = 0; b < p.nbig; ++b, ++big_row)
        jv[(row0 + s_c + b) * Cg + gi] = jv_big[big_row * Cg + gi];
      row0 += ns;
    }
  }
}

}  // namespace

extern "C" int fyrox_fused_bp(
    const void* body, const void* col_body, const void* col_shape,
    const void* kinds, const void* dyn, const void* col_sta,
    const void* col_off, const void* sweep_cap, const void* grid_cols,
    const void* cls_tab, const void* jv_big, void* jv, void* col, int W,
    int B, int C, int Cg, int s_walk, int ns0, int ns1, int ns2, int nbig,
    int trivial, float dt, float margin, float cell, float zfine, float d2,
    void* stream) {
  int np2 = 1;
  while (np2 < Cg) np2 <<= 1;
  BpParams p{W, B, C, Cg, s_walk, {ns0, ns1, ns2}, ns0 + ns1 + ns2, nbig,
             trivial, np2, dt, margin, cell, zfine, d2};
  const size_t smem = 8 * (size_t)np2 + 4 * 6 * (size_t)Cg;
  cudaError_t err = cudaFuncSetAttribute(
      fused_bp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_bp_kernel<<<W, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)body, (const int*)col_body, (const int*)col_shape,
      (const int*)kinds, (const int*)dyn, (const float*)col_sta,
      (const float*)col_off, (const float*)sweep_cap, (const int*)grid_cols,
      (const int*)cls_tab, (const int*)jv_big, (int*)jv, (float*)col, p);
  return (int)cudaGetLastError();
}
