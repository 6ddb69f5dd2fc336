// K5: tile visibility of the binned 2DH rasterizer, full and depth-only.
//
// Replaces fyrox_tpu/render/pallas_raster.py:352 _visibility_pallas (its
// body _raster_kernel :230). Per image (a world's camera view, or one
// (world, cascade) shadow map) and per tile of tile_h x tile_w pixels (8 x
// 128 where the image allows), walk the tile's `count` binned feature rows
// in slot order and keep a z-buffer: per pixel centre p = (x+.5, y+.5)
// evaluate the affine forms E0, E1, S, Z, W (feature slots 0-14), take
// e2 = S - E0 - E1, z = Z / W, and count the pixel as inside where e0, e1,
// e2 >= 0, W > 1e-12, -1 <= z <= 1 and the row's ok flag (slot 15) is set.
// A strict `<` keeps the lowest slot on a tie, as on the TPU. The full
// variant writes z, the winning slot (-1 where nothing is hit) and the
// perspective-correct barycentrics w0 = E0 / S, w1 = E1 / S (0 where
// nothing is hit); the depth-only variant writes z (1e9 where nothing is
// hit).
//
// Bound: bytes, the walked ids and feature rows read once and the outputs
// written once (under 0.01 ms at the bench frame); the function needs ~31
// float operations only for the (pixel, slot) pairs whose three edge tests
// pass, 2-3 % of the walked pairs there, and a slot's 64-byte row serves
// 1,024 pixels. The kernel is far from both: what costs is (1) evaluating
// walked pairs that cannot be inside and (2) the latency of a tile's walk,
// serial in slot order, where a few tiles walk 10-20x the mean count. The
// design:
//  - each warp owns a compact rectangle of the tile (8 rows x 16 columns of
//    an 8 x 128 tile, 4 pixels a lane; the host picks the rectangle from the
//    tile's shape, or row-major runs of 128 pixels where no rectangle grid
//    fits 8 warps), and reduces its pixel centres' bounding box once;
//  - a warp rejects a chunk's slots 32 at a time, a lane per slot, before
//    any per-pixel work: a slot is dropped when its ok flag fails or when
//    E0, E1 or W evaluated at the box corner that maximises the form fails
//    the plain test there. Round-to-nearest is monotone, so fl(a*px) is
//    monotone in px with the sign of a and fl(u+v) is non-decreasing in u
//    and v: the rounded form at every pixel of the box is at most its
//    rounded value at that corner. A NaN at the corner rejects nothing (the
//    tests are `< 0` and `<= 1e-12`). E2 = S - E0 - E1 is not monotone in
//    the pixel and is tested per pixel. A ballot gives the kept slots, which
//    the warp walks in slot order;
//  - a kept slot costs each lane E0, E1, S and e2 for its pixels; Z, W and
//    the divide z = Z / W are taken only where e0, e1, e2 >= 0, and a warp
//    skips that block when no lane has such a pixel (__any_sync);
//  - the full variant keeps the winner's e0, e1 and S in registers and
//    divides w0 = e0 / S, w1 = e1 / S once after the walk: the operands are
//    the plain version's, so the bits are;
//  - a tile that walks more than `span` slots is split: a one-block plan
//    kernel cuts it into parts of at most `span` consecutive slots (span
//    doubled until the parts fit the caller's scratch), helper CTAs, first
//    in the grid, take the parts from a counter, and each part's best
//    (z, slot) per pixel goes to its own scratch slice as the key
//    ord(z) << 32 | slot (ord maps floats to unsigned integers in their
//    order, -0 as +0). The CTA that finishes a tile's last part (an integer
//    counter) takes the least key per pixel, which is the plain walk's
//    winner: the least z, the lowest slot on a tie. It recomputes z, w0 and
//    w1 from the winner's row, so the bits are the plain version's, and no
//    float passes through an atomic. Where K <= span no tile can be split,
//    and neither the plan kernel nor a helper is launched. (A fixed grid
//    of ceil(K / span) CTAs a tile merging by atomicMin needs no plan, but
//    most of its CTAs return at once, 27,648 in the bench's cascade pass,
//    and they cost more than the plan does.)
// The CTA of a tile reads its count and slot ids and gathers the rows
// straight from feats [images, T, 16] into shared memory, 64 rows at a time
// in two field-major buffers (8 KB), the next chunk loading into registers
// while the warps walk this one; it writes no [tiles, K, 16] copy (the TPU
// path materialises one) and walks exactly `count` slots, not the TPU's
// chunks of 8. Every operation is an IEEE round-to-nearest intrinsic in the
// plain version's order (render/tile_raster.py visibility_plain), never
// contracted, and skipped work is only work whose plain `inside` is false,
// so the two agree bit for bit, and two launches give the same bits.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 4;            // pixels per lane: tiles up to 1,024 px
constexpr int kWarpPix = 32 * kPix;
constexpr int kTilePix = kThreads * kPix;
constexpr int kRows = 64;          // feature rows per shared-memory chunk
constexpr int kFeat = 16;
constexpr int kItem = 5;           // a part: cell, lo, hi, first part, parts
constexpr int kSpans = 16;         // span, 2 span, ... tried by the plan
constexpr float kBig = 1e9f;
constexpr unsigned long long kNoHit = ~0ull;

// An affine form a * px + b * py + c whose coefficients lie S floats apart.
template <int S>
__device__ __forceinline__ float form(const float* f, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(f[0], px), __fmul_rn(f[S], py)),
                   f[2 * S]);
}

// The form at the corner of [xlo, xhi] x [ylo, yhi] that maximises it.
__device__ __forceinline__ float form_max(const float* f, float xlo,
                                          float xhi, float ylo, float yhi) {
  return form<kRows>(f, f[0] >= 0.0f ? xhi : xlo,
                     f[kRows] >= 0.0f ? yhi : ylo);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u < v ? u : v;
  }
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// The launch's shapes.
struct Shape {
  int T, K, H, W, tile_h, tile_w, rect_w, n_tiles;
};

// A lane's pixels of one tile and its warp's box of pixel centres.
// rect_w > 0: warp w owns the rectangle (w / nrx, w % nrx) of rect_w
// columns x 128 / rect_w rows, nrx = ceil(tile_w / rect_w), and lane l's
// pixel j is its pixel l + 32 j in row-major order; rect_w == 0: warp w
// owns the tile's row-major pixels 128 w .. 128 w + 127.
struct Pixels {
  int img, y0, x0;                 // image, tile origin
  int prow[kPix], pcol[kPix];
  float px[kPix], py[kPix];
  bool live[kPix];
  float xlo, xhi, ylo, yhi;
  bool warp_live;

  __device__ __forceinline__ Pixels(const Shape& sh, int cell) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int tile = cell % sh.n_tiles, ntx = sh.W / sh.tile_w;
    img = cell / sh.n_tiles;
    y0 = tile / ntx * sh.tile_h;
    x0 = tile % ntx * sh.tile_w;
    xlo = ylo = kBig;
    xhi = yhi = -kBig;
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int q = lane + 32 * j;
      if (sh.rect_w > 0) {
        const int nrx = (sh.tile_w + sh.rect_w - 1) / sh.rect_w;
        prow[j] = (warp / nrx) * (kWarpPix / sh.rect_w) + q / sh.rect_w;
        pcol[j] = (warp % nrx) * sh.rect_w + q % sh.rect_w;
      } else {
        const int p = warp * kWarpPix + q;
        prow[j] = p / sh.tile_w;
        pcol[j] = p % sh.tile_w;
      }
      live[j] = prow[j] < sh.tile_h && pcol[j] < sh.tile_w;
      py[j] = __fadd_rn((float)(y0 + prow[j]), 0.5f);
      px[j] = __fadd_rn((float)(x0 + pcol[j]), 0.5f);
      if (live[j]) {
        xlo = px[j] < xlo ? px[j] : xlo;
        xhi = px[j] > xhi ? px[j] : xhi;
        ylo = py[j] < ylo ? py[j] : ylo;
        yhi = py[j] > yhi ? py[j] : yhi;
      }
    }
    // the warp's box (empty where it owns no pixel)
    xlo = warp_min(xlo);
    xhi = warp_max(xhi);
    ylo = warp_min(ylo);
    yhi = warp_max(yhi);
    warp_live = xlo <= xhi;
  }

  __device__ __forceinline__ size_t out(const Shape& sh, int j) const {
    return ((size_t)img * sh.H + y0 + prow[j]) * sh.W + x0 + pcol[j];
  }
};

// A lane's best hit per pixel so far: z, slot, and the winner's e0, e1, S.
struct Best {
  float z[kPix], e0[kPix], e1[kPix], s[kPix];
  int slot[kPix];

  __device__ __forceinline__ Best() {
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      z[j] = kBig;
      slot[j] = -1;
      e0[j] = e1[j] = s[j] = 0.0f;
    }
  }
};

// Walk slots [lo, hi) of a tile in slot order into `b`, keeping the
// winners' slots where SLOT and their e0, e1, S where BARY. Every thread of
// the CTA calls it with the same range; the caller synchronises the CTA
// between two walks.
template <bool SLOT, bool BARY>
__device__ __forceinline__ void walk(const Pixels& P, Best& b, float* rows,
                                     const int* tile_ids,
                                     const float* img_feats, int lo,
                                     int hi) {
  const int lane = threadIdx.x & 31;
  // Chunk rows are staged field-major, rows[(buf * kFeat + i) * kRows + s],
  // in two buffers: thread t brings fields 4q..4q+3 of row t % 64 (q = t /
  // 64), and loads the next chunk's into registers while the warps walk.
  const int srow = threadIdx.x % kRows, sq = threadIdx.x / kRows;
  float4 v = {0.0f, 0.0f, 0.0f, 0.0f};
  if (lo + srow < hi)
    v = reinterpret_cast<const float4*>(
        img_feats + (size_t)__ldg(tile_ids + lo + srow) * kFeat)[sq];
  for (int base = lo, buf = 0; base < hi; base += kRows, buf ^= 1) {
    const int m = min(kRows, hi - base);
    const float* R = rows + buf * kFeat * kRows;
    if (srow < m) {
      float* d = rows + (buf * kFeat + 4 * sq) * kRows + srow;
      d[0] = v.x;
      d[kRows] = v.y;
      d[2 * kRows] = v.z;
      d[3 * kRows] = v.w;
    }
    __syncthreads();             // this chunk staged; the other buffer's
                                 // chunk walked by every warp
    if (base + kRows + srow < hi)
      v = reinterpret_cast<const float4*>(
          img_feats +
          (size_t)__ldg(tile_ids + base + kRows + srow) * kFeat)[sq];
    if (!P.warp_live) continue;
    for (int h = 0; h < m; h += 32) {
      // the warp's rejection of 32 slots at once, a lane per slot
      bool keep_s = false;
      if (h + lane < m) {
        const float* c = R + h + lane;
        const float e0c = form_max(c + 0 * kRows, P.xlo, P.xhi, P.ylo, P.yhi);
        const float e1c = form_max(c + 3 * kRows, P.xlo, P.xhi, P.ylo, P.yhi);
        const float wc = form_max(c + 12 * kRows, P.xlo, P.xhi, P.ylo, P.yhi);
        keep_s = c[15 * kRows] > 0.5f &&
                 !(e0c < 0.0f || e1c < 0.0f || wc <= 1e-12f);
      }
      // the kept slots in slot order
      for (unsigned keep = __ballot_sync(0xffffffffu, keep_s); keep;
           keep &= keep - 1) {
        const int s = h + __ffs(keep) - 1;
        const float* c = R + s;
        float e0[kPix], e1[kPix], sf[kPix];
        bool cov[kPix];
        bool any = false;
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          e0[j] = form<kRows>(c + 0 * kRows, P.px[j], P.py[j]);
          e1[j] = form<kRows>(c + 3 * kRows, P.px[j], P.py[j]);
          sf[j] = form<kRows>(c + 6 * kRows, P.px[j], P.py[j]);
          const float e2 = __fsub_rn(__fsub_rn(sf[j], e0[j]), e1[j]);
          cov[j] = P.live[j] && e0[j] >= 0.0f && e1[j] >= 0.0f && e2 >= 0.0f;
          any |= cov[j];
        }
        if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          if (!cov[j]) continue;
          const float wf = form<kRows>(c + 12 * kRows, P.px[j], P.py[j]);
          if (!(wf > 1e-12f)) continue;
          const float z =
              __fdiv_rn(form<kRows>(c + 9 * kRows, P.px[j], P.py[j]), wf);
          if (z >= -1.0f && z <= 1.0f && z < b.z[j]) {
            b.z[j] = z;
            if (SLOT) b.slot[j] = base + s;
            if (BARY) {
              b.e0[j] = e0[j];
              b.e1[j] = e1[j];
              b.s[j] = sf[j];
            }
          }
        }
      }
    }
  }
}

template <bool DEPTH_ONLY>
__device__ __forceinline__ void emit(size_t o, float z, int slot, float e0,
                                     float e1, float s, float* z_out,
                                     int* idx_out, float* w0_out,
                                     float* w1_out) {
  z_out[o] = z;
  if (!DEPTH_ONLY) {
    const bool hit = slot >= 0;
    const float s_safe = s == 0.0f ? 1.0f : s;
    idx_out[o] = slot;
    w0_out[o] = hit ? __fdiv_rn(e0, s_safe) : 0.0f;
    w1_out[o] = hit ? __fdiv_rn(e1, s_safe) : 0.0f;
  }
}

// z in [-1, 1] → an unsigned integer in the floats' order, -0 as +0.
__device__ __forceinline__ unsigned ordered(float z) {
  const unsigned u = z == 0.0f ? 0u : __float_as_uint(z);
  return (u & 0x80000000u) ? ~u : u | 0x80000000u;
}

// One block: cut every tile that walks more than `span` slots into parts of
// at most `span` (span doubled, up to kSpans times, until the parts fit
// `cap`; no split where none fits). plan = {parts, next part to take,
// span}; items[i] = {cell, lo, hi, first part of the cell, its parts}.
__global__ void __launch_bounds__(1024)
tile_raster_plan(const int* __restrict__ count, int n_cells, int span0,
                 int cap, int* __restrict__ plan, int* __restrict__ items,
                 int* __restrict__ done) {
  extern __shared__ float plan_smem[];
  int* tot = reinterpret_cast<int*>(plan_smem);   // [kSpans + 1]
  if (threadIdx.x <= kSpans) tot[threadIdx.x] = 0;
  __syncthreads();
  for (int c = threadIdx.x; c < n_cells; c += blockDim.x) {
    const int n = count[c];
    for (int k = 0, sp = span0; k < kSpans && n > sp; ++k, sp *= 2) {
      atomicAdd(tot + k, (n - 1) / sp + 1);
      if (sp > n / 2) break;     // every longer span holds n whole
    }
  }
  __syncthreads();
  int span = 0x7fffffff;
  for (int k = kSpans - 1; k >= 0; --k) {
    const long long sp = (long long)span0 << k;
    if (tot[k] <= cap) span = sp < 0x7fffffff ? (int)sp : 0x7fffffff;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n_cells; c += blockDim.x) {
    const int n = count[c];
    if (n <= span) continue;
    const int parts = (n + span - 1) / span, size = (n + parts - 1) / parts;
    const int first = atomicAdd(tot + kSpans, parts);
    done[c] = 0;
    for (int p = 0; p < parts; ++p) {
      int* it = items + (size_t)(first + p) * kItem;
      it[0] = c;
      it[1] = p * size;
      it[2] = min(n, (p + 1) * size);
      it[3] = first;
      it[4] = parts;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    plan[0] = tot[kSpans];
    plan[1] = 0;
    plan[2] = span;
  }
}

// Blocks [0, n_help) are helpers that take the split tiles' parts; block
// n_help + c is the tile of cell c (image c / n_tiles, tile c % n_tiles),
// which returns at once where its tile was split (no plan: none is). The depth-only variant
// fits 64 registers, 4 CTAs an SM; the full variant's 80 keep 3.
template <bool DEPTH_ONLY>
__global__ void __launch_bounds__(kThreads, DEPTH_ONLY ? 4 : 3)
tile_raster_kernel(const float* __restrict__ feats,
                   const int* __restrict__ ids,
                   const int* __restrict__ count,
                   float* __restrict__ z_out, int* __restrict__ idx_out,
                   float* __restrict__ w0_out, float* __restrict__ w1_out,
                   Shape sh, int n_help, int* __restrict__ plan,
                   const int* __restrict__ items, int* __restrict__ done,
                   unsigned long long* __restrict__ slices) {
  extern __shared__ float rows[];  // 2 x kFeat x kRows, then 2 ints
  int* flag = reinterpret_cast<int*>(rows + 2 * kFeat * kRows);
  if ((int)blockIdx.x >= n_help) {
    const int cell = blockIdx.x - n_help;
    const int n = __ldg(count + cell);
    if (plan != nullptr && n > plan[2]) return;
    const Pixels P(sh, cell);
    Best b;
    walk<!DEPTH_ONLY, !DEPTH_ONLY>(P, b, rows, ids + (size_t)cell * sh.K,
                     feats + (size_t)P.img * sh.T * kFeat, 0, n);
#pragma unroll
    for (int j = 0; j < kPix; ++j)
      if (P.live[j])
        emit<DEPTH_ONLY>(P.out(sh, j), b.z[j], b.slot[j], b.e0[j], b.e1[j],
                         b.s[j], z_out, idx_out, w0_out, w1_out);
    return;
  }
  const int n_items = plan[0];
  for (;;) {
    __syncthreads();             // the last part's flags and rows are read
    if (threadIdx.x == 0) flag[0] = atomicAdd(plan + 1, 1);
    __syncthreads();
    const int i = flag[0];
    if (i >= n_items) return;
    const int* it = items + (size_t)i * kItem;
    const int cell = it[0], first = it[3], parts = it[4];
    const Pixels P(sh, cell);
    const int* tile_ids = ids + (size_t)cell * sh.K;
    const float* img_feats = feats + (size_t)P.img * sh.T * kFeat;
    Best b;                      // a part keeps its winning slots
    walk<true, false>(P, b, rows, tile_ids, img_feats, it[1], it[2]);
#pragma unroll
    for (int j = 0; j < kPix; ++j)
      if (P.live[j])
        slices[(size_t)i * kTilePix + P.prow[j] * sh.tile_w + P.pcol[j]] =
            b.slot[j] < 0 ? kNoHit
                          : (unsigned long long)ordered(b.z[j]) << 32 |
                                (unsigned)b.slot[j];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) flag[1] = atomicAdd(done + cell, 1) == parts - 1;
    __syncthreads();
    if (!flag[1]) continue;
    __threadfence();             // the tile's last part: merge the parts
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (!P.live[j]) continue;
      const int local = P.prow[j] * sh.tile_w + P.pcol[j];
      unsigned long long key = kNoHit;
      for (int q = first; q < first + parts; ++q) {
        const unsigned long long k =
            __ldcg(slices + (size_t)q * kTilePix + local);
        key = k < key ? k : key;
      }
      if (key == kNoHit) {
        emit<DEPTH_ONLY>(P.out(sh, j), kBig, -1, 0.0f, 0.0f, 0.0f, z_out,
                         idx_out, w0_out, w1_out);
        continue;
      }
      // the winner's row, evaluated as the walk did
      const int slot = (int)(key & 0xffffffffu);
      const float* f = img_feats + (size_t)__ldg(tile_ids + slot) * kFeat;
      const float px = P.px[j], py = P.py[j];
      const float z =
          __fdiv_rn(form<1>(f + 9, px, py), form<1>(f + 12, px, py));
      emit<DEPTH_ONLY>(P.out(sh, j), z, slot, form<1>(f + 0, px, py),
                       form<1>(f + 3, px, py), form<1>(f + 6, px, py),
                       z_out, idx_out, w0_out, w1_out);
    }
  }
}

// The warps' rectangle width: the one of 16, 32, 64, 128 columns (128 px a
// warp) whose grid over the tile needs the fewest rectangles, the narrowest
// on a tie; 0 (row-major runs) where every grid needs more than 8.
int rect_width(int tile_h, int tile_w) {
  int best = kWarps + 1, width = 0;
  for (int rw = 16; rw <= kWarpPix; rw *= 2) {
    const int rh = kWarpPix / rw;
    const int nr = ((tile_h + rh - 1) / rh) * ((tile_w + rw - 1) / rw);
    if (nr < best) {
      best = nr;
      width = rw;
    }
  }
  return best <= kWarps ? width : 0;
}

}  // namespace

// feats [B, T, 16] f32, ids [B, NT, K] i32, count [B, NT] i32 → z [B, H, W]
// f32 and, unless depth_only, idx i32, w0, w1 f32 [B, H, W]. H and W are
// multiples of the tile, tile_h * tile_w <= 1024, NT = (H/tile_h)(W/tile_w).
// Tiles above `span` slots are split into at most `cap` parts in all.
// Scratch: plan int32 [3 + 5 cap + B NT] (plan, parts, counters per tile),
// slices int64 [cap, 1024]; where plan is null (K <= span, or cap 0: no
// tile can be split) neither the plan kernel nor a helper is launched.
extern "C" int fyrox_tile_raster(const void* feats, const void* ids,
                                 const void* count, void* z, void* idx,
                                 void* w0, void* w1, int B, int T, int K,
                                 int H, int W, int tile_h, int tile_w,
                                 int depth_only, int span, int cap,
                                 void* plan, void* slices, void* stream) {
  if (tile_h * tile_w > kTilePix || H % tile_h || W % tile_w || span < 1 ||
      cap < 0)
    return (int)cudaErrorInvalidValue;
  const Shape sh{T, K, H, W, tile_h, tile_w, rect_width(tile_h, tile_w),
                 (H / tile_h) * (W / tile_w)};
  const int n_cells = B * sh.n_tiles;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return (int)cudaGetLastError();
  int* p = (int*)plan;
  int* items = p ? p + 3 : nullptr;
  int* done = p ? items + (size_t)kItem * cap : nullptr;
  const cudaStream_t st = (cudaStream_t)stream;
  if (p)
    tile_raster_plan<<<1, 1024, (kSpans + 1) * sizeof(int), st>>>(
        (const int*)count, n_cells, span, cap, p, items, done);
  const int n_help = p ? min(cap, 4 * sms) : 0;
  auto kern = depth_only ? tile_raster_kernel<true> : tile_raster_kernel<false>;
  kern<<<n_help + n_cells, kThreads,
         2 * kRows * kFeat * sizeof(float) + 2 * sizeof(int), st>>>(
      (const float*)feats, (const int*)ids, (const int*)count, (float*)z,
      (int*)idx, (float*)w0, (float*)w1, sh, n_help, p, items, done,
      (unsigned long long*)slices);
  return (int)cudaGetLastError();
}
