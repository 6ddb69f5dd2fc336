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
// Bound: operations. Each (pixel, walked slot) costs ~31 float operations
// (five affine forms of 2 multiplies and 2 adds, two subtracts, a divide,
// six compares) against 64 bytes of feature row per slot that 1,024 pixels
// share, so the card's float32 rate bounds it, not HBM. The design keeps
// every byte it can out of device memory: one CTA of 256 threads per
// (image, tile), 4 pixels per thread held in registers; the CTA reads its
// own count and slot ids and gathers the rows straight from feats
// [images, T, 16] into shared memory, 64 rows (4 KB) at a time, so no
// [tiles, K, 16] copy is ever written (the TPU path materialises one); it
// walks exactly `count` slots, not the TPU's chunks of 8. No atomics: two
// launches give the same bits. Every operation is an IEEE round-to-nearest
// intrinsic in the plain version's order (render/tile_raster.py
// visibility_plain), never contracted, so the two agree bit for bit.
// Faster forms (an early out per tile, wider tiles, warp specialisation)
// are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;            // pixels per thread: tiles up to 1,024 px
constexpr int kRows = 64;          // feature rows per shared-memory chunk
constexpr int kFeat = 16;
constexpr float kBig = 1e9f;

__device__ __forceinline__ float affine(const float* f, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(f[0], px), __fmul_rn(f[1], py)), f[2]);
}

template <bool DEPTH_ONLY>
__global__ void __launch_bounds__(kThreads)
tile_raster_kernel(const float* __restrict__ feats,
                   const int* __restrict__ ids,
                   const int* __restrict__ count,
                   float* __restrict__ z_out, int* __restrict__ idx_out,
                   float* __restrict__ w0_out, float* __restrict__ w1_out,
                   int T, int K, int H, int W, int tile_h, int tile_w,
                   int n_tiles) {
  extern __shared__ float rows[];                 // kRows x kFeat floats
  const int tile = blockIdx.x;
  const int img = blockIdx.y;
  const int ntx = W / tile_w;
  const int ti = tile / ntx, tj = tile % ntx;
  const int tile_px = tile_h * tile_w;
  const size_t cell = (size_t)img * n_tiles + tile;
  const int n = __ldg(count + cell);
  const int* tile_ids = ids + cell * K;
  const float* img_feats = feats + (size_t)img * T * kFeat;

  float px[kPix], py[kPix], zb[kPix], w0b[kPix], w1b[kPix];
  int ib[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = threadIdx.x + j * kThreads;
    const int row = p / tile_w, col = p % tile_w;
    py[j] = __fadd_rn((float)(ti * tile_h + row), 0.5f);
    px[j] = __fadd_rn((float)(tj * tile_w + col), 0.5f);
    zb[j] = kBig;
    ib[j] = -1;
    w0b[j] = 0.0f;
    w1b[j] = 0.0f;
  }

  const int lrow = threadIdx.x >> 2, quarter = threadIdx.x & 3;
  for (int base = 0; base < n; base += kRows) {
    const int m = min(kRows, n - base);
    __syncthreads();                              // last chunk consumed
    if (lrow < m) {
      const int id = __ldg(tile_ids + base + lrow);
      const float4 v =
          reinterpret_cast<const float4*>(img_feats + (size_t)id * kFeat)[quarter];
      reinterpret_cast<float4*>(rows)[lrow * 4 + quarter] = v;
    }
    __syncthreads();
    for (int s = 0; s < m; ++s) {
      const float* f = rows + s * kFeat;
      const bool ok = f[15] > 0.5f;
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        if (threadIdx.x + j * kThreads >= tile_px) continue;
        const float e0 = affine(f + 0, px[j], py[j]);
        const float e1 = affine(f + 3, px[j], py[j]);
        const float sf = affine(f + 6, px[j], py[j]);
        const float zf = affine(f + 9, px[j], py[j]);
        const float wf = affine(f + 12, px[j], py[j]);
        const float e2 = __fsub_rn(__fsub_rn(sf, e0), e1);
        const bool in_front = wf > 1e-12f;
        const float z = __fdiv_rn(zf, in_front ? wf : 1.0f);
        const bool inside = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f &&
                            in_front && z >= -1.0f && z <= 1.0f && ok;
        if (inside && z < zb[j]) {
          zb[j] = z;
          if (!DEPTH_ONLY) {
            const float s_safe = sf == 0.0f ? 1.0f : sf;
            ib[j] = base + s;
            w0b[j] = __fdiv_rn(e0, s_safe);
            w1b[j] = __fdiv_rn(e1, s_safe);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = threadIdx.x + j * kThreads;
    if (p >= tile_px) continue;
    const int y = ti * tile_h + p / tile_w, x = tj * tile_w + p % tile_w;
    const size_t o = ((size_t)img * H + y) * W + x;
    z_out[o] = zb[j];
    if (!DEPTH_ONLY) {
      idx_out[o] = ib[j];
      w0_out[o] = w0b[j];
      w1_out[o] = w1b[j];
    }
  }
}

}  // namespace

// feats [B, T, 16] f32, ids [B, NT, K] i32, count [B, NT] i32 → z [B, H, W]
// f32 and, unless depth_only, idx i32, w0, w1 f32 [B, H, W]. H and W are
// multiples of the tile, tile_h * tile_w <= 1024, NT = (H/tile_h)(W/tile_w).
extern "C" int fyrox_tile_raster(const void* feats, const void* ids,
                                 const void* count, void* z, void* idx,
                                 void* w0, void* w1, int B, int T, int K,
                                 int H, int W, int tile_h, int tile_w,
                                 int depth_only, void* stream) {
  if (tile_h * tile_w > kThreads * kPix || H % tile_h || W % tile_w)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (H / tile_h) * (W / tile_w);
  auto kern = depth_only ? tile_raster_kernel<true> : tile_raster_kernel<false>;
  dim3 grid(n_tiles, B);
  kern<<<grid, kThreads, kRows * kFeat * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)feats, (const int*)ids, (const int*)count, (float*)z,
      (int*)idx, (float*)w0, (float*)w1, T, K, H, W, tile_h, tile_w, n_tiles);
  return (int)cudaGetLastError();
}
