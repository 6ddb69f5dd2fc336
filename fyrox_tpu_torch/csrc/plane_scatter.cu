// K4b: plane scatter-add, out[w, a, b] = sum_k vals[w, a, k] * [idx[w, k] == b];
// an index below 0 or at or above N drops. Sums run in ascending k.
//
// Replaces fyrox_tpu/physics/pallas_ops.py:219 plane_scatter (kernel
// _scatter_kernel :202), which the TPU ran as a one-hot matmul on the MXU
// because its scatters lower to scalar code. Its one caller is the
// counting-rank slab broadphase, which permutes the grid colliders'
// attribute rows into key order (broadphase.class_windows, rank "count").
//
// Design: one CTA per world, two passes over the world's indices.
//   1. counting sort: the CTA stages its indices in shared memory, counts
//      them per output row with integer shared-memory atomics (exact and
//      order-free), scans the counts into bucket offsets, and one warp
//      places each k into its bucket in ascending k (32 indices a step,
//      each lane ranked among the equal keys of lower lanes), so a bucket's
//      order does not depend on the atomics (__match_any_sync ranks equal
//      keys); the other warps meanwhile stage the first chunk of attribute
//      rows vals[a, :] with coalesced loads, eight in flight a thread;
//   2. segment sums: thread b reads its bucket once and, for each staged
//      row a, adds the bucket's values in ascending k from shared memory;
//      the rows of out are written coalesced.
// Each index is read once per world. No float atomics: a launch repeats bit
// for bit, and a permutation (one k per bucket) writes each value added to
// 0.0f, as the plain version does. Shapes of any size go in tiles: output
// rows in buckets of at most kMaxRows, indices in chunks of at most
// kMaxIdx (a bucket's running sum carries from one chunk to the next, so
// the order stays ascending k), attributes as many rows at a time as
// kValFloats holds.
//
// Bound: memory. The flagship's [128, 16, 1000] permutation reads each
// value and index once and writes each output once (16.9 MB); its 2 M
// additions are negligible beside that.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxRows = 4096;     // output rows (buckets) per tile
constexpr int kMaxIdx = 4096;      // indices per chunk
constexpr int kValFloats = 16384;  // staged attribute values (64 KB)

// rows a0 .. a0+na of the chunk's values into sval [na, nk], by threads
// t0, t0 + nt, ...; eight loads in flight a thread
__device__ __forceinline__ void stage(float* sval, const float* wvals, int a0,
                                      int na, int nk, int k0, int K, int t0,
                                      int nt) {
  const int n = na * nk;
  for (int i0 = t0; i0 < n; i0 += 8 * nt) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * nt;
      if (i < n) {
        const int j = i / nk;
        v[u] = __ldg(wvals + (size_t)(a0 + j) * K + k0 + (i - j * nk));
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i0 + u * nt < n) sval[i0 + u * nt] = v[u];
  }
}

__global__ void __launch_bounds__(kThreads)
plane_scatter_kernel(const float* __restrict__ vals,
                     const int* __restrict__ idx, float* __restrict__ out,
                     int A, int K, int N, int KC, int NB, int ACH) {
  extern __shared__ float smem[];
  int* sidx = reinterpret_cast<int*>(smem);   // [KC] the chunk's indices
  int* order = sidx + KC;                     // [KC] local k, bucket-major
  int* cur = order + KC;                      // [NB] counts, then cursors
  int* off = cur + NB;                        // [NB + 1] bucket offsets
  int* part = off + NB + 1;                   // [kThreads] scan partials
  float* sval = reinterpret_cast<float*>(part + kThreads);   // [ACH, KC]
  const int T = blockDim.x, tid = threadIdx.x;
  const int w = blockIdx.x;
  const int* widx = idx + (size_t)w * K;
  const float* wvals = vals + (size_t)w * A * K;
  float* wout = out + (size_t)w * A * N;

  for (int b0 = 0; b0 < N; b0 += NB) {
    const int nb = min(NB, N - b0);
    int k0 = 0;
    do {
      const int nk = min(KC, K - k0);
      // ---- 1. counting sort of the chunk's indices that land in the tile
      // keys relative to the tile, wrapping (unsigned) so that any index
      // outside [b0, b0 + nb) compares out of range
      for (int i = tid; i < nk; i += T)
        sidx[i] = (int)((unsigned)widx[k0 + i] - (unsigned)b0);
      for (int i = tid; i < nb; i += T) cur[i] = 0;
      __syncthreads();
      for (int i = tid; i < nk; i += T) {
        const int b = sidx[i];
        if ((unsigned)b < (unsigned)nb) atomicAdd(&cur[b], 1);
      }
      __syncthreads();
      // exclusive scan: each thread sums a run of buckets, the run sums are
      // scanned across the block, then each run is written out
      const int run = (nb + T - 1) / T;
      const int lo = min(tid * run, nb), hi = min(lo + run, nb);
      int s = 0;
      for (int i = lo; i < hi; ++i) s += cur[i];
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
        const int c = cur[i];
        off[i] = base;
        cur[i] = base;
        base += c;
      }
      if (tid == T - 1) off[nb] = part[T - 1];
      __syncthreads();
      // stable placement by warp 0, 32 indices a step (each lane ranked
      // among the equal keys of the lower lanes), while the other warps
      // stage the first chunk of attribute rows
      const int na0 = min(ACH, A);
      if (tid < 32) {
        for (int t0 = 0; t0 < nk; t0 += 32) {
          const int i = t0 + tid;
          const int key = i < nk ? sidx[i] : -1;
          const bool in = (unsigned)key < (unsigned)nb;
          const unsigned peers = __match_any_sync(0xffffffffu, key);
          const int rank = __popc(peers & ((1u << tid) - 1u));
          const bool last = (peers >> tid) == 1u;
          const int pos = in ? cur[key] + rank : 0;
          __syncwarp();
          if (in) {
            order[pos] = i;
            if (last) cur[key] = pos + 1;
          }
          __syncwarp();
        }
      } else {
        stage(sval, wvals, 0, na0, nk, k0, K, tid - 32, T - 32);
      }
      __syncthreads();
      // ---- 2. segment sums, ACH attribute rows at a time: thread b takes
      // its bucket once and sums it for every row of the chunk
      for (int a0 = 0; a0 < A; a0 += ACH) {
        const int na = min(ACH, A - a0);
        if (a0 > 0) {
          stage(sval, wvals, a0, na, nk, k0, K, tid, T);
          __syncthreads();
        }
        for (int b = tid; b < nb; b += T) {
          const int p0 = off[b], p1 = off[b + 1];
          for (int j = 0; j < na; ++j) {
            float* dst = wout + (size_t)(a0 + j) * N + b0 + b;
            float acc = k0 == 0 ? 0.0f : *dst;
            const float* row = sval + j * nk;
            for (int p = p0; p < p1; ++p)
              acc = __fadd_rn(acc, row[order[p]]);
            *dst = acc;
          }
        }
        __syncthreads();
      }
      k0 += KC;
    } while (k0 < K);
  }
}

}  // namespace

extern "C" int fyrox_plane_scatter(const void* vals, const void* idx,
                                   void* out, int W, int A, int K, int N,
                                   void* stream) {
  if (W == 0 || A == 0 || N == 0) return 0;
  const int KC = K < 1 ? 1 : (K < kMaxIdx ? K : kMaxIdx);
  const int NB = N < kMaxRows ? N : kMaxRows;
  const int fit = kValFloats / KC;
  const int ACH = fit < 1 ? 1 : (fit < A ? fit : A);
  const size_t smem = sizeof(int) * (2 * (size_t)KC + 2 * (size_t)NB + 1
                                     + kThreads)
                    + sizeof(float) * (size_t)ACH * KC;
  cudaError_t err = cudaFuncSetAttribute(
      plane_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  plane_scatter_kernel<<<W, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)vals, (const int*)idx, (float*)out, A, K, N, KC, NB, ACH);
  return (int)cudaGetLastError();
}
