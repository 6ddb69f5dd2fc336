// K4b: plane scatter-add, out[w, a, b] = sum_k vals[w, a, k] * [idx[w, k] == b];
// an index below 0 or at or above N drops.
//
// Replaces fyrox_tpu/physics/pallas_ops.py:219 plane_scatter (kernel
// _scatter_kernel :202), which the TPU ran as a one-hot matmul on the MXU
// because its scatters lower to scalar code. Its one caller is the
// counting-rank slab broadphase, which permutes the grid colliders'
// attribute rows into key order (broadphase.class_windows, rank "count").
//
// Design: one thread per output row (w, b). A block stages its world's
// indices in shared memory, one tile of blockDim.x at a time, and every
// thread scans the tile (all threads read the same word: a broadcast) and
// adds the attribute values of each match to its registers, in ascending
// k. No float atomics: each output is a fixed-order sum, so a launch
// repeats bit for bit, and a permutation (one match per row) writes each
// value unchanged. Attributes go in chunks of kChunk registers; a chunk
// rescans the indices.
//
// Bound: memory. The work is K*N compares per world (as the TPU's
// one-hot), ~1e6 at the flagship's [128, 16, 1000] permutation, a few
// microseconds of the card's integer rate; the bytes are each value read
// once and each output written once. The scattered value reads (one row of
// a matched k per thread) are what a faster two-pass design (a counting
// sort of idx per world, then segment sums) would make contiguous.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;   // attribute accumulators per thread

__global__ void plane_scatter_kernel(const float* __restrict__ vals,
                                     const int* __restrict__ idx,
                                     float* __restrict__ out,
                                     int A, int K, int N) {
  extern __shared__ float smem[];
  int* sidx = reinterpret_cast<int*>(smem);          // [blockDim.x]
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int w = blockIdx.y;
  const int* widx = idx + (size_t)w * K;
  const float* wvals = vals + (size_t)w * A * K;
  for (int a0 = 0; a0 < A; a0 += kChunk) {
    const int na = min(kChunk, A - a0);
    float acc[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) acc[j] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += blockDim.x) {
      const int nk = min((int)blockDim.x, K - k0);
      __syncthreads();
      if ((int)threadIdx.x < nk) sidx[threadIdx.x] = __ldg(widx + k0 + threadIdx.x);
      __syncthreads();
      for (int kk = 0; kk < nk; ++kk) {
        if (sidx[kk] != b) continue;
        const float* src = wvals + (size_t)a0 * K + k0 + kk;
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          if (j < na) acc[j] = __fadd_rn(acc[j], __ldg(src + (size_t)j * K));
      }
    }
    if (b < N) {
      float* dst = out + ((size_t)w * A + a0) * N + b;
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (j < na) dst[(size_t)j * N] = acc[j];
    }
  }
}

}  // namespace

extern "C" int fyrox_plane_scatter(const void* vals, const void* idx,
                                   void* out, int W, int A, int K, int N,
                                   void* stream) {
  const int threads = 256;
  dim3 grid((N + threads - 1) / threads, W);
  plane_scatter_kernel<<<grid, threads, threads * sizeof(int),
                         (cudaStream_t)stream>>>(
      (const float*)vals, (const int*)idx, (float*)out, A, K, N);
  return (int)cudaGetLastError();
}
