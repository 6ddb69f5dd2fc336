// K4a: plane gather, out[w, a, k] = planes[w, a, idx[w, k]]; an index
// below 0 or at or above N reads 0. The world stride of `planes` is a
// parameter: A * N for per-world planes, 0 for one table that every world
// reads (a heightfield's corner heights, the hull rows).
//
// Replaces fyrox_tpu/physics/pallas_ops.py:171 plane_gather (kernels
// _gather_kernel :107 / _gather_kernel2 :133), which the TPU ran as a
// one-hot matmul on the MXU because its gathers lower to scalar code. On
// Hopper a gather is a load: one thread per (w, k) output column loads its
// index once (coalesced across the warp) and walks the A attributes; the
// writes of a warp are contiguous in k for every attribute.
//
// Bound: memory. Each output element costs one 4-byte store plus one
// scattered 4-byte load, so the kernel moves ~8 bytes per output element
// plus 4 per index; the scattered reads hit L2 well because a world's
// planes (A*N*4 bytes, ~40 KB at the flagship's broadphase shapes) are
// small. Faster forms (staging a world's planes in shared memory, vector
// loads over attributes) are later work.
#include <cuda_runtime.h>

namespace {

__global__ void plane_gather_kernel(const float* __restrict__ planes,
                                    const int* __restrict__ idx,
                                    float* __restrict__ out,
                                    int A, int N, int K,
                                    long long world_stride) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int w = blockIdx.y;
  if (k >= K) return;
  const int i = __ldg(idx + (size_t)w * K + k);
  const bool ok = (i >= 0) && (i < N);
  const float* src = planes + (size_t)w * world_stride;
  float* dst = out + (size_t)w * A * K + k;
  for (int a = 0; a < A; ++a) {
    dst[(size_t)a * K] = ok ? __ldg(src + (size_t)a * N + i) : 0.0f;
  }
}

}  // namespace

extern "C" int fyrox_plane_gather(const void* planes, const void* idx,
                                  void* out, int W, int A, int N, int K,
                                  long long world_stride, void* stream) {
  const int threads = 256;
  dim3 grid((K + threads - 1) / threads, W);
  plane_gather_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)planes, (const int*)idx, (float*)out, A, N, K,
      world_stride);
  return (int)cudaGetLastError();
}
