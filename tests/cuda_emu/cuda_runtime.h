// A host emulation of the CUDA features fyrox_tpu_torch/csrc uses, so that
// the kernels compile as host C++ (g++ -std=c++20 -ffp-contract=off) and
// run on the CPU for tests/test_torch_kernels_emulated.py. One std::thread
// per CUDA thread, one block at a time; std::barrier stands in for
// __syncthreads and for the warp-wide syncs of __syncwarp / __ballot_sync.
// The __f*_rn intrinsics become plain float operations, which the flag
// -ffp-contract=off keeps unfused. Launches are rewritten by the test
// (`k<<<g, t, smem, stream>>>(args)` → `EMU_LAUNCH(g, t, smem, k, args)`),
// and `extern __shared__ T name[];` becomes a pointer into emu::smem.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

namespace emu {
inline thread_local dim3 tIdx, bIdx;
inline dim3 bDim;
inline std::unique_ptr<std::barrier<>> block_bar;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
inline std::vector<unsigned> votes;
inline std::vector<unsigned char> smem;

inline void launch(dim3 grid, dim3 threads, size_t smem_bytes,
                   const std::function<void()>& kernel) {
  bDim = threads;
  for (unsigned y = 0; y < grid.y; ++y)
    for (unsigned x = 0; x < grid.x; ++x) {
      smem.assign(smem_bytes, 0xAB);           // garbage, as on the card
      block_bar = std::make_unique<std::barrier<>>(threads.x);
      warp_bars.clear();
      for (unsigned w = 0; w < (threads.x + 31) / 32; ++w)
        warp_bars.push_back(std::make_unique<std::barrier<>>(32));
      votes.assign(threads.x, 0);
      std::vector<std::thread> pool;
      for (unsigned t = 0; t < threads.x; ++t)
        pool.emplace_back([=, &kernel] {
          tIdx = dim3(t);
          bIdx = dim3(x, y);
          kernel();
        });
      for (auto& th : pool) th.join();
    }
}
}  // namespace emu

#define threadIdx emu::tIdx
#define blockIdx emu::bIdx
#define blockDim emu::bDim
#define EMU_LAUNCH(g, t, s, k, ...) \
  emu::launch(dim3(g), dim3(t), s, [&] { k(__VA_ARGS__); })

inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu::warp_bars[threadIdx.x / 32]->arrive_and_wait();
}
inline unsigned __ballot_sync(unsigned, bool pred) {
  const unsigned w = threadIdx.x / 32;
  emu::votes[threadIdx.x] = pred;
  __syncwarp();
  unsigned r = 0;
  for (unsigned i = 0; i < 32; ++i)
    if (emu::votes[w * 32 + i]) r |= 1u << i;
  __syncwarp();
  return r;
}
template <class T>
inline T __ldg(const T* p) { return *p; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
using std::max;
using std::min;

typedef int cudaError_t;
enum { cudaSuccess = 0 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T>
inline cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
