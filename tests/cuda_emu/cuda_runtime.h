// A host emulation of the CUDA features fyrox_tpu_torch/csrc uses, so that
// the kernels compile as host C++ (g++ -std=c++20 -ffp-contract=off) and
// run on the CPU for tests/test_torch_kernels_emulated.py. One block at a
// time; its CUDA threads are fibers (ucontext) on the calling OS thread,
// each with its own stack, switched only at a barrier: __syncthreads and
// the warp-wide syncs of __syncwarp / __ballot_sync wait on a counting
// barrier, and a round-robin scheduler resumes every fiber whose barrier
// has been passed. Warp shuffles exchange values through a per-thread slot
// between two warp barriers. The __f*_rn intrinsics become plain float
// operations, which the flag -ffp-contract=off keeps unfused. The emulated
// card has kEmuSMs SMs that hold one resident block each (the occupancy
// queries' answers).
// Launches are rewritten by the test
// (`k<<<g, t, smem, stream>>>(args)` → `EMU_LAUNCH(g, t, smem, k, args)`),
// and `extern __shared__ T name[];` becomes a pointer into emu::smem.
#pragma once
#include <sys/mman.h>
#include <ucontext.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)

struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

namespace emu {
inline thread_local dim3 tIdx, bIdx;
inline dim3 bDim;
constexpr int kEmuSMs = 4;
constexpr size_t kStack = 256 * 1024;     // per CUDA thread, mapped lazily
inline std::vector<unsigned char> smem;
inline std::vector<unsigned> votes;
inline std::vector<unsigned long long> lanes;   // shuffle slots

struct Barrier;
struct Fiber {
  ucontext_t ctx;
  char* stack = nullptr;
  unsigned t = 0;
  bool done = false;
  const Barrier* wait = nullptr;   // the barrier it waits at, and its phase
  unsigned long phase = 0;
};
inline std::vector<Fiber> fibers;
inline Fiber* current = nullptr;
inline ucontext_t scheduler;
inline const std::function<void()>* body = nullptr;

// Counting barrier of `expected` fibers: the last to arrive opens the next
// phase and runs on; the others yield until the scheduler sees it opened.
struct Barrier {
  unsigned expected, count = 0;
  unsigned long phase = 0;
  explicit Barrier(unsigned n) : expected(n) {}
  void arrive_and_wait() {
    if (++count == expected) {
      count = 0;
      ++phase;
      return;
    }
    current->wait = this;
    current->phase = phase;
    swapcontext(&current->ctx, &scheduler);
  }
};
inline std::unique_ptr<Barrier> block_bar;
inline std::vector<std::unique_ptr<Barrier>> warp_bars;

inline void fiber_main() {
  (*body)();
  current->done = true;            // returns to `scheduler` (uc_link)
}

inline void launch(dim3 grid, dim3 threads, size_t smem_bytes,
                   const std::function<void()>& kernel) {
  bDim = threads;
  body = &kernel;
  while (fibers.size() < threads.x) {
    fibers.emplace_back();
    void* st = mmap(nullptr, kStack, PROT_READ | PROT_WRITE,
                    MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (st == MAP_FAILED) std::abort();
    fibers.back().stack = static_cast<char*>(st);
  }
  for (unsigned y = 0; y < grid.y; ++y)
    for (unsigned x = 0; x < grid.x; ++x) {
      smem.assign(smem_bytes, 0xAB);           // garbage, as on the card
      block_bar = std::make_unique<Barrier>(threads.x);
      warp_bars.clear();
      for (unsigned w = 0; w < (threads.x + 31) / 32; ++w)
        warp_bars.push_back(std::make_unique<Barrier>(32));
      votes.assign(threads.x, 0);
      lanes.assign(threads.x, 0);
      bIdx = dim3(x, y);
      for (unsigned t = 0; t < threads.x; ++t) {
        Fiber& f = fibers[t];
        f.t = t;
        f.done = false;
        f.wait = nullptr;
        getcontext(&f.ctx);
        f.ctx.uc_stack.ss_sp = f.stack;
        f.ctx.uc_stack.ss_size = kStack;
        f.ctx.uc_link = &scheduler;
        makecontext(&f.ctx, fiber_main, 0);
      }
      for (unsigned live = threads.x; live;) {
        bool moved = false;
        live = 0;
        for (unsigned t = 0; t < threads.x; ++t) {
          Fiber& f = fibers[t];
          if (f.done) continue;
          if (f.wait && f.wait->phase == f.phase) {
            ++live;
            continue;
          }
          f.wait = nullptr;
          current = &f;
          tIdx = dim3(t);
          swapcontext(&scheduler, &f.ctx);
          moved = true;
          live += !f.done;
        }
        if (live && !moved) {
          std::fprintf(stderr, "emu: every live thread waits at a barrier "
                               "that cannot open\n");
          std::abort();
        }
      }
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
inline int __any_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) != 0;
}
// integer atomics (the kernels use no float atomics)
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
// lanes of the calling warp whose `value` equals this lane's
inline unsigned __match_any_sync(unsigned, int value) {
  const unsigned w = threadIdx.x / 32;
  emu::votes[threadIdx.x] = (unsigned)value;
  __syncwarp();
  unsigned r = 0;
  for (unsigned i = 0; i < 32; ++i)
    if (emu::votes[w * 32 + i] == (unsigned)value) r |= 1u << i;
  __syncwarp();
  return r;
}
// the value `v` of lane `src` of the calling warp (every lane calls)
template <class T>
inline T emu_shfl(T v, unsigned src) {
  static_assert(sizeof(T) <= 8, "shuffles move at most 64 bits");
  const unsigned base = threadIdx.x & ~31u;
  unsigned long long bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  emu::lanes[threadIdx.x] = bits;
  __syncwarp();
  bits = emu::lanes[base + src];
  __syncwarp();
  T r;
  std::memcpy(&r, &bits, sizeof(T));
  return r;
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int mask) {   // width 32
  return emu_shfl(v, (threadIdx.x & 31u) ^ (unsigned)mask);
}
template <class T>
inline T __ldg(const T* p) { return *p; }
template <class T>
inline T __ldcg(const T* p) { return *p; }
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline unsigned __float_as_uint(float x) {
  unsigned u;
  std::memcpy(&u, &x, sizeof u);
  return u;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
using std::max;
using std::min;

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T>
inline cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = emu::kEmuSMs;
  return cudaSuccess;
}
template <class T>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T,
                                                                 int,
                                                                 size_t) {
  *n = 1;
  return cudaSuccess;
}
