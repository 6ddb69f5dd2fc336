// K4a: per-world gather by index; an index below 0 or at or above N reads
// 0, and the world stride of the table is a parameter (0: one table that
// every world reads, a heightfield's corner heights or the hull rows).
// Indices are int32 or int64 (the argsort order and the walk positions of
// the slab broadphase are int64: no cast before the call). Two kernels:
//   plane_gather_kernel  attribute-major out[w, a, k] = T[w](a, idx[w, k]),
//                        T planes [A, N] a world, or a row-major [N, A]
//                        table (gather_rows with a planar output);
//   gather_rows_kernel   row-major out[w, k, :] = rows[w, idx[w, k], :],
//                        rows [N, D] a world (gather_rows).
//
// Replaces fyrox_tpu/physics/pallas_ops.py:171 plane_gather (kernels
// _gather_kernel :107 / _gather_kernel2 :133) and, through it, gather_rows
// :248, which the TPU ran as a one-hot matmul on the MXU over attribute-
// major planes, transposing row-major tables into planes around it. On
// Hopper a gather is a load: a row-major table is read as it is, in one
// launch with no transpose copy. The output layout is the caller's
// choice: attribute-major where the consumers go on by attribute slices
// (the solvers and the slab broadphase; on row-major outputs those slices
// are strided and their elementwise passes slowed the dense tick by ~5 %),
// row-major where they take whole rows (the hull rows).
//
// Bound: bytes (the table and the indices read once, the output written
// once). What the design does about it:
// - every output store is 16 bytes (one float4) where the output's
//   alignment allows, else four floats of one warp-contiguous run: the
//   plane form's thread takes 4 consecutive k and writes them for every
//   attribute, reading its 4 indices once; the row form's thread takes
//   4 consecutive floats of a world's flat [K*D] output;
// - the row form reads 16 bytes at a time where D % 4 == 0 (the hull rows:
//   a 512-byte row is 32 float4); a row-major table read by the plane form
//   keeps each gathered row in L1 while its attributes are walked;
// - tables are read through the read-only path (__ldg). Staging a world's
//   table in shared memory was measured slower at every caller's shapes on
//   the H100 (kernel_ab.py): the tables that fit are small enough for L1 to
//   serve their reuse, and the staged copy cut the resident CTAs;
// - the launch computes its grid from the shapes alone: one quad of
//   columns a thread (plane form), ~4 quads a thread (row form).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowFloats = 4 * 4 * kThreads;   // row form: floats a CTA

template <typename I>
__device__ __forceinline__ int row_of(const I* __restrict__ idx, int k, int n) {
  const I i = __ldg(idx + k);
  return (i >= 0 && i < (I)n) ? (int)i : -1;
}

// Plane form. CTA (x, w) writes columns [4*kThreads*x, +4*kThreads) of world
// w's A output rows, 4 consecutive k a thread: its 4 indices are read once
// and their values written for every attribute, one float4 a row where
// K % 4 == 0 (VEC). The table's element (a, row r) is at a*sa + r*sr:
// planes [A, N] (sa = N, sr = 1) or a row-major [N, A] table (sa = 1,
// sr = A).
template <typename I, bool VEC>
__global__ void __launch_bounds__(kThreads) plane_gather_kernel(
    const float* __restrict__ table, const I* __restrict__ idx,
    float* __restrict__ out, int A, int N, int K, long long world_stride,
    int sa, int sr) {
  const int w = blockIdx.y;
  const int k = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (k >= K) return;
  const float* tab = table + (size_t)w * world_stride;
  const I* iw = idx + (size_t)w * K;
  int r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r[j] = k + j < K ? row_of(iw, k + j, N) : -1;
    r[j] = r[j] >= 0 ? r[j] * sr : -1;
  }
  float* dst = out + (size_t)w * A * K + k;
#pragma unroll 4
  for (int a = 0; a < A; ++a, dst += K) {
    const float* pa = tab + a * sa;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = r[j] >= 0 ? __ldg(pa + r[j]) : 0.f;
    if (VEC) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k + j < K) dst[j] = v[j];
    }
  }
}

// Row form. CTA (x, w) writes rows [x*rows_per_cta, +rows_per_cta) of world
// w's output as a flat stream of floats. VEC (D % 4 == 0, 16-byte aligned
// rows): each quad lies in one row and is one float4 load and store.
// Otherwise quads are aligned on the output's address, their four values
// read one by one (a quad may span rows), and the few floats before the
// first and after the last whole quad are written one a thread.
template <typename I, bool VEC>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const float* __restrict__ rows, const I* __restrict__ idx,
    float* __restrict__ out, int N, int D, int K, long long world_stride,
    int rows_per_cta) {
  const int w = blockIdx.y;
  const float* tab = rows + (size_t)w * world_stride;
  const I* iw = idx + (size_t)w * K;
  const int k0 = blockIdx.x * rows_per_cta;
  const int e0 = k0 * D, e1 = min(K, k0 + rows_per_cta) * D;
  float* ow = out + (size_t)w * K * D;
  if (VEC) {
    // 4 quads a thread a round, their loads issued together
    for (int base = e0 + 4 * threadIdx.x; base < e1; base += kRowFloats) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = base + q * 4 * kThreads;
        if (e >= e1) break;
        const int k = e / D, i = row_of(iw, k, N);
        const float4 v =
            i >= 0 ? __ldg(reinterpret_cast<const float4*>(tab + i * D +
                                                           (e - k * D)))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(ow + e) = v;
      }
    }
    return;
  }
  const int lead = min(e1 - e0, (int)((0u - (unsigned)(
      (uintptr_t)(ow + e0) >> 2)) & 3u));
  const int body = e0 + lead + ((e1 - e0 - lead) & ~3);
  for (int e = e0 + lead + 4 * threadIdx.x; e < body; e += 4 * kThreads) {
    int k = e / D, c = e - k * D, i = row_of(iw, k, N);
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = i >= 0 ? __ldg(tab + i * D + c) : 0.f;
      if (++c == D && j < 3) {
        c = 0;
        i = row_of(iw, ++k, N);
      }
    }
    *reinterpret_cast<float4*>(ow + e) = make_float4(v[0], v[1], v[2], v[3]);
  }
  const int t = threadIdx.x;
  if (t < lead + (e1 - body)) {
    const int e = t < lead ? e0 + t : body + (t - lead);
    const int k = e / D, i = row_of(iw, k, N);
    ow[e] = i >= 0 ? __ldg(tab + i * D + (e - k * D)) : 0.f;
  }
}

template <typename I>
int launch_planes(const float* table, const I* idx, float* out, int W, int A,
                  int N, int K, long long world_stride, bool rows_major,
                  cudaStream_t stream) {
  const dim3 grid((K + 4 * kThreads - 1) / (4 * kThreads), W);
  const int sa = rows_major ? 1 : N, sr = rows_major ? A : 1;
  auto kern = K % 4 == 0 && (uintptr_t)out % 16 == 0
                  ? plane_gather_kernel<I, true>
                  : plane_gather_kernel<I, false>;
  kern<<<grid, kThreads, 0, stream>>>(table, idx, out, A, N, K, world_stride,
                                      sa, sr);
  return (int)cudaGetLastError();
}

template <typename I>
int launch_rows(const float* rows, const I* idx, float* out, int W, int N,
                int D, int K, long long world_stride, cudaStream_t stream) {
  const int per_cta = D < kRowFloats ? kRowFloats / D : 1;
  const dim3 grid((K + per_cta - 1) / per_cta, W);
  auto kern = D % 4 == 0 && world_stride % 4 == 0 &&
                      (uintptr_t)rows % 16 == 0 && (uintptr_t)out % 16 == 0
                  ? gather_rows_kernel<I, true>
                  : gather_rows_kernel<I, false>;
  kern<<<grid, kThreads, 0, stream>>>(rows, idx, out, N, D, K, world_stride,
                                      per_cta);
  return (int)cudaGetLastError();
}

}  // namespace

// idx64: the indices are int64 (else int32). rows_major: the table is a
// row-major [W|1, N, A] (gather_rows with an attribute-major output), else
// planes [W|1, A, N].
extern "C" int fyrox_plane_gather(const void* table, const void* idx,
                                  void* out, int W, int A, int N, int K,
                                  long long world_stride, int rows_major,
                                  int idx64, void* stream) {
  if (idx64)
    return launch_planes((const float*)table, (const long long*)idx,
                         (float*)out, W, A, N, K, world_stride, rows_major,
                         (cudaStream_t)stream);
  return launch_planes((const float*)table, (const int*)idx, (float*)out, W,
                       A, N, K, world_stride, rows_major,
                       (cudaStream_t)stream);
}

extern "C" int fyrox_gather_rows(const void* rows, const void* idx, void* out,
                                 int W, int N, int D, int K,
                                 long long world_stride, int idx64,
                                 void* stream) {
  if (idx64)
    return launch_rows((const float*)rows, (const long long*)idx, (float*)out,
                       W, N, D, K, world_stride, (cudaStream_t)stream);
  return launch_rows((const float*)rows, (const int*)idx, (float*)out, W, N, D,
                     K, world_stride, (cudaStream_t)stream);
}
