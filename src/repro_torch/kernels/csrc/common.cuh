// Shared pieces of the port's Hopper kernels (built for sm_90a by
// repro_torch/kernels/_build.py and called through ctypes).
//
// Every kernel here is deterministic: each output element is reduced in
// one fixed order that depends only on the contraction length, never on
// the row count M, the row's position in the batch or the run.  That is
// what keeps the serving contracts exact on the card (paged == each
// request alone, chunked prefill == dense prefill, prefix sharing on ==
// off): no atomics, no split-K whose order changes between launches.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes, mirrored by _build.DTYPE_CODES
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int kThreads = 256;                 // every kernel: 8 warps
constexpr int kWarps = kThreads / 32;
// dynamic shared memory a block may opt into on sm_90 (227 KB; mirrored
// by ops._SMEM)
constexpr int kMaxDynamicSmem = 232448;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
// round to nearest even, as torch's .to(bfloat16) / .to(float16)
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// the value ``v`` takes after a round trip through T (the reference's
// ``.astype(x.dtype)`` between fused stages)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// two values rounded to T and packed in one 32-bit register, the first in
// the low half (one cvt.rn.*x2 instruction)
template <typename T>
__device__ __forceinline__ unsigned pack2(float a, float b);
template <>
__device__ __forceinline__ unsigned pack2<__nv_bfloat16>(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&v);
}
template <>
__device__ __forceinline__ unsigned pack2<__half>(float a, float b) {
  const __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&v);
}

// one 16-byte load holds kVec<T> elements
template <typename T> constexpr int kVec = 16 / sizeof(T);

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec<T>; ++i) out[i] = to_f32(e[i]);
}

// Partial products of a row tile of A (BM rows, lda, first ``m_valid``
// rows real) against the CG*kVec<T> columns of B starting at ``n0``.
// Thread t owns column group t % CG (kVec<T> adjacent columns, one
// 16-byte load per B row) and k-lane t / CG: it accumulates, in f32 and
// in ascending k, the products of every k with k % (kThreads / CG) equal
// to its k-lane.  Columns at or past N (N % kVec<T> == 0) stay zero.
template <typename T, int BM, int CG>
__device__ __forceinline__ void gemm_partial(
    const T* A, int lda, int m_valid, const T* __restrict__ B, int ldb,
    int K, int n0, int N, float (&acc)[BM][kVec<T>]) {
  constexpr int V = kVec<T>;
  constexpr int KL = kThreads / CG;
  const int cg = threadIdx.x % CG;
  const int kl = threadIdx.x / CG;
  const int col = n0 + cg * V;
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[m][v] = 0.f;
  if (col >= N) return;
#pragma unroll 4
  for (int k = kl; k < K; k += KL) {
    float b[V];
    load_vec(B + (size_t)k * ldb + col, b);
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      if (m < m_valid) {
        const float a = to_f32(A[(size_t)m * lda + k]);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[m][v] = fmaf(a, b[v], acc[m][v]);
      }
    }
  }
}

// Sum the k-lane partials of gemm_partial in one fixed order: a
// butterfly over the k-lanes inside each warp, then warps 0..7 in turn.
// The totals land in red[0][m][c] (c = column within the tile).
// ``red`` is shared memory of kWarps * BM * CG * kVec<T> floats.
template <typename T, int BM, int CG>
__device__ __forceinline__ void reduce_k_lanes(
    float (&acc)[BM][kVec<T>], float* red) {
  constexpr int V = kVec<T>;
  constexpr int BN = CG * V;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float s = acc[m][v];
#pragma unroll
      for (int off = CG; off < 32; off <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      acc[m][v] = s;
    }
  if (lane < CG) {
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int v = 0; v < V; ++v)
        red[(warp * BM + m) * BN + lane * V + v] = acc[m][v];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * BM * BN + i];
    red[i] = s;  // each i is owned by one thread: no race with warp 0's row
  }
  __syncthreads();
}

// sum of squares of one row, lane-strided then a butterfly over the warp
template <typename T>
__device__ __forceinline__ float row_sumsq(const T* x, int d) {
  const int lane = threadIdx.x & 31;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(x[i]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  return ss;
}

// row-tile heights the GEMM kernels are instantiated for
inline int pick_bm(int m) { return m <= 1 ? 1 : (m <= 4 ? 4 : 16); }

// Launch ``kern`` (kThreads a block) as the programmatic dependent of the
// kernel before it on ``s``: it may start once every block of that kernel
// has run griddepcontrol.launch_dependents (or ended), and must run
// griddepcontrol.wait before it reads what that kernel writes.
template <typename... P, typename... A>
cudaError_t launch_dependent(void (*kern)(P...), dim3 grid, int smem,
                             cudaStream_t s, A... args) {
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

}  // namespace repro

#define REPRO_DISPATCH_DTYPE(code, T, ...)       \
  switch (code) {                                \
    case repro::kF32: {                          \
      using T = float;                           \
      __VA_ARGS__;                               \
    } break;                                     \
    case repro::kBF16: {                         \
      using T = __nv_bfloat16;                   \
      __VA_ARGS__;                               \
    } break;                                     \
    case repro::kF16: {                          \
      using T = __half;                          \
      __VA_ARGS__;                               \
    } break;                                     \
    default:                                     \
      return (int)cudaErrorInvalidValue;         \
  }
