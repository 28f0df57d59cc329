// Fused RMSNorm + matmul for Hopper: C = (rmsnorm(x, g, eps) rounded to
// x.dtype) @ W, f32 accumulation, C in x's dtype.  g may be f32 while x
// and W are bf16 (the final norm before the unembed).
//
// Replaces: src/repro/kernels/norm_matmul.py:_norm_matmul_kernel.
//
// Bound on the H100: W's bytes (16.8M or 419M bf16 elements per call on
// the serving path) against ~2*M flops per W byte -- device-memory
// bandwidth, like the plain matmul.
//
// Design: each block first computes its rows' inverse RMS in f32 (a warp
// per row, one fixed reduction order), writes the normalized rows,
// rounded to x.dtype exactly as the TPU kernel's ``.astype(x_ref.dtype)``
// does, into shared memory, and then runs the matmul's GEMM loop
// (common.cuh) against W with A read from shared memory.  Each block
// recomputes the norm of its few rows: x is 8-32 KB and stays in L2, so
// this costs L2 reads instead of a round trip of the normalized
// activation through device memory.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int CG = 4;

template <typename T, typename TG, int BM>
__global__ void __launch_bounds__(kThreads)
    norm_matmul_kernel(const T* __restrict__ X, const TG* __restrict__ G,
                       const T* __restrict__ W, T* __restrict__ C, int M,
                       int D, int N, float eps) {
  constexpr int BN = CG * kVec<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);   // [BM][D] normalized rows
  __shared__ float red[kWarps * BM * BN];
  __shared__ float inv[BM];
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int m_valid = min(BM, M - m0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int m = warp; m < BM; m += kWarps) {
    float ss = 0.f;
    if (m < m_valid) ss = row_sumsq(X + (size_t)(m0 + m) * D, D);
    if (lane == 0) inv[m] = 1.f / sqrtf(ss / (float)D + eps);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * D; i += kThreads) {
    const int m = i / D, d = i % D;
    float v = 0.f;
    if (m < m_valid)
      v = to_f32(X[(size_t)(m0 + m) * D + d]) * inv[m] * to_f32(G[d]);
    xs[i] = from_f32<T>(v);
  }
  __syncthreads();
  float acc[BM][kVec<T>];
  gemm_partial<T, BM, CG>(xs, D, m_valid, W, N, D, n0, N, acc);
  reduce_k_lanes<T, BM, CG>(acc, red);
  for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
    const int m = i / BN, n = n0 + i % BN;
    if (m < m_valid && n < N)
      C[(size_t)(m0 + m) * N + n] = from_f32<T>(red[i]);
  }
}

template <typename T, typename TG, int BM>
int launch(const T* X, const TG* G, const T* W, T* C, int M, int D, int N,
           float eps, cudaStream_t s) {
  constexpr int BN = CG * kVec<T>;
  const size_t smem = (size_t)BM * D * sizeof(T);
  auto kern = norm_matmul_kernel<T, TG, BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, kThreads, smem, s>>>(X, G, W, C, M, D, N, eps);
  return 0;
}

template <typename T, typename TG>
int launch_bm(const T* X, const TG* G, const T* W, T* C, int M, int D,
              int N, int bm, float eps, cudaStream_t s) {
  switch (bm) {
    case 1: return launch<T, TG, 1>(X, G, W, C, M, D, N, eps, s);
    case 4: return launch<T, TG, 4>(X, G, W, C, M, D, N, eps, s);
    case 16: return launch<T, TG, 16>(X, G, W, C, M, D, N, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// ``bm`` is the row-tile height the wrapper picked (1, 4 or 16) so that
// bm * D * sizeof(x) bytes of normalized rows fit in shared memory.
extern "C" int repro_norm_matmul(const void* x, const void* g, const void* w,
                                 void* c, int M, int D, int N, int bm,
                                 float eps, int dtype, int g_dtype,
                                 void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int rc = 0;
  REPRO_DISPATCH_DTYPE(dtype, T, {
    REPRO_DISPATCH_DTYPE(g_dtype, TG, {
      rc = launch_bm<T, TG>(static_cast<const T*>(x),
                            static_cast<const TG*>(g),
                            static_cast<const T*>(w), static_cast<T*>(c), M,
                            D, N, bm, eps, s);
    });
  });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
