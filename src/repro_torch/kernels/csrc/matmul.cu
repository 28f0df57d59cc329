// Tiled matmul for Hopper: C (M, N) = A (M, K) @ B (K, N), f32
// accumulation, C in A's dtype (bf16, f16 or f32).
//
// Replaces: src/repro/kernels/matmul.py:_matmul_kernel (the Pallas TPU
// tiled matmul behind kernels/ops.py:matmul).
//
// Bound on the H100: at the serving shapes M is the decode slot count (4)
// or a prefill chunk (64) while B is a weight of 16-400 MB, so the kernel
// moves B's bytes once and does ~2*M flops per byte -- far below the
// ~295 flop/byte where the tensor cores would bind.  It is bound by
// device-memory bandwidth (3.35 TB/s).
//
// Design: one block owns a BM x (4*16/sizeof(T)) output tile and its
// whole K sweep.  Threads read B rows as 16-byte vectors (4 column
// groups x 64 k-lanes, so a warp reads 8 rows x 64 contiguous bytes),
// accumulate in f32 registers, and the k-lanes are summed in one fixed
// order (common.cuh) -- deterministic and independent of M.  Narrow
// column tiles give N=4096 128 blocks and the unembed (N=102400) 3200,
// enough to keep the SMs busy without splitting K.  The ragged M and N
// edges are masked.  No tensor cores yet (wgmma/TMA is later work).
#include "common.cuh"

namespace {

using namespace repro;

constexpr int CG = 4;

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  T* __restrict__ C, int M, int K, int N) {
  constexpr int BN = CG * kVec<T>;
  __shared__ float red[kWarps * BM * BN];
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int m_valid = min(BM, M - m0);
  float acc[BM][kVec<T>];
  gemm_partial<T, BM, CG>(A + (size_t)m0 * K, K, m_valid, B, N, K, n0, N,
                          acc);
  reduce_k_lanes<T, BM, CG>(acc, red);
  for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
    const int m = i / BN, n = n0 + i % BN;
    if (m < m_valid && n < N)
      C[(size_t)(m0 + m) * N + n] = from_f32<T>(red[i]);
  }
}

template <typename T, int BM>
void launch(const T* A, const T* B, T* C, int M, int K, int N,
            cudaStream_t s) {
  constexpr int BN = CG * kVec<T>;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_kernel<T, BM><<<grid, kThreads, 0, s>>>(A, B, C, M, K, N);
}

}  // namespace

extern "C" int repro_matmul(const void* a, const void* b, void* c, int M,
                            int K, int N, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_DTYPE(dtype, T, {
    const T* A = static_cast<const T*>(a);
    const T* B = static_cast<const T*>(b);
    T* C = static_cast<T*>(c);
    switch (pick_bm(M)) {
      case 1: launch<T, 1>(A, B, C, M, K, N, s); break;
      case 4: launch<T, 4>(A, B, C, M, K, N, s); break;
      default: launch<T, 16>(A, B, C, M, K, N, s); break;
    }
  });
  return (int)cudaGetLastError();
}
