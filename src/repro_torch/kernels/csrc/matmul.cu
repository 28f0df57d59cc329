// Tiled matmul for Hopper: C (M, N) = A (M, K) @ B (K, N), f32
// accumulation, C in A's dtype (bf16, f16 or f32).
//
// Replaces: src/repro/kernels/matmul.py:_matmul_kernel (the Pallas TPU
// tiled matmul behind kernels/ops.py:matmul).
//
// Bound on the H100.  At decode (M = 4), a prefill chunk (M = 64) and the
// unembed of a prefill's last row (M = 1, N = 102400) B is a weight of
// 32-840 MB read once for at most 64 flops per byte, far below the ~295
// where the tensor cores would bind: device-memory bandwidth (3.35 TB/s)
// bounds these cases, and the kernel has to keep enough of B in flight
// on every SM to hide DRAM latency.  The dense prefill (M = 512) does
// 17 GFLOP for 40 MB: there the tensor-core rate (989 TFLOP/s) bounds it.
//
// Design, bf16 and f16: the tensor-core mainloop of tc_gemm.cuh.  A block
// owns a tile of 16 rows (M <= 16), 64 rows (M <= 64) or 64 x 64 (more
// rows), 32 columns wide, or 128 at decode when N >= 8192, and its whole K
// sweep: N = 4096 gives 128 blocks at decode, the unembed 800, so no split
// of K is needed to fill 132 SMs.  B and A stream through a ring of three
// or four 256-deep cp.async stages (48-128 KB of B in flight per block
// while one stage is multiplied); each warp multiplies its fixed 32-wide k
// slice of a stage with mma.sync m16n8k16 into f32 registers.  Each output
// is thus reduced in one order fixed by K alone -- per warp ascending k and
// stage, then the 8 warp partials in warp order -- so a row of A gives
// bitwise the same output at any M and any position in its batch; padding
// rows are zeros in shared memory and are never stored.  Every tile uses
// the same instruction shape and the same k slices: decode and prefill rows
// go through the same arithmetic.  B's copies carry an evict-first L2
// policy when B is at most 256 MB: a weight read once then evicts itself
// rather than the activations, or dirty lines whose write-back would share
// the memory bus with the stream.  A B many times L2's 50 MB (the unembed)
// streams with the evict-normal policy, where evict-first measured slower.
//
// Design, f32: CUDA-core FMAs (no TF32: f32 means f32).  A
// block owns a BM x 16 output tile; threads read B rows as 16-byte vectors
// (4 column groups x 64 k-lanes) and the k-lanes are summed in one fixed
// order (common.cuh gemm_partial / reduce_k_lanes).
#include "tc_gemm.cuh"

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

template <int BM>
cudaError_t launch_f32(const float* A, const float* B, float* C, int M,
                       int K, int N, cudaStream_t s) {
  constexpr int BN = CG * kVec<float>;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_kernel<float, BM><<<grid, kThreads, 0, s>>>(A, B, C, M, K, N);
  return cudaSuccess;
}

template <typename T, class TL>
__global__ void __launch_bounds__(kThreads)
    matmul_tc_kernel(const T* __restrict__ A, const T* __restrict__ B,
                     T* __restrict__ C, int M, int K, int N, bool b_first) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BN = TL::BN;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * TL::BM;
  const float* sum =
      tc::gemm_tc<T, TL>(A, K, B, M, K, N, m0, n0, b_first, smem);
  // two adjacent columns per store (N % 8 == 0: both in or both out)
  for (int e = threadIdx.x; e < TL::BM * BN / 2; e += kThreads) {
    const int m = e / (BN / 2), n = (e % (BN / 2)) * 2;
    if (m0 + m < M && n0 + n < N) {
      const float* p = sum + m * TL::RED_PITCH + n;
      __align__(4) T pair[2] = {from_f32<T>(p[0]), from_f32<T>(p[1])};
      *reinterpret_cast<unsigned*>(C + (size_t)(m0 + m) * N + n0 + n) =
          *reinterpret_cast<const unsigned*>(pair);
    }
  }
}

template <typename T, class TL>
cudaError_t launch_tc(const T* A, const T* B, T* C, int M, int K, int N,
                      cudaStream_t s) {
  // raise the instantiation's dynamic shared memory limit once per device
  static PerDevice limit_set;
  const cudaError_t limit = once_per_device(limit_set, [] {
    return cudaFuncSetAttribute(
        matmul_tc_kernel<T, TL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TL::SMEM);
  });
  if (limit != cudaSuccess) return limit;
  const bool b_first = tc::b_evict_first((size_t)K * N * sizeof(T));
  dim3 grid((N + TL::BN - 1) / TL::BN, (M + TL::BM - 1) / TL::BM);
  matmul_tc_kernel<T, TL><<<grid, kThreads, TL::SMEM, s>>>(A, B, C, M, K, N,
                                                           b_first);
  return cudaSuccess;
}

// the tensor-core tiles of tc_gemm.cuh's with_matmul_tile (ops.py:tc_tile)
template <typename T>
cudaError_t launch_16bit(const void* a, const void* b, void* c, int M, int K,
                         int N, cudaStream_t s) {
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  T* C = static_cast<T*>(c);
  return tc::with_matmul_tile(M, N, [&](auto tile) {
    return launch_tc<T, decltype(tile)>(A, B, C, M, K, N, s);
  });
}

}  // namespace

extern "C" int repro_matmul(const void* a, const void* b, void* c, int M,
                            int K, int N, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: {
      const float* A = static_cast<const float*>(a);
      const float* B = static_cast<const float*>(b);
      float* C = static_cast<float*>(c);
      switch (pick_bm(M)) {
        case 1: err = launch_f32<1>(A, B, C, M, K, N, s); break;
        case 4: err = launch_f32<4>(A, B, C, M, K, N, s); break;
        default: err = launch_f32<16>(A, B, C, M, K, N, s); break;
      }
    } break;
    case kBF16: err = launch_16bit<__nv_bfloat16>(a, b, c, M, K, N, s); break;
    case kF16: err = launch_16bit<__half>(a, b, c, M, K, N, s); break;
    default: break;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
