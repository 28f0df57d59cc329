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
// Design, bf16 and f16, above wg::kMinRows rows (a dense prefill, a train
// step's 2048 rows, mixtral's 4,224-token prefill): wg_gemm.cuh's wgmma
// mainloop -- 128 x 128 tiles, A and B by the TMA unit into a ring of
// 64-deep stages, two consumer warpgroups, persistent blocks -- in the
// same K order, so its bits are those of the tiles below at every M.
//
// Design, bf16 and f16, up to wg::kMinRows rows (and where A's rows are not
// whole 16-byte vectors): the tensor-core mainloop of tc_gemm.cuh.  A block
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
// Design, f32: CUDA-core FMAs (no TF32: f32 means f32) in the port's one
// f32 order, f32_gemm.cuh's: k in chunks of 256, each chunk in sub-chains
// of 32, each sub-chain one fmaf chain in ascending k from +0, a chunk's
// sub-chain sums added in order from +0, the chunk sums in chunk order
// from +0 -- the batched kernel's order, so f32 matmul(a, b) is bitwise
// batched_matmul(a[None], b[None])[0] at every shape.  One launch a call
// (f32_gemm.cuh's f32_matmul, which swiglu's f32 down product and
// norm_matmul's f32 product launch too), one of three arrangements by
// shape (with_f32_matmul, mirrored by kernels/ops.py:matmul_plan):
//   - a cluster of 8 blocks per output (f32_mm_split_kernel), for at most
//     64 outputs over K >= 2048 (a router at decode: 4 x 8 outputs over
//     6144): the chunks run in parallel and block 0 adds their sums in
//     order through distributed shared memory;
//   - chunk lanes (f32_mm_lanes_kernel) for at most 4 rows (decode, the
//     unembed of one row): 16 chunks in flight a block (32 past 16
//     chunks: a router's long K), B streamed from device memory as
//     16-byte vectors straight into registers, 32 columns a block (128
//     blocks at N = 4096, 3200 at the unembed), so the bytes of B bound
//     it as they bound the 16-bit route;
//   - register tiles through a cp.async ring with A k-major
//     (f32_mm_kernel): 32 x 32 (4 x 4 outputs a thread, 8 groups of
//     threads on different chunks of the tile) up to 32 rows, 32 x 64 (4
//     x 8, 4 groups) beyond, so that a prefill's rows fill the card (128
//     blocks at 32 rows and N = 4096), and 32 x 8 for N <= 8 (a router's
//     experts at prefill).  At 128 rows and more the CUDA cores' 67
//     TFLOP/s bound it.
#include "f32_gemm.cuh"
#include "wg_gemm.cuh"

namespace {

using namespace repro;

// names matmul's f32 kernels in a profile (f32_gemm.cuh's f32_matmul)
struct matmul_f32 {};
// names matmul's wgmma mainloop in a profile (wg_gemm.cuh)
struct matmul_wg {};

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

// above wg::kMinRows rows (where A's rows are 16-byte vectors for the
// TMA unit, K % 8 == 0) the wgmma mainloop, else the tensor-core tiles of
// tc_gemm.cuh's with_matmul_tile (ops.py:matmul_plan, tc_tile)
template <typename T>
cudaError_t launch_16bit(const void* a, const void* b, void* c, int M, int K,
                         int N, cudaStream_t s) {
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  T* C = static_cast<T*>(c);
  if (M > wg::kMinRows && K % 8 == 0)
    return wg::gemm_as<matmul_wg, T, false, false>(
        wg::Operand{A, true, K, (long long)M * K},
        wg::Operand{B, false, N, (long long)K * N}, C, 1, M, N, K, false, s);
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
    case kF32:
      err = f32_matmul<matmul_f32, false>(static_cast<const float*>(a),
                                          static_cast<const float*>(b),
                                          static_cast<float*>(c), M, K, N, s);
      break;
    case kBF16: err = launch_16bit<__nv_bfloat16>(a, b, c, M, K, N, s); break;
    case kF16: err = launch_16bit<__half>(a, b, c, M, K, N, s); break;
    default: break;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
