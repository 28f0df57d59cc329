// Fused SwiGLU MLP for Hopper:
//   out (M, Do) = (silu(x @ wg) * (x @ wu)) @ wd
// with the reference's roundings: each of x@wg and x@wu accumulated in
// f32 and rounded to x.dtype; silu as jax.nn.silu computes it under
// XLA, g * (1 / (1 + exp(-g))) with each op rounded to x.dtype; the product
// with u rounded; and the down projection accumulated in f32; out in
// x's dtype.
//
// Replaces: src/repro/kernels/swiglu.py:_swiglu_kernel.
//
// Bound on the H100.  At decode (M = 4) and in a prefill chunk (M = 64)
// the three weights (3 * 4096 * 11008 bf16 = 270 MB per layer at
// deepseek-7b's width) are read once for at most 64 flops per byte:
// device-memory bandwidth.  The dense prefill (M = 512) does 139 GFLOP
// for 279 MB, about 500 flops per byte: there the tensor-core rate
// bounds it.
//
// Design, bf16 and f16, above wg::kMinRows rows where D % 8 == 0 (a dense
// prefill, a train step's 2048 rows): the tensor cores bind, so both
// launches are wg_gemm.cuh's wgmma + TMA mainloop.  The gate/up launch
// (swiglu_gate_up_wg) reads x and a paired B: each stage's two 64-column
// boxes come from wg's and wu's tensor maps at the same F columns, so a
// 128-wide tile is 64 F columns of each, and the thread holding g at n8
// block j holds u at block j + 8 -- h forms in registers (GateUp: the
// same silu_mul as below) and leaves through one TMA box a consumer.  It
// lets the down launch start at once.  The down launch (swiglu_down_wg)
// is the mainloop on (h, wd) as its programmatic dependent (wg::WaitA:
// wd's first stages copied, then griddepcontrol.wait, then h).  g and u
// are each reduced in matmul's order for K = D, the down product in its
// order for K = F, the mainloop's k16 step rounding as mma.sync's: every
// bit is the tiles'.
//
// Design, bf16 and f16, up to wg::kMinRows rows (decode, a prefill chunk):
// two kernels, the second launched as a
// programmatic dependent of the first.
//   swiglu_gate_up_kernel is the tensor-core mainloop of tc_gemm.cuh on
//   A = x with a paired B: a block's BN-wide B tile holds BN/2 columns of
//   wg and the same BN/2 columns of wu, so each A fragment read feeds both
//   products.  In the epilogue the block's f32 sums sit in shared memory,
//   g at column j and u at column j + BN/2; each thread forms h with the
//   rounding chain above and writes it in x's dtype to an (M, F)
//   workspace -- 88 KB at decode, 11 MB at M = 512, so it stays in the
//   50 MB L2 for the next launch.  Tiles: 16 rows (M <= 16) by 64 F
//   columns of each weight with a ring of 3 stages (172 blocks at F =
//   11008, 128 KB of B in flight per block, 256-byte rows: on the H100
//   faster than 344 blocks of 32 columns with 96 KB in flight), else
//   64 rows by 32 F columns with 3 stages.  The grid walks
//   the row tiles fastest, so the blocks of one F tile run together and
//   read its wg and wu columns from device memory once (at M = 512 the
//   other order re-reads all 180 MB for each of the 8 row tiles, and is
//   slower on the H100).
//   swiglu_down_kernel is matmul.cu's tensor-core GEMM (same tiles, same
//   L2 rule) on A = h, B = wd, K = F.  It starts while the first kernel's
//   last blocks run, puts its first wd stages in flight, and copies h
//   only after griddepcontrol.wait, once h is complete.
// So each weight is read once (the TPU kernel re-reads wg and wu once per
// Do tile), the (M, F) activation makes one trip through L2, and nothing
// is reduced across blocks.
//
// Design, f32: CUDA-core FMAs (no TF32: f32 means f32) in the port's one
// f32 order (f32_gemm.cuh: chunks of 256 k, each in sub-chains of 32),
// split the same way.  swiglu_gate_up_f32_kernel pairs BN/2 columns of wg
// with the same BN/2 of wu in its B tile, so each A value it reads feeds
// both products; at most 4 rows it runs f32_gemm.cuh's chunk lanes over
// 16 + 16 paired columns (swiglu_gate_up_f32_lanes_kernel: the bytes of
// wg and wu bind), from 5 rows on matmul's register tiles, 32 x 32 (16 +
// 16 columns, 8 groups of threads on different chunks) up to 32 rows, 32
// x 64 (32 + 32, 4 groups) beyond, rows fastest in the grid.  The sums
// of g and u meet in shared memory and the epilogue writes h in f32 to
// the (M, F) workspace.  The down product is matmul's f32 launch
// (f32_gemm.cuh's f32_matmul) on h and wd as the programmatic dependent
// of the first kernel, reading h only after griddepcontrol.wait: f32
// swiglu's output is bit for bit f32 matmul(h, wd).
//
// Reduction order: tensor cores: g and u each in matmul's order for K =
// D, the down product in matmul's order for K = F (tc_gemm.cuh's warp
// slices); f32: g and u each in the f32 order for K = D, the down product
// in the f32 order for K = F.  Neither depends on M, the row's position
// or the run: no split of K across blocks, no atomics.
#include "f32_gemm.cuh"
#include "wg_gemm.cuh"

namespace {

using namespace repro;

// h = round(silu(g) * u) from the f32 sums of g and u, rounded op by op as
// XLA computes jax.nn.silu (expf and an IEEE division, as the reference);
// every route's h comes from here
template <typename T>
__device__ __forceinline__ float silu_mul(float g_sum, float u_sum) {
  const float g = round_to<T>(g_sum);
  const float u = round_to<T>(u_sum);
  const float e = round_to<T>(expf(-g));
  const float sig = round_to<T>(1.f / round_to<T>(1.f + e));
  const float sg = round_to<T>(g * sig);
  return sg * u;   // the caller rounds
}

// -- f32: CUDA cores (f32_gemm.cuh) -------------------------------------------
// names the f32 down product's kernels in a profile (f32_matmul)
struct swiglu_down_f32 {};

// Register tiles: a BM x BN tile of [g | u], BN/2 F columns of each, rows
// fastest in the grid.  g and u meet in shared memory (the ring, free on
// return), where each thread forms h for its share of the tile.  Both
// f32 gate/up kernels let the down product launch only once they have
// written h (as norm_matmul.cu's row kernel does, and for its reason).
template <class LT>
__global__ void __launch_bounds__(LT::THREADS)
    swiglu_gate_up_f32_kernel(const float* __restrict__ X,
                              const float* __restrict__ WG,
                              const float* __restrict__ WU,
                              float* __restrict__ H, int M, int D, int F,
                              bool a_vec, bool b_vec) {
  using TL = typename LT::Tile;
  constexpr int BN = TL::BN, BF = BN / 2;
  extern __shared__ __align__(16) float fsm[];
  const int m0 = blockIdx.x * TL::BM;
  const int f0 = blockIdx.y * BF;
  f32_lane_tile<LT, false>(
      fsm, D,
      [&](float* as, int k0, int t) {
        f32_load_kmajor<TL::BM, TL::BK, TL::THREADS>(as, X, D, m0, M, k0, D,
                                                     a_vec, t);
      },
      [&](float* bs, int k0, int t) {
        f32_load<BF, TL::BP, TL::BK, TL::THREADS, false>(
            bs, WG, F, 1, f0, F, k0, D, b_vec, t);
        f32_load<BF, TL::BP, TL::BK, TL::THREADS, false>(
            bs + BF, WU, F, 1, f0, F, k0, D, b_vec, t);
      },
      [&](int m, int n, float v) { fsm[m * BN + n] = v; });
  __syncthreads();
  for (int e = threadIdx.x; e < TL::BM * BF; e += LT::THREADS) {
    const int m = e / BF, j = e % BF;
    if (m0 + m < M && f0 + j < F)
      H[(size_t)(m0 + m) * F + f0 + j] =
          silu_mul<float>(fsm[m * BN + j], fsm[m * BN + BF + j]);
  }
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Chunk lanes: BM rows against 16 F columns of wg beside the same 16 of wu
template <int BM, int LANES>
__global__ void __launch_bounds__(LANES * kLaneGroups)
    swiglu_gate_up_f32_lanes_kernel(const float* __restrict__ X,
                                    const float* __restrict__ WG,
                                    const float* __restrict__ WU,
                                    float* __restrict__ H, int M, int D,
                                    int F, bool a_vec) {
  constexpr int BF = kLaneCols / 2;
  const int m0 = blockIdx.x * BM;
  const int f0 = blockIdx.y * BF;
  f32_lanes<BM, LANES>(
      X, D, M, D, m0, a_vec,
      [&](int c) -> const float* {
        const int f = f0 + (c < BF ? c : c - BF);
        return f < F ? (c < BF ? WG : WU) + f : nullptr;
      },
      F, [&](const float* sums) {
        for (int e = threadIdx.x; e < BM * BF; e += LANES * kLaneGroups) {
          const int m = e / BF, j = e % BF;
          if (m0 + m < M && f0 + j < F)
            H[(size_t)(m0 + m) * F + f0 + j] = silu_mul<float>(
                sums[m * kLaneCols + j], sums[m * kLaneCols + BF + j]);
        }
      });
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <int BM, int LANES>
cudaError_t launch_gate_up_f32(F32Lanes<BM, LANES>, const float* X,
                               const float* WG, const float* WU, float* H,
                               int M, int D, int F, cudaStream_t s) {
  const dim3 grid((M + BM - 1) / BM, (F + kLaneCols / 2 - 1) / (kLaneCols / 2));
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  swiglu_gate_up_f32_lanes_kernel<BM, LANES>
      <<<grid, LANES * kLaneGroups, 0, s>>>(X, WG, WU, H, M, D, F,
                                            aligned16(X) && D % 4 == 0);
  return cudaGetLastError();
}

template <class LT>
cudaError_t launch_gate_up_f32(F32Tiles<LT>, const float* X, const float* WG,
                               const float* WU, float* H, int M, int D, int F,
                               cudaStream_t s) {
  using TL = typename LT::Tile;
  constexpr int BF = TL::BN / 2;
  static PerDevice limit_set;
  const cudaError_t limit =
      f32_smem_limit(limit_set, swiglu_gate_up_f32_kernel<LT>, LT::SMEM);
  if (limit != cudaSuccess) return limit;
  const dim3 grid((M + TL::BM - 1) / TL::BM, (F + BF - 1) / BF);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  swiglu_gate_up_f32_kernel<LT><<<grid, LT::THREADS, LT::SMEM, s>>>(
      X, WG, WU, H, M, D, F, aligned16(X) && D % 4 == 0,
      aligned16(WG) && aligned16(WU) && F % 4 == 0);
  return cudaGetLastError();
}

// the gate/up arrangement, mirrored by kernels/ops.py:swiglu_plan:
// with_f32_matmul's chunk lanes and register tiles (no cluster per output,
// no narrow tile: a paired tile holds at least 16 F columns)
template <class Fn>
cudaError_t with_f32_gate_up(int M, int D, Fn&& f) {
  if (M <= kLaneMaxRows) {
    const bool many = D > kLanesFew * kChunk;
    if (M <= 1)
      return many ? f(F32Lanes<1, kLanesMany>()) : f(F32Lanes<1, kLanesFew>());
    if (M <= 2)
      return many ? f(F32Lanes<2, kLanesMany>()) : f(F32Lanes<2, kLanesFew>());
    return many ? f(F32Lanes<4, kLanesMany>()) : f(F32Lanes<4, kLanesFew>());
  }
  if (M <= 32) return f(F32Tiles<F32L32x32>());
  return f(F32Tiles<F32L32x64>());
}

cudaError_t launch_f32(const float* X, const float* WG, const float* WU,
                       const float* WD, float* H, float* C, int M, int D,
                       int F, int Do, cudaStream_t s) {
  const cudaError_t err = with_f32_gate_up(M, D, [&](auto arrangement) {
    return launch_gate_up_f32(arrangement, X, WG, WU, H, M, D, F, s);
  });
  if (err != cudaSuccess) return err;
  return f32_matmul<swiglu_down_f32, true>(H, WD, C, M, F, Do, s);
}

// -- bf16, f16: tensor cores ---------------------------------------------------
template <typename T, class TL>
__global__ void __launch_bounds__(kThreads)
    swiglu_gate_up_kernel(const T* __restrict__ X, const T* __restrict__ WG,
                          const T* __restrict__ WU, T* __restrict__ H, int M,
                          int D, int F, bool b_first) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BF = TL::BN / 2;
  const int m0 = blockIdx.x * TL::BM;   // row tiles fastest (see the header)
  const int f0 = blockIdx.y * BF;
  const float* sum = tc::gemm_tc<T, TL, tc::IdentityA, tc::PairB>(
      X, D, WG, M, D, F, m0, f0, b_first, smem, tc::IdentityA(), WU);
  // g at column j, u at column BF + j; two adjacent columns per store
  // (F % 8 == 0: both in or both out)
  for (int e = threadIdx.x; e < TL::BM * BF / 2; e += kThreads) {
    const int m = e / (BF / 2), j = (e % (BF / 2)) * 2;
    if (m0 + m < M && f0 + j < F) {
      const float* p = sum + m * TL::RED_PITCH + j;
      *reinterpret_cast<unsigned*>(H + (size_t)(m0 + m) * F + f0 + j) =
          pack2<T>(silu_mul<T>(p[0], p[BF]), silu_mul<T>(p[1], p[BF + 1]));
    }
  }
}

template <typename T, class TL>
__global__ void __launch_bounds__(kThreads)
    swiglu_down_kernel(const T* __restrict__ H, const T* __restrict__ WD,
                       T* __restrict__ C, int M, int F, int Do,
                       bool b_first) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * TL::BN;
  const int m0 = blockIdx.y * TL::BM;
  const float* sum = tc::gemm_tc<T, TL, tc::IdentityA, tc::WaitA>(
      H, F, WD, M, F, Do, m0, n0, b_first, smem);
  // matmul.cu's epilogue: two adjacent columns per store
  for (int e = threadIdx.x; e < TL::BM * TL::BN / 2; e += kThreads) {
    const int m = e / (TL::BN / 2), n = (e % (TL::BN / 2)) * 2;
    if (m0 + m < M && n0 + n < Do)
      *reinterpret_cast<unsigned*>(C + (size_t)(m0 + m) * Do + n0 + n) =
          pack2<T>(sum[m * TL::RED_PITCH + n],
                   sum[m * TL::RED_PITCH + n + 1]);
  }
}

template <typename T, class TL>
cudaError_t launch_gate_up(const T* X, const T* WG, const T* WU, T* H, int M,
                           int D, int F, cudaStream_t s) {
  // raise the instantiation's dynamic shared memory limit once per device
  static PerDevice limit_set;
  const cudaError_t limit = once_per_device(limit_set, [] {
    return cudaFuncSetAttribute(
        swiglu_gate_up_kernel<T, TL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
  });
  if (limit != cudaSuccess) return limit;
  constexpr int BF = TL::BN / 2;
  dim3 grid((M + TL::BM - 1) / TL::BM, (F + BF - 1) / BF);
  swiglu_gate_up_kernel<T, TL><<<grid, kThreads, TL::SMEM, s>>>(
      X, WG, WU, H, M, D, F,
      tc::b_evict_first((size_t)2 * D * F * sizeof(T)));   // wg + wu
  return cudaGetLastError();
}

template <typename T, class TL>
cudaError_t launch_down(const T* H, const T* WD, T* C, int M, int F, int Do,
                        cudaStream_t s) {
  static PerDevice limit_set;
  const cudaError_t limit = once_per_device(limit_set, [] {
    return cudaFuncSetAttribute(
        swiglu_down_kernel<T, TL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TL::SMEM);
  });
  if (limit != cudaSuccess) return limit;
  dim3 grid((Do + TL::BN - 1) / TL::BN, (M + TL::BM - 1) / TL::BM);
  return launch_dependent(swiglu_down_kernel<T, TL>, grid, TL::SMEM, s, H,
                          WD, C, M, F, Do,
                          tc::b_evict_first((size_t)F * Do * sizeof(T)));
}

// names the wgmma route's launches in a profile (wg_gemm.cuh)
struct swiglu_gate_up_wg {};
struct swiglu_down_wg {};

// the wgmma gate/up's paired B and its epilogue: h from g and u
struct GateUp {
  static constexpr bool kWaitA = false, kPairB = true;
  template <typename T>
  static __device__ __forceinline__ float pair(float g, float u) {
    return silu_mul<T>(g, u);
  }
};

// above wg::kMinRows rows where D % 8 == 0 the wgmma mainloop for both
// launches, else the tensor-core tiles; mirrored by
// kernels/ops.py:swiglu_plan
template <typename T>
cudaError_t launch_16bit(const void* x, const void* w_gate,
                         const void* w_up, const void* w_down, void* h,
                         void* c, int M, int D, int F, int Do,
                         cudaStream_t s) {
  const T* X = static_cast<const T*>(x);
  const T* WG = static_cast<const T*>(w_gate);
  const T* WU = static_cast<const T*>(w_up);
  const T* WD = static_cast<const T*>(w_down);
  T* H = static_cast<T*>(h);
  T* C = static_cast<T*>(c);
  if (M > wg::kMinRows && D % 8 == 0) {
    const wg::Operand wu_op{WU, false, F, (long long)D * F};
    const cudaError_t err = wg::gemm_as<swiglu_gate_up_wg, T, false, false,
                                        GateUp>(
        wg::Operand{X, true, D, (long long)M * D},
        wg::Operand{WG, false, F, (long long)D * F}, H, 1, M, F, D, false, s,
        &wu_op);
    if (err != cudaSuccess) return err;
    return wg::gemm_as<swiglu_down_wg, T, false, false, wg::WaitA>(
        wg::Operand{H, true, F, (long long)M * F},
        wg::Operand{WD, false, Do, (long long)F * Do}, C, 1, M, Do, F, false,
        s);
  }
  // the gate/up tiles, mirrored by kernels/ops.py:swiglu_tile: BN/2 F
  // columns of each of wg and wu
  auto gate_up = [&](auto tile) {
    return launch_gate_up<T, decltype(tile)>(X, WG, WU, H, M, D, F, s);
  };
  const cudaError_t err = M <= 16 ? gate_up(tc::Tile<16, 128, 3>())
                                  : gate_up(tc::Tile<64, 64, 3>());
  if (err != cudaSuccess) return err;
  return tc::with_matmul_tile(M, Do, [&](auto tile) {
    return launch_down<T, decltype(tile)>(H, WD, C, M, F, Do, s);
  });
}

}  // namespace

// ``h`` is the (M, F) workspace of the hidden activation, in x's dtype.
extern "C" int repro_swiglu(const void* x, const void* wg, const void* wu,
                            const void* wd, void* h, void* out, int M, int D,
                            int F, int Do, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      err = launch_f32(static_cast<const float*>(x),
                       static_cast<const float*>(wg),
                       static_cast<const float*>(wu),
                       static_cast<const float*>(wd), static_cast<float*>(h),
                       static_cast<float*>(out), M, D, F, Do, s);
      break;
    case kBF16:
      err = launch_16bit<__nv_bfloat16>(x, wg, wu, wd, h, out, M, D, F, Do,
                                        s);
      break;
    case kF16:
      err = launch_16bit<__half>(x, wg, wu, wd, h, out, M, D, F, Do, s);
      break;
    default: break;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
