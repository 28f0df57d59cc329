// Fused RMSNorm + matmul for Hopper: C = (rmsnorm(x, g, eps) rounded to
// x.dtype) @ W, f32 accumulation, C in x's dtype.  The norm is
// (x_f32 * inv) * g_f32 with inv = 1 / sqrt(mean(x^2) + eps) in f32, in
// that multiply order.  g may be f32 while x and W are bf16 (the final
// norm before the unembed).
//
// Replaces: src/repro/kernels/norm_matmul.py:_norm_matmul_kernel.
//
// Bound on the H100: W's bytes.  On the serving path W is a projection
// of 4096 x 4096 (32 MB in bf16: the pre-attention norm with each of wq,
// wk and wv) or the 4096 x 102400 unembed (839 MB), read once for 2 * M
// flops per W element; at M = 4 or 64 that is far below the ~295 flops a
// byte at which the tensor cores would bind, so device-memory bandwidth
// bounds it, exactly like the plain matmul.  x is 32-512 KB and stays in
// L2.
//
// Design, bf16 and f16: two kernels, the second launched as a
// programmatic dependent of the first.  norm_matmul_inv_kernel computes
// each row's inverse RMS once per call (M floats).  The GEMM is the
// tensor-core mainloop of tc_gemm.cuh with the norm as its A transform,
// in matmul.cu's blocks (same tiles, same ring of 256-deep cp.async
// stages, same L2 rule: W streams evict-first up to 256 MB, the unembed
// evict-normal with 128-column tiles).  It starts while the first kernel
// runs, puts its first W stages in flight, and waits for the first kernel
// (griddepcontrol.wait) only before it reads its rows' inv.  x then
// enters the products normalised on the way in: it arrives raw by
// cp.async (g's slice of the stage with it), and each warp rewrites the A
// fragments it reads with ldmatrix, in registers, as (x * inv[m]) * g[k]
// rounded to x's dtype.  Normalised rows are never kept whole, so M = 64
// takes matmul's 64-row tile (the old kernel kept BM full normalised rows
// in shared memory, which capped its tile at 16 rows).  Computing inv in
// each block's own prologue instead would re-read x from L2 once per
// column tile (at M = 64, 128 tiles x 512 KB), which measured slower at
// every M above 4.
//
// Reduction order: each row's sum of squares by one warp (lane l sums the
// squares of the row's 16-byte vectors l, l + 32, ... in ascending order,
// then a butterfly; a scalar lane-strided sum when D is no whole number
// of vectors), so inv depends on D alone; every product then in matmul's
// K order, fixed by D alone.  A row gives the same bits alone or in any
// batch.
//
// Design, f32: CUDA-core FMAs (no TF32: f32 means f32).  The block first
// normalises its 1, 4 or 16 rows into shared memory (inverse RMS by
// row_sumsq), then runs common.cuh's gemm_partial / reduce_k_lanes
// against W; the wrapper picks the row tile so the rows fit.
#include "tc_gemm.cuh"

namespace {

using namespace repro;

// -- f32: CUDA cores ---------------------------------------------------------
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

template <typename TG, int BM>
int launch_f32(const float* X, const TG* G, const float* W, float* C, int M,
               int D, int N, float eps, cudaStream_t s) {
  constexpr int BN = CG * kVec<float>;
  const size_t smem = (size_t)BM * D * sizeof(float);
  auto kern = norm_matmul_kernel<float, TG, BM>;
  // once per instantiation, at the card's opt-in limit less the static
  // arrays (the row tile's size depends on D): no runtime call on the
  // launch path, which a CUDA-graph capture may run
  static const cudaError_t limit = [kern] {
    cudaFuncAttributes fa;
    const cudaError_t e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxDynamicSmem - (int)fa.sharedSizeBytes);
  }();
  if (limit != cudaSuccess) return (int)limit;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, kThreads, smem, s>>>(X, G, W, C, M, D, N, eps);
  return 0;
}

template <typename TG>
int launch_f32_bm(const float* X, const TG* G, const float* W, float* C,
                  int M, int D, int N, int bm, float eps, cudaStream_t s) {
  switch (bm) {
    case 1: return launch_f32<TG, 1>(X, G, W, C, M, D, N, eps, s);
    case 4: return launch_f32<TG, 4>(X, G, W, C, M, D, N, eps, s);
    case 16: return launch_f32<TG, 16>(X, G, W, C, M, D, N, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// -- bf16, f16: the tensor-core mainloop with the norm as A transform --------
// Each row's inverse RMS, once per call, in the order of the header (16
// loads in flight per lane).  It lets the GEMM that follows launch at
// once (programmatic dependent launch): the GEMM streams its first W
// stages while this runs and waits for it only before it reads inv.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    norm_matmul_inv_kernel(const T* __restrict__ X, float* __restrict__ inv,
                           int M, int D, float eps) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  constexpr int U = 16;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (m >= M) return;
  const T* row = X + (size_t)m * D;
  float ss = 0.f;
  if (D % 8 == 0) {
    const int nv = D / 8;
    for (int c0 = lane; c0 < nv; c0 += 32 * U) {
      uint4 buf[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (c0 + u * 32 < nv)
          buf[u] = __ldg(reinterpret_cast<const uint4*>(row) + c0 + u * 32);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (c0 + u * 32 < nv) {
          const T* e = reinterpret_cast<const T*>(&buf[u]);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float v = to_f32(e[i]);
            ss = fmaf(v, v, ss);
          }
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
  } else {
    ss = row_sumsq(row, D);
  }
  if (lane == 0) inv[m] = 1.f / sqrtf(ss / (float)D + eps);
}

// The A transform of tc_gemm.cuh: row m of the block's tile times its
// inverse RMS, times g[k], rounded to T.  g's slice of each stage rides
// the ring too (``gs``: STAGES slots of kKS values), so the fragments
// read it from shared memory.
template <typename T, typename TG, int BM, int STAGES>
struct NormA {
  static constexpr bool kIdentity = false;
  const float* inv_all;   // (M,), from norm_matmul_inv_kernel
  const TG* g;            // (D,)
  float* inv;             // shared, [BM]: the block's rows; past M, 0
  TG* gs;                 // shared, [STAGES][kKS]
  int M, D, m0;

  // wait for norm_matmul_inv_kernel, then take the block's rows
  __device__ __forceinline__ void prepare() const {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    for (int m = threadIdx.x; m < BM; m += kThreads)
      inv[m] = m0 + m < M ? inv_all[m0 + m] : 0.f;
    __syncthreads();
  }

  __device__ __forceinline__ T operator()(T a, int m, int k) const {
    return from_f32<T>(to_f32(a) * inv[m] * to_f32(g[k]));
  }

  // g[s * kKS, (s + 1) * kKS) into its slot, with stage s's copies; past
  // D, zeros
  __device__ __forceinline__ void load(int s) const {
    constexpr int V = 16 / sizeof(TG), NC = tc::kKS / V;
    static_assert(NC <= kThreads, "");
    const int k = s * tc::kKS + threadIdx.x * V;
    if (threadIdx.x < NC)
      tc::cp_async16(gs + (s % STAGES) * tc::kKS + threadIdx.x * V,
                     k < D ? g + k : g, k < D);
  }

  // two adjacent elements (one 32-bit register) of row ``r`` times inv
  // and g, in that order, rounded to T
  __device__ __forceinline__ unsigned norm2(unsigned v, float r, float ga,
                                            float gb) const {
    const T* e = reinterpret_cast<const T*>(&v);
    return pack2<T>(to_f32(e[0]) * r * ga, to_f32(e[1]) * r * gb);
  }

  // the m16k16 A fragment of tile rows m.., stage columns k.. of stage s
  // (lane l holds rows m + l/4 and + 8, columns k + 2(l%4), +1, +8, +9)
  __device__ __forceinline__ void frag(unsigned (&a)[4], int m, int k,
                                       int s) const {
    const int lane = threadIdx.x & 31;
    const float r0 = inv[m + (lane >> 2)], r1 = inv[m + (lane >> 2) + 8];
    const TG* gp = gs + (s % STAGES) * tc::kKS + k + (lane & 3) * 2;
    const float g0 = to_f32(gp[0]), g1 = to_f32(gp[1]);
    const float g8 = to_f32(gp[8]), g9 = to_f32(gp[9]);
    a[0] = norm2(a[0], r0, g0, g1);
    a[1] = norm2(a[1], r1, g0, g1);
    a[2] = norm2(a[2], r0, g8, g9);
    a[3] = norm2(a[3], r1, g8, g9);
  }
};

template <typename T, typename TG, class TL>
__global__ void __launch_bounds__(kThreads)
    norm_matmul_tc_kernel(const T* __restrict__ X, const TG* __restrict__ G,
                          const T* __restrict__ W, T* __restrict__ C,
                          const float* __restrict__ inv_all, int M, int D,
                          int N, bool b_first) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float inv[TL::BM];
  const int n0 = blockIdx.x * TL::BN;
  const int m0 = blockIdx.y * TL::BM;
  TG* gs = reinterpret_cast<TG*>(smem + TL::SMEM);
  const NormA<T, TG, TL::BM, TL::STAGES> ax{inv_all, G, inv, gs, M, D, m0};
  const float* sum =
      tc::gemm_tc<T, TL>(X, D, W, M, D, N, m0, n0, b_first, smem, ax);
  // matmul.cu's epilogue: two adjacent columns per store
  for (int e = threadIdx.x; e < TL::BM * TL::BN / 2; e += kThreads) {
    const int m = e / (TL::BN / 2), n = (e % (TL::BN / 2)) * 2;
    if (m0 + m < M && n0 + n < N)
      *reinterpret_cast<unsigned*>(C + (size_t)(m0 + m) * N + n0 + n) =
          pack2<T>(sum[m * TL::RED_PITCH + n],
                   sum[m * TL::RED_PITCH + n + 1]);
  }
}

// dynamic shared memory: the GEMM's ring, then g's slots
template <typename TG, class TL>
constexpr int norm_smem() {
  return TL::SMEM + TL::STAGES * tc::kKS * (int)sizeof(TG);
}

template <typename T, typename TG, class TL>
int launch_tc(const T* X, const TG* G, const T* W, T* C, float* inv, int M,
              int D, int N, float eps, cudaStream_t s) {
  constexpr int smem = norm_smem<TG, TL>();
  auto kern = norm_matmul_tc_kernel<T, TG, TL>;
  static const cudaError_t limit = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (limit != cudaSuccess) return (int)limit;
  norm_matmul_inv_kernel<T><<<(M + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      X, inv, M, D, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_dependent(
      kern, dim3((N + TL::BN - 1) / TL::BN, (M + TL::BM - 1) / TL::BM),
      smem, s, X, G, W, C, static_cast<const float*>(inv), M, D, N,
      tc::b_evict_first((size_t)D * N * sizeof(T)));
}

// matmul.cu's tiles (tc_gemm.cuh's with_matmul_tile), mirrored by
// kernels/ops.py:norm_matmul_plan
template <typename T, typename TG>
int launch_16bit(const T* X, const TG* G, const T* W, T* C, float* inv,
                 int M, int D, int N, float eps, cudaStream_t s) {
  return tc::with_matmul_tile(M, N, [&](auto tile) {
    return launch_tc<T, TG, decltype(tile)>(X, G, W, C, inv, M, D, N, eps, s);
  });
}

}  // namespace

// ``bm`` is the f32 route's row tile (1, 4 or 16), picked by the wrapper
// so that bm normalized rows of D f32 values fit in shared memory; the
// 16-bit route picks its tile from M and N and ignores it.  ``inv`` is
// the 16-bit route's workspace of M floats (the rows' inverse RMS); the
// f32 route takes null.
extern "C" int repro_norm_matmul(const void* x, const void* g, const void* w,
                                 void* c, void* inv, int M, int D, int N,
                                 int bm, float eps, int dtype, int g_dtype,
                                 void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(inv);
  if (dtype != kF32 && ws == nullptr) return (int)cudaErrorInvalidValue;
  int rc = 0;
  REPRO_DISPATCH_DTYPE(g_dtype, TG, {
    const TG* G = static_cast<const TG*>(g);
    switch (dtype) {
      case kF32:
        rc = launch_f32_bm<TG>(static_cast<const float*>(x), G,
                               static_cast<const float*>(w),
                               static_cast<float*>(c), M, D, N, bm, eps, s);
        break;
      case kBF16:
        rc = launch_16bit<__nv_bfloat16, TG>(
            static_cast<const __nv_bfloat16*>(x), G,
            static_cast<const __nv_bfloat16*>(w),
            static_cast<__nv_bfloat16*>(c), ws, M, D, N, eps, s);
        break;
      case kF16:
        rc = launch_16bit<__half, TG>(static_cast<const __half*>(x), G,
                                      static_cast<const __half*>(w),
                                      static_cast<__half*>(c), ws, M, D, N,
                                      eps, s);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
