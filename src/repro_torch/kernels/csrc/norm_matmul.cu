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
// Design, bf16 and f16, above wg::kMinRows rows where D % 8 == 0 (a dense
// prefill, a train step's 2048 rows, the rows of a long prompt): there
// the tensor cores bind, so the product is matmul's -- wg_gemm.cuh's
// wgmma + TMA mainloop -- on the normalised rows, and the norm is a pass
// of its own before it, as in the f32 route below.
// norm_matmul_rows_kernel gives each row a block of 4 warps: its inverse
// RMS in norm_matmul_inv_kernel's order, then the row as (x * inv) * g
// rounded to x's dtype, in NormA's multiply order, into an (M, D)
// workspace of x's dtype (16 MB at 2048 rows: it stays in L2).  The
// product (norm_matmul_wg) is the mainloop's programmatic dependent
// (wg::WaitA): it copies W's first stages before it waits for the rows
// kernel, and the rows only after.  So the rows are bit for bit what
// NormA feeds the fragments below, and 16-bit norm_matmul there is bit
// for bit matmul(rows, W) -- and, the mainloop's k16 step rounding as
// mma.sync's, the tiles' bits at every M.
//
// Design, bf16 and f16, up to wg::kMinRows rows (decode, a prefill
// chunk): two kernels, the second launched as a
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
// Reduction order, bf16 and f16: each row's sum of squares by one warp
// (lane l sums the squares of the row's 16-byte vectors l, l + 32, ... in
// ascending order, then a butterfly; a scalar lane-strided sum when D is
// no whole number of vectors), so inv depends on D alone; every product
// then in matmul's K order, fixed by D alone.  A row gives the same bits
// alone or in any batch.
//
// Design, f32: two kernels, the second launched as a programmatic
// dependent of the first.  norm_rows_f32_kernel gives each row a warp: its
// inverse RMS in row_sumsq's order (lane l sums the squares of elements l,
// l + 32, ... in ascending order, then a butterfly; fixed by D alone),
// then the normalised row (x * inv) * g, in that multiply order, written
// in f32 to an (M, D) workspace (64 KB at 4 rows, 2 MB at 128: it stays
// in L2).  The product is matmul's f32 launch (f32_gemm.cuh's
// f32_matmul) on that workspace and W, in the port's one f32 order, and
// reads the rows only after griddepcontrol.wait: f32 norm_matmul is bit
// for bit f32 matmul(normalised rows, W), and nothing of it grows with D.
#include "f32_gemm.cuh"
#include "wg_gemm.cuh"

namespace {

using namespace repro;

// -- f32: CUDA cores (f32_gemm.cuh) -------------------------------------------
// names the f32 product's kernels in a profile (f32_matmul)
struct norm_matmul_f32 {};

// Row m of the block's kWarps rows to XN: (x * inv) * g in f32, inv in
// row_sumsq's order.  The product that follows may launch at once
// (EARLY), or once every block has written its rows: where its blocks
// would otherwise wait on SMs the scheduler packed two to one
// (f32_gemm.cuh's f32_packs).
template <typename TG, bool EARLY>
__global__ void __launch_bounds__(kThreads)
    norm_rows_f32_kernel(const float* __restrict__ X,
                         const TG* __restrict__ G, float* __restrict__ XN,
                         int M, int D, float eps) {
  if constexpr (EARLY)
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (m < M) {   // the whole warp
    const float* row = X + (size_t)m * D;
    const float inv = 1.f / sqrtf(row_sumsq(row, D) / (float)D + eps);
    float* out = XN + (size_t)m * D;
    for (int d = lane; d < D; d += 32) out[d] = row[d] * inv * to_f32(G[d]);
  }
  if constexpr (!EARLY)
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <typename TG>
int launch_f32(const float* X, const TG* G, const float* W, float* C,
               float* XN, int M, int D, int N, float eps, cudaStream_t s) {
  int sms = 0;
  const cudaError_t e = f32_sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  bool packs = false;
  with_f32_matmul(M, D, N, [&](auto arrangement) {
    packs = f32_packs(arrangement, M, N, sms);
    return cudaSuccess;
  });
  const unsigned blocks = (M + kWarps - 1) / kWarps;
  if (packs)
    norm_rows_f32_kernel<TG, false><<<blocks, kThreads, 0, s>>>(X, G, XN, M,
                                                              D, eps);
  else
    norm_rows_f32_kernel<TG, true><<<blocks, kThreads, 0, s>>>(X, G, XN, M,
                                                             D, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)f32_matmul<norm_matmul_f32, true>(XN, W, C, M, D, N, s);
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

// vector ``v`` (8 elements of x from element 8 c) as (x * inv) * g
// rounded to T: NormA::norm2's order and rounding
template <typename T>
__device__ __forceinline__ uint4 norm8(uint4 v, const float (&g)[8],
                                       float inv) {
  const T* e = reinterpret_cast<const T*>(&v);
  uint4 o;
  unsigned* op = reinterpret_cast<unsigned*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    op[i] = pack2<T>(to_f32(e[2 * i]) * inv * g[2 * i],
                     to_f32(e[2 * i + 1]) * inv * g[2 * i + 1]);
  return o;
}

// g[8 c, 8 c + 8) in f32
template <typename TG>
__device__ __forceinline__ void load_g8(float (&g)[8],
                                        const TG* __restrict__ G, int c) {
  if constexpr (sizeof(TG) == 4) {
    const float4 g0 = __ldg(reinterpret_cast<const float4*>(G) + 2 * c);
    const float4 g1 = __ldg(reinterpret_cast<const float4*>(G) + 2 * c + 1);
    g[0] = g0.x, g[1] = g0.y, g[2] = g0.z, g[3] = g0.w;
    g[4] = g1.x, g[5] = g1.y, g[6] = g1.z, g[7] = g1.w;
  } else {
    const uint4 gv = __ldg(reinterpret_cast<const uint4*>(G) + c);
    const TG* ge = reinterpret_cast<const TG*>(&gv);
#pragma unroll
    for (int i = 0; i < 8; ++i) g[i] = to_f32(ge[i]);
  }
}

// The wgmma route's rows kernel: a block of kRowWarps warps a row (D %
// 8 == 0), the row to XN as (x * inv) * g rounded to T, with inv in
// norm_matmul_inv_kernel's order.  There lane l's chain runs over the
// row's vectors l + 32 u, u ascending, then a butterfly; here u =
// kRowGroup r + kRowVecs w + j is warp w's j-th vector of round r, so the
// chain passes from warp to warp through shared memory (a barrier each),
// the last warp takes the butterfly, and every warp then normalises the
// vectors it holds -- the loads of a round (x and g) all in flight at
// once across the row's warps, as rmsnorm.cu's block a row has them (a
// warp a row measured slower on an H100).  Rows past one round (D >
// 4096) read x again for the write.  The product launches as its
// programmatic dependent once every block has written its row (letting
// it launch on entry measured slower on an H100: its blocks take the SMs
// one by one as the rows end).
constexpr int kRowWarps = 4, kRowVecs = 4;
constexpr int kRowGroup = kRowWarps * kRowVecs;   // vectors a lane, a round

template <typename T, typename TG>
__global__ void __launch_bounds__(kRowWarps * 32)
    norm_matmul_rows_kernel(const T* __restrict__ X, const TG* __restrict__ G,
                            T* __restrict__ XN, int D, float eps) {
  __shared__ float chain[32];
  __shared__ float inv_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint4* row =
      reinterpret_cast<const uint4*>(X + (size_t)blockIdx.x * D);
  uint4* out = reinterpret_cast<uint4*>(XN + (size_t)blockIdx.x * D);
  const int nv = D / 8;
  const int rounds = (nv + 32 * kRowGroup - 1) / (32 * kRowGroup);
  uint4 x[kRowVecs];
  auto vec = [&](int r, int j) {   // this lane's j-th vector of round r
    return lane + 32 * (kRowGroup * r + kRowVecs * warp + j);
  };
  float ss = 0.f;
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int j = 0; j < kRowVecs; ++j)
      if (vec(r, j) < nv) x[j] = __ldg(row + vec(r, j));
    for (int w = 0; w < kRowWarps; ++w) {
      if (warp == w) {
        if (r + w > 0) ss = chain[lane];
#pragma unroll
        for (int j = 0; j < kRowVecs; ++j)
          if (vec(r, j) < nv) {
            const T* e = reinterpret_cast<const T*>(&x[j]);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float v = to_f32(e[i]);
              ss = fmaf(v, v, ss);
            }
          }
        chain[lane] = ss;
      }
      __syncthreads();
    }
  }
  if (warp == kRowWarps - 1) {   // norm_matmul_inv_kernel's butterfly
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) inv_s = 1.f / sqrtf(ss / (float)D + eps);
  }
  __syncthreads();
  const float inv = inv_s;
  for (int r = rounds - 1; r >= 0; --r) {   // the last round is in registers
#pragma unroll
    for (int j = 0; j < kRowVecs; ++j) {
      const int c = vec(r, j);
      if (c < nv) {
        float g[8];
        load_g8(g, G, c);
        out[c] = norm8<T>(r == rounds - 1 ? x[j] : __ldg(row + c), g, inv);
      }
    }
  }
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
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
  static PerDevice limit_set;
  const cudaError_t limit = once_per_device(limit_set, [kern] {
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  });
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

// names the wgmma route's product in a profile (wg_gemm.cuh)
struct norm_matmul_wg {};

// above wg::kMinRows rows where D % 8 == 0 the rows kernel, then the wgmma
// mainloop on the rows (``ws``: (M, D) of T); else the inverse RMS (``ws``:
// M floats), then matmul.cu's tiles (tc_gemm.cuh's with_matmul_tile);
// mirrored by kernels/ops.py:norm_matmul_plan
template <typename T, typename TG>
int launch_16bit(const T* X, const TG* G, const T* W, T* C, void* ws, int M,
                 int D, int N, float eps, cudaStream_t s) {
  if (M > wg::kMinRows && D % 8 == 0) {
    T* rows = static_cast<T*>(ws);
    norm_matmul_rows_kernel<T, TG>
        <<<M, kRowWarps * 32, 0, s>>>(X, G, rows, D, eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)wg::gemm_as<norm_matmul_wg, T, false, false, wg::WaitA>(
        wg::Operand{rows, true, D, (long long)M * D},
        wg::Operand{W, false, N, (long long)D * N}, C, 1, M, N, D, false, s);
  }
  float* inv = static_cast<float*>(ws);
  return tc::with_matmul_tile(M, N, [&](auto tile) {
    return launch_tc<T, TG, decltype(tile)>(X, G, W, C, inv, M, D, N, eps, s);
  });
}

}  // namespace

// ``ws`` is a workspace: the 16-bit tiles' M floats (the rows' inverse
// RMS), the 16-bit wgmma route's (M, D) of x's dtype and the f32 route's
// (M, D) floats (the normalised rows).
extern "C" int repro_norm_matmul(const void* x, const void* g, const void* w,
                                 void* c, void* ws, int M, int D, int N,
                                 float eps, int dtype, int g_dtype,
                                 void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* work = static_cast<float*>(ws);
  if (work == nullptr) return (int)cudaErrorInvalidValue;
  int rc = 0;
  REPRO_DISPATCH_DTYPE(g_dtype, TG, {
    const TG* G = static_cast<const TG*>(g);
    switch (dtype) {
      case kF32:
        rc = launch_f32<TG>(static_cast<const float*>(x), G,
                            static_cast<const float*>(w),
                            static_cast<float*>(c), work, M, D, N, eps, s);
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
