// Batched matmul with one fixed summation order for Hopper:
// C (batch, M, N) = A (batch, M, K) @ B (batch, K, N), f32 accumulation,
// C in f32 or in the operands' 16-bit type.  A and B are read through
// their strides, so A may come as (K, M) (the backward's transposed
// operands) and B as (N, K) (q.k^T over a (B, H, S, D) cache) with no
// copy.
//
// Replaces: no TPU kernel.  In the reference these products are XLA's
// lax.dot_general (src/repro/transformers/jax_backend.py); the emitter
// ran them as torch.einsum, which on the card is a cuBLAS GEMM whose
// algorithm -- split-K included -- follows the shape.  The paged
// attention compositions contract over a batch of B * Hkv rows, M = rep *
// chunk query rows and the padded cache width, so a request's scores and
// p.V took other bits at another slot count or prefill chunk, and in bf16
// a near-tied greedy token flipped.  This kernel repairs that: it is the
// one route of every floating contraction the emitted program runs
// outside the five ported kernels (ROADMAP Queue 3).
//
// The order, fixed by K alone.  No split of K across blocks that changes
// with the shape, no atomics, and nothing in the order depends on the
// batch count, M, N, the kernel or tile chosen, or an element's place
// (kernels/ops.py:batched_matmul_k_order):
//   - f32 (and mixed types, upcast by the wrapper): k in chunks of 256;
//     each chunk one fmaf chain in ascending k from +0, the chunk sums
//     added in chunk order to a total from +0.  Up to K 256 that is one
//     chain.  The f32 kernels and tiles differ only in which thread runs
//     which chain.
//   - bf16 / f16: tc_gemm.cuh's mainloop, whose K order is matmul's: warp
//     w sums k in [256 s + 32 w, 256 s + 32 w + 32) over the stages s in
//     order with mma.sync m16n8k16 into f32, then the 8 warp partials are
//     added in warp order.  A product of two 16-bit values is exact in
//     f32, so this keeps the f32 sums the reference asks for without f32
//     copies of the operands.
// Zeros past K (a padded cache width) add exact zeros to the same chains
// and chunks, so trailing zero padding gives the same bits.
//
// Bound on the H100.  At decode the products are batches of
// (1 x 128) @ (128 x Skv) and their p.V: a few flops per byte of the
// f32 cache they read, so device-memory bandwidth (3.35 TB/s) bounds
// them.  The training backward's transposed products and the MoE expert
// FFN do hundreds of flops per byte: f32 products there are bound by the
// CUDA cores' 67 TFLOP/s, 16-bit ones by the tensor cores.  A first,
// simple kernel: the f32 route is a register-blocked SGEMM whose tile
// follows M (2 x 128 for one query row up to 64 x 64), with k tiles in
// shared memory (and a block per output for a few outputs over a long K:
// those are latency- rather than rate-bound); the 16-bit route copies
// 16-byte
// vectors where the operand's layout allows (cp.async along the ring's
// rows, plain loads across them for a transposed operand) and single
// elements otherwise.  wgmma and TMA are later work.
#include "tc_gemm.cuh"

namespace {

using namespace repro;

// A element (b, m, k) at A[b * sab + m * sam + k * sak]; B element
// (b, k, n) at B[b * sbb + k * sbk + n * sbn].
struct Strides {
  long long sab, sam, sak, sbb, sbk, sbn;
};

constexpr int kBatchGrid = 65535;   // grid.y; a block walks the rest

// -- f32: the CUDA cores ---------------------------------------------------
// The f32 order: k in chunks of kChunk; each chunk is one fmaf chain in
// ascending k from +0, and the chunk sums are added in chunk order to a
// total that starts at +0.  Two kernels run it -- register tiles sized by
// M, and a block per output for few outputs over a long K (the chunks in
// parallel) -- so which one a shape takes changes no bit.
constexpr int kChunk = 256;
// outputs (all batches) up to which a K of at least kSplitMinK runs its
// chunks in parallel, one block per output
constexpr long long kSplitMaxOutputs = 8192;
constexpr int kSplitMinK = 8 * kChunk;

// A BM x BN output tile, TM x TN outputs a thread, 256 threads, k in
// shared-memory tiles of BK.  Every load of a k tile is issued before
// the barrier, so a tile costs one memory latency, not one per k.
template <int BM, int BN, int TM, int TN, int BK>
__global__ void __launch_bounds__(kThreads)
    bmm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   void* __restrict__ C, int batch, int M, int N, int K,
                   Strides st) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "256 threads");
  static_assert(kChunk % BK == 0, "a k tile lies in one chunk");
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  constexpr int TX = BN / TN;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int tiles_n = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  // which index runs along the threads of a load: the contiguous one
  const bool a_k_fast = st.sak == 1;
  const bool b_n_fast = st.sbn == 1;
  float* out = static_cast<float*>(C);
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const float* Ab = A + b * st.sab;
    const float* Bb = B + b * st.sbb;
    float acc[TM][TN], tot[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = tot[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int e = threadIdx.x; e < BM * BK; e += kThreads) {
        const int m = a_k_fast ? e / BK : e % BM;
        const int k = a_k_fast ? e % BK : e / BM;
        const bool ok = m0 + m < M && k0 + k < K;
        As[k][m] = ok ? Ab[(m0 + m) * st.sam + (k0 + k) * st.sak] : 0.f;
      }
#pragma unroll 4
      for (int e = threadIdx.x; e < BN * BK; e += kThreads) {
        const int n = b_n_fast ? e % BN : e / BK;
        const int k = b_n_fast ? e / BN : e % BK;
        const bool ok = n0 + n < N && k0 + k < K;
        Bs[k][n] = ok ? Bb[(k0 + k) * st.sbk + (n0 + n) * st.sbn] : 0.f;
      }
      __syncthreads();
      // one fmaf per output per k, in ascending k
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * (BM / TM)];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + j * TX];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
      if ((k0 + BK) % kChunk == 0 || k0 + BK >= K) {   // a chunk ends
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            tot[i][j] += acc[i][j];
            acc[i][j] = 0.f;
          }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + i * (BM / TM);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx + j * TX;
        if (m < M && n < N) out[((size_t)b * M + m) * N + n] = tot[i][j];
      }
    }
  }
}

// One chunk's chain, k in [c0, c1), from global memory.
__device__ __forceinline__ float chunk_chain(const float* a, long long sak,
                                             const float* b, long long sbk,
                                             int c0, int c1) {
  float acc = 0.f;
#pragma unroll 8
  for (int k = c0; k < c1; ++k)
    acc = fmaf(__ldg(a + k * sak), __ldg(b + k * sbk), acc);
  return acc;
}

// Few outputs over a long K (the sampler's pick of one logit out of the
// vocabulary: M = N = 1, K = 102400): one block per output, thread t runs
// chunks t, t + 256, ...; thread 0 adds the chunk sums in chunk order.
__global__ void __launch_bounds__(kThreads)
    bmm_f32_split_kernel(const float* __restrict__ A,
                         const float* __restrict__ B, void* __restrict__ C,
                         int batch, int M, int N, int K, Strides st) {
  __shared__ float part[kThreads];
  const int m = blockIdx.x / N, n = blockIdx.x % N;
  const int chunks = (K + kChunk - 1) / kChunk;
  float* out = static_cast<float*>(C);
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const float* a = A + b * st.sab + m * st.sam;
    const float* bb = B + b * st.sbb + n * st.sbn;
    float tot = 0.f;
    for (int g = 0; g < chunks; g += kThreads) {
      const int c = g + threadIdx.x;
      part[threadIdx.x] =
          c < chunks ? chunk_chain(a, st.sak, bb, st.sbk, c * kChunk,
                                   min(c * kChunk + kChunk, K))
                     : 0.f;
      __syncthreads();
      if (threadIdx.x == 0) {
        const int n_here = min(kThreads, chunks - g);
        for (int i = 0; i < n_here; ++i) tot += part[i];
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) out[((size_t)b * M + m) * N + n] = tot;
  }
}

unsigned batch_grid(long long rows) {
  return (unsigned)(rows < kBatchGrid ? rows : kBatchGrid);
}

template <int BM, int BN, int TM, int TN, int BK>
cudaError_t launch_f32_tile(const float* A, const float* B, void* C,
                            int batch, int M, int N, int K, const Strides& st,
                            cudaStream_t s) {
  const long long tiles =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)tiles, batch_grid(batch));
  bmm_f32_kernel<BM, BN, TM, TN, BK><<<grid, kThreads, 0, s>>>(
      A, B, C, batch, M, N, K, st);
  return cudaSuccess;
}

// the f32 kernels, mirrored by kernels/ops.py:batched_matmul_plan
cudaError_t launch_f32(const float* A, const float* B, void* C, int batch,
                       int M, int N, int K, const Strides& st,
                       cudaStream_t s) {
  const long long outs = (long long)batch * M * N;
  if (K >= kSplitMinK && outs <= kSplitMaxOutputs) {
    dim3 grid((unsigned)((long long)M * N), batch_grid(batch));
    bmm_f32_split_kernel<<<grid, kThreads, 0, s>>>(A, B, C, batch, M, N, K,
                                                   st);
    return cudaSuccess;
  }
  if (M == 1) return launch_f32_tile<2, 128, 1, 1, 64>(A, B, C, batch, M, N,
                                                       K, st, s);
  if (M <= 4)
    return launch_f32_tile<4, 64, 1, 1, 64>(A, B, C, batch, M, N, K, st, s);
  if (M <= 16)
    return launch_f32_tile<16, 64, 1, 4, 32>(A, B, C, batch, M, N, K, st, s);
  return launch_f32_tile<64, 64, 4, 4, 32>(A, B, C, batch, M, N, K, st, s);
}

// -- bf16 / f16: the tensor cores ---------------------------------------------
// How a stage of one operand is copied into the ring (mirrored by
// kernels/ops.py:batched_matmul_plan): 16-byte cp.async along the stage's
// rows (B's n, A's k) where that index is the contiguous one; for a
// transposed operand (B as (N, K), A as (K, M)) 8 x 8 blocks, loaded as
// 8 16-byte vectors along the contiguous index, transposed in registers
// and stored as 8 vectors along the rows; else element by element with
// the threads along whichever index is contiguous.  A
// vector copy needs its chunk of 8 aligned and wholly inside or wholly
// outside the matrix.
enum CopyMode { kElements = 0, kRows = 1, kColumns = 2 };

// rows[r] holds 8 16-bit values (r, 0..7); cols[c] gets (0..7, c)
__device__ __forceinline__ void transpose8x8(const uint4 (&rows)[8],
                                             uint4 (&cols)[8]) {
  const unsigned short* in = reinterpret_cast<const unsigned short*>(rows);
  unsigned short* out = reinterpret_cast<unsigned short*>(cols);
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int r = 0; r < 8; ++r) out[c * 8 + r] = in[r * 8 + c];
}

// tc_gemm.cuh's strided source: one batch's A and B through their strides.
template <typename T, class TL>
struct StridedSource {
  static constexpr bool kWaitA = false, kStrided = true;
  const T* A;
  const T* B;
  long long sam, sak, sbk, sbn;
  int M, N, K, m0, n0;
  int a_mode, b_mode;

  // the rows of a stage any warp reads: all, but for K under one stage
  // only the live warps' slices (tc_gemm.cuh's ``live``)
  __device__ __forceinline__ int rows_read() const {
    return K < tc::kKS ? (K + tc::kWarpK - 1) / tc::kWarpK * tc::kWarpK
                       : tc::kKS;
  }

  // B's stage: bs[k][n], k in [k0, k0 + KS), n in [n0, n0 + BN)
  __device__ __forceinline__ void load_b(T* bs, int k0) const {
    constexpr int BN = TL::BN, KS = tc::kKS;
    const T zero = from_f32<T>(0.f);
    const int kr = rows_read();
    if (b_mode == kRows) {
      constexpr int CB = BN / 8;
#pragma unroll
      for (int i = 0; i < KS * CB / kThreads; ++i) {
        const int e = threadIdx.x + i * kThreads;
        const int k = e / CB, c = e % CB;
        if (k >= kr) break;   // e grows with i
        const bool ok = k0 + k < K && n0 + c * 8 < N;
        tc::cp_async16(bs + tc::swz<BN>(k, c),
                       ok ? B + (k0 + k) * sbk + n0 + c * 8 : B, ok);
      }
    } else if (b_mode == kColumns) {
      // B (N, K): a thread loads an 8 (n) x 8 (k) block as 8 vectors of
      // k, transposes it in registers and stores 8 vectors of n
      constexpr int KB = KS / 8, BLOCKS = BN / 8 * KB;
#pragma unroll
      for (int i = 0; i < (BLOCKS + kThreads - 1) / kThreads; ++i) {
        const int e = threadIdx.x + i * kThreads;
        if (BLOCKS % kThreads && e >= BLOCKS) break;
        const int nc = e / KB, k = (e % KB) * 8;
        if (k >= kr) continue;
        uint4 rows[8], cols[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int n = n0 + nc * 8 + r;
          rows[r] = n < N && k0 + k < K
                        ? __ldg(reinterpret_cast<const uint4*>(
                              B + n * sbn + k0 + k))
                        : make_uint4(0, 0, 0, 0);
        }
        transpose8x8(rows, cols);
#pragma unroll
        for (int c = 0; c < 8; ++c)
          *reinterpret_cast<uint4*>(bs + tc::swz<BN>(k + c, nc)) = cols[c];
      }
    } else {
      const bool n_fast = sbn == 1;
      for (int e = threadIdx.x; e < KS * BN; e += kThreads) {
        const int n = n_fast ? e % BN : e / KS;
        const int k = n_fast ? e / BN : e % KS;
        if (k >= kr) continue;
        const bool ok = k0 + k < K && n0 + n < N;
        bs[tc::swz<BN>(k, n >> 3) + (n & 7)] =
            ok ? B[(k0 + k) * sbk + (n0 + n) * sbn] : zero;
      }
    }
  }

  // A's stage: as[m][k], m in [m0, m0 + BM), k in [k0, k0 + KS)
  __device__ __forceinline__ void load_a(T* as, int k0) const {
    constexpr int BM = TL::BM, KS = tc::kKS;
    const T zero = from_f32<T>(0.f);
    const int kr = rows_read();
    if (a_mode == kRows) {
      constexpr int CA = KS / 8;
#pragma unroll
      for (int i = 0; i < BM * CA / kThreads; ++i) {
        const int e = threadIdx.x + i * kThreads;
        const int m = e / CA, c = e % CA;
        if (c * 8 >= kr) continue;
        const bool ok = m0 + m < M && k0 + c * 8 < K;
        tc::cp_async16(as + tc::swz<KS>(m, c),
                       ok ? A + (m0 + m) * sam + k0 + c * 8 : A, ok);
      }
    } else if (a_mode == kColumns) {
      // A (K, M): a thread loads an 8 (k) x 8 (m) block as 8 vectors of
      // m, transposes it in registers and stores 8 vectors of k
      constexpr int MB = BM / 8, BLOCKS = MB * (KS / 8);
#pragma unroll
      for (int i = 0; i < (BLOCKS + kThreads - 1) / kThreads; ++i) {
        const int e = threadIdx.x + i * kThreads;
        if (BLOCKS % kThreads && e >= BLOCKS) break;
        const int mc = e % MB, kc = e / MB;
        if (kc * 8 >= kr) break;   // e grows with i
        uint4 rows[8], cols[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int k = k0 + kc * 8 + r;
          rows[r] = m0 + mc * 8 < M && k < K
                        ? __ldg(reinterpret_cast<const uint4*>(
                              A + k * sak + m0 + mc * 8))
                        : make_uint4(0, 0, 0, 0);
        }
        transpose8x8(rows, cols);
#pragma unroll
        for (int c = 0; c < 8; ++c)
          *reinterpret_cast<uint4*>(as + tc::swz<KS>(mc * 8 + c, kc)) =
              cols[c];
      }
    } else {
      const bool k_fast = sak == 1;
      for (int e = threadIdx.x; e < BM * KS; e += kThreads) {
        const int m = k_fast ? e / KS : e % BM;
        const int k = k_fast ? e % KS : e / BM;
        if (k >= kr) continue;
        const bool ok = m0 + m < M && k0 + k < K;
        as[tc::swz<KS>(m, k >> 3) + (k & 7)] =
            ok ? A[(m0 + m) * sam + (k0 + k) * sak] : zero;
      }
    }
  }

  __device__ __forceinline__ void load(T* slot, int s) const {
    load_b(slot, s * tc::kKS);
    load_a(slot + tc::kKS * TL::BN, s * tc::kKS);
  }
};

template <typename T, class TL>
__global__ void __launch_bounds__(kThreads)
    bmm_tc_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  void* __restrict__ C, int batch, int M, int N, int K,
                  Strides st, int a_mode, int b_mode, bool out_f32) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BN = TL::BN;
  const int tiles_n = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * TL::BM;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const StridedSource<T, TL> src{A + b * st.sab, B + b * st.sbb, st.sam,
                                   st.sak, st.sbk, st.sbn, M, N, K, m0, n0,
                                   a_mode, b_mode};
    const float* sum = tc::gemm_tc<T, TL, tc::IdentityA, StridedSource<T, TL>>(
        src.A, 0, src.B, M, K, N, m0, n0, false, smem, tc::IdentityA(),
        nullptr, src);
    for (int e = threadIdx.x; e < TL::BM * BN; e += kThreads) {
      const int m = e / BN, n = e % BN;
      if (m0 + m < M && n0 + n < N) {
        const float v = sum[m * TL::RED_PITCH + n];
        const size_t o = ((size_t)b * M + m0 + m) * N + n0 + n;
        if (out_f32)
          static_cast<float*>(C)[o] = v;
        else
          static_cast<T*>(C)[o] = from_f32<T>(v);
      }
    }
    __syncthreads();   // the next batch's ring reuses the sums' memory
  }
}

template <typename T, class TL>
cudaError_t launch_tc(const T* A, const T* B, void* C, int batch, int M,
                      int N, int K, const Strides& st, int a_mode,
                      int b_mode, bool out_f32, cudaStream_t s) {
  static PerDevice limit_set;
  const cudaError_t limit = once_per_device(limit_set, [] {
    return cudaFuncSetAttribute(bmm_tc_kernel<T, TL>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                TL::SMEM);
  });
  if (limit != cudaSuccess) return limit;
  const long long tiles =
      (long long)((M + TL::BM - 1) / TL::BM) * ((N + TL::BN - 1) / TL::BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)tiles, batch_grid(batch));
  bmm_tc_kernel<T, TL><<<grid, kThreads, TL::SMEM, s>>>(
      A, B, C, batch, M, N, K, st, a_mode, b_mode, out_f32);
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The copy mode of an operand whose index ``row`` (B's n, A's k) runs
// along the ring's rows, ``col`` along its columns, with strides
// ``s_row``, ``s_col`` and ``s_batch`` and extents ``n_row``, ``n_col``.
int copy_mode(const void* p, long long s_row, long long s_col,
              long long s_batch, int n_row, int n_col) {
  if (!aligned16(p) || s_batch % 8) return kElements;
  if (s_row == 1 && s_col % 8 == 0 && n_row % 8 == 0) return kRows;
  if (s_col == 1 && s_row % 8 == 0 && n_col % 8 == 0) return kColumns;
  return kElements;
}

template <typename T>
cudaError_t launch_16bit(const void* a, const void* b, void* c, int batch,
                         int M, int N, int K, const Strides& st, bool out_f32,
                         cudaStream_t s) {
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  const int a_mode = copy_mode(A, st.sak, st.sam, st.sab, K, M);
  const int b_mode = copy_mode(B, st.sbn, st.sbk, st.sbb, N, K);
  return tc::with_matmul_tile(M, N, [&](auto tile) {
    return launch_tc<T, decltype(tile)>(A, B, c, batch, M, N, K, st, a_mode,
                                        b_mode, out_f32, s);
  });
}

}  // namespace

// dtype: both operands' type (kF32 for the CUDA-core route); out_f32:
// C is f32, else C is in the operands' type.  Strides in elements.
extern "C" int repro_batched_matmul(const void* a, const void* b, void* c,
                                    int batch, int M, int N, int K,
                                    long long sab, long long sam,
                                    long long sak, long long sbb,
                                    long long sbk, long long sbn, int dtype,
                                    int out_f32, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Strides st{sab, sam, sak, sbb, sbk, sbn};
  cudaError_t err = cudaErrorInvalidValue;
  if (batch < 1 || M < 1 || N < 1 || K < 1) return (int)err;
  switch (dtype) {
    case kF32:
      if (out_f32)
        err = launch_f32(static_cast<const float*>(a),
                         static_cast<const float*>(b), c, batch, M, N, K, st,
                         s);
      break;
    case kBF16:
      err = launch_16bit<__nv_bfloat16>(a, b, c, batch, M, N, K, st,
                                        out_f32 != 0, s);
      break;
    case kF16:
      err = launch_16bit<__half>(a, b, c, batch, M, N, K, st, out_f32 != 0,
                                 s);
      break;
    default:
      break;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
