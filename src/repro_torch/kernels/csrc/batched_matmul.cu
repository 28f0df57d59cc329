// Batched matmul with one fixed summation order for Hopper:
// C (batch, M, N) = A (batch, M, K) @ B (batch, K, N), f32 accumulation,
// C in f32 or in the operands' 16-bit type.  A and B are read through
// their strides, so A may come as (K, M) (the backward's transposed
// operands, the paged write's one-hot mask) and B as (N, K) (q.k^T over a
// (B, H, S, D) cache) with no copy.
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
// outside the five ported kernels.
//
// The order, fixed by K alone.  No split of K across blocks that changes
// with the shape, no atomics, and nothing in the order depends on the
// batch count, M, N, the kernel or tile chosen, or an element's place
// (kernels/ops.py:batched_matmul_k_order):
//   - f32 (and mixed types, upcast by the wrapper): f32_gemm.cuh's
//     order: k in chunks of 256, each chunk in sub-chains of 32; each
//     sub-chain one fmaf chain in ascending k from +0, a chunk's
//     sub-chain sums added in order to a chunk sum from +0, the chunk
//     sums added in chunk order to a total from +0.
//   - bf16 / f16: eight lanes; lane w starts at +0 and applies
//     mma.sync m16n8k16 (f32 accumulators) over the k16 groups
//     [256 s + 32 w, +16) and [256 s + 32 w + 16, +32) for the stages s
//     in order; the lanes are added in lane order to a sum from +0, and
//     for K under 256 only the first ceil(K / 32) lanes are added.  That
//     is matmul's order (tc_gemm.cuh, lane = warp).  A product of two
//     16-bit values is exact in f32, so this keeps the f32 sums the
//     reference asks for without f32 copies of the operands.
// The order is a property of the sequence of operations each accumulator
// sees, not of which warp, thread or block runs it, so each kernel below
// runs it in whatever arrangement suits its shape.  Zeros past K (a padded
// cache width) add exact zeros to the same chains, so trailing zero
// padding gives the same bits.
//
// Bound on the H100, and the kernels.
//   - bf16 / f16 (bmm_seq_kernel): the lanes run one after another in
//     each warp.  A k-tile is one lane's 32 values of k at one stage; the
//     block visits the k-tiles in the order (w, s) -- lane 0 over every
//     stage, then lane 1 -- each copied once by 16-byte cp.async in the
//     operand's own layout (ldmatrix for k-contiguous rows,
//     ldmatrix.trans for a transposed A or a row-major B, so no register
//     transposes), and every warp keeps the running lane sum ``tot``
//     beside ``acc`` for its own piece of the output.  A thread's copies
//     keep their place from one k-tile to the next, so their sources and
//     places are worked out once a block.  Stages of four k-tiles put a
//     barrier every 8 k16 steps.  The training products (hundreds of
//     flops a byte: the tensor cores bound them) take the wgmma mainloop
//     below, or where an operand is copied element by element 128 x 128
//     tiles, 64 x 32 a warp; up to 64 rows, 64 x 32 tiles (a 64-row
//     prefill chunk fills 128 blocks); up to 16 rows (decode, the MoE
//     experts' 8 rows, bound by the bytes of B they stream), 16 x 128.
//     One lane (K <= 32: the paged write's one-hot products, K = the
//     slot count, bound by the bytes of their output) takes 128 x 128
//     tiles and keeps no running sum.  The epilogue stages the tile in
//     shared memory and writes 16-byte rows.
//   - f32 on the CUDA cores (bmm_f32_kernel): a register tile sized by M
//     and N (one row and 64 columns a block at decode, where the f32 cache
//     read bounds q.k^T and p.V; 128 x 128 with 8 x 8 outputs a thread and
//     float4 reads of shared memory for the attention scores, bound by the
//     CUDA cores' 67 TFLOP/s), k tiles streamed by 4- or 16-byte cp.async
//     through a ring of stages; for K <= 256 (one chunk) no running total
//     and two blocks an SM (the 8 x 8 tile then keeps its chunk sums in
//     shared memory, over two stages).
//   - f32, few outputs over a long K (bmm_f32_split_kernel): a cluster of
//     8 blocks per output, each staging 32 chunks at a time in shared
//     memory and running one chunk's sub-chains per thread; block 0 of the
//     cluster adds the chunk sums in chunk order from the others' shared
//     memory (the sampler's pick of one logit out of the vocabulary).
//   - bf16 / f16 training tiles (more than 64 rows and one lane of k)
//     where the TMA unit reads both operands: wg_gemm.cuh's wgmma
//     mainloop (128 x 128 tiles, two lanes' k-tiles a ring stage,
//     persistent blocks over every batch).  The order names mma.sync's
//     chain, and one k16 step of wgmma rounds bit for bit as one of
//     mma.sync (kernels/wgmma_probe.py, on an H100: 2^27 outputs, bf16
//     and f16, every operand layout, equal), so both kernels give the
//     same bits.
#include "f32_gemm.cuh"
#include "wg_gemm.cuh"

namespace {

using namespace repro;

// names the batched kernel's wgmma mainloop in a profile (wg_gemm.cuh)
struct bmm_wg {};

// A element (b, m, k) at A[b * sab + m * sam + k * sak]; B element
// (b, k, n) at B[b * sbb + k * sbk + n * sbn].
struct Strides {
  long long sab, sam, sak, sbb, sbk, sbn;
};

constexpr int kBatchGrid = 65535;   // grid.y; a block walks the rest

unsigned batch_grid(long long rows) {
  return (unsigned)(rows < kBatchGrid ? rows : kBatchGrid);
}

// -- f32: the CUDA cores ---------------------------------------------------
// The f32 order and its arrangements are f32_gemm.cuh's.  Two of them run
// here -- register tiles, and a cluster per output for few outputs over a
// long K (the chunks in parallel) -- so which one a shape takes changes no
// bit.  Outputs (all batches) up to which a K of at least kSplitMinK runs
// its chunks in parallel, one cluster per output:
constexpr long long kSplitMaxOutputs = 8192;

// f32_gemm.cuh's register tile with one group of threads, A as As[k][m];
// at one chunk the 8 x 8 tile keeps its chunk sums in shared memory
template <class TL, bool ONE>
using BmmF32Tile = F32LaneTile<TL, 1, false, ONE && TL::TM * TL::TN >= 64>;

// ONE: K <= 256, one chunk (f32_lane_tile)
template <class TL, bool ONE>
__global__ void __launch_bounds__(TL::THREADS,
                                  ONE && TL::THREADS == kThreads ? 2 : 1)
    bmm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ C, int batch, int M, int N, int K,
                   Strides st, bool a_vec, bool b_vec) {
  constexpr int BM = TL::BM, BN = TL::BN, BK = TL::BK, AP = TL::AP;
  extern __shared__ __align__(16) float fsm[];
  const int tiles_n = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const float* Ab = A + b * st.sab;
    const float* Bb = B + b * st.sbb;
    f32_lane_tile<BmmF32Tile<TL, ONE>, ONE>(
        fsm, K,
        [&](float* as, int k0, int t) {
          f32_load<BM, AP, BK, TL::THREADS, BM == 1>(
              as, Ab, st.sak, st.sam, m0, M, k0, K, a_vec, t);
        },
        [&](float* bs, int k0, int t) {
          f32_load<BN, TL::BP, BK, TL::THREADS, BM == 1>(
              bs, Bb, st.sbk, st.sbn, n0, N, k0, K, b_vec, t);
        },
        [&](int m, int n, float v) {
          if (m0 + m < M && n0 + n < N)
            C[((size_t)b * M + m0 + m) * N + n0 + n] = v;
        });
  }
}

// Few outputs over a long K (the sampler's pick of one logit out of the
// vocabulary: M = N = 1, K = 102400): a cluster of kSplitCluster blocks
// per output (f32_split_sum).
__global__ void __cluster_dims__(kSplitCluster, 1, 1)
    __launch_bounds__(kThreads)
        bmm_f32_split_kernel(const float* __restrict__ A,
                             const float* __restrict__ B,
                             float* __restrict__ C, int batch, int M, int N,
                             int K, Strides st) {
  extern __shared__ __align__(16) float ssm[];
  const int o = blockIdx.x / kSplitCluster;
  const int m = o / N, n = o % N;
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const float tot = f32_split_sum(A + b * st.sab + m * st.sam, st.sak,
                                    B + b * st.sbb + n * st.sbn, st.sbk, K,
                                    ssm);
    if (blockIdx.x % kSplitCluster == 0 && threadIdx.x == 0)
      C[((size_t)b * M + m) * N + n] = tot;
  }
}

template <class TL, bool ONE>
cudaError_t launch_f32_tile(const float* A, const float* B, float* C,
                            int batch, int M, int N, int K, const Strides& st,
                            cudaStream_t s) {
  static PerDevice limit_set;
  const cudaError_t limit = once_per_device(limit_set, [] {
    return cudaFuncSetAttribute(bmm_f32_kernel<TL, ONE>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                BmmF32Tile<TL, ONE>::SMEM);
  });
  if (limit != cudaSuccess) return limit;
  const long long tiles =
      (long long)((M + TL::BM - 1) / TL::BM) * ((N + TL::BN - 1) / TL::BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  // 16-byte vectors along m (n): a contiguous index whose rows start on
  // 16 bytes, and an extent in whole vectors, so that a vector lies wholly
  // inside or outside the matrix
  const bool ok16 = aligned16(A) && aligned16(B);
  const bool a_vec = ok16 && st.sam == 1 && st.sak % 4 == 0 &&
                     st.sab % 4 == 0 && M % 4 == 0;
  const bool b_vec = ok16 && st.sbn == 1 && st.sbk % 4 == 0 &&
                     st.sbb % 4 == 0 && N % 4 == 0;
  dim3 grid((unsigned)tiles, batch_grid(batch));
  bmm_f32_kernel<TL, ONE>
      <<<grid, TL::THREADS, BmmF32Tile<TL, ONE>::SMEM, s>>>(
      A, B, C, batch, M, N, K, st, a_vec, b_vec);
  return cudaSuccess;
}

template <class TL>
cudaError_t launch_f32_tile(const float* A, const float* B, float* C,
                            int batch, int M, int N, int K, const Strides& st,
                            cudaStream_t s) {
  if (K <= kChunk)
    return launch_f32_tile<TL, true>(A, B, C, batch, M, N, K, st, s);
  return launch_f32_tile<TL, false>(A, B, C, batch, M, N, K, st, s);
}

// the f32 kernels, mirrored by kernels/ops.py:batched_matmul_plan
cudaError_t launch_f32(const float* A, const float* B, float* C, int batch,
                       int M, int N, int K, const Strides& st,
                       cudaStream_t s) {
  const long long outs = (long long)batch * M * N;
  if (K >= kSplitMinK && outs <= kSplitMaxOutputs) {
    static PerDevice limit_set;
    const cudaError_t limit = once_per_device(limit_set, [] {
      return cudaFuncSetAttribute(bmm_f32_split_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSplitSmem);
    });
    if (limit != cudaSuccess) return limit;
    dim3 grid((unsigned)((long long)M * N * kSplitCluster), batch_grid(batch));
    bmm_f32_split_kernel<<<grid, kThreads, kSplitSmem, s>>>(A, B, C, batch, M,
                                                           N, K, st);
    return cudaSuccess;
  }
  if (M == 1)
    return launch_f32_tile<F32Tile<1, 64, 1, 1, 32, 64, 4>>(A, B, C, batch, M,
                                                           N, K, st, s);
  if (M <= 4)
    return launch_f32_tile<F32Tile<4, 16, 1, 1, 32, 64, 4>>(A, B, C, batch, M,
                                                           N, K, st, s);
  if (M <= 16)
    return launch_f32_tile<F32Tile<16, 64, 1, 4, 32, 256, 3>>(A, B, C, batch,
                                                             M, N, K, st, s);
  if (M <= 64 || N <= 64)
    return launch_f32_tile<F32Tile<64, 64, 4, 4, 32, 256, 3>>(A, B, C, batch,
                                                             M, N, K, st, s);
  // one chunk (the attention scores over a head): the chunk sums in
  // shared memory, two stages, two blocks an SM
  if (K <= kChunk)
    return launch_f32_tile<F32Tile<128, 128, 8, 8, 16, 256, 2>, true>(
        A, B, C, batch, M, N, K, st, s);
  return launch_f32_tile<F32Tile<128, 128, 8, 8, 16, 256, 3>, false>(
      A, B, C, batch, M, N, K, st, s);
}

// -- bf16 / f16: the lanes in sequence ----------------------------------------
// Element offset of 16-byte chunk ``c`` of row ``r`` in rows of W
// elements, XOR-swizzled so that the 8 rows an ldmatrix phase reads at one
// logical chunk lie in 8 distinct bank quads.
template <int W>
__device__ __forceinline__ int sw(int r, int c) {
  constexpr int CW = W / 8;
  static_assert(CW == 2 || CW == 4 || CW % 8 == 0, "row width");
  if constexpr (CW % 8 == 0)
    return r * W + ((c ^ (r & 7)) << 3);
  else if constexpr (CW == 4)
    return r * W + ((c ^ ((r >> 1) & 3)) << 3);
  else
    return r * W + ((c ^ ((r >> 2) & 1)) << 3);
}

// The block's BM x BN tile: WARPS_M x (8 / WARPS_M) warps, each a WM x WN
// piece (MF x NF mma fragments), and a ring of STAGES stages of KG
// k-tiles of kKT = 32 (one lane's k at one stage of the order), each
// k-tile B's then A's.
constexpr int kKT = tc::kWarpK;

template <int BM_, int BN_, int WARPS_M_, int STAGES_, int KG_>
struct SeqTile {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_;
  static constexpr int STAGES = STAGES_, KG = KG_;
  static constexpr int WARPS_N = kWarps / WARPS_M;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MF = WM / 16, NF = WN / 8;
  static constexpr int KTILE = kKT * (BM + BN);   // elements of a k-tile
  static constexpr int STAGE = KG * KTILE;
  // the largest ring; a launch takes only the stages its k-tiles fill,
  // and at least the epilogue's staging (mirrored by ops.BMM_SEQ_TILES)
  static constexpr int RING = STAGES * STAGE * 2;
  static_assert(WM % 16 == 0 && NF % 2 == 0 && WARPS_M * WARPS_N == kWarps,
                "warp tile");
};

// the epilogue's row pitch (elements) when the tile is staged in shared
// memory: 16 bytes past the row
template <typename O, class TL>
__host__ __device__ constexpr int seq_out_pitch() {
  return TL::BN + 16 / (int)sizeof(O);
}

template <class TL, typename T>
int seq_smem(int tiles, bool out_f32) {
  const int used = (tiles + TL::KG - 1) / TL::KG;
  const int ring =
      (used < TL::STAGES ? used : TL::STAGES) * TL::STAGE * 2;
  const int epi = out_f32 ? TL::BM * seq_out_pitch<float, TL>() * 4
                          : TL::BM * seq_out_pitch<T, TL>() * 2;
  return ring > epi ? ring : epi;
}

// One operand's 16-byte copies of a k-tile into a tile of X_EXT rows or
// columns (A's m, B's n): KFAST, the tile is [x][32] and the chunks run
// along k (k contiguous); else [k][X_EXT] and they run along x.  A
// thread's chunks keep their row, column and place in the tile from one
// k-tile to the next, so they are worked out once a block: each k-tile
// adds its k to the source and checks it against K.
template <typename T, int X_EXT, bool KFAST>
struct VecSlots {
  static constexpr int CHUNKS = KFAST ? X_EXT * 4 : kKT * (X_EXT / 8);
  static constexpr int N = (CHUNKS + kThreads - 1) / kThreads;
  long long src[N];   // element offset of the chunk at k0 = 0
  int off[N];         // element offset in the tile
  int kk[N];          // the chunk's k within the k-tile
  bool ok[N];         // inside the matrix along x (and a chunk at all)

  __device__ __forceinline__ void init(long long sx, long long sk, int x0,
                                       int X) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if constexpr (KFAST) {
        const int x = e >> 2, c = e & 3;
        ok[i] = e < CHUNKS && x0 + x < X;
        src[i] = ok[i] ? (x0 + x) * sx + c * 8 : 0;
        off[i] = sw<kKT>(x & (X_EXT - 1), c);
        kk[i] = c * 8;
      } else {
        constexpr int CX = X_EXT / 8;
        const int k = e / CX, c = e % CX;
        ok[i] = e < CHUNKS && x0 + c * 8 < X;
        src[i] = ok[i] ? k * sk + x0 + c * 8 : 0;
        off[i] = sw<X_EXT>(k & (kKT - 1), c);
        kk[i] = k;
      }
    }
  }

  __device__ __forceinline__ void load(T* tile, const T* p, long long sk,
                                       int k0, int K) const {
    const long long kofs = KFAST ? k0 : k0 * sk;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (N * kThreads > CHUNKS && threadIdx.x + i * kThreads >= CHUNKS)
        break;
      const bool v = ok[i] && k0 + kk[i] < K;
      tc::cp_async16(tile + off[i], v ? p + src[i] + kofs : p, v);
    }
  }
};

// One k-tile (k in [k0, k0 + 32)) of both operands, in the layout of each
// operand's contiguous index: B as bs[k][BN] (B_K false: n contiguous) or
// bs[n][32] (B_K: k contiguous), A as as[m][32] (A_K: k contiguous) or
// as[k][BM].  16-byte cp.async where ``vec`` (VecSlots), else element by
// element with the threads along the tile's rows; everything outside the
// matrices is zero.
template <typename T, class TL, bool A_K, bool B_K>
struct SeqLoader {
  const T* A;
  const T* B;
  long long sam, sak, sbk, sbn;
  int M, N, K, m0, n0;
  bool a_vec, b_vec;
  VecSlots<T, TL::BM, A_K> av;
  VecSlots<T, TL::BN, B_K> bv;

  __device__ __forceinline__ void init() {
    if (a_vec) av.init(sam, sak, m0, M);
    if (b_vec) bv.init(sbn, sbk, n0, N);
  }

  __device__ __forceinline__ void load(T* tile, int k0) const {
    constexpr int BM = TL::BM, BN = TL::BN;
    const T zero = from_f32<T>(0.f);
    T* bs = tile;
    T* as = tile + kKT * BN;
    if (b_vec) {
      bv.load(bs, B, sbk, k0, K);
    } else if constexpr (B_K) {
      for (int e = threadIdx.x; e < BN * kKT; e += kThreads) {
        const int n = e / kKT, k = e % kKT;
        const bool ok = n0 + n < N && k0 + k < K;
        bs[sw<kKT>(n, k >> 3) + (k & 7)] =
            ok ? B[(k0 + k) * sbk + (n0 + n) * sbn] : zero;
      }
    } else {
      for (int e = threadIdx.x; e < BN * kKT; e += kThreads) {
        const int k = e / BN, n = e % BN;
        const bool ok = n0 + n < N && k0 + k < K;
        bs[sw<BN>(k, n >> 3) + (n & 7)] =
            ok ? B[(k0 + k) * sbk + (n0 + n) * sbn] : zero;
      }
    }
    if (a_vec) {
      av.load(as, A, sak, k0, K);
    } else if constexpr (A_K) {
      for (int e = threadIdx.x; e < BM * kKT; e += kThreads) {
        const int m = e / kKT, k = e % kKT;
        const bool ok = m0 + m < M && k0 + k < K;
        as[sw<kKT>(m, k >> 3) + (k & 7)] =
            ok ? A[(m0 + m) * sam + (k0 + k) * sak] : zero;
      }
    } else {
      for (int e = threadIdx.x; e < BM * kKT; e += kThreads) {
        const int k = e / BM, m = e % BM;
        const bool ok = m0 + m < M && k0 + k < K;
        as[sw<BM>(k, m >> 3) + (m & 7)] =
            ok ? A[(m0 + m) * sam + (k0 + k) * sak] : zero;
      }
    }
  }
};

// One k16 step's fragments of a warp's piece: A's MF m16k16 and B's NF
// n8k16 (two per ldmatrix.x4), from the k-tile at ``tile``, k in
// [kk, kk + 16).
template <typename T, class TL, bool A_K, bool B_K>
struct SeqFrags {
  unsigned a[TL::MF][4];
  unsigned b[TL::NF / 2][4];

  __device__ __forceinline__ void load(const T* tile, int kk, int wm0,
                                       int wn0, int lane) {
    const T* bs = tile;
    const T* as = tile + kKT * TL::BN;
#pragma unroll
    for (int h = 0; h < TL::NF / 2; ++h) {
      const int nb = wn0 + h * 16;
      if constexpr (B_K) {
        const int n = nb + (lane & 7) + ((lane >> 4) << 3);
        tc::ldmatrix_x4(b[h], bs + sw<kKT>(n, (kk >> 3) + ((lane >> 3) & 1)));
      } else {
        const int k = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        tc::ldmatrix_x4_trans(b[h], bs + sw<TL::BN>(k, (nb >> 3) +
                                                           (lane >> 4)));
      }
    }
#pragma unroll
    for (int i = 0; i < TL::MF; ++i) {
      const int mb = wm0 + i * 16;
      if constexpr (A_K) {
        tc::ldmatrix_x4(a[i], as + sw<kKT>(mb + (lane & 15),
                                           (kk >> 3) + (lane >> 4)));
      } else {
        const int k = kk + (lane & 7) + ((lane >> 4) << 3);
        tc::ldmatrix_x4_trans(
            a[i], as + sw<TL::BM>(k, (mb >> 3) + ((lane >> 3) & 1)));
      }
    }
  }
};

// The epilogue: a warp's values ``v`` (rows r, r + 8 and columns qc,
// qc + 1 of each fragment) into C's rows row0 + m.  Where rows of C hold
// whole 16-byte vectors, the tile is staged in shared memory (the ring's,
// free by now) and written a 16-byte vector a thread, rows in full; else
// from registers, two values (or one) a store.
template <typename O, typename T, class TL>
__device__ __forceinline__ void seq_store(const float (&v)[TL::MF][TL::NF][4],
                                          O* C, size_t row0, int M, int N,
                                          int m0, int n0, int wm0, int wn0,
                                          int r, int qc, unsigned char* smem) {
  constexpr int V = 16 / (int)sizeof(O), P = seq_out_pitch<O, TL>();
  if (N % V == 0) {
    O* stage = reinterpret_cast<O*>(smem);
#pragma unroll
    for (int i = 0; i < TL::MF; ++i)
#pragma unroll
      for (int n = 0; n < TL::NF; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          O* p = stage + (wm0 + i * 16 + r + h * 8) * P + wn0 + n * 8 + qc;
          if constexpr (sizeof(O) == 4)
            *reinterpret_cast<float2*>(p) =
                make_float2(v[i][n][2 * h], v[i][n][2 * h + 1]);
          else
            *reinterpret_cast<unsigned*>(p) =
                pack2<T>(v[i][n][2 * h], v[i][n][2 * h + 1]);
        }
    __syncthreads();
    constexpr int CV = TL::BN / V;
    for (int e = threadIdx.x; e < TL::BM * CV; e += kThreads) {
      const int row = e / CV, c = e % CV;
      const int m = m0 + row, n = n0 + c * V;
      if (m < M && n < N)
        *reinterpret_cast<uint4*>(C + (row0 + m) * N + n) =
            *reinterpret_cast<const uint4*>(stage + row * P + c * V);
    }
    return;
  }
  const bool pairs = (N & 1) == 0;   // (m, qc) starts on a pair
#pragma unroll
  for (int i = 0; i < TL::MF; ++i)
#pragma unroll
    for (int n = 0; n < TL::NF; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm0 + i * 16 + r + h * 8;
        const int col = n0 + wn0 + n * 8 + qc;
        if (m >= M || col >= N) continue;
        const float v0 = v[i][n][2 * h], v1 = v[i][n][2 * h + 1];
        O* c = C + (row0 + m) * N + col;
        if constexpr (sizeof(O) == 4) {
          if (pairs) {
            *reinterpret_cast<float2*>(c) = make_float2(v0, v1);
          } else {
            c[0] = v0;
            if (col + 1 < N) c[1] = v1;
          }
        } else {
          if (pairs) {
            *reinterpret_cast<unsigned*>(c) = pack2<T>(v0, v1);
          } else {
            c[0] = from_f32<T>(v0);
            if (col + 1 < N) c[1] = from_f32<T>(v1);
          }
        }
      }
}

// ONE: the order has one lane (K <= 32): the output is +0 + that lane's
// chain, and no running sum is kept.
template <typename T, class TL, bool A_K, bool B_K, bool ONE>
__global__ void __launch_bounds__(kThreads,
                                  TL::BM * TL::BN >= 128 * 128 ? 1 : 2)
    bmm_seq_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   void* __restrict__ C, int batch, int M, int N, int K,
                   Strides st, bool a_vec, bool b_vec, bool out_f32) {
  constexpr int BM = TL::BM, BN = TL::BN, MF = TL::MF, NF = TL::NF;
  constexpr int STAGES = TL::STAGES, STAGE = TL::STAGE, KG = TL::KG;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp % TL::WARPS_M) * TL::WM;
  const int wn0 = (warp / TL::WARPS_M) * TL::WN;
  const int tiles_n = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  const int nst = (K + tc::kKS - 1) / tc::kKS;
  // the lanes that hold data: all 8, but ceil(K / 32) for K under a stage
  const int live = K < tc::kKS ? (K + kKT - 1) / kKT : kWarps;
  const int tiles = live * nst;   // k-tile t: lane t / nst, stage t % nst
  const int nstage = (tiles + KG - 1) / KG;
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    SeqLoader<T, TL, A_K, B_K> ld{A + b * st.sab, B + b * st.sbb, st.sam,
                                  st.sak, st.sbk, st.sbn, M, N, K, m0, n0,
                                  a_vec, b_vec};
    ld.init();
    // the next k-tile to load: lane lw at stage ls of the order
    int lw = 0, ls = 0;
    auto load_stage = [&](int j) {
      T* slot = ring + (j % STAGES) * STAGE;
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        if (j * KG + g < tiles) {
          ld.load(slot + g * TL::KTILE, ls * tc::kKS + lw * kKT);
          if (++ls == nst) {
            ls = 0;
            ++lw;
          }
        }
      }
    };
    float acc[MF][NF][4], tot[MF][NF][4];   // tot: unused when ONE
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
    if constexpr (!ONE) {
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) tot[i][j][v] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
      if (j < nstage) load_stage(j);
      tc::cp_async_commit();
    }
    int cs = 0;   // the stage of the order of the k-tile multiplied next
    for (int j = 0; j < nstage; ++j) {
      tc::cp_async_wait<STAGES - 2>();   // stage j has landed
      __syncthreads();                   // ... for all; slot j-1 is free
      if (j + STAGES - 1 < nstage) load_stage(j + STAGES - 1);
      tc::cp_async_commit();
      const T* slot = ring + (j % STAGES) * STAGE;
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        if (j * KG + g >= tiles) break;   // uniform: the last stage's tail
#pragma unroll
        for (int kk = 0; kk < kKT; kk += 16) {
          SeqFrags<T, TL, A_K, B_K> f;
          f.load(slot + g * TL::KTILE, kk, wm0, wn0, lane);
#pragma unroll
          for (int i = 0; i < MF; ++i)
#pragma unroll
            for (int n = 0; n < NF; ++n)
              tc::mma16816<T>(acc[i][n], f.a[i], f.b[n >> 1][(n & 1) * 2],
                              f.b[n >> 1][(n & 1) * 2 + 1]);
        }
        if constexpr (!ONE) {
          if (++cs == nst) {   // a lane ends: add it in lane order
            cs = 0;
#pragma unroll
            for (int i = 0; i < MF; ++i)
#pragma unroll
              for (int n = 0; n < NF; ++n)
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                  tot[i][n][v] += acc[i][n][v];
                  acc[i][n][v] = 0.f;
                }
          }
        }
      }
    }
    tc::cp_async_wait<0>();
    __syncthreads();   // the ring is free: the epilogue stages the tile
    // the output values, +0 plus the lanes in order: (row r, columns qc,
    // qc + 1) and row r + 8 of each fragment
    const int r = lane >> 2, qc = (lane & 3) * 2;
    const size_t row0 = (size_t)b * M;
    if constexpr (ONE) {
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int n = 0; n < NF; ++n)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[i][n][v] = 0.f + acc[i][n][v];
    }
    const float(&out)[MF][NF][4] = ONE ? acc : tot;
    if (out_f32)
      seq_store<float, T, TL>(out, static_cast<float*>(C), row0, M, N, m0, n0,
                              wm0, wn0, r, qc, smem);
    else
      seq_store<T, T, TL>(out, static_cast<T*>(C), row0, M, N, m0, n0, wm0,
                          wn0, r, qc, smem);
    __syncthreads();   // the next batch's ring reuses the staging
  }
}

template <typename T, class TL, bool A_K, bool B_K, bool ONE>
cudaError_t launch_seq(const T* A, const T* B, void* C, int batch, int M,
                       int N, int K, const Strides& st, bool a_vec,
                       bool b_vec, bool out_f32, cudaStream_t s) {
  static PerDevice limit_set;
  const cudaError_t limit = once_per_device(limit_set, [] {
    constexpr int epi = TL::BM * seq_out_pitch<float, TL>() * 4;
    return cudaFuncSetAttribute(bmm_seq_kernel<T, TL, A_K, B_K, ONE>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                TL::RING > epi ? TL::RING : epi);
  });
  if (limit != cudaSuccess) return limit;
  const long long grid_tiles =
      (long long)((M + TL::BM - 1) / TL::BM) * ((N + TL::BN - 1) / TL::BN);
  if (grid_tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int nst = (K + tc::kKS - 1) / tc::kKS;
  const int live = K < tc::kKS ? (K + kKT - 1) / kKT : kWarps;
  dim3 grid((unsigned)grid_tiles, batch_grid(batch));
  bmm_seq_kernel<T, TL, A_K, B_K, ONE>
      <<<grid, kThreads, seq_smem<TL, T>(live * nst, out_f32), s>>>(
          A, B, C, batch, M, N, K, st, a_vec, b_vec, out_f32);
  return cudaSuccess;
}

// How an operand is copied (mirrored by kernels/ops.py:
// batched_matmul_copy): 16-byte cp.async along its contiguous index, where
// that is B's n or A's k (kRows) or B's k or A's m (kColumns); else element
// by element.  A vector copy needs its chunk of 8 aligned and wholly
// inside or wholly outside the matrix.
enum CopyMode { kElements = 0, kRows = 1, kColumns = 2 };

// The copy mode of an operand whose index ``row`` (B's n, A's k) is
// ``s_row`` apart, ``col`` (B's k, A's m) ``s_col`` apart, ``s_batch``
// between batches, with extents ``n_row``, ``n_col``.  The k-tile keeps
// the layout the copy reads: kRows B as [k][n] and A as [m][k], kColumns
// B as [n][k] and A as [k][m].
int copy_mode(const void* p, long long s_row, long long s_col,
              long long s_batch, int n_row, int n_col) {
  if (!aligned16(p) || s_batch % 8) return kElements;
  if (s_row == 1 && s_col % 8 == 0 && n_row % 8 == 0) return kRows;
  if (s_col == 1 && s_row % 8 == 0 && n_col % 8 == 0) return kColumns;
  return kElements;
}

// bmm_seq_kernel for one tile: the slot layouts follow the copy modes (an
// element copy keeps the layout of whichever index is contiguous)
template <typename T, class TL, bool ONE>
cudaError_t launch_seq_tile(const T* A, const T* B, void* C, int batch,
                            int M, int N, int K, const Strides& st,
                            int a_mode, int b_mode, bool out_f32,
                            cudaStream_t s) {
  const bool a_k = a_mode == kRows ||
                   (a_mode == kElements && !(st.sam == 1 && st.sak != 1));
  const bool b_k = b_mode == kColumns ||
                   (b_mode == kElements && st.sbk == 1 && st.sbn != 1);
  const bool a_vec = a_mode != kElements, b_vec = b_mode != kElements;
  if (a_k && b_k)
    return launch_seq<T, TL, true, true, ONE>(A, B, C, batch, M, N, K, st,
                                              a_vec, b_vec, out_f32, s);
  if (a_k)
    return launch_seq<T, TL, true, false, ONE>(A, B, C, batch, M, N, K, st,
                                               a_vec, b_vec, out_f32, s);
  if (b_k)
    return launch_seq<T, TL, false, true, ONE>(A, B, C, batch, M, N, K, st,
                                               a_vec, b_vec, out_f32, s);
  return launch_seq<T, TL, false, false, ONE>(A, B, C, batch, M, N, K, st,
                                              a_vec, b_vec, out_f32, s);
}

// the 16-bit kernels and tiles, mirrored by kernels/ops.py:
// batched_matmul_plan
template <typename T>
cudaError_t launch_16bit(const void* a, const void* b, void* c, int batch,
                         int M, int N, int K, const Strides& st, bool out_f32,
                         cudaStream_t s) {
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  const int a_mode = copy_mode(A, st.sak, st.sam, st.sab, K, M);
  const int b_mode = copy_mode(B, st.sbn, st.sbk, st.sbb, N, K);
  if (K <= kKT)   // one lane (the paged write)
    return launch_seq_tile<T, SeqTile<128, 128, 2, 2, 1>, true>(
        A, B, c, batch, M, N, K, st, a_mode, b_mode, out_f32, s);
  if (M <= 16)
    return launch_seq_tile<T, SeqTile<16, 128, 1, 3, 4>, false>(
        A, B, c, batch, M, N, K, st, a_mode, b_mode, out_f32, s);
  if (M <= 64)
    return launch_seq_tile<T, SeqTile<64, 32, 4, 3, 4>, false>(
        A, B, c, batch, M, N, K, st, a_mode, b_mode, out_f32, s);
  // the training tiles: the wgmma mainloop where the TMA unit reads both
  // operands (16-byte vectors along the contiguous index, a batch stride
  // that is not 0 between several batches)
  if (a_mode != kElements && b_mode != kElements &&
      (batch == 1 || (st.sab != 0 && st.sbb != 0)))
    return wg::gemm<bmm_wg, T>(
        wg::Operand{A, a_mode == kRows, a_mode == kRows ? st.sam : st.sak,
                    st.sab},
        wg::Operand{B, b_mode == kColumns,
                    b_mode == kColumns ? st.sbn : st.sbk, st.sbb},
        c, batch, M, N, K, out_f32, s);
  return launch_seq_tile<T, SeqTile<128, 128, 2, 3, 4>, false>(
      A, B, c, batch, M, N, K, st, a_mode, b_mode, out_f32, s);
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
                         static_cast<const float*>(b), static_cast<float*>(c),
                         batch, M, N, K, st, s);
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
