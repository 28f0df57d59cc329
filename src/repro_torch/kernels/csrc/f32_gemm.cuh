// The port's one f32 contraction order on the CUDA cores, the three
// arrangements that run it, and matmul's f32 launch built on them,
// shared by batched_matmul.cu (every f32 contraction the emitted program
// runs outside the ported kernels), matmul.cu (its f32 route), swiglu.cu
// (its f32 gate/up kernel, and its down product: matmul's launch) and
// norm_matmul.cu (its f32 product: matmul's launch).
//
// The order, fixed by K alone (kernels/ops.py:f32_k_order, which
// batched_matmul_k_order and matmul_k_order state), in three levels: k in
// chunks of kChunk = 256, each chunk in sub-chains of kSub = 32
// consecutive k; each sub-chain is one fmaf chain in ascending k from +0;
// a chunk's sub-chain sums are added in order to a chunk sum from +0; and
// the chunk sums are added in chunk order to a total from +0.  About 32 +
// 8 + K / 256 roundings an output (one 256-long chain had 256 + K / 256).
// No TF32 and no tensor cores (f32 means f32), no atomics, and nothing in
// the order depends on M, N, the arrangement or tile chosen, or an
// output's place, so a row gives the same bits alone or in any batch, and
// the three arrangements below give the same bits as each other.  A chunk
// sum or a total never reaches -0 (each starts at +0, and a sum is -0
// only where both terms are), so neither the zeros a tile adds past K nor
// a sub-chain begun by its first product instead of an fmaf onto +0 (the
// two differ at most in the sign of a zero) changes a bit.
//
// The arrangements (each caller picks one by shape):
//   - register tiles (f32_lane_tile): a block owns a BM x BN output tile,
//     TM x TN outputs a thread; k tiles of A and B stream through a ring
//     of cp.async stages in shared memory.  A thread keeps each output's
//     running sub-chain and its chunk sum beside it (the batched kernel's
//     8 x 8 thread tile at one chunk: the sums in shared memory), and adds
//     the one to the other at every 32nd k.  In the batched kernel's tiles
//     a thread runs the chunks of its outputs one after another and keeps
//     their running totals too; in matmul's 4 or 8 groups of threads run
//     the tile's chunks for different chunks at once and each output's
//     owner adds the chunk sums in order, so a prefill's few rows still
//     get 4 x 4 or 4 x 8 outputs a thread and a block or two an SM.  Bound
//     by the CUDA cores' 67 TFLOP/s at many rows.  The operands'
//     addressing is the caller's (load functors).
//   - chunk lanes (f32_lanes): few rows (decode) against a wide B, where
//     the bytes of B bind.  A block owns at most 4 rows and 32 columns;
//     its 16 or 32 lanes of 8 threads run that many chunks at once, each
//     thread the sub-chains of 4 columns of every row with B read straight
//     from device memory as 16-byte vectors (no shared memory on the
//     stream, 16 to 32 loads in flight a thread), and the chunk sums meet
//     in shared memory, where each output's owner adds them in chunk
//     order.  The caller names each group's 4 columns (swiglu pairs 16 of
//     wg with the same 16 of wu).
//   - a cluster per output (f32_split_sum): few outputs over a long K (the
//     sampler's pick of one logit, a router at decode): 8 blocks stage
//     their chunks of A's row and B's column in shared memory, one chunk's
//     sub-chains a thread, and block 0 adds the chunk sums in chunk order
//     from the others' shared memory.
#pragma once

#include <cooperative_groups.h>

#include "tc_gemm.cuh"

namespace repro {

constexpr int kChunk = 256;
constexpr int kSub = 32;   // k a sub-chain
static_assert(kChunk % kSub == 0, "a chunk is whole sub-chains");

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 4 bytes global -> shared; with ``valid`` false nothing is read and the
// destination is zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tc::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// -- register tiles ------------------------------------------------------------
// A BM x BN output tile, TM x TN outputs a thread, THREADS threads, k in
// tiles of BK through a ring of STAGES stages in shared memory (the
// layout of the stages is F32LaneTile's).  Thread columns, and thread
// rows of an A stored As[k][m], come in groups of 4 where TN (TM) is a
// multiple of 4, read as float4, the groups BN / (TN / 4) apart; else one
// apart, BN / TN apart.
template <int BM_, int BN_, int TM_, int TN_, int BK_, int THREADS_,
          int STAGES_>
struct F32Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_;
  static constexpr int THREADS = THREADS_, STAGES = STAGES_;
  static constexpr int AP = BM + 4, BP = BN + 4;
  static constexpr int TX = BN / TN;             // threads along n
  static_assert((BM / TM) * (BN / TN) == THREADS, "one output tile");
  static_assert(kChunk % BK == 0, "a k tile lies in one chunk");
  static_assert(STAGES >= 2, "ring");
};

template <int T, int B>
__device__ __forceinline__ int f32_pos(int t, int i) {
  if constexpr (T % 4 == 0)
    return (i / 4) * (B / (T / 4)) + t * 4 + i % 4;
  else
    return t + i * (B / T);
}

template <int T, int B>
__device__ __forceinline__ void f32_frag(const float* row, int t,
                                         float (&v)[T]) {
  if constexpr (T % 4 == 0) {
#pragma unroll
    for (int g = 0; g < T / 4; ++g) {
      const float4 x =
          *reinterpret_cast<const float4*>(row + g * (B / (T / 4)) + t * 4);
      v[g * 4] = x.x;
      v[g * 4 + 1] = x.y;
      v[g * 4 + 2] = x.z;
      v[g * 4 + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < T; ++i) v[i] = row[t + i * (B / T)];
  }
}

// Copies i = 0..N-1 of a k tile: ``copy(i)`` returns false past the
// tile.  Unrolled, but rolled (ROLL) for the one-row tile, which streams
// the bytes of B and then keeps more blocks on an SM.
template <int N, bool ROLL, class F>
__device__ __forceinline__ void f32_copies(F&& copy) {
  if constexpr (ROLL) {
#pragma unroll 1
    for (int i = 0; i < N; ++i)
      if (!copy(i)) break;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (!copy(i)) break;
  }
}

// One k tile of an operand X (A: x = m; B: x = n) into Xs[k][x], pitch
// XP, extent BX, from X(k, x) at p + k * sk + x * sx, by THREADS threads
// of which this is thread t: 16-byte vectors along x where ``vec`` (x
// contiguous, 16-byte aligned rows, an extent in whole vectors), else
// 4-byte elements with the threads along whichever index is contiguous.
// Copy i of a thread keeps its place along the threads' index and steps
// the other by THREADS / (that extent), so the sources and places are a
// base and a fixed stride.
template <int BX, int XP, int BK, int THREADS, bool ROLL>
__device__ __forceinline__ void f32_load(float* xs, const float* p,
                                         long long sk, long long sx, int x0,
                                         int X, int k0, int K, bool vec,
                                         int t) {
  if (BX % 4 == 0 && vec) {
    constexpr int CX = BX % 4 == 0 ? BX / 4 : 1;   // vectors along x
    static_assert(THREADS % CX == 0, "");
    constexpr int STEP = THREADS / CX, N = (BK + STEP - 1) / STEP;
    const int x = (t % CX) * 4, k = t / CX;
    const bool xok = x0 + x < X;
    const float* src = p + (k0 + k) * sk + x0 + x;
    f32_copies<N, ROLL>([&](int i) {
      if (BK % STEP && k + i * STEP >= BK) return false;
      const bool ok = xok && k0 + k + i * STEP < K;
      tc::cp_async16(xs + (k + i * STEP) * XP + x,
                     ok ? src + i * STEP * sk : p, ok);
      return true;
    });
  } else if (sx == 1) {   // the threads along x
    constexpr int STEP = THREADS / BX, N = (BK + STEP - 1) / STEP;
    static_assert(THREADS % BX == 0, "");
    const int x = t % BX, k = t / BX;
    const bool xok = x0 + x < X;
    const float* src = p + (k0 + k) * sk + x0 + x;
    f32_copies<N, ROLL>([&](int i) {
      if (BK % STEP && k + i * STEP >= BK) return false;
      const bool ok = xok && k0 + k + i * STEP < K;
      cp_async4(xs + (k + i * STEP) * XP + x, ok ? src + i * STEP * sk : p,
                ok);
      return true;
    });
  } else {   // the threads along k
    constexpr int STEP = THREADS / BK;
    constexpr int N = (BX + STEP - 1) / STEP;
    static_assert(THREADS % BK == 0, "");
    const int k = t % BK, x = t / BK;
    const bool kok = k0 + k < K;
    const float* src = p + (k0 + k) * sk + (x0 + x) * sx;
    f32_copies<N, ROLL>([&](int i) {
      if (BX % STEP && x + i * STEP >= BX) return false;
      const bool ok = kok && x0 + x + i * STEP < X;
      cp_async4(xs + k * XP + x + i * STEP, ok ? src + i * STEP * sx : p,
                ok);
      return true;
    });
  }
}

// acc = a * b where FIRST (k starts a sub-chain: the chain from +0,
// whose first fmaf differs from the product in no bit but the sign of a
// zero, which the chunk sum's +0 start takes away), else acc += a * b
template <bool FIRST>
__device__ __forceinline__ void f32_step(float a, float b, float& acc) {
  acc = FIRST ? __fmul_rn(a, b) : fmaf(a, b, acc);   // never contracted
}

// Products of k = KB .. KB + N - 1 of a k tile: acc[i][j] += a * b in
// ascending k, one fmaf per output per k (the first a product where FIRST:
// f32_step), from As[k][m] and Bs[k][n] in shared memory (thread (ty, tx)
// of the tile)
template <class TL, int N, bool FIRST>
__device__ __forceinline__ void f32_tile_fma(const float* as, const float* bs,
                                             int ty, int tx, int KB,
                                             float (&acc)[TL::TM][TL::TN]) {
#pragma unroll
  for (int kk = KB; kk < KB + N; ++kk) {
    float a[TL::TM], bv[TL::TN];
    f32_frag<TL::TM, TL::BM>(as + kk * TL::AP, ty, a);
    f32_frag<TL::TN, TL::BN>(bs + kk * TL::BP, tx, bv);
#pragma unroll
    for (int i = 0; i < TL::TM; ++i)
#pragma unroll
      for (int j = 0; j < TL::TN; ++j) {
        if (FIRST && kk == KB)
          f32_step<true>(a[i], bv[j], acc[i][j]);
        else
          f32_step<false>(a[i], bv[j], acc[i][j]);
      }
  }
}

// One k tile of a row-major (X, K) operand (A: x = m) into Xs[x][k],
// pitch BK + 4, by THREADS threads of which this is thread t: 16-byte
// vectors along k where ``vec`` (K % 4 == 0, 16-byte aligned rows), else
// 4-byte elements; the threads along k either way, zeros outside.
template <int BX, int BK, int THREADS>
__device__ __forceinline__ void f32_load_kmajor(float* xs, const float* p,
                                                long long ld, int x0, int X,
                                                int k0, int K, bool vec,
                                                int t) {
  constexpr int P = BK + 4;
  if (vec) {
    constexpr int CK = BK / 4;   // vectors along k
    static_assert(BK % 4 == 0 && THREADS % CK == 0, "");
    constexpr int STEP = THREADS / CK, N = (BX + STEP - 1) / STEP;
    const int k = (t % CK) * 4, x = t / CK;
    const bool kok = k0 + k < K;
    const float* src = p + (x0 + x) * ld + k0 + k;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (BX % STEP && x + i * STEP >= BX) break;
      const bool ok = kok && x0 + x + i * STEP < X;
      tc::cp_async16(xs + (x + i * STEP) * P + k,
                     ok ? src + i * STEP * ld : p, ok);
    }
  } else {
    static_assert(THREADS % BK == 0, "");
    constexpr int STEP = THREADS / BK, N = (BX + STEP - 1) / STEP;
    const int k = t % BK, x = t / BK;
    const bool kok = k0 + k < K;
    const float* src = p + (x0 + x) * ld + k0 + k;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (BX % STEP && x + i * STEP >= BX) break;
      const bool ok = kok && x0 + x + i * STEP < X;
      cp_async4(xs + (x + i * STEP) * P + k, ok ? src + i * STEP * ld : p,
                ok);
    }
  }
}

// f32_tile_fma with A k-major (As[m][k], pitch AKP): 4 values of k of a
// row in one 16-byte read, the thread's rows ty + i * BM / TM (32 banks
// for 8 rows in a row at pitch 20); the same fmaf per output per k in
// ascending k
template <class TL, int AKP, int N, bool FIRST>
__device__ __forceinline__ void f32_tile_fma_kmajor(
    const float* as, const float* bs, int ty, int tx, int KB,
    float (&acc)[TL::TM][TL::TN]) {
  static_assert(N % 4 == 0, "");
#pragma unroll
  for (int kq = KB; kq < KB + N; kq += 4) {
    float4 a4[TL::TM];
#pragma unroll
    for (int i = 0; i < TL::TM; ++i)
      a4[i] = *reinterpret_cast<const float4*>(
          as + (ty + i * (TL::BM / TL::TM)) * AKP + kq);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float bv[TL::TN];
      f32_frag<TL::TN, TL::BN>(bs + (kq + c) * TL::BP, tx, bv);
#pragma unroll
      for (int i = 0; i < TL::TM; ++i)
#pragma unroll
        for (int j = 0; j < TL::TN; ++j) {
          if (FIRST && kq == KB && c == 0)
            f32_step<true>(f4(a4[i], c), bv[j], acc[i][j]);
          else
            f32_step<false>(f4(a4[i], c), bv[j], acc[i][j]);
        }
    }
  }
}

// -- the register-tile engine ----------------------------------------------------
// LANES groups of TL::THREADS threads share one output tile; group l runs
// the tile's sub-chains for chunks l, l + LANES, ... (a round of LANES
// chunks at a time), each k tile through its own ring of TL::STAGES
// stages.  A thread keeps, beside each output's running sub-chain, its
// chunk sum, and adds the sub-chain to it at every kSub-th k of the chunk.
// With LANES 1 (the batched kernel's tiles, and matmul's narrow one) a
// thread keeps the running totals of its outputs too and adds each chunk
// sum as its chunk ends.  With more, the chunk sums meet in
// shared memory at the end of a round and each output's owner (the
// block's threads in turn, O outputs each) adds them in chunk order to
// its total: a thread then keeps a register tile of 4 x 4 or 4 x 8 (3
// shared-memory reads of 16 bytes for 32 fmaf a k) while the grid still
// has a block or two an SM at a prefill's few rows.  B's k tiles are
// Bs[k][n]; A's are As[k][m] (any strides), or with KMAJOR As[m][k],
// pitch BK + 4 (a row-major A's 16-byte vectors copied as they lie).
// With CS_SMEM (one group, one chunk) a thread keeps its chunk sums in
// shared memory (its own 16-byte slots) instead of registers: the 8 x 8
// tile's sub-chains then leave room for two blocks an SM.
template <class TL, int LANES_, bool KMAJOR, bool CS_SMEM = false>
struct F32LaneTile {
  using Tile = TL;
  static constexpr int LANES = LANES_;
  static constexpr int CS_ROWS = CS_SMEM ? TL::TM : 0;   // rows in csm
  static constexpr bool A_KMAJOR = KMAJOR;
  static constexpr int THREADS = TL::THREADS * LANES;
  static constexpr int OUTS = TL::BM * TL::BN;
  static constexpr int O = OUTS / THREADS;   // outputs an owner holds
  static constexpr int AKP = TL::BK + 4;
  static constexpr int A_FLOATS = KMAJOR ? TL::BM * AKP : TL::BK * TL::AP;
  static constexpr int STAGE = A_FLOATS + TL::BK * TL::BP;   // floats
  static constexpr int RING = LANES * TL::STAGES * STAGE;
  static constexpr int PART = LANES > 1 ? LANES * OUTS : 0;  // chunk sums
  static constexpr int CSM = CS_ROWS * TL::TN * THREADS;  // chunk sums
  static constexpr int SMEM = (RING + PART + CSM) * 4;
  static_assert(O * THREADS == OUTS, "owners");
  static_assert(!CS_SMEM || (LANES == 1 && TL::TN % 4 == 0 &&
                              (RING + PART) % 4 == 0),
                "");
};

// the tile row of a thread's i-th row of outputs
template <class LT>
__device__ __forceinline__ int f32_row(int ty, int i) {
  using TL = typename LT::Tile;
  if constexpr (LT::A_KMAJOR)
    return ty + i * (TL::BM / TL::TM);
  else
    return f32_pos<TL::TM, TL::BM>(ty, i);
}

// The tile's outputs in the f32 order, handed to ``epi``: ``load_a(as,
// k0, t)`` and ``load_b(bs, k0, t)`` issue thread t's cp.async copies
// (t < TL::THREADS, its group's index) of the k tile at k0 into As
// (f32_load, or f32_load_kmajor) and Bs[BK][BP], zeros outside the
// operands (a group past the last chunk copies nothing); epi(m, n, v)
// gets each output (tile row and column) once.  ``smem`` holds LT::SMEM
// bytes.  ONE (LANES 1): K <= kChunk, one chunk: the output is +0 plus
// its chunk sum, and no running total is kept.  On return the ring is
// free.
template <class LT, bool ONE, class LoadA, class LoadB, class Epi>
__device__ __forceinline__ void f32_lane_tile(float* smem, int K,
                                              LoadA&& load_a, LoadB&& load_b,
                                              Epi&& epi) {
  using TL = typename LT::Tile;
  constexpr int LANES = LT::LANES, OUTS = LT::OUTS, O = LT::O;
  constexpr int TM = TL::TM, TN = TL::TN, BN = TL::BN, BK = TL::BK;
  constexpr int STAGES = TL::STAGES, STAGE = LT::STAGE;
  constexpr int KT = kChunk / BK;   // k tiles a chunk
  // k a piece of a k tile: a whole tile inside one sub-chain, or one
  // sub-chain of a tile that holds several
  constexpr int PIECE = BK < kSub ? BK : kSub;
  static_assert(BK % PIECE == 0 && kSub % PIECE == 0, "");
  static_assert(!ONE || LANES == 1, "");
  const int lane = LANES == 1 ? 0 : threadIdx.x / TL::THREADS;
  const int lt = LANES == 1 ? threadIdx.x : threadIdx.x % TL::THREADS;
  const int tx = lt % TL::TX, ty = lt / TL::TX;
  const int chunks = (K + kChunk - 1) / kChunk;
  // k tiles each group walks: up to K for one group, else whole rounds
  const int nk = LANES == 1 ? (K + BK - 1) / BK
                            : (chunks + LANES - 1) / LANES * KT;
  float* ring = smem + lane * STAGES * STAGE;
  float* part = smem + LT::RING;
  // k tile j of the group: k tile j % KT of chunk (j / KT) * LANES + lane
  auto load = [&](int j) {
    float* as = ring + (j % STAGES) * STAGE;
    const int k0 = LANES == 1 ? j * BK
                              : ((j / KT) * LANES + lane) * kChunk +
                                    (j % KT) * BK;
    load_a(as, k0, lt);
    load_b(as + LT::A_FLOATS, k0, lt);
  };
  // acc: the running sub-chains (each restarted by its first product);
  // cs: the chunk sums -- with CS_SMEM the thread's 16-byte slots of csm,
  // outputs (i, 4q ..) at csm[(i * TN / 4 + q) * THREADS + threadIdx.x],
  // and ``fresh`` while the chunk's first sub-chain runs (its sum starts
  // at +0)
  constexpr int RR = TM - LT::CS_ROWS;   // rows whose sums are registers
  static_assert(RR == TM || ONE, "");
  float acc[TM][TN], cs[RR > 0 ? RR : 1][TN], tot[ONE ? 1 : O];
  float4* csm = reinterpret_cast<float4*>(smem + LT::RING + LT::PART) +
                threadIdx.x;
  auto slot = [&](int i, int jj) -> float4& {
    return csm[((i - RR) * TN / 4 + jj / 4) * LT::THREADS];
  };
  bool fresh = true;
#pragma unroll
  for (int i = 0; i < RR; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) cs[i][j] = 0.f;
  if constexpr (!ONE) {
#pragma unroll
    for (int i = 0; i < O; ++i) tot[i] = 0.f;
  }
  auto fold = [&] {   // a sub-chain ends
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (i >= RR) {
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          float4& c = slot(i, 4 * q);
          float4 v = fresh ? make_float4(0.f, 0.f, 0.f, 0.f) : c;
          v.x += acc[i][4 * q];
          v.y += acc[i][4 * q + 1];
          v.z += acc[i][4 * q + 2];
          v.w += acc[i][4 * q + 3];
          c = v;
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) cs[i][jj] += acc[i][jj];
      }
    }
    fresh = false;
  };
  // the products of k [p, p + PIECE) of the k tile at ``as``, its first
  // k (k-major: its first 4, one 16-byte read of A) a sub-chain's first
  // where ``first``: only that head is built twice
  constexpr int HEAD = LT::A_KMAJOR ? 4 : 1;
  static_assert(PIECE > HEAD, "");
  auto products = [&](const float* as, bool first, int p) {
    const float* bs = as + LT::A_FLOATS;
    if constexpr (LT::A_KMAJOR) {
      if (first)
        f32_tile_fma_kmajor<TL, LT::AKP, HEAD, true>(as, bs, ty, tx, p, acc);
      else
        f32_tile_fma_kmajor<TL, LT::AKP, HEAD, false>(as, bs, ty, tx, p,
                                                      acc);
      f32_tile_fma_kmajor<TL, LT::AKP, PIECE - HEAD, false>(
          as, bs, ty, tx, p + HEAD, acc);
    } else {
      if (first)
        f32_tile_fma<TL, HEAD, true>(as, bs, ty, tx, p, acc);
      else
        f32_tile_fma<TL, HEAD, false>(as, bs, ty, tx, p, acc);
      f32_tile_fma<TL, PIECE - HEAD, false>(as, bs, ty, tx, p + HEAD, acc);
    }
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < nk) load(j);
    tc::cp_async_commit();
  }
  for (int j = 0; j < nk; ++j) {
    tc::cp_async_wait<STAGES - 2>();   // tile j has landed
    __syncthreads();                   // ... for all; slot j-1 is free
    if (j + STAGES - 1 < nk) load(j + STAGES - 1);
    tc::cp_async_commit();
    const float* as = ring + (j % STAGES) * STAGE;
    if constexpr (BK >= kSub) {   // pieces of one sub-chain each
#pragma unroll
      for (int p = 0; p < BK; p += PIECE) {
        products(as, true, p);
        fold();
      }
    } else {   // kSub / BK k tiles a sub-chain
      products(as, j % (kSub / BK) == 0, 0);
      // the last k tile of one group ends its sub-chain too
      if ((j + 1) % (kSub / BK) == 0 || (LANES == 1 && j + 1 == nk)) fold();
    }
    if constexpr (LANES == 1) {
      if constexpr (!ONE) {
        if ((j + 1) % KT == 0 || j + 1 == nk) {   // a chunk ends
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int jj = 0; jj < TN; ++jj) {
              tot[i * TN + jj] += cs[i][jj];
              cs[i][jj] = 0.f;
            }
        }
      }
    } else if ((j + 1) % KT == 0) {   // a round ends: each group's chunk sum
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = f32_row<LT>(ty, i);
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) {
          part[lane * OUTS + m * BN + f32_pos<TN, BN>(tx, jj)] = cs[i][jj];
          cs[i][jj] = 0.f;
        }
      }
      __syncthreads();
      // the owners add the round's chunk sums in chunk order (the next
      // round writes part only after the next k tile's barrier)
      const int live = min(LANES, chunks - (j / KT) * LANES);
#pragma unroll
      for (int i = 0; i < O; ++i) {
        const int o = threadIdx.x * O + i;
        for (int l = 0; l < live; ++l) tot[i] += part[l * OUTS + o];
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();   // the ring is free for the caller
  if constexpr (LANES == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) {
        float v;
        if (i >= RR)
          v = 0.f + f4(slot(i, jj), jj % 4);
        else if constexpr (ONE)
          v = 0.f + cs[i][jj];
        else
          v = tot[i * TN + jj];
        epi(f32_row<LT>(ty, i), f32_pos<TN, BN>(tx, jj), v);
      }
  } else {
#pragma unroll
    for (int i = 0; i < O; ++i) {
      const int o = threadIdx.x * O + i;
      epi(o / BN, o % BN, tot[i]);
    }
  }
}

// (M, K) @ (K, N) row-major on a lane tile: the block at (m0, n0); A's
// rows (B's) as 16-byte vectors where ``a_vec`` (``b_vec``).  Output (m,
// n) goes to store(m, n, v) for m < M and n < N.
template <class LT, class Store>
__device__ __forceinline__ void f32_mm_tile(float* smem, const float* A,
                                            const float* B, int M, int K,
                                            int N, int m0, int n0, bool a_vec,
                                            bool b_vec, Store&& store) {
  using TL = typename LT::Tile;
  f32_lane_tile<LT, false>(
      smem, K,
      [&](float* as, int k0, int t) {
        f32_load_kmajor<TL::BM, TL::BK, TL::THREADS>(as, A, K, m0, M, k0, K,
                                                     a_vec, t);
      },
      [&](float* bs, int k0, int t) {
        f32_load<TL::BN, TL::BP, TL::BK, TL::THREADS, false>(
            bs, B, N, 1, n0, N, k0, K, b_vec, t);
      },
      [&](int m, int n, float v) {
        if (m0 + m < M && n0 + n < N) store(m0 + m, n0 + n, v);
      });
}

// -- chunk lanes ---------------------------------------------------------------
constexpr int kLaneCols = 32;                     // columns a block
constexpr int kLaneGroups = kLaneCols / 4;        // float4 groups
constexpr int kLaneMaxRows = 4;
// lanes a block (chunks at once): 16, or 32 for K of more than 16 chunks
// (a router's long K)
constexpr int kLanesFew = 16, kLanesMany = 32;

// Rows [m0, m0 + BM) of A (row-major, lda) against 32 columns of B in the
// f32 order.  Thread (lane, g) of LANES * 8 runs, for chunk r + lane of
// each round r of LANES chunks, the sub-chains of the 4 columns that
// ``col(4 * g)`` names -- a pointer to B(0, the first of them), rows ldb
// apart, or null past the matrix -- for every row, B's rows read as
// 16-byte vectors U at a time (one row: 16, the next 16 issued before the
// products of these; 2 or 4 rows: 32).  The chunk sums go to shared
// memory, where the owner of each output (thread t: outputs t * O .. t *
// O + O - 1 of the index m * 32 + c) adds them in chunk order to its
// total.  The totals end in shared memory, [BM][32], and every thread
// then calls ``epi(sums)`` (rows past M hold zeros).  A's rows as 16-byte
// vectors where ``a_vec`` (16-byte aligned rows), else element by
// element.
template <int BM, int LANES, class Col, class Epi>
__device__ __forceinline__ void f32_lanes(const float* __restrict__ A,
                                          int lda, int M, int K, int m0,
                                          bool a_vec, Col&& col, int ldb,
                                          Epi&& epi) {
  static_assert(BM >= 1 && BM <= kLaneMaxRows, "");
  static_assert(kSub % 16 == 0, "a step of U lies in one sub-chain");
  constexpr bool DOUBLE = BM == 1;
  constexpr int U = BM == 1 ? 16 : 32;
  constexpr int THREADS = LANES * kLaneGroups;
  constexpr int OUTS = BM * kLaneCols;            // a block's outputs
  constexpr int O = (OUTS + THREADS - 1) / THREADS;
  __shared__ float part[LANES][OUTS];
  const int g = threadIdx.x % kLaneGroups, lane = threadIdx.x / kLaneGroups;
  const float* bcol = col(g * 4);
  const bool col_ok = bcol != nullptr;   // a group is in or out
  const int mv = min(BM, M - m0);
  const float* Am = A + (size_t)m0 * lda;
  const int chunks = (K + kChunk - 1) / kChunk;
  auto load = [&](float4 (&bv)[U], int k) {
#pragma unroll
    for (int u = 0; u < U; ++u) bv[u] = ldg4(bcol + (size_t)(k + u) * ldb);
  };
  // the products of U values of k from k on, ascending; A by vectors
  // where it can (zeros past the block's rows)
  auto products = [&](float (&acc)[BM][4], const float4 (&bv)[U], int k) {
#pragma unroll
    for (int q = 0; q < U / 4; ++q)
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float* ap = Am + (size_t)m * lda + k + q * 4;
        float4 a4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m < mv)
          a4 = a_vec ? ldg4(ap)
                     : make_float4(__ldg(ap), __ldg(ap + 1), __ldg(ap + 2),
                                   __ldg(ap + 3));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float a = f4(a4, kk);
          const float4 b = bv[q * 4 + kk];
          acc[m][0] = fmaf(a, b.x, acc[m][0]);
          acc[m][1] = fmaf(a, b.y, acc[m][1]);
          acc[m][2] = fmaf(a, b.z, acc[m][2]);
          acc[m][3] = fmaf(a, b.w, acc[m][3]);
        }
      }
  };
  float tot[O];
#pragma unroll
  for (int i = 0; i < O; ++i) tot[i] = 0.f;
  for (int r = 0; r < chunks; r += LANES) {
    const int c = r + lane;
    // acc: the running sub-chain; cs: the chunk sum
    float acc[BM][4], cs[BM][4];
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[m][v] = cs[m][v] = 0.f;
    auto fold = [&] {
#pragma unroll
      for (int m = 0; m < BM; ++m)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          cs[m][v] += acc[m][v];
          acc[m][v] = 0.f;
        }
    };
    if (c < chunks && col_ok) {
      const int kc = c * kChunk, k1 = min(K, kc + kChunk);
      int k = kc;
      const int steps = (k1 - k) / U;
      if constexpr (DOUBLE) {
        float4 cur[U], nxt[U];
        if (steps > 0) load(cur, k);
        for (int s = 0; s < steps; ++s, k += U) {
          if (s + 1 < steps) load(nxt, k + U);
          products(acc, cur, k);
          if ((k + U - kc) % kSub == 0) fold();
#pragma unroll
          for (int u = 0; u < U; ++u) cur[u] = nxt[u];
        }
      } else {
        for (int s = 0; s < steps; ++s, k += U) {
          float4 bv[U];
          load(bv, k);
          products(acc, bv, k);
          if ((k + U - kc) % kSub == 0) fold();
        }
      }
      // the chunk's tail: fewer than U values of k, inside the sub-chain
      // the steps left open (U divides kSub)
      for (; k < k1; ++k) {
        const float4 b = ldg4(bcol + (size_t)k * ldb);
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const float a = m < mv ? __ldg(Am + (size_t)m * lda + k) : 0.f;
          acc[m][0] = fmaf(a, b.x, acc[m][0]);
          acc[m][1] = fmaf(a, b.y, acc[m][1]);
          acc[m][2] = fmaf(a, b.z, acc[m][2]);
          acc[m][3] = fmaf(a, b.w, acc[m][3]);
        }
      }
      fold();   // the chunk's last sub-chain (+0 if the steps closed it)
    }
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        part[lane][m * kLaneCols + g * 4 + v] = cs[m][v];
    __syncthreads();
    const int live = min(LANES, chunks - r);
#pragma unroll
    for (int i = 0; i < O; ++i) {
      const int o = threadIdx.x * O + i;
      if (o < OUTS)
        for (int l = 0; l < live; ++l) tot[i] += part[l][o];
    }
    __syncthreads();   // the next round overwrites part
  }
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const int o = threadIdx.x * O + i;
    if (o < OUTS) part[0][o] = tot[i];
  }
  __syncthreads();
  epi(&part[0][0]);
}

// -- a cluster per output ---------------------------------------------------------
// In each round the cluster takes kSplitCluster * kSplitRound chunks in
// order, block r the r-th run of kSplitRound; a block stages its chunks
// of A's row and B's column in shared memory (4-byte cp.async, the threads
// along k, zeros past K; rows of 257 floats, so the chains below read 32
// distinct banks), thread i runs chunk i's 8 sub-chains side by side and
// adds them in order, and thread 0 of block 0 adds the
// round's chunk sums in chunk order, reading the other blocks' shared
// memory across the cluster.
constexpr int kSplitCluster = 8;
constexpr int kSplitRound = 32;
constexpr int kSplitPitch = kChunk + 1;
constexpr int kSplitSmem = (2 * kSplitRound * kSplitPitch + kSplitRound) * 4;

// sum over k < K of a[k * sa] * b[k * sb] in the f32 order, returned on
// thread 0 of the cluster's block 0 (kThreads threads a block; ``ssm``
// holds kSplitSmem bytes)
__device__ __forceinline__ float f32_split_sum(const float* a, long long sa,
                                               const float* b, long long sb,
                                               int K, float* ssm) {
  namespace cg = cooperative_groups;
  float* sa_ = ssm;
  float* sb_ = sa_ + kSplitRound * kSplitPitch;
  float* part = sb_ + kSplitRound * kSplitPitch;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int chunks = (K + kChunk - 1) / kChunk;
  constexpr int kPerRound = kSplitCluster * kSplitRound;
  float tot = 0.f;
  for (int g = 0; g < chunks; g += kPerRound) {
    const int c0 = g + rank * kSplitRound;
    const int nc = max(0, min(kSplitRound, chunks - c0));
    for (int e = threadIdx.x; e < nc * kChunk; e += kThreads) {
      const int i = e / kChunk, kk = e % kChunk;
      const int k = (c0 + i) * kChunk + kk;
      const bool ok = k < K;
      cp_async4(sa_ + i * kSplitPitch + kk, ok ? a + k * sa : a, ok);
      cp_async4(sb_ + i * kSplitPitch + kk, ok ? b + k * sb : b, ok);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    if (threadIdx.x < nc) {
      // the chunk's sub-chains side by side, one k of each a step (the
      // staged zeros past K change no bit), then added in order
      const float* x = sa_ + threadIdx.x * kSplitPitch;
      const float* y = sb_ + threadIdx.x * kSplitPitch;
      constexpr int S = kChunk / kSub;
      float acc[S];
#pragma unroll
      for (int c = 0; c < S; ++c) acc[c] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < kSub; ++kk)
#pragma unroll
        for (int c = 0; c < S; ++c)
          acc[c] = fmaf(x[c * kSub + kk], y[c * kSub + kk], acc[c]);
      float cs = 0.f;
#pragma unroll
      for (int c = 0; c < S; ++c) cs += acc[c];
      part[threadIdx.x] = cs;
    }
    cluster.sync();   // every block's chunk sums are in place
    if (rank == 0 && threadIdx.x == 0) {
      for (int r = 0; r < kSplitCluster; ++r) {
        const int nr = max(0, min(kSplitRound, chunks - (g + r * kSplitRound)));
        const float* p = cluster.map_shared_rank(part, r);
        for (int i = 0; i < nr; ++i) tot += p[i];
      }
    }
    cluster.sync();   // ... and read: the next round may overwrite them
  }
  return tot;
}

// -- matmul's f32 arrangement (mirrored by kernels/ops.py:matmul_plan) --------------
// (M, K) @ (K, N) row-major: a cluster per output for at most
// kMatmulSplitOutputs outputs over K >= kSplitMinK (a router's few
// experts at decode); chunk lanes for at most kLaneMaxRows rows (decode:
// 1, 2 or 4 a block; 32 lanes past 16 chunks); else a register
// tile: 32 x 8 for N <= 8 (a router's experts, one group),
// 32 x 32 with 4 x 4 a thread and 8 groups up to 32 rows, 32 x 64 with 4
// x 8 a thread and 4 groups beyond (two blocks an SM: 2 stages), so a
// prefill's 32 to 128 rows still put a block or two on every SM.
constexpr int kSplitMinK = 8 * kChunk;
constexpr long long kMatmulSplitOutputs = 64;

struct F32Split {};
template <int BM, int LANES>
struct F32Lanes {};
template <class LT>
struct F32Tiles {};

using F32Narrow = F32LaneTile<F32Tile<32, 8, 1, 1, 32, 256, 3>, 1, true>;
using F32L32x32 = F32LaneTile<F32Tile<32, 32, 4, 4, 32, 64, 2>, 8, true>;
using F32L32x64 = F32LaneTile<F32Tile<32, 64, 4, 8, 16, 64, 2>, 4, true>;

template <class F>
cudaError_t with_f32_matmul(int M, int K, int N, F&& f) {
  if (K >= kSplitMinK && (long long)M * N <= kMatmulSplitOutputs)
    return f(F32Split());
  if (M <= kLaneMaxRows) {
    const bool many = K > kLanesFew * kChunk;
    if (M <= 1)
      return many ? f(F32Lanes<1, kLanesMany>()) : f(F32Lanes<1, kLanesFew>());
    if (M <= 2)
      return many ? f(F32Lanes<2, kLanesMany>()) : f(F32Lanes<2, kLanesFew>());
    return many ? f(F32Lanes<4, kLanesMany>()) : f(F32Lanes<4, kLanesFew>());
  }
  if (N <= 8) return f(F32Tiles<F32Narrow>());
  if (M <= 32) return f(F32Tiles<F32L32x32>());
  return f(F32Tiles<F32L32x64>());
}

// Whether the blocks of an f32 matmul launch, had they started early as a
// programmatic dependent, would sit two to an SM on part of the card:
// the 32 x 64 register tile (two blocks an SM) with no more blocks than
// SMs.  Measured on the H100, a 64-row product launched at its producer's
// start ran at half the card; at 4, 32 and 128 rows an early launch
// measured faster.
template <class A>
bool f32_packs(A, int, int, int) {
  return false;
}
inline bool f32_packs(F32Tiles<F32L32x64>, int M, int N, int sms) {
  using TL = F32L32x64::Tile;
  return (long long)((M + TL::BM - 1) / TL::BM) * ((N + TL::BN - 1) / TL::BN)
         <= sms;
}

// the current device's SM count
inline cudaError_t f32_sm_count(int* sms) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// a kernel's dynamic shared-memory limit, raised once per device
template <class K>
cudaError_t f32_smem_limit(PerDevice& table, K kernel, int bytes) {
  return once_per_device(table, [&] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  });
}

// -- matmul's f32 launch ----------------------------------------------------------
// f32 (M, K) @ (K, N) row-major into C: one launch, in the arrangement
// with_f32_matmul picks, of the kernels below.  matmul.cu's f32 route
// runs it, and so do swiglu's f32 down product (on h) and norm_matmul's
// f32 product (on the normalised rows), each as the programmatic
// dependent of the kernel that writes its A (DEPENDENT): such a launch
// may start while that kernel runs, and reads nothing before
// griddepcontrol.wait, which returns once that kernel has ended.  So the
// three give bit for bit matmul's output on the same A.  ``Tag`` (an
// empty type in the calling source's anonymous namespace) names the
// kernels in a profile -- the caller's wrapper counts them -- and gives
// each source its own instantiations.
template <bool WAIT>
__device__ __forceinline__ void f32_wait() {
  if constexpr (WAIT) asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

template <class Tag, class LT, bool WAIT>
__global__ void __launch_bounds__(LT::THREADS)
    f32_mm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ C, int M, int K, int N, bool a_vec,
                  bool b_vec) {
  using TL = typename LT::Tile;
  extern __shared__ __align__(16) float fsm[];
  f32_wait<WAIT>();
  f32_mm_tile<LT>(fsm, A, B, M, K, N, blockIdx.y * TL::BM,
                  blockIdx.x * TL::BN, a_vec, b_vec,
                  [&](int m, int n, float v) { C[(size_t)m * N + n] = v; });
}

template <class Tag, int BM, int LANES, bool WAIT>
__global__ void __launch_bounds__(LANES * kLaneGroups)
    f32_mm_lanes_kernel(const float* __restrict__ A,
                        const float* __restrict__ B, float* __restrict__ C,
                        int M, int K, int N, bool a_vec) {
  f32_wait<WAIT>();
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kLaneCols;
  f32_lanes<BM, LANES>(
      A, K, M, K, m0, a_vec,
      [&](int c) -> const float* { return n0 + c < N ? B + n0 + c : nullptr; },
      N, [&](const float* sums) {
        for (int o = threadIdx.x; o < BM * kLaneCols;
             o += LANES * kLaneGroups) {
          const int m = o / kLaneCols, n = o % kLaneCols;
          if (m0 + m < M && n0 + n < N)
            C[(size_t)(m0 + m) * N + n0 + n] = sums[o];
        }
      });
}

template <class Tag, bool WAIT>
__global__ void __cluster_dims__(kSplitCluster, 1, 1)
    __launch_bounds__(kThreads)
        f32_mm_split_kernel(const float* __restrict__ A,
                            const float* __restrict__ B,
                            float* __restrict__ C, int M, int K, int N) {
  extern __shared__ __align__(16) float ssm[];
  f32_wait<WAIT>();
  const int o = blockIdx.x / kSplitCluster;
  const int m = o / N, n = o % N;
  const float tot = f32_split_sum(A + (size_t)m * K, 1, B + n, N, K, ssm);
  if (blockIdx.x % kSplitCluster == 0 && threadIdx.x == 0)
    C[(size_t)m * N + n] = tot;
}

// ``kern`` on ``s``, as the programmatic dependent of the kernel before
// it where DEP
template <bool DEP, typename... P, typename... Args>
cudaError_t f32_launch(void (*kern)(P...), dim3 grid, int threads, int smem,
                       cudaStream_t s, Args... args) {
  if constexpr (DEP)
    return launch_pdl(kern, grid, dim3(threads), smem, s, args...);
  kern<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <class Tag, bool DEP>
cudaError_t f32_mm_launch(F32Split, const float* A, const float* B, float* C,
                          int M, int K, int N, cudaStream_t s) {
  auto kern = f32_mm_split_kernel<Tag, DEP>;
  static PerDevice limit_set;
  const cudaError_t limit = f32_smem_limit(limit_set, kern, kSplitSmem);
  if (limit != cudaSuccess) return limit;
  return f32_launch<DEP>(kern, dim3((unsigned)(M * N * kSplitCluster)),
                         kThreads, kSplitSmem, s, A, B, C, M, K, N);
}

template <class Tag, bool DEP, int BM, int LANES>
cudaError_t f32_mm_launch(F32Lanes<BM, LANES>, const float* A,
                          const float* B, float* C, int M, int K, int N,
                          cudaStream_t s) {
  const dim3 grid((N + kLaneCols - 1) / kLaneCols, (M + BM - 1) / BM);
  return f32_launch<DEP>(f32_mm_lanes_kernel<Tag, BM, LANES, DEP>, grid,
                         LANES * kLaneGroups, 0, s, A, B, C, M, K, N,
                         aligned16(A) && K % 4 == 0);
}

template <class Tag, bool DEP, class LT>
cudaError_t f32_mm_launch(F32Tiles<LT>, const float* A, const float* B,
                          float* C, int M, int K, int N, cudaStream_t s) {
  using TL = typename LT::Tile;
  auto kern = f32_mm_kernel<Tag, LT, DEP>;
  static PerDevice limit_set;
  const cudaError_t limit = f32_smem_limit(limit_set, kern, LT::SMEM);
  if (limit != cudaSuccess) return limit;
  const dim3 grid((N + TL::BN - 1) / TL::BN, (M + TL::BM - 1) / TL::BM);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  return f32_launch<DEP>(kern, grid, LT::THREADS, LT::SMEM, s, A, B, C, M, K,
                         N, aligned16(A) && K % 4 == 0,
                         aligned16(B) && N % 4 == 0);
}

template <class Tag, bool DEPENDENT>
cudaError_t f32_matmul(const float* A, const float* B, float* C, int M, int K,
                       int N, cudaStream_t s) {
  return with_f32_matmul(M, K, N, [&](auto arrangement) {
    return f32_mm_launch<Tag, DEPENDENT>(arrangement, A, B, C, M, K, N, s);
  });
}

}  // namespace repro
