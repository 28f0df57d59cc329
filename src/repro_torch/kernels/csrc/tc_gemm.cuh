// Tensor-core GEMM mainloop for Hopper, shared by the port's 16-bit GEMM
// kernels: one block computes a BM x BN tile of A (M, K) @ B (K, N), A and
// B bf16 or f16, with the products on the tensor cores
// (mma.sync.aligned.m16n8k16, f32 accumulators) and B and A streamed
// through shared memory by a ring of cp.async stages.
//
// Why mma.sync and not wgmma: at the serving shapes (M = 1, 4, 64) the
// product does at most 64 flops per byte of B, far below the ~295 at which
// the tensor cores bind, so what has to be fast is the stream of B, not
// the multiply; m16n8k16 pads decode's rows to 16 instead of wgmma's 64
// and needs no descriptors.  Where the multiply binds (matmul above 96
// rows, the batched kernel's training tiles) wg_gemm.cuh runs this same
// order with wgmma: one k16 step of wgmma m64nNk16 rounds bit for bit as
// one of mma.sync m16n8k16 (kernels/wgmma_probe.py, on an H100: 2^27
// outputs, bf16 and f16, every operand layout, equal), so the order's
// chains are the same sums on either instruction.
//
// Layout.  The block is 256 threads (8 warps) and owns a BM x BN output
// tile (Tile below).  A stage holds kKS = 256 values of k: B[kKS][BN] and
// A[BM][kKS], their 16-byte chunks XOR-swizzled by the row so that every
// ldmatrix phase reads 8 distinct bank quads; B's fragments come from
// ldmatrix.trans (B is row-major (K, N)).  Ragged rows of A, columns of B
// (N % 8 == 0) and the K tail are zero-filled by the copy, so they add
// exact zeros, and padding rows are never stored.  A is copied with
// 16-byte cp.async when its rows are 16-byte aligned (lda % 8 == 0), else
// element by element.
//
// Reduction order, fixed by K alone.  Warp w owns k in [s*256 + 32w,
// s*256 + 32w + 32) of every stage s: two m16n8k16 steps, in ascending k,
// accumulated into its own registers across the stages in ascending s.
// After the sweep the 8 warp partials are summed in shared memory in warp
// order 0..7.  The tile, the ring depth, M, N, a row's position in its
// tile, the grid and the run change none of it: no split of K across
// blocks, no atomics.  So a row of A gives bitwise the same output alone
// or inside any batch.  (Splitting K across warps keeps eight independent
// mma chains in flight per block, which is what the small-M cases need.)
//
// A transform.  gemm_tc takes an optional functor applied to A on its way
// into the products (the fused norm of norm_matmul.cu scales each element
// by its row's inverse RMS and g[k], rounding to A's dtype).  A 16-byte
// aligned A still arrives raw by cp.async; each warp rewrites the A
// fragments it has just read with ldmatrix, in registers, so every
// element is transformed once per block, off the copy ring's critical
// path and with no shared-memory round trip.  An unaligned A is
// transformed as it is loaded.  The default, IdentityA, compiles to the
// plain GEMM.
//
// B source and prologue order.  gemm_tc's last template parameter (the
// default, PlainB, is the plain GEMM) may ask for
//   - a paired B (kPair): the tile's columns [0, BN/2) are columns
//     [n0, n0 + BN/2) of B, its columns [BN/2, BN) the same columns of a
//     second (K, N) matrix B2, so one pass of A's fragments feeds two
//     products (swiglu.cu's gate and up).  Only the copy's source
//     changes: the swizzle, the fragments and the K order are the plain
//     GEMM's.
//   - A after the primary grid (kWaitA): A is written by the kernel this
//     one is a programmatic dependent launch of.  The prologue puts B's
//     first stages in flight, waits for that kernel (griddepcontrol.wait)
//     and only then copies A.
//   - strided operands (kStrided): the policy object's ``load(slot, s)``
//     fills stage s of the ring slot itself -- B's [kKS][BN] and then A's
//     [BM][kKS] in the plain GEMM's swizzled layout, zero outside the
//     matrices -- from operands read through any strides
//     (batched_matmul.cu).  Only the copy changes: the fragments and the
//     K order are the plain GEMM's.  A strided source with K below one
//     stage skips the warps whose k slice lies past K (their partials
//     would be exact zeros, and adding them changes no bit), so it need
//     copy only the rows up to 32 * ceil(K / 32).
#pragma once

#include "common.cuh"

namespace repro {
namespace tc {

constexpr int kKS = 256;                   // k per ring stage
constexpr int kWarpK = kKS / kWarps;       // k per warp per stage (32)

// A block's tile: BM x BN outputs and a ring of STAGES stages.  None of it
// changes the reduction order, so each caller picks what suits its shape.
template <int BM_, int BN_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_;
  static constexpr int MF = BM / 16, NF = BN / 8;    // mma fragments
  static constexpr int STAGE = kKS * BN + BM * kKS;  // elements per stage
  static constexpr int RED_PITCH = BN + 8;           // f32 epilogue pitch
  // shared-memory bytes: the ring, or the epilogue's warp partials that
  // reuse it (mirrored by kernels/ops.py:tc_smem_bytes)
  static constexpr int RING = STAGES * STAGE * 2;
  static constexpr int RED = kWarps * BM * RED_PITCH * 4;
  static constexpr int SMEM = RING > RED ? RING : RED;
  static_assert(BM % 16 == 0 && (BN == 32 || BN == 64 || BN == 128), "");
  static_assert(STAGES >= 3, "ring");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with ``valid`` false nothing is read and the
// destination is filled with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// the same, with an L2 cache policy for the source
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid, uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0), "l"(policy));
}
// L2 policies for a copy's source.  evict_first makes the lines it brings
// in the first to be evicted: a weight streamed once then leaves the rest
// of L2 (activations, and dirty lines that would have to be written back)
// in place.  evict_normal is L2's default.
__device__ __forceinline__ uint64_t l2_policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_policy_evict_normal() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16x8 f32) += a (16x16, row) @ b (16x8, col)
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(
    float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The identity A transform (the plain GEMM).  A transform class has
// kIdentity = false and provides
//   void prepare() const            -- run by every thread once, before
//                                      stage 0 is multiplied; ends with
//                                      a block barrier
//   T operator()(T a, int m, int k) const      -- one element, row m of
//                                                 the tile, column k
//   void load(int s) const          -- cp.async of what stage s's
//                                      fragments read besides A, in the
//                                      stage's copy group
//   void frag(unsigned (&a)[4], int m, int k, int s) const
//                                   -- an m16k16 A fragment of rows m..,
//                                      columns k.. of stage s, in place
struct IdentityA {
  static constexpr bool kIdentity = true;
};

// Element offset of 16-byte chunk ``c`` of row ``r`` in a stage whose
// rows hold W elements: the chunk is XOR-swizzled so that 8 consecutive
// rows at one logical chunk lie in 8 distinct bank quads.
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  return r * W + ((W == 32 ? c ^ ((r >> 1) & 3) : c ^ (r & 7)) << 3);
}

// B's source and the prologue's order (see the header).
struct PlainB {
  static constexpr bool kPair = false, kWaitA = false, kStrided = false;
};
struct PairB {
  static constexpr bool kPair = true, kWaitA = false, kStrided = false;
};
struct WaitA {
  static constexpr bool kPair = false, kWaitA = true, kStrided = false;
};

// Copy stage ``s`` (k from s * KS) of B's columns [n0, n0 + BN) into
// ``bs`` (paired: BN/2 columns of B, then the same of B2); everything
// outside the matrix is zero.
template <typename T, class TL, class BX>
__device__ __forceinline__ void load_b(T* bs, const T* B, const T* B2, int K,
                                       int N, int n0, int s,
                                       uint64_t b_policy) {
  constexpr int BN = TL::BN, KS = kKS;
  constexpr int CB = BN / 8;                     // 16-byte chunks per row
  constexpr int HALF = BX::kPair ? CB / 2 : CB;  // chunks per source
  static_assert(KS * CB % kThreads == 0, "");
  const int k0 = s * KS;
#pragma unroll
  for (int i = 0; i < KS * CB / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int k = e / CB, c = e % CB;
    const int cn = BX::kPair ? c % HALF : c;     // chunk in its source
    const T* src = BX::kPair && c >= HALF ? B2 : B;
    const bool ok = k0 + k < K && n0 + cn * 8 < N;
    cp_async16(bs + swz<BN>(k, c),
               ok ? src + (size_t)(k0 + k) * N + n0 + cn * 8 : B, ok,
               b_policy);
  }
}

// Copy stage ``s`` of A's rows [m0, m0 + BM) into ``as``; everything
// outside the matrix is zero.  An unaligned A goes through ``ax`` as it
// is loaded.
template <typename T, class TL, class AX = IdentityA>
__device__ __forceinline__ void load_a(T* as, const T* A, int lda, int M,
                                       int K, int m0, int s, bool a_vec,
                                       const AX& ax = AX()) {
  constexpr int BM = TL::BM, KS = kKS;
  constexpr int CA = KS / 8;   // 16-byte chunks per row
  static_assert(BM * CA % kThreads == 0, "");
  const int k0 = s * KS;
  if (a_vec) {
#pragma unroll
    for (int i = 0; i < BM * CA / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int m = e / CA, c = e % CA;
      const bool ok = m0 + m < M && k0 + c * 8 < K;
      cp_async16(as + swz<KS>(m, c),
                 ok ? A + (size_t)(m0 + m) * lda + k0 + c * 8 : A, ok);
    }
    if constexpr (!AX::kIdentity) ax.load(s);
  } else {   // rows of A not 16-byte aligned: plain loads and stores
    for (int e = threadIdx.x; e < BM * KS; e += kThreads) {
      const int m = e / KS, k = e % KS;
      const bool ok = m0 + m < M && k0 + k < K;
      if constexpr (AX::kIdentity) {
        as[swz<KS>(m, k >> 3) + (k & 7)] =
            ok ? A[(size_t)(m0 + m) * lda + k0 + k] : from_f32<T>(0.f);
      } else {
        as[swz<KS>(m, k >> 3) + (k & 7)] =
            ok ? ax(A[(size_t)(m0 + m) * lda + k0 + k], m, k0 + k)
               : from_f32<T>(0.f);
      }
    }
  }
}

// The mainloop.  On return the block's BM x BN sums lie in shared memory
// (f32, row pitch TL::RED_PITCH) at the returned pointer and the block is
// synchronised; ``smem`` is the dynamic shared memory of TL::SMEM bytes.
// ``b_first``: B's lines are the first L2 evicts (a weight read once).
// ``ax``: the A transform; ``BX``: B's source and the prologue's order,
// ``B2`` the second matrix of a paired B, ``bx`` a strided source's
// loader (see the header).
template <typename T, class TL, class AX = IdentityA, class BX = PlainB>
__device__ __forceinline__ float* gemm_tc(const T* __restrict__ A, int lda,
                                          const T* __restrict__ B, int M,
                                          int K, int N, int m0, int n0,
                                          bool b_first, unsigned char* smem,
                                          const AX& ax = AX(),
                                          const T* __restrict__ B2 = nullptr,
                                          const BX& bx = BX()) {
  constexpr int MF = TL::MF, NF = TL::NF, BN = TL::BN;
  constexpr int STAGES = TL::STAGES, STAGE = TL::STAGE;
  constexpr int PITCH = TL::RED_PITCH;
  T* ring = reinterpret_cast<T*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nst = (K + kKS - 1) / kKS;
  // warps whose k slices hold data: all of them, but for a strided
  // source whose K is under one stage (see the header)
  const int live = BX::kStrided && K < kKS ? (K + kWarpK - 1) / kWarpK
                                           : kWarps;
  const bool a_vec = (lda & 7) == 0;
  const uint64_t b_policy = b_first ? l2_policy_evict_first()
                                    : l2_policy_evict_normal();

  float acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  // an unaligned A is transformed as it is loaded: prepare first
  if constexpr (!AX::kIdentity) {
    if (!a_vec) ax.prepare();
  }
  if constexpr (BX::kWaitA) {
    // B's first stages in flight, then the wait for A's writer; commit
    // group s holds A's stage s (group 0 also every B stage of this
    // prologue), so the mainloop's count of groups is unchanged
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s)
      if (s < nst)
        load_b<T, TL, BX>(ring + s * STAGE, B, B2, K, N, n0, s, b_policy);
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nst)
        load_a<T, TL, AX>(ring + s * STAGE + kKS * BN, A, lda, M, K, m0, s,
                          a_vec, ax);
      cp_async_commit();
    }
  } else {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nst) {
        if constexpr (BX::kStrided) {
          bx.load(ring + s * STAGE, s);
        } else {
          load_b<T, TL, BX>(ring + s * STAGE, B, B2, K, N, n0, s, b_policy);
          load_a<T, TL, AX>(ring + s * STAGE + kKS * BN, A, lda, M, K, m0,
                            s, a_vec, ax);
        }
      }
      cp_async_commit();
    }
  }
  // an aligned A: prepare while the first stages are in flight
  if constexpr (!AX::kIdentity) {
    if (a_vec) ax.prepare();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<STAGES - 2>();    // stage s has landed
    __syncthreads();                // ... for every thread; slot s-1 free
    const int nxt = s + STAGES - 1;
    if (nxt < nst) {
      T* slot = ring + (nxt % STAGES) * STAGE;
      if constexpr (BX::kStrided) {
        bx.load(slot, nxt);
      } else {
        load_b<T, TL, BX>(slot, B, B2, K, N, n0, nxt, b_policy);
        load_a<T, TL, AX>(slot + kKS * BN, A, lda, M, K, m0, nxt, a_vec, ax);
      }
    }
    cp_async_commit();
    const T* bs = ring + (s % STAGES) * STAGE;
    const T* as = bs + kKS * BN;
    if (warp >= live) continue;   // uniform in the warp; no barrier below
#pragma unroll
    for (int ks = 0; ks < kWarpK / 16; ++ks) {
      const int k = warp * kWarpK + ks * 16;
      // B: NF n8 fragments of k16, two per ldmatrix.x4.trans
      unsigned b[NF / 2][4];
#pragma unroll
      for (int h = 0; h < NF / 2; ++h) {
        const int kr = k + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = h * 2 + (lane >> 4);
        ldmatrix_x4_trans(b[h], bs + swz<BN>(kr, c));
      }
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        unsigned a[4];
        const int mr = i * 16 + (lane & 15);
        ldmatrix_x4(a, as + swz<kKS>(mr, (k >> 3) + (lane >> 4)));
        if constexpr (!AX::kIdentity) {
          if (a_vec) ax.frag(a, i * 16, k, s);
        }
#pragma unroll
        for (int j = 0; j < NF; ++j)
          mma16816<T>(acc[i][j], a, b[j >> 1][(j & 1) * 2],
                      b[j >> 1][(j & 1) * 2 + 1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the warp partials reuse it

  float* red = reinterpret_cast<float*>(smem);
  const int r = lane >> 2, q = (lane & 3) * 2;
  if (warp < live) {
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        float* p = red + (warp * TL::BM + i * 16 + r) * PITCH + j * 8 + q;
        *reinterpret_cast<float2*>(p) =
            make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(p + 8 * PITCH) =
            make_float2(acc[i][j][2], acc[i][j][3]);
      }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TL::BM * BN; e += kThreads) {
    const int m = e / BN, n = e % BN;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < live; ++w) sum += red[(w * TL::BM + m) * PITCH + n];
    red[m * PITCH + n] = sum;   // (m, n) is this thread's alone
  }
  __syncthreads();
  return red;
}

// Host side.  A B of up to 256 MB (every weight of the serving path but
// the unembed) streams as L2's first victims; a larger one gains nothing
// from it.
inline bool b_evict_first(size_t b_bytes) { return b_bytes <= (256u << 20); }

// matmul's tensor-core tiles for an (M, K) @ (K, N) product, mirrored by
// kernels/ops.py:tc_tile: matmul's own up to 96 rows (above them, where
// A's rows are whole 16-byte vectors, matmul.cu takes wg_gemm.cuh's
// mainloop), and at every M those of the GEMMs that share its launch
// (norm_matmul.cu's, swiglu.cu's down product).  Up to 16 rows: 32
// columns a block (128 blocks at N = 4096), or 128 where N is wide enough
// (N >= 8192: the unembed, 800 blocks) for 256-byte rows of B to stream
// faster; up to 64 rows, one 64-row tile of 32 columns; more rows, 64 x 64
// tiles, which halve the re-reads of A from L2 (three stages fit 227 KB).
// Returns ``launch(tile)`` for a value of the tile's type.
template <class F>
auto with_matmul_tile(int M, int N, F&& launch) {
  if (M <= 16)
    return N >= 8192 ? launch(Tile<16, 128, 3>()) : launch(Tile<16, 32, 4>());
  if (M <= 64) return launch(Tile<64, 32, 4>());
  return launch(Tile<64, 64, 3>());
}

}  // namespace tc
}  // namespace repro
