// Flash attention for Hopper: out (B, Hq, Sq, Dv) = softmax(q k^T * scale
// + mask) v, with an online softmax over KV tiles.  q (B, Hq, Sq, Dk),
// k (B, Hkv, Skv, Dk), v (B, Hkv, Skv, Dv), out in q's dtype (f32, bf16
// or f16).  Query head h reads kv head h / (Hq / Hkv) (GQA, MQA) without
// repeating heads.  Scores are q.k * scale in f32; the mask is causal
// and/or a sliding window on absolute positions (query i at i + q_offset,
// key j at j; masked scores -1e30); the running max, sum and accumulator
// are f32, as in the Pallas kernel.  A row that sees no key gives exactly
// 0.  Dv may differ from Dk; head widths up to 256.
//
// Replaces: src/repro/kernels/flash_attention.py:_flash_kernel.
//
// Bound on the H100: bytes at the serving shapes.  Decode (Sq 1) reads
// each visible K and V row once for one query row: ~1 flop per byte, so
// the bytes of K and V up to the query's position bound it (4 slots x 32
// heads x 256 keys x 128 x 2 B x 2 = 16.8 MB, ~5 us at 3.35 TB/s).  A
// 128-token prefill of 4 prompts moves 16.8 MB and does 0.54 GFLOP under
// the causal mask (0.55 us on the tensor cores): the bytes again.  So the
// kernel has to keep the K/V stream in flight and must not let the
// arithmetic (CUDA-core FMAs, a shared-memory round trip for the scores,
// accurate exponentials, divisions) become the bottleneck.
//
// Design, bf16 and f16: two routes on one order (kernels/ops.py:
// flash_16_order), chosen by kernels/ops.py:flash_plan, which the
// wrapper hands the route.
//
// The order.  A row's keys fall into chunks of kChunk (512) keys by
// absolute key index.  Inside a chunk the row's state (max m, sum l,
// unnormalised accumulator acc, all f32) runs from empty over the chunk's
// 64-key tiles in ascending order: scores summed over d in ascending k16
// steps, each tile's max and sum over the thread's 16 values in order,
// then over the quad of lanes that share the row in one shuffle order,
// p.V over the tile's keys in ascending k16 steps as hi then lo.  The
// chunks' states merge into the running state in ascending order
// (merge_scales: a chunk the row saw no key of is a no-op, merging into
// the empty state is a copy, else both scale to the larger max), and out
// = acc * (1 / l).  None of it depends on B, Sq, the query tile, the
// row's place in it, the column split, the grid or the run; a tile or a
// chunk that is fully masked for a row, run or skipped, is an exact
// no-op for it.  So decode at position p gives row p of the causal
// prefill bit for bit, and a row whose visible keys lie in one chunk
// gets the bits of the unchunked order.  No atomics.
//
// mma.sync route (FA2's layout on mma.sync.m16n8k16; every one-slot
// decode, and prefills below ops.FLASH_WG_MIN_SQ rows):
// - Blocks of 4 warps, one per (query-row tile, chunk, head, batch row).
//   Each warp owns 16 query rows: prefill tiles are 64 rows (32 rows and
//   two column halves per warp pair for heads wider than 128, so the
//   accumulators stay in registers).  Sq <= 16 uses one 16-row fragment
//   (padding rows zero, never stored): the 4 warps split the output
//   columns, and each computes a quarter of the tile's scores, which they
//   exchange through shared memory; where the launch has few blocks, 2
//   or 4 blocks split a tile's columns (each reads K and its share of
//   V).  At decode (Sq 1) the fragment's rows are the rep query heads
//   that share a kv head, so K and V are read once for all of them.
// - Split by chunk: a block walks one chunk's tiles (the grid's x holds
//   ceil(Skv / kChunk) chunks a row tile, so a CUDA graph captures a
//   fixed grid, and a block whose chunk no row of it sees exits at once).
//   With one chunk it writes the output; else it writes its rows' chunk
//   states (m, l, acc) to a workspace and flash_combine_kernel merges
//   each row's chunks in ascending order -- a one-slot decode over 4,096
//   keys runs 8 blocks a kv head instead of 1.
// - Scores on the tensor cores: S = Q K^T with Q's fragments (ldmatrix)
//   and the 16 x 64 scores of a tile in registers; K fragments by
//   ldmatrix from shared memory.  The scores are scaled into log2 units
//   so each exponential is one SFU ex2 (~2 ulp); a tile the mask leaves
//   whole for the warp's rows skips the mask, and a fragment half that
//   holds only padding rows skips the softmax.  No shared-memory round
//   trip for S and no block barrier between scores, softmax and p.V.
// - p.V on the tensor cores with p at f32 precision: p goes from the
//   score registers straight into A fragments split as hi = T(p) and lo =
//   T(p - hi), two mma into the same f32 accumulator.  Rounding p to 16
//   bits alone would be attention_ref's function (p cast to v's dtype),
//   not the Pallas kernel's f32 p.V; hi + lo keeps p to ~2^-16 relative
//   in bf16.
// - A ring of 64-key K and V tiles (4 stages; 3 for heads over 128 and
//   for decode at width 128, so two decode blocks share an SM; at most as
//   many as the cache has tiles) filled by 16-byte cp.async, all stages
//   in flight from the start and each refilled as soon as its tile is
//   done.  Rows are padded by 16 bytes so ldmatrix hits distinct banks;
//   head widths that are no multiple of 16 are zero-padded in shared
//   memory.
// - Tiles are skipped by the causal and window limits of the block's
//   rows (the Pallas kernel's pl.when(run)), and a warp skips a tile its
//   own rows cannot see; q_offset is read on the device (the decode
//   position is a carry of the fused chunk and never crosses to the
//   host).
//
// wgmma route (prefills of ops.FLASH_WG_MIN_SQ rows and more, in the
// head-width classes of kernels/ops.py:FLASH_WG_CLASSES): FA3's shape.
// - A block is a producer warpgroup and NC consumer warpgroups of 64
//   query rows each (2; 1 for 256-wide heads, whose accumulators take 128
//   registers a thread); a work item is (row tile, head, batch row), the
//   last row tiles first.  With 2 consumers blocks are persistent (one an
//   SM, walking the items), and the producer loads the next item's Q into
//   a second buffer while the consumers finish this one; with 1, a block
//   takes one item.  One producer thread copies the Q tiles and a ring of
//   64-key K and V tiles by TMA (boxes of 64 rows x 128 bytes under the
//   128-byte swizzle, a "full" and an "empty" mbarrier a stage; keys past
//   Skv, rows past Sq and columns past the head width land as zeros); GQA
//   reads kv head h / (Hq / Hkv) through the maps' slice index.
// - In a consumer, tile j's scores are issued, then tile j - 1's p.V, and
//   tile j's softmax runs while that p.V does (FA3's overlap); the two
//   consumers take turns to issue their products (named barriers), so one
//   runs its softmax while the other's products run.
// - S = Q K^T on wgmma m64n64k16 from shared memory (both K-major), in
//   ascending k16 steps over d; its accumulator fragment is mma.sync's
//   warp by warp, so the softmax is the mma.sync route's code, row max
//   and sum in the same thread-then-quad order.  p.V is wgmma's register
//   form: p's hi and lo fragments straight from the score registers, V
//   MN-major from shared memory, m64n64k16 or m64n128k16 per 64 or 128
//   output columns, hi then lo in each ascending k16 step, into the f32
//   accumulators.  wgmma's k16 step rounds as mma.sync's, from zeroed and
//   from loaded accumulators, in both forms (kernels/wgmma_probe.py), so
//   this route gives the mma.sync route's bits.
// - Chunks merge inside the block: at each chunk boundary a consumer
//   folds its chunk state into a running state whose accumulators it
//   keeps in shared memory, a slot a thread (only where Skv > kChunk).
// - setmaxnreg gives the consumers the producer's registers.
// Its rows give the mma.sync route's bits (chip_smoke.py's phase 3 holds
// the routes to each other).
// Design, f32 (CUDA cores, FMA in f32: no TF32, no 3xTF32 split; f32
// doubles the bytes, so decode at position 255 reads 33.6 MB, ~10 us):
// - Blocks of 4 warps; each warp owns 1, 2 or 4 consecutive block rows
//   (query rows, or at decode the rep query heads that share a kv head,
//   so K and V are read once for all of them).  The most rows a warp
//   that still leaves a block an SM, so a short prompt fills the card.
// - A ring of 64-key K and V tiles, every stage in flight from the start
//   (as many as the SM's shared memory holds for the blocks it runs, 1 to
//   4), copied by the TMA unit from tensor maps in boxes of 32 keys x 128
//   bytes with the 128-byte swizzle, in four groups -- K's first and
//   second 32 keys, then V's -- each completing its own mbarrier, so a
//   warp computes on a tile's first keys while the rest land and waits
//   for nothing else.  (Copies of a row each, 512 bytes, streamed at half
//   the rate from L2.)
// - Scores in registers: lane l holds keys l and l + 32 of the tile for
//   each of its warp's rows; K is read as float4 from the swizzled boxes
//   (8 lanes, 8 rows, 8 distinct bank quads) and Q as a broadcast float4.
//   Each row's max and sum: the lane's two keys, then the warp in one
//   shuffle-xor order.  The exponentials are SFU ex2 (~2 ulp) on scores in
//   log2 units.  p goes from registers into p.V by shuffles, where lane l
//   owns output columns 4l..4l+3 (and 128 more past width 128) of every
//   row of its warp.  No shared-memory round trip for the scores; the
//   only block barrier is the ring's, before a stage is refilled.
// - A warp skips a 32-key half that its rows cannot see, and the block
//   skips tiles no row of it can see (the Pallas kernel's pl.when(run)).
// Reduction order (kernels/ops.py:flash_f32_order): a score is four fmaf
// chains over d (chain c takes d = c mod 4, ascending), summed (c0 + c1)
// + (c2 + c3), times scale * log2(e); a tile's sum is each lane's p(l) +
// p(l + 32), then the warp's shuffle-xor adds at distances 16, 8, 4, 2,
// 1; l = alpha * l + sum; the output is acc * alpha, then one fmaf a key
// over the tile's keys in ascending order, the tiles in ascending order,
// and out = acc / l.  It depends on Dk, Dv, Skv and the mask alone; a
// tile or half that is fully masked for a row is an exact no-op for it
// (alpha 1, p 0), run or skipped.  So decode at position p gives row p of
// the causal prefill bit for bit, and a packed GQA decode gives the bits
// of its heads over repeated K and V.  No split-KV, no atomics.
#include <algorithm>
#include <type_traits>

#include "wg_gemm.cuh"

namespace {

using namespace repro;
using tc::cp_async16;
using tma::bulk_copy;
using tma::mbar_expect_tx;
using tma::mbar_init;
using tma::mbar_wait;
using tma::tma_box;

constexpr int kFT = 128;            // threads per block: 4 warps
constexpr int kFW = kFT / 32;
constexpr int BK = 64;              // keys per KV tile (fixed)
constexpr float kNegInf = -1e30f;   // the reference's mask value
constexpr int kSMs = 132;              // the H100's SMs
// the 16-bit routes (kernels/ops.py:FLASH_ROUTES), chosen by flash_plan
constexpr int kRouteMma = 0, kRouteWgmma = 1;

// -- bf16, f16: the order's pieces -------------------------------------------
constexpr int kChunk = 512;                 // keys of a chunk (the order's)
constexpr int kChunkTiles = kChunk / BK;

// 2^x by the SFU (ex2.approx, ~2 ulp): the softmax's exponentials, on
// scores kept in log2 units
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// p (two f32 values) as hi + lo, each a pair of T: hi = T(p), lo =
// T(p - hi), so hi + lo keeps p to ~2^-16 relative in bf16 (hi rounded
// as a pair, then read back exactly)
__device__ __forceinline__ float2 unpack2(unsigned v, __nv_bfloat16*) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}
__device__ __forceinline__ float2 unpack2(unsigned v, __half*) {
  return __half22float2(*reinterpret_cast<const __half2*>(&v));
}
template <typename T>
__device__ __forceinline__ void split2(float a, float b, unsigned& hi,
                                       unsigned& lo) {
  hi = pack2<T>(a, b);
  const float2 h = unpack2(hi, static_cast<T*>(nullptr));
  lo = pack2<T>(a - h.x, b - h.y);
}

// One 64-key tile's online softmax for a thread's two rows (r and r + 8
// of a 16-row fragment), on the scores S[n][x] of n8 block n (x < 2: row
// r, else row r + 8; keys k0 + 8 n + qd + (x & 1)): scale into log2
// units, mask to each row's keys [lo, hi] (unless ``full``), the row's
// max over the thread's 16 values in order and then the quad, p = 2^(s -
// max), the row's sum in the same order, and m, l updated; returns the
// rows' rescale factors in al0, al1.  ``hi_live`` false: row r + 8 is
// padding and its p are 0.  Both routes run this code.
__device__ __forceinline__ void softmax_tile(float (&S)[8][4], float scale2,
                                             bool full, int k0, int qd,
                                             int lo0, int hi0, int lo1,
                                             int hi1, bool hi_live,
                                             float& m0, float& m1, float& l0,
                                             float& l1, float& al0,
                                             float& al1) {
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float sv = S[n][x] * scale2;
      if (!full) {
        const int key = k0 + n * 8 + qd + (x & 1);
        if (key < (x < 2 ? lo0 : lo1) || key > (x < 2 ? hi0 : hi1))
          sv = kNegInf;
      }
      if (x >= 2 && !hi_live) sv = kNegInf;
      S[n][x] = sv;
      if (x < 2)
        mx0 = fmaxf(mx0, sv);
      else
        mx1 = fmaxf(mx1, sv);
    }
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
  }
  // the online softmax, as the Pallas kernel: a row that has seen no
  // key yet subtracts 0 (exp(-1e30 - -1e30) = 1 would pollute it), and a
  // max that did not move rescales by exactly 1; masked scores give
  // exp2(-1e30 - m) = 0
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float ms0 = mn0 <= kNegInf * 0.5f ? 0.f : mn0;
  const float ms1 = mn1 <= kNegInf * 0.5f ? 0.f : mn1;
  al0 = m0 == mn0 ? 1.f : ex2(m0 - mn0);
  al1 = m1 == mn1 ? 1.f : ex2(m1 - mn1);
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      S[n][x] = ex2(S[n][x] - ms0);
      rs0 += S[n][x];
    }
  if (hi_live) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int x = 2; x < 4; ++x) {
        S[n][x] = ex2(S[n][x] - ms1);
        rs1 += S[n][x];
      }
  } else {
#pragma unroll
    for (int n = 0; n < 8; ++n) S[n][2] = S[n][3] = 0.f;
  }
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, w);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, w);
  }
  l0 = al0 * l0 + rs0;
  l1 = al1 * l1 + rs1;
  m0 = mn0;
  m1 = mn1;
}

// p.V's A fragments of k16 step kk (keys 16 kk .. 16 kk + 15 of the
// tile) from the scores: hi and lo halves (split2), mma.sync's layout
template <typename T>
__device__ __forceinline__ void p_frags(const float (&S)[8][4], int kk,
                                        unsigned (&ph)[4],
                                        unsigned (&pl)[4]) {
  split2<T>(S[2 * kk][0], S[2 * kk][1], ph[0], pl[0]);
  split2<T>(S[2 * kk][2], S[2 * kk][3], ph[1], pl[1]);
  split2<T>(S[2 * kk + 1][0], S[2 * kk + 1][1], ph[2], pl[2]);
  split2<T>(S[2 * kk + 1][2], S[2 * kk + 1][3], ph[3], pl[3]);
}

// keeps the compiler from computing an A fragment after the wgmma fence
// that precedes the products reading it
__device__ __forceinline__ void fence_frag(unsigned (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// The order's merge of a row's chunk state (m, l, acc) into its running
// state (M, L, A), in f32 with every rounding written out: a chunk the
// row saw no key of (l 0) is a no-op (``skip``); the empty running state
// (L 0) takes the chunk's as it is (``copy``); else mn = max(M, m), fa =
// 2^(M - mn) and fb = 2^(m - mn) (1 where the max is theirs), L = L fa +
// l fb and A = A fa + acc fb, each product rounded, then the sum.
struct Merge {
  float fa, fb;
  bool skip, copy;
};
__device__ __forceinline__ Merge merge_scales(float& M, float& L, float m,
                                              float l) {
  Merge g{1.f, 1.f, l == 0.f, false};
  if (g.skip) return g;
  if (L == 0.f) {
    g.copy = true;
    M = m;
    L = l;
    return g;
  }
  const float mn = fmaxf(M, m);
  g.fa = M == mn ? 1.f : ex2(__fsub_rn(M, mn));
  g.fb = m == mn ? 1.f : ex2(__fsub_rn(m, mn));
  L = __fadd_rn(__fmul_rn(L, g.fa), __fmul_rn(l, g.fb));
  M = mn;
  return g;
}
__device__ __forceinline__ float merge_value(const Merge& g, float A,
                                             float a) {
  return g.skip   ? A
         : g.copy ? a
                  : __fadd_rn(__fmul_rn(A, g.fa), __fmul_rn(a, g.fb));
}
// out = acc / l: acc times the rounded reciprocal of l (of 1 where the
// row saw no key, whose acc is 0), once a row
__device__ __forceinline__ float recip(float l) {
  return __fdiv_rn(1.f, l == 0.f ? 1.f : l);
}

// the keys a row at absolute position p sees: [lo, hi] (the causal,
// window and length limits of Mask::visible as one range)
__device__ __forceinline__ int key_lo(int p, int has_window, int window) {
  return has_window ? max(0, p - window + 1) : 0;
}
__device__ __forceinline__ int key_hi(int p, int causal, int Skv) {
  return causal ? min(p, Skv - 1) : Skv - 1;
}

// -- bf16, f16, the mma.sync route: tensor cores and a cp.async ring ----------
//
// A block is 4 warps.  The warps split the block's query rows into RW
// fragments of 16 rows and the output columns into CW = 4 / RW groups:
// prefill takes 4 x 16 = 64 rows (2 x 16 with 2 column groups for head
// widths over 128, so the accumulators stay in registers), and Sq <= 16 --
// decode -- one 16-row fragment with the 4 warps on 4 column groups (the
// warps split the fragment's scores and exchange them).  W is the
// head-width class (64, 128 or 256) that sizes the register arrays.  CS
// blocks split a one-fragment tile's output columns where the launch has
// few blocks (a one-slot decode): each computes the scores, reads K and
// its share of V.
template <int W_, int RW_, int STAGES_, int CS_ = 1>
struct FlashCfg {
  static constexpr int W = W_, RW = RW_, CW = kFW / RW_, STAGES = STAGES_;
  static constexpr int CS = CS_;          // blocks a tile's columns
  static constexpr int BQ = 16 * RW;      // query rows per block
  static constexpr int WC = W / CW / CS;  // output columns per warp
  static constexpr int NF = WC / 8;       // n8 fragments of O per warp
  static constexpr bool QREG = W <= 128;  // Q fragments held in registers
  static_assert(RW * CW == kFW && WC % 16 == 0 && (CS == 1 || RW == 1),
                "");
};

// shared memory: the Q tile, then ``ns`` stages of a K and a V tile, rows
// padded by 8 elements (16 bytes) so that ldmatrix's 8 row addresses hit
// 8 distinct bank quads, then (one fragment, bq 16) the tile's scores as
// the warps exchange them; mirrored by kernels/ops.py:flash_plan
constexpr int kScoreXchg = 16 * BK * 4;   // a fragment's 16 x 64 f32 scores
template <typename T>
__host__ __device__ __forceinline__ size_t tc_smem(int bq, int dkp, int dvp,
                                                   int ns) {
  return ((size_t)bq * (dkp + 8) + (size_t)ns * BK * (dkp + 8 + dvp + 8)) *
             sizeof(T) +
         (bq == 16 ? kScoreXchg : 0);
}

// rows [r0, r0 + BK) of K (width d, padded to dp) into shared memory at
// pitch ``pitch``, columns [c0, c0 + dp); rows past ``rows`` and columns
// past d are zero
template <typename T>
__device__ __forceinline__ void load_kv_tile(T* dst, const T* src, int r0,
                                             int rows, int d, int dp,
                                             int pitch, int c0,
                                             uint64_t policy) {
  const int nc = dp / 8;
  dst += c0;
  src += c0;
  d -= c0;
  if (kFT % nc == 0) {   // a fixed chunk per thread, no division per copy
    const int c = threadIdx.x % nc;
    for (int r = threadIdx.x / nc; r < BK; r += kFT / nc) {
      const bool ok = r0 + r < rows && c * 8 < d;
      tc::cp_async16(dst + r * pitch + c * 8,
                     ok ? src + (size_t)(r0 + r) * (d + c0) + c * 8 : src,
                     ok, policy);
    }
    return;
  }
  for (int e = threadIdx.x; e < BK * nc; e += kFT) {
    const int r = e / nc, c = e - r * nc;
    const bool ok = r0 + r < rows && c * 8 < d;
    tc::cp_async16(dst + r * pitch + c * 8,
                   ok ? src + (size_t)(r0 + r) * (d + c0) + c * 8 : src, ok,
                   policy);
  }
}

// wait until at most ``n`` (0 to 3) copy groups are pending
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n >= 3)
    tc::cp_async_wait<3>();
  else if (n == 2)
    tc::cp_async_wait<2>();
  else if (n == 1)
    tc::cp_async_wait<1>();
  else
    tc::cp_async_wait<0>();
}

// nch: the chunks a row tile splits into (ceil(Skv / kChunk)); with more
// than one, the block's rows' chunk states go to the workspace (Wacc:
// (row, chunk, Dv) f32 accumulators, Wml: (row, chunk) (m, l)), row
// being the output row
template <typename T, class CF>
__global__ void __launch_bounds__(kFT)
    flash_tc_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                    const T* __restrict__ Vg, T* __restrict__ O,
                    float* __restrict__ Wacc, float2* __restrict__ Wml,
                    const int* __restrict__ q_offset, int Hq, int Hkv,
                    int Sq, int Skv, int Dk, int Dv, float scale, int causal,
                    int has_window, int window, int ns, int nch) {
  constexpr int W = CF::W, BQ = CF::BQ, NF = CF::NF, WC = CF::WC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int dkp = (Dk + 15) & ~15, dvp = (Dv + 15) & ~15;
  const int kp = dkp + 8, vp = dvp + 8;
  T* Qs = reinterpret_cast<T*>(smem);
  T* ring = Qs + BQ * kp;
  const int stage = BK * (kp + vp);
  float* xs = reinterpret_cast<float*>(ring + ns * stage);   // bq 16

  // Sq == 1 (decode): the block's rows are the rep query heads that share
  // kv head blockIdx.y, so K and V are read once for all of them; else
  // they are query rows of head blockIdx.y
  const int rep = Hq / Hkv;
  const bool packed = Sq == 1;
  const int b = blockIdx.z, hy = blockIdx.y;
  const int hk = packed ? hy : hy / rep;
  // x: (row tile, chunk, column share)
  const int cs = blockIdx.x % CF::CS;   // the block's share of the columns
  const int ch = blockIdx.x / CF::CS % nch;   // the block's chunk
  const int R0 = blockIdx.x / CF::CS / nch * BQ;
  // the V columns the block reads: its share (past Dv: none)
  const int vc0 = min(cs * (W / CF::CS), dvp);
  const int vcn = min(W / CF::CS, dvp - vc0);
  const int rows = min(BQ, (packed ? rep : Sq) - R0);
  // (b, head, query) row of block row R
  auto grow = [&](int R) -> size_t {
    return packed ? (size_t)b * Hq + hy * rep + R0 + R
                  : ((size_t)b * Hq + hy) * Sq + R0 + R;
  };

  const T* k = K + (size_t)(b * Hkv + hk) * Skv * Dk;
  const T* v = Vg + (size_t)(b * Hkv + hk) * Skv * Dv;
  const uint64_t policy = tc::l2_policy_evict_normal();
  auto load_tile = [&](int t, int slot) {
    T* ks = ring + slot * stage;
    load_kv_tile(ks, k, t * BK, Skv, Dk, dkp, kp, 0, policy);
    if (vcn > 0)
      load_kv_tile(ks + BK * kp, v, t * BK, Skv, Dv, vcn, vp, vc0, policy);
  };

  // block row R's absolute position
  const int off = q_offset != nullptr ? *q_offset : 0;
  auto qpos = [&](int R) { return packed ? off : R0 + R + off; };
  // the KV tiles of the block's chunk that can hold a key some row of
  // this block sees
  const int q_first = qpos(0), q_last = qpos(rows - 1);
  const int n_tiles = (Skv + BK - 1) / BK;
  int t_end = min(n_tiles, (ch + 1) * kChunkTiles);
  if (causal) t_end = q_last < 0 ? 0 : min(t_end, q_last / BK + 1);
  const int t_begin =
      max(ch * kChunkTiles, has_window ? max(0, q_first - window + 1) / BK
                                       : 0);
  const int nt = max(0, t_end - t_begin);
  // the combine may be scheduled now; it waits for this grid's writes
  if (nch > 1) asm volatile("griddepcontrol.launch_dependents;\n" ::);
  // a chunk no row of the block sees: no row's merge reads it
  if (nch > 1 && nt == 0) return;

  // the Q tile (rows past ``rows`` and columns past Dk zero) joins the
  // first copy group; every stage of the ring is in flight from the start
  for (int e = threadIdx.x; e < BQ * (dkp / 8); e += kFT) {
    const int r = e / (dkp / 8), c = e - r * (dkp / 8);
    const bool ok = r < rows && c * 8 < Dk;
    tc::cp_async16(Qs + r * kp + c * 8, ok ? Q + grow(r) * Dk + c * 8 : Q,
                   ok);
  }
  for (int j = 0; j < ns; ++j) {
    if (j < nt) load_tile(t_begin + j, j);
    tc::cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp / CF::CW, cg = warp % CF::CW;
  const int r = lane >> 2, qd = (lane & 3) * 2;   // fragment row, column
  const int row0 = rg * 16 + r, row1 = row0 + 8;  // block rows of a thread
  const bool warp_live = rg * 16 < rows;
  const int p0 = qpos(row0), p1 = qpos(row1);
  const int w_first = qpos(rg * 16);
  const int w_last = qpos(max(0, min(rg * 16 + 15, rows - 1)));
  const int col0 = cs * (W / CF::CS) + cg * WC;
  const float scale2 = scale * 1.44269504088896341f;   // log2(e)
  const int lo0 = key_lo(p0, has_window, window), hi0 = key_hi(p0, causal, Skv);
  const int lo1 = key_lo(p1, has_window, window), hi1 = key_hi(p1, causal, Skv);

  unsigned qf[CF::QREG ? W / 16 : 1][4];
  float acc[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[f][x] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < nt; ++j) {
    if (j > 0) {
      // tile j - 1 is done with: its slot takes tile j - 1 + ns
      if (j - 1 + ns < nt) {
        __syncthreads();
        load_tile(t_begin + j - 1 + ns, (j - 1) % ns);
      }
      tc::cp_async_commit();
    }
    cp_async_wait_n(ns - 1);   // tile j (and Q) landed for this thread
    __syncthreads();           // ... for every thread
    if constexpr (CF::QREG) {
      if (j == 0) {
#pragma unroll
        for (int s = 0; s < W / 16; ++s)
          if (s * 16 < dkp)
            tc::ldmatrix_x4(qf[s], Qs + (rg * 16 + (lane & 15)) * kp +
                                       s * 16 + (lane >> 4) * 8);
      }
    }
    const int k0 = (t_begin + j) * BK;
    // a tile the mask hides from all of this warp's rows is skipped: for
    // each row that is exactly what running it would do (alpha 1, p 0)
    if (!warp_live || (causal && k0 > w_last) ||
        (has_window && k0 + BK - 1 <= w_first - window))
      continue;
    const T* ks = ring + (j % ns) * stage;
    const T* vs = ks + BK * kp;

    // S = Q K^T: 16 rows x 64 keys in registers, d in ascending k16 steps
    float S[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) S[n][x] = 0.f;
    // (a head as wide as its class runs unguarded, straight-line code)
    auto scores = [&](auto whole) {
      constexpr bool kWhole = decltype(whole)::value;
      if constexpr (CF::RW == 1) {
        // one fragment: warp cg computes n8 blocks 2 cg and 2 cg + 1 (the
        // same chains as below), and the warps exchange them through
        // shared memory, so each holds all 8 as if it had computed them
        float Sw[2][4] = {};
#pragma unroll
        for (int s = 0; s < W / 16; ++s) {
          if constexpr (!kWhole) {
            if (s * 16 >= dkp) continue;
          }
          unsigned a[4];
          if constexpr (CF::QREG) {
#pragma unroll
            for (int x = 0; x < 4; ++x) a[x] = qf[s][x];
          } else {
            tc::ldmatrix_x4(a, Qs + (lane & 15) * kp + s * 16 +
                                   (lane >> 4) * 8);
          }
          unsigned kb[4];
          tc::ldmatrix_x4(kb, ks + (cg * 16 + (lane & 7) +
                                    ((lane >> 4) << 3)) * kp + s * 16 +
                                  ((lane >> 3) & 1) * 8);
          tc::mma16816<T>(Sw[0], a, kb[0], kb[1]);
          tc::mma16816<T>(Sw[1], a, kb[2], kb[3]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            xs[((2 * cg + i) * 4 + x) * 32 + lane] = Sw[i][x];
        __syncthreads();
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int x = 0; x < 4; ++x) S[n][x] = xs[(n * 4 + x) * 32 + lane];
        return;
      }
#pragma unroll
      for (int s = 0; s < W / 16; ++s) {
        if constexpr (!kWhole) {
          if (s * 16 >= dkp) continue;
        }
        unsigned a[4];
        if constexpr (CF::QREG) {
#pragma unroll
          for (int x = 0; x < 4; ++x) a[x] = qf[s][x];
        } else {
          tc::ldmatrix_x4(a, Qs + (rg * 16 + (lane & 15)) * kp + s * 16 +
                                 (lane >> 4) * 8);
        }
        unsigned kb[4][4];
#pragma unroll
        for (int np = 0; np < 4; ++np)
          tc::ldmatrix_x4(kb[np],
                          ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                   kp + s * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          tc::mma16816<T>(S[2 * np], a, kb[np][0], kb[np][1]);
          tc::mma16816<T>(S[2 * np + 1], a, kb[np][2], kb[np][3]);
        }
      }
    };
    if (dkp == W)
      scores(std::true_type{});
    else
      scores(std::false_type{});

    // a tile the mask leaves whole for every row of the warp takes no
    // mask; the fragment's second half is skipped when it holds only
    // padding rows (Sq or rep <= 8)
    const bool full = k0 + BK <= Skv &&
                      (!causal || k0 + BK - 1 <= w_first) &&
                      (!has_window || k0 > w_last - window);
    float al0, al1;
    softmax_tile(S, scale2, full, k0, qd, lo0, hi0, lo1, hi1,
                 rg * 16 + 8 < rows, m0, m1, l0, l1, al0, al1);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      acc[f][0] *= al0;
      acc[f][1] *= al0;
      acc[f][2] *= al1;
      acc[f][3] *= al1;
    }

    // acc += p V: p goes from the score registers straight into A
    // fragments, as hi + lo in T (two mma into the same f32 sums: hi, then
    // lo), keys in ascending k16 steps
    auto pv = [&](auto whole) {
      constexpr bool kWhole = decltype(whole)::value;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned ph[4], pl[4];
        p_frags<T>(S, kk, ph, pl);
        unsigned vb[NF / 2][4];
#pragma unroll
        for (int fp = 0; fp < NF / 2; ++fp) {
          if constexpr (!kWhole) {
            if (col0 + fp * 16 >= dvp) continue;
          }
          tc::ldmatrix_x4_trans(
              vb[fp], vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               vp + col0 + fp * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int fp = 0; fp < NF / 2; ++fp) {
            if constexpr (!kWhole) {
              if (col0 + fp * 16 >= dvp) continue;
            }
            const unsigned (&pa)[4] = h == 0 ? ph : pl;
            tc::mma16816<T>(acc[2 * fp], pa, vb[fp][0], vb[fp][1]);
            tc::mma16816<T>(acc[2 * fp + 1], pa, vb[fp][2], vb[fp][3]);
          }
      }
    };
    if (col0 + WC <= dvp)
      pv(std::true_type{});
    else
      pv(std::false_type{});
  }
  tc::cp_async_wait<0>();

  if (nch > 1) {
    // the rows' chunk states, for flash_combine_kernel
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int c = col0 + f * 8 + qd;
      if (c >= Dv) continue;
      if (row0 < rows)
        *reinterpret_cast<float2*>(Wacc + (grow(row0) * nch + ch) * Dv + c) =
            make_float2(acc[f][0], acc[f][1]);
      if (row1 < rows)
        *reinterpret_cast<float2*>(Wacc + (grow(row1) * nch + ch) * Dv + c) =
            make_float2(acc[f][2], acc[f][3]);
    }
    if (cs == 0 && cg == 0 && (lane & 3) == 0) {
      if (row0 < rows) Wml[grow(row0) * nch + ch] = make_float2(m0, l0);
      if (row1 < rows) Wml[grow(row1) * nch + ch] = make_float2(m1, l1);
    }
    return;
  }
  // out = acc / l (a row that saw no key: 0); padding rows and columns
  // are never stored
  const float rl0 = recip(l0), rl1 = recip(l1);
  T* o0 = O + grow(row0) * Dv;
  T* o1 = O + grow(row1) * Dv;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int c = col0 + f * 8 + qd;
    if (c >= Dv) continue;
    if (row0 < rows)
      *reinterpret_cast<unsigned*>(o0 + c) =
          pack2<T>(__fmul_rn(acc[f][0], rl0), __fmul_rn(acc[f][1], rl0));
    if (row1 < rows)
      *reinterpret_cast<unsigned*>(o1 + c) =
          pack2<T>(__fmul_rn(acc[f][2], rl1), __fmul_rn(acc[f][3], rl1));
  }
}

// The chunk states' merge: a warp an output row (rows: B * Hq * Sq, in
// O's order), its chunks that hold a key the row sees in ascending order
// (merge_scales), then out = A / L; lane l holds columns 64 u + 2 l and
// + 1.  No atomics: the order is fixed.
template <typename T>
__global__ void __launch_bounds__(kFT)
    flash_combine_kernel(const float* __restrict__ Wacc,
                         const float2* __restrict__ Wml, T* __restrict__ O,
                         const int* __restrict__ q_offset, int n_rows,
                         int Sq, int Skv, int Dv, int nch, int causal,
                         int has_window, int window) {
  // the chunk kernel's states are complete (this kernel is its
  // programmatic dependent: launched early, it waits here)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int g = blockIdx.x * kFW + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= n_rows) return;
  const int p = g % Sq + (q_offset != nullptr ? *q_offset : 0);
  const int lo = key_lo(p, has_window, window), hi = key_hi(p, causal, Skv);
  float M = kNegInf, L = 0.f, A[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) A[i] = 0.f;
  if (lo <= hi) {
    for (int c = lo / kChunk; c <= hi / kChunk; ++c) {
      const float2 ml = Wml[(size_t)g * nch + c];
      const Merge w = merge_scales(M, L, ml.x, ml.y);
      if (w.skip) continue;
      const float* a = Wacc + ((size_t)g * nch + c) * Dv;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int col = 64 * u + 2 * lane;
        if (col >= Dv) continue;
        const float2 x = *reinterpret_cast<const float2*>(a + col);
        A[2 * u] = merge_value(w, A[2 * u], x.x);
        A[2 * u + 1] = merge_value(w, A[2 * u + 1], x.y);
      }
    }
  }
  T* o = O + (size_t)g * Dv;
  const float rl = recip(L);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int col = 64 * u + 2 * lane;
    if (col >= Dv) continue;
    *reinterpret_cast<unsigned*>(o + col) =
        pack2<T>(__fmul_rn(A[2 * u], rl), __fmul_rn(A[2 * u + 1], rl));
  }
}

// the workspace of a split launch: (rows, chunks, Dv) f32 accumulators,
// then (rows, chunks) (m, l) pairs; mirrored by kernels/ops.py:flash_plan
__host__ __forceinline__ size_t split_ws_bytes(size_t n_rows, int nch,
                                               int Dv) {
  return n_rows * nch * ((size_t)Dv * 4 + 8);
}

template <typename T, class CF>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      const int* off, void* ws, long long ws_bytes, int B,
                      int Hq, int Hkv, int Sq, int Skv, int Dk, int Dv,
                      float scale, int causal, int has_window, int window,
                      cudaStream_t s) {
  // raise the instantiation's dynamic shared memory limit once per
  // device, to the most any call can need
  static PerDevice limit_set;
  const cudaError_t limit = once_per_device(limit_set, [] {
    return cudaFuncSetAttribute(
        flash_tc_kernel<T, CF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tc_smem<T>(CF::BQ, CF::W, CF::W, CF::STAGES));
  });
  if (limit != cudaSuccess) return limit;
  const int tiles = (Skv + BK - 1) / BK;
  const int ns = std::min(CF::STAGES, tiles);
  const size_t smem = tc_smem<T>(CF::BQ, (Dk + 15) & ~15, (Dv + 15) & ~15,
                                 ns);
  const int nrows = Sq == 1 ? Hq / Hkv : Sq;
  const int nch = (Skv + kChunk - 1) / kChunk;
  const size_t n_rows = (size_t)B * Hq * Sq;
  float* wacc = static_cast<float*>(ws);
  float2* wml = reinterpret_cast<float2*>(wacc + n_rows * nch * Dv);
  if (nch > 1 && (ws == nullptr ||
                  ws_bytes < (long long)split_ws_bytes(n_rows, nch, Dv)))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((nrows + CF::BQ - 1) / CF::BQ * nch * CF::CS),
                  (unsigned)(Sq == 1 ? Hkv : Hq), (unsigned)B);
  flash_tc_kernel<T, CF><<<grid, kFT, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), wacc, wml, off, Hq, Hkv,
      Sq, Skv, Dk, Dv, scale, causal, has_window, window, ns, nch);
  if (nch == 1) return cudaSuccess;
  return launch_pdl(flash_combine_kernel<T>,
                    dim3((unsigned)((n_rows + kFW - 1) / kFW)), dim3(kFT), 0,
                    s, (const float*)wacc, (const float2*)wml,
                    static_cast<T*>(o), off, (int)n_rows, Sq, Skv, Dv, nch,
                    causal, has_window, window);
}

// The one-fragment launch's column split: 4 blocks a tile (width 256) or 2
// (width 128 and more) while the blocks -- (kv) heads x batch x chunks --
// fill at most a quarter or a half of the H100's SMs, else 1; mirrored by
// kernels/ops.py:flash_plan.
inline int decode_column_split(int W, long long blocks) {
  if (W >= 256 && 4 * blocks <= kSMs) return 4;
  if (W >= 128 && 2 * blocks <= kSMs) return 2;
  return 1;
}

// the head-width class and the block's rows, mirrored by
// kernels/ops.py:flash_plan
// STAGES for the RW-fragment tiles, DSTAGES for the one-fragment (decode)
// tile: at width 128, 3 stages let two decode blocks share an SM
template <typename T, int W, int RW, int STAGES, int DSTAGES>
cudaError_t launch_w(const void* q, const void* k, const void* v, void* o,
                     const int* off, void* ws, long long ws_bytes, int B,
                     int Hq, int Hkv, int Sq, int Skv, int Dk, int Dv,
                     float scale, int causal, int has_window, int window,
                     cudaStream_t s) {
  const int nrows = Sq == 1 ? Hq / Hkv : Sq;
  if (nrows <= 16) {
    const int cs = decode_column_split(W, (long long)(Sq == 1 ? Hkv : Hq) *
                                              B * ((Skv + kChunk - 1) /
                                                   kChunk));
    if (W >= 256 && cs == 4)
      return launch_tc<T, FlashCfg<W, 1, DSTAGES, (W >= 256 ? 4 : 1)>>(
          q, k, v, o, off, ws, ws_bytes, B, Hq, Hkv, Sq, Skv, Dk, Dv, scale,
          causal, has_window, window, s);
    if (W >= 128 && cs == 2)
      return launch_tc<T, FlashCfg<W, 1, DSTAGES, (W >= 128 ? 2 : 1)>>(
          q, k, v, o, off, ws, ws_bytes, B, Hq, Hkv, Sq, Skv, Dk, Dv, scale,
          causal, has_window, window, s);
    return launch_tc<T, FlashCfg<W, 1, DSTAGES>>(
        q, k, v, o, off, ws, ws_bytes, B, Hq, Hkv, Sq, Skv, Dk, Dv, scale,
        causal, has_window, window, s);
  }
  return launch_tc<T, FlashCfg<W, RW, STAGES>>(
      q, k, v, o, off, ws, ws_bytes, B, Hq, Hkv, Sq, Skv, Dk, Dv, scale,
      causal, has_window, window, s);
}

template <typename T>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       const int* off, void* ws, long long ws_bytes, int B,
                       int Hq, int Hkv, int Sq, int Skv, int Dk, int Dv,
                       float scale, int causal, int has_window, int window,
                       cudaStream_t s) {
  const int w = std::max((Dk + 15) & ~15, (Dv + 15) & ~15);
  if (w <= 64)
    return launch_w<T, 64, 4, 4, 4>(q, k, v, o, off, ws, ws_bytes, B, Hq,
                                    Hkv, Sq, Skv, Dk, Dv, scale, causal,
                                    has_window, window, s);
  if (w <= 128)
    return launch_w<T, 128, 4, 4, 3>(q, k, v, o, off, ws, ws_bytes, B, Hq,
                                     Hkv, Sq, Skv, Dk, Dv, scale, causal,
                                     has_window, window, s);
  return launch_w<T, 256, 2, 3, 3>(q, k, v, o, off, ws, ws_bytes, B, Hq, Hkv,
                                   Sq, Skv, Dk, Dv, scale, causal,
                                   has_window, window, s);
}

// -- bf16, f16, the wgmma route: a TMA ring and warpgroups --------------------
//
// Shared memory (on 1024 bytes): the consumers' Q tiles (NBK boxes of 64
// rows x 64 d each), ``ns`` stages of a K tile (NBK boxes of 64 keys x
// 64 d) and a V tile (NBV boxes of 64 keys x 64 columns), each box 64
// rows of 128 bytes under the 128-byte swizzle -- Q and K as wgmma's
// K-major tiles, V as its MN-major boxes (wg_gemm.cuh) -- then, where
// Skv > kChunk, the running accumulators (a slot a thread), then the
// mbarriers: Q's, and a full and an empty one a stage.  Mirrored by
// kernels/ops.py:flash_plan.
constexpr int kWgBox = 64;                  // elements of a box row
constexpr int kWgBoxBytes = 64 * 128;       // a box: 64 rows of 128 bytes
constexpr int kWgMaxStages = 4;
constexpr int kWgBarBytes = 8 * (4 + 2 * kWgMaxStages);

template <int NBK_, int NBV_, int NC_>
struct WgCfg {
  static constexpr int NBK = NBK_, NBV = NBV_, NC = NC_;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int BQ = 64 * NC;                 // query rows a block
  static constexpr int NA = 32 * NBV;                // accumulators a thread
  // Q tiles of two work items (the producer loads the next one's while
  // the consumers work on this one) where blocks are persistent (NC 2)
  static constexpr bool PERSIST = NC > 1;
  static constexpr int QBUF = PERSIST ? 2 : 1;
  static constexpr int QTILE = NC * NBK * kWgBoxBytes;   // one item's Q
  static constexpr int QBYTES = QBUF * QTILE;
  static constexpr int STAGE = (NBK + NBV) * kWgBoxBytes;
  static constexpr int SPILL = NC * 128 * NA * 4;
  static_assert(NBV == 1 || NBV == 2 || NBV == 4, "");
};

template <class CF>
__host__ __forceinline__ size_t wg_smem(int ns, bool spill) {
  return 1024 + CF::QBYTES + (size_t)ns * CF::STAGE +
         (spill ? CF::SPILL : 0) + kWgBarBytes;
}

// acc (the consumer's 64 rows x 64 NBV columns: accumulator 32 b + 4 j +
// x is box b's n8 block j) += p (A fragments) @ V's k16 step kk: one
// m64n128k16 a pair of boxes (m64n64k16 for a lone box)
template <typename T, int NBV>
__device__ __forceinline__ void pv_step(float (&acc)[32 * NBV],
                                        const unsigned (&pa)[4],
                                        const unsigned char* vs, int kk) {
  if constexpr (NBV == 1) {
    wg::mma_rs<T, 64, 1>(acc, pa, wg::desc_mn(vs, kk));
  } else {
#pragma unroll
    for (int g = 0; g < NBV / 2; ++g)
      wg::mma_rs<T, 128, 1>(*reinterpret_cast<float(*)[64]>(&acc[64 * g]),
                            pa, wg::desc_mn(vs + 2 * g * kWgBoxBytes, kk));
  }
}

// A work item is (row tile, head, batch row), the last row tiles first
// (under the causal mask they have the most tiles, and the short ones
// fill the tail); its KV tiles: those some row of it can see
struct WgItem {
  int R0, rows, hy, b, t_begin, nt;
};
__device__ __forceinline__ WgItem wg_item(int i, int bq, int Hq, int B,
                                          int Sq, int Skv, int off,
                                          int causal, int has_window,
                                          int window) {
  const int n_rt = (Sq + bq - 1) / bq;
  WgItem w;
  w.R0 = (n_rt - 1 - i / (Hq * B)) * bq;
  w.hy = i % (Hq * B) % Hq;
  w.b = i % (Hq * B) / Hq;
  w.rows = min(bq, Sq - w.R0);
  const int n_tiles = (Skv + BK - 1) / BK;
  const int q_first = w.R0 + off, q_last = w.R0 + w.rows - 1 + off;
  const int t_end = causal ? min(n_tiles, q_last / BK + 1) : n_tiles;
  w.t_begin = has_window ? max(0, q_first - window + 1) / BK : 0;
  w.nt = max(0, t_end - w.t_begin);
  return w;
}

// Persistent blocks: block i walks work items i, i + grid, ...; the
// producer runs ahead into the next item (its Q once the consumers are
// done with the last one's, its K/V tiles as stages free) while the
// consumers finish and store this one.  The two consumers take turns to
// issue their products (named barriers 1 and 2, FA3's ping-pong), so one
// runs its softmax while the other's products run.
template <typename T, class CF>
__global__ void __launch_bounds__(CF::THREADS, 1)
    flash_wg_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    T* __restrict__ O, const int* __restrict__ q_offset,
                    int B, int Hq, int Hkv, int Sq, int Skv, int Dk, int Dv,
                    float scale, int causal, int has_window, int window,
                    int ns, int spill) {
  constexpr int NBK = CF::NBK, NBV = CF::NBV, NA = CF::NA, NC = CF::NC;
  extern __shared__ __align__(1024) unsigned char raw[];
  unsigned char* qs = raw + ((1024u - (tc::smem_u32(raw) & 1023u)) & 1023u);
  unsigned char* ring = qs + CF::QBYTES;
  float* run_s = reinterpret_cast<float*>(ring + ns * CF::STAGE);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(
      ring + ns * CF::STAGE + (spill ? CF::SPILL : 0));   // [QBUF]
  uint64_t* qempty = qfull + 2;                            // [QBUF]
  uint64_t* full = qfull + 4;
  uint64_t* empty = full + ns;
  const int items = (Sq + CF::BQ - 1) / CF::BQ * Hq * B;
  const int rep = Hq / Hkv;
  const int off = q_offset != nullptr ? *q_offset : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < CF::QBUF; ++i) {
      tma::mbar_init(qfull + i, 1);
      tma::mbar_init(qempty + i, NC);
    }
    for (int i = 0; i < ns; ++i) {
      tma::mbar_init(full + i, 1);
      tma::mbar_init(empty + i, NC);
    }
    tma::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {   // the producer
    if constexpr (NC > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      // K and V are read by every row tile of the head: L2's normal
      // priority; Q once: evict first
      const uint64_t kv_pol = tc::l2_policy_evict_normal();
      const uint64_t q_pol = tc::l2_policy_evict_first();
      int it = 0, n = 0;   // ring tiles and items so far
      for (int i = blockIdx.x; i < items; i += gridDim.x, ++n) {
        const WgItem w = wg_item(i, CF::BQ, Hq, B, Sq, Skv, off, causal,
                                 has_window, window);
        // this Q buffer's last item is read
        const int qb = n % CF::QBUF;
        tma::mbar_wait(qempty + qb, ((n / CF::QBUF) & 1) ^ 1u);
        tma::mbar_expect_tx(qfull + qb, CF::QTILE);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int kb = 0; kb < NBK; ++kb)
            tma::tma_box(qs + qb * CF::QTILE + (c * NBK + kb) * kWgBoxBytes,
                         &qmap, kWgBox * kb, w.R0 + 64 * c, w.b * Hq + w.hy,
                         qfull + qb, q_pol);
        const int bh = w.b * Hkv + w.hy / rep;
        for (int j = 0; j < w.nt; ++j, ++it) {
          const int slot = it % ns;
          tma::mbar_wait(empty + slot, ((it / ns) & 1) ^ 1u);
          unsigned char* st = ring + slot * CF::STAGE;
          const int k0 = (w.t_begin + j) * BK;
          tma::mbar_expect_tx(full + slot, CF::STAGE);
#pragma unroll
          for (int kb = 0; kb < NBK; ++kb)
            tma::tma_box(st + kb * kWgBoxBytes, &kmap, kWgBox * kb, k0, bh,
                         full + slot, kv_pol);
#pragma unroll
          for (int vb = 0; vb < NBV; ++vb)
            tma::tma_box(st + (NBK + vb) * kWgBoxBytes, &vmap, kWgBox * vb,
                         k0, bh, full + slot, kv_pol);
        }
        if constexpr (!CF::PERSIST) break;
      }
    }
  } else {   // the consumers: item rows [64 c, 64 c + 64)
    if constexpr (NC > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = threadIdx.x / 128 - 1, t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31;
    const int r = lane >> 2, qd = (lane & 3) * 2;
    const int crow = 64 * c;                       // the consumer's first row
    const int row0 = crow + 16 * warp + r, row1 = row0 + 8;
    const float scale2 = scale * 1.44269504088896341f;   // log2(e)
    float* run = run_s + (size_t)c * NA * 128 + t;   // slot i at run[128 i]
    // the turns: wait for this consumer's (the other consumer's products
    // are issued), then hand the turn over once this one's are
    auto turn_wait = [&]() {
      if constexpr (NC > 1)
        asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
    };
    auto turn_pass = [&]() {
      if constexpr (NC > 1)
        asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory");
    };
    if (c == 1) turn_pass();   // consumer 0 takes the first turn

    int it = 0, n = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x, ++n) {
      const WgItem w = wg_item(i, CF::BQ, Hq, B, Sq, Skv, off, causal,
                               has_window, window);
      const int R0 = w.R0, rows = w.rows, t_begin = w.t_begin, nt = w.nt;
      const int qb = n % CF::QBUF;
      const unsigned char* qc = qs + qb * CF::QTILE + c * NBK * kWgBoxBytes;
      const bool live = crow < rows;
      const int p0 = R0 + row0 + off, p1 = p0 + 8;
      const int w_first = R0 + crow + off;
      const int w_last = R0 + min(crow + 63, max(crow, rows - 1)) + off;
      const int lo0 = key_lo(p0, has_window, window);
      const int hi0 = key_hi(p0, causal, Skv);
      const int lo1 = key_lo(p1, has_window, window);
      const int hi1 = key_hi(p1, causal, Skv);

      float acc[NA];
#pragma unroll
      for (int x = 0; x < NA; ++x) acc[x] = 0.f;
      // the chunk's state, and the running state (its accumulators in
      // shared memory)
      float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
      float M0 = kNegInf, M1 = kNegInf, L0 = 0.f, L1 = 0.f;
      int chunk = t_begin / kChunkTiles;
      // fold the chunk's state into the running state, then start the
      // next
      auto fold = [&]() {
        const Merge w0 = merge_scales(M0, L0, m0, l0);
        const Merge w1 = merge_scales(M1, L1, m1, l1);
#pragma unroll
        for (int x = 0; x < NA; ++x) {
          const Merge& g = (x & 2) ? w1 : w0;
          if (!g.skip) run[128 * x] = merge_value(g, run[128 * x], acc[x]);
          acc[x] = 0.f;
        }
        m0 = m1 = kNegInf;
        l0 = l1 = 0.f;
      };
      // the consumer's own tiles [ja, jb): those some row of it can see
      // (a run: the window hides a prefix, the causal limit a suffix); it
      // waits for and releases the others without reading them
      auto sees = [&](int j) {
        const int k0 = (t_begin + j) * BK;
        return live && !(causal && k0 > w_last) &&
               !(has_window && k0 + BK - 1 <= w_first - window);
      };
      int ja = 0;
      while (ja < nt && !sees(ja)) ++ja;
      int jb = ja;
      while (jb < nt && sees(jb)) ++jb;
      auto wait_full = [&](int j) {
        tma::mbar_wait(full + (it + j) % ns,
                       (unsigned)((it + j) / ns) & 1u);
      };
      auto release = [&](int j) {
        if (t == 0) tma::mbar_arrive(empty + (it + j) % ns);
      };

      // The mainloop, FA3's overlap inside a consumer: tile j's scores
      // are issued, then tile j - 1's p.V (acc rescaled first); tile j's
      // softmax runs on the CUDA cores while that p.V runs on the tensor
      // cores.  Every wait's count is fixed; each tile, and one turn
      // more for the last p.V, is one turn of the ping-pong.
      float S[32];
      unsigned ph[4][4], pl[4][4];   // the last softmax's p, hi and lo
      float al0 = 1.f, al1 = 1.f;    // ... and its rescale factors
      // S = Q K^T of tile j: 64 rows x 64 keys, d in ascending k16 steps
      // (columns past Dk are zeros in Q and K: they add +0 to a sum that
      // is never -0), issued, not waited for
      auto issue_scores = [&](int j) {
        const unsigned char* ks = ring + ((it + j) % ns) * CF::STAGE;
#pragma unroll
        for (int x = 0; x < 32; ++x) S[x] = 0.f;
        wg::fence_regs(S);
        wg::fence();
#pragma unroll
        for (int s = 0; s < 4 * NBK; ++s)
          wg::mma_64x64<T, 0, 0>(
              S, wg::desc_k(qc + (s / 4) * kWgBoxBytes, s % 4),
              wg::desc_k(ks + (s / 4) * kWgBoxBytes, s % 4));
        wg::commit();
      };
      // acc = acc * alpha, then acc += p V of tile j, hi then lo in each
      // ascending k16 step, issued
      auto issue_pv = [&](int j) {
        const unsigned char* vs =
            ring + ((it + j) % ns) * CF::STAGE + NBK * kWgBoxBytes;
        // (a warp none of whose rows' max moved skips the rescale: a
        // product by exactly 1)
        if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
          for (int x = 0; x < NA; x += 4) {
            acc[x] *= al0;
            acc[x + 1] *= al0;
            acc[x + 2] *= al1;
            acc[x + 3] *= al1;
          }
        }
        wg::fence_regs(acc);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pv_step<T, NBV>(acc, ph[kk], vs, kk);
          pv_step<T, NBV>(acc, pl[kk], vs, kk);
        }
        wg::commit();
      };
      // tile j's softmax on its scores (complete), after a fold where it
      // starts a chunk (acc complete: no p.V in flight)
      auto softmax = [&](int j) {
        const int k0 = (t_begin + j) * BK;
        float(&S4)[8][4] = *reinterpret_cast<float(*)[8][4]>(S);
        const bool full_tile = k0 + BK <= Skv &&
                               (!causal || k0 + BK - 1 <= w_first) &&
                               (!has_window || k0 > w_last - window);
        softmax_tile(S4, scale2, full_tile, k0, qd, lo0, hi0, lo1, hi1,
                     true, m0, m1, l0, l1, al0, al1);
      };
      // its p fragments (no p.V in flight may still read the last ones)
      auto frags = [&]() {
        float(&S4)[8][4] = *reinterpret_cast<float(*)[8][4]>(S);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          p_frags<T>(S4, kk, ph[kk], pl[kk]);
          // (made before the next fence: none is written between
          // products)
          fence_frag(ph[kk]);
          fence_frag(pl[kk]);
        }
      };
      auto starts_chunk = [&](int j) {
        return (t_begin + j) / kChunkTiles != chunk;
      };

      tma::mbar_wait(qfull + qb, (n / CF::QBUF) & 1);
      for (int j = 0; j < ja; ++j) {
        wait_full(j);
        turn_wait();
        turn_pass();
        release(j);
      }
      if (ja < jb) {
        wait_full(ja);
        turn_wait();
        issue_scores(ja);
        turn_pass();
        wg::wait<0>();
        wg::fence_regs(S);
        if (starts_chunk(ja)) {
          fold();
          chunk = (t_begin + ja) / kChunkTiles;
        }
        softmax(ja);
        frags();
        for (int j = ja + 1; j < jb; ++j) {
          wait_full(j);
          turn_wait();
          issue_scores(j);
          issue_pv(j - 1);
          turn_pass();
          wg::wait<1>();   // the scores (older than the p.V)
          wg::fence_regs(S);
          if (starts_chunk(j)) {
            wg::wait<0>();
            wg::fence_regs(acc);
            fold();
            chunk = (t_begin + j) / kChunkTiles;
          }
          softmax(j);
          wg::wait<0>();   // p.V of tile j - 1: its stage and fragments
          wg::fence_regs(acc);
          release(j - 1);
          frags();
        }
        turn_wait();
        issue_pv(jb - 1);
        turn_pass();
        wg::wait<0>();
        wg::fence_regs(acc);
        release(jb - 1);
      } else {
        turn_wait();
        turn_pass();
      }
      for (int j = jb; j < nt; ++j) {
        wait_full(j);
        turn_wait();
        turn_pass();
        release(j);
      }
      // every product that read this item's Q is done
      if (t == 0) tma::mbar_arrive(qempty + qb);
      it += nt;

      // the last chunk, then out = A / L; padding rows and columns are
      // never stored (a row's running state is empty unless a fold put
      // a chunk it saw there)
      const bool e0 = L0 == 0.f, e1 = L1 == 0.f;
      const Merge w0 = merge_scales(M0, L0, m0, l0);
      const Merge w1 = merge_scales(M1, L1, m1, l1);
      const float rl0 = recip(L0), rl1 = recip(L1);
      T* o0 = O + (((size_t)w.b * Hq + w.hy) * Sq + R0 + row0) * Dv;
      T* o1 = o0 + 8 * (size_t)Dv;
#pragma unroll
      for (int x = 0; x < NA; x += 2) {
        const int h = (x >> 1) & 1;   // row r (0) or r + 8 (1)
        const int col = 64 * (x / 32) + 8 * ((x % 32) / 4) + qd;
        const bool e = h ? e1 : e0;
        const Merge& g = h ? w1 : w0;
        const float x0 = e ? acc[x] : merge_value(g, run[128 * x], acc[x]);
        const float x1 = e ? acc[x + 1]
                           : merge_value(g, run[128 * (x + 1)], acc[x + 1]);
        const int row = h ? row1 : row0;
        if (row < rows && col < Dv)
          *reinterpret_cast<unsigned*>((h ? o1 : o0) + col) =
              pack2<T>(__fmul_rn(x0, h ? rl1 : rl0),
                       __fmul_rn(x1, h ? rl1 : rl0));
      }
      // (one item a block: no loop state to keep)
      if constexpr (!CF::PERSIST) break;
    }
    if (c == 0) turn_wait();   // the other consumer's last hand-over
  }
}

// the 3-D map (column, row, slice) of a (slices, rows, d) 16-bit operand:
// boxes of 64 rows x 64 columns (128 bytes) under the 128-byte swizzle;
// what lies outside it lands as zeros.  A host-side encoding: a
// CUDA-graph capture may run it.
template <typename T>
cudaError_t wg_map(CUtensorMap* map, const void* base, int d, int rows,
                   int slices) {
  const tma::EncodeTiled encode = tma::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)slices};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * (cuuint64_t)d * 2};
  const cuuint32_t box[3] = {kWgBox, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      3, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// stages: as many as fit beside Q and the running accumulators (1 to
// kWgMaxStages), at most the cache's tiles; mirrored by
// kernels/ops.py:flash_plan
template <class CF>
int wg_stages(int Skv) {
  const bool spill = Skv > kChunk;
  const long budget = (long)kMaxDynamicSmem - (long)wg_smem<CF>(0, spill);
  const int tiles = (Skv + BK - 1) / BK;
  return (int)std::max<long>(
      1, std::min<long>(std::min(kWgMaxStages, tiles), budget / CF::STAGE));
}

template <typename T, class CF>
cudaError_t launch_wg(const void* q, const void* k, const void* v, void* o,
                      const int* off, int B, int Hq, int Hkv, int Sq,
                      int Skv, int Dk, int Dv, float scale, int causal,
                      int has_window, int window, cudaStream_t s) {
  static PerDevice limit_set;
  static int sms[kMaxDevices];
  int dev = 0;
  const cudaError_t limit = once_per_device(limit_set, [&] {
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(flash_wg_kernel<T, CF>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kMaxDynamicSmem);
  });
  if (limit != cudaSuccess) return limit;
  const cudaError_t de = cudaGetDevice(&dev);
  if (de != cudaSuccess) return de;
  CUtensorMap qm, km, vm;
  cudaError_t e = wg_map<T>(&qm, q, Dk, Sq, B * Hq);
  if (e == cudaSuccess) e = wg_map<T>(&km, k, Dk, Skv, B * Hkv);
  if (e == cudaSuccess) e = wg_map<T>(&vm, v, Dv, Skv, B * Hkv);
  if (e != cudaSuccess) return e;
  const bool spill = Skv > kChunk;
  const int ns = wg_stages<CF>(Skv);
  const size_t smem = wg_smem<CF>(ns, spill);
  if (smem > (size_t)kMaxDynamicSmem) return cudaErrorInvalidValue;
  // persistent blocks: one an SM, at most one a work item
  const long long items = (long long)((Sq + CF::BQ - 1) / CF::BQ) * Hq * B;
  const unsigned grid =
      (unsigned)(CF::PERSIST ? std::min<long long>(items, sms[dev]) : items);
  flash_wg_kernel<T, CF><<<grid, CF::THREADS, smem, s>>>(
      qm, km, vm, static_cast<T*>(o), off, B, Hq, Hkv, Sq, Skv, Dk, Dv,
      scale, causal, has_window, window, ns, spill ? 1 : 0);
  return cudaSuccess;
}

// the wgmma route's head-width classes (boxes of 64 across Dk, across
// Dv; consumers), mirrored by kernels/ops.py:FLASH_WG_CLASSES; any other
// shape is refused (the plan never sends one here)
template <typename T>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, const int* off, int B, int Hq, int Hkv,
                         int Sq, int Skv, int Dk, int Dv, float scale,
                         int causal, int has_window, int window,
                         cudaStream_t s) {
  const int nbk = (Dk + kWgBox - 1) / kWgBox, nbv = (Dv + kWgBox - 1) / kWgBox;
#define REPRO_WG_CLASS(BK_, BV_, NC_)                                        \
  if (nbk == BK_ && nbv == BV_)                                             \
    return launch_wg<T, WgCfg<BK_, BV_, NC_>>(q, k, v, o, off, B, Hq, Hkv,  \
                                              Sq, Skv, Dk, Dv, scale,       \
                                              causal, has_window, window, s);
  REPRO_WG_CLASS(1, 1, 2)
  REPRO_WG_CLASS(2, 1, 2)
  REPRO_WG_CLASS(2, 2, 2)
  REPRO_WG_CLASS(3, 2, 2)
  REPRO_WG_CLASS(4, 4, 1)
#undef REPRO_WG_CLASS
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_16bit(const void* q, const void* k, const void* v,
                         void* o, const int* off, void* ws,
                         long long ws_bytes, int B, int Hq, int Hkv, int Sq,
                         int Skv, int Dk, int Dv, float scale, int causal,
                         int has_window, int window, int route,
                         cudaStream_t s) {
  if (route == kRouteWgmma)
    return launch_wgmma<T>(q, k, v, o, off, B, Hq, Hkv, Sq, Skv, Dk, Dv,
                           scale, causal, has_window, window, s);
  return launch_mma<T>(q, k, v, o, off, ws, ws_bytes, B, Hq, Hkv, Sq, Skv,
                       Dk, Dv, scale, causal, has_window, window, s);
}

// -- f32: the CUDA cores, a warp a few rows, lanes over keys -----------------
//
// A block is 4 warps; warp w owns block rows [w * R, w * R + R).  Shared
// memory: one mbarrier per copy group of each stage, the block's Q rows,
// then (at a 1024-byte boundary) the ring.  A stage holds a 64-key tile of
// K and of V as 32-key halves, each half a row of boxes of 32 keys x 32
// floats (4 KB) that the TMA unit copies from a tensor map with the
// 128-byte swizzle: 16-byte chunk x of key row r lands at chunk x ^ (r %
// 8), so the 8 lanes that read one chunk of 8 rows hit 8 distinct bank
// quads, and the rows need no padding.  The last warp issues a stage in
// four groups -- K's keys 0-31, K's 32-63, V's 0-31, V's 32-63 -- each
// completing its own mbarrier, so a warp waits for exactly the keys it is
// about to read and no block barrier stands between a copy landing and
// its use.  Keys past Skv and columns past the head width are outside the
// tensor map and land as zeros.  Mirrored by kernels/ops.py:flash_plan.
constexpr int kHalf = BK / 2;          // keys of one copy group
constexpr int kBox = 32;               // floats of a box row: 128 bytes
constexpr int kBoxFloats = kHalf * kBox;
constexpr int kF32Groups = 4;          // copy groups a stage
constexpr int kF32MaxStages = 4;
constexpr int kF32Bars = 128;          // bytes of mbarriers before Q
constexpr int kSwizzleAlign = 1024;    // the 128-byte swizzle's period
constexpr int kSmemPerSM = 233472;     // shared memory of one SM (228 KB)
constexpr int kSmemPerBlock = 1024;    // reserved by the system per block

// boxes across a head width
__host__ __device__ __forceinline__ int f32_boxes(int d) {
  return (d + kBox - 1) / kBox;
}

__host__ __device__ __forceinline__ size_t f32_stage_bytes(int dk, int dv) {
  return (size_t)2 * (f32_boxes(dk) + f32_boxes(dv)) * kBoxFloats * 4;
}

// float index of chunk (row r, column c) in a run of boxes
__device__ __forceinline__ int f32_swz(int r, int c) {
  return ((c >> 5) * kBoxFloats) + r * kBox + ((c & 28) ^ ((r & 7) << 2));
}

// the producer warp's copies of one stage: keys [k0, k0 + 64) of K and V
// (slice ``bh`` of the maps) into ``ks``, a box a lane, in four groups,
// each announcing its bytes on its mbarrier first; the first ``qrows`` Q
// rows (lane i's at ``qrow``) join the first group.  K and V carry L2's
// evict-first policy: each is read once a call, and decode at position
// 255 measured 6% faster with it than with the normal policy.
__device__ __forceinline__ void f32_load_stage(
    float* ks, uint64_t* bars, const CUtensorMap* kmap,
    const CUtensorMap* vmap, int bh, int k0, int Skv, int nbk, int nbv,
    int Dk, int qrows, const float* qrow, float* Qs) {
  const int lane = threadIdx.x & 31;
  const uint64_t policy = tc::l2_policy_evict_first();
  float* vs = ks + 2 * nbk * kBoxFloats;
#pragma unroll
  for (int g = 0; g < kF32Groups; ++g) {
    const int h = g & 1, r0 = k0 + h * kHalf;
    const bool any = r0 < Skv;
    const int nb = g < 2 ? nbk : nbv;
    const int qb = g == 0 ? qrows * Dk * 4 : 0;
    if (lane == 0)
      mbar_expect_tx(bars + g,
                     (unsigned)((any ? nb * kBoxFloats * 4 : 0) + qb));
    __syncwarp();
    if (any && lane < nb) {
      if (g < 2)
        tma_box(ks + (h * nbk + lane) * kBoxFloats, kmap, lane * kBox, r0,
                bh, bars + g, policy);
      else
        tma_box(vs + (h * nbv + lane) * kBoxFloats, vmap, lane * kBox, r0,
                bh, bars + g, policy);
    }
    if (g == 0 && lane < qrows) bulk_copy(Qs + lane * Dk, qrow, Dk * 4, bars);
  }
}

// R: rows a warp; NC: float4 column groups a lane (Dv <= 128 * NC)
template <int R, int NC>
__global__ void __launch_bounds__(kFT, 1)
    flash_f32_kernel(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const float* __restrict__ Q, float* __restrict__ O,
                     const int* __restrict__ q_offset, int Hq, int Hkv,
                     int Sq, int Skv, int Dk, int Dv, float scale, int causal,
                     int has_window, int window, int ns) {
  constexpr int BQ = kFW * R;
  // p.V's keys a batch (shuffles and V loads issued ahead of the FMAs),
  // and the score loop's unrolling: as many as the registers allow
  constexpr int PB = R * NC >= 4 ? 4 : 8;
  constexpr int DU = R == 1 ? 8 : (R == 2 ? 4 : 2);
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);   // [stage][group]
  float* Qs = reinterpret_cast<float*>(smem + kF32Bars);
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(Qs + BQ * Dk) + kSwizzleAlign - 1) &
      ~static_cast<uintptr_t>(kSwizzleAlign - 1));
  const int nbk = f32_boxes(Dk), nbv = f32_boxes(Dv);
  const int stage = 2 * (nbk + nbv) * kBoxFloats;

  // Sq == 1 (decode): the block's rows are the rep query heads that share
  // kv head blockIdx.y; else they are query rows of head blockIdx.y
  const int rep = Hq / Hkv;
  const bool packed = Sq == 1;
  const int b = blockIdx.z, hy = blockIdx.y;
  const int hk = packed ? hy : hy / rep;
  const int bh = b * Hkv + hk;   // the maps' slice
  const int R0 = blockIdx.x * BQ;
  const int rows = min(BQ, (packed ? rep : Sq) - R0);
  // (b, head, query) row of block row r
  auto grow = [&](int r) -> size_t {
    return packed ? (size_t)b * Hq + hy * rep + R0 + r
                  : ((size_t)b * Hq + hy) * Sq + R0 + r;
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool producer = warp == kFW - 1;
  if (threadIdx.x < kF32Groups * ns) mbar_init(bars + threadIdx.x, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // the producer warp: every stage of the ring in flight from the start,
  // the Q rows joining stage 0's first group.  Without a window the first
  // tile any row can need is tile 0, so stage 0 goes out before the
  // offset is read (the block waits for it even if no row sees a key)
  const float* qrow = Q + grow(min(lane, rows - 1)) * Dk;
  const bool early = !has_window;
  if (producer && early)
    f32_load_stage(ring, bars, &kmap, &vmap, bh, 0, Skv, nbk, nbv, Dk, rows,
                   qrow, Qs);

  const int off = q_offset != nullptr ? *q_offset : 0;
  auto qpos = [&](int r) { return packed ? off : R0 + r + off; };
  // the KV tiles that can hold a key some row of this block sees
  const int q_first = qpos(0), q_last = qpos(rows - 1);
  const int n_tiles = (Skv + BK - 1) / BK;
  int t_end = n_tiles;
  if (causal) t_end = q_last < 0 ? 0 : min(n_tiles, q_last / BK + 1);
  const int t_begin = has_window ? max(0, q_first - window + 1) / BK : 0;
  const int nt = max(0, t_end - t_begin);
  // the stages issued: at least stage 0 where it went out early
  const int issued = early ? max(1, min(ns, nt)) : min(ns, nt);

  if (producer) {
    for (int j = early ? 1 : 0; j < issued; ++j)
      f32_load_stage(ring + j * stage, bars + j * kF32Groups, &kmap, &vmap,
                     bh, (t_begin + j) * BK, Skv, nbk, nbv, Dk,
                     j == 0 ? rows : 0, qrow, Qs);
  }

  const int wr0 = warp * R;                     // the warp's first block row
  const int nr = max(0, min(R, rows - wr0));    // its rows that exist
  const int w_first = qpos(wr0), w_last = qpos(wr0 + max(nr, 1) - 1);
  const float scale2 = scale * 1.44269504088896341f;   // log2(e)
  // each row sees keys [lo, hi] (the causal, window and length limits as
  // one range); rows that do not exist see none
  int lo[R], hi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = qpos(wr0 + r);
    lo[r] = r < nr ? (has_window ? max(0, p - window + 1) : 0) : 1;
    hi[r] = r < nr ? (causal ? min(p, Skv - 1) : Skv - 1) : 0;
  }
  // the lane's output columns; a lane past Dv reads column 0 and never
  // stores
  int col[NC];
#pragma unroll
  for (int g = 0; g < NC; ++g)
    col[g] = g * 128 + lane * 4 < Dv ? g * 128 + lane * 4 : 0;

  float m[R], l[R], acc[R][NC][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int g = 0; g < NC; ++g)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[r][g][x] = 0.f;
  }
  // the lane's two scores per row (log2 units), then its two p
  float s[R][2];

  // the Q rows land with the first tile's first group
  if (nr > 0 && nt > 0) mbar_wait(bars, 0);
  int slot = 0;
  unsigned phase = 0;
  for (int j = 0; j < nt; ++j) {
    if (j > 0) {
      // tile j - 1 is done with: its slot takes tile j - 1 + ns, once
      // every group of it has landed (a group no warp read was never
      // waited for)
      if (j - 1 + ns < nt) {
        __syncthreads();
        if (producer) {
#pragma unroll
          for (int g = 0; g < kF32Groups; ++g)
            mbar_wait(bars + slot * kF32Groups + g, phase);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          f32_load_stage(ring + slot * stage, bars + slot * kF32Groups,
                         &kmap, &vmap, bh, (t_begin + j - 1 + ns) * BK, Skv,
                         nbk, nbv, Dk, 0, qrow, Qs);
        }
      }
      if (++slot == ns) {
        slot = 0;
        phase ^= 1u;
      }
    }
    const int k0 = (t_begin + j) * BK;
    // the halves some row of this warp can see: a half (or a tile) the
    // mask hides from all of them is skipped, which is exactly what
    // running it would do for each row (alpha 1, p 0)
    bool run[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int a = k0 + h * kHalf;
      run[h] = nr > 0 && a < Skv && (!causal || a <= w_last) &&
               (!has_window || a + kHalf - 1 > w_first - window);
    }
    if (!run[0] && !run[1]) continue;
    const float* ks = ring + slot * stage;
    const float* vs = ks + 2 * nbk * kBoxFloats;
    uint64_t* bar = bars + slot * kF32Groups;

    // scores of keys lane and lane + 32: four chains over d, d = c mod 4
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!run[h]) {
#pragma unroll
        for (int r = 0; r < R; ++r) s[r][h] = kNegInf;
        continue;
      }
      mbar_wait(bar + h, phase);
      const float* kr = ks + h * nbk * kBoxFloats;
      float c[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int x = 0; x < 4; ++x) c[r][x] = 0.f;
#pragma unroll DU
      for (int d = 0; d < Dk; d += 4) {
        const float4 kv =
            *reinterpret_cast<const float4*>(kr + f32_swz(lane, d));
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 qv =
              *reinterpret_cast<const float4*>(Qs + (wr0 + r) * Dk + d);
          c[r][0] = fmaf(qv.x, kv.x, c[r][0]);
          c[r][1] = fmaf(qv.y, kv.y, c[r][1]);
          c[r][2] = fmaf(qv.z, kv.z, c[r][2]);
          c[r][3] = fmaf(qv.w, kv.w, c[r][3]);
        }
      }
      const int key = k0 + h * kHalf + lane;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dot = __fadd_rn(__fadd_rn(c[r][0], c[r][1]),
                                    __fadd_rn(c[r][2], c[r][3]));
        s[r][h] = key >= lo[r] && key <= hi[r] ? __fmul_rn(dot, scale2)
                                               : kNegInf;
      }
    }

    // the online softmax, as the Pallas kernel: a row that has seen no
    // key yet subtracts 0 (exp(-1e30 - -1e30) = 1 would pollute it), and
    // a max that did not move rescales by exactly 1; masked scores give
    // exp2(-1e30 - m) = 0
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = fmaxf(s[r][0], s[r][1]);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mn = fmaxf(m[r], mx);
      const float ms = mn <= kNegInf * 0.5f ? 0.f : mn;
      const float al = m[r] == mn ? 1.f : ex2(__fsub_rn(m[r], mn));
      s[r][0] = ex2(__fsub_rn(s[r][0], ms));
      s[r][1] = ex2(__fsub_rn(s[r][1], ms));
      float rs = __fadd_rn(s[r][0], s[r][1]);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, w));
      l[r] = __fadd_rn(__fmul_rn(al, l[r]), rs);
      m[r] = mn;
#pragma unroll
      for (int g = 0; g < NC; ++g)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[r][g][x] = __fmul_rn(acc[r][g][x], al);
    }

    // acc += p V over each half's keys in ascending order, p from the
    // lane that holds it (keys past Skv: zero rows, p 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!run[h]) continue;
      mbar_wait(bar + 2 + h, phase);
      const float* vr = vs + h * nbv * kBoxFloats;
      // 8 keys a step: key j0 + u's row of the lane's boxes, at swizzled
      // chunk (column / 4) ^ u
#pragma unroll 1
      for (int j0 = 0; j0 < kHalf; j0 += 8) {
#pragma unroll
        for (int u0 = 0; u0 < 8; u0 += PB) {
          float pj[PB][R];
          float4 vv[PB][NC];
#pragma unroll
          for (int u = 0; u < PB; ++u) {
#pragma unroll
            for (int r = 0; r < R; ++r)
              pj[u][r] = __shfl_sync(0xffffffffu, s[r][h], j0 + u0 + u);
#pragma unroll
            for (int g = 0; g < NC; ++g)
              vv[u][g] = *reinterpret_cast<const float4*>(
                  vr + j0 * kBox + f32_swz(u0 + u, col[g]));
          }
#pragma unroll
          for (int u = 0; u < PB; ++u)
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
              for (int g = 0; g < NC; ++g) {
                acc[r][g][0] = fmaf(pj[u][r], vv[u][g].x, acc[r][g][0]);
                acc[r][g][1] = fmaf(pj[u][r], vv[u][g].y, acc[r][g][1]);
                acc[r][g][2] = fmaf(pj[u][r], vv[u][g].z, acc[r][g][2]);
                acc[r][g][3] = fmaf(pj[u][r], vv[u][g].w, acc[r][g][3]);
              }
        }
      }
    }
  }

  // no copy may still be writing to shared memory when the block exits
  if (producer) {
    for (int j = max(0, max(nt, issued) - ns); j < max(nt, issued); ++j)
#pragma unroll
      for (int g = 0; g < kF32Groups; ++g)
        mbar_wait(bars + (j % ns) * kF32Groups + g, (unsigned)(j / ns) & 1u);
  }

  // out = acc / l (a row that saw no key: 0 / 1 = 0)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= nr) break;
    const float dl = l[r] == 0.f ? 1.f : l[r];
    float* o = O + grow(wr0 + r) * Dv;
#pragma unroll
    for (int g = 0; g < NC; ++g) {
      if (g * 128 + lane * 4 >= Dv) continue;
      *reinterpret_cast<float4*>(o + col[g]) = make_float4(
          __fdiv_rn(acc[r][g][0], dl), __fdiv_rn(acc[r][g][1], dl),
          __fdiv_rn(acc[r][g][2], dl), __fdiv_rn(acc[r][g][3], dl));
    }
  }
}

// The f32 launch, mirrored by kernels/ops.py:flash_plan: the most rows a
// warp (4, then 2) that a block's rows do not outnumber and that leaves
// at least a block an SM; else 1.  Stages: as many as fit the SM's
// shared memory split between the blocks it will run (1 to 3), 1 to 4,
// at most the cache's tiles.  Shared memory: the mbarriers and Q, the
// ring's alignment slack, the ring.
struct F32Launch {
  int r, nc, ns;
  dim3 grid;
  size_t smem;
};

inline F32Launch f32_launch(int B, int Hq, int Hkv, int Sq, int Skv, int Dk,
                            int Dv) {
  const bool packed = Sq == 1;
  const long nrows = packed ? Hq / Hkv : Sq;
  const long heads = packed ? Hkv : Hq;
  auto blocks = [&](int r) {
    return (nrows + kFW * r - 1) / (kFW * r) * heads * B;
  };
  int r = 1;
  for (int c : {4, 2})
    if (kFW * c <= nrows && blocks(c) >= kSMs) {
      r = c;
      break;
    }
  const size_t head = kF32Bars + (size_t)kFW * r * Dk * 4 + kSwizzleAlign;
  const size_t st = f32_stage_bytes(Dk, Dv);
  const long per_sm =
      std::min<long>(3, std::max<long>(1, (blocks(r) + kSMs - 1) / kSMs));
  const long budget = kSmemPerSM / per_sm - kSmemPerBlock - (long)head;
  int ns = (int)std::max<long>(1, std::min<long>(kF32MaxStages,
                                                 budget / (long)st));
  ns = std::min(ns, (Skv + BK - 1) / BK);
  while (ns > 1 && head + ns * st > (size_t)kMaxDynamicSmem) --ns;
  const dim3 grid((unsigned)((nrows + kFW * r - 1) / (kFW * r)),
                  (unsigned)heads, (unsigned)B);
  return {r, Dv <= 128 ? 1 : 2, ns, grid, head + ns * st};
}

// the 3-D map (column, key, b * Hkv + h) of a (B, Hkv, Skv, d) f32
// operand: boxes of 32 keys x 32 floats with the 128-byte swizzle; what
// lies outside it lands as zeros.  A host-side encoding: no device work,
// so a CUDA-graph capture may run it.
cudaError_t f32_map(CUtensorMap* map, const void* base, int d, int skv,
                    int bh) {
  const tma::EncodeTiled encode = tma::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)skv, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 4,
                                 (cuuint64_t)skv * (cuuint64_t)d * 4};
  const cuuint32_t box[3] = {kBox, kHalf, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int R, int NC>
cudaError_t launch_f32_rc(const CUtensorMap& km, const CUtensorMap& vm,
                          const void* q, void* o, const int* off,
                          const F32Launch& p, int Hq, int Hkv, int Sq,
                          int Skv, int Dk, int Dv, float scale, int causal,
                          int has_window, int window, cudaStream_t s) {
  // raise the instantiation's dynamic shared memory limit once per
  // device, to the most a block may use, and ask for the largest shared
  // memory carveout, so that several blocks share an SM
  static PerDevice limit_set;
  const cudaError_t limit = once_per_device(limit_set, [] {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_f32_kernel<R, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxDynamicSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(flash_f32_kernel<R, NC>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  });
  if (limit != cudaSuccess) return limit;
  flash_f32_kernel<R, NC><<<p.grid, kFT, p.smem, s>>>(
      km, vm, static_cast<const float*>(q), static_cast<float*>(o), off, Hq,
      Hkv, Sq, Skv, Dk, Dv, scale, causal, has_window, window, p.ns);
  return cudaSuccess;
}

template <int R>
cudaError_t launch_f32_r(const CUtensorMap& km, const CUtensorMap& vm,
                         const void* q, void* o, const int* off,
                         const F32Launch& p, int Hq, int Hkv, int Sq, int Skv,
                         int Dk, int Dv, float scale, int causal,
                         int has_window, int window, cudaStream_t s) {
  if (p.nc == 1)
    return launch_f32_rc<R, 1>(km, vm, q, o, off, p, Hq, Hkv, Sq, Skv, Dk, Dv,
                               scale, causal, has_window, window, s);
  return launch_f32_rc<R, 2>(km, vm, q, o, off, p, Hq, Hkv, Sq, Skv, Dk, Dv,
                             scale, causal, has_window, window, s);
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       const int* off, int B, int Hq, int Hkv, int Sq,
                       int Skv, int Dk, int Dv, float scale, int causal,
                       int has_window, int window, cudaStream_t s) {
  const F32Launch p = f32_launch(B, Hq, Hkv, Sq, Skv, Dk, Dv);
  CUtensorMap km, vm;
  cudaError_t e = f32_map(&km, k, Dk, Skv, B * Hkv);
  if (e == cudaSuccess) e = f32_map(&vm, v, Dv, Skv, B * Hkv);
  if (e != cudaSuccess) return e;
  switch (p.r) {
    case 4:
      return launch_f32_r<4>(km, vm, q, o, off, p, Hq, Hkv, Sq, Skv, Dk, Dv,
                             scale, causal, has_window, window, s);
    case 2:
      return launch_f32_r<2>(km, vm, q, o, off, p, Hq, Hkv, Sq, Skv, Dk, Dv,
                             scale, causal, has_window, window, s);
    default:
      return launch_f32_r<1>(km, vm, q, o, off, p, Hq, Hkv, Sq, Skv, Dk, Dv,
                             scale, causal, has_window, window, s);
  }
}

}  // namespace

// route: the 16-bit route kernels/ops.py:flash_plan chose (kRouteMma,
// kRouteWgmma; ignored for f32); ws: the mma.sync route's workspace
// where Skv spans more than one chunk (ws_bytes of it, from the caching
// allocator)
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o,
                                     const void* q_offset, void* ws,
                                     long long ws_bytes, int B, int Hq,
                                     int Hkv, int Sq, int Skv, int Dk, int Dv,
                                     float scale, int causal, int has_window,
                                     int window, int dtype, int route,
                                     void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(q_offset);
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Skv < 1 ||
      Dk < 1 || Dv < 1 || Dk > 2 * kFT || Dv > 2 * kFT)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  switch (dtype) {
    case kF32:
      if (Dk % 4 || Dv % 4) return (int)cudaErrorInvalidValue;
      err = launch_f32(q, k, v, o, off, B, Hq, Hkv, Sq, Skv, Dk, Dv, scale,
                       causal, has_window, window, s);
      break;
    case kBF16:
    case kF16:
      if (Dk % 8 || Dv % 8 || (route != kRouteMma && route != kRouteWgmma))
        return (int)cudaErrorInvalidValue;
      err = dtype == kBF16
                ? launch_16bit<__nv_bfloat16>(q, k, v, o, off, ws, ws_bytes,
                                              B, Hq, Hkv, Sq, Skv, Dk, Dv,
                                              scale, causal, has_window,
                                              window, route, s)
                : launch_16bit<__half>(q, k, v, o, off, ws, ws_bytes, B, Hq,
                                       Hkv, Sq, Skv, Dk, Dv, scale, causal,
                                       has_window, window, route, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
