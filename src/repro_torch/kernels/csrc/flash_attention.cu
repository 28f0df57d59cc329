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
// Design, bf16 and f16 (FA2's layout on mma.sync.m16n8k16):
// - Blocks of 4 warps, one per (query-row tile, head, batch row).  Each
//   warp owns 16 query rows: prefill tiles are 64 rows (32 rows and two
//   column halves per warp pair for heads wider than 128, so the
//   accumulators stay in registers).  Sq <= 16 uses one 16-row fragment
//   (padding rows zero, never stored) and the 4 warps split the output
//   columns.  At decode (Sq 1) the fragment's rows are the rep query heads
//   that share a kv head, so K and V are read once for all of them.
// - Scores on the tensor cores: S = Q K^T with Q's fragments (ldmatrix)
//   and the 16 x 64 scores of a tile in registers; K fragments by
//   ldmatrix from shared memory.  Each row's max and sum are taken over
//   the thread's 16 values in order, then over the quad of lanes that
//   share the row, in one shuffle order.  The scores are scaled into log2
//   units so each exponential is one SFU ex2 (~2 ulp); a tile the mask
//   leaves whole for the warp's rows skips the mask, and a fragment half
//   that holds only padding rows skips the softmax.  No shared-memory
//   round trip for S and no block barrier between scores, softmax and
//   p.V.
// - p.V on the tensor cores with p at f32 precision: p goes from the
//   score registers straight into A fragments split as hi = T(p) and lo =
//   T(p - hi), two mma into the same f32 accumulator.  Rounding p to 16
//   bits alone would be attention_ref's function (p cast to v's dtype),
//   not the Pallas kernel's f32 p.V; hi + lo keeps p to ~2^-16 relative
//   in bf16.  The second mma hides under the K/V stream at decode; in a
//   prefill, where each tile feeds 16 rows a warp, mma.sync's rate (half
//   of wgmma's) leaves part of it exposed -- wgmma is the next step.
// - A ring of 64-key K and V tiles (4 stages; 3 for heads over 128 and
//   for decode at width 128, so two decode blocks share an SM; at most as
//   many as the cache has tiles) filled by 16-byte cp.async, all stages
//   in flight from the start and each refilled as soon as its tile is
//   done: the next tiles load while the current one is multiplied.  (At
//   decode position 255, 2, 3 or 4 stages measured the same for 128
//   blocks; 3 halved the waves once there are more (slot, kv head) pairs
//   than SMs.)  Rows are padded by 16 bytes so
//   ldmatrix hits distinct banks; head widths that are no multiple of 16
//   are zero-padded in shared memory.  The copies keep L2's normal
//   policy: evict-first measured no faster at decode.
// - Tiles are skipped by the causal and window limits of the block's
//   rows (the Pallas kernel's pl.when(run)), and a warp skips a tile its
//   own rows cannot see; q_offset is read on the device (the decode
//   position is a carry of the fused chunk and never crosses to the
//   host).
// Reduction order: a row's scores are summed over d in ascending k16
// steps, its max and sum in the fixed thread-then-quad order, and its
// output over the tiles in ascending order, each tile's keys in
// ascending k16 steps (hi then lo).  None of it depends on B, Sq, the
// query tile, the row's place in its fragment, the column split, the grid
// or the run; a tile that is fully masked for a row, run or skipped, is
// an exact no-op for it (alpha 1, p 0).  So decode at position p gives
// row p of the causal prefill bit for bit.  No split-KV, no atomics.
//
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

#include "tma.cuh"

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

// -- bf16, f16: tensor cores and a K/V copy ring -----------------------------
//
// A block is 4 warps.  The warps split the block's query rows into RW
// fragments of 16 rows and the output columns into CW = 4 / RW groups:
// prefill takes 4 x 16 = 64 rows (2 x 16 with 2 column groups for head
// widths over 128, so the accumulators stay in registers), and Sq <= 16 --
// decode -- one 16-row fragment with the 4 warps on 4 column groups (each
// warp computes the fragment's scores itself, in the same order).  W is
// the head-width class (64, 128 or 256) that sizes the register arrays.
template <int W_, int RW_, int STAGES_>
struct FlashCfg {
  static constexpr int W = W_, RW = RW_, CW = kFW / RW_, STAGES = STAGES_;
  static constexpr int BQ = 16 * RW;      // query rows per block
  static constexpr int WC = W / CW;       // output columns per warp
  static constexpr int NF = WC / 8;       // n8 fragments of O per warp
  static constexpr bool QREG = W <= 128;  // Q fragments held in registers
  static_assert(RW * CW == kFW && WC % 16 == 0, "");
};

// shared memory: the Q tile, then ``ns`` stages of a K and a V tile, rows
// padded by 8 elements (16 bytes) so that ldmatrix's 8 row addresses hit
// 8 distinct bank quads; mirrored by kernels/ops.py:flash_plan
template <typename T>
__host__ __device__ __forceinline__ size_t tc_smem(int bq, int dkp, int dvp,
                                                   int ns) {
  return ((size_t)bq * (dkp + 8) + (size_t)ns * BK * (dkp + 8 + dvp + 8)) *
         sizeof(T);
}

// rows [r0, r0 + BK) of K (width d, padded to dp) into shared memory at
// pitch dp + 8; rows past ``rows`` and columns past d are zero
template <typename T>
__device__ __forceinline__ void load_kv_tile(T* dst, const T* src, int r0,
                                             int rows, int d, int dp,
                                             uint64_t policy) {
  const int nc = dp / 8, pitch = dp + 8;
  if (kFT % nc == 0) {   // a fixed chunk per thread, no division per copy
    const int c = threadIdx.x % nc;
    for (int r = threadIdx.x / nc; r < BK; r += kFT / nc) {
      const bool ok = r0 + r < rows && c * 8 < d;
      tc::cp_async16(dst + r * pitch + c * 8,
                     ok ? src + (size_t)(r0 + r) * d + c * 8 : src, ok,
                     policy);
    }
    return;
  }
  for (int e = threadIdx.x; e < BK * nc; e += kFT) {
    const int r = e / nc, c = e - r * nc;
    const bool ok = r0 + r < rows && c * 8 < d;
    tc::cp_async16(dst + r * pitch + c * 8,
                   ok ? src + (size_t)(r0 + r) * d + c * 8 : src, ok, policy);
  }
}

// 2^x by the SFU (ex2.approx, ~2 ulp): the softmax's exponentials, on
// scores kept in log2 units
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// p (two f32 values) as hi + lo, each a pair of T: hi = T(p), lo =
// T(p - hi), so hi + lo keeps p to ~2^-16 relative in bf16
template <typename T>
__device__ __forceinline__ void split2(float a, float b, unsigned& hi,
                                       unsigned& lo) {
  const float ha = round_to<T>(a), hb = round_to<T>(b);
  hi = pack2<T>(ha, hb);
  lo = pack2<T>(a - ha, b - hb);
}

template <typename T, class CF>
__global__ void __launch_bounds__(kFT)
    flash_tc_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                    const T* __restrict__ Vg, T* __restrict__ O,
                    const int* __restrict__ q_offset, int Hq, int Hkv,
                    int Sq, int Skv, int Dk, int Dv, float scale, int causal,
                    int has_window, int window, int ns) {
  constexpr int W = CF::W, BQ = CF::BQ, NF = CF::NF, WC = CF::WC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int dkp = (Dk + 15) & ~15, dvp = (Dv + 15) & ~15;
  const int kp = dkp + 8, vp = dvp + 8;
  T* Qs = reinterpret_cast<T*>(smem);
  T* ring = Qs + BQ * kp;
  const int stage = BK * (kp + vp);

  // Sq == 1 (decode): the block's rows are the rep query heads that share
  // kv head blockIdx.y, so K and V are read once for all of them; else
  // they are query rows of head blockIdx.y
  const int rep = Hq / Hkv;
  const bool packed = Sq == 1;
  const int b = blockIdx.z, hy = blockIdx.y;
  const int hk = packed ? hy : hy / rep;
  const int R0 = blockIdx.x * BQ;
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
    load_kv_tile(ks, k, t * BK, Skv, Dk, dkp, policy);
    load_kv_tile(ks + BK * kp, v, t * BK, Skv, Dv, dvp, policy);
  };

  // block row R's absolute position
  const int off = q_offset != nullptr ? *q_offset : 0;
  auto qpos = [&](int R) { return packed ? off : R0 + R + off; };
  // the KV tiles that can hold a key some row of this block sees
  const int q_first = qpos(0), q_last = qpos(rows - 1);
  const int n_tiles = (Skv + BK - 1) / BK;
  int t_end = n_tiles;
  if (causal) t_end = q_last < 0 ? 0 : min(n_tiles, q_last / BK + 1);
  const int t_begin = has_window ? max(0, q_first - window + 1) / BK : 0;
  const int nt = max(0, t_end - t_begin);

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
  const int col0 = cg * WC;
  const float scale2 = scale * 1.44269504088896341f;   // log2(e)
  // each of the thread's two rows sees keys [lo, hi]: the causal, window
  // and length limits of Mask::visible as one range
  auto key_lo = [&](int p) { return has_window ? max(0, p - window + 1) : 0; };
  auto key_hi = [&](int p) { return causal ? min(p, Skv - 1) : Skv - 1; };
  const int lo0 = key_lo(p0), hi0 = key_hi(p0);
  const int lo1 = key_lo(p1), hi1 = key_hi(p1);

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

    // scale into log2 units, mask, and each row's max over the tile: the
    // thread's 16 values in order, then the quad of lanes that share the
    // row.  A tile the mask leaves whole for every row of the warp takes
    // no mask; the fragment's second half is skipped when it holds only
    // padding rows (Sq or rep <= 8).
    const bool full = k0 + BK <= Skv &&
                      (!causal || k0 + BK - 1 <= w_first) &&
                      (!has_window || k0 > w_last - window);
    const bool hi_live = rg * 16 + 8 < rows;
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
    const float al0 = m0 == mn0 ? 1.f : ex2(m0 - mn0);
    const float al1 = m1 == mn1 ? 1.f : ex2(m1 - mn1);
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
        split2<T>(S[2 * kk][0], S[2 * kk][1], ph[0], pl[0]);
        split2<T>(S[2 * kk][2], S[2 * kk][3], ph[1], pl[1]);
        split2<T>(S[2 * kk + 1][0], S[2 * kk + 1][1], ph[2], pl[2]);
        split2<T>(S[2 * kk + 1][2], S[2 * kk + 1][3], ph[3], pl[3]);
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

  // out = acc * (1 / l) (a row that saw no key: 0 * 1 = 0); padding rows
  // and columns are never stored
  const float rl0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float rl1 = 1.f / (l1 == 0.f ? 1.f : l1);
  T* o0 = O + grow(row0) * Dv;
  T* o1 = O + grow(row1) * Dv;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int c = col0 + f * 8 + qd;
    if (c >= Dv) continue;
    if (row0 < rows)
      *reinterpret_cast<unsigned*>(o0 + c) =
          pack2<T>(acc[f][0] * rl0, acc[f][1] * rl0);
    if (row1 < rows)
      *reinterpret_cast<unsigned*>(o1 + c) =
          pack2<T>(acc[f][2] * rl1, acc[f][3] * rl1);
  }
}

template <typename T, class CF>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      const int* off, int B, int Hq, int Hkv, int Sq,
                      int Skv, int Dk, int Dv, float scale, int causal,
                      int has_window, int window, cudaStream_t s) {
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
  const dim3 grid((unsigned)((nrows + CF::BQ - 1) / CF::BQ),
                  (unsigned)(Sq == 1 ? Hkv : Hq), (unsigned)B);
  flash_tc_kernel<T, CF><<<grid, kFT, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), off, Hq, Hkv, Sq, Skv,
      Dk, Dv, scale, causal, has_window, window, ns);
  return cudaSuccess;
}

// the head-width class and the block's rows, mirrored by
// kernels/ops.py:flash_plan
// STAGES for the RW-fragment tiles, DSTAGES for the one-fragment (decode)
// tile: at width 128, 3 stages let two decode blocks share an SM
template <typename T, int W, int RW, int STAGES, int DSTAGES>
cudaError_t launch_w(const void* q, const void* k, const void* v, void* o,
                     const int* off, int B, int Hq, int Hkv, int Sq,
                     int Skv, int Dk, int Dv, float scale, int causal,
                     int has_window, int window, cudaStream_t s) {
  const int nrows = Sq == 1 ? Hq / Hkv : Sq;
  if (nrows <= 16)
    return launch_tc<T, FlashCfg<W, 1, DSTAGES>>(
        q, k, v, o, off, B, Hq, Hkv, Sq, Skv, Dk, Dv, scale, causal,
        has_window, window, s);
  return launch_tc<T, FlashCfg<W, RW, STAGES>>(
      q, k, v, o, off, B, Hq, Hkv, Sq, Skv, Dk, Dv, scale, causal,
      has_window, window, s);
}

template <typename T>
cudaError_t launch_16bit(const void* q, const void* k, const void* v,
                         void* o, const int* off, int B, int Hq, int Hkv,
                         int Sq, int Skv, int Dk, int Dv, float scale,
                         int causal, int has_window, int window,
                         cudaStream_t s) {
  const int w = std::max((Dk + 15) & ~15, (Dv + 15) & ~15);
  if (w <= 64)
    return launch_w<T, 64, 4, 4, 4>(q, k, v, o, off, B, Hq, Hkv, Sq, Skv, Dk,
                                 Dv, scale, causal, has_window, window, s);
  if (w <= 128)
    return launch_w<T, 128, 4, 4, 3>(q, k, v, o, off, B, Hq, Hkv, Sq, Skv, Dk,
                                  Dv, scale, causal, has_window, window, s);
  return launch_w<T, 256, 2, 3, 3>(q, k, v, o, off, B, Hq, Hkv, Sq, Skv, Dk, Dv,
                                scale, causal, has_window, window, s);
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
constexpr int kSMs = 132;              // the H100's SMs
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

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o,
                                     const void* q_offset, int B, int Hq,
                                     int Hkv, int Sq, int Skv, int Dk, int Dv,
                                     float scale, int causal, int has_window,
                                     int window, int dtype, void* stream) {
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
      if (Dk % 8 || Dv % 8) return (int)cudaErrorInvalidValue;
      err = dtype == kBF16
                ? launch_16bit<__nv_bfloat16>(q, k, v, o, off, B, Hq, Hkv,
                                              Sq, Skv, Dk, Dv, scale, causal,
                                              has_window, window, s)
                : launch_16bit<__half>(q, k, v, o, off, B, Hq, Hkv, Sq, Skv,
                                       Dk, Dv, scale, causal, has_window,
                                       window, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
