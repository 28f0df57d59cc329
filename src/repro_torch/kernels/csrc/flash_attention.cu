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
// Design, f32 (CUDA cores; no TF32: f32 means f32): one block of 128
// threads per (query tile of 1, 4 or 16 rows, head, batch row); each
// 64-key K and V tile is copied into shared memory and waited for; each
// score is one thread's dot product in ascending d, each row's max and
// sum one warp's in a fixed order, each output column one thread's sum
// over the tile's keys in ascending order, then acc * alpha + pv.
#include <algorithm>
#include <type_traits>

#include "tc_gemm.cuh"

namespace {

using namespace repro;
using tc::cp_async16;

constexpr int kFT = 128;            // threads per block: 4 warps
constexpr int kFW = kFT / 32;
constexpr int BK = 64;              // keys per KV tile (fixed)
constexpr float kNegInf = -1e30f;   // the reference's mask value

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ void load_vec_shared(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec<T>; ++i) out[i] = to_f32(e[i]);
}

struct Mask {
  int skv, causal, has_window, window;
  __device__ __forceinline__ bool visible(int kpos, int qpos) const {
    return kpos < skv && (!causal || kpos <= qpos) &&
           (!has_window || kpos > qpos - window);
  }
};

// rows [r0, r0 + BK) of a (rows, D) matrix into shared memory, row pitch
// D + kVec<T>; rows at or past ``rows`` are zero
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0,
                                          int rows, int D) {
  constexpr int V = kVec<T>;
  const int nv = D / V;
  const int pitch = D + V;
  for (int e = threadIdx.x; e < BK * nv; e += kFT) {
    const int r = e / nv, c = e - r * nv;
    const bool valid = r0 + r < rows;
    const T* g = valid ? src + (size_t)(r0 + r) * D + c * V : src;
    cp_async16(dst + r * pitch + c * V, g, valid);
  }
}

template <typename T, int BQ>
size_t smem_bytes(int Dk, int Dv) {
  constexpr int V = kVec<T>;
  return (size_t)BK * (Dk + V) * sizeof(T) + (size_t)BK * (Dv + V) * sizeof(T)
         + (size_t)BQ * Dk * 4 + (size_t)BQ * BK * 4 + 3 * BQ * 4;
}

// RC: output columns per thread (Dv <= 128 * RC)
template <typename T, int BQ, int RC>
__global__ void __launch_bounds__(kFT)
    flash_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                 const T* __restrict__ Vg, T* __restrict__ O,
                 const int* __restrict__ q_offset, int Hq, int Hkv, int Sq,
                 int Skv, int Dk, int Dv, float scale, int causal,
                 int has_window, int window) {
  constexpr int V = kVec<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = Dk + V, vp = Dv + V;
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BK * kp;
  float* Qs = reinterpret_cast<float*>(Vs + BK * vp);
  float* Ss = Qs + BQ * Dk;        // scores, then probabilities
  float* Ms = Ss + BQ * BK;        // running max per row
  float* Ls = Ms + BQ;             // running sum per row
  float* As = Ls + BQ;             // this tile's rescale per row

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int rows = min(BQ, Sq - q0);
  const int off = q_offset != nullptr ? *q_offset : 0;
  const Mask mask{Skv, causal, has_window, window};

  const T* q = Q + ((size_t)(b * Hq + h) * Sq + q0) * Dk;
  const T* k = K + (size_t)(b * Hkv + hk) * Skv * Dk;
  const T* v = Vg + (size_t)(b * Hkv + hk) * Skv * Dv;
  T* o = O + ((size_t)(b * Hq + h) * Sq + q0) * Dv;

  for (int e = threadIdx.x; e < BQ * Dk; e += kFT)
    Qs[e] = e / Dk < rows ? to_f32(q[e]) : 0.f;
  if (threadIdx.x < BQ) {
    Ms[threadIdx.x] = kNegInf;
    Ls[threadIdx.x] = 0.f;
  }

  // the KV tiles that can hold a key some row of this block sees
  const int q_first = q0 + off, q_last = q0 + rows - 1 + off;
  const int n_tiles = (Skv + BK - 1) / BK;
  int t_end = n_tiles;
  if (causal) t_end = q_last < 0 ? 0 : min(n_tiles, q_last / BK + 1);
  const int t_begin = has_window ? max(0, q_first - window + 1) / BK : 0;

  float acc[BQ][RC];
#pragma unroll
  for (int i = 0; i < BQ; ++i)
#pragma unroll
    for (int r = 0; r < RC; ++r) acc[i][r] = 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    load_tile(Ks, k, k0, Skv, Dk);
    load_tile(Vs, v, k0, Skv, Dv);
    cp_async_wait_all();
    __syncthreads();

    // scores: one (row, key) pair per thread, the dot product in
    // ascending d
    for (int e = threadIdx.x; e < BQ * BK; e += kFT) {
      const int i = e / BK, j = e - i * BK;
      const float* qi = Qs + i * Dk;
      const T* kj = Ks + j * kp;
      float s = 0.f;
      for (int d = 0; d < Dk; d += V) {
        float kv[V];
        load_vec_shared(kj + d, kv);
#pragma unroll
        for (int x = 0; x < V; ++x) s = fmaf(qi[d + x], kv[x], s);
      }
      Ss[e] = mask.visible(k0 + j, q0 + i + off) ? s * scale : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per row, lanes over the tile's keys
    for (int i = warp; i < BQ; i += kFW) {
      float* si = Ss + i * BK;
      const int qpos = q0 + i + off;
      float mc = kNegInf;
      for (int j = lane; j < BK; j += 32) mc = fmaxf(mc, si[j]);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, w));
      const float mp = Ms[i];
      const float mn = fmaxf(mp, mc);
      // a row that has seen no key yet: exp(-1e30 - -1e30) = 1 would
      // pollute the sum, so rescale with 0 instead
      const bool dead = mn <= kNegInf * 0.5f;
      const float msafe = dead ? 0.f : mn;
      float rs = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = mask.visible(k0 + j, qpos) ? expf(si[j] - msafe) : 0.f;
        si[j] = p;
        rs += p;
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, w);
      if (lane == 0) {
        const float alpha = expf(dead ? 0.f : mp - mn);
        As[i] = alpha;
        Ls[i] = alpha * Ls[i] + rs;
        Ms[i] = mn;
      }
    }
    __syncthreads();

    // p.V in f32: thread t owns columns t, t + 128, summed over the
    // tile's keys in ascending order
    float pv[BQ][RC];
#pragma unroll
    for (int i = 0; i < BQ; ++i)
#pragma unroll
      for (int r = 0; r < RC; ++r) pv[i][r] = 0.f;
    for (int j = 0; j < BK; ++j) {
      float vj[RC];
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        const int c = threadIdx.x + r * kFT;
        vj[r] = c < Dv ? to_f32(Vs[j * vp + c]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < BQ; ++i) {
        const float p = Ss[i * BK + j];
#pragma unroll
        for (int r = 0; r < RC; ++r) pv[i][r] = fmaf(p, vj[r], pv[i][r]);
      }
    }
#pragma unroll
    for (int i = 0; i < BQ; ++i) {
      const float a = As[i];
#pragma unroll
      for (int r = 0; r < RC; ++r) acc[i][r] = fmaf(acc[i][r], a, pv[i][r]);
    }
    __syncthreads();   // the next tile overwrites Ks, Vs and Ss
  }

#pragma unroll
  for (int i = 0; i < BQ; ++i) {
    if (i >= rows) break;
    const float l = Ls[i];
    const float safe_l = l == 0.f ? 1.f : l;
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const int c = threadIdx.x + r * kFT;
      if (c < Dv) o[(size_t)i * Dv + c] = from_f32<T>(acc[i][r] / safe_l);
    }
  }
}

template <typename T, int BQ, int RC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* off, int B, int Hq, int Hkv, int Sq, int Skv,
                   int Dk, int Dv, float scale, int causal, int has_window,
                   int window, cudaStream_t s) {
  const size_t smem = smem_bytes<T, BQ>(Dk, Dv);
  // raise the instantiation's dynamic shared memory limit once per
  // device, to the most any call can need (Dk = Dv = 256)
  static PerDevice limit_set;
  const cudaError_t limit = once_per_device(limit_set, [] {
    return cudaFuncSetAttribute(
        flash_kernel<T, BQ, RC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<T, BQ>(2 * kFT, 2 * kFT));
  });
  if (limit != cudaSuccess) return limit;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)Hq, (unsigned)B);
  flash_kernel<T, BQ, RC><<<grid, kFT, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), off, Hq, Hkv, Sq, Skv,
      Dk, Dv, scale, causal, has_window, window);
  return cudaSuccess;
}

template <typename T, int BQ>
cudaError_t launch_rc(const void* q, const void* k, const void* v, void* o,
                      const int* off, int B, int Hq, int Hkv, int Sq,
                      int Skv, int Dk, int Dv, float scale, int causal,
                      int has_window, int window, cudaStream_t s) {
  if (Dv <= kFT)
    return launch<T, BQ, 1>(q, k, v, o, off, B, Hq, Hkv, Sq, Skv, Dk, Dv,
                            scale, causal, has_window, window, s);
  return launch<T, BQ, 2>(q, k, v, o, off, B, Hq, Hkv, Sq, Skv, Dk, Dv,
                          scale, causal, has_window, window, s);
}

// query rows per block of the f32 route, mirrored by
// kernels/ops.py:flash_plan
inline int pick_bq(int sq) { return sq <= 1 ? 1 : (sq <= 4 ? 4 : 16); }

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
      if (Dk % kVec<float> || Dv % kVec<float>)
        return (int)cudaErrorInvalidValue;
      switch (pick_bq(Sq)) {
        case 1:
          err = launch_rc<float, 1>(q, k, v, o, off, B, Hq, Hkv, Sq, Skv, Dk,
                                    Dv, scale, causal, has_window, window, s);
          break;
        case 4:
          err = launch_rc<float, 4>(q, k, v, o, off, B, Hq, Hkv, Sq, Skv, Dk,
                                    Dv, scale, causal, has_window, window, s);
          break;
        default:
          err = launch_rc<float, 16>(q, k, v, o, off, B, Hq, Hkv, Sq, Skv,
                                     Dk, Dv, scale, causal, has_window,
                                     window, s);
          break;
      }
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
