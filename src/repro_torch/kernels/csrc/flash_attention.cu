// Flash attention for Hopper: out (B, Hq, Sq, Dv) = softmax(q k^T * scale
// + mask) v, with an online softmax over KV tiles.  q (B, Hq, Sq, Dk),
// k (B, Hkv, Skv, Dk), v (B, Hkv, Skv, Dv), out in q's dtype (f32, bf16
// or f16).  Query head h reads kv head h / (Hq / Hkv) (GQA, MQA) without
// repeating heads.  Scores are q.k * scale in f32; the mask is causal
// and/or a sliding window on absolute positions (query i at i + q_offset,
// key j at j; masked scores -1e30); the running max, sum and accumulator
// are f32 and p.V is taken in f32, as in the Pallas kernel.  A row that
// sees no key gives exactly 0.  Dv may differ from Dk.
//
// Replaces: src/repro/kernels/flash_attention.py:_flash_kernel.
//
// Bound on the H100: at the serving shapes the kernel does few
// operations per byte.  Decode (Sq 1) reads each visible K and V row
// once for one query row: ~1 flop per byte, so the bytes of K and V up
// to the query's position bound it (4 slots x 32 heads x 256 keys x 128
// x 2 B x 2 = 16.8 MB, ~5 us at 3.35 TB/s).  Prefill at 128 tokens
// reads q, k, v and writes out (16.8 MB for 4 x 32 heads) and does 0.54
// GFLOP under the causal mask: still the bytes, ~5 us.
//
// Design: one block of 128 threads per (query tile, head, batch row).
// A loop inside the block walks the KV tiles in ascending order -- the
// TPU kernel's sequential "arbitrary" grid axis -- and skips the tiles
// the mask hides from every row of the block (the Pallas kernel's
// pl.when(run)): causal stops after the tile that holds the last query's
// position, a window starts at the tile that holds the first query's
// oldest visible key, so decode at position p reads ceil((p+1)/64)
// tiles.  q_offset is read on the device (the decode position is a
// carry of the fused chunk and never crosses to the host).  K and V
// tiles of 64 keys are copied into shared memory with 16-byte cp.async
// (rows padded by one vector so the score loop's row-strided reads hit
// distinct banks), ragged rows filled with zeros; the q tile lives in
// shared memory as f32.  Each score is one thread's dot product in
// ascending d; each row's max and sum are taken by one warp in one fixed
// order; each output column is one thread's sum over the tile's keys in
// ascending order, then acc * alpha + pv.  So every output row is
// reduced in an order that depends only on Skv and the mask, never on
// B, Sq or the query tile (a tile skipped or run fully masked is an
// exact no-op for the row): no split-KV, no atomics, deterministic.  The
// query tile height follows Sq (1 row for decode, 4, or 16) so that
// decode wastes no rows.  CUDA-core FMAs; mma/wgmma, TMA and a
// multi-stage ring are later work.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kFT = 128;            // threads per block: 4 warps
constexpr int kFW = kFT / 32;
constexpr int BK = 64;              // keys per KV tile (fixed)
constexpr float kNegInf = -1e30f;   // the reference's mask value

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // 16 bytes global -> shared; with a source size of 0 the destination
  // is filled with zeros and nothing is read
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

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
  // raise the instantiation's dynamic shared memory limit once, to the
  // most any call can need (Dk = Dv = 256), off the per-launch path
  static const cudaError_t limit = cudaFuncSetAttribute(
      flash_kernel<T, BQ, RC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<T, BQ>(2 * kFT, 2 * kFT));
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

// query rows per block, mirrored by kernels/ops.py:flash_q_tile
inline int pick_bq(int sq) { return sq <= 1 ? 1 : (sq <= 4 ? 4 : 16); }

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
  REPRO_DISPATCH_DTYPE(dtype, T, {
    if (Dk % kVec<T> || Dv % kVec<T>) return (int)cudaErrorInvalidValue;
    switch (pick_bq(Sq)) {
      case 1:
        err = launch_rc<T, 1>(q, k, v, o, off, B, Hq, Hkv, Sq, Skv, Dk, Dv,
                              scale, causal, has_window, window, s);
        break;
      case 4:
        err = launch_rc<T, 4>(q, k, v, o, off, B, Hq, Hkv, Sq, Skv, Dk, Dv,
                              scale, causal, has_window, window, s);
        break;
      default:
        err = launch_rc<T, 16>(q, k, v, o, off, B, Hq, Hkv, Sq, Skv, Dk, Dv,
                               scale, causal, has_window, window, s);
        break;
    }
  });
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
