// Warpgroup products (wgmma) for Hopper: shared-memory matrix
// descriptors in the layouts the TMA unit writes, and the asynchronous
// m64n128k16 product with f32 accumulators.
//
// Layouts.  A stage of an operand holds 64 values of k: the k-tiles of
// two neighbouring lanes of the K order (32 k each, see the mainloop).
// Every tile sits under the 128-byte swizzle (16-byte chunk c of a
// 128-byte row r at chunk c ^ (r & 7)), a function of the shared-memory
// address, so each tile starts on 1024 bytes.  An operand whose k is
// contiguous (K-major: matmul's A, a (N, K) B) sits as [rows][64 k],
// 128-byte rows; k16 step j is 32 j bytes into each row.  An operand
// whose rows or columns are contiguous (MN-major: a row-major (K, N) B, a
// (K, M) A) sits as boxes of [64 k][64], a box each 64 columns; k16 step
// j is 16 j rows down.
#pragma once

#include <type_traits>

#include "tma.cuh"

namespace repro {
namespace wg {

constexpr int kTileK = 32;                  // k of a lane's k-tile
constexpr int kStageK = 2 * kTileK;         // k of a stage: two lanes
constexpr int kBoxMN = 64;                  // columns of an MN-major box
constexpr int kBoxBytes = kStageK * kBoxMN * 2;   // 8 KB

// byte offset of the element at logical byte offset ``o`` of a tile of
// 128-byte rows under the 128-byte swizzle
__host__ __device__ __forceinline__ int swz128(int o) {
  return o ^ (((o >> 7) & 7) << 4);
}

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the 128-byte swizzle (mode 1).
__device__ __forceinline__ uint64_t make_desc(const void* p, unsigned lbo,
                                              unsigned sbo) {
  const unsigned a = tc::smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// k16 step ``j`` of a K-major tile: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(const void* tile, int j) {
  return make_desc(static_cast<const char*>(tile) + 32 * j, 16, 1024);
}
// k16 step ``j`` of an MN-major tile: 8-row groups of k 1024 bytes
// apart, boxes of 64 columns kBoxBytes apart
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int j) {
  return make_desc(static_cast<const char*>(tile) + 2048 * j, kBoxBytes,
                   1024);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of ``d`` across an
// asynchronous product that is still in flight
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16) @ B (16 x 128), A and B in shared
// memory through descriptors; TA / TB: the operand is MN-major.  scale-d
// is 1: the accumulators are zeroed in registers, never by the product.
// Fragment of d: thread t of the warpgroup holds, for n8 block j,
// d[4j], d[4j+1] at row 16 (t / 32) + (t % 32) / 4, columns 8j + 2 (t %
// 4) and + 1, and d[4j+2], d[4j+3] eight rows below -- mma.sync's C
// fragment, warp by warp.
#define REPRO_WGMMA_64x128(TYPE)                                            \
  asm volatile(                                                             \
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " "      \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                            \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                            \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                            \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                            \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                           \
      "%64, %65, p, 1, 1, %67, %68;\n}\n"                                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB))

template <typename T, int TA, int TB>
__device__ __forceinline__ void mma_64x128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    REPRO_WGMMA_64x128("bf16");
  else
    REPRO_WGMMA_64x128("f16");
}
#undef REPRO_WGMMA_64x128

// Flash attention's products (flash_attention.cu's wgmma route).
// d (64 x 64, f32) += A (64 x 16) @ B (16 x 64), both in shared memory
// (the scores Q K^T, both K-major); fragment as above for n8 blocks 0-7.
#define REPRO_WGMMA_64x64(TYPE)                                             \
  asm volatile(                                                             \
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "       \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                           \
      "%32, %33, p, 1, 1, %35, %36;\n}\n"                                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31])                                            \
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB))

template <typename T, int TA, int TB>
__device__ __forceinline__ void mma_64x64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    REPRO_WGMMA_64x64("bf16");
  else
    REPRO_WGMMA_64x64("f16");
}
#undef REPRO_WGMMA_64x64

// d (64 x N, f32) += A (64 x 16) @ B (16 x N) with A in registers (the
// register form: p.V, p from the score registers) and B in shared memory
// (TB: MN-major).  A's fragment is mma.sync m16n8k16's, warp by warp:
// a[0] rows g, k 2q and 2q + 1; a[1] rows g + 8; a[2], a[3] the same at k
// + 8 (g = lane / 4, q = lane % 4, rows 16 (warp % 4) + ...).
#define REPRO_WGMMA_RS_64x64(TYPE)                                          \
  asm volatile(                                                             \
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "       \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                           \
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31])                                            \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),        \
        "n"(TB))

#define REPRO_WGMMA_RS_64x128(TYPE)                                         \
  asm volatile(                                                             \
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " "      \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                            \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                            \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                            \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                            \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                           \
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),        \
        "n"(TB))

// N = 64 or 128 columns of B from ``db``
template <typename T, int N, int TB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const unsigned (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 128, "");
  if constexpr (N == 64) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      REPRO_WGMMA_RS_64x64("bf16");
    else
      REPRO_WGMMA_RS_64x64("f16");
  } else {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      REPRO_WGMMA_RS_64x128("bf16");
    else
      REPRO_WGMMA_RS_64x128("f16");
  }
}
#undef REPRO_WGMMA_RS_64x64
#undef REPRO_WGMMA_RS_64x128

// -- the mainloop -----------------------------------------------------------
// C (batch, M, N) = A (batch, M, K) @ B (batch, K, N), each operand read
// by the TMA unit from a tensor map of its own layout (a K-major or an
// MN-major operand, see above), C f32 or in the operands' 16-bit type.
//
// The order is the port's 16-bit order, tc_gemm.cuh's: lane w's chain
// starts at +0 and applies the k16 steps of [256 s + 32 w, +32) for the
// stages s in order; the lanes' chains are added in lane order to a sum
// from +0; K under one stage adds only the first ceil(K / 32) lanes (the
// others would add +0 to a sum that is never -0).  Here the lanes go in
// pairs (2p, 2p + 1): a ring stage is k in [256 s + 64 p, +64), both
// lanes' k-tiles at stage s, so each consumer keeps ``acc0`` and
// ``acc1`` (the two lanes' chains, each in ascending k) and ``tot`` (the
// lanes' sum), and adds acc0 then acc1 to tot when the pair has walked
// every stage.  (One lane a stage -- 32-deep k-tiles, K-major operands
// in 64-byte rows under the 64-byte swizzle, one chain a consumer --
// measured slower on an H100.)  wgmma's k16 step rounds bit for bit as
// mma.sync's (kernels/wgmma_probe.py: 2^27 outputs of normal, spread,
// cancelling and subnormal inputs, every layout, bf16 and f16, on an
// H100), so this gives every bit that gemm_tc and bmm_seq_kernel give,
// at any M.  Zeros past K and past the matrix edges come from the TMA
// unit's out-of-bounds fill.
//
// The block (kWgThreads): warpgroup 0 is the producer -- one thread keeps
// TMA copies in flight into a ring of kStages stages, each with a "full"
// mbarrier (the copies' bytes) and an "empty" one (both consumers done)
// -- and warpgroups 1 and 2 are the consumers, rows [0, 64) and [64, 128)
// of the 128 x 128 tile, four m64n128k16 products a stage (two a lane),
// one stage's products in flight while the stage before it is released.
// Blocks are persistent: block i walks tiles i, i + grid, ... in row
// groups of kGroupM tile rows (the tiles in flight share A's rows and
// B's columns through L2), and the producer runs ahead into the next tile
// while the consumers store this one.  A consumer stages its 64 x 128
// outputs in shared memory under the 128-byte swizzle and one thread
// hands them to the TMA unit, which writes them while the consumer
// starts the next tile; where C's rows are not whole 16 bytes (an odd N
// of the batched kernel) the consumers store from registers instead.
constexpr int kWgThreads = 384;
constexpr int kBM = 128, kBN = 128;
constexpr int kStages = 5;
constexpr int kATile = kBM * kStageK * 2;         // 16 KB
constexpr int kBTile = kBN * kStageK * 2;         // 16 KB
constexpr int kStageBytes = kATile + kBTile;
constexpr int kGroupM = 8;
// a consumer's staged output: 64 rows of kBN f32 at most
constexpr int kEpiBytes = 64 * kBN * 4;
// the ring on 1024 bytes, the consumers' staged outputs, then the full
// and empty barriers (mirrored by kernels/ops.py:WG_SMEM)
constexpr int kSmem =
    1024 + kStages * kStageBytes + 2 * kEpiBytes + 2 * kStages * 8;
static_assert(kSmem <= kMaxDynamicSmem, "ring");
constexpr int kWgLanes = tc::kKS / kTileK;        // 8
// Rows above which a 16-bit product takes the mainloop (matmul.cu, and
// the products of norm_matmul.cu and swiglu.cu), where the TMA unit can
// read its operands (rows in whole 16-byte vectors); mirrored by
// kernels/ops.py:WG_MIN_ROWS.  The bits are the tensor-core tiles' either
// way, so the threshold is a matter of time alone: on an H100 at K 4096
// and N 4096, 6144 and 11008 the mainloop was the faster from 128 rows up
// (scripts/torch_bmm_bits.py --time), and from 97 rows it runs the one
// tile row of 128 that it runs at 128.
constexpr int kMinRows = 96;

// What an instantiation adds to the plain product (matmul's and the
// batched kernel's are Plain).
struct Plain {
  static constexpr bool kWaitA = false, kPairB = false;
};
// The programmatic dependent of the kernel before it on the stream, which
// writes A (norm_matmul's product on the normalised rows, swiglu's down
// product on h; launched by launch_pdl).  The producer thread copies B's
// boxes of the ring's first stages (the stages' expect_tx counting both
// operands), executes griddepcontrol.wait, and only then copies A.  No
// other thread reads what the primary wrote: the consumers read the ring.
struct WaitA {
  static constexpr bool kWaitA = true, kPairB = false;
};
// A paired B (swiglu's gate/up: an Opt with kPairB and a ``pair``): a
// stage's two MN-major B boxes come from two tensor maps at the same
// columns [n0, n0 + 64), so a 128-wide tile covers 64 columns of each;
// under the m64n128 fragment the thread that holds the first's column at
// n8 block j (j < 8) holds the second's at block j + 8, in the same row
// and place, and the epilogue writes Opt::pair<T>(first, second) rounded
// to T, 64 columns a consumer through one TMA box.  Such a kernel lets
// its programmatic dependent launch on entry
// (griddepcontrol.launch_dependents).

struct TileIndex {
  int b, m0, n0;
};

// tile ``t`` of the grid: batch-major, then row groups of kGroupM tile
// rows, the rows of a group fastest; tiles ``bn`` columns wide
__device__ __forceinline__ TileIndex tile_at(long long t, int tiles_m,
                                             int tiles_n, int bn = kBN) {
  const long long per = (long long)tiles_m * tiles_n;
  const int b = (int)(t / per);
  const int r = (int)(t % per);
  const int group = kGroupM * tiles_n;
  const int first = (r / group) * kGroupM;
  const int rows = min(tiles_m - first, kGroupM);
  const int in = r % group;
  return {b, (first + in % rows) * kBM, (in / rows) * bn};
}

__device__ __forceinline__ void zero(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
}

// A_MN: A is MN-major (read as (K, M)); B_K: B is K-major (read as (N, K));
// Opt: Plain, WaitA or a paired B (above).  b2map is read only where
// Opt::kPairB.
template <class Tag, typename T, bool A_MN, bool B_K, class Opt = Plain>
__global__ void __launch_bounds__(kWgThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap bmap,
                const __grid_constant__ CUtensorMap b2map,
                const __grid_constant__ CUtensorMap cmap,
                void* __restrict__ C, int batch, int M, int N, int K,
                int out_f32, int c_tma) {
  static_assert(!Opt::kPairB || (!A_MN && !B_K), "a paired B is MN-major");
  if constexpr (Opt::kPairB)
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // a paired tile covers kBoxMN columns of each of B's two maps
  constexpr int kTileN = Opt::kPairB ? kBoxMN : kBN;
  extern __shared__ __align__(1024) unsigned char raw[];
  unsigned char* ring =
      raw + ((1024u - (tc::smem_u32(raw) & 1023u)) & 1023u);
  unsigned char* epi = ring + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 2 * kEpiBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      tma::mbar_init(full + i, 1);
      tma::mbar_init(empty + i, 2);
    }
    tma::mbar_init_fence();
  }
  __syncthreads();
  const int tiles_m = (M + kBM - 1) / kBM;
  const int tiles_n = (N + kTileN - 1) / kTileN;
  const long long tiles = (long long)batch * tiles_m * tiles_n;
  const int nst = (K + tc::kKS - 1) / tc::kKS;
  const int live = K < tc::kKS ? (K + kTileK - 1) / kTileK : kWgLanes;
  const int pairs = (live + 1) / 2;
  if (threadIdx.x < 128) {   // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      // B's lines are the first L2 evicts, A's stay at the normal
      // priority: with both at the normal priority every shape measured
      // slower on an H100
      const uint64_t a_pol = tc::l2_policy_evict_normal();
      const uint64_t b_pol = tc::l2_policy_evict_first();
      auto load_a = [&](unsigned char* st, const TileIndex& ti, int k0,
                        uint64_t* bar) {
        if constexpr (A_MN) {
          tma::tma_box(st, &amap, ti.m0, k0, ti.b, bar, a_pol);
          tma::tma_box(st + kBoxBytes, &amap, ti.m0 + kBoxMN, k0, ti.b, bar,
                       a_pol);
        } else {
          tma::tma_box(st, &amap, k0, ti.m0, ti.b, bar, a_pol);
        }
      };
      auto load_b = [&](unsigned char* st, const TileIndex& ti, int k0,
                        uint64_t* bar) {
        unsigned char* bs = st + kATile;
        if constexpr (B_K) {
          tma::tma_box(bs, &bmap, k0, ti.n0, ti.b, bar, b_pol);
        } else if constexpr (Opt::kPairB) {
          tma::tma_box(bs, &bmap, ti.n0, k0, ti.b, bar, b_pol);
          tma::tma_box(bs + kBoxBytes, &b2map, ti.n0, k0, ti.b, bar, b_pol);
        } else {
          tma::tma_box(bs, &bmap, ti.n0, k0, ti.b, bar, b_pol);
          tma::tma_box(bs + kBoxBytes, &bmap, ti.n0 + kBoxMN, k0, ti.b, bar,
                       b_pol);
        }
      };
      // a dependent's first stages (the first tile's, at most the ring):
      // B's boxes, the wait, then their A
      int early = 0;
      if constexpr (Opt::kWaitA) {
        const TileIndex ti = tile_at(blockIdx.x, tiles_m, tiles_n, kTileN);
        if (blockIdx.x < tiles) early = min(kStages, pairs * nst);
        for (int i = 0; i < early; ++i) {
          const int k0 = (i % nst) * tc::kKS + (i / nst) * kStageK;
          tma::mbar_expect_tx(full + i, kStageBytes);
          load_b(ring + i * kStageBytes, ti, k0, full + i);
        }
        asm volatile("griddepcontrol.wait;\n" ::: "memory");
        for (int i = 0; i < early; ++i) {
          const int k0 = (i % nst) * tc::kKS + (i / nst) * kStageK;
          load_a(ring + i * kStageBytes, ti, k0, full + i);
        }
      }
      int slot = 0, walked = 0;
      unsigned phase = 0;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const TileIndex ti = tile_at(t, tiles_m, tiles_n, kTileN);
        for (int p = 0; p < pairs; ++p)
          for (int s = 0; s < nst; ++s) {
            const int k0 = s * tc::kKS + p * kStageK;
            if (walked < early) {   // copied above
              ++walked;
            } else {
              tma::mbar_wait(empty + slot, phase ^ 1u);
              unsigned char* st = ring + slot * kStageBytes;
              uint64_t* bar = full + slot;
              tma::mbar_expect_tx(bar, kStageBytes);
              load_a(st, ti, k0, bar);
              load_b(st, ti, k0, bar);
            }
            if (++slot == kStages) {
              slot = 0;
              phase ^= 1u;
            }
          }
      }
    }
  } else {   // the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = threadIdx.x / 128 - 1;   // rows [64 c, 64 c + 64)
    const bool lead = (threadIdx.x & 127) == 0;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    int slot = 0;
    unsigned phase = 0;
    float acc0[64], acc1[64], tot[64];
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TileIndex ti = tile_at(t, tiles_m, tiles_n, kTileN);
      zero(tot);
      for (int p = 0; p < pairs; ++p) {
        zero(acc0);
        zero(acc1);
        int prev = -1;
        for (int s = 0; s < nst; ++s) {
          tma::mbar_wait(full + slot, phase);
          const unsigned char* st = ring + slot * kStageBytes;
          const unsigned char* as = st + c * kBoxBytes;   // 64 rows in
          const unsigned char* bs = st + kATile;
          fence_regs(acc0);
          fence_regs(acc1);
          fence();
#pragma unroll
          for (int j = 0; j < 2; ++j)   // lane 2p: k16 steps 0, 1
            mma_64x128<T, A_MN ? 1 : 0, B_K ? 0 : 1>(
                acc0, A_MN ? desc_mn(as, j) : desc_k(as, j),
                B_K ? desc_k(bs, j) : desc_mn(bs, j));
#pragma unroll
          for (int j = 2; j < 4; ++j)   // lane 2p + 1: k16 steps 2, 3
            mma_64x128<T, A_MN ? 1 : 0, B_K ? 0 : 1>(
                acc1, A_MN ? desc_mn(as, j) : desc_k(as, j),
                B_K ? desc_k(bs, j) : desc_mn(bs, j));
          commit();
          fence_regs(acc0);
          fence_regs(acc1);
          wait<1>();   // the stage before this one is read: release it
          if (lead && prev >= 0) tma::mbar_arrive(empty + prev);
          prev = slot;
          if (++slot == kStages) {
            slot = 0;
            phase ^= 1u;
          }
        }
        wait<0>();
        fence_regs(acc0);
        fence_regs(acc1);
        if (lead) tma::mbar_arrive(empty + prev);
        // lane order; a lane past K (2p + 1 == live) adds nothing
#pragma unroll
        for (int i = 0; i < 64; ++i) tot[i] += acc0[i];
        if (2 * p + 1 < live) {
#pragma unroll
          for (int i = 0; i < 64; ++i) tot[i] += acc1[i];
        }
      }
      // the epilogue: rows r and r + 8, columns q and q + 1 of each n8
      // block of this consumer's 64 rows
      const int r = 16 * warp + (lane >> 2), q = 2 * (lane & 3);
      if (c_tma) {
        // boxes of 128 bytes of a row: 64 16-bit outputs, or 32 f32
        const int per = out_f32 ? 32 : 64;
        unsigned char* my = epi + c * kEpiBytes;
        if (lead) tma::bulk_wait_read();   // the last tile's boxes are out
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
        if constexpr (Opt::kPairB) {
          // column n of the first map at block j, of the second at j + 8
#pragma unroll
          for (int j = 0; j < kBoxMN / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int rr = r + 8 * h, n = 8 * j + q;
              const int i = 4 * j + 2 * h, i2 = 4 * (j + kBoxMN / 8) + 2 * h;
              *reinterpret_cast<unsigned*>(my + swz128(rr * 128 + n * 2)) =
                  pack2<T>(Opt::template pair<T>(tot[i], tot[i2]),
                           Opt::template pair<T>(tot[i + 1], tot[i2 + 1]));
            }
        } else {
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int rr = r + 8 * h, n = 8 * j + q;
              const float v0 = tot[4 * j + 2 * h],
                          v1 = tot[4 * j + 2 * h + 1];
              unsigned char* d = my + (n / per) * kBoxBytes;
              if (out_f32)
                *reinterpret_cast<float2*>(
                    d + swz128(rr * 128 + (n % 32) * 4)) =
                    make_float2(v0, v1);
              else
                *reinterpret_cast<unsigned*>(
                    d + swz128(rr * 128 + (n % 64) * 2)) = pack2<T>(v0, v1);
            }
        }
        tma::fence_async_shared();
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
        if (lead) {
          for (int bx = 0; bx < kTileN / per; ++bx)
            tma::tma_store_box(&cmap, my + bx * kBoxBytes,
                               ti.n0 + bx * per, ti.m0 + 64 * c, ti.b);
          tma::bulk_commit();
        }
        continue;
      }
      if constexpr (!Opt::kPairB) {
        // C's rows not in whole 16 bytes: from registers, two values a
        // store where N is even
        const bool two = (N & 1) == 0;
        const size_t row0 = (size_t)ti.b * M;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = ti.m0 + 64 * c + r + 8 * h, n = ti.n0 + q + 8 * j;
            if (m >= M || n >= N) continue;
            const float v0 = tot[4 * j + 2 * h], v1 = tot[4 * j + 2 * h + 1];
            const size_t o = (row0 + m) * N + n;
            if (out_f32) {
              float* d = static_cast<float*>(C) + o;
              if (two) {
                *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
              } else {
                d[0] = v0;
                if (n + 1 < N) d[1] = v1;
              }
            } else {
              T* d = static_cast<T*>(C) + o;
              if (two) {
                *reinterpret_cast<unsigned*>(d) = pack2<T>(v0, v1);
              } else {
                d[0] = from_f32<T>(v0);
                if (n + 1 < N) d[1] = from_f32<T>(v1);
              }
            }
          }
      }
    }
    if (lead) tma::bulk_wait();   // every box is written
  }
}

// -- host side ---------------------------------------------------------------
// An operand as the TMA unit reads it: ``k_major`` where k is its
// contiguous index (matmul's A, a (N, K) B), else its M or N is; the
// stride (elements) of its other index, and between batches.
struct Operand {
  const void* p;
  bool k_major;
  long long s_cross, s_batch;
};

// The 3-D tensor map of an operand ``x`` rows or columns wide (M or N),
// under the 128-byte swizzle: K-major, (k, x, batch) in boxes of 64 k x
// 128; MN-major, (x, k, batch) in boxes of 64 x 64 k.  Outside the
// operand the boxes land as zeros.  A host-side encoding: a CUDA-graph
// capture may run it.
template <typename T>
cudaError_t operand_map(CUtensorMap* map, const Operand& op, int x, int K,
                        int batch) {
  const tma::EncodeTiled encode = tma::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t inner = op.k_major ? K : x, outer = op.k_major ? x : K;
  // one batch: any stride past the operand will do
  const long long sb = batch > 1 ? op.s_batch : op.s_cross * (long long)outer;
  const cuuint64_t dims[3] = {inner, outer, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)op.s_cross * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[3] = {op.k_major ? (cuuint32_t)kStageK
                                        : (cuuint32_t)kBoxMN,
                             op.k_major ? (cuuint32_t)kBM
                                        : (cuuint32_t)kStageK,
                             1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      3, const_cast<void*>(op.p), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The 3-D map (n, m, batch) of C (batch, M, N), f32 or T, in boxes of
// 128 bytes of a row x 64 rows under the 128-byte swizzle, where its rows
// are whole 16 bytes (``*ok``); else no map is needed.
template <typename T>
cudaError_t output_map(CUtensorMap* map, void* C, bool out_f32, int M,
                       int N, int batch, bool* ok) {
  const int osz = out_f32 ? 4 : 2;
  *ok = ((size_t)N * osz) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(C) % 16 == 0;
  if (!*ok) return cudaSuccess;
  const tma::EncodeTiled encode = tma::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)M,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)N * osz,
                                 (cuuint64_t)N * M * osz};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / osz), 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      out_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : std::is_same<T, __nv_bfloat16>::value
          ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
          : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      3, C, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <class Tag, typename T, bool A_MN, bool B_K, class Opt>
cudaError_t launch_gemm(const CUtensorMap& am, const CUtensorMap& bm,
                        const CUtensorMap& b2m, const CUtensorMap& cm,
                        bool c_tma, void* C, int batch, int M, int N, int K,
                        bool out_f32, cudaStream_t s) {
  static PerDevice limit_set;
  static int sms[kMaxDevices];
  int dev = 0;
  const auto kern = gemm_kernel<Tag, T, A_MN, B_K, Opt>;
  const cudaError_t limit = once_per_device(limit_set, [&] {
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  });
  if (limit != cudaSuccess) return limit;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int tn = Opt::kPairB ? kBoxMN : kBN;
  const long long tiles = (long long)batch * ((M + kBM - 1) / kBM) *
                          ((N + tn - 1) / tn);
  const unsigned grid = (unsigned)(tiles < sms[dev] ? tiles : sms[dev]);
  if constexpr (Opt::kWaitA)
    return launch_pdl(kern, dim3(grid), dim3(kWgThreads), kSmem, s, am, bm,
                      b2m, cm, C, batch, M, N, K, out_f32 ? 1 : 0,
                      c_tma ? 1 : 0);
  kern<<<grid, kWgThreads, kSmem, s>>>(am, bm, b2m, cm, C, batch, M, N, K,
                                       out_f32 ? 1 : 0, c_tma ? 1 : 0);
  return cudaSuccess;
}

// C (batch, M, N) = A @ B by the mainloop, A MN-major where A_MN and B
// K-major where B_K (the operands' own flags must agree).  Tag names the
// instantiation in a profile; Opt (above) may make it a programmatic
// dependent (WaitA) or pair B with ``b2`` (C then holds N columns, each
// the pair of B's and b2's, in the operands' type through the TMA unit).
template <class Tag, typename T, bool A_MN, bool B_K, class Opt = Plain>
cudaError_t gemm_as(const Operand& a, const Operand& b, void* C, int batch,
                    int M, int N, int K, bool out_f32, cudaStream_t s,
                    const Operand* b2 = nullptr) {
  if (a.k_major == A_MN || b.k_major != B_K) return cudaErrorInvalidValue;
  if (Opt::kPairB && (b2 == nullptr || b2->k_major || out_f32))
    return cudaErrorInvalidValue;
  CUtensorMap am, bm, b2m, cm = {};
  bool c_tma = false;
  cudaError_t e = operand_map<T>(&am, a, M, K, batch);
  if (e == cudaSuccess) e = operand_map<T>(&bm, b, N, K, batch);
  b2m = bm;   // read only where paired
  if (e == cudaSuccess && Opt::kPairB)
    e = operand_map<T>(&b2m, *b2, N, K, batch);
  if (e == cudaSuccess)
    e = output_map<T>(&cm, C, out_f32, M, N, batch, &c_tma);
  if (e != cudaSuccess) return e;
  if (Opt::kPairB && !c_tma) return cudaErrorInvalidValue;
  return launch_gemm<Tag, T, A_MN, B_K, Opt>(am, bm, b2m, cm, c_tma, C, batch,
                                             M, N, K, out_f32, s);
}

// the same, in the layouts the operands name
template <class Tag, typename T>
cudaError_t gemm(const Operand& a, const Operand& b, void* C, int batch,
                 int M, int N, int K, bool out_f32, cudaStream_t s) {
  if (a.k_major)
    return b.k_major ? gemm_as<Tag, T, false, true>(a, b, C, batch, M, N, K,
                                                    out_f32, s)
                     : gemm_as<Tag, T, false, false>(a, b, C, batch, M, N,
                                                     K, out_f32, s);
  return b.k_major ? gemm_as<Tag, T, true, true>(a, b, C, batch, M, N, K,
                                                 out_f32, s)
                   : gemm_as<Tag, T, true, false>(a, b, C, batch, M, N, K,
                                                  out_f32, s);
}

}  // namespace wg
}  // namespace repro
