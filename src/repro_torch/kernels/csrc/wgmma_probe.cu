// A probe of the tensor cores' arithmetic: is wgmma's k16 step bitwise
// mma.sync's?  The port's 16-bit K order (tc_gemm.cuh) names chains of
// mma.sync m16n8k16 steps; a wgmma route keeps that order's bits only if
// one k16 step of wgmma.mma_async m64nNk16 rounds exactly as one of
// mma.sync, from the same accumulator.
//
// Replaces: no TPU kernel; run by chip_smoke.py's phase 3 and by
// ``python -m repro_torch.kernels.wgmma_probe``.  Problem p is A_p (64,
// K) @ B_p (K, 128), both row-major, into C_p (64, 128) f32.  Mode -1
// runs it as mma.sync chains: warp w owns rows [16w, 16w + 16), its 16
// n8 accumulators start at +0, and each k16 step in ascending k applies
// m16n8k16 with fragments read straight from global memory; mode -2 is
// the same from accumulators loaded from C_p.  Modes 0-3 run it as one
// wgmma m64n128k16 chain a warpgroup, accumulators zeroed in registers
// and scale-d 1, over tiles of 64 k that the threads write into shared
// memory in the mainloop's layouts (wg_gemm.cuh, 128-byte swizzle): bit
// 0 puts A MN-major ([k][m], as dW's (K, M) A arrives), else K-major
// ([m][k]); bit 1 puts B K-major ([n][k], as dX's (N, K) B), else
// MN-major ([k][n]).  Modes 4-6 are flash attention's products
// (flash_attention.cu's wgmma route): 4 and 5 take A from registers in
// mma.sync's A fragment (p.V, p from the score registers) and B MN-major
// (V's tiles), from accumulators loaded from C_p (acc * alpha), as one
// m64n128k16 chain (4) or two m64n64k16 chains over the column halves
// (5); 6 is the scores' m64n64k16 over the column halves with both
// operands K-major (Q and K's tiles), from zeroed accumulators.
#include "wg_gemm.cuh"

namespace {

using namespace repro;

constexpr int kPM = 64, kPN = 128;
constexpr int kKT = wg::kStageK;   // k a tile, as a ring stage holds

template <typename T>
__device__ __forceinline__ unsigned pack(T lo, T hi) {
  __align__(4) T v[2] = {lo, hi};
  return *reinterpret_cast<const unsigned*>(v);
}

template <typename T>
__global__ void __launch_bounds__(128)
    probe_mma_kernel(const T* __restrict__ A, const T* __restrict__ B,
                     float* __restrict__ C, int K, int from_c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const T* Ap = A + (size_t)blockIdx.x * kPM * K + (size_t)(16 * warp) * K;
  const T* Bp = B + (size_t)blockIdx.x * K * kPN;
  float* Cp = C + (size_t)blockIdx.x * kPM * kPN;
  float c[kPN / 8][4];
#pragma unroll
  for (int j = 0; j < kPN / 8; ++j) {
    const int r = 16 * warp + g, col = 8 * j + 2 * q;
    c[j][0] = from_c ? Cp[r * kPN + col] : 0.f;
    c[j][1] = from_c ? Cp[r * kPN + col + 1] : 0.f;
    c[j][2] = from_c ? Cp[(r + 8) * kPN + col] : 0.f;
    c[j][3] = from_c ? Cp[(r + 8) * kPN + col + 1] : 0.f;
  }
  for (int k = 0; k < K; k += 16) {
    unsigned a[4];
    a[0] = pack(Ap[(size_t)g * K + k + 2 * q],
                Ap[(size_t)g * K + k + 2 * q + 1]);
    a[1] = pack(Ap[(size_t)(g + 8) * K + k + 2 * q],
                Ap[(size_t)(g + 8) * K + k + 2 * q + 1]);
    a[2] = pack(Ap[(size_t)g * K + k + 2 * q + 8],
                Ap[(size_t)g * K + k + 2 * q + 9]);
    a[3] = pack(Ap[(size_t)(g + 8) * K + k + 2 * q + 8],
                Ap[(size_t)(g + 8) * K + k + 2 * q + 9]);
#pragma unroll
    for (int j = 0; j < kPN / 8; ++j) {
      const int n = 8 * j + g;
      const unsigned b0 = pack(Bp[(size_t)(k + 2 * q) * kPN + n],
                               Bp[(size_t)(k + 2 * q + 1) * kPN + n]);
      const unsigned b1 = pack(Bp[(size_t)(k + 2 * q + 8) * kPN + n],
                               Bp[(size_t)(k + 2 * q + 9) * kPN + n]);
      tc::mma16816<T>(c[j], a, b0, b1);
    }
  }
#pragma unroll
  for (int j = 0; j < kPN / 8; ++j) {
    const int r = 16 * warp + g, col = 8 * j + 2 * q;
    Cp[r * kPN + col] = c[j][0];
    Cp[r * kPN + col + 1] = c[j][1];
    Cp[(r + 8) * kPN + col] = c[j][2];
    Cp[(r + 8) * kPN + col + 1] = c[j][3];
  }
}

template <typename T, bool A_MN, bool B_K>
__global__ void __launch_bounds__(128)
    probe_wgmma_kernel(const T* __restrict__ A, const T* __restrict__ B,
                       float* __restrict__ C, int K) {
  extern __shared__ __align__(1024) unsigned char raw[];
  // the swizzle is a function of the address: tiles on 1024 bytes
  const unsigned pad = (1024u - (tc::smem_u32(raw) & 1023u)) & 1023u;
  unsigned char* as = raw + pad;
  unsigned char* bs = as + kPM * kKT * 2;
  const T* Ap = A + (size_t)blockIdx.x * kPM * K;
  const T* Bp = B + (size_t)blockIdx.x * K * kPN;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kKT) {
    for (int e = threadIdx.x; e < kPM * kKT; e += 128) {
      const int m = e / kKT, kk = e % kKT;
      const int o = A_MN ? kk * 128 + m * 2 : m * 128 + kk * 2;
      *reinterpret_cast<T*>(as + wg::swz128(o)) =
          Ap[(size_t)m * K + k0 + kk];
    }
    for (int e = threadIdx.x; e < kKT * kPN; e += 128) {
      const int kk = e / kPN, n = e % kPN;
      const int o = B_K ? n * 128 + kk * 2
                        : (n / wg::kBoxMN) * wg::kBoxBytes + kk * 128 +
                              (n % wg::kBoxMN) * 2;
      *reinterpret_cast<T*>(bs + wg::swz128(o)) =
          Bp[(size_t)(k0 + kk) * kPN + n];
    }
    // the threads' writes, then the async proxy's reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    wg::fence_regs(d);
    wg::fence();
#pragma unroll
    for (int j = 0; j < kKT / 16; ++j)
      wg::mma_64x128<T, A_MN ? 1 : 0, B_K ? 0 : 1>(
          d, A_MN ? wg::desc_mn(as, j) : wg::desc_k(as, j),
          B_K ? wg::desc_k(bs, j) : wg::desc_mn(bs, j));
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(d);
    __syncthreads();   // every product has read the tile
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = 16 * warp + (lane >> 2), q = (lane & 3) * 2;
  float* Cp = C + (size_t)blockIdx.x * kPM * kPN;
#pragma unroll
  for (int j = 0; j < kPN / 8; ++j) {
    Cp[r * kPN + 8 * j + q] = d[4 * j];
    Cp[r * kPN + 8 * j + q + 1] = d[4 * j + 1];
    Cp[(r + 8) * kPN + 8 * j + q] = d[4 * j + 2];
    Cp[(r + 8) * kPN + 8 * j + q + 1] = d[4 * j + 3];
  }
}

// mode 4 (N 128: one chain) and 5 (N 64: two, over the column halves):
// A from registers, B MN-major, from accumulators loaded from C; mode 6
// (RS false): A and B K-major in shared memory, two N 64 chains from
// zeroed accumulators
template <typename T, int N, bool RS>
__global__ void __launch_bounds__(128)
    probe_flash_kernel(const T* __restrict__ A, const T* __restrict__ B,
                       float* __restrict__ C, int K) {
  extern __shared__ __align__(1024) unsigned char raw[];
  const unsigned pad = (1024u - (tc::smem_u32(raw) & 1023u)) & 1023u;
  unsigned char* as = raw + pad;
  unsigned char* bs = as + kPM * kKT * 2;
  const T* Ap = A + (size_t)blockIdx.x * kPM * K;
  const T* Bp = B + (size_t)blockIdx.x * K * kPN;
  float* Cp = C + (size_t)blockIdx.x * kPM * kPN;
  constexpr int H = kPN / N;   // chains over the column halves
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int r = 16 * warp + g;
  float d[H][N / 2];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = h * N + 8 * j + 2 * q;
      d[h][4 * j] = RS ? Cp[r * kPN + col] : 0.f;
      d[h][4 * j + 1] = RS ? Cp[r * kPN + col + 1] : 0.f;
      d[h][4 * j + 2] = RS ? Cp[(r + 8) * kPN + col] : 0.f;
      d[h][4 * j + 3] = RS ? Cp[(r + 8) * kPN + col + 1] : 0.f;
    }
  for (int k0 = 0; k0 < K; k0 += kKT) {
    if (!RS) {   // A K-major
      for (int e = threadIdx.x; e < kPM * kKT; e += 128) {
        const int m = e / kKT, kk = e % kKT;
        *reinterpret_cast<T*>(as + wg::swz128(m * 128 + kk * 2)) =
            Ap[(size_t)m * K + k0 + kk];
      }
    }
    for (int e = threadIdx.x; e < kKT * kPN; e += 128) {
      const int kk = e / kPN, n = e % kPN;
      const int o = RS ? (n / wg::kBoxMN) * wg::kBoxBytes + kk * 128 +
                             (n % wg::kBoxMN) * 2
                       : n * 128 + kk * 2;
      *reinterpret_cast<T*>(bs + wg::swz128(o)) =
          Bp[(size_t)(k0 + kk) * kPN + n];
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int h = 0; h < H; ++h) wg::fence_regs(d[h]);
    wg::fence();
#pragma unroll
    for (int j = 0; j < kKT / 16; ++j) {
      if constexpr (RS) {
        const int k = k0 + 16 * j;
        unsigned a[4];
        a[0] = pack(Ap[(size_t)r * K + k + 2 * q],
                    Ap[(size_t)r * K + k + 2 * q + 1]);
        a[1] = pack(Ap[(size_t)(r + 8) * K + k + 2 * q],
                    Ap[(size_t)(r + 8) * K + k + 2 * q + 1]);
        a[2] = pack(Ap[(size_t)r * K + k + 2 * q + 8],
                    Ap[(size_t)r * K + k + 2 * q + 9]);
        a[3] = pack(Ap[(size_t)(r + 8) * K + k + 2 * q + 8],
                    Ap[(size_t)(r + 8) * K + k + 2 * q + 9]);
#pragma unroll
        for (int h = 0; h < H; ++h)
          wg::mma_rs<T, N, 1>(d[h], a,
                              wg::desc_mn(bs + h * wg::kBoxBytes, j));
      } else {
#pragma unroll
        for (int h = 0; h < H; ++h)
          wg::mma_64x64<T, 0, 0>(d[h], wg::desc_k(as, j),
                                 wg::desc_k(bs + h * 64 * 128, j));
      }
    }
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int h = 0; h < H; ++h) wg::fence_regs(d[h]);
    __syncthreads();   // every product has read the tile
  }
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = h * N + 8 * j + 2 * q;
      Cp[r * kPN + col] = d[h][4 * j];
      Cp[r * kPN + col + 1] = d[h][4 * j + 1];
      Cp[(r + 8) * kPN + col] = d[h][4 * j + 2];
      Cp[(r + 8) * kPN + col + 1] = d[h][4 * j + 3];
    }
}

constexpr int kProbeSmem = 1024 + (kPM + kPN) * kKT * 2;

template <typename T, bool A_MN, bool B_K>
cudaError_t launch_wg(const void* a, const void* b, float* c, int P, int K,
                      cudaStream_t s) {
  probe_wgmma_kernel<T, A_MN, B_K><<<P, 128, kProbeSmem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), c, K);
  return cudaSuccess;
}

template <typename T, int N, bool RS>
cudaError_t launch_fl(const void* a, const void* b, float* c, int P, int K,
                      cudaStream_t s) {
  probe_flash_kernel<T, N, RS><<<P, 128, kProbeSmem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), c, K);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, float* c, int P, int K,
                   int mode, cudaStream_t s) {
  switch (mode) {
    case -1:
    case -2:
      probe_mma_kernel<T><<<P, 128, 0, s>>>(static_cast<const T*>(a),
                                            static_cast<const T*>(b), c, K,
                                            mode == -2);
      return cudaSuccess;
    case 0: return launch_wg<T, false, false>(a, b, c, P, K, s);
    case 1: return launch_wg<T, true, false>(a, b, c, P, K, s);
    case 2: return launch_wg<T, false, true>(a, b, c, P, K, s);
    case 3: return launch_wg<T, true, true>(a, b, c, P, K, s);
    case 4: return launch_fl<T, 128, true>(a, b, c, P, K, s);
    case 5: return launch_fl<T, 64, true>(a, b, c, P, K, s);
    case 6: return launch_fl<T, 64, false>(a, b, c, P, K, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// P problems of (64, K) @ (K, 128), K a multiple of 64; mode -1:
// mma.sync chains, 0-3: wgmma (bit 0: A MN-major, bit 1: B K-major);
// -2, 4 and 5 start from C's contents (mma.sync; wgmma with A from
// registers, N 128 and 64), 6 is wgmma N 64 with both operands K-major.
extern "C" int repro_wgmma_probe(const void* a, const void* b, void* c,
                                 int P, int K, int dtype, int mode,
                                 void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (P < 1 || K < kKT || K % kKT) return (int)cudaErrorInvalidValue;
  float* C = static_cast<float*>(c);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kBF16) err = launch<__nv_bfloat16>(a, b, C, P, K, mode, s);
  if (dtype == kF16) err = launch<__half>(a, b, C, P, K, mode, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
