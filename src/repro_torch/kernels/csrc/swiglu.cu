// Fused SwiGLU MLP for Hopper:
//   out (M, Do) = (silu(x @ wg) * (x @ wu)) @ wd
// with the reference's roundings: each of x@wg and x@wu accumulated in
// f32 and rounded to x.dtype; silu as jax.nn.silu computes it under
// XLA, g * (1 / (1 + exp(-g))) with each op rounded to x.dtype; the product
// with u rounded; and the down projection accumulated in f32; out in
// x's dtype.
//
// Replaces: src/repro/kernels/swiglu.py:_swiglu_kernel.
//
// Bound on the H100: the three weights (3 * 4096 * 11008 bf16 = 270 MB
// per layer at deepseek-7b's width) are read once per call and M is 4
// (decode) or 64 (prefill): device-memory bandwidth.
//
// Design: the TPU kernel keeps a (bm, D) row tile resident and, for each
// Do tile, sweeps F sequentially in one core, re-reading wg and wu for
// every Do tile.  On the H100 that re-read (once per Do tile, 64x at
// Do=4096) would dominate, and one block per Do tile gives too few
// blocks at decode shapes.  So the F axis is split instead: block f
// owns an F slice of 64 (bf16) columns, computes the slice's gate and up
// products for its rows, forms the hidden slice h in shared memory --
// the (M, F) hidden activation never reaches device memory, as in the
// TPU kernel -- and multiplies it by its 64 rows of wd into an f32
// partial (M, Do) tile.  A second kernel sums the partials over the
// slices in slice order.  Every weight byte is read once, F=11008 gives
// 172 blocks, and each output is reduced in one fixed order (no
// atomics): deterministic and independent of M.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int CG = 8;   // gate/up column groups: BF = 8 * 16/sizeof(T)

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
    swiglu_partial_kernel(const T* __restrict__ X, const T* __restrict__ WG,
                          const T* __restrict__ WU, const T* __restrict__ WD,
                          float* __restrict__ P, int M, int D, int F,
                          int Do) {
  constexpr int V = kVec<T>;
  constexpr int BF = CG * V;
  __shared__ float red[kWarps * BM * BF];
  __shared__ float gs[BM * BF];   // gate, then the hidden slice h
  const int slice = blockIdx.x;
  const int f0 = slice * BF;
  const int f_valid = min(BF, F - f0);
  const int m0 = blockIdx.y * BM;
  const int m_valid = min(BM, M - m0);
  const T* Xt = X + (size_t)m0 * D;
  float acc[BM][V];

  // gate slice: round(x @ wg[:, f0:f0+BF]) to x.dtype
  gemm_partial<T, BM, CG>(Xt, D, m_valid, WG, F, D, f0, F, acc);
  reduce_k_lanes<T, BM, CG>(acc, red);
  for (int i = threadIdx.x; i < BM * BF; i += kThreads)
    gs[i] = round_to<T>(red[i]);
  __syncthreads();

  // up slice, then h = round(silu(g) * round(u)) with silu rounded op
  // by op as above
  gemm_partial<T, BM, CG>(Xt, D, m_valid, WU, F, D, f0, F, acc);
  reduce_k_lanes<T, BM, CG>(acc, red);
  for (int i = threadIdx.x; i < BM * BF; i += kThreads) {
    const float g = gs[i];
    const float u = round_to<T>(red[i]);
    const float e = round_to<T>(expf(-g));
    const float sig = round_to<T>(1.f / round_to<T>(1.f + e));
    const float sg = round_to<T>(g * sig);
    gs[i] = round_to<T>(sg * u);
  }
  __syncthreads();

  // partial down projection of this slice: P[slice, m, :] =
  // sum over the slice's f, in ascending order, of h[m, f] * wd[f, :]
  for (int c0 = threadIdx.x * V; c0 < Do; c0 += kThreads * V) {
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[m][v] = 0.f;
    for (int f = 0; f < f_valid; ++f) {
      float w[V];
      load_vec(WD + (size_t)(f0 + f) * Do + c0, w);
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        if (m < m_valid) {
          const float h = gs[m * BF + f];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[m][v] = fmaf(h, w[v], acc[m][v]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      if (m < m_valid) {
        float* dst = P + ((size_t)slice * M + m0 + m) * Do + c0;
#pragma unroll
        for (int v = 0; v < V; ++v) dst[v] = acc[m][v];
      }
    }
  }
}

// out[i] = sum over slices s = 0, 1, ... of P[s, i], rounded to x.dtype
template <typename T>
__global__ void __launch_bounds__(kThreads)
    swiglu_reduce_kernel(const float* __restrict__ P, T* __restrict__ out,
                         int slices, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < slices; ++k) s += P[(size_t)k * n + i];
  out[i] = from_f32<T>(s);
}

template <typename T, int BM>
void launch_partial(const T* X, const T* WG, const T* WU, const T* WD,
                    float* P, int M, int D, int F, int Do, cudaStream_t s) {
  constexpr int BF = CG * kVec<T>;
  dim3 grid((F + BF - 1) / BF, (M + BM - 1) / BM);
  swiglu_partial_kernel<T, BM><<<grid, kThreads, 0, s>>>(X, WG, WU, WD, P, M,
                                                          D, F, Do);
}

}  // namespace

// ``partial`` is f32 scratch of slices(F) * M * Do elements, where
// slices(F) = ceil(F / (8 * 16 / sizeof(x))) -- see swiglu.py.
extern "C" int repro_swiglu(const void* x, const void* wg, const void* wu,
                            const void* wd, void* partial, void* out, int M,
                            int D, int F, int Do, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_DTYPE(dtype, T, {
    const T* X = static_cast<const T*>(x);
    const T* WG = static_cast<const T*>(wg);
    const T* WU = static_cast<const T*>(wu);
    const T* WD = static_cast<const T*>(wd);
    float* P = static_cast<float*>(partial);
    switch (pick_bm(M)) {
      case 1: launch_partial<T, 1>(X, WG, WU, WD, P, M, D, F, Do, s); break;
      case 4: launch_partial<T, 4>(X, WG, WU, WD, P, M, D, F, Do, s); break;
      default: launch_partial<T, 16>(X, WG, WU, WD, P, M, D, F, Do, s); break;
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    constexpr int BF = CG * kVec<T>;
    const int slices = (F + BF - 1) / BF;
    const long long n = (long long)M * Do;
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    swiglu_reduce_kernel<T><<<blocks, kThreads, 0, s>>>(
        P, static_cast<T*>(out), slices, n);
  });
  return (int)cudaGetLastError();
}
