// RMSNorm for Hopper: y = x * (1 / sqrt(mean(x^2) + eps)) * w, the mean
// of squares in f32, y in x's dtype.  w may be f32 while x is bf16 (the
// final norm before the unembed).
//
// Replaces: src/repro/kernels/rmsnorm.py:_rmsnorm_kernel.
//
// Bound on the H100: x is read once and y written once, a few flops per
// byte -- device-memory bandwidth.  At the serving shapes (4, 64 or 512
// rows of 4096) the tensors are 32 KB-4 MB, so a launch is bound by its
// latency: the launch itself and the DRAM round trips on its critical
// path, rather than by either rate.
//
// Design: one block per row, so the rows spread over the SMs.  A thread
// holds 64 bytes of the row per round: four 16-byte vectors of x when d
// is a whole number of vectors, else (rows then do not start on 16-byte
// boundaries) the masked scalar path, 32 or 16 single elements.  The
// thread count is a function of d alone: enough for one round, in whole
// warps, at most 512.  Every load of the row, x and w, is issued before
// the first is consumed and the row stays in registers, so the kernel
// reads x once in one DRAM round trip and writes y with 16-byte stores.
// Rows wider than one round (d > 16384 in bf16) take several rounds and
// read x again to write y.  The sum of squares has one fixed order that
// depends on d only: each thread's elements in ascending order, a
// butterfly over the warp, then the warps in order through shared memory
// -- deterministic, independent of the row count.  Any row count and any
// d are taken.
#include <type_traits>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kVecUnits = 4;       // 16-byte units a thread holds per round
constexpr int kMaxThreads = 512;

// ``n`` elements of a TW row at element ``i`` (16-byte aligned when
// VEC), as floats
template <typename TW, int N, bool VEC>
__device__ __forceinline__ void load_w(const TW* w, int i, float* out) {
  if constexpr (VEC && N * sizeof(TW) >= 16) {
#pragma unroll
    for (int c = 0; c < N * (int)sizeof(TW) / 16; ++c) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(w + i) + c);
      const TW* e = reinterpret_cast<const TW*>(&raw);
#pragma unroll
      for (int j = 0; j < 16 / (int)sizeof(TW); ++j)
        out[c * (16 / sizeof(TW)) + j] = to_f32(e[j]);
    }
  } else if constexpr (VEC && N * sizeof(TW) == 8) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(w + i));
    const TW* e = reinterpret_cast<const TW*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f32(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f32(__ldg(w + i + j));
  }
}

// VEC: a unit is a 16-byte vector of x, else one element
template <typename T, typename TW, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const T* __restrict__ X, const TW* __restrict__ W,
                   T* __restrict__ Y, int d, float eps) {
  constexpr int V = VEC ? kVec<T> : 1;   // elements per unit
  // units a thread holds per round: the same bytes on both paths
  constexpr int kUnits = VEC ? kVecUnits : kVecUnits * kVec<T>;
  using Raw = typename std::conditional<VEC, uint4, T>::type;
  __shared__ float warp_ss[kMaxThreads / 32];
  const int nthreads = blockDim.x;
  const int units = d / V;
  const int per_round = nthreads * kUnits;
  const int rounds = (units + per_round - 1) / per_round;
  const T* x = X + (size_t)blockIdx.x * d;
  T* y = Y + (size_t)blockIdx.x * d;

  // thread t holds units r * per_round + j * nthreads + t, j < kUnits
  Raw xr[kUnits];
  float wv[kUnits][V];
  auto load_round = [&](int r) {   // every load of the round is issued ...
    const int u0 = r * per_round + threadIdx.x;
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      const int u = u0 + j * nthreads;
      if (u < units) xr[j] = reinterpret_cast<const Raw*>(x)[u];
    }
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      const int u = u0 + j * nthreads;
      if (u < units) load_w<TW, V, VEC>(W, u * V, wv[j]);
    }
  };
  float ss = 0.f;
  for (int r = 0; r < rounds; ++r) {
    load_round(r);
    const int u0 = r * per_round + threadIdx.x;
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {   // ... before any is consumed
      if (u0 + j * nthreads < units) {
        const T* e = reinterpret_cast<const T*>(&xr[j]);
#pragma unroll
        for (int i = 0; i < V; ++i) {    // ascending elements
          const float v = to_f32(e[i]);
          ss = fmaf(v, v, ss);
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);   // equal on every lane
  if ((threadIdx.x & 31) == 0) warp_ss[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < nthreads / 32; ++w) total += warp_ss[w];
  const float inv = 1.f / sqrtf(total / (float)d + eps);

  for (int r = rounds - 1; r >= 0; --r) {   // the last round is in registers
    if (r != rounds - 1) load_round(r);
    const int u0 = r * per_round + threadIdx.x;
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      const int u = u0 + j * nthreads;
      if (u < units) {
        const T* e = reinterpret_cast<const T*>(&xr[j]);
        Raw out;
        T* o = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int i = 0; i < V; ++i)
          o[i] = from_f32<T>(to_f32(e[i]) * inv * wv[j][i]);
        reinterpret_cast<Raw*>(y)[u] = out;
      }
    }
  }
}

// threads for a row of ``units`` units: a function of d alone, mirrored by
// kernels/ops.py:rmsnorm_plan
inline int pick_threads(int units, int per_thread) {
  const int want = (units + per_thread - 1) / per_thread;
  const int t = ((want + 31) / 32) * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

template <typename T, typename TW>
void launch(const void* x, const void* w, void* y, int rows, int d,
            float eps, cudaStream_t s) {
  const bool vec = d % kVec<T> == 0;
  const int units = vec ? d / kVec<T> : d;
  const int threads =
      pick_threads(units, vec ? kVecUnits : kVecUnits * kVec<T>);
  if (vec)
    rmsnorm_kernel<T, TW, true><<<rows, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const TW*>(w),
        static_cast<T*>(y), d, eps);
  else
    rmsnorm_kernel<T, TW, false><<<rows, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const TW*>(w),
        static_cast<T*>(y), d, eps);
}

}  // namespace

extern "C" int repro_rmsnorm(const void* x, const void* w, void* y, int rows,
                             int d, float eps, int dtype, int w_dtype,
                             void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_DTYPE(dtype, T, {
    REPRO_DISPATCH_DTYPE(w_dtype, TW, {
      launch<T, TW>(x, w, y, rows, d, eps, s);
    });
  });
  return (int)cudaGetLastError();
}
