// RMSNorm for Hopper: y = x * (1 / sqrt(mean(x^2) + eps)) * w, the mean
// of squares in f32, y in x's dtype.  w may be f32 while x is bf16 (the
// final norm before the unembed).
//
// Replaces: src/repro/kernels/rmsnorm.py:_rmsnorm_kernel.
//
// Bound on the H100: x is read once and y written once, a few flops per
// byte -- device-memory bandwidth.  At the serving shapes (4 or 64 rows
// of 4096) the tensors are 32-512 KB, so a launch is bound by its fixed
// latency rather than by either rate.
//
// Design: one warp per row (8 rows per 256-thread block) with a
// lane-strided f32 sum of squares and a butterfly over the warp -- one
// fixed order, so the result is deterministic and independent of the row
// count.  Unlike the TPU kernel, which raises when the rows do not divide
// its block, any row count works: the last block masks its missing rows.
#include "common.cuh"

namespace {

using namespace repro;

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ X, const TW* __restrict__ W,
                   T* __restrict__ Y, int rows, int d, float eps) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;   // whole warps leave together
  const int lane = threadIdx.x & 31;
  const T* x = X + (size_t)row * d;
  T* y = Y + (size_t)row * d;
  const float inv = 1.f / sqrtf(row_sumsq(x, d) / (float)d + eps);
  for (int i = lane; i < d; i += 32)
    y[i] = from_f32<T>(to_f32(x[i]) * inv * to_f32(W[i]));
}

}  // namespace

extern "C" int repro_rmsnorm(const void* x, const void* w, void* y, int rows,
                             int d, float eps, int dtype, int w_dtype,
                             void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  REPRO_DISPATCH_DTYPE(dtype, T, {
    REPRO_DISPATCH_DTYPE(w_dtype, TW, {
      rmsnorm_kernel<T, TW><<<blocks, kThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const TW*>(w),
          static_cast<T*>(y), rows, d, eps);
    });
  });
  return (int)cudaGetLastError();
}
