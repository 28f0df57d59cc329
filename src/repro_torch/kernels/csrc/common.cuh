// Shared pieces of the port's Hopper kernels (built for sm_90a by
// repro_torch/kernels/_build.py and called through ctypes).
//
// Every kernel here is deterministic: each output element is reduced in
// one fixed order that depends only on the contraction length, never on
// the row count M, the row's position in the batch or the run.  That is
// what keeps the serving contracts exact on the card (paged == each
// request alone, chunked prefill == dense prefill, prefix sharing on ==
// off): no atomics, no split-K whose order changes between launches.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace repro {

// dtype codes, mirrored by _build.DTYPE_CODES
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int kThreads = 256;                 // every kernel: 8 warps
constexpr int kWarps = kThreads / 32;
// dynamic shared memory a block may opt into on sm_90 (227 KB; mirrored
// by ops._SMEM)
constexpr int kMaxDynamicSmem = 232448;

// A kernel attribute set once per device.  cudaFuncSetAttribute acts on
// the current device, so a process-wide "done" would leave every card but
// the first at the default limit.  Each call site keeps one table (a
// function-local static of its instantiation), keyed by cudaGetDevice;
// the first launch on a device runs ``set`` and every later one reuses
// its result.  The wrappers make the operands' device current
// (_build.launch).  No runtime call but cudaGetDevice on the launch
// path, which a CUDA-graph capture may run.
constexpr int kMaxDevices = 64;

struct PerDevice {
  std::mutex mu;
  bool done[kMaxDevices] = {};
  cudaError_t err[kMaxDevices] = {};
};

template <typename F>
inline cudaError_t once_per_device(PerDevice& table, F set) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(table.mu);
  if (!table.done[dev]) {
    table.err[dev] = set();
    table.done[dev] = true;
  }
  return table.err[dev];
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
// round to nearest even, as torch's .to(bfloat16) / .to(float16)
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// the value ``v`` takes after a round trip through T (the reference's
// ``.astype(x.dtype)`` between fused stages)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// two values rounded to T and packed in one 32-bit register, the first in
// the low half (one cvt.rn.*x2 instruction)
template <typename T>
__device__ __forceinline__ unsigned pack2(float a, float b);
template <>
__device__ __forceinline__ unsigned pack2<__nv_bfloat16>(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&v);
}
template <>
__device__ __forceinline__ unsigned pack2<__half>(float a, float b) {
  const __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&v);
}

// one 16-byte load holds kVec<T> elements
template <typename T> constexpr int kVec = 16 / sizeof(T);

// sum of squares of one row, lane-strided then a butterfly over the warp
template <typename T>
__device__ __forceinline__ float row_sumsq(const T* x, int d) {
  const int lane = threadIdx.x & 31;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(x[i]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  return ss;
}

// Launch ``kern`` (``block`` threads a block) as the programmatic
// dependent of the kernel before it on ``s``: it may start once every
// block of that kernel has run griddepcontrol.launch_dependents (or
// ended), and must run griddepcontrol.wait before it reads what that
// kernel writes.
template <typename... P, typename... A>
cudaError_t launch_pdl(void (*kern)(P...), dim3 grid, dim3 block, int smem,
                       cudaStream_t s, A... args) {
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

// launch_pdl with kThreads a block
template <typename... P, typename... A>
cudaError_t launch_dependent(void (*kern)(P...), dim3 grid, int smem,
                             cudaStream_t s, A... args) {
  return launch_pdl(kern, grid, dim3(kThreads), smem, s, args...);
}

}  // namespace repro

#define REPRO_DISPATCH_DTYPE(code, T, ...)       \
  switch (code) {                                \
    case repro::kF32: {                          \
      using T = float;                           \
      __VA_ARGS__;                               \
    } break;                                     \
    case repro::kBF16: {                         \
      using T = __nv_bfloat16;                   \
      __VA_ARGS__;                               \
    } break;                                     \
    case repro::kF16: {                          \
      using T = __half;                          \
      __VA_ARGS__;                               \
    } break;                                     \
    default:                                     \
      return (int)cudaErrorInvalidValue;         \
  }
