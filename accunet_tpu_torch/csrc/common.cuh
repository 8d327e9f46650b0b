// Shared pieces of the port's CUDA kernels: dtype conversion, the activation,
// dynamic shared memory (the tensor-core helpers are in mma.cuh).
//
// Conventions of every kernel here: activations are NHWC float or bf16,
// weights and affines fp32 (the tensor-core kernels' weights in the input
// type), sums in fp32; one CTA of kThreads (8
// warps); a kernel launches on the caller's stream and its C entry point
// returns cudaGetLastError() (or a negative code for a shape it refuses).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace accunet {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// LeakyReLU(0.01) as max(x, 0.01x), the form of the plain versions
__device__ __forceinline__ float lrelu(float v) { return fmaxf(v, 0.01f * v); }

// the running kernel's dynamic shared memory, as floats
__device__ __forceinline__ float* shared_floats() {
  extern __shared__ float4 accunet_smem[];
  return reinterpret_cast<float*>(accunet_smem);
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// opt a kernel into more than the default 48 KB of dynamic shared memory
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace accunet
