// Shared pieces of the port's CUDA kernels: dtype conversion, the activation,
// dynamic shared memory, and the HANC pyramid helpers of hanc_block.cu.
//
// Conventions of every kernel here: activations are NHWC float or bf16,
// weights and affines fp32, all arithmetic in fp32; one CTA of kThreads (8
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

// The HANC pyramid of a TH x TW pixel tile, as rows of a matrix A in shared
// memory (row stride `ld` floats, `kc` channels used):
//   rows [0, P)      the tile's pixels, row-major
//   rows [A2, M2)    2x2 average pools, then [M2, A4) 2x2 max pools
//   rows [A4, M4)    4x4 average pools, then [M4, NR) 4x4 max pools
// (levels present for K >= 2 and K >= 3). The 4x4 pools are taken from the
// 2x2 maps, as the TPU kernels do. Row r mixes with weight slab `slab(r)`:
// 0 for the pixels, i for avg_{2^i}, K-1+i for max_{2^i}.
template <int TH, int TW, int K>
struct Pyramid {
  static constexpr int P = TH * TW;
  static constexpr int N2 = K >= 2 ? (TH / 2) * (TW / 2) : 0;
  static constexpr int N4 = K >= 3 ? (TH / 4) * (TW / 4) : 0;
  static constexpr int A2 = P, M2 = A2 + N2, A4 = M2 + N2, M4 = A4 + N4, NR = M4 + N4;
  static constexpr int NG = NR / 2;                 // row pairs (never straddle a slab)
  static constexpr int GPW = (NG + kWarps - 1) / kWarps;  // row pairs per warp
  static_assert(NR % 2 == 0 && P % 2 == 0 && N2 % 2 == 0 && N4 % 2 == 0, "row pairs");

  __device__ static int slab(int r) {
    if (r < A2) return 0;
    if (r < M2) return 1;
    if (r < A4) return K;
    if (r < M4) return 2;
    return K + 1;
  }

  // pooled-row index covering pixel p at the 2x2 and 4x4 levels
  __device__ static int q2(int p) { return (p / TW / 2) * (TW / 2) + (p % TW) / 2; }
  __device__ static int q4(int p) { return (p / TW / 4) * (TW / 4) + (p % TW) / 4; }

  // rows [A2, A4) from the pixel rows; pool order (0,0),(0,1),(1,0),(1,1)
  __device__ static void pool2(float* A, int ld, int kc) {
    for (int i = threadIdx.x; i < N2 * kc; i += kThreads) {
      const int q = i / kc, c = i % kc;
      const int src = (2 * (q / (TW / 2))) * TW + 2 * (q % (TW / 2));
      const float* s = A + src * ld + c;
      const float v0 = s[0], v1 = s[ld], v2 = s[TW * ld], v3 = s[(TW + 1) * ld];
      A[(A2 + q) * ld + c] = ((v0 + v1) + (v2 + v3)) * 0.25f;
      A[(M2 + q) * ld + c] = fmaxf(fmaxf(v0, v1), fmaxf(v2, v3));
    }
  }

  // rows [A4, NR) from the 2x2 maps
  __device__ static void pool4(float* A, int ld, int kc) {
    constexpr int W2 = TW / 2;
    for (int i = threadIdx.x; i < N4 * kc; i += kThreads) {
      const int q = i / kc, c = i % kc;
      const int src = (2 * (q / (TW / 4))) * W2 + 2 * (q % (TW / 4));
      const float* a = A + (A2 + src) * ld + c;
      const float* m = A + (M2 + src) * ld + c;
      A[(A4 + q) * ld + c] = ((a[0] + a[ld]) + (a[W2 * ld] + a[(W2 + 1) * ld])) * 0.25f;
      A[(M4 + q) * ld + c] =
          fmaxf(fmaxf(m[0], m[ld]), fmaxf(m[W2 * ld], m[(W2 + 1) * ld]));
    }
  }

  // acc[g][0..1][j] += A[2g..2g+1][0..kc) x Wsl[slab][0..kc)[lane + 32j]:
  // warp w owns row pairs w, w+8, ...; lane + 32j is the output column.
  // Wsl is [slab][kc][32*NJ] in shared memory, zero-padded.
  template <int NJ>
  __device__ static void mix(float (&acc)[GPW][2][NJ], const float* A, int ld,
                             const float* Wsl, int kc) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    constexpr int ncol = 32 * NJ;
#pragma unroll
    for (int gi = 0; gi < GPW; ++gi) {
      const int g = warp + kWarps * gi;
      if (g < NG) {
        const float* a0 = A + 2 * g * ld;
        const float* a1 = a0 + ld;
        const float* w = Wsl + slab(2 * g) * kc * ncol + lane;
        for (int kk = 0; kk < kc; ++kk) {
          const float x0 = a0[kk], x1 = a1[kk];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float wv = w[kk * ncol + 32 * j];
            acc[gi][0][j] = fmaf(x0, wv, acc[gi][0][j]);
            acc[gi][1][j] = fmaf(x1, wv, acc[gi][1][j]);
          }
        }
      }
    }
  }

  // the accumulators to R[NR][32*NJ] in shared memory
  template <int NJ>
  __device__ static void store(const float (&acc)[GPW][2][NJ], float* R) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    constexpr int ncol = 32 * NJ;
#pragma unroll
    for (int gi = 0; gi < GPW; ++gi) {
      const int g = warp + kWarps * gi;
      if (g < NG) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          R[(2 * g) * ncol + lane + 32 * j] = acc[gi][0][j];
          R[(2 * g + 1) * ncol + lane + 32 * j] = acc[gi][1][j];
        }
      }
    }
  }

  // pixel p's mix with the upsample-adds telescoped coarsest-first:
  // x@w0 + up((avg2@w1 + max2@wK) + up(avg4@w2 + max4@wK+1))
  __device__ static float telescope(const float* R, int ncol, int p, int n) {
    float y = R[p * ncol + n];
    if (K >= 2) {
      float t = R[(A2 + q2(p)) * ncol + n] + R[(M2 + q2(p)) * ncol + n];
      if (K >= 3) t = t + (R[(A4 + q4(p)) * ncol + n] + R[(M4 + q4(p)) * ncol + n]);
      y = y + t;
    }
    return y;
  }
};

}  // namespace accunet
