// HANC aggregation + 1x1 mix (pre-BN), NHWC:
//   y = x@w0 + sum_{i<k} up_{2^i}(avg_{2^i}(x)@w_i + max_{2^i}(x)@w_{k-1+i}) + b
// Replaces the TPU kernel hanc_mix (accunet_tpu/ops/pallas/hanc.py:154).
//
// One CTA per (image, 4x8-pixel tile, 32*NJ output channels). Per chunk of
// 16 input channels: stage the tile and the weight slabs in shared memory,
// build the 2x2/4x4 avg/max pyramid, and accumulate all 2k-1 mixes into fp32
// registers (warp = row pairs, lane = output column). The epilogue telescopes
// the upsample-adds and writes y once: the full-resolution map is read once
// and written once; the pyramid never reaches device memory.
#include "common.cuh"

namespace accunet {
namespace {

constexpr int kMixTH = 4, kMixTW = 8, kMixKC = 16;

template <typename T, int K, int NJ>
__global__ void __launch_bounds__(kThreads)
hanc_mix_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, T* __restrict__ y, int H, int W, int C,
                int Cout, int tiles_w) {
  using Pyr = Pyramid<kMixTH, kMixTW, K>;
  constexpr int KC = kMixKC, NCOL = 32 * NJ, NV = 2 * K - 1;
  static_assert(Pyr::NR <= NV * KC, "the epilogue reuses the weight buffer");
  float* A = shared_floats();     // [NR][KC]
  float* Wsl = A + Pyr::NR * KC;  // [NV][KC][NCOL]

  const int tid = threadIdx.x;
  const int b = blockIdx.z, c0 = blockIdx.y * NCOL;
  const int h0 = (blockIdx.x / tiles_w) * kMixTH, w0 = (blockIdx.x % tiles_w) * kMixTW;
  const T* xb = x + static_cast<size_t>(b) * H * W * C;

  float acc[Pyr::GPW][2][NJ] = {};
  for (int cb = 0; cb < C; cb += KC) {
    for (int i = tid; i < Pyr::P * KC; i += kThreads) {
      const int p = i / KC, c = i % KC;
      const int gy = h0 + p / kMixTW, gx = w0 + p % kMixTW;
      float v = 0.f;
      if (gy < H && gx < W && cb + c < C)
        v = to_float(xb[(static_cast<size_t>(gy) * W + gx) * C + cb + c]);
      A[i] = v;
    }
    // w is (C, NV, Cout): slab v of input channel c at w[(c*NV + v)*Cout + o]
    for (int i = tid; i < NV * KC * NCOL; i += kThreads) {
      const int v = i / (KC * NCOL), kk = (i / NCOL) % KC, n = i % NCOL;
      float val = 0.f;
      if (cb + kk < C && c0 + n < Cout)
        val = w[(static_cast<size_t>(cb + kk) * NV + v) * Cout + c0 + n];
      Wsl[i] = val;
    }
    __syncthreads();
    if (K >= 2) {
      Pyr::pool2(A, KC, KC);
      __syncthreads();
    }
    if (K >= 3) {
      Pyr::pool4(A, KC, KC);
      __syncthreads();
    }
    Pyr::template mix<NJ>(acc, A, KC, Wsl, KC);
    __syncthreads();
  }

  float* R = Wsl;  // [NR][NCOL]
  Pyr::template store<NJ>(acc, R);
  __syncthreads();
  T* yb = y + static_cast<size_t>(b) * H * W * Cout;
  for (int i = tid; i < Pyr::P * NCOL; i += kThreads) {
    const int p = i / NCOL, n = i % NCOL;
    const int gy = h0 + p / kMixTW, gx = w0 + p % kMixTW;
    if (gy < H && gx < W && c0 + n < Cout) {
      const float v = Pyr::telescope(R, NCOL, p, n) + bias[c0 + n];
      yb[(static_cast<size_t>(gy) * W + gx) * Cout + c0 + n] = from_float<T>(v);
    }
  }
}

template <typename T, int K, int NJ>
int launch(const void* x, const float* w, const float* bias, void* y, int B, int H, int W,
           int C, int Cout, cudaStream_t stream) {
  using Pyr = Pyramid<kMixTH, kMixTW, K>;
  constexpr int NCOL = 32 * NJ;
  const size_t smem = (Pyr::NR * kMixKC + (2 * K - 1) * kMixKC * NCOL) * sizeof(float);
  cudaError_t err = allow_smem(hanc_mix_kernel<T, K, NJ>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = ceil_div(W, kMixTW);
  const dim3 grid(ceil_div(H, kMixTH) * tiles_w, ceil_div(Cout, NCOL), B);
  hanc_mix_kernel<T, K, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w, bias, static_cast<T*>(y), H, W, C, Cout, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int dispatch_nj(const void* x, const float* w, const float* bias, void* y, int B, int H,
                int W, int C, int Cout, cudaStream_t s) {
  if (Cout <= 32) return launch<T, K, 1>(x, w, bias, y, B, H, W, C, Cout, s);
  if (Cout <= 64) return launch<T, K, 2>(x, w, bias, y, B, H, W, C, Cout, s);
  return launch<T, K, 4>(x, w, bias, y, B, H, W, C, Cout, s);
}

template <typename T>
int dispatch_k(const void* x, const float* w, const float* bias, void* y, int B, int H,
               int W, int C, int Cout, int k, cudaStream_t s) {
  if (k == 2) return dispatch_nj<T, 2>(x, w, bias, y, B, H, W, C, Cout, s);
  if (k == 3) return dispatch_nj<T, 3>(x, w, bias, y, B, H, W, C, Cout, s);
  return -1;
}

}  // namespace
}  // namespace accunet

extern "C" int accunet_hanc_mix(const void* x, const void* w, const void* bias, void* y,
                                int B, int H, int W, int C, int Cout, int k, int dtype,
                                void* stream) {
  using namespace accunet;
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_k<float>(x, wf, bf, y, B, H, W, C, Cout, k, s);
  if (dtype == kBFloat16)
    return dispatch_k<__nv_bfloat16>(x, wf, bf, y, B, H, W, C, Cout, k, s);
  return -2;
}
