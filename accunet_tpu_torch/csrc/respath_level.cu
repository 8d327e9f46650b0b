// One ResPath level, NHWC:
//   x_i = x_{i-1} + lrelu((y_{i-1} * g) * s_se + t_se)     (has_prev)
//   y_i = lrelu(conv3x3(x_i) * s_bn + t_bn)                 (conv bias in t_bn)
// plus fp32 per-tile channel sums of y_i.
// Replaces the TPU kernel respath_level_frame (accunet_tpu/ops/pallas/respath.py:72).
//
// One CTA per (image, 8x16-pixel tile, 32*NJ output channels). Per chunk of 8
// input channels: stage the 10x18 halo of x_i (the SE apply and residual are
// computed on load, and the tile's x_i written from there) and the 3x3
// weights, then run the implicit-GEMM conv into fp32 registers; warp w owns
// output row w, lane + 32j output channel. The epilogue applies BN + lrelu,
// writes y_i and reduces the tile's channel sums in a fixed order.
#include "common.cuh"

namespace accunet {
namespace {

constexpr int kRpTH = 8, kRpTW = 16, kRpKC = 8;
constexpr int kRpHH = kRpTH + 2, kRpHW = kRpTW + 2;
static_assert(kRpTH == kWarps, "one warp per output row");

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
respath_level_kernel(const T* __restrict__ x, const T* __restrict__ yprev,
                     const float* __restrict__ gate, const float* __restrict__ s_se,
                     const float* __restrict__ t_se, const float* __restrict__ w,
                     const float* __restrict__ s_bn, const float* __restrict__ t_bn,
                     T* __restrict__ y_out, T* __restrict__ x_out, float* __restrict__ sums,
                     int H, int W, int C, int has_prev, int tiles_w, int n_tiles) {
  constexpr int KC = kRpKC, NCOL = 32 * NJ;
  float* X = shared_floats();                 // [HH*HW][KC]
  float* Wsl = X + kRpHH * kRpHW * KC;         // [9][KC][NCOL]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, c0 = blockIdx.y * NCOL, tile = blockIdx.x;
  const int h0 = (tile / tiles_w) * kRpTH, w0 = (tile % tiles_w) * kRpTW;
  const size_t img = static_cast<size_t>(b) * H * W * C;

  float acc[kRpTW][NJ] = {};
  for (int cb = 0; cb < C; cb += KC) {
    for (int i = tid; i < kRpHH * kRpHW * KC; i += kThreads) {
      const int hp = i / KC, c = i % KC, ch = cb + c;
      const int hy = hp / kRpHW, hx = hp % kRpHW;
      const int gy = h0 - 1 + hy, gx = w0 - 1 + hx;
      float v = 0.f;  // SAME padding: zero outside the image
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && ch < C) {
        const size_t idx = img + (static_cast<size_t>(gy) * W + gx) * C + ch;
        v = to_float(x[idx]);
        if (has_prev) {
          v += lrelu((to_float(yprev[idx]) * gate[b * C + ch]) * s_se[ch] + t_se[ch]);
          if (blockIdx.y == 0 && hy >= 1 && hy <= kRpTH && hx >= 1 && hx <= kRpTW)
            x_out[idx] = from_float<T>(v);
        }
      }
      X[i] = v;
    }
    // w is (3, 3, C, C) HWIO
    for (int i = tid; i < 9 * KC * NCOL; i += kThreads) {
      const int t = i / (KC * NCOL), kk = (i / NCOL) % KC, n = i % NCOL;
      float val = 0.f;
      if (cb + kk < C && c0 + n < C) val = w[(static_cast<size_t>(t) * C + cb + kk) * C + c0 + n];
      Wsl[i] = val;
    }
    __syncthreads();
    for (int t = 0; t < 9; ++t) {
      const float* xr = X + ((warp + t / 3) * kRpHW + t % 3) * KC;
      const float* wt = Wsl + t * KC * NCOL + lane;
      for (int kk = 0; kk < KC; ++kk) {
        float wv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) wv[j] = wt[kk * NCOL + 32 * j];
#pragma unroll
        for (int px = 0; px < kRpTW; ++px) {
          const float a = xr[px * KC + kk];
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[px][j] = fmaf(a, wv[j], acc[px][j]);
        }
      }
    }
    __syncthreads();
  }

  float* part = X;  // [kWarps][NCOL] per-row partial sums
  const int gy = h0 + warp;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int n = c0 + lane + 32 * j;
    float s = 0.f;
    if (n < C && gy < H) {
      const float sb = s_bn[n], tb = t_bn[n];
#pragma unroll
      for (int px = 0; px < kRpTW; ++px) {
        const int gx = w0 + px;
        if (gx < W) {
          const T o = from_float<T>(lrelu(acc[px][j] * sb + tb));
          y_out[img + (static_cast<size_t>(gy) * W + gx) * C + n] = o;
          s += to_float(o);
        }
      }
    }
    part[warp * NCOL + lane + 32 * j] = s;
  }
  __syncthreads();
  for (int n = tid; n < NCOL; n += kThreads) {
    if (c0 + n < C) {
      float s = 0.f;
      for (int r = 0; r < kWarps; ++r) s += part[r * NCOL + n];
      sums[(static_cast<size_t>(b) * n_tiles + tile) * C + c0 + n] = s;
    }
  }
}

template <typename T, int NJ>
int launch(const void* x, const void* yprev, const float* gate, const float* s_se,
           const float* t_se, const float* w, const float* s_bn, const float* t_bn, void* y_out,
           void* x_out, float* sums, int B, int H, int W, int C, int has_prev,
           cudaStream_t stream) {
  constexpr int NCOL = 32 * NJ;
  const size_t smem = (kRpHH * kRpHW * kRpKC + 9 * kRpKC * NCOL) * sizeof(float);
  cudaError_t err = allow_smem(respath_level_kernel<T, NJ>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = ceil_div(W, kRpTW), n_tiles = ceil_div(H, kRpTH) * tiles_w;
  const dim3 grid(n_tiles, ceil_div(C, NCOL), B);
  respath_level_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(yprev), gate, s_se, t_se, w, s_bn, t_bn,
      static_cast<T*>(y_out), static_cast<T*>(x_out), sums, H, W, C, has_prev, tiles_w, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* yprev, const float* gate, const float* s_se,
             const float* t_se, const float* w, const float* s_bn, const float* t_bn,
             void* y_out, void* x_out, float* sums, int B, int H, int W, int C, int has_prev,
             cudaStream_t s) {
  if (C <= 32)
    return launch<T, 1>(x, yprev, gate, s_se, t_se, w, s_bn, t_bn, y_out, x_out, sums, B, H, W,
                        C, has_prev, s);
  if (C <= 64)
    return launch<T, 2>(x, yprev, gate, s_se, t_se, w, s_bn, t_bn, y_out, x_out, sums, B, H, W,
                        C, has_prev, s);
  return launch<T, 4>(x, yprev, gate, s_se, t_se, w, s_bn, t_bn, y_out, x_out, sums, B, H, W,
                      C, has_prev, s);
}

}  // namespace
}  // namespace accunet

extern "C" int accunet_respath_level(const void* x, const void* yprev, const void* gate,
                                     const void* s_se, const void* t_se, const void* w,
                                     const void* s_bn, const void* t_bn, void* y_out,
                                     void* x_out, void* sums, int B, int H, int W, int C,
                                     int has_prev, int dtype, void* stream) {
  using namespace accunet;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sm = static_cast<float*>(sums);
  if (dtype == kFloat32)
    return dispatch<float>(x, yprev, f(gate), f(s_se), f(t_se), f(w), f(s_bn), f(t_bn), y_out,
                           x_out, sm, B, H, W, C, has_prev, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(x, yprev, f(gate), f(s_se), f(t_se), f(w), f(s_bn), f(t_bn),
                                   y_out, x_out, sm, B, H, W, C, has_prev, s);
  return -2;
}
