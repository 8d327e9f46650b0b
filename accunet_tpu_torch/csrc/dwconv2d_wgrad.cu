// Depthwise conv2d weight gradient, NHWC, SAME padding:
//   dw[i][j][c] = sum_{b,h,w} x[b, h+i-ph, w+j-pw, c] * g[b, h, w, c]
// (x zero outside the image, ph = (KH-1)/2, pw = (KW-1)/2).
// Replaces the TPU kernel _dwconv2d_wgrad_pallas
// (accunet_tpu/ops/pallas/dwconv2d.py:76, pallas_call :111).
//
// What bounds it on the card: bytes. Each output tap is a reduction over
// B*H*W of one product, so the work is 2*KH*KW flops per element of x and g
// against 2 loads (4 flops per 8 bytes in fp32 at k=3): the H100 runs out of
// bandwidth long before it runs out of FMAs.
//
// Design: pass 1 gives each CTA 32 channels (one per lane, so every warp
// load is 32 neighbouring channels of one pixel) and a contiguous range of
// (b, h) rows; its 8 warps take neighbouring rows, so the KH rows of x that
// a row's taps read are shared between warps through L1. A warp sweeps its
// row left to right, keeping the KH x KW window of x in registers (KH new
// values per pixel) and the KH*KW sums in fp32 registers. The CTA reduces
// its warps in a fixed order into one partial per tap and channel. Pass 2
// sums the partials of the row ranges in a fixed order: no atomics, so the
// result does not change from run to run. The wrapper caps the number of row
// ranges, so the partial buffer does not grow with B*H*W.
#include "common.cuh"

namespace accunet {
namespace {

constexpr int kWgChannels = 32;  // channels per CTA, one per lane

template <typename T, int KH, int KW>
__global__ void __launch_bounds__(kThreads)
dwconv_wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                            float* __restrict__ part, int rows, int H, int W, int C,
                            int rows_per_cta) {
  constexpr int PH = (KH - 1) / 2, PW = (KW - 1) / 2;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = static_cast<int>(blockIdx.x) * kWgChannels + lane;
  const bool live = c < C;
  const int p = blockIdx.y;
  const int r_end = min(rows, (p + 1) * rows_per_cta);

  float acc[KH][KW];
#pragma unroll
  for (int i = 0; i < KH; ++i)
#pragma unroll
    for (int j = 0; j < KW; ++j) acc[i][j] = 0.f;

  if (live) {
    for (int r = p * rows_per_cta + warp; r < r_end; r += kWarps) {
      const int b = r / H, h = r % H;
      const T* grow = g + static_cast<size_t>(r) * W * C + c;
      const T* xrow[KH];
      bool rin[KH];
#pragma unroll
      for (int i = 0; i < KH; ++i) {
        const int hh = h + i - PH;
        rin[i] = hh >= 0 && hh < H;
        xrow[i] = x + (static_cast<size_t>(b) * H + (rin[i] ? hh : 0)) * W * C + c;
      }
      // win[i][j] = x[b, h+i-PH, w+j-PW, c] at step w; columns 1.. are
      // preloaded for w = 0 and shift left by one each step
      float win[KH][KW];
#pragma unroll
      for (int i = 0; i < KH; ++i) {
        win[i][0] = 0.f;
#pragma unroll
        for (int j = 1; j < KW; ++j) {
          const int ww = j - 1 - PW;
          win[i][j] = (rin[i] && ww >= 0 && ww < W)
                          ? to_float(xrow[i][static_cast<size_t>(ww) * C]) : 0.f;
        }
      }
      for (int w = 0; w < W; ++w) {
        const int wn = w + KW - 1 - PW;  // >= 0: the column entering the window
#pragma unroll
        for (int i = 0; i < KH; ++i) {
#pragma unroll
          for (int j = 0; j < KW - 1; ++j) win[i][j] = win[i][j + 1];
          win[i][KW - 1] =
              (rin[i] && wn < W) ? to_float(xrow[i][static_cast<size_t>(wn) * C]) : 0.f;
        }
        const float gv = to_float(grow[static_cast<size_t>(w) * C]);
#pragma unroll
        for (int i = 0; i < KH; ++i)
#pragma unroll
          for (int j = 0; j < KW; ++j) acc[i][j] = fmaf(win[i][j], gv, acc[i][j]);
      }
    }
  }

  // the CTA's partial for each tap: its warps summed in warp order
  float* red = shared_floats();  // [kWarps][32]
  float* out = part + static_cast<size_t>(p) * KH * KW * C;
#pragma unroll
  for (int t = 0; t < KH * KW; ++t) {
    red[warp * 32 + lane] = acc[t / KW][t % KW];
    __syncthreads();
    if (warp == 0 && live) {
      float s = 0.f;
      for (int q = 0; q < kWarps; ++q) s += red[q * 32 + lane];
      out[static_cast<size_t>(t) * C + c] = s;
    }
    __syncthreads();
  }
}

// dw[t] = sum over the row ranges p of part[p][t], p in order
__global__ void __launch_bounds__(kThreads)
dwconv_wgrad_sum_kernel(const float* __restrict__ part, float* __restrict__ dw, int n_parts,
                        int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;  // no barrier in this kernel
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += part[static_cast<size_t>(p) * n + i];
  dw[i] = s;
}

template <typename T, int KH, int KW>
int launch(const void* x, const void* g, float* part, float* dw, int B, int H, int W, int C,
           int n_parts, int rows_per_cta, cudaStream_t stream) {
  const dim3 grid(ceil_div(C, kWgChannels), n_parts);
  const size_t smem = kWarps * 32 * sizeof(float);
  dwconv_wgrad_partial_kernel<T, KH, KW><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), part, B * H, H, W, C, rows_per_cta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = KH * KW * C;
  dwconv_wgrad_sum_kernel<<<ceil_div(n, kThreads), kThreads, 0, stream>>>(part, dw, n_parts, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_k(const void* x, const void* g, float* part, float* dw, int B, int H, int W,
               int C, int kh, int kw, int n_parts, int rows_per_cta, cudaStream_t s) {
  if (kh == 3 && kw == 3)
    return launch<T, 3, 3>(x, g, part, dw, B, H, W, C, n_parts, rows_per_cta, s);
  if (kh == 5 && kw == 5)
    return launch<T, 5, 5>(x, g, part, dw, B, H, W, C, n_parts, rows_per_cta, s);
  if (kh == 7 && kw == 7)
    return launch<T, 7, 7>(x, g, part, dw, B, H, W, C, n_parts, rows_per_cta, s);
  return -1;
}

}  // namespace
}  // namespace accunet

// x, g (B, H, W, C) of `dtype`; part (n_parts, kh*kw, C) fp32 scratch;
// dw (kh, kw, C) fp32. Row range p covers the flattened (b, h) rows
// [p*rows_per_cta, (p+1)*rows_per_cta).
extern "C" int accunet_dwconv2d_wgrad(const void* x, const void* g, void* part, void* dw,
                                      int B, int H, int W, int C, int kh, int kw, int n_parts,
                                      int rows_per_cta, int dtype, void* stream) {
  using namespace accunet;
  float* pf = static_cast<float*>(part);
  float* df = static_cast<float*>(dw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_k<float>(x, g, pf, df, B, H, W, C, kh, kw, n_parts, rows_per_cta, s);
  if (dtype == kBFloat16)
    return dispatch_k<__nv_bfloat16>(x, g, pf, df, B, H, W, C, kh, kw, n_parts, rows_per_cta,
                                     s);
  return -2;
}
