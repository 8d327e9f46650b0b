// Hybrid HANCBlock front half, NHWC:
//   u = lrelu((x@w1)*s1 + t1)            expand, BN1 (the conv bias folded: t1 += b1*s1)
//   y = lrelu(dw3x3(pad0(u))*s2 + t2)    SAME depthwise, BN2 (t2 += bd*s2)
// Replaces the TPU kernel expand_dw_nhwc (accunet_tpu/ops/pallas/expand_dw.py:77,
// body _kernel :29), which ran a (batch, row block) grid with two-block halo
// staging in VMEM.
//
// One CTA computes one image, one 14x14-pixel tile and one chunk of 64 of the
// E channels (the depthwise conv is per channel, so chunks are independent).
// It stages the tile's 16x16 halo of x and w1[:, chunk] in shared memory, 32
// input channels at a time, and expands the halo as a register-tiled product
// (each thread 8 pixels x 8 channels, fp32 FMAs). The activated halo goes to
// shared memory with out-of-image pixels set to 0 AFTER the activation: SAME
// padding pads the activated map, not x. The nine taps then run per channel,
// and consecutive threads store consecutive channels (NHWC), so the stores
// coalesce.
//
// What bounds it on the card: fp32 FMAs on CUDA cores (2*px*E*(cin+9) flops)
// times the halo recompute, 256/196 = 1.31 at 56x56 maps and 1.56 at 128x128
// (ragged last tiles); device-memory traffic is one read of x (13-17 MB at
// the main path's shapes, small enough for the 50 MB L2 to serve the later
// channel chunks' re-reads) and one write of y, against the unfused path's
// round trips of the E-wide interior.
// Tensor cores (wgmma) for the expand are later work.
#include "common.cuh"

namespace accunet {
namespace {

constexpr int kEdT = 14;                // output tile edge
constexpr int kEdHS = kEdT + 2;         // halo edge
constexpr int kEdHP = kEdHS * kEdHS;    // halo pixels (256)
constexpr int kEdEC = 64;               // E channels per CTA
constexpr int kEdKC = 32;               // cin channels per staging step
constexpr int kEdXLD = kEdKC + 1;       // Xs row stride (conflict-free scalar reads)
constexpr int kEdPPT = 8, kEdCPT = 8;   // expand: pixels x channels per thread
static_assert(kEdHP / kEdPPT * (kEdEC / kEdCPT) == kThreads, "one pass covers the halo");

// shared memory, in floats: Us [HP][EC] activated halo, Ws [KC][EC], Xs [HP][KC+1],
// Ps [13][EC] = s1, t1, s2, t2, wd taps 0..8
constexpr int kEdUs = 0, kEdWs = kEdUs + kEdHP * kEdEC, kEdXs = kEdWs + kEdKC * kEdEC;
constexpr int kEdPs = kEdXs + kEdHP * kEdXLD, kEdFloats = kEdPs + 13 * kEdEC;
constexpr size_t kEdSmem = kEdFloats * sizeof(float);
static_assert(kEdWs % 4 == 0 && kEdXs % 4 == 0, "float4 reads of Ws");

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
expand_dw_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ wd, const float* __restrict__ affe,
                 T* __restrict__ y, int H, int W, int cin, int E, int tiles_w) {
  float* smem = shared_floats();
  float* Us = smem + kEdUs;
  float* Ws = smem + kEdWs;
  float* Xs = smem + kEdXs;
  float* Ps = smem + kEdPs;

  const int tid = threadIdx.x;
  const int tile = blockIdx.x, e0 = blockIdx.y * kEdEC, b = blockIdx.z;
  const int h0 = (tile / tiles_w) * kEdT, w0 = (tile % tiles_w) * kEdT;
  const T* xb = x + static_cast<size_t>(b) * H * W * cin;

  for (int i = tid; i < 13 * kEdEC; i += kThreads) {  // affe is (4, E), wd (9, E)
    const int r = i / kEdEC, e = e0 + i % kEdEC;
    float v = 0.f;
    if (e < E) v = r < 4 ? affe[static_cast<size_t>(r) * E + e]
                         : wd[static_cast<size_t>(r - 4) * E + e];
    Ps[i] = v;
  }

  // expand: thread (pg, cg) owns halo pixels pg*8.. and chunk channels cg*8..
  const int cg = tid % (kEdEC / kEdCPT), pg = tid / (kEdEC / kEdCPT);
  float acc[kEdPPT][kEdCPT] = {};
  for (int c0 = 0; c0 < cin; c0 += kEdKC) {
    __syncthreads();  // the previous step's readers are done with Xs, Ws
    for (int i = tid; i < kEdHP * kEdKC; i += kThreads) {
      const int p = i / kEdKC, k = i % kEdKC;
      const int gy = h0 - 1 + p / kEdHS, gx = w0 - 1 + p % kEdHS;
      float v = 0.f;
      if (c0 + k < cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_float(xb[(static_cast<size_t>(gy) * W + gx) * cin + c0 + k]);
      Xs[p * kEdXLD + k] = v;
    }
    for (int i = tid; i < kEdKC * kEdEC; i += kThreads) {
      const int k = i / kEdEC, e = e0 + i % kEdEC;
      Ws[i] = c0 + k < cin && e < E ? w1[static_cast<size_t>(c0 + k) * E + e] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kEdKC; ++k) {  // zero-filled past cin
      const float4 wa = *reinterpret_cast<const float4*>(Ws + k * kEdEC + cg * kEdCPT);
      const float4 wb = *reinterpret_cast<const float4*>(Ws + k * kEdEC + cg * kEdCPT + 4);
      const float wv[kEdCPT] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int j = 0; j < kEdPPT; ++j) {
        const float xv = Xs[(pg * kEdPPT + j) * kEdXLD + k];
#pragma unroll
        for (int c = 0; c < kEdCPT; ++c) acc[j][c] = fmaf(xv, wv[c], acc[j][c]);
      }
    }
  }

  // BN1 + lrelu; the conv's zero padding (and the ragged tile's outside) is 0
#pragma unroll
  for (int j = 0; j < kEdPPT; ++j) {
    const int p = pg * kEdPPT + j;
    const int gy = h0 - 1 + p / kEdHS, gx = w0 - 1 + p % kEdHS;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    float u[kEdCPT];
#pragma unroll
    for (int c = 0; c < kEdCPT; ++c) {
      const int ee = cg * kEdCPT + c;
      u[c] = inside ? lrelu(fmaf(acc[j][c], Ps[ee], Ps[kEdEC + ee])) : 0.f;
    }
    float4* dst = reinterpret_cast<float4*>(Us + p * kEdEC + cg * kEdCPT);
    dst[0] = make_float4(u[0], u[1], u[2], u[3]);
    dst[1] = make_float4(u[4], u[5], u[6], u[7]);
  }
  __syncthreads();

  // depthwise 3x3 (taps in row-major order), BN2 + lrelu, one channel per
  // thread, rows oy = rg, rg+4, ... swept left to right with a 3x3 window
  const int ee = tid % kEdEC, rg = tid / kEdEC, e = e0 + ee;
  float tap[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) tap[t] = Ps[(4 + t) * kEdEC + ee];
  const float s2 = Ps[2 * kEdEC + ee], t2 = Ps[3 * kEdEC + ee];
  T* yb = y + static_cast<size_t>(b) * H * W * E;
  for (int oy = rg; oy < kEdT; oy += kThreads / kEdEC) {
    const float* u = Us + (oy * kEdHS) * kEdEC + ee;  // halo row oy = image row h0+oy-1
    float win[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      win[r][1] = u[(r * kEdHS + 0) * kEdEC];
      win[r][2] = u[(r * kEdHS + 1) * kEdEC];
    }
    const int gy = h0 + oy;
    for (int ox = 0; ox < kEdT; ++ox) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        win[r][0] = win[r][1];
        win[r][1] = win[r][2];
        win[r][2] = u[(r * kEdHS + ox + 2) * kEdEC];
      }
      float s = win[0][0] * tap[0];
#pragma unroll
      for (int t = 1; t < 9; ++t) s += win[t / 3][t % 3] * tap[t];
      const int gx = w0 + ox;
      if (gy < H && gx < W && e < E)
        yb[(static_cast<size_t>(gy) * W + gx) * E + e] = from_float<T>(lrelu(fmaf(s, s2, t2)));
    }
  }
}

template <typename T>
int launch(const void* x, const float* w1, const float* wd, const float* affe, void* y, int B,
           int H, int W, int cin, int E, cudaStream_t stream) {
  cudaError_t err = allow_smem(expand_dw_kernel<T>, kEdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a hint: as much of the SM's L1/shared split as shared, so two CTAs fit
  err = cudaFuncSetAttribute(expand_dw_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = ceil_div(W, kEdT);
  const dim3 grid(ceil_div(H, kEdT) * tiles_w, ceil_div(E, kEdEC), B);
  expand_dw_kernel<T><<<grid, kThreads, kEdSmem, stream>>>(
      static_cast<const T*>(x), w1, wd, affe, static_cast<T*>(y), H, W, cin, E, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace accunet

// x (B,H,W,cin) and y (B,H,W,E) in `dtype`; w1 (cin,E), wd (9,E) and
// affe (4,E) = [s1, t1, s2, t2] fp32, the conv biases folded into t1, t2
extern "C" int accunet_expand_dw(const void* x, const void* w1, const void* wd,
                                 const void* affe, void* y, int B, int H, int W, int cin,
                                 int E, int dtype, void* stream) {
  using namespace accunet;
  if (B < 1 || H < 1 || W < 1 || cin < 1 || E < 1 || ceil_div(E, kEdEC) > 65535 || B > 65535)
    return -3;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(x, f(w1), f(wd), f(affe), y, B, H, W, cin, E, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, f(w1), f(wd), f(affe), y, B, H, W, cin, E, s);
  return -2;
}
