// HANC aggregation + 1x1 mix (pre-BN), NHWC, on the tensor cores:
//   y = x@w0 + sum_{0<i<k} up_{2^i}(avg_{2^i}(x)@w_i + max_{2^i}(x)@w_{k-1+i}) + b
// Replaces the TPU kernel hanc_mix (accunet_tpu/ops/pallas/hanc.py:154, body
// _kernel :68-120), which ran the whole telescope per row tile in VMEM.
//
// What bounds it on an H100 SXM, at cnv72 of ACC_UNet b8 224x224 (x
// (8,56,56,4352) -> 128, k=3, 45.4 GFLOP): in fp32 the tensor cores at
// 3xTF32, 3 x 45.4 GFLOP / 495 TFLOP/s = 0.275 ms (its bytes, 0.138 ms); in
// bf16 the bytes, x 218 MB + w + y: 0.070 ms. Every CTA also streams the
// weight of its output columns from L2, once per pixel tile.
//
// It is a grouped GEMM, y^T = W^T A^T: M = output channels, N = the rows of
// the tile's pyramid A (the pixels, then the 2x2 and 4x4 avg and max pools,
// each in 8-row groups with their own weight slab), K = input channels. What
// the design does about the three faults of the CUDA-core version it replaced
// (4x8-pixel tiles, fp32 FMAs fed from shared memory, no overlap):
//  1. the products run on the tensor cores through mma.sync, into fp32
//     registers: bf16 as m16n8k16 on bf16 x and bf16 w (the wrapper rounds w,
//     the pools are rounded to bf16 as JAX's kernel pools in the input type);
//     fp32 as 3xTF32 m16n8k8, each operand split into a tf32 high part and
//     its remainder, hi*hi + hi*lo + lo*hi (close to fp32 accuracy, where
//     plain TF32 keeps about three digits), each K-chunk summed from 0 and
//     then added to the accumulator in fp32 (Ops::kPromote);
//  2. a CTA covers 128 or 256 pixels (8x16 or 16x16) x 16-128 output
//     channels (`Tile`, picked by shape), so the weight is read from L2 4-8x
//     less often than with 32 pixels; tile sides are multiples of 4, so no
//     pool crosses a tile;
//  3. a ring of 3 shared-memory stages filled by cp.async (16-byte copies
//     where the rows allow, element copies otherwise), one barrier per
//     K-chunk: iteration ch multiplies chunk ch, pools chunk ch+1 (into its
//     pyramid rows, in shared memory) and issues the copies of chunk ch+2.
// The epilogue telescopes the upsample-adds from the partial sums in shared
// memory and writes y once: x is read once and y written once, the pyramid
// never reaches device memory. Ragged K-chunks, output columns and pixels are
// zero-filled and masked at the store; every thread reaches every barrier.
#include <stdint.h>

#include "mma.cuh"

namespace accunet {
namespace {

constexpr int kStages = 3;  // the cp.async ring

template <typename T, int K, class C>
__global__ void __launch_bounds__(C::THREADS, 1)
hanc_mix_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const float* __restrict__ bias, T* __restrict__ y, int H, int W, int Cin,
                int Cout, int tiles_w, int vec_x, int vec_w) {
  using O = Ops<T>;
  using L = Rows<C, K>;
  constexpr int KC = O::KC, LDX = O::LDX, NV = 2 * K - 1, NCOL = C::NCOL, TW = C::TW;
  constexpr int LDW = NCOL + O::PADW, WSL = KC * LDW;  // a weight slab: [KC][LDW]
  constexpr int LDR = NCOL + 4, NTH = C::THREADS;
  constexpr int XS = L::NR * LDX, STAGE = XS + NV * WSL;  // elements of T
  T* smem = reinterpret_cast<T*>(shared_floats());

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = (warp % C::WM) * C::MT * 16, nh = warp / C::WM;
  const int c0 = blockIdx.x * NCOL, b = blockIdx.z;
  const int h0 = (blockIdx.y / tiles_w) * C::TH, w0 = (blockIdx.y % tiles_w) * TW;
  const T* xb = x + static_cast<size_t>(b) * H * W * Cin;
  const int nchunks = (Cin + KC - 1) / KC;
  const T zero = from_float<T>(0.f);

  // 16-byte copies: thread tid copies the same 16-byte column of rows that
  // are a fixed stride apart in every chunk (x: XPS pixels, XGS image rows;
  // w: WRS slab rows), so a copy costs an add, a compare and the copy
  constexpr int XSEG = KC / O::VEC, XPS = NTH / XSEG, XGS = XPS / TW, XN = L::P * XSEG;
  constexpr int WSEG = NCOL / O::VEC, WRS = NTH / WSEG, WN = NV * KC * WSEG;
  static_assert(NTH % XSEG == 0 && XPS % TW == 0 && XN % NTH == 0, "fixed x columns");
  static_assert(NTH % WSEG == 0 && (WRS % KC == 0 || KC % WRS == 0), "fixed w columns");

  // stage the x rows and the NV weight slabs of K-chunk ch
  auto load_chunk = [&](int ch) {
    if (ch >= nchunks) return;
    T* Xs = smem + (ch % kStages) * STAGE;
    T* Ws = Xs + XS;
    const int cb = ch * KC;
    if (vec_x) {
      const int p0 = tid / XSEG, c = (tid % XSEG) * O::VEC, gy = h0 + p0 / TW, gx = w0 + p0 % TW;
      const T* src = xb + (static_cast<size_t>(gy) * W + gx) * Cin + cb + c;
      const size_t step = static_cast<size_t>(XGS) * W * Cin;
      const bool ok = gx < W && cb + c < Cin;
#pragma unroll
      for (int r = 0; r < XN / NTH; ++r) {
        const bool in = ok && gy + r * XGS < H;
        cp_async16(Xs + (p0 + r * XPS) * LDX + c, in ? src + r * step : x, in);
      }
    } else {
      for (int i = tid; i < L::P * KC; i += NTH) {
        const int p = i / KC, c = cb + i % KC;
        const int gy = h0 + p / TW, gx = w0 + p % TW;
        Xs[p * LDX + i % KC] = gy < H && gx < W && c < Cin
                                   ? xb[(static_cast<size_t>(gy) * W + gx) * Cin + c]
                                   : zero;
      }
    }
    // w is (Cin, NV, Cout): slab v of input channel c at w[(c*NV + v)*Cout + o]
    if (vec_w) {
      // copy r: slab row (tid / WSEG) + r * WRS, i.e. slab v0 + vr, channel k0 + kr
      const int r0 = tid / WSEG, v0 = r0 / KC, k0 = r0 % KC, n = (tid % WSEG) * O::VEC;
      const T* src = w + (static_cast<size_t>(cb + k0) * NV + v0) * Cout + c0 + n;
      const bool ok = c0 + n < Cout;
#pragma unroll
      for (int r = 0; r < (WN + NTH - 1) / NTH; ++r) {
        if (WN % NTH && tid + r * NTH >= WN) break;
        const int vr = r * WRS / KC, kr = r * WRS % KC;
        const bool in = ok && cb + k0 + kr < Cin;
        cp_async16(Ws + (v0 + vr) * WSL + (k0 + kr) * LDW + n,
                   in ? src + (static_cast<size_t>(kr) * NV + vr) * Cout : w, in);
      }
    } else {
      for (int i = tid; i < NV * KC * NCOL; i += NTH) {
        const int v = i / (KC * NCOL), kk = (i / NCOL) % KC, n = c0 + i % NCOL;
        Ws[v * WSL + kk * LDW + i % NCOL] =
            cb + kk < Cin && n < Cout ? w[(static_cast<size_t>(cb + kk) * NV + v) * Cout + n]
                                      : zero;
      }
    }
  };

  // the pools of a staged chunk into its pyramid rows, in fp32 and rounded to
  // T; a 4x4 pool is taken from its four rounded 2x2 pools, as the TPU
  // kernel pools the pooled maps. An item is CW channels of one 4x4 window
  // (its four 2x2 pools and its 4x4 pool; K = 3) or of one 2x2 window (K =
  // 2), CW as wide as keeps every thread busy.
  constexpr int NWIN = K >= 3 ? L::N4 : L::N2;
  constexpr int CW = NWIN * KC >= 4 * NTH ? 4 : NWIN * KC >= 2 * NTH ? 2 : 1, KV = KC / CW;
  // the 2x2 pools of CW channels of the window whose top-left pixel's row is s
  auto window = [&](const T* s, float (&avg)[CW], float (&mx)[CW]) {
    float v0[CW], v1[CW], v2[CW], v3[CW];
    ldv(s, v0), ldv(s + LDX, v1), ldv(s + TW * LDX, v2), ldv(s + (TW + 1) * LDX, v3);
#pragma unroll
    for (int e = 0; e < CW; ++e) {
      avg[e] = round_to<T>(((v0[e] + v1[e]) + (v2[e] + v3[e])) * 0.25f);
      mx[e] = fmaxf(fmaxf(v0[e], v1[e]), fmaxf(v2[e], v3[e]));
    }
  };
  auto pool = [&](T* Xs) {
    for (int i = tid; i < NWIN * KV; i += NTH) {
      const int q = i / KV, c = (i % KV) * CW;
      if constexpr (K >= 3) {
        const int qy = q / (TW / 4), qx = q % (TW / 4);
        float avg[4][CW], mx[4][CW], a4[CW], m4[CW];
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const int y2 = 2 * qy + (d >> 1), x2 = 2 * qx + (d & 1), q2 = y2 * (TW / 2) + x2;
          window(Xs + (2 * y2 * TW + 2 * x2) * LDX + c, avg[d], mx[d]);
          stv(Xs + (L::A2 + q2) * LDX + c, avg[d]);
          stv(Xs + (L::M2 + q2) * LDX + c, mx[d]);
        }
#pragma unroll
        for (int e = 0; e < CW; ++e) {
          a4[e] = ((avg[0][e] + avg[1][e]) + (avg[2][e] + avg[3][e])) * 0.25f;
          m4[e] = fmaxf(fmaxf(mx[0][e], mx[1][e]), fmaxf(mx[2][e], mx[3][e]));
        }
        stv(Xs + (L::A4 + q) * LDX + c, a4);
        stv(Xs + (L::A4 + L::N4 + q) * LDX + c, m4);
      } else {
        float avg[CW], mx[CW];
        window(Xs + ((2 * (q / (TW / 2))) * TW + 2 * (q % (TW / 2))) * LDX + c, avg, mx);
        stv(Xs + (L::A2 + q) * LDX + c, avg);
        stv(Xs + (L::M2 + q) * LDX + c, mx);
      }
    }
  };

  // One barrier per K-chunk: iteration ch multiplies chunk ch (pooled in
  // iteration ch-1), pools chunk ch+1 (landed) and issues chunk ch+2.
  float acc[L::NT][C::MT][4] = {};
  load_chunk(0);
  cp_async_commit();
  load_chunk(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  pool(smem);
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<0>();
    __syncthreads();  // chunk ch+1 has landed, chunk ch is pooled, chunk ch-1 is done with
    T* next = smem + ((ch + 1) % kStages) * STAGE;
    if (O::kPrepareFirst) {
      load_chunk(ch + 2);  // into chunk ch-1's stage
      if (ch + 1 < nchunks) pool(next);
    }
    const T* Xs = smem + (ch % kStages) * STAGE;
    const T* Ws = Xs + XS;
    mix<0, L::NT0>(acc, Ws, LDW, Xs, L::row(0, nh), m0, lane);
    if (!O::kPrepareFirst) {
      if (ch + 1 < nchunks) pool(next);
      load_chunk(ch + 2);
    }
    cp_async_commit();
    mix<L::NT0, L::NT1>(acc, Ws + 1 * WSL, LDW, Xs, L::row(L::NT0, nh), m0, lane);
    mix<L::NT0 + L::NT1, L::NT1>(acc, Ws + K * WSL, LDW, Xs, L::row(L::NT0 + L::NT1, nh), m0,
                                 lane);
    if (L::NT3 && nh < L::T4) {  // slab 2 (avg4) or K + 1 (max4)
      const int slab = nh < L::T4 / 2 ? 2 : K + 1;
      mix<L::NT - L::NT3, L::NT3>(acc, Ws + slab * WSL, LDW, Xs, L::A4 + 8 * nh, m0, lane);
    }
  }

  // partial sums -> R[NR][LDR] (over the drained ring), then telescope
  cp_async_wait<0>();
  __syncthreads();
  float* R = shared_floats();
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < L::NT; ++j) {
    const int r = L::row(j, nh);
    if (r < 0) continue;
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
      float* o = R + (r + t2) * LDR + m0 + 16 * mt + g;
      o[0] = acc[j][mt][0];
      o[LDR] = acc[j][mt][1];
      o[8] = acc[j][mt][2];
      o[LDR + 8] = acc[j][mt][3];
    }
  }
  __syncthreads();
  T* yb = y + static_cast<size_t>(b) * H * W * Cout;
  for (int i = tid; i < L::P * NCOL; i += NTH) {
    const int p = i / NCOL, n = i % NCOL;
    const int gy = h0 + p / TW, gx = w0 + p % TW;
    if (gy < H && gx < W && c0 + n < Cout) {
      const int q2 = (p / TW / 2) * (TW / 2) + (p % TW) / 2;
      float t = R[(L::A2 + q2) * LDR + n] + R[(L::M2 + q2) * LDR + n];
      if (K >= 3) {
        const int q4 = (p / TW / 4) * (TW / 4) + (p % TW) / 4;
        t = t + (R[(L::A4 + q4) * LDR + n] + R[(L::A4 + L::N4 + q4) * LDR + n]);
      }
      const float v = (R[p * LDR + n] + t) + bias[c0 + n];
      yb[(static_cast<size_t>(gy) * W + gx) * Cout + c0 + n] = from_float<T>(v);
    }
  }
}

template <typename T, int K, class C>
int launch(const void* x, const void* w, const float* bias, void* y, int B, int H, int W,
           int Cin, int Cout, cudaStream_t stream) {
  using O = Ops<T>;
  using L = Rows<C, K>;
  constexpr size_t stage =
      (static_cast<size_t>(L::NR) * O::LDX + (2 * K - 1) * O::KC * (C::NCOL + O::PADW)) *
      sizeof(T);
  constexpr size_t partials = static_cast<size_t>(L::NR) * (C::NCOL + 4) * sizeof(float);
  static_assert(stage % 16 == 0, "16-byte aligned stages");
  constexpr size_t smem = kStages * stage > partials ? kStages * stage : partials;
  static_assert(smem <= kMaxSmem, "the ring fits in shared memory");
  auto kernel = hanc_mix_kernel<T, K, C>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = ceil_div(W, C::TW);
  // the column blocks of one pixel tile run side by side: x is read from
  // device memory once
  const dim3 grid(ceil_div(Cout, C::NCOL), ceil_div(H, C::TH) * tiles_w, B);
  const int vec_x = (Cin * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w = (Cout * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  kernel<<<grid, C::THREADS, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                              bias, static_cast<T*>(y), H, W, Cin, Cout,
                                              tiles_w, vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}

// tile 0 picks by the output width and type (from tools/hanc_mix_sweep.py
// on the H100); 1, 3, 4 and 5 name a tile
template <typename T>
int pick_tile(int Cout) {
  if (Cout <= 16) return 4;
  if (Cout <= 32) return 3;
  return sizeof(T) == 2 && Cout >= 256 ? 1 : 5;
}

template <typename T, int K>
int dispatch_tile(const void* x, const void* w, const float* bias, void* y, int B, int H, int W,
                  int Cin, int Cout, int tile, cudaStream_t s) {
  switch (tile == 0 ? pick_tile<T>(Cout) : tile) {
    case 1: return launch<T, K, Tile<8, 16, 128, 4, 2>>(x, w, bias, y, B, H, W, Cin, Cout, s);
    case 3: return launch<T, K, Tile<8, 16, 32, 2, 2>>(x, w, bias, y, B, H, W, Cin, Cout, s);
    case 4: return launch<T, K, Tile<8, 16, 16, 1, 4>>(x, w, bias, y, B, H, W, Cin, Cout, s);
    case 5: return launch<T, K, Tile<16, 16, 64, 2, 4>>(x, w, bias, y, B, H, W, Cin, Cout, s);
    default: return -3;
  }
}

template <typename T>
int dispatch_k(const void* x, const void* w, const float* bias, void* y, int B, int H, int W,
               int Cin, int Cout, int k, int tile, cudaStream_t s) {
  if (k == 2) return dispatch_tile<T, 2>(x, w, bias, y, B, H, W, Cin, Cout, tile, s);
  if (k == 3) return dispatch_tile<T, 3>(x, w, bias, y, B, H, W, Cin, Cout, tile, s);
  return -1;
}

}  // namespace
}  // namespace accunet

// x (B, H, W, C) and w (C, 2k-1, Cout) in the same type (dtype 0 fp32, 1
// bf16), bias fp32; tile 0 picks the tile by shape
extern "C" int accunet_hanc_mix(const void* x, const void* w, const void* bias, void* y,
                                int B, int H, int W, int C, int Cout, int k, int tile,
                                int dtype, void* stream) {
  using namespace accunet;
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_k<float>(x, w, bf, y, B, H, W, C, Cout, k, tile, s);
  if (dtype == kBFloat16) return dispatch_k<bf16>(x, w, bf, y, B, H, W, C, Cout, k, tile, s);
  return -2;
}
