// Whole HANCBlock inference body before the SE, BNs folded, NHWC:
//   xin = pre ? lrelu(x*gs + tb) : x                (chained SE prologue)
//   u = lrelu(xin@w1 + t1); d = lrelu(dw3x3(pad0(u)) + t2)
//   h = HANC pyramid + (2k-1) mixes (telescoped); z = (lrelu(h + th) + xin)*sres + tres
//   y = lrelu(z@w3 + t3), and fp32 per-tile channel sums of y
// Replaces the TPU kernel hanc_block_frame (accunet_tpu/ops/pallas/hanc_block.py:335),
// plain (_kernel/_kernel_one) and chained (_kernel_parts) forms.
//
// What bounds it on an H100 SXM, at cnv91 of ACC_UNet b8 224x224 (cin 64,
// E 192, cout 32, k 3; 28.9 GFLOP): the products. In fp32 they run as 3xTF32
// on the tensor cores, 3 x 28.9 GFLOP / 495 TFLOP/s = 0.175 ms; in bf16 as
// bf16 mma at 989 TFLOP/s, 0.029 ms, where the bytes (x once, y once) take
// about as long. The depthwise taps, the pools, the activations and the
// telescope (about 4% of the operations) stay on the CUDA cores.
//
// One CTA per (image, tile of TH x TW pixels: 8x16 or 16x16, `Tile`); its
// (TH+2) x (TW+2) halo of xin stays in shared memory for the whole block (the
// expand's input and the residual). The loop walks E in K-chunks of KC
// channels (16 fp32, 32 bf16), so the E-wide interior never reaches device
// memory; per chunk:
//  (a) the expand on the halo, a GEMM on the tensor cores through mma.sync
//      (M = the chunk's channels, N = halo pixels, K = cin), then t1, lrelu
//      and the zeroing of out-of-image halo pixels AFTER the activation (SAME
//      padding pads the activated map), into fp32 shared memory;
//  (b) on the CUDA cores, per channel and 4x4 (2x2, 1x1 for k = 2, 1) window
//      of pixels: the depthwise taps, t2, lrelu, and the window's avg/max
//      pools, written as the chunk's rows of the pyramid (Rows in mma.cuh);
//  (c) the 2k-1 mixes of the pyramid, accumulated in registers across all
//      chunks exactly as in hanc_mix.cu (`mix`; 3xTF32 with each chunk's sum
//      promoted in fp32, or bf16).
// The weight chunks (w1, wd, t1, t2 and the 2k-1 wh slabs) come by cp.async
// one chunk ahead, into two stages (the wh slabs into one stage where two do
// not fit: fp32 with cin > 64); three barriers a chunk. The epilogue stores
// the mix partials, telescopes the upsample-adds, applies th, lrelu, the
// residual and the 'norm' BN into z (fp32 in place, or bf16), projects z
// through w3 on the tensor cores (A fragments read from w3 in device memory),
// applies t3 and lrelu, writes y from the fragments and reduces the tile's
// channel sums in a fixed order (lanes, then warps). In bf16 the operands of
// every product are bf16 and the interior is rounded to bf16 where JAX's
// kernel rounds it: after the expand's activation, after the depthwise
// activation, the pools, after the hanc lrelu, z, and y.
#include "mma.cuh"

namespace accunet {
namespace {

// The shared-memory plan of a CTA, in bytes (mirrored by
// ops/kernels/hanc_block.py smem_bytes):
//   [0, xs)  the x halo, HPR rows of xld T (rows >= HP and channels >= cin zero)
//   loop:     Us (HPR x ULD fp32), the pyramid (NR x LDX T), two stages of
//             [w1 (cin_pad x W1LD T), wd (9 x KC T), t1, t2 (KC fp32)], nwh
//             stages of the wh slabs (NV x KC x LDW T)
//   epilogue: R (NR x LDR fp32), z (fp32: in R's pixel rows; bf16: P x zld),
//             the warps' channel sums (kWarps x cout_pad fp32)
template <typename T, int K, class C>
struct HbSmem {
  using O = Ops<T>;
  using L = Rows<C, K>;
  static constexpr int KC = O::KC, NV = 2 * K - 1, P = L::P, SZ = sizeof(T);
  static constexpr int HTW = C::TW + 2, HP = (C::TH + 2) * HTW, HPR = (HP + 7) / 8 * 8;
  static constexpr int ULD = KC + 4, W1LD = KC + O::PADW, LDW = C::NCOL + O::PADW;
  static constexpr int LDR = C::NCOL + 4;
  int cin_pad, xld, zld, cout_pad, nwh;
  int us, pyr, wa, wa_bytes, wd_off, t_off, wh, wh_bytes, r, z, sums, bytes;  // bytes

  __host__ __device__ HbSmem(int cin, int cout) {
    cin_pad = (cin + O::KSTEP - 1) / O::KSTEP * O::KSTEP;
    xld = conflict_free_ld(cin_pad, SZ == 4 ? 32 : 16);
    cout_pad = (cout + 15) / 16 * 16;
    const int loop = align16(HPR * xld * SZ);
    us = loop;
    pyr = us + HPR * ULD * 4;
    wa = align16(pyr + L::NR * O::LDX * SZ);
    wd_off = cin_pad * W1LD * SZ;
    t_off = wd_off + 9 * KC * SZ;
    wa_bytes = align16(t_off + 2 * KC * 4);
    wh = wa + 2 * wa_bytes;
    wh_bytes = NV * KC * LDW * SZ;
    r = loop;
    const int r_end = r + L::NR * LDR * 4;
    zld = SZ == 4 ? LDR : conflict_free_ld(cin_pad, 16);
    z = SZ == 4 ? r : r_end;
    sums = align16(SZ == 4 ? r_end : z + P * zld * SZ);
    const int epilogue = sums + kWarps * cout_pad * 4;
    const int limit = static_cast<int>(kMaxSmem);
    nwh = wh + 2 * wh_bytes <= limit && epilogue <= limit ? 2 : 1;
    const int end = wh + nwh * wh_bytes;
    bytes = end > epilogue ? end : epilogue;
  }
};

// The projection's A fragment (m = output channel, k = z channel) straight
// from w3 (nf, cout) in device memory, zero outside it; the k slots follow
// Ops<T>::load_a / load_b
__device__ __forceinline__ void load_a_w3(Ops<float>::A& a, const float* w3, int nf, int cout,
                                          int m, int kk, int lane) {
  const int g = lane >> 2, k = kk + 2 * (lane & 3);
  auto at = [&](int kr, int mr) {
    return kr < nf && mr < cout ? __ldg(w3 + static_cast<size_t>(kr) * cout + mr) : 0.f;
  };
  split_tf32(at(k, m + g), a.hi[0], a.lo[0]);
  split_tf32(at(k, m + g + 8), a.hi[1], a.lo[1]);
  split_tf32(at(k + 1, m + g), a.hi[2], a.lo[2]);
  split_tf32(at(k + 1, m + g + 8), a.hi[3], a.lo[3]);
}
__device__ __forceinline__ void load_a_w3(Ops<bf16>::A& a, const bf16* w3, int nf, int cout,
                                          int m, int kk, int lane) {
  const int g = lane >> 2, k = kk + 2 * (lane & 3);
  auto at = [&](int kr, int mr) {
    return kr < nf && mr < cout ? w3[static_cast<size_t>(kr) * cout + mr] : from_float<bf16>(0.f);
  };
  auto pack = [](bf16 lo, bf16 hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
  };
  a.r[0] = pack(at(k, m + g), at(k + 1, m + g));
  a.r[1] = pack(at(k, m + g + 8), at(k + 1, m + g + 8));
  a.r[2] = pack(at(k + 8, m + g), at(k + 9, m + g));
  a.r[3] = pack(at(k + 8, m + g + 8), at(k + 9, m + g + 8));
}

template <typename T, int K, class C>
__global__ void __launch_bounds__(C::THREADS, 1)
hanc_block_kernel(const T* __restrict__ x, const float* __restrict__ pre,
                  const T* __restrict__ w1, const float* __restrict__ t1,
                  const T* __restrict__ wd, const float* __restrict__ t2,
                  const T* __restrict__ wh, const float* __restrict__ th,
                  const float* __restrict__ sres, const float* __restrict__ tres,
                  const T* __restrict__ w3, const float* __restrict__ t3, T* __restrict__ y,
                  float* __restrict__ sums, int H, int W, int cin, int E, int cout, int tiles_w,
                  int n_tiles, int vec_x, int vec_w, int vec_h) {
  using O = Ops<T>;
  using L = Rows<C, K>;
  using S = HbSmem<T, K, C>;
  static_assert(C::THREADS == kThreads, "8 warps");
  constexpr int KC = O::KC, TH = C::TH, TW = C::TW, HTW = S::HTW, P = L::P, NCOL = C::NCOL;
  constexpr int WSL = KC * S::LDW, LDX = O::LDX;
  const S sm(cin, cout);
  const int nf = cin;
  char* base = reinterpret_cast<char*>(shared_floats());
  T* Xs = reinterpret_cast<T*>(base);
  float* Us = reinterpret_cast<float*>(base + sm.us);
  T* Pyr = reinterpret_cast<T*>(base + sm.pyr);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t2x = 2 * (lane & 3);
  const int m0 = (warp % C::WM) * C::MT * 16, nh = warp / C::WM;
  const int b = blockIdx.y, tile = blockIdx.x;
  const int h0 = (tile / tiles_w) * TH, w0 = (tile % tiles_w) * TW;
  const T* xb = x + static_cast<size_t>(b) * H * W * cin;
  const int nchunks = (E + KC - 1) / KC;

  auto halo_in = [&](int hp) {  // halo pixel hp lies in the image
    const int hy = hp / HTW, gy = h0 - 1 + hy, gx = w0 - 1 + hp - hy * HTW;
    return hp < S::HP && gy >= 0 && gy < H && gx >= 0 && gx < W;
  };
  // the weights of chunk ch: w1, wd, t1, t2 into stage ch % 2, the wh slabs
  // into stage ch % nwh
  auto load_wa = [&](int ch) {
    char* st = base + sm.wa + (ch % 2) * sm.wa_bytes;
    const int e0 = ch * KC, ok = min(KC, E - e0);
    copy_block<T, KC, kThreads>(reinterpret_cast<T*>(st), S::W1LD, w1 + e0, E, sm.cin_pad, cin, ok,
                                vec_w, tid);
    copy_block<T, KC, kThreads>(reinterpret_cast<T*>(st + sm.wd_off), KC, wd + e0, E, 9, 9, ok,
                                vec_w, tid);
    float* ts = reinterpret_cast<float*>(st + sm.t_off);
    copy_block<float, KC, kThreads>(ts, KC, t1 + e0, 0, 1, 1, ok, vec_w, tid);
    copy_block<float, KC, kThreads>(ts + KC, KC, t2 + e0, 0, 1, 1, ok, vec_w, tid);
  };
  auto load_wh = [&](int ch) {
    T* st = reinterpret_cast<T*>(base + sm.wh + (ch % sm.nwh) * sm.wh_bytes);
    const int e0 = ch * KC, ok = min(KC, E - e0);
#pragma unroll
    for (int v = 0; v < 2 * K - 1; ++v)
      copy_block<T, NCOL, kThreads>(st + v * WSL, S::LDW,
                                    wh + (static_cast<size_t>(v) * E + e0) * nf, nf, KC, ok, nf,
                                    vec_h, tid);
  };

  // the x halo (zero outside the image and for channels >= cin) with chunk
  // 0's weights, then the chained SE prologue in place
  if (vec_x) {
    constexpr int V = 16 / sizeof(T);
    const int segs = sm.cin_pad / V;
    for (int i = tid; i < S::HPR * segs; i += kThreads) {
      const int hp = i / segs, c = (i - hp * segs) * V;
      const int hy = hp / HTW, gy = h0 - 1 + hy, gx = w0 - 1 + hp - hy * HTW;
      const bool ok = halo_in(hp) && c < cin;
      cp_async16(Xs + hp * sm.xld + c, ok ? xb + (static_cast<size_t>(gy) * W + gx) * cin + c : x,
                 ok);
    }
  } else {
    for (int i = tid; i < S::HPR * sm.cin_pad; i += kThreads) {
      const int hp = i / sm.cin_pad, c = i - hp * sm.cin_pad;
      const int hy = hp / HTW, gy = h0 - 1 + hy, gx = w0 - 1 + hp - hy * HTW;
      Xs[hp * sm.xld + c] = halo_in(hp) && c < cin
                                ? xb[(static_cast<size_t>(gy) * W + gx) * cin + c]
                                : from_float<T>(0.f);
    }
  }
  load_wa(0);
  load_wh(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (pre != nullptr) {
    // out-of-image pixels change too; their expand output is zeroed anyway
    const float* gs = pre + static_cast<size_t>(2 * b) * cin;
    for (int i = tid; i < S::HPR * cin; i += kThreads) {
      const int hp = i / cin, c = i - hp * cin;
      T* v = Xs + hp * sm.xld + c;
      *v = from_float<T>(lrelu(to_float(*v) * gs[c] + gs[cin + c]));
    }
    __syncthreads();
  }

  float acc[L::NT][C::MT][4] = {};
  for (int ch = 0; ch < nchunks; ++ch) {
    const char* wa = base + sm.wa + (ch % 2) * sm.wa_bytes;
    const T* w1s = reinterpret_cast<const T*>(wa);
    const T* wds = reinterpret_cast<const T*>(wa + sm.wd_off);
    const float* ts = reinterpret_cast<const float*>(wa + sm.t_off);

    // (a) the expand on the halo (expand_halo in mma.cuh), then t1, lrelu
    // and the zeroing of out-of-image halo pixels
    expand_halo<T, S::HPR / 8, KC / 16, false>(
        w1s, S::W1LD, Xs, sm.xld, sm.cin_pad, warp, lane, [&](int hp, int e, float v) {
          const float u = lrelu(v + ts[e]);
          Us[hp * S::ULD + e] = halo_in(hp) ? round_to<T>(u) : 0.f;
        });
    __syncthreads();  // B1: Us is complete; every thread is done with chunk ch-1's stage
    if (ch + 1 < nchunks) {
      load_wa(ch + 1);
      if (sm.nwh == 2) load_wh(ch + 1);
    }
    cp_async_commit();

    // (b) depthwise 3x3 + t2 + lrelu and the pools, per channel and window
    {
      constexpr int WS = 1 << (K - 1), NWIN = P / (WS * WS), WPR = TW / WS;
      for (int i = tid; i < NWIN * KC; i += kThreads) {
        const int e = i % KC, q = i / KC, qy = q / WPR, qx = q - qy * WPR;
        float wk[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) wk[t] = to_float(wds[t * KC + e]);
        const float bias = ts[KC + e];
        // the window's u rows three at a time (ur[r % 3] holds row r), its
        // d rows one at a time, its 2x2 pools as each pair of rows is done
        const float* ub = Us + ((qy * WS) * HTW + qx * WS) * S::ULD + e;
        float ur[3][WS + 2], dprev[WS], a2[K >= 2 ? WS / 2 : 1][K >= 2 ? WS / 2 : 1],
            m2[K >= 2 ? WS / 2 : 1][K >= 2 ? WS / 2 : 1];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < WS + 2; ++c) ur[r][c] = ub[(r * HTW + c) * S::ULD];
#pragma unroll
        for (int py = 0; py < WS; ++py) {
#pragma unroll
          for (int c = 0; c < WS + 2; ++c) ur[(py + 2) % 3][c] = ub[((py + 2) * HTW + c) * S::ULD];
          float dv[WS];
#pragma unroll
          for (int px = 0; px < WS; ++px) {
            float sum = ur[py % 3][px] * wk[0];
#pragma unroll
            for (int t = 1; t < 9; ++t) sum = fmaf(ur[(py + t / 3) % 3][px + t % 3], wk[t], sum);
            dv[px] = round_to<T>(lrelu(sum + bias));
            Pyr[((qy * WS + py) * TW + qx * WS + px) * LDX + e] = from_float<T>(dv[px]);
          }
          if constexpr (K >= 2) {
            // 2x2 pools in order (0,0),(0,1),(1,0),(1,1)
            if (py % 2 == 1) {
#pragma unroll
              for (int sx = 0; sx < WS / 2; ++sx) {
                const float v0 = dprev[2 * sx], v1 = dprev[2 * sx + 1];
                const float v2 = dv[2 * sx], v3 = dv[2 * sx + 1];
                const int sy = py / 2, q2 = (qy * WS / 2 + sy) * (TW / 2) + qx * WS / 2 + sx;
                a2[sy][sx] = round_to<T>(((v0 + v1) + (v2 + v3)) * 0.25f);
                m2[sy][sx] = fmaxf(fmaxf(v0, v1), fmaxf(v2, v3));
                Pyr[(L::A2 + q2) * LDX + e] = from_float<T>(a2[sy][sx]);
                Pyr[(L::M2 + q2) * LDX + e] = from_float<T>(m2[sy][sx]);
              }
            }
#pragma unroll
            for (int px = 0; px < WS; ++px) dprev[px] = dv[px];
          }
        }
        if constexpr (K >= 3) {
          // the 4x4 pool from the four rounded 2x2 pools, as the TPU kernels
          // pool the pooled maps
          const int q4 = qy * (TW / 4) + qx;
          Pyr[(L::A4 + q4) * LDX + e] =
              from_float<T>(((a2[0][0] + a2[0][1]) + (a2[1][0] + a2[1][1])) * 0.25f);
          Pyr[(L::A4 + L::N4 + q4) * LDX + e] =
              from_float<T>(fmaxf(fmaxf(m2[0][0], m2[0][1]), fmaxf(m2[1][0], m2[1][1])));
        }
      }
    }
    if (sm.nwh == 1) cp_async_wait<1>();  // chunk ch's wh slabs (issued after B3 of ch-1)
    __syncthreads();  // B2: the pyramid of chunk ch is complete

    // (c) the mixes, as hanc_mix
    {
      const T* Ws = reinterpret_cast<const T*>(base + sm.wh + (ch % sm.nwh) * sm.wh_bytes);
      mix<0, L::NT0>(acc, Ws, S::LDW, Pyr, L::row(0, nh), m0, lane);
      if constexpr (K >= 2) {
        mix<L::NT0, L::NT1>(acc, Ws + 1 * WSL, S::LDW, Pyr, L::row(L::NT0, nh), m0, lane);
        mix<L::NT0 + L::NT1, L::NT1>(acc, Ws + K * WSL, S::LDW, Pyr,
                                     L::row(L::NT0 + L::NT1, nh), m0, lane);
      }
      if constexpr (L::NT3 > 0) {
        if (nh < L::T4) {  // slab 2 (avg4) or K + 1 (max4)
          const int slab = nh < L::T4 / 2 ? 2 : K + 1;
          mix<L::NT - L::NT3, L::NT3>(acc, Ws + slab * WSL, S::LDW, Pyr, L::A4 + 8 * nh, m0,
                                      lane);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // B3: chunk ch+1's weights have landed; the pyramid is free
    if (sm.nwh == 1 && ch + 1 < nchunks) {
      load_wh(ch + 1);
      cp_async_commit();
    }
  }

  // the mix partials -> R[NR][LDR] (over the drained loop region)
  float* R = reinterpret_cast<float*>(base + sm.r);
#pragma unroll
  for (int j = 0; j < L::NT; ++j) {
    const int r = L::row(j, nh);
    if (r < 0) continue;
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
      float* o = R + (r + t2x) * S::LDR + m0 + 16 * mt + g;
      o[0] = acc[j][mt][0];
      o[S::LDR] = acc[j][mt][1];
      o[8] = acc[j][mt][2];
      o[S::LDR + 8] = acc[j][mt][3];
    }
  }
  __syncthreads();

  // z = (lrelu(telescope + th) + xin) * sres + tres; (p, n) reads its own
  // R row and the pooled rows (>= P), so fp32 z can take its R element's place
  T* Zs = reinterpret_cast<T*>(base + sm.z);
  for (int i = tid; i < P * sm.cin_pad; i += kThreads) {
    const int p = i / sm.cin_pad, n = i - p * sm.cin_pad;
    float z = 0.f;
    if (n < nf) {
      float h = R[p * S::LDR + n];
      if constexpr (K >= 2) {
        const int q2 = (p / TW / 2) * (TW / 2) + (p % TW) / 2;
        float t = R[(L::A2 + q2) * S::LDR + n] + R[(L::M2 + q2) * S::LDR + n];
        if constexpr (K >= 3) {
          const int q4 = (p / TW / 4) * (TW / 4) + (p % TW) / 4;
          t = t + (R[(L::A4 + q4) * S::LDR + n] + R[(L::A4 + L::N4 + q4) * S::LDR + n]);
        }
        h = h + t;
      }
      const float r = round_to<T>(lrelu(h + th[n]));
      const float xin = to_float(Xs[((p / TW + 1) * HTW + p % TW + 1) * sm.xld + n]);
      z = (r + xin) * sres[n] + tres[n];
    }
    Zs[p * sm.zld + n] = from_float<T>(z);
  }
  __syncthreads();

  // y^T = w3^T z^T on the tensor cores: warps over pixel n-tiles, every
  // output m-tile in turn; y from the fragments; each lane sums its pixels,
  // then the 4 lanes of a channel, then (below) the warps, in fixed orders
  constexpr int JP = P / 8 / kWarps;
  static_assert(P % (8 * kWarps) == 0, "whole pixel n-tiles per warp");
  float* red = reinterpret_cast<float*>(base + sm.sums);  // [kWarps][cout_pad]
  T* yb = y + static_cast<size_t>(b) * H * W * cout;
  for (int mt = 0; mt < sm.cout_pad / 16; ++mt) {
    float ap[JP][4] = {};
    for (int kk = 0; kk < sm.cin_pad; kk += O::KSTEP) {
      typename O::A a;
      typename O::B bb[JP];
      load_a_w3(a, w3, nf, cout, 16 * mt, kk, lane);
#pragma unroll
      for (int jj = 0; jj < JP; ++jj)
        O::load_b(bb[jj], Zs, sm.zld, 8 * (warp + kWarps * jj), kk, lane);
#pragma unroll
      for (int p = 0; p < O::kPasses; ++p)
#pragma unroll
        for (int jj = 0; jj < JP; ++jj) O::pass(p, false, ap[jj], a, bb[jj]);
    }
    float s[2] = {0.f, 0.f};  // channels 16mt + g and + 8
#pragma unroll
    for (int jj = 0; jj < JP; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int co = 16 * mt + g + (c >> 1) * 8, p = 8 * (warp + kWarps * jj) + t2x + (c & 1);
        const int gy = h0 + p / TW, gx = w0 + p % TW;
        if (co < cout && gy < H && gx < W) {
          const T o = from_float<T>(lrelu(ap[jj][c] + t3[co]));
          yb[(static_cast<size_t>(gy) * W + gx) * cout + co] = o;
          s[c >> 1] += to_float(o);
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
    }
    if ((lane & 3) == 0) {
      red[warp * sm.cout_pad + 16 * mt + g] = s[0];
      red[warp * sm.cout_pad + 16 * mt + g + 8] = s[1];
    }
  }
  __syncthreads();
  for (int co = tid; co < cout; co += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * sm.cout_pad + co];
    sums[(static_cast<size_t>(b) * n_tiles + tile) * cout + co] = s;
  }
}

struct Args {
  const void* x;
  const float* pre;
  const void *w1, *wd, *wh, *w3;
  const float *t1, *t2, *th, *sres, *tres, *t3;
  void* y;
  float* sums;
  int B, H, W, cin, E, cout;
};

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int K, class C>
int launch(const Args& a, cudaStream_t stream) {
  using S = HbSmem<T, K, C>;
  if (a.cin > C::NCOL) return -3;
  const S sm(a.cin, a.cout);
  if (sm.bytes > static_cast<int>(kMaxSmem)) return -4;
  auto kernel = hanc_block_kernel<T, K, C>;
  cudaError_t err = allow_smem(kernel, sm.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int V = 16 / sizeof(T);
  const int vec_x = a.cin % V == 0 && aligned16(a.x);
  // 16-byte copies: rows of whole 16 bytes (the fp32 t1, t2 too: V >= 4)
  const int vec_w = a.E % V == 0 && aligned16(a.w1) && aligned16(a.wd) && aligned16(a.t1) &&
                    aligned16(a.t2);
  const int vec_h = a.cin % V == 0 && aligned16(a.wh);
  const int tiles_w = ceil_div(a.W, C::TW), n_tiles = ceil_div(a.H, C::TH) * tiles_w;
  kernel<<<dim3(n_tiles, a.B), C::THREADS, sm.bytes, stream>>>(
      static_cast<const T*>(a.x), a.pre, static_cast<const T*>(a.w1), a.t1,
      static_cast<const T*>(a.wd), a.t2, static_cast<const T*>(a.wh), a.th, a.sres, a.tres,
      static_cast<const T*>(a.w3), a.t3, static_cast<T*>(a.y), a.sums, a.H, a.W, a.cin, a.E,
      a.cout, tiles_w, n_tiles, vec_x, vec_w, vec_h);
  return static_cast<int>(cudaGetLastError());
}

// the kernel's tiles (ops/kernels/hanc_block.py TILES): pixels x mix columns
template <typename T, int K>
int dispatch_tile(const Args& a, int tile, cudaStream_t s) {
  switch (tile) {
    case 1: return launch<T, K, Tile<8, 16, 128, 4, 2>>(a, s);
    case 2: return launch<T, K, Tile<16, 16, 64, 2, 4>>(a, s);
    case 3: return launch<T, K, Tile<16, 16, 32, 1, 8>>(a, s);
    default: return -3;
  }
}

template <typename T>
int dispatch_k(const Args& a, int k, int tile, cudaStream_t s) {
  if (k == 1) return dispatch_tile<T, 1>(a, tile, s);
  if (k == 2) return dispatch_tile<T, 2>(a, tile, s);
  if (k == 3) return dispatch_tile<T, 3>(a, tile, s);
  return -1;
}

}  // namespace
}  // namespace accunet

// x (B, H, W, cin) and w1 (cin, E), wd (9, E), wh (2k-1, E, nf), w3 (nf,
// cout) in the same type (dtype 0 fp32, 1 bf16); pre (B, 2, cin), t1, t2
// (E), th, sres, tres (nf), t3 (cout) fp32; y (B, H, W, cout), sums (B,
// tiles, cout) fp32. `tile` names the kernel's tile (1-3).
extern "C" int accunet_hanc_block(const void* x, const void* pre, const void* w1,
                                  const void* t1, const void* wd, const void* t2,
                                  const void* wh, const void* th, const void* sres,
                                  const void* tres, const void* w3, const void* t3, void* y,
                                  void* sums, int B, int H, int W, int cin, int E, int nf,
                                  int cout, int k, int tile, int dtype, void* stream) {
  using namespace accunet;
  if (nf != cin) return -4;  // the residual needs nf == cin
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const Args a{x,     f(pre), w1,      wd,      wh,    w3,
               f(t1), f(t2),  f(th),   f(sres), f(tres), f(t3),
               y,     static_cast<float*>(sums),
               B,     H,      W,       cin,     E,     cout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_k<float>(a, k, tile, s);
  if (dtype == kBFloat16) return dispatch_k<bf16>(a, k, tile, s);
  return -2;
}
