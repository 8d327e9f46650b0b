// Hybrid HANCBlock front half, NHWC:
//   u = lrelu((x@w1)*s1 + t1)            expand, BN1 (the conv bias folded: t1 += b1*s1)
//   y = lrelu(dw3x3(pad0(u))*s2 + t2)    SAME depthwise, BN2 (t2 += bd*s2)
// Replaces the TPU kernel expand_dw_nhwc (accunet_tpu/ops/pallas/expand_dw.py:77,
// body _kernel :29), which ran a (batch, row block) grid with two-block halo
// staging in VMEM.
//
// What bounds it on an H100 SXM, at cnv72 of ACC_UNet_W b2 512x512 (cin 128,
// E 4352, 32,768 pixels): in fp32 the expand's products as 3xTF32 on the
// tensor cores (3 x 36.5 GFLOP / 495 TFLOP/s = 0.22 ms) and the store of the
// E-wide y (570 MB, 0.17 ms at 3.35 TB/s); in bf16 the bytes (y 285 MB).
//
// This is hanc_block.cu's front half, phases (a) and (b), with y as the
// output. A CTA owns one tile of 8x16 pixels of one image
// and a group of consecutive chunks of E, 64 channels in fp32, 32 in bf16 (grid.y: the groups
// spread the work over the SMs, about eight waves); the tile's
// (TH+2) x 18 halo of x (all cin channels) comes in once by cp.async and
// stays in shared memory while the CTA walks its chunks, so x is read once
// per group, not once per chunk. Where the whole halo does not fit (cin
// above about 128 in fp32, 256 in bf16: the wider unfused blocks of
// hybrid_e_min), a second plan stages it 64 channels at a time with the
// matching rows of w1, for every chunk, without overlap. Per chunk:
//  (a) the expand on the halo on the tensor cores (expand_halo in mma.cuh:
//      M = the chunk's channels, N = halo pixels, K = cin; 3xTF32 with each
//      16-deep K-chunk's sum added in fp32, or bf16), then BN1, lrelu and
//      the zeroing of out-of-image halo pixels AFTER the activation (SAME
//      padding pads the activated map), into fp32 shared memory;
//  (b) on the CUDA cores, the nine taps (row-major order), BN2 and lrelu:
//      each thread 4 channels of a run of pixels along a tile row, a 3x3
//      window sliding in registers, y stored as 4-channel vectors (16 bytes
//      in fp32), consecutive threads on a pixel's chunk of channels.
// The next chunk's w1, wd and BN columns come by cp.async during (b); two
// barriers a chunk. In bf16 w1 and wd are bf16 (JAX's kernel casts them),
// the expand's product is rounded to bf16 before BN1, u is rounded to bf16,
// and y = bf16(lrelu(acc*s2 + t2)); expand_dw_plain rounds at the same
// points and does the BN arithmetic as separate fp32 operations, as the
// kernel does (__fmul_rn, __fadd_rn).
#include <algorithm>

#include "mma.cuh"

namespace accunet {
namespace {

// A tile of TH x TW pixels and chunks of EC channels (64 in fp32, where the
// 3xTF32 expand wants the most products per loaded fragment; 32 in bf16,
// where two CTAs fit an SM); the x halo resident
// (all cin channels, XRES) or staged KX channels at a time for each chunk
// (where the whole halo does not fit); the taps' threads: CG a pixel (4
// channels each), RUNS runs of RL pixels, RPR runs a tile row
template <typename T, bool XRES_>
struct EdPlan {
  static constexpr int TH = 8, TW = 16, EC = sizeof(T) == 4 ? 64 : 32, KX = 64;
  static constexpr bool XRES = XRES_;
  static constexpr int HTW = TW + 2, HP = (TH + 2) * HTW, HPR = (HP + 7) / 8 * 8;
  static constexpr int ULD = EC + 4, W1LD = EC + Ops<T>::PADW;
  static constexpr int CG = EC / 4, RUNS = kThreads / CG, RPR = RUNS / TH, RL = TW / RPR;
  // two CTAs an SM where the shared memory allows it (bf16, resident)
  static constexpr int MINB = sizeof(T) == 2 && XRES ? 2 : 1;
  static_assert(RUNS % TH == 0 && TW % RPR == 0, "whole runs per tile row");
};

// The shared-memory plan, in bytes (mirrored by ops/kernels/expand_dw.py
// smem_bytes): the x halo (HPR rows of kdim channels, stride xld; channels
// >= cin zero), the activated halo Us (HPR x ULD fp32), and two stages
// (resident x) or one (staged x) of [w1 (kdim x W1LD T), wd (9 x EC T), s1,
// t1, s2, t2 (4 x EC fp32)]. cin_pad: cin rounded up to 16; kdim: the
// channels staged at a time (cin_pad, or KX).
struct EdSmem {
  int cin_pad, kdim, xld, us, wa, wa_bytes, wd_off, p_off, bytes;
  __host__ __device__ EdSmem(int cin, int sz, int hpr, int uld, int w1ld, int ec, bool xres,
                             int kx) {
    cin_pad = (cin + 15) / 16 * 16;
    kdim = xres ? cin_pad : kx;
    xld = conflict_free_ld(kdim, sz == 4 ? 32 : 16);
    us = align16(hpr * xld * sz);
    wa = align16(us + hpr * uld * 4);
    wd_off = kdim * w1ld * sz;
    p_off = align16(wd_off + 9 * ec * sz);
    wa_bytes = align16(p_off + 4 * ec * 4);
    bytes = wa + (xres ? 2 : 1) * wa_bytes;
  }
};

template <typename T, class P>
__global__ void __launch_bounds__(kThreads, P::MINB)
expand_dw_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ wd,
                 const float* __restrict__ affe, T* __restrict__ y, int H, int W, int cin,
                 int E, int tiles_w, int n_tiles, int cpg, int vec_x, int vec_w, int vec_y) {
  using O = Ops<T>;
  constexpr int TH = P::TH, TW = P::TW, HTW = P::HTW, EC = P::EC, ULD = P::ULD;
  constexpr int V = 16 / sizeof(T);
  const EdSmem sm(cin, sizeof(T), P::HPR, ULD, P::W1LD, EC, P::XRES, P::KX);
  char* base = reinterpret_cast<char*>(shared_floats());
  T* Xs = reinterpret_cast<T*>(base);
  float* Us = reinterpret_cast<float*>(base + sm.us);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / n_tiles, tile = blockIdx.x - b * n_tiles;
  const int h0 = (tile / tiles_w) * TH, w0 = (tile % tiles_w) * TW;
  const int nch = (E + EC - 1) / EC, ch0 = blockIdx.y * cpg, ch1 = min(nch, ch0 + cpg);
  const T* xb = x + static_cast<size_t>(b) * H * W * cin;

  auto halo_in = [&](int hp) {  // halo pixel hp lies in the image
    const int hy = hp / HTW, gy = h0 - 1 + hy, gx = w0 - 1 + hp - hy * HTW;
    return hp < P::HP && gy >= 0 && gy < H && gx >= 0 && gx < W;
  };
  auto pixel = [&](int hp) {  // halo pixel hp's offset in the image (when inside)
    const int hy = hp / HTW, gy = h0 - 1 + hy, gx = w0 - 1 + hp - hy * HTW;
    return (static_cast<size_t>(gy) * W + gx) * cin;
  };
  // channels k0 .. k0 + kdim of the x halo (zero outside the image and for
  // channels >= cin)
  auto load_x = [&](int k0) {
    if (vec_x) {
      const int segs = sm.kdim / V;
      for (int i = tid; i < P::HPR * segs; i += kThreads) {
        const int hp = i / segs, c = (i - hp * segs) * V;
        const bool ok = halo_in(hp) && k0 + c < cin;
        cp_async16(Xs + hp * sm.xld + c, ok ? xb + pixel(hp) + k0 + c : x, ok);
      }
    } else {
      for (int i = tid; i < P::HPR * sm.kdim; i += kThreads) {
        const int hp = i / sm.kdim, c = i - hp * sm.kdim;
        Xs[hp * sm.xld + c] =
            halo_in(hp) && k0 + c < cin ? xb[pixel(hp) + k0 + c] : from_float<T>(0.f);
      }
    }
  };
  auto stage = [&](int st) { return base + sm.wa + st * sm.wa_bytes; };
  // rows k0 .. k0 + kdim of chunk ch's w1 columns into stage st
  auto load_w1 = [&](int ch, int k0, int st) {
    const int e0 = ch * EC;
    copy_block<T, EC, kThreads>(reinterpret_cast<T*>(stage(st)), P::W1LD,
                                w1 + static_cast<size_t>(k0) * E + e0, E, sm.kdim,
                                min(sm.kdim, cin - k0), min(EC, E - e0), vec_w, tid);
  };
  // chunk ch's wd columns and s1, t1, s2, t2 into stage st
  auto load_params = [&](int ch, int st) {
    const int e0 = ch * EC, ok = min(EC, E - e0);
    copy_block<T, EC, kThreads>(reinterpret_cast<T*>(stage(st) + sm.wd_off), EC, wd + e0, E, 9,
                                9, ok, vec_w, tid);
    copy_block<float, EC, kThreads>(reinterpret_cast<float*>(stage(st) + sm.p_off), EC,
                                    affe + e0, E, 4, 4, ok, vec_w, tid);
  };

  if constexpr (P::XRES) {  // the whole halo with the first chunk's weights
    load_x(0);
    load_w1(ch0, 0, 0);
    load_params(ch0, 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // the taps' thread: channels 4 * cg .. +3 of a run of RL pixels from
  // column cx of tile row r
  const int cg = tid % P::CG, run = tid / P::CG;
  const int r = run / P::RPR, cx = (run % P::RPR) * P::RL, ec = 4 * cg;
  const int gy = h0 + r;
  T* yrow = y + (static_cast<size_t>(b) * H + gy) * W * E;

  for (int ch = ch0; ch < ch1; ++ch) {
    const int st = P::XRES ? (ch - ch0) & 1 : 0;
    const T* w1s = reinterpret_cast<const T*>(stage(st));
    const T* wds = reinterpret_cast<const T*>(stage(st) + sm.wd_off);
    const float* ps = reinterpret_cast<const float*>(stage(st) + sm.p_off);

    // (a) u = lrelu(x@w1 * s1 + t1) on the halo, 0 outside the image
    ExpandAcc<P::HPR / 8, EC / 16> ae = {};
    if constexpr (P::XRES) {
      expand_acc<T, O::kPromote>(ae, w1s, P::W1LD, Xs, sm.xld, sm.cin_pad, warp, lane);
    } else {
      for (int k0 = 0; k0 < sm.cin_pad; k0 += sm.kdim) {
        __syncthreads();  // every thread is done with the staged block and the chunk's taps
        load_x(k0);
        load_w1(ch, k0, 0);
        if (k0 == 0) load_params(ch, 0);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        expand_acc<T, O::kPromote>(ae, w1s, P::W1LD, Xs, sm.xld, min(sm.kdim, sm.cin_pad - k0),
                                   warp, lane);
      }
    }
    expand_store(ae, warp, lane, [&](int hp, int e, float v) {
      float u = 0.f;
      if (halo_in(hp))
        u = round_to<T>(lrelu(__fadd_rn(__fmul_rn(round_to<T>(v), ps[e]), ps[EC + e])));
      Us[hp * ULD + e] = u;
    });
    __syncthreads();  // B1: Us is complete; every thread is done with chunk ch-1's stage
    if constexpr (P::XRES) {
      if (ch + 1 < ch1) {
        load_w1(ch + 1, 0, st ^ 1);
        load_params(ch + 1, st ^ 1);
      }
      cp_async_commit();
    }

    // (b) the taps, BN2, lrelu; y from the registers
    {
      float wk[9][4], s2[4], t2[4];
#pragma unroll
      for (int t = 0; t < 9; ++t) ldv<4>(wds + t * EC + ec, wk[t]);
      ldv<4>(ps + 2 * EC + ec, s2);
      ldv<4>(ps + 3 * EC + ec, t2);
      const int e = ch * EC + ec;
      // halo column cx + k of halo rows r .. r + 2 sits in win[.][k % 3]
      const float* ub = Us + (r * HTW + cx) * ULD + ec;
      float win[3][3][4];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int k = 0; k < 2; ++k) ldv<4>(ub + (dy * HTW + k) * ULD, win[dy][k]);
#pragma unroll
      for (int px = 0; px < P::RL; ++px) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) ldv<4>(ub + (dy * HTW + px + 2) * ULD, win[dy][(px + 2) % 3]);
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = win[0][px % 3][j] * wk[0][j];
#pragma unroll
          for (int t = 1; t < 9; ++t) s = fmaf(win[t / 3][(px + t % 3) % 3][j], wk[t][j], s);
          o[j] = round_to<T>(lrelu(__fadd_rn(__fmul_rn(s, s2[j]), t2[j])));
        }
        const int gx = w0 + cx + px;
        if (gy < H && gx < W) {
          T* dst = yrow + static_cast<size_t>(gx) * E + e;
          if (vec_y && e + 4 <= E) {
            stv<4>(dst, o);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (e + j < E) dst[j] = from_float<T>(o[j]);
          }
        }
      }
    }
    if constexpr (P::XRES) {
      cp_async_wait<0>();
      __syncthreads();  // B2: chunk ch+1's weights have landed; Us is free
    }
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, class P>
int launch(const void* x, const void* w1, const void* wd, const float* affe, void* y, int B,
           int H, int W, int cin, int E, cudaStream_t stream) {
  const EdSmem sm(cin, sizeof(T), P::HPR, P::ULD, P::W1LD, P::EC, P::XRES, P::KX);
  if (sm.bytes > static_cast<int>(kMaxSmem)) return -4;
  auto kernel = expand_dw_kernel<T, P>;
  cudaError_t err = allow_smem(kernel, sm.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // about eight waves of CTAs over the SMs (cached per size)
  static int dev_c = -1, bytes_c = -1, ctas_c = 0;
  int dev;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if (dev != dev_c || sm.bytes != bytes_c) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                             sm.bytes)) != cudaSuccess)
      return static_cast<int>(err);
    if (per_sm < 1) return -4;
    dev_c = dev, bytes_c = sm.bytes, ctas_c = sms * per_sm;
  }
  const int tiles_w = ceil_div(W, P::TW), n_tiles = ceil_div(H, P::TH) * tiles_w;
  const int nch = ceil_div(E, P::EC), tiles = B * n_tiles;
  int groups = std::min(nch, std::max(1, ceil_div(8 * ctas_c, tiles)));
  const int cpg = ceil_div(nch, groups);
  groups = ceil_div(nch, cpg);
  if (groups > 65535) return -3;
  constexpr int V = 16 / sizeof(T);
  const int vec_x = cin % V == 0 && aligned16(x);
  // 16-byte copies of the chunks: rows of whole 16 bytes (affe too: V >= 4)
  const int vec_w = E % V == 0 && aligned16(w1) && aligned16(wd) && aligned16(affe);
  const int vec_y = E % 4 == 0 && aligned16(y);
  kernel<<<dim3(tiles, groups), kThreads, sm.bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(wd), affe,
      static_cast<T*>(y), H, W, cin, E, tiles_w, n_tiles, cpg, vec_x, vec_w, vec_y);
  return static_cast<int>(cudaGetLastError());
}

// the kernel's plans (ops/kernels/expand_dw.py PLANS): the x halo resident
// or staged
template <typename T>
int dispatch(const void* x, const void* w1, const void* wd, const float* affe, void* y, int B,
             int H, int W, int cin, int E, int plan, cudaStream_t s) {
  switch (plan) {
    case 1: return launch<T, EdPlan<T, true>>(x, w1, wd, affe, y, B, H, W, cin, E, s);
    case 2: return launch<T, EdPlan<T, false>>(x, w1, wd, affe, y, B, H, W, cin, E, s);
    default: return -3;
  }
}

}  // namespace
}  // namespace accunet

// x (B,H,W,cin), y (B,H,W,E), w1 (cin,E) and wd (9,E) in `dtype` (0 fp32, 1
// bf16); affe (4,E) = [s1, t1, s2, t2] fp32, the conv biases folded into t1,
// t2. `plan` names the kernel's plan (1-2).
extern "C" int accunet_expand_dw(const void* x, const void* w1, const void* wd,
                                 const void* affe, void* y, int B, int H, int W, int cin,
                                 int E, int plan, int dtype, void* stream) {
  using namespace accunet;
  if (B < 1 || H < 1 || W < 1 || cin < 1 || E < 1) return -3;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch<float>(x, w1, wd, f(affe), y, B, H, W, cin, E, plan, s);
  if (dtype == kBFloat16) return dispatch<bf16>(x, w1, wd, f(affe), y, B, H, W, cin, E, plan, s);
  return -2;
}
