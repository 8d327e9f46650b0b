// One ResPath level, NHWC:
//   x_i = x_{i-1} + lrelu((y_{i-1} * g) * s_se + t_se)     (has_prev)
//   y_i = lrelu(conv3x3(x_i) * s_bn + t_bn)                 (conv bias in t_bn)
// plus fp32 per-tile channel sums of y_i.
// Replaces the TPU kernel respath_level_frame (accunet_tpu/ops/pallas/respath.py:72).
//
// What bounds it on an H100 SXM, at rspth1 of ACC_UNet b8 224x224 (C 32,
// 7.4 GFLOP, x and y_{i-1} in, x_i and y_i out: 205 MB in fp32): in fp32 the
// bytes (0.061 ms at 3.35 TB/s) and the products as 3xTF32 on the tensor
// cores (3 x 7.4 GFLOP / 495 TFLOP/s = 0.045 ms) about equally; in bf16 the
// bytes. So the conv runs on the tensor cores and the level stays one pass.
//
// The conv is an implicit GEMM through mma.sync: M = 16 pixels of one tile
// row (an m16 tile), N = 8 output channels (an n8 tile), K = tap by tap over
// the input channels; 3xTF32 (m16n8k8) in fp32, each 16-deep K-chunk's sum
// started from 0 and added to the accumulator in fp32, bf16 (m16n8k16) in
// bf16. A CTA owns a tile of TH x 16 pixels (TH 8 or 16) and NCOL output
// channels (32 or 64; wider C in column blocks, grid.y), and walks tiles
// (persistent, as many CTAs as fit on the SMs). Per tile it forms the
// (TH+2) x 18 halo of x_i once, in shared memory: x and y_{i-1} by 16-byte
// loads, the SE apply and the residual, then the zeroing of out-of-image
// pixels AFTER forming x_i (SAME padding pads x_i); it writes the tile's x_i
// from the same pass (column block 0). The input channels come in K blocks
// of up to kKMax: the halo holds one block at a time. The 3x3 weights,
// stored [tap][out][in] in the input type, come by cp.async: all nine taps
// once per CTA (resident, C <= kKMax), or tap by tap (and K block by K
// block) through a two-stage ring, one step ahead, for 8x16 tiles (streamed:
// any C, and where two CTAs an SM beat one). The epilogue
// applies BN and lrelu to the accumulator fragments, stores y_i (two
// channels a lane) and sums the tile's channels in a fixed order: a lane's
// pixels, the lanes (shuffles), then the warps; no atomics. In bf16 the
// weights, g, s_se and t_se are bf16 (JAX's kernel casts them), x_i is
// rounded to bf16 and y_i = lrelu(bf16(acc * s_bn + t_bn)), as in JAX;
// respath_level_reference rounds at the same points and does its element
// arithmetic as separate fp32 operations, as the kernel does (__fmul_rn,
// __fadd_rn: nothing contracted to an FMA).
#include <algorithm>
#include <type_traits>

#include "mma.cuh"

namespace accunet {
namespace {

constexpr int kKMax = 128;  // input channels in one K block (a halo's worth)

// The warps of a plan: TH pixel rows x 16 columns, NCOL output channels; WM x
// WN warps, warp (wm, wn) owning MT tile rows (m16 tiles) and NT n8 tiles.
template <typename T, int TH_, int NCOL_, bool STREAM_>
struct RpPlan {
  static constexpr int TH = TH_, TW = 16, NCOL = NCOL_;
  static constexpr bool STREAM = STREAM_;
  static constexpr int HTW = TW + 2, HP = (TH + 2) * HTW, HPR = (HP + 7) / 8 * 8;
  static constexpr int WN = NCOL == 64 ? 2 : 1, WM = kWarps / WN;
  static constexpr int MT = TH / WM, NT = NCOL / 8 / WN, STAGES = STREAM ? 2 : 9;
  static constexpr int MINB = MT * NT >= 16 ? 1 : 2;  // CTAs per SM the registers allow
  static_assert(MT >= 1 && TH % WM == 0 && NCOL % (8 * WN) == 0, "whole tiles per warp");
};

// The shared-memory plan, in bytes (mirrored by ops/kernels/respath.py
// smem_bytes): the weight stages (STAGES x NCOL rows of kpad channels,
// stride ld), the halo (HPR rows, stride ld), the warps' channel sums (WM x
// NCOL fp32). kpad: a K block's channels (at most kKMax) rounded up to 16,
// zero-filled.
struct RpSmem {
  int kpad, ld, xs, red, bytes;
  __host__ __device__ RpSmem(int C, int sz, int hpr, int ncol, int stages, int wm) {
    kpad = C < kKMax ? (C + 15) / 16 * 16 : kKMax;
    ld = conflict_free_ld(kpad, sz == 4 ? 32 : 16);
    xs = align16(stages * ncol * ld * sz);
    red = xs + align16(hpr * ld * sz);
    bytes = red + wm * ncol * 4;
  }
};

// x_{i-1} + lrelu((y_{i-1} * g) * s_se + t_se), rounded to T
template <typename T>
__device__ __forceinline__ float se_apply(float xv, float yv, float g, float s, float t) {
  const float a = __fadd_rn(__fmul_rn(__fmul_rn(yv, g), s), t);
  return round_to<T>(__fadd_rn(xv, lrelu(a)));
}

template <typename T, class P>
__global__ void __launch_bounds__(kThreads, P::MINB)
respath_level_kernel(const T* __restrict__ x, const T* __restrict__ yprev,
                     const float* __restrict__ gate, const float* __restrict__ s_se,
                     const float* __restrict__ t_se, const T* __restrict__ w,
                     const float* __restrict__ s_bn, const float* __restrict__ t_bn,
                     T* __restrict__ y_out, T* __restrict__ x_out, float* __restrict__ sums,
                     int B, int H, int W, int C, int has_prev, int tiles_w, int n_tiles,
                     int vec) {
  using O = Ops<T>;
  constexpr int TH = P::TH, HTW = P::HTW, NCOL = P::NCOL, MT = P::MT, NT = P::NT;
  constexpr int V = 16 / sizeof(T), S = 16 / O::KSTEP;  // k-steps per 16-deep K-chunk
  const RpSmem sm(C, sizeof(T), P::HPR, NCOL, P::STAGES, P::WM);
  char* base = reinterpret_cast<char*>(shared_floats());
  T* Ws = reinterpret_cast<T*>(base);
  T* Xs = reinterpret_cast<T*>(base + sm.xs);
  float* red = reinterpret_cast<float*>(base + sm.red);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int wm = warp % P::WM, wn = warp / P::WM, r0 = wm * MT, nt0 = wn * NT;
  const int c0 = blockIdx.y * NCOL, ncols = min(NCOL, C - c0);
  const int total = B * n_tiles, wslab = NCOL * sm.ld;
  const int nkb = (C + kKMax - 1) / kKMax, steps = 9 * nkb;
  const bool write_x = has_prev && blockIdx.y == 0;
  // K block kb: its first channel, its channels, and those rounded up to 16
  auto kblock = [&](int kb, int& kb0, int& kw, int& kpb) {
    kb0 = kb * kKMax, kw = min(kKMax, C - kb0), kpb = (kw + 15) / 16 * 16;
  };

  // step `step`'s weights w[tap][c0 .. c0 + NCOL)[kb0 .. kb0 + kw) -> stage
  // `st`, tap = step % 9 of K block step / 9
  auto load_w = [&](int step, int st) {
    int kb0, kw, kpb;
    kblock(step / 9, kb0, kw, kpb);
    T* dst = Ws + st * wslab;
    const T* src = w + (static_cast<size_t>(step % 9) * C + c0) * C + kb0;
    if (vec) {
      const int segs = kpb / V;
      for (int i = tid; i < NCOL * segs; i += kThreads) {
        const int n = i / segs, k = (i - n * segs) * V;
        const bool ok = n < ncols && k < kw;
        cp_async16(dst + n * sm.ld + k, ok ? src + static_cast<size_t>(n) * C + k : w, ok);
      }
    } else {
      for (int i = tid; i < NCOL * kpb; i += kThreads) {
        const int n = i / kpb, k = i - n * kpb;
        dst[n * sm.ld + k] =
            n < ncols && k < kw ? src[static_cast<size_t>(n) * C + k] : from_float<T>(0.f);
      }
    }
  };
  if constexpr (P::STREAM) {
    load_w(0, 0);
  } else {
    for (int tap = 0; tap < 9; ++tap) load_w(tap, tap);
  }
  cp_async_commit();

  int q = 0;  // streamed: steps consumed so far (stage q % 2)
  for (int tt = blockIdx.x; tt < total; tt += gridDim.x) {
    const int b = tt / n_tiles, tile = tt - b * n_tiles;
    const int h0 = (tile / tiles_w) * TH, w0 = (tile % tiles_w) * P::TW;
    const size_t img = static_cast<size_t>(b) * H * W * C;
    const float* gb = gate + static_cast<size_t>(b) * C;
    float acc[MT][NT][4] = {};

    auto at = [&](int hp, int& gy, int& gx, bool& inside, bool& interior) {
      const int hy = hp / HTW, hx = hp - hy * HTW;
      gy = h0 - 1 + hy, gx = w0 - 1 + hx;
      inside = hp < P::HP && gy >= 0 && gy < H && gx >= 0 && gx < W;
      interior = inside && hy >= 1 && hy <= TH && hx >= 1 && hx <= P::TW;
    };

    for (int kb = 0; kb < nkb; ++kb) {
      int kb0, kw, kpb;
      kblock(kb, kb0, kw, kpb);
      if (kb > 0) __syncthreads();  // every warp is done with the last K block's halo

      // the halo of x_i, channels kb0 .. kb0 + kpb: zero outside the image and
      // for channels >= C
      if (vec) {
        // U 16-byte items a thread at a time: every load issued before the
        // first is used
        constexpr int U = 4;
        const int segs = kpb / V, n = P::HPR * segs;
        for (int i0 = tid; i0 < n; i0 += U * kThreads) {
          uint4 xr[U], yr[U];
          size_t idx[U];
          bool ok[U], interior[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = i0 + u * kThreads, hp = i / segs, c = (i - hp * segs) * V;
            int gy, gx;
            bool inside;
            at(hp, gy, gx, inside, interior[u]);
            ok[u] = i < n && inside && c < kw;
            idx[u] = ok[u] ? img + (static_cast<size_t>(gy) * W + gx) * C + kb0 + c : 0;
            xr[u] = ok[u] ? *reinterpret_cast<const uint4*>(x + idx[u]) : make_uint4(0, 0, 0, 0);
            yr[u] = ok[u] && has_prev ? *reinterpret_cast<const uint4*>(yprev + idx[u])
                                      : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = i0 + u * kThreads, hp = i / segs, c = (i - hp * segs) * V;
            if (i >= n) break;
            float v[V];
            unpack16(xr[u], v);
            if (ok[u] && has_prev) {
              float yv[V];
              unpack16(yr[u], yv);
#pragma unroll
              for (int j = 0; j < V; ++j)
                v[j] = se_apply<T>(v[j], yv[j], round_to<T>(__ldg(gb + kb0 + c + j)),
                                   round_to<T>(__ldg(s_se + kb0 + c + j)),
                                   round_to<T>(__ldg(t_se + kb0 + c + j)));
              if (write_x && interior[u]) stv<V>(x_out + idx[u], v);
            }
            stv<V>(Xs + hp * sm.ld + c, v);
          }
        }
      } else {
        for (int i = tid; i < P::HPR * kpb; i += kThreads) {
          const int hp = i / kpb, c = i - hp * kpb, ch = kb0 + c;
          int gy, gx;
          bool inside, interior;
          at(hp, gy, gx, inside, interior);
          float v = 0.f;
          if (inside && c < kw) {
            const size_t idx = img + (static_cast<size_t>(gy) * W + gx) * C + ch;
            v = to_float(x[idx]);
            if (has_prev) {
              v = se_apply<T>(v, to_float(yprev[idx]), round_to<T>(__ldg(gb + ch)),
                              round_to<T>(__ldg(s_se + ch)), round_to<T>(__ldg(t_se + ch)));
              if (write_x && interior) x_out[idx] = from_float<T>(v);
            }
          }
          Xs[hp * sm.ld + c] = from_float<T>(v);
        }
      }
      cp_async_wait<0>();  // resident: the weights of the first tile
      __syncthreads();     // the halo is complete

      // the conv: acc[mt][nt] += x_i(tap-shifted rows) x w[tap] per 16-deep K-chunk
      for (int tap = 0; tap < 9; ++tap) {
        const T* Wt = Ws + (P::STREAM ? q % 2 : tap) * wslab;
        if constexpr (P::STREAM) {
          const int step = kb * 9 + tap;
          cp_async_wait<0>();
          __syncthreads();  // step q has landed; every warp is done with step q - 1's stage
          if (step + 1 < steps)
            load_w(step + 1, (q + 1) % 2);
          else if (tt + static_cast<int>(gridDim.x) < total)
            load_w(0, (q + 1) % 2);
          cp_async_commit();
          ++q;
        }
        const int dy = tap / 3, dx = tap - dy * 3;
        for (int kc = 0; kc < kpb; kc += 16) {
          typename O::B bw[S][NT];
#pragma unroll
          for (int s = 0; s < S; ++s)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              O::load_b(bw[s][nt], Wt, sm.ld, (nt0 + nt) * 8, kc + s * O::KSTEP, lane);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int row = (r0 + mt + dy) * HTW + dx;  // 16 consecutive halo pixels
            typename O::A a[S];
#pragma unroll
            for (int s = 0; s < S; ++s)
              O::load_a_rows(a[s], Xs, sm.ld, row, kc + s * O::KSTEP, lane);
            if constexpr (O::kPromote) {
              float part[NT][4];
#pragma unroll
              for (int s = 0; s < S; ++s)
#pragma unroll
                for (int p = 0; p < O::kPasses; ++p)
#pragma unroll
                  for (int nt = 0; nt < NT; ++nt) O::pass(p, s == 0, part[nt], a[s], bw[s][nt]);
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[mt][nt][c] += part[nt][c];
            } else {
#pragma unroll
              for (int s = 0; s < S; ++s)
#pragma unroll
                for (int p = 0; p < O::kPasses; ++p)
#pragma unroll
                  for (int nt = 0; nt < NT; ++nt) O::pass(p, false, acc[mt][nt], a[s], bw[s][nt]);
            }
          }
        }
      }
    }  // K blocks

    // epilogue: BN, lrelu, y_i from the fragments (pixel g or g + 8 of tile
    // row r0 + mt, channels n and n + 1), and the lanes' channel sums
    float csum[NT][2] = {};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = c0 + (nt0 + nt) * 8 + t2;
      const bool ok0 = n < C, ok1 = n + 1 < C;
      const float sb0 = ok0 ? __ldg(s_bn + n) : 0.f, tb0 = ok0 ? __ldg(t_bn + n) : 0.f;
      const float sb1 = ok1 ? __ldg(s_bn + n + 1) : 0.f, tb1 = ok1 ? __ldg(t_bn + n + 1) : 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int gy = h0 + r0 + mt;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gx = w0 + g + 8 * h;
          if (gy < H && gx < W) {
            float o[2];
            o[0] = round_to<T>(lrelu(round_to<T>(__fadd_rn(__fmul_rn(acc[mt][nt][2 * h], sb0), tb0))));
            o[1] = round_to<T>(
                lrelu(round_to<T>(__fadd_rn(__fmul_rn(acc[mt][nt][2 * h + 1], sb1), tb1))));
            T* dst = y_out + img + (static_cast<size_t>(gy) * W + gx) * C + n;
            if (ok1 && C % 2 == 0) {
              stv<2>(dst, o);
            } else {
              if (ok0) dst[0] = from_float<T>(o[0]);
              if (ok1) dst[1] = from_float<T>(o[1]);
            }
            csum[nt][0] += ok0 ? o[0] : 0.f;
            csum[nt][1] += ok1 ? o[1] : 0.f;
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float s = csum[nt][j];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (g == 0) red[wm * NCOL + (nt0 + nt) * 8 + t2 + j] = s;
      }
    __syncthreads();  // every warp is done with the halo and has stored its sums
    for (int n = tid; n < ncols; n += kThreads) {
      float s = 0.f;
      for (int r = 0; r < P::WM; ++r) s += red[r * NCOL + n];
      sums[(static_cast<size_t>(b) * n_tiles + tile) * C + c0 + n] = s;
    }
  }
  cp_async_wait<0>();
}

struct Args {
  const void *x, *yprev;
  const float *gate, *s_se, *t_se;
  const void* w;
  const float *s_bn, *t_bn;
  void *y, *x_out;
  float* sums;
  int B, H, W, C, has_prev;
};

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, class P>
int launch(const Args& a, cudaStream_t stream) {
  const RpSmem sm(a.C, sizeof(T), P::HPR, P::NCOL, P::STAGES, P::WM);
  if (sm.bytes > static_cast<int>(kMaxSmem) || (!P::STREAM && a.C > kKMax)) return -4;
  auto kernel = respath_level_kernel<T, P>;
  cudaError_t err = allow_smem(kernel, sm.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent CTAs: as many as fit on the SMs at once (cached per size)
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
  constexpr int V = 16 / sizeof(T);
  const int vec = a.C % V == 0 && aligned16(a.x) && aligned16(a.w) && aligned16(a.y) &&
                  (!a.has_prev || (aligned16(a.yprev) && aligned16(a.x_out)));
  const int tiles_w = ceil_div(a.W, P::TW), n_tiles = ceil_div(a.H, P::TH) * tiles_w;
  const int ncb = ceil_div(a.C, P::NCOL);
  const int grid_x = std::min(a.B * n_tiles, std::max(1, ctas_c / ncb));
  kernel<<<dim3(grid_x, ncb), kThreads, sm.bytes, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.yprev), a.gate, a.s_se, a.t_se,
      static_cast<const T*>(a.w), a.s_bn, a.t_bn, static_cast<T*>(a.y),
      static_cast<T*>(a.x_out), a.sums, a.B, a.H, a.W, a.C, a.has_prev, tiles_w, n_tiles, vec);
  return static_cast<int>(cudaGetLastError());
}

// the plans (ops/kernels/respath.py PLANS: tile rows, output channels,
// weights streamed), built for the types in which pick_plan picks them
template <typename T>
int dispatch(const Args& a, int plan, cudaStream_t s) {
  switch (plan) {
    case 1:
      if constexpr (std::is_same_v<T, bf16>) return launch<T, RpPlan<T, 8, 64, false>>(a, s);
      return -3;
    case 2: return launch<T, RpPlan<T, 16, 32, false>>(a, s);
    case 3: return launch<T, RpPlan<T, 8, 64, true>>(a, s);
    default: return -3;
  }
}

}  // namespace
}  // namespace accunet

// x, yprev, y_out, x_out (B, H, W, C) and w (3, 3, C_out, C_in) in `dtype`
// (0 fp32, 1 bf16); gate (B, C), s_se, t_se, s_bn, t_bn (C) fp32; sums (B,
// tiles, C) fp32 for the plan's tiles. `plan` names the plan (1-3; 1 in
// bf16 only).
extern "C" int accunet_respath_level(const void* x, const void* yprev, const void* gate,
                                     const void* s_se, const void* t_se, const void* w,
                                     const void* s_bn, const void* t_bn, void* y_out,
                                     void* x_out, void* sums, int B, int H, int W, int C,
                                     int has_prev, int plan, int dtype, void* stream) {
  using namespace accunet;
  if (B < 1 || H < 1 || W < 1 || C < 1) return -3;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const Args a{x,     yprev,   f(gate), f(s_se), f(t_se), w, f(s_bn), f(t_bn), y_out, x_out,
               static_cast<float*>(sums), B, H, W, C, has_prev};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch<float>(a, plan, s);
  if (dtype == kBFloat16) return dispatch<bf16>(a, plan, s);
  return -2;
}
