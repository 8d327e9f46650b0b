// Whole HANCBlock inference body before the SE, BNs folded, NHWC:
//   xin = pre ? lrelu(x*gs + tb) : x                (chained SE prologue)
//   u = lrelu(xin@w1 + t1); d = lrelu(dw3x3(pad0(u)) + t2)
//   h = HANC pyramid + (2k-1) mixes (telescoped); z = (lrelu(h + th) + xin)*sres + tres
//   y = lrelu(z@w3 + t3), and fp32 per-tile channel sums of y
// Replaces the TPU kernel hanc_block_frame (accunet_tpu/ops/pallas/hanc_block.py:335),
// plain (_kernel/_kernel_one) and chained (_kernel_parts) forms.
//
// One CTA per (image, 8x8-pixel tile). The tile's 10x10 halo of xin stays in
// shared memory for the whole block (expand input and residual). The loop
// walks E in chunks of 16, so the E-wide interior never has to fit: per chunk
// it recomputes the expand on the halo (out-of-image halo pixels are set to 0
// AFTER the activation: SAME padding pads the activated map), runs the
// depthwise taps and the pools, and accumulates the 2k-1 mixes into fp32
// registers. The epilogue telescopes the upsample-adds, applies the residual
// and the projection, writes y and reduces the tile's channel sums in a fixed
// order.
#include "common.cuh"

namespace accunet {
namespace {

constexpr int kHbT = 8, kHbHS = kHbT + 2, kHbHP = kHbHS * kHbHS, kHbEC = 16;

template <int K, int NJ>
struct HbLayout {  // shared-memory plan, in floats
  using Pyr = Pyramid<kHbT, kHbT, K>;
  static constexpr int NCOL = 32 * NJ, NV = 2 * K - 1, EC = kHbEC;
  // after the halo (kHbHP x (cin+1)): the loop buffers...
  static size_t loop(int cin) {
    return static_cast<size_t>(cin) * EC + kHbHP * EC + Pyr::NR * EC + 11 * EC +
           NV * EC * NCOL;
  }
  // ...or, after the loop, the epilogue buffers
  static size_t epilogue(int nf, int cout) {
    return static_cast<size_t>(Pyr::NR) * NCOL + nf * cout + Pyr::P * cout;
  }
  static size_t bytes(int cin, int cout) {
    const size_t a = loop(cin), b = epilogue(cin, cout);
    return (static_cast<size_t>(kHbHP) * (cin + 1) + (a > b ? a : b)) * sizeof(float);
  }
};

template <typename T, int K, int NJ>
__global__ void __launch_bounds__(kThreads)
hanc_block_kernel(const T* __restrict__ x, const float* __restrict__ pre,
                  const float* __restrict__ w1, const float* __restrict__ t1,
                  const float* __restrict__ wd, const float* __restrict__ t2,
                  const float* __restrict__ wh, const float* __restrict__ th,
                  const float* __restrict__ sres, const float* __restrict__ tres,
                  const float* __restrict__ w3, const float* __restrict__ t3, T* __restrict__ y,
                  float* __restrict__ sums, int H, int W, int cin, int E, int cout, int tiles_w,
                  int n_tiles) {
  using L = HbLayout<K, NJ>;
  using Pyr = typename L::Pyr;
  constexpr int EC = L::EC, NCOL = L::NCOL, NV = L::NV, P = Pyr::P;
  const int nf = cin, xld = cin + 1;

  float* Xs = shared_floats();          // [HP][cin+1]  halo of xin
  float* W1s = Xs + kHbHP * xld;        // [cin][EC]
  float* Us = W1s + cin * EC;           // [HP][EC]     expanded halo
  float* As = Us + kHbHP * EC;          // [NR][EC]     d + pyramid
  float* WDs = As + Pyr::NR * EC;       // [9][EC]
  float* T1s = WDs + 9 * EC;            // [EC]
  float* T2s = T1s + EC;                // [EC]
  float* WHs = T2s + EC;                // [NV][EC][NCOL]
  float* Rs = W1s;                      // epilogue: [NR][NCOL] mixes, then z in rows < P
  float* W3s = Rs + Pyr::NR * NCOL;     // [nf][cout]
  float* Os = W3s + nf * cout;          // [P][cout]    rounded outputs for the sums

  const int tid = threadIdx.x;
  const int b = blockIdx.y, tile = blockIdx.x;
  const int h0 = (tile / tiles_w) * kHbT, w0 = (tile % tiles_w) * kHbT;
  const T* xb = x + static_cast<size_t>(b) * H * W * cin;

  for (int i = tid; i < kHbHP * cin; i += kThreads) {
    const int r = i / cin, c = i % cin;
    const int gy = h0 - 1 + r / kHbHS, gx = w0 - 1 + r % kHbHS;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = to_float(xb[(static_cast<size_t>(gy) * W + gx) * cin + c]);
      if (pre != nullptr) v = lrelu(v * pre[(2 * b) * cin + c] + pre[(2 * b + 1) * cin + c]);
    }
    Xs[r * xld + c] = v;
  }

  float acc[Pyr::GPW][2][NJ] = {};
  for (int e0 = 0; e0 < E; e0 += EC) {
    for (int i = tid; i < cin * EC; i += kThreads) {
      const int c = i / EC, ee = i % EC;
      W1s[i] = e0 + ee < E ? w1[static_cast<size_t>(c) * E + e0 + ee] : 0.f;
    }
    for (int i = tid; i < 11 * EC; i += kThreads) {  // wd rows 0..8, then t1, t2
      const int r = i / EC, ee = i % EC;
      float v = 0.f;
      if (e0 + ee < E) v = r < 9 ? wd[r * E + e0 + ee] : (r == 9 ? t1 : t2)[e0 + ee];
      WDs[i] = v;
    }
    for (int i = tid; i < NV * EC * NCOL; i += kThreads) {  // wh is (NV, E, nf)
      const int v = i / (EC * NCOL), ee = (i / NCOL) % EC, n = i % NCOL;
      float val = 0.f;
      if (e0 + ee < E && n < nf) val = wh[(static_cast<size_t>(v) * E + e0 + ee) * nf + n];
      WHs[i] = val;
    }
    __syncthreads();

    // expand on the halo; out-of-image pixels are the conv's zero padding
    for (int i = tid; i < kHbHP * EC; i += kThreads) {
      const int r = i / EC, ee = i % EC;
      const int gy = h0 - 1 + r / kHbHS, gx = w0 - 1 + r % kHbHS;
      float u = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && e0 + ee < E) {
        const float* xr = Xs + r * xld;
        float s = 0.f;
        for (int c = 0; c < cin; ++c) s = fmaf(xr[c], W1s[c * EC + ee], s);
        u = lrelu(s + T1s[ee]);
      }
      Us[i] = u;
    }
    __syncthreads();

    // depthwise 3x3, taps in row-major order
    for (int i = tid; i < P * EC; i += kThreads) {
      const int p = i / EC, ee = i % EC;
      const float* u = Us + ((p / kHbT) * kHbHS + p % kHbT) * EC + ee;
      float s = u[0] * WDs[ee];
      for (int t = 1; t < 9; ++t) s += u[((t / 3) * kHbHS + t % 3) * EC] * WDs[t * EC + ee];
      As[i] = lrelu(s + T2s[ee]);
    }
    __syncthreads();
    if (K >= 2) {
      Pyr::pool2(As, EC, EC);
      __syncthreads();
    }
    if (K >= 3) {
      Pyr::pool4(As, EC, EC);
      __syncthreads();
    }
    Pyr::template mix<NJ>(acc, As, EC, WHs, EC);
    __syncthreads();
  }

  Pyr::template store<NJ>(acc, Rs);
  for (int i = tid; i < nf * cout; i += kThreads) W3s[i] = w3[i];
  __syncthreads();
  // z in place: (p, n) reads only its own row and the pooled rows (>= P)
  for (int i = tid; i < P * nf; i += kThreads) {
    const int p = i / nf, n = i % nf;
    const float r = lrelu(Pyr::telescope(Rs, NCOL, p, n) + th[n]);
    const float xin = Xs[((p / kHbT + 1) * kHbHS + p % kHbT + 1) * xld + n];
    Rs[p * NCOL + n] = (r + xin) * sres[n] + tres[n];
  }
  __syncthreads();
  T* yb = y + static_cast<size_t>(b) * H * W * cout;
  for (int i = tid; i < P * cout; i += kThreads) {
    const int p = i / cout, co = i % cout;
    const int gy = h0 + p / kHbT, gx = w0 + p % kHbT;
    const float* z = Rs + p * NCOL;
    float s = 0.f;
    for (int n = 0; n < nf; ++n) s = fmaf(z[n], W3s[n * cout + co], s);
    const T o = from_float<T>(lrelu(s + t3[co]));
    const bool inside = gy < H && gx < W;
    if (inside) yb[(static_cast<size_t>(gy) * W + gx) * cout + co] = o;
    Os[i] = inside ? to_float(o) : 0.f;
  }
  __syncthreads();
  for (int co = tid; co < cout; co += kThreads) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += Os[p * cout + co];
    sums[(static_cast<size_t>(b) * n_tiles + tile) * cout + co] = s;
  }
}

struct Args {
  const void* x;
  const float *pre, *w1, *t1, *wd, *t2, *wh, *th, *sres, *tres, *w3, *t3;
  void* y;
  float* sums;
  int B, H, W, cin, E, cout;
};

template <typename T, int K, int NJ>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = HbLayout<K, NJ>::bytes(a.cin, a.cout);
  cudaError_t err = allow_smem(hanc_block_kernel<T, K, NJ>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = ceil_div(a.W, kHbT), n_tiles = ceil_div(a.H, kHbT) * tiles_w;
  const dim3 grid(n_tiles, a.B);
  hanc_block_kernel<T, K, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.x), a.pre, a.w1, a.t1, a.wd, a.t2, a.wh, a.th, a.sres, a.tres,
      a.w3, a.t3, static_cast<T*>(a.y), a.sums, a.H, a.W, a.cin, a.E, a.cout, tiles_w, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int dispatch_nj(const Args& a, cudaStream_t s) {
  if (a.cin <= 32) return launch<T, K, 1>(a, s);
  if (a.cin <= 64) return launch<T, K, 2>(a, s);
  if (a.cin <= 128) return launch<T, K, 4>(a, s);
  return -3;
}

template <typename T>
int dispatch_k(const Args& a, int k, cudaStream_t s) {
  if (k == 1) return dispatch_nj<T, 1>(a, s);
  if (k == 2) return dispatch_nj<T, 2>(a, s);
  if (k == 3) return dispatch_nj<T, 3>(a, s);
  return -1;
}

}  // namespace
}  // namespace accunet

extern "C" int accunet_hanc_block(const void* x, const void* pre, const void* w1,
                                  const void* t1, const void* wd, const void* t2,
                                  const void* wh, const void* th, const void* sres,
                                  const void* tres, const void* w3, const void* t3, void* y,
                                  void* sums, int B, int H, int W, int cin, int E, int nf,
                                  int cout, int k, int dtype, void* stream) {
  using namespace accunet;
  if (nf != cin) return -4;  // the residual needs nf == cin
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const Args a{x,       f(pre), f(w1),   f(t1),   f(wd), f(t2),
               f(wh),   f(th),  f(sres), f(tres), f(w3), f(t3),
               y,       static_cast<float*>(sums),
               B,       H,      W,       cin,     E,     cout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_k<float>(a, k, s);
  if (dtype == kBFloat16) return dispatch_k<__nv_bfloat16>(a, k, s);
  return -2;
}
