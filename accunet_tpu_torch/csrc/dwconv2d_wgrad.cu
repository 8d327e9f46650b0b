// Depthwise conv2d weight gradient, NHWC, SAME padding, and the bias gradient
// from the same pass:
//   dw[i][j][c] = sum_{b,h,w} x[b, h+i-ph, w+j-pw, c] * g[b, h, w, c]
//   db[c]       = sum_{b,h,w} g[b, h, w, c]
// (x zero outside the image, ph = (KH-1)/2, pw = (KW-1)/2). Replaces the TPU
// kernel _dwconv2d_wgrad_pallas (accunet_tpu/ops/pallas/dwconv2d.py:76,
// pallas_call :111); db is what JAX's _bwd computes beside it (:189).
//
// What bounds it on the card: bytes. Each output tap is a reduction over
// B*H*W of one product, 2*KH*KW flops per element pair of x and g (4 flops
// per 8 bytes in fp32 at k=3): the H100 runs out of bandwidth long before it
// runs out of FMAs. The design keeps many bytes in flight, reads each byte of
// x and g from device memory about once, and spends few instructions on it:
//  * A CTA owns CB channels (128 bytes of a pixel with 16-byte copies: 32
//    fp32 or 64 bf16; fewer when C is smaller) and a contiguous range of the
//    (image, column segment, row) units of the map, the same count for every
//    CTA of a channel block. A thread owns CV consecutive channels (4 at k=3,
//    2 at k=5, 1 at k=7 or with element copies) of one column of the
//    segment; a segment is as wide as the CTA has such threads per channel
//    vector (32 in fp32, 16 in bf16).
//  * Rows stream through a ring of shared-memory stages filled by cp.async
//    (16-byte copies where C * sizeof(T) allows, else element copies;
//    out-of-image pixels zero-filled), two stages ahead of the one in use. A
//    stage is KH x rows of the segment with their kw-1 halo columns and KH
//    g rows; a thread's copies are fixed columns of a row, so a copy costs a
//    compare and an add, and a band's place in the map is worked out once.
//  * Down a band of rows, each thread slides a KH x KW x CV window of x in
//    registers: a row brings in one new x row (KW loads from shared memory)
//    and one g value, and adds KH*KW*CV products to sums kept in fp32
//    registers across all its bands. With KH rows a stage, the row a step
//    brings in lands in a fixed register slot of the window, so the window
//    never moves. A band costs KH-1 extra x rows.
//  * A map so narrow that a segment leaves half the CTA's threads idle (the
//    14x14 layers in fp32) is latency-bound through the ring: there each
//    thread reads its window's values and g straight from device memory
//    (its neighbours' columns come from L1), a row ahead, and the idle
//    threads walk other bands of the CTA's rows at the same time (`direct`,
//    chosen by ops/kernels/dwconv2d.py wgrad_plan).
//  * Deterministic: the threads of a channel are summed in column order in
//    shared memory; with more than one CTA per channel block each writes its
//    partial, and the last CTA to finish (an atomic counter per channel
//    block, reset by that CTA) sums the partials in CTA order, the loads of
//    both sums batched eight at a time. One launch; two calls on the same
//    inputs give the same bits.
#include "mma.cuh"

namespace accunet {
namespace {

constexpr int kWgAhead = 2;  // ring stages in flight beyond the one in use

// 4 bytes global -> shared, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// one copy unit: 16 bytes (VEC), or one element (cp.async for fp32; bf16
// elements are too small for cp.async and are copied through a register)
template <typename T, bool VEC>
__device__ __forceinline__ void copy_in(T* dst, const T* src, bool valid) {
  if constexpr (VEC)
    cp_async16(dst, src, valid);
  else if constexpr (sizeof(T) == 4)
    cp_async4(dst, src, valid);
  else
    *dst = valid ? *src : from_float<T>(0.f);
}

// value(0) + value(1) + ... + value(n-1), added in that order, the values
// loaded eight at a time so that their latencies overlap
template <typename F>
__device__ __forceinline__ float ordered_sum(int n, F value) {
  float sum = 0.f;
  int q = 0;
  for (; q + 8 <= n; q += 8) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = value(q + i);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += v[i];
  }
  for (; q < n; ++q) sum += value(q);
  return sum;
}

// CW consecutive values from device memory (read-only path), as floats
template <int CW>
__device__ __forceinline__ void ldg_v(const float* p, float (&v)[CW]) {
  if constexpr (CW == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (CW == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}
template <int CW>
__device__ __forceinline__ void ldg_v(const bf16* p, float (&v)[CW]) {
  if constexpr (CW == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
  } else if constexpr (CW == 2) {
    const float2 t = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = __bfloat162float(__ldg(p));
  }
}

// channels per thread: 4 / 2 / 1 at k = 3 / 5 / 7, 1 with element copies
template <int K>
__host__ __device__ constexpr int channels_per_thread(bool vec) {
  return vec ? (K == 3 ? 4 : K == 5 ? 2 : 1) : 1;
}

struct WgShape {
  int B, H, W, C;
  int cb, sw, nseg, ctas;  // channels per block, segment width and count, CTAs per block
  int direct;              // read x and g straight from device memory, no ring
};

// A band: output rows [hb, hb + end - u) of one (image, segment) column,
// units u .. end (unit = column * H + row). Its steps s = 0 .. nx-1 bring x
// row hb - PH + s into the window; from s = KH-1 on, step s adds the products
// of output row hb + s - (KH-1). Stage t holds the x and g rows of steps
// t*KH .. t*KH + KH-1, so step s enters window slot s % KH = its row in the
// stage, a constant once the row loop is unrolled.
struct Cursor {
  int u, end, t, nx, b, w0, hb;
};

__device__ __forceinline__ void band_at(Cursor& c, int u, int u1, int H, int nseg, int sw,
                                        int kh) {
  const int col = u / H;
  c.u = u;
  c.end = min(u1, (col + 1) * H);
  c.t = 0;
  c.nx = c.end - u + kh - 1;
  c.b = col / nseg;
  c.w0 = (col - c.b * nseg) * sw;
  c.hb = u - col * H;
}

template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
dwconv_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ part,
                    int* __restrict__ counters, float* __restrict__ dw, float* __restrict__ db,
                    const WgShape s) {
  constexpr int PH = (K - 1) / 2, PW = (K - 1) / 2, NS = kWgAhead + 1;
  constexpr int CV = channels_per_thread<K>(VEC);
  constexpr int CPY = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;  // elements per copy
  constexpr int NT = K * K + 1;  // taps, then the bias gradient
  const int tid = threadIdx.x;
  const int cb = s.cb, sw = s.sw, H = s.H, W = s.W, C = s.C;
  const int ncv = cb / CV, lanes = kThreads / ncv;  // threads per channel vector
  const int cv = tid % ncv, l = tid / ncv;          // channels cv*CV.., column l
  const int p = blockIdx.x, cblk = blockIdx.y, c0 = cblk * cb;
  // a stage: K rows of [x row with halo columns (xw pixels), g row (sw)]
  const int xw = sw + K - 1, row = (xw + sw) * cb, stage = K * row;
  const int units = s.B * s.nseg * H;
  const int u0 = static_cast<int>(static_cast<long long>(units) * p / s.ctas);
  const int u1 = static_cast<int>(static_cast<long long>(units) * (p + 1) / s.ctas);
  const size_t pitch = static_cast<size_t>(W) * C;  // elements of an image row
  T* smem = reinterpret_cast<T*>(shared_floats());

  // this thread's copies of a row: x pixels px0 and px1 (< xw), g pixel px0
  // (< sw), each at channel offset e0 / e1 (fewer than 2 * kThreads copies
  // make a row: see wgrad_plan)
  const int nch = cb / CPY;
  const int px0 = tid / nch, e0 = (tid - px0 * nch) * CPY;
  const int px1 = (tid + kThreads) / nch, e1 = (tid + kThreads - px1 * nch) * CPY;
  const bool ch0 = c0 + e0 < C, ch1 = c0 + e1 < C;

  auto advance = [&](Cursor& c) {
    if (++c.t * K >= c.nx) band_at(c, c.end, u1, H, s.nseg, sw, K);
  };
  auto load = [&](const Cursor& c, T* slot) {
    const int gx0 = c.w0 - PW + px0, gx1 = c.w0 - PW + px1, gxg = c.w0 + px0;
    const bool okx0 = px0 < xw && ch0 && gx0 >= 0 && gx0 < W;
    const bool okx1 = px1 < xw && ch1 && gx1 >= 0 && gx1 < W;
    const bool okg = px0 < sw && ch0 && gxg < W;
    const int o0 = gx0 * C + e0, o1 = gx1 * C + e1, og = gxg * C + e0;
    const size_t img = static_cast<size_t>(c.b) * H * pitch + c0;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int st = c.t * K + r;
      if (st < c.nx) {
        T* dst = slot + r * row;
        const int xr = c.hb - PH + st;
        const bool in = xr >= 0 && xr < H;
        const T* xrow = x + img + (in ? xr : 0) * pitch;
        if (px0 < xw) copy_in<T, VEC>(dst + px0 * cb + e0, in && okx0 ? xrow + o0 : x, in && okx0);
        if (px1 < xw) copy_in<T, VEC>(dst + px1 * cb + e1, in && okx1 ? xrow + o1 : x, in && okx1);
        if (st >= K - 1 && px0 < sw) {
          const T* grow = g + img + (c.hb + st - (K - 1)) * pitch;
          copy_in<T, VEC>(dst + (xw + px0) * cb + e0, okg ? grow + og : g, okg);
        }
      }
    }
  };

  float win[K][K][CV] = {}, acc[K][K][CV] = {}, dacc[CV] = {};  // win[slot][column]
  // step st of a band: x row st enters window slot st % K, then (from st =
  // K-1 on) g's row adds its products; tap row i is x row st - (K-1) + i,
  // in slot (st + 1 + i) % K
  auto step = [&](int r, const float (&xn)[K][CV], const float (&gv)[CV], bool products) {
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int e = 0; e < CV; ++e) win[r][j][e] = xn[j][e];
    if (products) {
#pragma unroll
      for (int e = 0; e < CV; ++e) dacc[e] += gv[e];
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j)
#pragma unroll
          for (int e = 0; e < CV; ++e)
            acc[i][j][e] = fmaf(win[(r + 1 + i) % K][j][e], gv[e], acc[i][j][e]);
    }
  };
  if (s.direct) {
    // no ring: each thread reads its column's window values and g straight
    // from device memory (its neighbours' columns come from L1), one row
    // ahead of the row it adds. A narrow segment leaves
    // threads over: they walk later parts of the CTA's rows (sub-band j of
    // `sub`) at the same time, so that no thread walks many rows alone.
    const int sub = lanes / sw, j = l / sw, cl = l - j * sw;
    const int v0 = u0 + (u1 - u0) * j / max(sub, 1), v1 = u0 + (u1 - u0) * (j + 1) / max(sub, 1);
    Cursor c;
    for (band_at(c, v0, v1, H, s.nseg, sw, K); j < sub && c.u < v1;
         band_at(c, c.end, v1, H, s.nseg, sw, K)) {
      const int col = c.w0 + cl;
      if (col >= W) continue;
      const size_t img = static_cast<size_t>(c.b) * H * pitch + c0 + cv * CV;
      const T* xb = x + img;
      const T* gcol = g + img + static_cast<size_t>(col) * C;
      auto fetch = [&](int st, float (&xn)[K][CV], float (&gn)[CV]) {
        const int xr = c.hb - PH + st;
        const bool in = st < c.nx && xr >= 0 && xr < H;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int xc = col - PW + j;
          if (in && xc >= 0 && xc < W)
            ldg_v(xb + xr * pitch + static_cast<size_t>(xc) * C, xn[j]);
          else
#pragma unroll
            for (int e = 0; e < CV; ++e) xn[j][e] = 0.f;
        }
        if (st < c.nx && st >= K - 1)
          ldg_v(gcol + (c.hb + st - (K - 1)) * pitch, gn);
        else
#pragma unroll
          for (int e = 0; e < CV; ++e) gn[e] = 0.f;
      };
      float xn[K][CV], gn[CV];  // the next row's values, in flight
      fetch(0, xn, gn);
      for (int st0 = 0; st0 < c.nx; st0 += K) {
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const int st = st0 + r;
          if (st < c.nx) {
            float xc[K][CV], gv[CV];
#pragma unroll
            for (int j = 0; j < K; ++j)
#pragma unroll
              for (int e = 0; e < CV; ++e) xc[j][e] = xn[j][e];
#pragma unroll
            for (int e = 0; e < CV; ++e) gv[e] = gn[e];
            fetch(st + 1, xn, gn);
            step(r, xc, gv, st >= K - 1);
          }
        }
      }
    }
  } else {
    Cursor ld, cp;
    band_at(ld, u0, u1, H, s.nseg, sw, K);
    cp = ld;
#pragma unroll
    for (int a = 0; a < kWgAhead; ++a) {
      if (ld.u < u1) {
        load(ld, smem + a * stage);
        advance(ld);
      }
      cp_async_commit();
    }
    for (int S = 0; cp.u < u1; ++S) {
      cp_async_wait<kWgAhead - 1>();
      __syncthreads();  // stage S has landed; every thread is done with stage S - 1
      if (ld.u < u1) {
        load(ld, smem + ((S + kWgAhead) % NS) * stage);
        advance(ld);
      }
      cp_async_commit();
      if (l < sw && cp.w0 + l < W) {
        const T* slot = smem + (S % NS) * stage + l * cb + cv * CV;
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const int st = cp.t * K + r;
          if (st < cp.nx) {
            float xn[K][CV], gv[CV];
#pragma unroll
            for (int j = 0; j < K; ++j) ldv(slot + r * row + j * cb, xn[j]);
            if (st >= K - 1) ldv(slot + r * row + xw * cb, gv);
            step(r, xn, gv, st >= K - 1);
          }
        }
      }
      advance(cp);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the CTA's sums: every thread's K*K+1 sums to shared memory, then each
  // (tap, channel) output adds the columns of its channel vector in column
  // order, its loads batched (ordered_sum)
  float* red = shared_floats();  // [kThreads][NT][CV]
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < CV; ++e)
      red[(tid * NT + t) * CV + e] = t < NT - 1 ? acc[t / K][t % K][e] : dacc[e];
  __syncthreads();
  const int nt = db != nullptr ? NT : NT - 1;
  auto dst = [&](int t) { return t < NT - 1 ? dw + static_cast<size_t>(t) * C : db; };
  float* out = s.ctas > 1 ? part + static_cast<size_t>(p) * NT * C : nullptr;
  for (int o = tid; o < nt * cb; o += kThreads) {
    const int t = o / cb, c = o - t * cb;
    if (c0 + c >= C) continue;
    const float* src = red + ((c / CV) * NT + t) * CV + c % CV;
    const float sum = ordered_sum(lanes, [&](int q) { return src[q * ncv * NT * CV]; });
    if (out != nullptr)
      out[static_cast<size_t>(t) * C + c0 + c] = sum;
    else
      dst(t)[c0 + c] = sum;
  }
  if (s.ctas == 1) return;  // no barrier follows

  // the last CTA of the channel block sums the partials in CTA order
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + cblk, 1) == s.ctas - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int o = tid; o < nt * cb; o += kThreads) {
    const int t = o / cb, c = o - t * cb;
    if (c0 + c >= C) continue;
    const float* src = part + static_cast<size_t>(t) * C + c0 + c;
    dst(t)[c0 + c] =
        ordered_sum(s.ctas, [&](int q) { return __ldcg(src + static_cast<size_t>(q) * NT * C); });
  }
  if (tid == 0) counters[cblk] = 0;  // ready for the next launch on this stream
}

template <typename T, int K, bool VEC>
int launch(const void* x, const void* g, float* part, int* counters, float* dw, float* db,
           const WgShape& s, cudaStream_t stream) {
  constexpr int CV = channels_per_thread<K>(VEC);
  constexpr int CPY = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  if (s.cb % CPY || s.cb % CV || s.cb / CV > kThreads) return -3;
  const int lanes = kThreads / (s.cb / CV);
  if (s.sw > lanes || (s.sw + K - 1) * (s.cb / CPY) > 2 * kThreads) return -3;
  const size_t ring = s.direct ? 0
                              : static_cast<size_t>(kWgAhead + 1) * K * (2 * s.sw + K - 1) *
                                    s.cb * sizeof(T);
  const size_t red = static_cast<size_t>(kThreads) * (K * K + 1) * CV * sizeof(float);
  const size_t smem = ring > red ? ring : red;
  if (smem > kMaxSmem) return -4;
  auto kernel = dwconv_wgrad_kernel<T, K, VEC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(s.ctas, ceil_div(s.C, s.cb));
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(g),
                                           part, counters, dw, db, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int dispatch_k(const void* x, const void* g, float* part, int* counters, float* dw, float* db,
               const WgShape& s, int k, cudaStream_t st) {
  if (k == 3) return launch<T, 3, VEC>(x, g, part, counters, dw, db, s, st);
  if (k == 5) return launch<T, 5, VEC>(x, g, part, counters, dw, db, s, st);
  if (k == 7) return launch<T, 7, VEC>(x, g, part, counters, dw, db, s, st);
  return -1;
}

template <typename T>
int dispatch_vec(const void* x, const void* g, float* part, int* counters, float* dw, float* db,
                 const WgShape& s, int k, int vec, cudaStream_t st) {
  if (!vec) return dispatch_k<T, false>(x, g, part, counters, dw, db, s, k, st);
  const bool aligned = (static_cast<size_t>(s.C) * sizeof(T)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(g) % 16 == 0;
  if (!aligned) return -5;
  return dispatch_k<T, true>(x, g, part, counters, dw, db, s, k, st);
}

}  // namespace
}  // namespace accunet

// x, g (B, H, W, C) of `dtype`; dw (k, k, C) fp32, db (C,) fp32 or null.
// The plan (ops/kernels/dwconv2d.py wgrad_plan): cb channels per CTA block,
// column segments of sw pixels, `ctas` CTAs per channel block, `direct` 1
// to read x and g without the ring; vec 1 for
// 16-byte copies (C * sizeof(T) % 16 == 0). With ctas > 1, part is (ctas,
// k*k + 1, C) fp32 scratch and counters (ceil(C / cb),) int32, zero before
// the launch and zero after it.
extern "C" int accunet_dwconv2d_wgrad(const void* x, const void* g, void* part, void* counters,
                                      void* dw, void* db, int B, int H, int W, int C, int k,
                                      int cb, int sw, int ctas, int direct, int vec,
                                      int dtype, void* stream) {
  using namespace accunet;
  if (cb <= 0 || sw <= 0 || ctas <= 0) return -3;
  const WgShape s{B, H, W, C, cb, sw, ceil_div(W, sw), ctas, direct};
  if (ctas > B * s.nseg * H || (ctas > 1 && (part == nullptr || counters == nullptr))) return -3;
  float* pf = static_cast<float*>(part);
  int* cf = static_cast<int*>(counters);
  float* df = static_cast<float*>(dw);
  float* bf = static_cast<float*>(db);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_vec<float>(x, g, pf, cf, df, bf, s, k, vec, st);
  if (dtype == kBFloat16) return dispatch_vec<__nv_bfloat16>(x, g, pf, cf, df, bf, s, k, vec, st);
  return -2;
}
