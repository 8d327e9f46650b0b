// First-order linear recurrence along L of contiguous (B, L, D) fp32 tensors:
//   linear_scan          h[t] = a[t] * h[t-1] + b[t]                (h[-1] = 0)
//   linear_scan_reverse  G[t] = g[t] + a[t+1] * G[t+1]              (G[L] = 0)
//                        db[t] = G[t], da[t] = G[t] * h[t-1]        (h[-1] = 0)
//   linear_scan_staged   h as linear_scan, at a ring the caller chooses
// Replace the TPU kernels _chunked_scan_fwd / chunked_linear_scan
// (accunet_tpu/ops/pallas/scan.py:62 / :102, pallas_call :73; its backward
// :119-126 is the reverse form) and dma_chunked_scan
// (accunet_tpu/ops/pallas/scan_dma.py:114, pallas_call :130).
//
// What bounds them on the card: bytes. A step is one FMA per 12 bytes moved
// (a and b read, h written; the reverse form reads a, g and h[t-1] and
// writes da and db: 20 bytes), so the H100's 3.35 TB/s runs out long before
// its FMAs do: SegMamba stage 0's 12,544 dependent FMAs take ~30 us, its
// bytes 552 us. What holds a sequential walk below the bytes bound is
// latency: at ~1 us a load, 3.35 TB/s needs ~3 MB of loads in flight across
// the card, ~25 KB an SM, and it needs every SM to have columns to walk. A
// thread a column and 16 steps loaded ahead in registers (the design this
// one replaced) kept 16 KB in flight a 128-column CTA and gave BASELINE
// config 5's (8, 3136, 768) 48 CTAs.
//
// Design: one kernel, linear_scan_kernel<REVERSE, NBUF, VEC16>, serves all
// three. A CTA is one warp that owns a 32-column tile of one batch row (a
// tile row is 128 contiguous bytes of each operand) and walks L; B *
// ceil(D / 32) CTAs: config 5 gives 192, stage 0 384, and several fit on an
// SM at once, so every shape the paths launch puts all 132 SMs to work in
// one wave. The walk reads its operands (a, b; reverse: a, g and h[t-1])
// from an NBUF-slot ring of (chunk x 32) tiles in shared memory, filled by
// cp.async with one commit group a chunk and waited with wait_group NBUF-1,
// so the copies run NBUF-1 chunks ahead of the walk (the async-copy ring of
// scan_dma.py:60-104). linear_scan and its reverse launch it at 3 slots
// (kFwdRing / kRevRing: 64 rows of a and b, 48 of a, g and h[t-1]): 32 KB
// (reverse 36 KB) of loads in flight a CTA, 46-52 KB an SM at config 5 (1-2
// CTAs an SM), more at every other shape; tools/kernel_ab.py --sweep times
// the rings around them. linear_scan_staged runs at the caller's chunk and
// nbuf (dma_chunked_scan, the forced ring of the card tests and the sweep). The fill is
// 16-byte cp.async.cg, eight lanes a tile row, where D % 4 == 0 and the
// operands are 16-byte aligned, else 4-byte cp.async, a lane its column.
// Hopper's 1-D bulk copy (cp.async.bulk on an mbarrier) is not used: a
// tile's rows are D apart, so each 128-byte row would be a bulk request of
// its own, too small to pay for the TMA unit's per-request cost; on the
// H100 it lost to this ring at every path shape. h, da and db are stored
// from registers, a warp's 32 lanes one 128-byte line a step. L is not
// split: each lane applies h = fmaf(a, h, b) to its column in t order from
// h = 0 (the reverse: G in t order downwards from 0), so every ring gives
// the same bits and linear_scan_staged's h is bitwise linear_scan's; at the
// paths' fewest columns (config 5's 6,144) the tiles still fill the card.
#include <stdint.h>

#include "common.cuh"

namespace accunet {
namespace {

constexpr int kCols = 32;  // columns of a CTA: one warp

struct Ring {
  int chunk, nbuf;  // tile rows a slot, slots
};
constexpr Ring kFwdRing{64, 3};  // a, b: 16 KB a slot
constexpr Ring kRevRing{48, 3};  // a, g, h[t-1]: 18 KB a slot

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Forward: b is b, out is h (hf, da unused). Reverse: b is g, hf the
// forward's h, out is db = G and da = G * h[t-1]. Grid B * ceil(D / 32);
// shared memory [NBUF][operand][chunk][32] floats. VEC16: D % 4 == 0 and
// 16-byte aligned operands, so a tile row is whole 16-byte pieces.
template <bool REVERSE, int NBUF, bool VEC16>
__global__ void __launch_bounds__(kCols)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ hf, float* __restrict__ out,
                   float* __restrict__ da, int L, int D, int chunk) {
  constexpr int kOps = REVERSE ? 3 : 2;
  constexpr int kPieces = kCols / 4;  // 16-byte pieces in a tile row
  float* smem = shared_floats();
  const int lane = threadIdx.x;
  const int tiles = (D + kCols - 1) / kCols;
  const int d0 = static_cast<int>(blockIdx.x % tiles) * kCols;
  const int ncols = min(kCols, D - d0);
  const long long base = static_cast<long long>(blockIdx.x / tiles) * L * D + d0;
  const int tile = chunk * kCols;  // floats of one operand in a slot
  const int nchunks = (L + chunk - 1) / chunk;

  // chunk c of the walk covers rows [t0, t0 + n): forward from t = 0 up,
  // reverse from the top down (its first chunk is the partial one)
  auto rows_of = [&](int c, int& t0, int& n) {
    t0 = (REVERSE ? nchunks - 1 - c : c) * chunk;
    n = min(chunk, L - t0);
  };

  // chunk c's rows of every operand into slot c % NBUF, as one commit group
  // (an empty group past the last chunk keeps the group count uniform); the
  // reverse's third operand is h a row down (slot row r holds h[t0 + r - 1];
  // none at t = 0)
  auto issue = [&](int c) {
    if (c < nchunks) {
      int t0, n;
      rows_of(c, t0, n);
      float* sa = smem + (c % NBUF) * kOps * tile;
      if constexpr (VEC16) {
        for (int p = lane; p < n * kPieces; p += kCols) {
          const int r = p / kPieces, q = (p % kPieces) * 4;
          if (q < ncols) {
            const long long o = base + static_cast<long long>(t0 + r) * D + q;
            float* s = sa + r * kCols + q;
            cp_async16(s, a + o);
            cp_async16(s + tile, b + o);
            if (REVERSE && t0 + r > 0) cp_async16(s + 2 * tile, hf + o - D);
          }
        }
      } else if (lane < ncols) {
        for (int r = 0; r < n; ++r) {
          const long long o = base + static_cast<long long>(t0 + r) * D + lane;
          float* s = sa + r * kCols + lane;
          cp_async4(s, a + o);
          cp_async4(s + tile, b + o);
          if (REVERSE && t0 + r > 0) cp_async4(s + 2 * tile, hf + o - D);
        }
      }
    }
    cp_async_commit();
  };

  for (int c = 0; c < NBUF - 1; ++c) issue(c);
  float h = 0.f, a_next = 1.f;  // a_next: a[t+1] of the reverse walk
  for (int c = 0; c < nchunks; ++c) {
    issue(c + NBUF - 1);        // into the slot that chunk c-1 freed
    cp_async_wait<NBUF - 1>();  // chunk c's group has landed
    __syncthreads();
    int t0, n;
    rows_of(c, t0, n);
    float* sa = smem + (c % NBUF) * kOps * tile + lane;
    const float* sb = sa + tile;
    if (lane < ncols) {
      const long long o = base + static_cast<long long>(t0) * D + lane;
      if constexpr (REVERSE) {
        float* sh = sa + 2 * tile;
        if (t0 == 0) sh[0] = 0.f;  // h[-1], a row no copy fills
        float* odb = out + o + static_cast<long long>(n - 1) * D;
        float* oda = da + o + static_cast<long long>(n - 1) * D;
#pragma unroll 8
        for (int r = n - 1; r >= 0; --r) {
          h = fmaf(a_next, h, sb[r * kCols]);
          *odb = h;
          *oda = h * sh[r * kCols];
          a_next = sa[r * kCols];
          odb -= D;
          oda -= D;
        }
      } else {
        float* oh = out + o;
#pragma unroll 8
        for (int r = 0; r < n; ++r) {
          h = fmaf(sa[r * kCols], h, sb[r * kCols]);
          *oh = h;
          oh += D;
        }
      }
    }
    __syncthreads();  // slot c % NBUF is refilled in iteration c + 1
  }
  cp_async_wait<0>();
}

template <bool REVERSE, int NBUF, bool VEC16>
int launch_kernel(const float* a, const float* b, const float* hf, float* out, float* da, int B,
                  int L, int D, int chunk, size_t smem, cudaStream_t stream) {
  cudaError_t err = allow_smem(linear_scan_kernel<REVERSE, NBUF, VEC16>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  linear_scan_kernel<REVERSE, NBUF, VEC16><<<B * ceil_div(D, kCols), kCols, smem, stream>>>(
      a, b, hf, out, da, L, D, chunk);
  return static_cast<int>(cudaGetLastError());
}

// the scan at a ring of NBUF slots of `chunk` rows; hf and da null for the
// forward
template <bool REVERSE, int NBUF>
int launch(const void* a, const void* b, const void* hf, void* out, void* da, int B, int L,
           int D, int chunk, void* stream) {
  if (B <= 0 || L <= 0 || D <= 0 || chunk <= 0 ||
      static_cast<long long>(B) * D >= (1LL << 31))
    return -1;
  const size_t smem = static_cast<size_t>(NBUF) * (REVERSE ? 3 : 2) * chunk * kCols *
                      sizeof(float);
  if (smem > 232448) return -1;  // the dynamic shared memory a block may use
  const uintptr_t p = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                      reinterpret_cast<uintptr_t>(hf);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* hff = static_cast<const float*>(hf);
  float* of = static_cast<float*>(out);
  float* df = static_cast<float*>(da);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D % 4 == 0 && p % 16 == 0
             ? launch_kernel<REVERSE, NBUF, true>(af, bf, hff, of, df, B, L, D, chunk, smem, s)
             : launch_kernel<REVERSE, NBUF, false>(af, bf, hff, of, df, B, L, D, chunk, smem, s);
}

}  // namespace
}  // namespace accunet

// a, b, h (B, L, D) fp32 contiguous.
extern "C" int accunet_linear_scan(const void* a, const void* b, void* h, int B, int L, int D,
                                   void* stream) {
  using namespace accunet;
  return launch<false, kFwdRing.nbuf>(a, b, nullptr, h, nullptr, B, L, D, kFwdRing.chunk,
                                      stream);
}

// a, h (the forward's output), g, da, db (B, L, D) fp32 contiguous.
extern "C" int accunet_linear_scan_reverse(const void* a, const void* h, const void* g, void* da,
                                           void* db, int B, int L, int D, void* stream) {
  using namespace accunet;
  return launch<true, kRevRing.nbuf>(a, g, h, db, da, B, L, D, kRevRing.chunk, stream);
}

// a, b, h (B, L, D) fp32 contiguous, 16-byte aligned, D % 4 == 0; chunk rows
// per ring slot, nbuf slots (2, 3 or 4).
extern "C" int accunet_linear_scan_staged(const void* a, const void* b, void* h, int B, int L,
                                          int D, int chunk, int nbuf, void* stream) {
  using namespace accunet;
  if (D % 4 != 0) return -1;
  if (nbuf == 2) return launch<false, 2>(a, b, nullptr, h, nullptr, B, L, D, chunk, stream);
  if (nbuf == 3) return launch<false, 3>(a, b, nullptr, h, nullptr, B, L, D, chunk, stream);
  if (nbuf == 4) return launch<false, 4>(a, b, nullptr, h, nullptr, B, L, D, chunk, stream);
  return -2;
}
