// First-order linear recurrence along L of contiguous (B, L, D) fp32 tensors:
//   linear_scan          h[t] = a[t] * h[t-1] + b[t]                (h[-1] = 0)
//   linear_scan_reverse  G[t] = g[t] + a[t+1] * G[t+1]              (G[L] = 0)
//                        db[t] = G[t], da[t] = G[t] * h[t-1]        (h[-1] = 0)
//   linear_scan_staged   h as linear_scan, through a cp.async ring in shared memory
// Replace the TPU kernels _chunked_scan_fwd / chunked_linear_scan
// (accunet_tpu/ops/pallas/scan.py:62 / :102, pallas_call :73; its backward
// :119-126 is the reverse form) and dma_chunked_scan
// (accunet_tpu/ops/pallas/scan_dma.py:114, pallas_call :130).
//
// What bounds them on the card: bytes. Each step is one FMA per 12 bytes
// moved (a and b read, h written; the reverse form moves 20), so the H100's
// 3.35 TB/s runs out long before its FMAs do.
//
// Design: the TPU kernels carry the state of a whole (CHUNK, D) block from
// one grid step to the next in VMEM and scan inside a chunk with log-depth
// passes. Here one thread owns one (b, d) column and walks L sequentially
// with h = fmaf(a, h, b) in fp32: the carry is a register, no pass is
// log-depth, and neighbouring threads take neighbouring d, so every step is
// one coalesced 128-byte load per warp of a and of b and one store of h.
// A column's walk is a chain of dependent FMAs, so the memory latency is
// hidden by keeping loads in flight ahead of the chain:
//   * linear_scan (REVERSE = false / true) loads the next kSteps steps into
//     registers before running the current kSteps' FMA chain;
//   * linear_scan_staged passes (chunk x 32-column) tiles of a and b through
//     an NBUF-deep ring in shared memory, filled by cp.async.cg with one
//     commit group per chunk and waited with wait_group NBUF-1, so the copies
//     run NBUF-1 chunks ahead of the walk (the async-copy ring of
//     scan_dma.py:60-104; h is stored from registers).
// Both walks apply the same fmaf to the same operands in the same order, so
// linear_scan_staged's h is bitwise equal to linear_scan's.
// Parallelism is one thread per column (B * D threads): at few columns and
// long L (SegMamba's stage 0: 12,288 columns, L = 12,544) the walk is bound
// by latency, not bandwidth; a chunk-parallel form (per-chunk products and
// local scans, a carry scan, a fix-up) is the way past that.
#include "common.cuh"

namespace accunet {
namespace {

constexpr int kScanThreads = 128;  // columns per CTA of linear_scan
constexpr int kSteps = 16;         // steps loaded ahead of the FMA chain
constexpr int kStageCols = 32;     // columns per CTA of linear_scan_staged: one warp

// the kSteps steps from step s0 of one column (step s is t = s, or t = L-1-s
// in reverse); past the end a = 1, b = 0, hp = 0. With REVERSE, hp[u] is
// h[t-1] (0 at t = 0).
template <bool REVERSE>
__device__ __forceinline__ void load_steps(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           const float* __restrict__ hf, long long col0, int s0,
                                           int L, int D, float (&ra)[kSteps],
                                           float (&rb)[kSteps], float (&rh)[kSteps]) {
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int s = s0 + u;
    ra[u] = 1.f;
    rb[u] = 0.f;
    rh[u] = 0.f;
    if (s < L) {
      const int t = REVERSE ? L - 1 - s : s;
      const long long o = col0 + static_cast<long long>(t) * D;
      ra[u] = __ldg(a + o);
      rb[u] = __ldg(b + o);
      if (REVERSE && t > 0) rh[u] = __ldg(hf + o - D);
    }
  }
}

// Forward: b is b, out is h. Reverse: b is g, hf is the forward h, out is
// db = G and da = G * h[t-1].
template <bool REVERSE>
__global__ void __launch_bounds__(kScanThreads)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ hf, float* __restrict__ out,
                   float* __restrict__ da, int B, int L, int D) {
  const long long col = static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  if (col >= static_cast<long long>(B) * D) return;  // no barrier in this kernel
  const long long bi = col / D, d = col % D;
  const long long col0 = bi * L * D + d;

  float ca[kSteps], cb[kSteps], ch[kSteps], na[kSteps], nb[kSteps], nh[kSteps];
  load_steps<REVERSE>(a, b, hf, col0, 0, L, D, ca, cb, ch);
  float h = 0.f, a_next = 1.f;  // a_next: a[t+1] of the reverse walk
  for (int s0 = 0; s0 < L; s0 += kSteps) {
    if (s0 + kSteps < L) load_steps<REVERSE>(a, b, hf, col0, s0 + kSteps, L, D, na, nb, nh);
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int s = s0 + u;
      if (s < L) {
        const long long o = col0 + static_cast<long long>(REVERSE ? L - 1 - s : s) * D;
        if (REVERSE) {
          h = fmaf(a_next, h, cb[u]);
          out[o] = h;
          da[o] = h * ch[u];
          a_next = ca[u];
        } else {
          h = fmaf(ca[u], h, cb[u]);
          out[o] = h;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
      ch[u] = nh[u];
    }
  }
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// grid (ceil(D / 32), B); shared memory [NBUF][a, b][chunk][32] floats.
// D % 4 == 0 and 16-byte aligned a, b (the wrapper checks), so a tile row is
// whole 16-byte pieces.
template <int NBUF>
__global__ void __launch_bounds__(kStageCols)
linear_scan_staged_kernel(const float* __restrict__ a, const float* __restrict__ b,
                          float* __restrict__ h, int L, int D, int chunk) {
  constexpr int kPieces = kStageCols / 4;  // 16-byte pieces in a tile row
  float* smem = shared_floats();
  const int lane = threadIdx.x;
  const int d0 = static_cast<int>(blockIdx.x) * kStageCols;
  const int ncols = min(kStageCols, D - d0);
  const long long base = static_cast<long long>(blockIdx.y) * L * D + d0;
  const int tile = chunk * kStageCols;
  const int nchunks = (L + chunk - 1) / chunk;

  // chunk c's rows of a and b into slot c % NBUF, as one commit group (an
  // empty group past the last chunk keeps the group count uniform)
  auto issue = [&](int c) {
    if (c < nchunks) {
      const int t0 = c * chunk, rows = min(chunk, L - t0);
      float* sa = smem + (c % NBUF) * 2 * tile;
      float* sb = sa + tile;
      for (int p = lane; p < rows * kPieces; p += kStageCols) {
        const int r = p / kPieces, q = (p % kPieces) * 4;
        if (q < ncols) {
          const long long o = base + static_cast<long long>(t0 + r) * D + q;
          cp_async16(sa + r * kStageCols + q, a + o);
          cp_async16(sb + r * kStageCols + q, b + o);
        }
      }
    }
    cp_async_commit();
  };

  for (int c = 0; c < NBUF - 1; ++c) issue(c);
  float hv = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    issue(c + NBUF - 1);  // into the slot that chunk c-1 freed
    cp_async_wait<NBUF - 1>();  // chunk c's group has landed
    __syncthreads();
    const float* sa = smem + (c % NBUF) * 2 * tile;
    const float* sb = sa + tile;
    const int t0 = c * chunk, rows = min(chunk, L - t0);
    if (lane < ncols) {
      float* out = h + base + static_cast<long long>(t0) * D + lane;
      for (int r = 0; r < rows; ++r) {
        hv = fmaf(sa[r * kStageCols + lane], hv, sb[r * kStageCols + lane]);
        out[static_cast<long long>(r) * D] = hv;
      }
    }
    __syncthreads();  // slot c % NBUF is refilled in iteration c + 1
  }
  cp_async_wait<0>();
}

template <int NBUF>
int launch_staged(const float* a, const float* b, float* h, int B, int L, int D, int chunk,
                  cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(NBUF) * 2 * chunk * kStageCols * sizeof(float);
  cudaError_t err = allow_smem(linear_scan_staged_kernel<NBUF>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ceil_div(D, kStageCols), B);
  linear_scan_staged_kernel<NBUF><<<grid, kStageCols, smem, stream>>>(a, b, h, L, D, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace accunet

// a, b, h (B, L, D) fp32 contiguous.
extern "C" int accunet_linear_scan(const void* a, const void* b, void* h, int B, int L, int D,
                                   void* stream) {
  using namespace accunet;
  if (B <= 0 || L <= 0 || D <= 0) return -1;
  const int cols = B * D;
  linear_scan_kernel<false><<<ceil_div(cols, kScanThreads), kScanThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), nullptr,
      static_cast<float*>(h), nullptr, B, L, D);
  return static_cast<int>(cudaGetLastError());
}

// a, h (the forward's output), g, da, db (B, L, D) fp32 contiguous.
extern "C" int accunet_linear_scan_reverse(const void* a, const void* h, const void* g, void* da,
                                           void* db, int B, int L, int D, void* stream) {
  using namespace accunet;
  if (B <= 0 || L <= 0 || D <= 0) return -1;
  const int cols = B * D;
  linear_scan_kernel<true><<<ceil_div(cols, kScanThreads), kScanThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(g), static_cast<const float*>(h),
      static_cast<float*>(db), static_cast<float*>(da), B, L, D);
  return static_cast<int>(cudaGetLastError());
}

// a, b, h (B, L, D) fp32 contiguous, 16-byte aligned, D % 4 == 0; chunk rows
// per ring slot, nbuf slots (2, 3 or 4).
extern "C" int accunet_linear_scan_staged(const void* a, const void* b, void* h, int B, int L,
                                          int D, int chunk, int nbuf, void* stream) {
  using namespace accunet;
  if (B <= 0 || L <= 0 || D <= 0 || D % 4 != 0 || chunk <= 0) return -1;
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* hf = static_cast<float*>(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbuf == 2) return launch_staged<2>(af, bf, hf, B, L, D, chunk, s);
  if (nbuf == 3) return launch_staged<3>(af, bf, hf, B, L, D, chunk, s);
  if (nbuf == 4) return launch_staged<4>(af, bf, hf, B, L, D, chunk, s);
  return -2;
}
