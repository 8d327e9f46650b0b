// The selective scan (Mamba's SSM recurrence) fused into one kernel forward
// and one backward, per (b, d, n, t) with h[-1] = 0, in fp32:
//   delta' = softplus(delta + bias) (or delta + bias)
//   a[t] = exp(delta'[t] A[d,n])   x[t] = delta'[t] u[t] B[n,t]   h[t] = a[t] h[t-1] + x[t]
//   y[t] = sum_n C[n,t] h[t] + D[d] u[t]                          out[t] = y[t] silu(z[t])
// The backward, with g = d out, gy = g silu(z) and
//   G[t] = gy[t] C[n,t] + a[t+1] G[t+1]   (G[L] = 0; the last state's cotangent enters at L-1),
// writes du, ddelta, dz (B, D, L), dB, dC (B, N, L) and dA (D, N), dD, dbias (D,).
// Replace the TPU kernel _chunked_scan_fwd / chunked_linear_scan
// (accunet_tpu/ops/pallas/scan.py:62 / :102, pallas_call :73; its backward
// :119-126) together with the glue of accunet_tpu/ops/selective_scan.py:61-97
// around it (exp, the products with B and u, the contraction with C, D, silu).
//
// What bounds them on the card: the function needs only its inputs and its
// outputs, u, delta, z (B, D, L) and B, C (B, N, L) in, out (B, D, L) out
// (the backward adds g in and six gradients out), so neither kernel writes a
// (B, L, D, N) tensor: a, x, h and G live in registers. Per (t, n) the work is
// a few FMAs and one exp2 on the SFUs (two in the backward), so the kernels
// sit near the ridge between bytes and operations.
//
// Design:
//   * a warp owns one (b, d) at a time and walks L in chunks of 32 * K steps
//     (K = 2, 4 or 8, the fewest covering L, so a short L leaves few lanes
//     idle; 16 for L > 4096, where fewer, longer runs halve the shuffles and
//     barriers a step); lane i scans steps [iK, iK+K) of the chunk in
//     registers;
//   * per state n, each lane reduces its run to a transform h -> pa h + pb,
//     a warp-shuffle scan (__shfl_up_sync; __shfl_down_sync for the reverse
//     G walk) joins the lanes, the carry from the previous chunk enters per
//     n, and the lane re-walks its run with its prefix: y accumulates over n
//     in registers, so h is never stored;
//   * a CTA holds 8 d of one b, and B and C of the chunk are staged once per
//     CTA in shared memory by cp.async (the forward copies chunk c + 1 while
//     it scans chunk c; a lane reads its run at stride K+1, free of bank
//     conflicts); the forward scans two states at a time so that their
//     shuffle chains overlap (more states, or more in the backward, cost
//     more in occupancy than they gain: tools/selective_scan_sweep.py);
//   * the forward writes the state entering each chunk, (B, D, n_chunks, N),
//     when asked; the backward walks the chunks last first, recomputes h from
//     that state and runs G in reverse within the chunk with the carry from
//     the chunk after it;
//   * reductions in a fixed order, no atomics: dB and dC (sums over d) go
//     through shared memory warp by warp, state by state, into partials per
//     CTA of 8 d that a second small launch sums in block order; dA, dD and
//     dbias are summed per lane over the chunk, over the lanes by a fixed
//     shuffle tree, over the chunks in order, and over b by the second
//     launch. (A warp taking several d in turn, for fewer partials, and two
//     states per barrier both measured slower: PERF.md section 6.)
// Operands are contiguous fp32 (the wrapper copies strided views, such as
// BiMamba's transposed delta, z, B and C, once).
#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace accunet {
namespace {

namespace cg = cooperative_groups;

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
// tools/selective_scan_sweep.py times other values of kFwdStates
constexpr int kFwdWarps = 8;   // d per CTA of the forward
constexpr int kBwdWarps = 8;   // d per CTA and pass of the backward
constexpr int kFwdStates = 2;  // states the forward scans at once (their chains interleave)
constexpr float kLog2e = 1.4426950408889634f;

struct Scan {
  const float* __restrict__ u;
  const float* __restrict__ delta;
  const float* __restrict__ A;     // (D, N)
  const float* __restrict__ Bm;    // (B, N, L)
  const float* __restrict__ Cm;    // (B, N, L)
  const float* __restrict__ Dv;    // (D,) or null
  const float* __restrict__ z;     // (B, D, L) or null
  const float* __restrict__ bias;  // (D,) or null
  int nb, nd, L, ns, softplus;
};

// a chunk step j of a lane's run sits at j + j / K in a staged row
template <int K>
__device__ __forceinline__ int pad(int j) { return j + j / K; }

__device__ __forceinline__ float softplus(float v) { return v > 20.f ? v : log1pf(expf(v)); }
__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// inclusive scans over lanes 0..lane of M states' transforms h -> pa h + pb,
// side by side (their shuffle latencies overlap)
template <int M>
__device__ __forceinline__ void scan_up(float (&pa)[M], float (&pb)[M], int lane) {
#pragma unroll
  for (int off = 1; off < kLanes; off *= 2) {
    float a1[M], b1[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      a1[j] = __shfl_up_sync(kFull, pa[j], off);
      b1[j] = __shfl_up_sync(kFull, pb[j], off);
    }
    if (lane >= off) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        pb[j] = fmaf(pa[j], b1[j], pb[j]);
        pa[j] *= a1[j];
      }
    }
  }
}

// inclusive scans over lanes lane..31 (the reverse walk's order)
template <int M>
__device__ __forceinline__ void scan_down(float (&pa)[M], float (&pb)[M], int lane) {
#pragma unroll
  for (int off = 1; off < kLanes; off *= 2) {
    float a2[M], b2[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      a2[j] = __shfl_down_sync(kFull, pa[j], off);
      b2[j] = __shfl_down_sync(kFull, pb[j], off);
    }
    if (lane + off < kLanes) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        pb[j] = fmaf(pa[j], b2[j], pb[j]);
        pa[j] *= a2[j];
      }
    }
  }
}

// sum over the warp's lanes by a fixed xor tree (every lane gets the sum)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying B and C of batch b, steps [t0, t0 + 32K), into sB, sC
// [N][32(K+1)] (cp.async, so every copy is in flight at once; 0 past L).
template <int K>
__device__ __forceinline__ void stage_bc(const Scan& s, int b, int t0, float* sB, float* sC) {
  constexpr int kChunk = kLanes * K, kRow = kLanes * (K + 1);
  const long long base = static_cast<long long>(b) * s.ns * s.L;
  for (int e = threadIdx.x; e < s.ns * kChunk; e += blockDim.x) {
    const int n = e / kChunk, j = e % kChunk, t = t0 + j;
    const long long o = base + static_cast<long long>(n) * s.L + t;
    float* db = sB + n * kRow + pad<K>(j);
    float* dc = sC + n * kRow + pad<K>(j);
    if (t < s.L) {
      cp_async4(db, s.Bm + o);
      cp_async4(dc, s.Cm + o);
    } else {
      *db = *dc = 0.f;
    }
  }
}

// The raw operands of the lane's K steps of row (b, d) from t0 (0 past L).
template <int K>
__device__ __forceinline__ void load_raw(const Scan& s, long long row, int t0, float (&u)[K],
                                         float (&dr)[K], float (&zr)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = t0 + k;
    const bool in = t < s.L;
    u[k] = in ? __ldg(s.u + row + t) : 0.f;
    dr[k] = in ? __ldg(s.delta + row + t) : 0.f;
    zr[k] = in && s.z ? __ldg(s.z + row + t) : 0.f;
  }
}

// The lane's K steps of row (b, d) from t0: u, delta' and delta' u, with
// u = delta' = 0 past L (so a = 1, x = 0: the scan's identity).
template <int K>
__device__ __forceinline__ void load_run(const Scan& s, long long row, int d, int t0,
                                         float (&u)[K], float (&dl)[K], float (&du)[K]) {
  const float bias = s.bias ? __ldg(s.bias + d) : 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = t0 + k;
    u[k] = dl[k] = 0.f;
    if (t < s.L) {
      u[k] = __ldg(s.u + row + t);
      const float v = __ldg(s.delta + row + t) + bias;
      dl[k] = s.softplus ? softplus(v) : v;
    }
    du[k] = dl[k] * u[k];
  }
}

// grid (ceil(D / kFwdWarps), B); shared: two buffers of [N][32(K+1)] B and
// C (chunk c + 1 is copied while chunk c is scanned), then [warps][N] A
// log2(e) and the carries.
template <int K>
__global__ void __launch_bounds__(kFwdWarps * kLanes)
selective_scan_fwd_kernel(const Scan s, float* __restrict__ out, float* __restrict__ last,
                          float* __restrict__ states) {
  constexpr int kChunk = kLanes * K, kRow = kLanes * (K + 1);
  float* bufs = shared_floats();  // [2][B, C][N][kRow]
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  float* sA = bufs + 4 * s.ns * kRow + warp * s.ns;
  float* sH = bufs + 4 * s.ns * kRow + (kFwdWarps + warp) * s.ns;
  const int b = blockIdx.y, d = blockIdx.x * kFwdWarps + warp;
  const bool live = d < s.nd;
  const int nchunks = (s.L + kChunk - 1) / kChunk;
  const long long row = (static_cast<long long>(b) * s.nd + d) * s.L;
  const long long srow = (static_cast<long long>(b) * s.nd + d) * nchunks;
  if (live) {
    for (int n = lane; n < s.ns; n += kLanes) {
      sA[n] = __ldg(s.A + static_cast<long long>(d) * s.ns + n) * kLog2e;
      sH[n] = 0.f;
    }
  }
  const float dd = live && s.Dv ? __ldg(s.Dv + d) : 0.f;
  const float bias = live && s.bias ? __ldg(s.bias + d) : 0.f;
  // the lane's raw u, delta, z, loaded a chunk ahead of their use
  float ru[K], rd[K], rz[K];
  if (live) load_raw<K>(s, row, lane * K, ru, rd, rz);
  stage_bc<K>(s, b, 0, bufs, bufs + s.ns * kRow);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * kChunk, tl = t0 + lane * K;
    const float* sB = bufs + (c & 1) * 2 * s.ns * kRow;
    const float* sC = sB + s.ns * kRow;
    if (c + 1 < nchunks) {
      float* nb = bufs + ((c + 1) & 1) * 2 * s.ns * kRow;
      stage_bc<K>(s, b, t0 + kChunk, nb, nb + s.ns * kRow);
    }
    cp_async_commit();  // (an empty group past the last chunk)
    cp_async_wait<1>();  // chunk c's copies have landed
    __syncthreads();
    if (live) {
      float u[K], dl[K], du[K], z[K], y[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        u[k] = ru[k];
        z[k] = rz[k];
        dl[k] = tl + k < s.L ? (s.softplus ? softplus(rd[k] + bias) : rd[k] + bias) : 0.f;
        du[k] = dl[k] * u[k];
        y[k] = dd * u[k];
      }
      if (c + 1 < nchunks) load_raw<K>(s, row, tl + kChunk, ru, rd, rz);
      // kFwdStates states at a time; past N a state is repeated, not used
      for (int n0 = 0; n0 < s.ns; n0 += kFwdStates) {
        float a[kFwdStates][K], x[kFwdStates][K], pa[kFwdStates], pb[kFwdStates];
        float carry[kFwdStates];
#pragma unroll
        for (int j = 0; j < kFwdStates; ++j) {
          const int n = min(n0 + j, s.ns - 1);
          const float a2 = sA[n];
          const float* bn = sB + n * kRow + lane * (K + 1);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            a[j][k] = exp2f(dl[k] * a2);
            x[j][k] = du[k] * bn[k];
          }
          pa[j] = a[j][0];
          pb[j] = x[j][0];
#pragma unroll
          for (int k = 1; k < K; ++k) {
            pb[j] = fmaf(a[j][k], pb[j], x[j][k]);
            pa[j] *= a[j][k];
          }
          carry[j] = sH[n];
        }
        scan_up(pa, pb, lane);
        float ta[kFwdStates], tb[kFwdStates];
#pragma unroll
        for (int j = 0; j < kFwdStates; ++j) {
          const float ea = __shfl_up_sync(kFull, pa[j], 1), eb = __shfl_up_sync(kFull, pb[j], 1);
          ta[j] = __shfl_sync(kFull, pa[j], kLanes - 1);
          tb[j] = __shfl_sync(kFull, pb[j], kLanes - 1);
          if (n0 + j < s.ns) {
            const float* cn = sC + (n0 + j) * kRow + lane * (K + 1);
            float h = lane == 0 ? carry[j] : fmaf(ea, carry[j], eb);
#pragma unroll
            for (int k = 0; k < K; ++k) {
              h = fmaf(a[j][k], h, x[j][k]);
              y[k] = fmaf(cn[k], h, y[k]);
            }
          }
        }
        __syncwarp();  // every lane has read sH
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < kFwdStates; ++j) {
            const int n = n0 + j;
            if (n < s.ns) {
              if (states) states[(srow + c) * s.ns + n] = carry[j];
              sH[n] = fmaf(ta[j], carry[j], tb[j]);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int t = tl + k;
        if (t < s.L) out[row + t] = s.z ? y[k] * z[k] * sigmoid(z[k]) : y[k];
      }
    }
    __syncthreads();  // this buffer is refilled for chunk c + 2
  }
  cp_async_wait<0>();
  __syncwarp();
  if (live)
    for (int n = lane; n < s.ns; n += kLanes)
      last[(static_cast<long long>(b) * s.nd + d) * s.ns + n] = sH[n];
}

struct Grads {
  const float* __restrict__ states;  // (B, D, n_chunks, N)
  const float* __restrict__ g;       // (B, D, L)
  const float* __restrict__ g_last;  // (B, D, N) or null
  float* __restrict__ du;
  float* __restrict__ ddelta;
  float* __restrict__ dz;        // or null
  float* __restrict__ part_b;    // (blocks, B, N, L): dB summed over a d-block
  float* __restrict__ part_c;    // (blocks, B, N, L): dC
  float* __restrict__ part_bd;   // (B, D, N + 2): dA, dD, dbias summed over t
};

// grid (d-blocks of kBwdWarps d, B). Shared: B, C [N][32(K+1)]; two buffers
// of the warps' dB / dC contributions [warps][2][32(K+1)], taken in turn by
// the states (so one barrier a state separates a state's writes from its
// reads, and its reads from the writes two states on); per warp the chunk's
// saved states [N], the G carries [N], dA [N], A [N], dD and dbias.
template <int K>
__global__ void __launch_bounds__(kBwdWarps * kLanes)
selective_scan_bwd_kernel(const Scan s, const Grads p) {
  constexpr int kChunk = kLanes * K, kRow = kLanes * (K + 1);
  constexpr int kRed = kBwdWarps * 2 * kRow;
  float* sB = shared_floats();
  float* sC = sB + s.ns * kRow;
  float* reds = sC + s.ns * kRow;
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  float* sS = reds + 2 * kRed + warp * (4 * s.ns + 2);
  float* gcar = sS + s.ns;       // G carries: a[t+1] G[t+1] entering the chunk's last step
  float* dA = gcar + s.ns;
  float* sA = dA + s.ns;
  float* dDb = sA + s.ns;        // dD, dbias
  const int b = blockIdx.y, dblk = blockIdx.x;
  const int d = dblk * kBwdWarps + warp;
  const bool live = d < s.nd;
  const int nchunks = (s.L + kChunk - 1) / kChunk;
  const long long row = (static_cast<long long>(b) * s.nd + (live ? d : 0)) * s.L;
  const long long srow = (static_cast<long long>(b) * s.nd + d) * nchunks;
  const float dd = live && s.Dv ? __ldg(s.Dv + d) : 0.f;
  const float bias = live && s.bias ? __ldg(s.bias + d) : 0.f;
  if (live) {
    for (int n = lane; n < s.ns; n += kLanes) {
      gcar[n] = p.g_last ? __ldg(p.g_last + (static_cast<long long>(b) * s.nd + d) * s.ns + n) : 0.f;
      dA[n] = 0.f;
      sA[n] = __ldg(s.A + static_cast<long long>(d) * s.ns + n);
    }
    if (lane < 2) dDb[lane] = 0.f;
  }
  float* red = reds;

  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, tl = t0 + lane * K;
    __syncthreads();  // the previous chunk's reads of shared memory are done
    stage_bc<K>(s, b, t0, sB, sC);
    if (live)
      for (int n = lane; n < s.ns; n += kLanes) cp_async4(sS + n, p.states + (srow + c) * s.ns + n);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float u[K], dl[K], du[K], gy[K], yacc[K], ddacc[K], duacc[K];
    if (live) {
      load_run<K>(s, row, d, tl, u, dl, du);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int t = tl + k;
        gy[k] = 0.f;
        if (t < s.L) {
          gy[k] = __ldg(p.g + row + t);
          if (s.z) {
            const float zz = __ldg(s.z + row + t);
            gy[k] *= zz * sigmoid(zz);
          }
        }
        yacc[k] = ddacc[k] = duacc[k] = 0.f;
      }
    }
    for (int n = 0; n < s.ns; ++n) {
      red = red == reds ? reds + kRed : reds;
      float* rb = red + warp * 2 * kRow + lane * (K + 1);  // dB contributions
      float* rc = rb + kRow;                                  // dC
      if (live) {
        const float an = sA[n], a2 = an * kLog2e;
        const float* bn = sB + n * kRow + lane * (K + 1);
        const float* cn = sC + n * kRow + lane * (K + 1);
        // h over the lanes' runs from the chunk's saved state, as the forward
        float a[K], hp[K];
        float pa[1], pb[1];
#pragma unroll
        for (int k = 0; k < K; ++k) a[k] = exp2f(dl[k] * a2);
        pa[0] = a[0];
        pb[0] = du[0] * bn[0];
#pragma unroll
        for (int k = 1; k < K; ++k) {
          pb[0] = fmaf(a[k], pb[0], du[k] * bn[k]);
          pa[0] *= a[k];
        }
        scan_up(pa, pb, lane);
        const float carry = sS[n];
        float ea = __shfl_up_sync(kFull, pa[0], 1), eb = __shfl_up_sync(kFull, pb[0], 1);
        float h = lane == 0 ? carry : fmaf(ea, carry, eb);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          hp[k] = h;
          h = fmaf(a[k], h, du[k] * bn[k]);
          yacc[k] = fmaf(cn[k], h, yacc[k]);
          rc[k] = gy[k] * h;
        }
        // G over the runs, last step first: G[t] = alpha[t] G[t+1] + beta[t],
        // alpha[t] = a[t+1] (the next lane's first a across lanes; 1 for the
        // chunk's last lane, whose successor is folded into the carry)
        const float a_next = __shfl_down_sync(kFull, a[0], 1);
        const float alast = lane == kLanes - 1 ? 1.f : a_next;
        pa[0] = alast;
        pb[0] = gy[K - 1] * cn[K - 1];
#pragma unroll
        for (int k = K - 2; k >= 0; --k) {
          pb[0] = fmaf(a[k + 1], pb[0], gy[k] * cn[k]);
          pa[0] *= a[k + 1];
        }
        scan_down(pa, pb, lane);
        const float gc = gcar[n];
        ea = __shfl_down_sync(kFull, pa[0], 1);
        eb = __shfl_down_sync(kFull, pb[0], 1);
        float G = lane == kLanes - 1 ? gc : fmaf(ea, gc, eb);
        float da = 0.f;
#pragma unroll
        for (int k = K - 1; k >= 0; --k) {
          G = fmaf(k == K - 1 ? alast : a[k + 1], G, gy[k] * cn[k]);
          const float gha = G * hp[k] * a[k];
          ddacc[k] = fmaf(gha, an, fmaf(G * u[k], bn[k], ddacc[k]));
          duacc[k] = fmaf(G * dl[k], bn[k], duacc[k]);
          da = fmaf(gha, dl[k], da);
          rb[k] = G * du[k];
        }
        const float g_first = __shfl_sync(kFull, a[0] * G, 0);  // a[t0] G[t0]
        da = warp_sum(da);
        __syncwarp();  // every lane has read gcar[n]
        if (lane == 0) {
          gcar[n] = g_first;
          dA[n] += da;
        }
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) rb[k] = rc[k] = 0.f;
      }
      __syncthreads();  // this state's contributions are in (and the last state's read)
      // dB and dC of state n: the warps' contributions summed in order
      for (int e = threadIdx.x; e < 2 * kChunk; e += blockDim.x) {
        const int q = e / kChunk, jj = e % kChunk, t = t0 + jj;
        if (t >= s.L) continue;
        float sum = 0.f;
        for (int w = 0; w < kBwdWarps; ++w) sum += red[(w * 2 + q) * kRow + pad<K>(jj)];
        (q ? p.part_c : p.part_b)[((static_cast<long long>(dblk) * s.nb + b) * s.ns + n) * s.L + t] =
            sum;
      }
    }
    if (!live) continue;  // no barrier below in this iteration
    float sd = 0.f, sb = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = tl + k;
      if (t >= s.L) continue;
      if (s.z) {
        const float zz = __ldg(s.z + row + t), sg = sigmoid(zz);
        p.dz[row + t] = __ldg(p.g + row + t) * fmaf(dd, u[k], yacc[k]) * sg *
                        fmaf(zz, 1.f - sg, 1.f);
      }
      p.du[row + t] = fmaf(gy[k], dd, duacc[k]);
      float ddl = ddacc[k];
      if (s.softplus) ddl *= sigmoid(__ldg(s.delta + row + t) + bias);
      p.ddelta[row + t] = ddl;
      sd = fmaf(gy[k], u[k], sd);
      sb += ddl;
    }
    sd = warp_sum(sd);
    sb = warp_sum(sb);
    if (lane == 0) {
      dDb[0] += sd;
      dDb[1] += sb;
    }
  }
  __syncwarp();
  if (live) {
    float* o = p.part_bd + (static_cast<long long>(b) * s.nd + d) * (s.ns + 2);
    for (int n = lane; n < s.ns; n += kLanes) o[n] = dA[n];
    if (lane < 2) o[s.ns + lane] = dDb[lane];
  }
}

// dB, dC summed over the d-blocks (when there are several) and dA, dD,
// dbias over b, each in order.
__global__ void selective_scan_bwd_reduce_kernel(const Scan s, const Grads p, int blocks,
                                                 float* __restrict__ dA, float* __restrict__ dB,
                                                 float* __restrict__ dC, float* __restrict__ dD,
                                                 float* __restrict__ dbias) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long bnl = static_cast<long long>(s.nb) * s.ns * s.L;
  if (blocks > 1 && i < bnl) {
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < blocks; ++k) {
      sb += p.part_b[k * bnl + i];
      if (dC) sc += p.part_c[k * bnl + i];
    }
    dB[i] = sb;
    if (dC) dC[i] = sc;  // (the return-hidden backward has no C)
  }
  const int stride = s.ns + 2;
  if (i < static_cast<long long>(s.nd) * stride) {
    const int d = static_cast<int>(i / stride), n = static_cast<int>(i % stride);
    float sum = 0.f;
    for (int b = 0; b < s.nb; ++b) sum += p.part_bd[(static_cast<long long>(b) * s.nd + d) * stride + n];
    if (n < s.ns) dA[static_cast<long long>(d) * s.ns + n] = sum;
    else if (n == s.ns && dD) dD[d] = sum;
    else if (n == s.ns + 1 && dbias) dbias[d] = sum;
  }
}

// ------------------------------------------------------------ return-hidden
// The return-hidden selective scan (Spatial-Mamba's StructureAwareSSM): the
// recurrence above without C, D and z, every h[t] written, as (B, L, D, N):
// at step t the (d, n) values of one b are one run of D*N floats, the NHWC
// map of D*N channels (channel d*N + n) that the caller fuses next. With gh
// the cotangent of h in that layout, the backward computes
//   G[t] = gh[t] + a[t+1] G[t+1]   (G[L] = 0)
//   du = sum_n G delta' B     ddelta' = sum_n G (h[t-1] a A + u B)     dB = sum_d G delta' u
//   dA = sum_{b,t} G h[t-1] a delta'     dbias = sum_{b,t} ddelta
// (the backward above with gy C replaced by gh, and no dC, dD, dz).
// Replace chunked_linear_scan (accunet_tpu/ops/pallas/scan.py:102, pallas_call
// :73; its backward :119-126) with the glue of selective_scan_rh
// (accunet_tpu/ops/selective_scan.py:100-117) around it.
//
// What bounds them: h. The forward reads u, delta (B, D, L) and B (B, N, L)
// and writes h, N times the bytes of u (616.6 MB at the Spatial-Mamba
// variant's stage 0); the backward reads gh and writes du, ddelta, dB.
// Neither reads h back: the backward recomputes it from the state the
// forward saved at the start of each chunk of 128 steps. Per (t, n) the
// forward does one exp2 and a few FMAs, the backward three exp2 (a is
// recomputed rather than kept in registers) and some twenty operations with
// the sums over n and d; with enough warps in flight the forward is
// bytes-bound, the backward bound by its instructions, registers and the
// latency of its chunk's chain of barriers.
//
// Design: a thread owns one (b, d, n) chain and scans its steps in
// registers, with no shuffles in the scan. Lane q of each warp holds the
// chain (d0 + q / NP, q % NP), NP = N rounded up to a power of 2 (at least
// 4), so a CTA holds DC = 32 / NP d (2 at N 16) and, at every step, the
// warp's 32 chains are one aligned run of h: each store of h (load of a
// (B, L, D, N) gh) is one whole 128-byte line, and the forward stores h
// straight from registers as it rescans (a store does not stall the
// thread, so h drains while the next chunk is scanned; no shared tile, no
// transposition, no division). The W warps of a CTA split each chunk in
// time (RhPlan): warp w scans steps [w T, (w + 1) T) into the transform
// h -> pa h + pb, the warps trade transforms through shared memory (one
// barrier), and each thread folds its predecessors' onto the chunk's carry
// in warp order and rescans its steps from there: 3,072 warps at stage 0
// (a warp per (b, d) made 768), in 384 CTAs. delta' and delta' u are made once per
// (d, t) as a chunk is staged; u, delta and B are copied by cp.async two
// chunks ahead.
// The backward walks the chunks last first with the same split: h is
// rescanned from the chunk's saved state, and G runs in reverse with its
// carry (a[t+1] G[t+1] entering a warp's last step) folded over the warps
// to its right. gh of either layout is staged in shared memory (a (B, D,
// N, L) gh, the layout the model hands over, has each chain's steps
// contiguous); a lane off the tensor reads rows no copy writes, zeroed, so
// nothing needs masking. The sums over n (du, ddelta) and over the CTA's d
// (dB) are warp-shuffle reduce-scatters, which need no barrier. For N > 4
// dB is summed over the d of a cluster of 4 CTAs through distributed shared
// memory: each CTA arrives at the cluster barrier when its chunk's dB is in
// (after which it issues its global stores: an arrival releases the
// thread's earlier memory operations) and waits a chunk later, after its
// next chunk's transforms, so that the cluster's CTAs do not wait on each
// other. The dB partials are per 8 d at N 16 (77 MB at stage 0), and a
// second small launch sums them, and dA and dbias over b, in order. Every
// sum has a fixed order: no atomics, the same bits on a repeat and from
// either layout of gh.

// lanes per d: N rounded up to a power of 2, and at least 4 (so a CTA holds at
// most 8 d: a small N does not leave few CTAs each converting many d)
__host__ __device__ __forceinline__ int rh_lanes_per_d(int ns) {
  int p = 4;
  while (p < ns) p *= 2;
  return p;
}

// The split for N's lanes per d (NP): W warps, warp w scanning steps [w T,
// (w + 1) T) of each chunk of W T = 128 steps (the unit of staging and of
// the saved states), DC d a CTA (tools/selective_scan_sweep.py times other
// splits). N > 4: 8 warps of 16 steps; the backward in clusters of 4 CTAs
// (8 d a dB partial at N 16: the partials stay 77 MB at the Spatial-Mamba
// variant's stage 0) and 4 CTAs an SM, since 3 place only 92 clusters of 4
// at once (stage 0 needs 96). N <= 4 (NP 4, DC 8), whose few chains leave a
// CTA's chunks a chain of latencies: 16 warps of 8 steps, and no cluster
// (each CTA's dB partial, over 8 d, is a small tensor at such N).
template <int NP>
struct RhPlan {
  static constexpr int W = NP == 4 ? 16 : 8;
  static constexpr int T = NP == 4 ? 8 : 16;
  static constexpr int kChunk = W * T;
  static constexpr int kRow = kChunk + 4;   // floats of a staged row: 16-byte aligned, rows 4 banks apart
  static constexpr int kPRow = kChunk + 1;  // floats of a row of a CTA's dB partial
  static constexpr int kThreads = W * kLanes;
  static constexpr int DC = kLanes / NP;    // d of a CTA
  static constexpr int LNP = NP == 4 ? 2 : NP == 8 ? 3 : NP == 16 ? 4 : 5;
  static constexpr int kCluster = NP == 4 ? 1 : 4;  // CTAs (along d) of a backward cluster
  static constexpr int kBwdCtas = NP == 4 ? 1 : 4;  // backward CTAs an SM (at least)
};

__device__ __forceinline__ void cp_async16z(float* smem, const float* gmem, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4z(float* smem, const float* gmem, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem), "r"(bytes)
               : "memory");
}

// 2^x in one instruction, denormal results flushed to 0 (a = exp(delta' A)
// below 2^-126 is 0 to the scan; the rh kernels take it three times a (t, n))
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the two halves of a cluster barrier: arrive (releasing this thread's
// writes to shared memory) and wait (acquiring the cluster's)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address of p in the CTA of rank `rank` of the cluster
__device__ __forceinline__ unsigned cluster_peer(const float* p, int rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_cluster(unsigned addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Start copying steps [t0, t0 + kRhChunk) of `rows` rows (row r at src + r *
// stride) into dst (row r at dst + r * kRhRow), 0 past L: 16-byte copies when
// `vec` (L a multiple of 4 and 16-byte aligned operands), else 4-byte ones.
template <int NP>
__device__ __forceinline__ void rh_stage_rows(float* dst, const float* src, long long stride,
                                              int rows, int t0, int L, bool vec) {
  using P = RhPlan<NP>;
  constexpr int kRhChunk = P::kChunk, kRhRow = P::kRow, kRhThreads = P::kThreads;
  if (vec) {
    constexpr int kVecs = kRhChunk / 4;
    for (int e = threadIdx.x; e < rows * kVecs; e += kRhThreads) {
      const int r = e / kVecs, j = e % kVecs * 4, t = t0 + j;
      const int bytes = t < L ? 16 : 0;
      cp_async16z(dst + r * kRhRow + j, src + r * stride + (bytes ? t : 0), bytes);
    }
  } else {
    for (int e = threadIdx.x; e < rows * kRhChunk; e += kRhThreads) {
      const int r = e / kRhChunk, j = e % kRhChunk, t = t0 + j;
      const int bytes = t < L ? 4 : 0;
      cp_async4z(dst + r * kRhRow + j, src + r * stride + (bytes ? t : 0), bytes);
    }
  }
}

// Start copying the cotangent of the CTA's chains at steps [t0, t0 +
// kRhChunk) into sG, 0 past L. From a (B, D, N, L) gh each chain's steps are
// a row: sG [32 lanes][kRhRow], lane q's chain in row q (lanes off the
// tensor: nothing). From a (B, L, D, N) gh the chains' values at a step are
// one run of rows * N floats: sG [kRhChunk][32], chain (dl, n) at dl * N + n
// (past the run: nothing). A lane reads only its own chain's values.
template <int NP, bool kGhDnl>
__device__ __forceinline__ void rh_stage_gh(float* sG, const Scan& s, const float* gh, int b,
                                            int d0, int rows, int t0, bool vec) {
  using P = RhPlan<NP>;
  constexpr int LNP = P::LNP, LC = P::kChunk == 128 ? 7 : 8;
  constexpr int kRhChunk = P::kChunk, kRhRow = P::kRow, kRhThreads = P::kThreads;
  if (kGhDnl) {
    const float* src = gh + (static_cast<long long>(b) * s.nd + d0) * s.ns * s.L;
    if (vec) {
      for (int e = threadIdx.x; e < kLanes * kRhChunk / 4; e += kRhThreads) {
        const int q = e >> (LC - 2), j = (e & (kRhChunk / 4 - 1)) * 4, dl = q >> LNP,
                  n = q & (NP - 1), t = t0 + j;
        if (n >= s.ns || dl >= rows) continue;
        const float* g = src + static_cast<long long>(dl * s.ns + n) * s.L;
        cp_async16z(sG + q * kRhRow + j, g + (t < s.L ? t : 0), t < s.L ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < kLanes * kRhChunk; e += kRhThreads) {
        const int q = e >> LC, j = e & (kRhChunk - 1), dl = q >> LNP, n = q & (NP - 1), t = t0 + j;
        if (n >= s.ns || dl >= rows) continue;
        const float* g = src + static_cast<long long>(dl * s.ns + n) * s.L;
        cp_async4z(sG + q * kRhRow + j, g + (t < s.L ? t : 0), t < s.L ? 4 : 0);
      }
    }
  } else {
    const int run = rows * s.ns;
    const float* src = gh + (static_cast<long long>(b) * s.L * s.nd + d0) * s.ns;
    const long long step = static_cast<long long>(s.nd) * s.ns;
    if (vec && run % 4 == 0 && d0 * s.ns % 4 == 0) {
      for (int e = threadIdx.x; e < kRhChunk * kLanes / 4; e += kRhThreads) {
        const int j = e >> 3, o = (e & 7) * 4, t = t0 + j;
        if (o >= run) continue;
        cp_async16z(sG + j * kLanes + o, src + (t < s.L ? t * step + o : 0), t < s.L ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < kRhChunk * kLanes; e += kRhThreads) {
        const int j = e >> 5, o = e & 31, t = t0 + j;
        if (o >= run) continue;
        cp_async4z(sG + j * kLanes + o, src + (t < s.L ? t * step + o : 0), t < s.L ? 4 : 0);
      }
    }
  }
}

// delta' = softplus(delta + bias) (or delta + bias) and delta' u of the CTA's
// DC d at steps [t0, t0 + kRhChunk) from their staged raw rows (raw: delta
// then u, [2][DC][kRhRow]) into out [DC][kRhRow] each; with kBwd also u and
// sigmoid(delta + bias) (1 without the softplus). 0 past L and past D (a = 1,
// x = 0 there: the scan's identity).
template <int NP, bool kBwd>
__device__ __forceinline__ void rh_convert(const Scan& s, int d0, int t0, const float* raw,
                                           float* out) {
  using P = RhPlan<NP>;
  constexpr int DC = P::DC, kRhChunk = P::kChunk, kRhRow = P::kRow, kRhThreads = P::kThreads;
  constexpr int plane = DC * kRhRow;
  for (int e = threadIdx.x; e < DC * kRhChunk; e += kRhThreads) {
    const int r = e / kRhChunk, j = e % kRhChunk, d = d0 + r, o = r * kRhRow + j;
    const bool in = d < s.nd && t0 + j < s.L;
    const float v = in ? raw[o] + (s.bias ? __ldg(s.bias + d) : 0.f) : 0.f;
    const float u = in ? raw[plane + o] : 0.f;
    const float ev = expf(fminf(v, 20.f));  // softplus(v) = log1p(e^v), sigmoid(v) = e^v / (1 + e^v)
    const float dl = in ? (s.softplus ? (v > 20.f ? v : log1pf(ev)) : v) : 0.f;
    out[o] = dl;
    out[plane + o] = dl * u;
    if (kBwd) {
      out[2 * plane + o] = u;
      out[3 * plane + o] = s.softplus ? ev / (1.f + ev) : 1.f;
    }
  }
}

// A reduce-scatter over lanes lane ^ o, o = hi, hi / 2, ... (`levels` of them):
// at each level a lane keeps half of its values (the upper half when lane & o)
// and adds its partner's copy of that half; with one value left, both add and
// only the lower lane keeps ownership. After it the lane holds sums over the
// 2^levels lanes of values [idx, idx + T >> levels) (one value once levels >=
// log2 T) in v[..][0..), and owns them if `own`. K arrays go side by side.
template <int T, int K, int J = 0>
__device__ __forceinline__ void reduce_scatter(float (&v)[K][T], int lane, int hi, int levels,
                                               int& idx, bool& own) {
  if constexpr (J < 5) {
    if (J >= levels) return;
    const int o = hi >> J;
    const bool up = (lane & o) != 0;
    constexpr int h = T >> (J + 1);
    if constexpr (h > 0) {
#pragma unroll
      for (int i = 0; i < h; ++i) {
#pragma unroll
        for (int a = 0; a < K; ++a) {
          const float send = up ? v[a][i] : v[a][i + h];
          const float keep = up ? v[a][i + h] : v[a][i];
          v[a][i] = keep + __shfl_xor_sync(kFull, send, o);
        }
      }
      if (up) idx += h;
    } else {
#pragma unroll
      for (int a = 0; a < K; ++a) v[a][0] += __shfl_xor_sync(kFull, v[a][0], o);
      if (up) own = false;
    }
    reduce_scatter<T, K, J + 1>(v, lane, hi, levels, idx, own);
  }
}

// grid (ceil(D / DC), B), DC = 32 / NP, NP = rh_lanes_per_d(N); W warps.
// Shared: the chunk's delta', delta' u [2][DC][kRow]; the raw delta, u of
// the next two chunks [2][2][DC][kRow]; B of this chunk and the next two
// [3][N][kRow]; the warps' transforms [W][2][32]. A chunk's copies start
// two chunks ahead of it (so that a CTA alone on its SM does not wait for
// them) and it is converted while the chunk before it is rescanned.
template <int NP>
__global__ void __launch_bounds__(RhPlan<NP>::kThreads)
selective_scan_rh_fwd_kernel(const Scan s, float* __restrict__ hout, float* __restrict__ states,
                             int vec) {
  using P = RhPlan<NP>;
  constexpr int T = P::T, DC = P::DC, kRhWarps = P::W, kRhChunk = P::kChunk, kRhRow = P::kRow;
  constexpr int plane = DC * kRhRow;
  const int w = threadIdx.x / kLanes, q = threadIdx.x % kLanes, dl = q / NP, n = q % NP;
  const int b = blockIdx.y, d0 = blockIdx.x * DC, d = d0 + dl;
  const bool live = n < s.ns && d < s.nd;
  float* cur = shared_floats();          // delta', delta' u
  float* raw = cur + 2 * plane;          // [2][delta, u]: the next two chunks'
  float* sBs = raw + 4 * plane;          // [3][N][kRow]
  float* agg = sBs + 3 * s.ns * kRhRow;  // [W][pa, pb][32]
  const float a2 = live ? __ldg(s.A + static_cast<long long>(d) * s.ns + n) * kLog2e : 0.f;
  const int nchunks = (s.L + kRhChunk - 1) / kRhChunk;
  const int rows = max(0, min(DC, s.nd - d0));
  const long long drow = (static_cast<long long>(b) * s.nd + d0) * s.L;
  const float* bsrc = s.Bm + static_cast<long long>(b) * s.ns * s.L;
  const long long step = static_cast<long long>(s.nd) * s.ns;  // floats between steps of h
  float* ho = hout + (static_cast<long long>(b) * s.L * s.nd + d) * s.ns + n;
  const float* lq = cur + dl * kRhRow + w * T;
  // start copying chunk c (then commit a group, empty past the last chunk)
  auto stage = [&](int c) {
    if (c < nchunks) {
      float* r = raw + (c & 1) * 2 * plane;
      rh_stage_rows<NP>(r, s.delta + drow, s.L, rows, c * kRhChunk, s.L, vec);
      rh_stage_rows<NP>(r + plane, s.u + drow, s.L, rows, c * kRhChunk, s.L, vec);
      rh_stage_rows<NP>(sBs + (c % 3) * s.ns * kRhRow, bsrc, s.L, s.ns, c * kRhChunk, s.L, vec);
    }
    cp_async_commit();
  };

  stage(0);
  stage(1);
  cp_async_wait<1>();
  __syncthreads();
  rh_convert<NP, false>(s, d0, 0, raw, cur);
  float carry = 0.f;  // h entering the chunk
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * kRhChunk, tw = t0 + w * T;
    __syncthreads();  // chunk c's operands are staged; its raw buffer is free
    stage(c + 2);
    const float* bq = sBs + ((c % 3) * s.ns + min(n, s.ns - 1)) * kRhRow + w * T;
    float a[T], x[T], pa = 1.f, pb = 0.f;
#pragma unroll
    for (int k = 0; k < T; k += 4) {
      const float4 l4 = *reinterpret_cast<const float4*>(lq + k);
      const float4 x4 = *reinterpret_cast<const float4*>(lq + plane + k);
      const float4 b4 = *reinterpret_cast<const float4*>(bq + k);
      a[k] = ex2(l4.x * a2);
      a[k + 1] = ex2(l4.y * a2);
      a[k + 2] = ex2(l4.z * a2);
      a[k + 3] = ex2(l4.w * a2);
      x[k] = x4.x * b4.x;
      x[k + 1] = x4.y * b4.y;
      x[k + 2] = x4.z * b4.z;
      x[k + 3] = x4.w * b4.w;
    }
#pragma unroll
    for (int k = 0; k < T; ++k) {
      pb = fmaf(a[k], pb, x[k]);
      pa *= a[k];
    }
    agg[(2 * w) * kLanes + q] = pa;
    agg[(2 * w + 1) * kLanes + q] = pb;
    cp_async_wait<1>();
    __syncthreads();  // the warps' transforms are in; chunk c + 1's copies have landed
    // (chunk c's delta' and delta' u are read: chunk c + 1's take their place)
    if (c + 1 < nchunks)
      rh_convert<NP, false>(s, d0, t0 + kRhChunk, raw + ((c + 1) & 1) * 2 * plane, cur);
    // fold the warps' transforms in order: h entering this warp's steps, and the next chunk's carry
    float h = 0.f, run = carry;
#pragma unroll
    for (int v = 0; v < kRhWarps; ++v) {
      if (v == w) h = run;
      run = fmaf(agg[(2 * v) * kLanes + q], run, agg[(2 * v + 1) * kLanes + q]);
    }
    if (states && live && w == 0)
      states[((static_cast<long long>(b) * s.nd + d) * nchunks + c) * s.ns + n] = carry;
    carry = run;
    if (live) {
      float* o = ho + tw * step;
#pragma unroll
      for (int k = 0; k < T; ++k) {
        h = fmaf(a[k], h, x[k]);
        if (tw + k < s.L) o[k * step] = h;
      }
    }
  }
}

struct RhGrads {
  const float* __restrict__ states;  // (B, D, n_chunks, N)
  const float* __restrict__ gh;      // (B, L, D, N), or (B, D, N, L) with kGhDnl
  float* __restrict__ du;            // (B, D, L)
  float* __restrict__ ddelta;        // (B, D, L)
  float* __restrict__ part_b;        // (blocks, B, N, L): dB summed over a cluster's d
  float* __restrict__ part_bd;       // (B, D, N + 2): dA, 0 (no dD), dbias summed over t
};

// grid (blocks * kCluster, B) in clusters of kCluster CTAs along d (RhPlan),
// DC d a CTA as the forward; W warps. Shared: the chunk's delta', delta' u,
// u, sigmoid [4][DC][kRow]; the previous chunk's raw delta, u [2][DC][kRow];
// B [N][kRow] and gh [32 * kRow] (rh_stage_gh) of the chunk; the warps'
// transforms [3][W][32]; in a cluster, the CTA's dB of this chunk and the
// one after it [2][N][kPRow]. The previous chunk's raw delta and u are
// copied while a chunk is scanned, its B and gh once the chunk's reverse
// walk has read them (one buffer each: the backward of N > 4 needs its 4th
// CTA an SM); the cluster sums a chunk's dB while it scans the next (last
// first), so each thread's arrival at the cluster barrier and its wait are
// a chunk apart. Per (t, n) a lane keeps three terms: G B and G h[t-1] a A
// (summed over n: du = delta' sum G B, ddelta' = sum G h a A + u sum G B)
// and G delta' u (summed over d: dB); a is recomputed (exp2) rather than
// kept beside h[t-1].
template <int NP, bool kGhDnl>
__global__ void __cluster_dims__(RhPlan<NP>::kCluster, 1, 1)
    __launch_bounds__(RhPlan<NP>::kThreads, RhPlan<NP>::kBwdCtas)
selective_scan_rh_bwd_kernel(const Scan s, const RhGrads p, int vec, int vec_gh) {
  using P = RhPlan<NP>;
  constexpr int T = P::T, H = T / 2, DC = P::DC, kRhWarps = P::W, kRhChunk = P::kChunk;
  constexpr int kRhRow = P::kRow, kRhPRow = P::kPRow, kRhThreads = P::kThreads;
  constexpr int kCluster = P::kCluster, LNP = P::LNP, LH = H == 4 ? 2 : H == 8 ? 3 : 4;
  constexpr int kG = kLanes * kRhRow;  // floats of a staged gh chunk
  constexpr int plane = DC * kRhRow;
  // du, ddelta and dB values a lane owns in each half of its steps
  constexpr int NU = H >> (LNP < LH ? LNP : LH);
  constexpr int NB = H >> (5 - LNP < LH ? 5 - LNP : LH);
  const int w = threadIdx.x / kLanes, q = threadIdx.x % kLanes, dl = q / NP, n = q % NP;
  const int b = blockIdx.y, d0 = blockIdx.x * DC, d = d0 + dl;
  const int rank = static_cast<int>(cg::this_cluster().block_rank()),
            blk = blockIdx.x / kCluster;
  const bool live = n < s.ns && d < s.nd;
  float* cur = shared_floats();        // delta', delta' u, u, sigmoid
  float* raw = cur + 4 * plane;        // raw delta, u of the previous chunk
  float* sB = raw + 2 * plane;         // [N][kRow]
  float* sG = sB + s.ns * kRhRow;      // [kG]
  float* agg = sG + kG;                // [pa, pb, rb][W][32]
  float* part = agg + 3 * kRhWarps * kLanes;   // [2][N][kPRow] (in a cluster)
  const float an = live ? __ldg(s.A + static_cast<long long>(d) * s.ns + n) : 0.f;
  const float a2 = an * kLog2e;
  const int nchunks = (s.L + kRhChunk - 1) / kRhChunk;
  const int rows = max(0, min(DC, s.nd - d0));
  const long long drow = (static_cast<long long>(b) * s.nd + d0) * s.L;
  const float* bsrc = s.Bm + static_cast<long long>(b) * s.ns * s.L;
  const float* sq = p.states + (static_cast<long long>(b) * s.nd + d) * nchunks * s.ns + n;
  const float* lq = cur + dl * kRhRow + w * T;  // this lane's d at the warp's first step
  const float* bq = sB + min(n, s.ns - 1) * kRhRow + w * T;
  // this lane's gh at the warp's first step, and the floats between its steps;
  // a lane off the tensor reads a row (column) no copy writes, zeroed below,
  // so that its G, and all it adds, is 0 (past its CTA's run of rows * N
  // floats, column 31 is such a column whenever a lane is off the tensor)
  const float* gp =
      sG + (kGhDnl ? q * kRhRow + w * T : w * T * kLanes + (live ? dl * s.ns + n : kLanes - 1));
  constexpr int gk = kGhDnl ? 1 : kLanes;
  const int span = s.ns * kRhChunk / kCluster;  // dB values of a chunk this CTA sums
  // dB of chunk c over the cluster's d, CTA ranks in order: this CTA's share
  auto sum_cluster = [&](int c) {
    for (int e = rank * span + threadIdx.x; e < (rank + 1) * span; e += kRhThreads) {
      const int nn = e / kRhChunk, j = e % kRhChunk, t = c * kRhChunk + j;
      if (t >= s.L) continue;
      const int o = ((c & 1) * s.ns + nn) * kRhPRow + j;
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) sum += ld_cluster(cluster_peer(part + o, r));
      p.part_b[((static_cast<long long>(blk) * s.nb + b) * s.ns + nn) * s.L + t] = sum;
    }
  };
  auto stage_raw = [&](int c) {
    rh_stage_rows<NP>(raw, s.delta + drow, s.L, rows, c * kRhChunk, s.L, vec);
    rh_stage_rows<NP>(raw + plane, s.u + drow, s.L, rows, c * kRhChunk, s.L, vec);
  };
  auto stage_bg = [&](int c) {
    rh_stage_rows<NP>(sB, bsrc, s.L, s.ns, c * kRhChunk, s.L, vec);
    rh_stage_gh<NP, kGhDnl>(sG, s, p.gh, b, d0, rows, c * kRhChunk, vec_gh);
  };

  for (int e = threadIdx.x; e < kG; e += kRhThreads) sG[e] = 0.f;
  __syncthreads();
  stage_raw(nchunks - 1);
  stage_bg(nchunks - 1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  rh_convert<NP, true>(s, d0, (nchunks - 1) * kRhChunk, raw, cur);
  float h0 = live ? __ldg(sq + static_cast<long long>(nchunks - 1) * s.ns) : 0.f;
  float gcar = 0.f;  // a[t+1] G[t+1] entering the chunk's last step
  float dA = 0.f, dbias = 0.f;
  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * kRhChunk, tw = t0 + w * T;
    cp_async_wait<0>();
    __syncthreads();  // chunk c's operands are staged and converted; `raw` is free
    if (c > 0) stage_raw(c - 1);
    cp_async_commit();
    const float hs = h0;  // the state entering chunk c; the next one's load starts here
    if (c > 0) h0 = live ? __ldg(sq + static_cast<long long>(c - 1) * s.ns) : 0.f;
    // over the warp's steps: h's transform (pa, pb) and G at its first step
    // with nothing entering from the right, a[first] times it (rb)
    float pa = 1.f, pb = 0.f, rb;
    {
      float a[T];
#pragma unroll
      for (int k = 0; k < T; k += 4) {
        const float4 l4 = *reinterpret_cast<const float4*>(lq + k);
        const float4 x4 = *reinterpret_cast<const float4*>(lq + plane + k);
        const float4 b4 = *reinterpret_cast<const float4*>(bq + k);
        a[k] = ex2(l4.x * a2);
        a[k + 1] = ex2(l4.y * a2);
        a[k + 2] = ex2(l4.z * a2);
        a[k + 3] = ex2(l4.w * a2);
        pb = fmaf(a[k], pb, x4.x * b4.x);
        pb = fmaf(a[k + 1], pb, x4.y * b4.y);
        pb = fmaf(a[k + 2], pb, x4.z * b4.z);
        pb = fmaf(a[k + 3], pb, x4.w * b4.w);
        pa *= a[k] * a[k + 1] * a[k + 2] * a[k + 3];
      }
      float g = gp[(T - 1) * gk];
#pragma unroll
      for (int k = T - 2; k >= 0; --k) g = fmaf(a[k + 1], g, gp[k * gk]);
      rb = a[0] * g;
    }
    agg[(0 * kRhWarps + w) * kLanes + q] = pa;
    agg[(1 * kRhWarps + w) * kLanes + q] = pb;
    agg[(2 * kRhWarps + w) * kLanes + q] = rb;
    __syncthreads();  // the warps' transforms are in
    if (kCluster > 1 && c + 1 < nchunks) {
      cluster_wait();  // the cluster's dB of chunk c + 1 is in
      sum_cluster(c + 1);
    }
    // h entering this warp's steps (the warps to its left folded onto the
    // chunk's state) and G's carry entering its last step (the warps to its
    // right folded onto the chunk's), then the carry of the chunk before
    float hc = 0.f, run = hs;
#pragma unroll
    for (int v = 0; v < kRhWarps; ++v) {
      if (v == w) hc = run;
      run = fmaf(agg[v * kLanes + q], run, agg[(kRhWarps + v) * kLanes + q]);
    }
    float gc = 0.f;
    run = gcar;
#pragma unroll
    for (int v = kRhWarps - 1; v >= 0; --v) {
      if (v == w) gc = run;
      run = fmaf(agg[v * kLanes + q], run, agg[(2 * kRhWarps + v) * kLanes + q]);
    }
    gcar = run;
    // h[t-1] over the warp's steps
    float hp[T];
#pragma unroll
    for (int k = 0; k < T; k += 4) {
      const float4 l4 = *reinterpret_cast<const float4*>(lq + k);
      const float4 x4 = *reinterpret_cast<const float4*>(lq + plane + k);
      const float4 b4 = *reinterpret_cast<const float4*>(bq + k);
      hp[k] = hc;
      hc = fmaf(ex2(l4.x * a2), hc, x4.x * b4.x);
      hp[k + 1] = hc;
      hc = fmaf(ex2(l4.y * a2), hc, x4.y * b4.y);
      hp[k + 2] = hc;
      hc = fmaf(ex2(l4.z * a2), hc, x4.z * b4.z);
      hp[k + 3] = hc;
      hc = fmaf(ex2(l4.w * a2), hc, x4.w * b4.w);
    }
    // G last step first, and each step's terms, in two halves of the warp's
    // steps (each summed before the next: fewer live registers)
    float G = gc, anext = 1.f;  // a at the step after
    float* pc = part + (c & 1) * s.ns * kRhPRow;
    float su[2][2][NU];  // each half's owned sums over n: of G B, of G h a A
    int iu[2];
    bool ou[2];
#pragma unroll
    for (int half = 1; half >= 0; --half) {
      float sn[2][H], sd[1][H];
#pragma unroll
      for (int k4 = H - 4; k4 >= 0; k4 -= 4) {
        const int kb = half * H + k4;
        const float4 l4 = *reinterpret_cast<const float4*>(lq + kb);
        const float4 x4 = *reinterpret_cast<const float4*>(lq + plane + kb);
        const float4 b4 = *reinterpret_cast<const float4*>(bq + kb);
        const float dls[4] = {l4.x, l4.y, l4.z, l4.w}, dus[4] = {x4.x, x4.y, x4.z, x4.w};
        const float bs[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 3; i >= 0; --i) {
          const int k = kb + i;
          const float ghk = gp[k * gk];
          const float ak = ex2(dls[i] * a2);
          G = k == T - 1 ? ghk + gc : fmaf(anext, G, ghk);
          anext = ak;
          const float gha = G * hp[k] * ak;
          dA = fmaf(gha, dls[i], dA);
          sn[0][k4 + i] = G * bs[i];
          sn[1][k4 + i] = gha * an;
          sd[0][k4 + i] = G * dus[i];
        }
      }
      if (half == 0) {
        __syncthreads();  // B and gh of chunk c are read: stage chunk c - 1's
        if (c > 0) stage_bg(c - 1);
        cp_async_commit();
      }
      // du, ddelta: sums over the NP lanes of each d (stored below)
      iu[half] = half * H;
      ou[half] = true;
      reduce_scatter<H, 2>(sn, q, NP >> 1, LNP, iu[half], ou[half]);
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        su[half][0][i] = sn[0][i];
        su[half][1][i] = sn[1][i];
      }
      // dB: sums over the DC d of the CTA (lanes of each n)
      int idb = half * H;
      bool ob = true;
      reduce_scatter<H, 1>(sd, q, kLanes >> 1, 5 - LNP, idb, ob);
      if (ob && n < s.ns) {
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const int j = w * T + idb + i;
          if (kCluster > 1) {
            pc[n * kRhPRow + j] = sd[0][i];
          } else if (t0 + j < s.L) {  // no cluster: the CTA's partial
            p.part_b[((static_cast<long long>(blk) * s.nb + b) * s.ns + n) * s.L + t0 + j] =
                sd[0][i];
          }
        }
      }
    }
    // (the arrival releases this thread's earlier memory operations, so the
    // chunk's global stores come after it, not before)
    if (kCluster > 1) cluster_arrive();  // this CTA's dB of chunk c is in
    if (d < s.nd) {
      const long long row = (static_cast<long long>(b) * s.nd + d) * s.L;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          const int j = iu[half] + i, t = tw + j;
          if (ou[half] && t < s.L) {
            const float dlt = lq[j], ut = lq[2 * plane + j], sg = lq[3 * plane + j];
            p.du[row + t] = dlt * su[half][0][i];
            const float ddl = fmaf(ut, su[half][0][i], su[half][1][i]) * sg;
            p.ddelta[row + t] = ddl;
            dbias += ddl;
          }
        }
      }
    }
    cp_async_wait<1>();
    __syncthreads();  // chunk c - 1's raw delta and u have landed; chunk c's are read
    if (c > 0) rh_convert<NP, true>(s, d0, t0 - kRhChunk, raw, cur);
  }
  if (kCluster > 1) {
    cluster_wait();
    sum_cluster(0);
  }
  // dA over the warps, dbias over the warps and the lanes of a d, in order
  agg[w * kLanes + q] = dA;
  agg[(kRhWarps + w) * kLanes + q] = dbias;
  __syncthreads();
  if (w == 0 && live) {
    float* o = p.part_bd + (static_cast<long long>(b) * s.nd + d) * (s.ns + 2);
    float sa = 0.f;
    for (int v = 0; v < kRhWarps; ++v) sa += agg[v * kLanes + q];
    o[n] = sa;
    if (n == 0) {
      float sb = 0.f;
      for (int v = 0; v < kRhWarps; ++v)
        for (int j = 0; j < NP; ++j) sb += agg[(kRhWarps + v) * kLanes + dl * NP + j];
      o[s.ns] = 0.f;
      o[s.ns + 1] = sb;
    }
  }
  if (kCluster > 1) {
    cluster_arrive();  // no CTA leaves while the cluster may still read its dB
    cluster_wait();
  }
}

// The geometry of the return-hidden kernels, which the wrapper sizes its
// buffers by: the steps of a chunk (the saved states' unit), the chunks, the d
// of a dB partial (a cluster's), and the partials.
struct RhGeometry {
  int chunk, n_chunks, dblock, blocks;
};

inline RhGeometry rh_geometry(int nd, int L, int ns) {
  const int np = rh_lanes_per_d(ns);
  const int dblock = kLanes / np * (np == 4 ? RhPlan<4>::kCluster : RhPlan<8>::kCluster);
  constexpr int chunk = RhPlan<4>::kChunk;
  static_assert(chunk == RhPlan<8>::kChunk && chunk == RhPlan<16>::kChunk &&
                chunk == RhPlan<32>::kChunk && RhPlan<8>::kCluster == RhPlan<32>::kCluster,
                "one chunk for every N, one cluster for every N > 4");
  return {chunk, ceil_div(L, chunk), dblock, ceil_div(nd, dblock)};
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int NP>
int launch_rh_fwd(const Scan& s, float* h, float* states, cudaStream_t stream) {
  using P = RhPlan<NP>;
  const size_t smem = (6ull * P::DC * P::kRow + 3ull * s.ns * P::kRow + 2ull * P::W * kLanes) *
                      sizeof(float);
  cudaError_t err = allow_smem(selective_scan_rh_fwd_kernel<NP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = s.L % 4 == 0 && aligned16(s.u) && aligned16(s.delta) && aligned16(s.Bm);
  const dim3 grid(ceil_div(s.nd, P::DC), s.nb);
  selective_scan_rh_fwd_kernel<NP><<<grid, P::kThreads, smem, stream>>>(s, h, states, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int NP, bool kGhDnl>
int launch_rh_bwd(const Scan& s, const RhGrads& p, float* dA, float* dB, float* dbias,
                  cudaStream_t stream) {
  using P = RhPlan<NP>;
  const RhGeometry geo = rh_geometry(s.nd, s.L, s.ns);
  const size_t smem = (6ull * P::DC * P::kRow + 1ull * s.ns * P::kRow + 1ull * kLanes * P::kRow +
                       3ull * P::W * kLanes + (P::kCluster > 1 ? 2ull * s.ns * P::kPRow : 0ull)) *
                      sizeof(float);
  auto kernel = selective_scan_rh_bwd_kernel<NP, kGhDnl>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the whole of an SM's shared memory for it, so that kBwdCtas CTAs fit
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = s.L % 4 == 0 && aligned16(s.u) && aligned16(s.delta) && aligned16(s.Bm);
  // (a (B, L, D, N) gh: a CTA's runs also need 16-byte starts and lengths, checked per CTA)
  const int vec_gh = aligned16(p.gh) && (kGhDnl ? s.L % 4 == 0 : s.nd * s.ns % 4 == 0);
  kernel<<<dim3(geo.blocks * P::kCluster, s.nb), P::kThreads, smem, stream>>>(s, p, vec, vec_gh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the reduction of the kernels above: dB over the clusters, dA and dbias over b
  const Grads g{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, p.part_b, nullptr,
                p.part_bd};
  const long long n =
      std::max(geo.blocks > 1 ? static_cast<long long>(s.nb) * s.ns * s.L : 0ll,
               static_cast<long long>(s.nd) * (s.ns + 2));
  selective_scan_bwd_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      s, g, geo.blocks, dA, dB, nullptr, nullptr, dbias);
  return static_cast<int>(cudaGetLastError());
}

// the kernels' instantiation for N's lanes per d
int launch_rh_fwd(const Scan& s, float* h, float* states, cudaStream_t stream) {
  switch (rh_lanes_per_d(s.ns)) {
    case 4: return launch_rh_fwd<4>(s, h, states, stream);
    case 8: return launch_rh_fwd<8>(s, h, states, stream);
    case 16: return launch_rh_fwd<16>(s, h, states, stream);
    default: return launch_rh_fwd<32>(s, h, states, stream);
  }
}

template <bool kGhDnl>
int launch_rh_bwd(const Scan& s, const RhGrads& p, float* dA, float* dB, float* dbias,
                  cudaStream_t stream) {
  switch (rh_lanes_per_d(s.ns)) {
    case 4: return launch_rh_bwd<4, kGhDnl>(s, p, dA, dB, dbias, stream);
    case 8: return launch_rh_bwd<8, kGhDnl>(s, p, dA, dB, dbias, stream);
    case 16: return launch_rh_bwd<16, kGhDnl>(s, p, dA, dB, dbias, stream);
    default: return launch_rh_bwd<32, kGhDnl>(s, p, dA, dB, dbias, stream);
  }
}

// the lane's steps K: 2, 4 or 8, the fewest covering L, and 16 for a long L
// with N <= 16 (ops/kernels/selective_scan.py: chunk_steps)
inline int chunk_steps(int L, int ns) {
  return L <= 64 ? 2 : L <= 128 ? 4 : L > 4096 && ns <= 16 ? 16 : 8;
}

template <int K>
int launch_fwd(const Scan& s, float* out, float* last, float* states, cudaStream_t stream) {
  const size_t smem = (4ull * s.ns * kLanes * (K + 1) + 2ull * kFwdWarps * s.ns) * sizeof(float);
  cudaError_t err = allow_smem(selective_scan_fwd_kernel<K>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ceil_div(s.nd, kFwdWarps), s.nb);
  selective_scan_fwd_kernel<K><<<grid, kFwdWarps * kLanes, smem, stream>>>(s, out, last, states);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_bwd(const Scan& s, const Grads& p, float* dA, float* dB, float* dC, float* dD,
               float* dbias, cudaStream_t stream) {
  const size_t smem = (2ull * s.ns * kLanes * (K + 1) + 4ull * kBwdWarps * kLanes * (K + 1) +
                       static_cast<size_t>(kBwdWarps) * (4 * s.ns + 2)) * sizeof(float);
  cudaError_t err = allow_smem(selective_scan_bwd_kernel<K>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = ceil_div(s.nd, kBwdWarps);
  selective_scan_bwd_kernel<K><<<dim3(blocks, s.nb), kBwdWarps * kLanes, smem, stream>>>(s, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = std::max(blocks > 1 ? static_cast<long long>(s.nb) * s.ns * s.L : 0ll,
                               static_cast<long long>(s.nd) * (s.ns + 2));
  selective_scan_bwd_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      s, p, blocks, dA, dB, dC, dD, dbias);
  return static_cast<int>(cudaGetLastError());
}

Scan make_scan(const void* u, const void* delta, const void* A, const void* B, const void* C,
               const void* D, const void* z, const void* bias, int nb, int nd, int L, int ns,
               int softplus) {
  return Scan{static_cast<const float*>(u), static_cast<const float*>(delta),
              static_cast<const float*>(A), static_cast<const float*>(B),
              static_cast<const float*>(C), static_cast<const float*>(D),
              static_cast<const float*>(z), static_cast<const float*>(bias),
              nb, nd, L, ns, softplus};
}

}  // namespace
}  // namespace accunet

// u, delta, z, out (B, D, L); A (D, N); B, C (B, N, L); D, bias (D,); last
// (B, D, N); states (B, D, n_chunks, N) or null; D, z, bias may be null. All
// fp32 contiguous.
extern "C" int accunet_selective_scan_fwd(const void* u, const void* delta, const void* A,
                                          const void* B, const void* C, const void* D,
                                          const void* z, const void* bias, void* out, void* last,
                                          void* states, int nb, int nd, int L, int ns,
                                          int softplus, void* stream) {
  using namespace accunet;
  if (nb <= 0 || nd <= 0 || L <= 0 || ns <= 0 || ns > 32) return -1;
  const Scan s = make_scan(u, delta, A, B, C, D, z, bias, nb, nd, L, ns, softplus);
  float* o = static_cast<float*>(out);
  float* l = static_cast<float*>(last);
  float* st = static_cast<float*>(states);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (chunk_steps(L, ns)) {
    case 2: return launch_fwd<2>(s, o, l, st, cs);
    case 4: return launch_fwd<4>(s, o, l, st, cs);
    case 8: return launch_fwd<8>(s, o, l, st, cs);
    default: return launch_fwd<16>(s, o, l, st, cs);
  }
}

// The forward's operands and chunk states, g (B, D, L) and g_last (B, D, N)
// or null -> du, ddelta, dz (or null) (B, D, L); dA (D, N), dB, dC (B, N,
// L), dD, dbias (D,) or null. part_b, part_c (blocks, B, N, L), blocks =
// ceil(D / 8) (dB and dC themselves when D <= 8), and part_bd (B, D, N + 2)
// are scratch.
extern "C" int accunet_selective_scan_bwd(
    const void* u, const void* delta, const void* A, const void* B, const void* C, const void* D,
    const void* z, const void* bias, const void* states, const void* g, const void* g_last,
    void* du, void* ddelta, void* dz, void* part_b, void* part_c, void* part_bd, void* dA,
    void* dB, void* dC, void* dD, void* dbias, int nb, int nd, int L, int ns, int softplus,
    void* stream) {
  using namespace accunet;
  if (nb <= 0 || nd <= 0 || L <= 0 || ns <= 0 || ns > 32) return -1;
  if ((z == nullptr) != (dz == nullptr)) return -2;
  const Scan s = make_scan(u, delta, A, B, C, D, z, bias, nb, nd, L, ns, softplus);
  const Grads p{static_cast<const float*>(states), static_cast<const float*>(g),
                static_cast<const float*>(g_last), static_cast<float*>(du),
                static_cast<float*>(ddelta), static_cast<float*>(dz), static_cast<float*>(part_b),
                static_cast<float*>(part_c), static_cast<float*>(part_bd)};
  float* a = static_cast<float*>(dA);
  float* bm = static_cast<float*>(dB);
  float* cm = static_cast<float*>(dC);
  float* dv = static_cast<float*>(dD);
  float* bs = static_cast<float*>(dbias);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (chunk_steps(L, ns)) {
    case 2: return launch_bwd<2>(s, p, a, bm, cm, dv, bs, cs);
    case 4: return launch_bwd<4>(s, p, a, bm, cm, dv, bs, cs);
    case 8: return launch_bwd<8>(s, p, a, bm, cm, dv, bs, cs);
    default: return launch_bwd<16>(s, p, a, bm, cm, dv, bs, cs);
  }
}

// The return-hidden kernels' geometry for D = nd, L, N = ns, which the
// wrapper sizes its buffers by: out[0] the steps of a chunk, out[1] the
// chunks (the saved states are (B, D, out[1], N)), out[2] the d of a dB
// partial, out[3] the partials (part_b is (out[3], B, N, L); dB itself when
// out[3] is 1).
extern "C" int accunet_selective_scan_rh_geometry(int nd, int L, int ns, int* out) {
  using namespace accunet;
  if (nd <= 0 || L <= 0 || ns <= 0 || ns > 32) return -1;
  const RhGeometry g = rh_geometry(nd, L, ns);
  out[0] = g.chunk;
  out[1] = g.n_chunks;
  out[2] = g.dblock;
  out[3] = g.blocks;
  return 0;
}

// u, delta (B, D, L); A (D, N); B (B, N, L); bias (D,) or null -> h (B, L,
// D, N) and, when states is not null, the state entering each chunk,
// (B, D, n_chunks, N) (accunet_selective_scan_rh_geometry). All fp32
// contiguous.
extern "C" int accunet_selective_scan_rh_fwd(const void* u, const void* delta, const void* A,
                                             const void* B, const void* bias, void* h,
                                             void* states, int nb, int nd, int L, int ns,
                                             int softplus, void* stream) {
  using namespace accunet;
  if (nb <= 0 || nd <= 0 || L <= 0 || ns <= 0 || ns > 32) return -1;
  const Scan s = make_scan(u, delta, A, B, nullptr, nullptr, nullptr, bias, nb, nd, L, ns,
                           softplus);
  return launch_rh_fwd(s, static_cast<float*>(h), static_cast<float*>(states),
                       static_cast<cudaStream_t>(stream));
}

// The forward's operands and chunk states and gh, (B, L, D, N) or, with
// gh_dnl, (B, D, N, L) -> du, ddelta (B, D, L), dA (D, N), dB (B, N, L),
// dbias (D,) or null. part_b and part_bd (B, D, N + 2) are scratch, part_b
// sized by accunet_selective_scan_rh_geometry.
extern "C" int accunet_selective_scan_rh_bwd(
    const void* u, const void* delta, const void* A, const void* B, const void* bias,
    const void* states, const void* gh, void* du, void* ddelta, void* part_b, void* part_bd,
    void* dA, void* dB, void* dbias, int nb, int nd, int L, int ns, int softplus, int gh_dnl,
    void* stream) {
  using namespace accunet;
  if (nb <= 0 || nd <= 0 || L <= 0 || ns <= 0 || ns > 32) return -1;
  const Scan s = make_scan(u, delta, A, B, nullptr, nullptr, nullptr, bias, nb, nd, L, ns,
                           softplus);
  const RhGrads p{static_cast<const float*>(states), static_cast<const float*>(gh),
                  static_cast<float*>(du), static_cast<float*>(ddelta),
                  static_cast<float*>(part_b), static_cast<float*>(part_bd)};
  float* a = static_cast<float*>(dA);
  float* bm = static_cast<float*>(dB);
  float* bs = static_cast<float*>(dbias);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return gh_dnl ? launch_rh_bwd<true>(s, p, a, bm, bs, cs)
                : launch_rh_bwd<false>(s, p, a, bm, bs, cs);
}
