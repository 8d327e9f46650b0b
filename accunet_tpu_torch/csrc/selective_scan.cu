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
#include <algorithm>

#include "common.cuh"

namespace accunet {
namespace {

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
      sc += p.part_c[k * bnl + i];
    }
    dB[i] = sb;
    dC[i] = sc;
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
