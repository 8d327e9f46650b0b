// Tensor-core and cp.async helpers shared by hanc_mix.cu and hanc_block.cu:
// 16-byte cp.async copies into shared memory (zero-filled when the source is
// out of range), mma.sync in bf16 (m16n8k16) and in 3xTF32 (m16n8k8, each
// fp32 operand split into a tf32 high part and its remainder), vector loads
// and stores of shared-memory rows, and `Ops<T>`: per input type, the K-chunk,
// the fragment loads and the products of a grouped GEMM whose A operand is a
// weight slab stored [k][m] and whose B operand is a row matrix stored
// [row][k] (row stride Ops<T>::LDX unless given). Then the HANC pyramid's
// layout: `Tile` (pixels x output channels per CTA, and its warps), `Rows`
// (the pyramid's rows and each warp's n-tiles of them) and `mix` (the
// products of one staged K-chunk into a warp's accumulators).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace accunet {
namespace {

using bf16 = __nv_bfloat16;
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use (sm_90)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d = a * b, from a zero accumulator
__device__ __forceinline__ void mma_tf32_from0(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// v = hi + lo: hi rounded to tf32, lo the exact remainder (the tensor core
// reads its top 10 mantissa bits)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// CW consecutive values of a shared-memory row, as floats, in one access,
// and T's rounding of a float
template <int CW>
__device__ __forceinline__ void ldv(const float* p, float (&v)[CW]) {
  if constexpr (CW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (CW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}
template <int CW>
__device__ __forceinline__ void ldv(const bf16* p, float (&v)[CW]) {
  if constexpr (CW == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
  } else if constexpr (CW == 2) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}
// the 16 bytes r as 4 floats or 8 bf16 values
__device__ __forceinline__ void unpack16(const uint4& r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x), v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z), v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack16(const uint4& r, float (&v)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}
template <int CW>
__device__ __forceinline__ void stv(float* p, const float (&v)[CW]) {
  if constexpr (CW == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (CW == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}
template <int CW>
__device__ __forceinline__ void stv(bf16* p, const float (&v)[CW]) {
  if constexpr (CW == 8) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (CW == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                              *reinterpret_cast<const uint32_t*>(&hi));
  } else if constexpr (CW == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    *p = __float2bfloat16(v[0]);
  }
}
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// smallest s >= n with s = 8 (mod m): a row stride whose fragment loads are
// free of bank conflicts (m = 32 for fp32 pairs, 16 for bf16 words)
__host__ __device__ constexpr int conflict_free_ld(int n, int m) {
  return n + ((8 - n % m) % m + m) % m;
}

__host__ __device__ constexpr int align16(int n) { return (n + 15) / 16 * 16; }

// a rows x COLS block from device memory (row stride gld elements) into
// shared memory (row stride sld), zero outside rows_ok x cols_ok; 16-byte
// cp.async copies (vec: cols_ok and the rows' starts are whole 16 bytes) or
// element copies through a register
template <typename E, int COLS, int NTH>
__device__ __forceinline__ void copy_block(E* dst, int sld, const E* src, size_t gld, int rows,
                                           int rows_ok, int cols_ok, bool vec, int tid) {
  if (vec) {
    constexpr int V = 16 / sizeof(E), SEGS = COLS / V;
    static_assert(COLS % V == 0, "whole 16-byte columns");
    for (int i = tid; i < rows * SEGS; i += NTH) {
      const int r = i / SEGS, c = (i - r * SEGS) * V;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async16(dst + r * sld + c, ok ? src + r * gld + c : src, ok);
    }
  } else {
    for (int i = tid; i < rows * COLS; i += NTH) {
      const int r = i / COLS, c = i - r * COLS;
      dst[r * sld + c] = r < rows_ok && c < cols_ok ? src[r * gld + c] : from_float<E>(0.f);
    }
  }
}


// Per input type: the K-chunk staged per ring stage (KC), the K of one mma
// (KSTEP), row paddings that keep the fragment loads free of bank conflicts,
// and the fragment loads and products. A is W^T (m = output channel, read
// from the weight slab stored [k][m] in shared memory), B is the pyramid (n
// = row, stored [row][k]). Two choices differ by type:
//  * kPromote: each tile's sum over a K-chunk starts from 0 and is added to
//    the accumulator with an fp32 add. The tensor core truncates its fp32
//    sums; over K = 4352 (1632 mma.sync at 3xTF32) the bias of truncating a
//    large accumulator reached 3.5e-5 of the output, and 1e-6 with this.
//  * kPrepareFirst: an iteration issues chunk ch+2's copies and pools chunk
//    ch+1 before its products, else after the pixel rows' products. A 3xTF32
//    iteration is long: the copies still land in time, and neither holds
//    every warp back from its first mma.sync; a bf16 iteration is short, and
//    its copies need all of it (tools/hanc_mix_ablate.py times both orders).
template <typename T>
struct Ops;

template <>
struct Ops<float> {
  static constexpr int KC = 16, KSTEP = 8, LDX = KC + 8, PADW = 4, VEC = 4;
  static constexpr bool kPromote = true, kPrepareFirst = false;
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
  // m16n8k8: lane (g, t) = (lane / 4, lane % 4) holds A (m g and g+8) x (k
  // slots t and t+4) and B (k slots t and t+4) x (n g). Slot t is channel
  // kk + 2t and slot t+4 channel kk + 2t + 1 in both operands, so B's pair
  // is one 8-byte load.
  __device__ static void load_a(A& a, const float* Ws, int ldw, int m, int kk, int lane) {
    const float* p = Ws + (kk + 2 * (lane & 3)) * ldw + m + (lane >> 2);
    split_tf32(p[0], a.hi[0], a.lo[0]);
    split_tf32(p[8], a.hi[1], a.lo[1]);
    split_tf32(p[ldw], a.hi[2], a.lo[2]);
    split_tf32(p[ldw + 8], a.hi[3], a.lo[3]);
  }
  __device__ static void load_b(B& b, const float* Xs, int ld, int row, int kk, int lane) {
    const float2 v =
        *reinterpret_cast<const float2*>(Xs + (row + (lane >> 2)) * ld + kk + 2 * (lane & 3));
    split_tf32(v.x, b.hi[0], b.lo[0]);
    split_tf32(v.y, b.hi[1], b.lo[1]);
  }
  // A (m16 x k8) from a row-major [m][k] matrix (rows row .. row + 15,
  // stride ld): the same k slots, rows g and g + 8 each one 8-byte load
  __device__ static void load_a_rows(A& a, const float* Xs, int ld, int row, int kk, int lane) {
    const float* p = Xs + (row + (lane >> 2)) * ld + kk + 2 * (lane & 3);
    const float2 v = *reinterpret_cast<const float2*>(p);
    const float2 u = *reinterpret_cast<const float2*>(p + 8 * ld);
    split_tf32(v.x, a.hi[0], a.lo[0]);
    split_tf32(u.x, a.hi[1], a.lo[1]);
    split_tf32(v.y, a.hi[2], a.lo[2]);
    split_tf32(u.y, a.hi[3], a.lo[3]);
  }
  __device__ static void load_b(B& b, const float* Xs, int row, int kk, int lane) {
    load_b(b, Xs, LDX, row, kk, lane);
  }
  // the three products of 3xTF32, small terms first: d += lo*hi (d = lo*hi
  // when `first`), d += hi*lo, d += hi*hi
  __device__ static void pass(int p, bool first, float (&d)[4], const A& a, const B& b) {
    if (p == 0 && first) mma_tf32_from0(d, a.lo, b.hi);
    if (p == 0 && !first) mma_tf32(d, a.lo, b.hi);
    if (p == 1) mma_tf32(d, a.hi, b.lo);
    if (p == 2) mma_tf32(d, a.hi, b.hi);
  }
  static constexpr int kPasses = 3;
};

template <>
struct Ops<bf16> {
  static constexpr int KC = 32, KSTEP = 16, LDX = KC + 8, PADW = 8, VEC = 8;
  static constexpr bool kPromote = false, kPrepareFirst = true;
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };
  // A from the [k][m] slab with ldmatrix .trans: matrix q = lane / 8 covers
  // k rows (q / 2) * 8 .. +7 and m columns (q % 2) * 8 .. +7
  __device__ static void load_a(A& a, const bf16* Ws, int ldw, int m, int kk, int lane) {
    const int q = lane >> 3;
    const bf16* p = Ws + (kk + (q >> 1) * 8 + (lane & 7)) * ldw + m + (q & 1) * 8;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
                 : "r"(smem_u32(p)));
  }
  // B: row g, channels kk + 2t, +1 and kk + 8 + 2t, +1
  __device__ static void load_b(B& b, const bf16* Xs, int ld, int row, int kk, int lane) {
    const bf16* p = Xs + (row + (lane >> 2)) * ld + kk + 2 * (lane & 3);
    b.r[0] = *reinterpret_cast<const uint32_t*>(p);
    b.r[1] = *reinterpret_cast<const uint32_t*>(p + 8);
  }
  // A (m16 x k16) from a row-major [m][k] matrix (rows row .. row + 15,
  // stride ld, a multiple of 8) with ldmatrix: matrix q = lane / 8 covers
  // rows (q % 2) * 8 .. +7 and k columns (q / 2) * 8 .. +7
  __device__ static void load_a_rows(A& a, const bf16* Xs, int ld, int row, int kk, int lane) {
    const int q = lane >> 3;
    const bf16* p = Xs + (row + (q & 1) * 8 + (lane & 7)) * ld + kk + (q >> 1) * 8;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
                 : "r"(smem_u32(p)));
  }
  __device__ static void load_b(B& b, const bf16* Xs, int row, int kk, int lane) {
    load_b(b, Xs, LDX, row, kk, lane);
  }
  __device__ static void pass(int, bool, float (&d)[4], const A& a, const B& b) {
    mma_bf16(d, a.r, b.r);
  }
  static constexpr int kPasses = 1;
};

// A CTA's tile: TH x TW pixels, NCOL output channels, WM x WN warps; warp
// (wm, nh) owns MT = NCOL / 16 / WM m16 tiles of output channels and its
// share (column nh of WN) of every row group of the pyramid.
template <int TH_, int TW_, int NCOL_, int WM_, int WN_>
struct Tile {
  static constexpr int TH = TH_, TW = TW_, NCOL = NCOL_, WM = WM_, WN = WN_;
  static constexpr int THREADS = 32 * WM * WN, MT = NCOL / (16 * WM);
  static_assert(MT >= 1 && NCOL % (16 * WM) == 0, "whole m16 tiles per warp");
  static_assert(TH % 4 == 0 && TW % 4 == 0, "pools never cross a tile");
};

// The pyramid's rows, in 8-row n-tiles:
//   [0, P) pixels row-major, [A2, M2) 2x2 avg, [M2, A4) 2x2 max (K >= 2),
//   [A4, A4 + N4) 4x4 avg, [A4 + N4, NR) 4x4 max (K = 3).
// Warp column nh takes NT0 pixel n-tiles, NT1 of each 2x2 map and, for K = 3,
// 4x4 n-tile nh (avg4 tiles first, then max4) if there is one.
template <class C, int K>
struct Rows {
  static constexpr int P = C::TH * C::TW, N2 = K >= 2 ? P / 4 : 0, N4 = K >= 3 ? P / 16 : 0;
  static constexpr int A2 = P, M2 = A2 + N2, A4 = M2 + N2, NR = A4 + 2 * N4;
  static constexpr int NT0 = P / 8 / C::WN, NT1 = N2 / 8 / C::WN, T4 = 2 * N4 / 8;
  static constexpr int NT3 = T4 > 0 ? 1 : 0, NT = NT0 + 2 * NT1 + NT3;
  static_assert(P % (8 * C::WN) == 0 && N2 % (8 * C::WN) == 0 && N4 % 8 == 0, "8-row groups");
  static_assert(T4 <= C::WN, "one 4x4 n-tile per warp column at most");

  // first row of the warp column's n-tile j, or -1 where it has none
  __device__ static int row(int j, int nh) {
    if (j < NT0) return (nh * NT0 + j) * 8;
    if (j < NT0 + NT1) return A2 + (nh * NT1 + j - NT0) * 8;
    if (j < NT0 + 2 * NT1) return M2 + (nh * NT1 + j - NT0 - NT1) * 8;
    return nh < T4 ? A4 + 8 * nh : -1;
  }
};

// acc[J0 + j] += W_slab^T x rows [row0 + 8j, +8) over the staged K-chunk:
// two n-tiles at a time, every k-step of the chunk, pass by pass, so that
// consecutive mma.sync are independent. With kPromote each tile's chunk sum
// starts from 0 and is added to acc once.
template <int J0, int NJ, typename T, int MT, int NT>
__device__ __forceinline__ void mix(float (&acc)[NT][MT][4], const T* Ws, int ldw,
                                    const T* Xs, int row0, int m0, int lane) {
  using O = Ops<T>;
  constexpr int S = O::KC / O::KSTEP, JB = NJ % 2 == 0 ? 2 : 1;
  typename O::A a[S][MT];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) O::load_a(a[s][mt], Ws, ldw, m0 + 16 * mt, s * O::KSTEP, lane);
#pragma unroll
  for (int j = 0; j < NJ; j += JB) {
    float part[JB][MT][4];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      typename O::B b[JB];
#pragma unroll
      for (int jb = 0; jb < JB; ++jb) O::load_b(b[jb], Xs, row0 + 8 * (j + jb), s * O::KSTEP, lane);
#pragma unroll
      for (int p = 0; p < O::kPasses; ++p)
#pragma unroll
        for (int jb = 0; jb < JB; ++jb)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if constexpr (O::kPromote)
              O::pass(p, s == 0, part[jb][mt], a[s][mt], b[jb]);
            else
              O::pass(p, false, acc[J0 + j + jb][mt], a[s][mt], b[jb]);
          }
    }
    if constexpr (O::kPromote) {
#pragma unroll
      for (int jb = 0; jb < JB; ++jb)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[J0 + j + jb][mt][c] += part[jb][mt][c];
    }
  }
}

// The expand of a pixel halo on the tensor cores (hanc_block's and
// expand_dw's first phase): u^T = W^T x^T over MTE m16 tiles of channels (A
// from the [k][m] slab Ws, row stride ldw) and the NTE 8-row n-tiles of the
// halo Xs ([row][k], stride xld). Warp w takes n-tiles w, w + kWarps, ...
// (ExpandAcc<NTE, MTE> holds its sums). expand_acc adds a staged K block of
// depth kpad (a multiple of the k-step, of 16 with PROMOTE) to them: all the warp's n-tiles at once, two
// k-steps unrolled, pass by pass across its n-tiles so that consecutive
// mma.sync are independent. With PROMOTE each 16-deep K-chunk's sum starts
// from 0 and joins the fp32 sum with an fp32 add (3xTF32; the tensor core
// truncates its own sums). expand_store calls epi(row, m, value) for each
// of the warp's elements; expand_halo is the two over one K block.
template <int NTE, int MTE>
struct ExpandAcc {
  static constexpr int JE = (NTE + kWarps - 1) / kWarps;
  float v[JE][MTE][4];
};

template <typename T, bool PROMOTE, int NTE, int MTE>
__device__ __forceinline__ void expand_acc(ExpandAcc<NTE, MTE>& ae, const T* Ws, int ldw,
                                           const T* Xs, int xld, int kpad, int warp, int lane) {
  using O = Ops<T>;
  constexpr int JE = ExpandAcc<NTE, MTE>::JE, PC = PROMOTE ? 16 / O::KSTEP : 1;
#pragma unroll 2
  for (int k0 = 0; k0 < kpad; k0 += PC * O::KSTEP) {
    float part[PROMOTE ? JE : 1][MTE][4];
#pragma unroll
    for (int s = 0; s < PC; ++s) {
      const int kk = k0 + s * O::KSTEP;
      typename O::A a[MTE];
      typename O::B bb[JE];
#pragma unroll
      for (int mt = 0; mt < MTE; ++mt) O::load_a(a[mt], Ws, ldw, 16 * mt, kk, lane);
#pragma unroll
      for (int jj = 0; jj < JE; ++jj) {
        const int j = warp + kWarps * jj;
        if (j < NTE) O::load_b(bb[jj], Xs, xld, 8 * j, kk, lane);
      }
#pragma unroll
      for (int p = 0; p < O::kPasses; ++p)
#pragma unroll
        for (int jj = 0; jj < JE; ++jj) {
          if (warp + kWarps * jj < NTE) {
#pragma unroll
            for (int mt = 0; mt < MTE; ++mt) {
              if constexpr (PROMOTE)
                O::pass(p, s == 0, part[jj][mt], a[mt], bb[jj]);
              else
                O::pass(p, false, ae.v[jj][mt], a[mt], bb[jj]);
            }
          }
        }
    }
    if constexpr (PROMOTE) {
#pragma unroll
      for (int jj = 0; jj < JE; ++jj)
        if (warp + kWarps * jj < NTE) {
#pragma unroll
          for (int mt = 0; mt < MTE; ++mt)
#pragma unroll
            for (int c = 0; c < 4; ++c) ae.v[jj][mt][c] += part[jj][mt][c];
        }
    }
  }
}

template <int NTE, int MTE, class Epi>
__device__ __forceinline__ void expand_store(const ExpandAcc<NTE, MTE>& ae, int warp, int lane,
                                             Epi epi) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int jj = 0; jj < ExpandAcc<NTE, MTE>::JE; ++jj) {
    const int j = warp + kWarps * jj;
    if (j < NTE) {
#pragma unroll
      for (int mt = 0; mt < MTE; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          epi(8 * j + t2 + (c & 1), 16 * mt + g + (c >> 1) * 8, ae.v[jj][mt][c]);
    }
  }
}

template <typename T, int NTE, int MTE, bool PROMOTE, class Epi>
__device__ __forceinline__ void expand_halo(const T* Ws, int ldw, const T* Xs, int xld, int kpad,
                                            int warp, int lane, Epi epi) {
  ExpandAcc<NTE, MTE> ae = {};
  expand_acc<T, PROMOTE>(ae, Ws, ldw, Xs, xld, kpad, warp, lane);
  expand_store(ae, warp, lane, epi);
}

}  // namespace
}  // namespace accunet
