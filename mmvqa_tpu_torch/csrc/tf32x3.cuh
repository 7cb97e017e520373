// fp32 products on the tensor cores with fp32 accuracy ("3xTF32"), shared
// by the fp32 paths of conv1x1 + statistics (conv1x1_stats.cu) and of the
// token head's backward (token_head_bwd.cu).
//
// TF32 keeps 10 of fp32's 23 mantissa bits, so one TF32 product of fp32
// operands is off by about 1e-3 relative. Each operand v is split into
//   hi = rna_tf32(v),  lo = tf32(v - hi) (cut)
// (hi + lo carries 21-22 bits of v) and a product is taken as three TF32
// products with fp32 sums, the small terms first:
//   a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi
// leaving out a_lo b_lo (below 2^-21 of |a b|). Long sums take each k8
// step's three products from zero and add them to the running sum in fp32
// (mma3_row); short ones go straight in (mma3_row_into). The error is of the
// size of fp32's own rounding of the sums (tests/test_torch_tf32.py models
// the arithmetic in numpy). At 495 TFLOP/s of dense TF32 an H100 does about
// 165 TFLOP/s of such fp32 products, against 67 on its CUDA cores: the
// bound of these kernels wherever they are not held by bytes.
//
// The products are mma.sync.m16n8k8 (row.col, tf32, fp32 sums). Operands
// are staged in shared memory as fp32 tiles by cp.async and split as their
// fragments are loaded: ldmatrix where a tile's rows are m or n, 32-bit
// loads where they are the contraction, three integer or fp32 instructions
// a value (the conversion instruction runs at a quarter of their rate).
// wgmma's .tf32 form would need both operands K-major in shared memory and
// hi and lo tiles of each held there (a pass over every staged tile); the
// fragments of mma.sync are single 32-bit elements, so one tile serves an
// operand read either way (the token head's backward reads x and gact both
// ways) and the split stays in registers. Splitting W and gact ahead into
// lo tiles was read on the card at no gain (PERF.md §6).
//
// Tiles hold fp32 rows of a multiple of 32 values with no padding; element
// (r, c) lies at r * ld + (c ^ swz(r)). A fragment read touches eight rows
// at four neighbouring columns, or four rows at eight neighbouring columns;
// swz spreads both over the 32 banks, so no read conflicts, and it keeps
// aligned groups of four columns together for 16-byte copies and ldmatrix.
#pragma once

#include "mma_sync.cuh"

namespace mmvqa {
namespace tf32 {

__host__ __device__ __forceinline__ int swz(int r) {
  return ((r & 3) << 3) | (r & 4);
}

__device__ __forceinline__ float* at(float* t, int ld, int r, int c) {
  return t + r * ld + (c ^ swz(r));
}
__device__ __forceinline__ float ld_at(const float* t, int ld, int r, int c) {
  return t[r * ld + (c ^ swz(r))];
}

// hi: v rounded to TF32, to nearest, ties away from zero (cvt.rna.tf32's
// rounding): half a TF32 step added to the magnitude's bits, whose low 13
// bits the tensor cores do not read; lo: the exact rest v - hi, which the
// tensor cores read cut to TF32. Three integer and fp32 instructions at full
// rate (the conversion instruction is not).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) + 0x1000u;
  lo = __float_as_uint(v - __uint_as_float(hi & 0xFFFFE000u));
}

struct FragA {  // 16 x 8: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
  uint32_t hi[4], lo[4];
};
struct FragB {  // 8 x 8: (t, g), (t + 4, g)
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma1(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b, from zero
__device__ __forceinline__ void mma1z(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// d[j] += a b[j] to fp32 accuracy for N B fragments: each one's three TF32
// products of this k8 step, the small terms first, summed from zero in the
// tensor cores and added to d by fp32 adds, stage by stage so that the N
// chains of three dependent products are in flight together. The tensor
// cores' sums cut what they shift out (read on the card: summed straight
// into d, y of K4 at K = 3072 drifted 5e-5 from the plain product, beyond
// TOL_K4_F32); from zero, each step's sum is small and so is the cut
// (tests/test_torch_tf32.py models both).
template <int N>
__device__ __forceinline__ void mma3_row(float (&d)[N][4], const FragA& a,
                                         const FragB (&b)[N]) {
  float t[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j) mma1z(t[j], a.lo, b[j].hi[0], b[j].hi[1]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma1(t[j], a.hi, b[j].lo[0], b[j].lo[1]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma1(t[j], a.hi, b[j].hi[0], b[j].hi[1]);
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] += t[j][e];
}

// The same summed straight into d: for short sums (a contraction of up to
// 128, or a 32-deep chunk, whose result is added to an fp32 sum outside),
// where the tensor cores' cut costs less than the adds it saves
template <int N>
__device__ __forceinline__ void mma3_row_into(float (&d)[N][4], const FragA& a,
                                              const FragB (&b)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma1(d[j], a.lo, b[j].hi[0], b[j].hi[1]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma1(d[j], a.hi, b[j].lo[0], b[j].lo[1]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma1(d[j], a.hi, b[j].hi[0], b[j].hi[1]);
}
__device__ __forceinline__ void mma3_into(float (&d)[4], const FragA& a,
                                          const FragB& b) {
  mma1(d, a.lo, b.hi[0], b.hi[1]);
  mma1(d, a.hi, b.lo[0], b.lo[1]);
  mma1(d, a.hi, b.hi[0], b.hi[1]);
}

// Fragments by shared-memory loads where a tile's rows are the contraction
// (A(m, k) = t(k, m); B(k, n) = t(k, n)): ldmatrix moves 16-bit pairs, not
// these transposed 32-bit elements. g = lane / 4, q = lane % 4.
__device__ __forceinline__ void load_a_t(FragA& f, const float* t, int ld,
                                         int m0, int k0, int g, int q) {
  split(ld_at(t, ld, k0 + q, m0 + g), f.hi[0], f.lo[0]);
  split(ld_at(t, ld, k0 + q, m0 + g + 8), f.hi[1], f.lo[1]);
  split(ld_at(t, ld, k0 + q + 4, m0 + g), f.hi[2], f.lo[2]);
  split(ld_at(t, ld, k0 + q + 4, m0 + g + 8), f.hi[3], f.lo[3]);
}
__device__ __forceinline__ void load_b(FragB& f, const float* t, int ld,
                                       int k0, int n0, int g, int q) {
  split(ld_at(t, ld, k0 + q, n0 + g), f.hi[0], f.lo[0]);
  split(ld_at(t, ld, k0 + q + 4, n0 + g), f.hi[1], f.lo[1]);
}

// Fragments by ldmatrix where a tile's rows are m (A) or n (B) and its
// columns the contraction: each 8 x 8 b16 matrix of ldmatrix is 8
// rows of four fp32 values, and hands thread t the value at (t / 4, t % 4),
// which is the m16n8k8 tf32 layout. One instruction for an A fragment at
// (m0, k0), one for a B fragment at (k0, n0) or those of two n8 tiles (n0
// and n0 + 8).
__device__ __forceinline__ void ldsm_a(FragA& f, const float* t, int ld,
                                       int m0, int k0, int lane) {
  const int j = lane / 8;  // matrix j: rows + 8 (j & 1), columns + 4 (j / 2)
  unsigned v[4];
  ldsm_x4(v, t + (m0 + (j & 1) * 8 + lane % 8) * ld +
                 ((k0 + (j >> 1) * 4) ^ swz(lane % 8)));
#pragma unroll
  for (int e = 0; e < 4; ++e) split(__uint_as_float(v[e]), f.hi[e], f.lo[e]);
}
__device__ __forceinline__ void ldsm_b1(FragB& f, const float* t, int ld,
                                        int k0, int n0, int lane) {
  const int j = (lane / 8) & 1;  // matrix j: columns + 4 j (lanes 0-15)
  unsigned v0, v1;
  ldsm_x2(v0, v1, t + (n0 + lane % 8) * ld + ((k0 + j * 4) ^ swz(lane % 8)));
  split(__uint_as_float(v0), f.hi[0], f.lo[0]);
  split(__uint_as_float(v1), f.hi[1], f.lo[1]);
}
__device__ __forceinline__ void ldsm_b2(FragB& f0, FragB& f1, const float* t,
                                        int ld, int k0, int n0, int lane) {
  const int j = lane / 8;  // matrix j: rows + 8 (j / 2), columns + 4 (j & 1)
  unsigned v[4];
  ldsm_x4(v, t + (n0 + (j >> 1) * 8 + lane % 8) * ld +
                 ((k0 + (j & 1) * 4) ^ swz(lane % 8)));
  split(__uint_as_float(v[0]), f0.hi[0], f0.lo[0]);
  split(__uint_as_float(v[1]), f0.hi[1], f0.lo[1]);
  split(__uint_as_float(v[2]), f1.hi[0], f1.lo[0]);
  split(__uint_as_float(v[3]), f1.hi[1], f1.lo[1]);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// A matrix in device memory: element (r, c) at p[row(r) + c * sc], rows
// [0, nr), columns [0, nc); vec: sc = 1, every row's start and p on 16
// bytes and nc % 4 = 0, so that four neighbouring columns are one 16-byte
// copy, all inside or all outside.
struct Dense {  // row(r) = r * ld
  const float* p;
  long long ld, sc;
  int nr, nc;
  bool vec;
  __device__ __forceinline__ long long row(int r) const { return r * ld; }
};
struct Positions {  // rows are b * P + p of a (B, P, .) tensor by strides
  const float* p;
  long long sb, sp, sc;
  int P, nr, nc;
  bool vec;
  __device__ __forceinline__ long long row(int r) const {
    const int b = r / P;
    return b * sb + (long long)(r - b * P) * sp;
  }
};

// Start the copies of the (R x CC) block at (r0, c0) of `src` into the tile
// t (ld = CC, a multiple of 32), zeros outside the matrix. The caller
// commits. Thread `tid` of `nthreads` takes its share.
template <class Src>
__device__ __forceinline__ void stage(float* t, int R, int CC, const Src& src,
                                      int r0, int c0, int tid, int nthreads) {
  if (src.vec) {
    const int pieces = CC / 4;
    for (int i = tid; i < R * pieces; i += nthreads) {
      const int r = i / pieces, c = (i % pieces) * 4;
      const bool in = r0 + r < src.nr && c0 + c < src.nc;
      cp_async16(at(t, CC, r, c),
                 in ? src.p + src.row(r0 + r) + c0 + c : src.p, in);
    }
  } else {
    for (int i = tid; i < R * CC; i += nthreads) {
      const int r = i / CC, c = i % CC;
      const bool in = r0 + r < src.nr && c0 + c < src.nc;
      cp_async4(at(t, CC, r, c),
                in ? src.p + src.row(r0 + r) + (long long)(c0 + c) * src.sc
                   : src.p,
                in);
    }
  }
}

constexpr int kThreads = 256;  // 8 warps: 2 along m, 4 along n
constexpr int kChunk = 32;     // contraction depth of a stage

// Where an operand's rows lie in its staged chunk: m (or n) rows of 32
// contraction values, or 32 contraction rows of m (or n) values.
enum Rows { kOuterRows = 0, kInnerRows = 1 };

// acc += A B over the contraction [0, klen) for a BM x BN output tile, 32 at
// a time through a ring of STAGES chunk pairs. A's chunk kt is the block at
// (a_r0, a_c0) advanced by kt * 32 along its contraction axis (columns for
// kOuterRows, rows for kInnerRows); B's the same. Warp w owns rows
// (w / 4) * BM / 2 .. and columns (w % 4) * BN / 4 ..; acc[i][j] is the
// m16 x n8 fragment (i, j) of that warp tile. Ends with a block barrier:
// the ring may be refilled by the caller. UNROLL: k8 steps unrolled (1: the
// fragments of one step at a time, for accumulators that leave no registers
// to hoist the next step's; 2 for the small tiles, faster on the card).
// CHUNK: the tensor cores sum a whole 32-deep chunk (twelve products) from
// zero before the fp32 add into acc, a quarter of mma3_row's adds, for a
// second set of accumulators' registers; else each k8 step's (mma3_row).
template <int BM, int BN, int STAGES, int AROWS, int BROWS, int UNROLL,
          bool CHUNK = false, class SA, class SB>
__device__ __forceinline__ void product(float (&acc)[BM / 32][BN / 32][4],
                                        float* ring, const SA& sa, int a_r0,
                                        int a_c0, const SB& sb, int b_r0,
                                        int b_c0, int klen) {
  constexpr int MI = BM / 32, NI = BN / 32;
  constexpr int kA = BM * kChunk, kB = BN * kChunk, kStage = kA + kB;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = (warp / 4) * (BM / 2), wn = (warp % 4) * (BN / 4);
  const int nk = (klen + kChunk - 1) / kChunk;
  auto issue = [&](int kt) {
    float* ta = ring + (kt % STAGES) * kStage;
    float* tb = ta + kA;
    const int d = kt * kChunk;
    if (AROWS == kOuterRows)
      stage(ta, BM, kChunk, sa, a_r0, a_c0 + d, tid, kThreads);
    else
      stage(ta, kChunk, BM, sa, a_r0 + d, a_c0, tid, kThreads);
    if (BROWS == kOuterRows)
      stage(tb, BN, kChunk, sb, b_r0, b_c0 + d, tid, kThreads);
    else
      stage(tb, kChunk, BN, sb, b_r0 + d, b_c0, tid, kThreads);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) issue(s);
    commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    wait_groups<STAGES - 2>();
    __syncthreads();  // chunk kt is in; chunk kt - 1's buffer is free
    if (kt + STAGES - 1 < nk) issue(kt + STAGES - 1);
    commit();
    const float* ta = ring + (kt % STAGES) * kStage;
    const float* tb = ta + kA;
    float t[CHUNK ? MI : 1][CHUNK ? NI : 1][4];
    if (CHUNK) {
#pragma unroll
      for (int i = 0; i < (CHUNK ? MI : 1); ++i)
#pragma unroll
        for (int j = 0; j < (CHUNK ? NI : 1); ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) t[i][j][e] = 0.0f;
    }
#pragma unroll UNROLL
    for (int k8 = 0; k8 < kChunk; k8 += 8) {
      FragB fb[NI];
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        if (BROWS == kOuterRows) {
          ldsm_b2(fb[j], fb[j + 1], tb, kChunk, k8, wn + j * 8, lane);
        } else {
          load_b(fb[j], tb, BN, k8, wn + j * 8, g, q);
          load_b(fb[j + 1], tb, BN, k8, wn + j * 8 + 8, g, q);
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        FragA fa;
        if (AROWS == kOuterRows)
          ldsm_a(fa, ta, kChunk, wm + i * 16, k8, lane);
        else
          load_a_t(fa, ta, BM, wm + i * 16, k8, g, q);
        if constexpr (CHUNK)
          mma3_row_into(t[i], fa, fb);
        else
          mma3_row(acc[i], fa, fb);
      }
    }
    if constexpr (CHUNK) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += t[i][j][e];
    }
  }
  wait_groups<0>();
  __syncthreads();
}

}  // namespace tf32
}  // namespace mmvqa
