// The tensor-core building blocks shared by the RealFormer attention's two
// bf16 kernels, the forward (realformer_attention.cu, tc::) and the
// backward (realformer_attention_bwd.cu, k2bwd::tc::): a head's rows staged
// in bf16 shared memory by 16-byte cp.async, its flat (T, T) fp32 blocks
// copied in and out by 16-byte copies with their offset within 16 bytes
// kept, the softmax of a warp's rows in the mma.sync accumulator layout, an
// fp32 pair split into two bf16 terms, and the dispatch on the count of
// 16-row tiles.
#pragma once

#include <type_traits>

#include "mma_sync.cuh"

namespace mmvqa {
namespace k2tc {

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

constexpr int kPad = 8;  // bf16 elements past a staged row: rows 16 bytes x
                         // an odd count apart, so ldmatrix meets no conflict

constexpr int kMaxTiles = 8;  // Tp <= 128: the registers of a warp's rows

// the warps of a block: one a 16-row tile, and at least four for the copies
__host__ __device__ constexpr int warps_for(int nt) { return nt < 4 ? 4 : nt; }

// fp32 elements of a staged (T, T) block: T * T and the up to three that
// keep its offset within 16 bytes, rounded up to 16 bytes
__host__ __device__ inline int flat_floats(int T) {
  return (T * T + 3 + 3) / 4 * 4;
}

// the offset within 16 bytes of a 4-byte aligned address, in floats
__device__ __forceinline__ int flat_offset(const float* p) {
  return (int)((reinterpret_cast<size_t>(p) >> 2) & 3);
}

// rows [0, Tp) of one head of a (B, T, H, E) operand into dst (row stride
// ld), zero past T and where src is null
template <typename S>
__device__ __forceinline__ void stage(const __nv_bfloat16* src, const S& s,
                                      int b, int h, int T, int Tp, int E,
                                      __nv_bfloat16* dst, int ld, bool vec,
                                      const __nv_bfloat16* any, int tid,
                                      int nthreads) {
  const long long base = b * s.b + h * s.h;
  if (vec) {  // every row starts on 16 bytes; e is the unit-stride axis
    // copy i is row i / pieces, piece i % pieces: both carried from one
    // copy of this thread to its next, with no division in the loop
    const int pieces = E / 8, dr = nthreads / pieces, dc = nthreads % pieces;
    int r = tid / pieces, c = tid % pieces;
    for (int i = tid; i < Tp * pieces; i += nthreads) {
      const bool in = src != nullptr && r < T;
      cp_async16(dst + r * ld + 8 * c,
                 in ? src + base + r * s.t + 8 * c : any, in);
      r += dr;
      c += dc;
      if (c >= pieces) {
        c -= pieces;
        ++r;
      }
    }
  } else {
    for (int i = tid; i < Tp * E; i += nthreads) {
      const int r = i / E, e = i % E;
      dst[r * ld + e] = (src != nullptr && r < T)
                            ? src[base + r * s.t + e * s.e]
                            : __float2bfloat16(0.0f);
    }
  }
}

// a head's flat (T, T) fp32 block of n = T * T elements into dst (16-byte
// aligned), by 16-byte copies: dst[off + i] = src[i], where off keeps src's
// offset within 16 bytes so that both sides of every copy are aligned; the
// peeled ends (at most three elements each) by plain loads. Returns off.
__device__ __forceinline__ int stage_flat(const float* src, int n, float* dst,
                                          int tid, int nthreads) {
  const int off = flat_offset(src);
  const int head = min((4 - off) & 3, n);
  const int pieces = (n - head) / 4;
  for (int i = tid; i < pieces; i += nthreads)
    cp_async16(dst + off + head + 4 * i, src + head + 4 * i, true);
  const int tail = head + 4 * pieces;
  for (int i = tid; i < head + n - tail; i += nthreads) {
    const int e = i < head ? i : tail + i - head;
    dst[off + e] = src[e];
  }
  return off;
}

// stage_flat reversed: dst[i] = src[off + i] for i < n, where off is dst's
// offset within 16 bytes (flat_offset(dst)), by 16-byte stores
__device__ __forceinline__ void store_flat(const float* src, int n, float* dst,
                                           int tid, int nthreads) {
  const int off = flat_offset(dst);
  const int head = min((4 - off) & 3, n);
  const int pieces = (n - head) / 4;
  for (int i = tid; i < pieces; i += nthreads)
    *reinterpret_cast<float4*>(dst + head + 4 * i) =
        *reinterpret_cast<const float4*>(src + off + head + 4 * i);
  const int tail = head + 4 * pieces;
  for (int i = tid; i < head + n - tail; i += nthreads) {
    const int e = i < head ? i : tail + i - head;
    dst[e] = src[off + e];
  }
}

// the two bf16 terms of (x0, x1): hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split(float x0, float x1, unsigned& hi,
                                      unsigned& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l2 = __floats2bfloat162_rn(
      x0 - __low2float(h2), x1 - __high2float(h2));
  hi = *reinterpret_cast<const unsigned*>(&h2);
  lo = *reinterpret_cast<const unsigned*>(&l2);
}

// p = softmax over the keys of each of a thread's two rows, in place: the
// quad of a row holds all of its columns. exp(s - max) is one ex2 of
// (s - max) log2 e, within about 2^-22 of it, far below the bf16 terms p
// goes into; a row of -inf (padded) gives every p 0.
template <int NT>
__device__ __forceinline__ void softmax_rows(float (&p)[2 * NT][4]) {
  constexpr float kLog2e = 1.4426950408889634f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float m = neg_inf();
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
      m = fmaxf(m, fmaxf(p[j][2 * half], p[j][2 * half + 1]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    if (m == neg_inf()) m = 0.0f;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float e = ex2_ftz((p[j][2 * half + c] - m) * kLog2e);
        p[j][2 * half + c] = e;
        sum += e;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = sum > 0.0f ? 1.0f / sum : 0.0f;
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      p[j][2 * half] *= inv;
      p[j][2 * half + 1] *= inv;
    }
  }
}

// f(std::integral_constant<int, NT>) for NT = ceil(T / 16)
template <typename F>
cudaError_t dispatch(int T, F f) {
  switch ((T + 15) / 16) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7: return f(std::integral_constant<int, 7>());
    case 8: return f(std::integral_constant<int, 8>());
    default: return cudaErrorInvalidValue;
  }
}

// an operand read (or written) by 16-byte copies: e the unit-stride axis
// and every row of a head on 16 bytes
template <typename S>
inline bool rows16(const void* p, const S& s) {
  return p == nullptr ||
         (s.e == 1 && s.b % 8 == 0 && s.t % 8 == 0 && s.h % 8 == 0 &&
          reinterpret_cast<size_t>(p) % 16 == 0);
}

}  // namespace k2tc
}  // namespace mmvqa
