// The tensor-core building blocks shared by the RealFormer attention's
// kernels, the forward (realformer_attention.cu, tc:: in bf16, tc32:: in
// fp32) and the backward (realformer_attention_bwd.cu, k2bwd::tc:: and
// k2bwd::tc32::): a head's rows staged in shared memory by 16-byte cp.async
// (bf16 rows padded; fp32 rows in tf32x3.cuh's swizzle), its flat (T, T)
// fp32 blocks copied in and out by 16-byte copies with their offset within
// 16 bytes kept, the softmax of a warp's rows in the mma.sync accumulator
// layout and the score epilogues around it (the forward's scale, prev and
// mask term into the flat block; the backward's carry in), an
// fp32 pair split into two bf16 terms, the fp32 kernels' key order and
// fragments, the dispatch on the count of 16-row tiles, and a launch with
// its shared-memory grant.
#pragma once

#include <type_traits>

#include "mma_sync.cuh"
#include "tf32x3.cuh"

namespace mmvqa {

constexpr float kNegBig = 10000.0f;  // the mask term: -10000 (1 - mask_q)

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
// quad of a row holds all of its columns. In bf16 exp(s - max) is one ex2
// of (s - max) log2 e, within about 2^-22 of it, far below the bf16 terms p
// goes into; the fp32 kernels (EXACT) take expf, as the plain version does.
// A row of -inf (padded) gives every p 0.
template <int NT, bool EXACT = false>
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
        const float e = EXACT ? expf(p[j][2 * half + c] - m)
                              : ex2_ftz((p[j][2 * half + c] - m) * kLog2e);
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

// the key of column c (0 or 1) of thread t4's pair in key tile j of a
// warp's score accumulators: 8 j + 2 t4 + c in the bf16 kernels, 8 j + t4 +
// 4 c in the fp32 ones (KPERM: the order kperm below sets)
template <bool KPERM>
__device__ __forceinline__ int acc_key(int j, int t4, int c) {
  return KPERM ? 8 * j + t4 + 4 * c : 8 * j + 2 * t4 + c;
}

// s / sqrt(E) (+ prev) - 10000 (1 - mask_q), the plain version's order, for
// a warp's rows r0 + g and r0 + g + 8 from its accumulators p, into the flat
// (T, T) block `flat`, which holds prev where `with_prev`, in prev's place;
// -inf past T, so that p is 0 there. mask: the batch item's T values, or
// null.
template <int NT, bool KPERM>
__device__ __forceinline__ void scores_to_flat(float (&p)[2 * NT][4],
                                               float* flat, bool with_prev,
                                               const float* mask, int T,
                                               int r0, int g, int t4,
                                               float scale) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    const float neg = (mask && r < T) ? kNegBig * (1.0f - mask[r]) : 0.0f;
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = acc_key<KPERM>(j, t4, c);
        float x = p[j][2 * half + c] * scale;
        if (r < T && col < T) {
          float* cell = flat + r * T + col;
          if (with_prev) x = x + *cell;
          if (mask) x = x - neg;
          *cell = x;
        } else {
          x = neg_inf();
        }
        p[j][2 * half + c] = x;
      }
    }
  }
}

// a warp's rows r0 + g and r0 + g + 8 of the flat (T, T) carry into the
// accumulator layout (rows and keys past T: -inf, so that p is 0 there)
template <int NT, bool KPERM>
__device__ __forceinline__ void flat_to_acc(float (&p)[2 * NT][4],
                                            const float* flat, int T, int r0,
                                            int g, int t4) {
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + g + 8 * half;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = acc_key<KPERM>(j, t4, c);
        p[j][2 * half + c] =
            (r < T && col < T) ? flat[r * T + col] : neg_inf();
      }
    }
  }
}

// `kernel`'s dynamic shared memory raised to `smem`; a refusal is cleared,
// so that it does not fail the next launch
template <typename K>
cudaError_t grant_smem(K kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// the blocks of `kernel` an SM holds at once with `threads` threads and
// `smem` bytes of shared memory
template <typename K>
cudaError_t occupancy_of(K kernel, int threads, int smem, int* blocks) {
  cudaError_t err = grant_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       threads, smem);
}

// kernel<<<grid, threads, smem, stream>>>(a), its shared memory granted
template <typename K, typename A>
cudaError_t launch_with_smem(K kernel, int grid, int threads, int smem,
                             const A& a, cudaStream_t stream) {
  cudaError_t err = grant_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
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
// and every row of a head on 16 bytes (`per16` elements a copy: 8 in bf16,
// 4 in fp32)
template <typename S>
inline bool rows16(const void* p, const S& s, int per16 = 8) {
  return p == nullptr ||
         (s.e == 1 && s.b % per16 == 0 && s.t % per16 == 0 &&
          s.h % per16 == 0 && reinterpret_cast<size_t>(p) % 16 == 0);
}

// an fp32 output written two elements a store
template <typename S>
inline bool pairs8(const void* p, const S& s) {
  return s.e == 1 && s.b % 2 == 0 && s.t % 2 == 0 && s.h % 2 == 0 &&
         reinterpret_cast<size_t>(p) % 8 == 0;
}

// ------------------------------------------ fp32: split TF32 (tc32::)

// fp32 values a staged row holds: n rounded up to 32, unpadded, as
// tf32x3.cuh's swizzle wants (tf32::at)
__host__ __device__ constexpr int ld32(int n) { return (n + 31) / 32 * 32; }

// The key order within each n8 tile of an fp32 kernel's score accumulators:
// column c holds key kperm(c) = c / 2 + 4 (c % 2). Thread t4's two columns,
// 2 t4 and 2 t4 + 1, are then keys t4 and t4 + 4, which are the k slots of
// its A fragment in m16n8k8.tf32 (a0 = (g, t4), a2 = (g, t4 + 4)): p and ds
// go into their next products from the registers as they stand, and the
// other operand is read in natural key order. The order is set by the rows
// whose addresses ldmatrix takes for the B fragments of q k^T (dctx v^T).
__host__ __device__ __forceinline__ int kperm(int c) {
  return (c >> 1) | ((c & 1) << 2);
}

// the B fragments of keys n0 .. n0 + 15 (two n8 tiles, kperm order within
// each) at contraction k0 from a swizzled tile whose rows are keys
__device__ __forceinline__ void ldsm_b2_keys(tf32::FragB& f0, tf32::FragB& f1,
                                             const float* t, int ld, int k0,
                                             int n0, int lane) {
  const int j = lane / 8;  // matrix j: keys + 8 (j / 2), columns + 4 (j & 1)
  const int r = kperm(lane % 8);
  unsigned v[4];
  ldsm_x4(v, t + (n0 + (j >> 1) * 8 + r) * ld +
                 ((k0 + (j & 1) * 4) ^ tf32::swz(r)));
  tf32::split(__uint_as_float(v[0]), f0.hi[0], f0.lo[0]);
  tf32::split(__uint_as_float(v[1]), f0.hi[1], f0.lo[1]);
  tf32::split(__uint_as_float(v[2]), f1.hi[0], f1.lo[0]);
  tf32::split(__uint_as_float(v[3]), f1.hi[1], f1.lo[1]);
}

// the A fragment (16 rows x 8 keys) of one key tile from its accumulators,
// kperm order, as hi and lo terms
__device__ __forceinline__ void acc_to_a(tf32::FragA& f, const float (&c)[4]) {
  tf32::split(c[0], f.hi[0], f.lo[0]);  // (g, t4)
  tf32::split(c[2], f.hi[1], f.lo[1]);  // (g + 8, t4)
  tf32::split(c[1], f.hi[2], f.lo[2]);  // (g, t4 + 4)
  tf32::split(c[3], f.hi[3], f.lo[3]);  // (g + 8, t4 + 4)
}

// rows [0, Tp) of one head of a (B, T, H, E) fp32 operand into the swizzled
// tile dst (rows of ld32(E)), zero past T and E and where src is null
// (`any`: a valid address for the copies that read nothing)
template <typename S>
__device__ __forceinline__ void stage32(const float* src, const S& s, int b,
                                        int h, int T, int Tp, int E,
                                        float* dst, bool vec, const float* any,
                                        int tid, int nthreads) {
  const tf32::Dense d{src ? src + b * s.b + h * s.h : any, s.t, s.e,
                      src ? T : 0, E, vec};
  tf32::stage(dst, Tp, ld32(E), d, 0, 0, tid, nthreads);
}

// rows r0 + g and r0 + g + 8 (those below T), columns e0 + 8 n + 2 t4 and
// + 1 of a (B, T, H, E) fp32 output from an m16n8 accumulator pair, times
// `scale`, by 8-byte stores
template <typename S>
__device__ __forceinline__ void store_rows32(float* out, const S& s, int b,
                                             int h, int T, int r0, int e0,
                                             const float (&acc)[2][4],
                                             float scale, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= T) continue;
    float* row = out + b * s.b + r * s.t + h * s.h;
#pragma unroll
    for (int n = 0; n < 2; ++n)
      *reinterpret_cast<float2*>(row + e0 + 8 * n + 2 * t4) = make_float2(
          acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
  }
}

}  // namespace k2tc
}  // namespace mmvqa
