// The bf16 tile machinery shared by the token head's forward (token_head.cu)
// and backward (token_head_bwd.cu) on the tensor cores.
//
// Both take the positions as one axis of B * P rows, so that a tile of rows
// may straddle images and the small maps (P = 49, 196) waste no padded tile
// per image. x (B, P, K) is read by strides; W (K, C) is contiguous. A tile's
// x and W are staged in shared memory by cp.async (16-byte copies where the
// rows are 16-byte aligned, element copies where not), zero past the rows,
// past K and past C, and the products run on mma.sync.m16n8k16 in bf16 with
// fp32 sums, their fragments loaded by ldmatrix (csrc/mma_sync.cuh).
#pragma once

#include "mma_sync.cuh"

namespace mmvqa {
namespace k1 {

enum Act : int { kSerf = 0, kSerfFast = 1, kRelu = 2 };

// What the staging reads; the backward's gradients ride along.
struct Args {
  const void* x;
  long long sb, sp, sk;
  const void* w;
  const float* g;
  void* dx;
  long long dsb, dsp, dsk;
  float* part;
  float* dw;
  unsigned* bar;
  int B, P, K, C;
  int tp;               // rows of a tile
  int items_per_block;  // tiles of a block
  // the plan's mode (the kernels take theirs as a template argument): kept
  // in the launch's arguments, whose layout the bf16 backward's code
  // generation follows; without it that kernel ran 1.6% slower on the card
  int mode;
};

// element offset of row n (= b * P + p) in a (B, P, K) tensor of strides
// (sb, sp)
__device__ __forceinline__ long long row_offset(int n, int P, long long sb,
                                                long long sp) {
  const int b = n / P;
  return b * sb + (long long)(n - b * P) * sp;
}

constexpr int kChunkK = 32;    // k's of a streamed stage
constexpr int kChunkC = 128;   // channels of the backward's s tile
constexpr int kXRow = kChunkK + 8;   // bf16 row stride of a staged x chunk:
                                     // 80 bytes, eight rows on distinct banks
constexpr int kWRow = kChunkC + 8;   // of a staged W chunk: 272 bytes

// k's of an x tile staged whole (W resident): K in 32s
__host__ __device__ inline int resident_k(int K) {
  return (K + kChunkK - 1) / kChunkK * kChunkK;
}

// an arrival on `bar` once every cp.async this thread has issued is done
// (the barrier's count includes it)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// x[rows of tile `item`, k0 .. k0 + nk] into xs (row stride xld); zero past
// the rows and past K. Thread `tid` of `nthreads` takes its share.
template <int TP>
__device__ __forceinline__ void stage_x(const Args& a, __nv_bfloat16* xs,
                                        int xld, int item, int k0, int nk,
                                        bool vec, int tid, int nthreads) {
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const int N = a.B * a.P;
  if (vec) {  // 16-byte copies: sk = 1, rows 16-byte aligned, K % 8 = 0
    const int pieces = nk / 8;
    for (int i = tid; i < TP * pieces; i += nthreads) {
      const int r = i / pieces;
      const int kk = (i % pieces) * 8;
      const int n = item * TP + r;
      const bool in = n < N && k0 + kk < a.K;
      const __nv_bfloat16* src =
          in ? x + row_offset(n, a.P, a.sb, a.sp) + k0 + kk : x;
      cp_async16(xs + r * xld + kk, src, in);
    }
  } else {  // element copies, neighbouring threads on neighbouring addresses
    for (int i = tid; i < TP * nk; i += nthreads) {
      int r, kk;
      if (a.sp == 1) {
        kk = i / TP;
        r = i % TP;
      } else {
        r = i / nk;
        kk = i % nk;
      }
      const int n = item * TP + r;
      const int k = k0 + kk;
      xs[r * xld + kk] =
          (n < N && k < a.K)
              ? x[row_offset(n, a.P, a.sb, a.sp) + (long long)k * a.sk]
              : __float2bfloat16(0.0f);
    }
  }
}

// W[k0 .. k0 + nk, c0 .. c0 + nc] into ws (row stride wld); zero past K
// and C. Thread `tid` of `nthreads` takes its share.
__device__ __forceinline__ void stage_w(const Args& a, __nv_bfloat16* ws,
                                        int wld, int k0, int nk, int c0,
                                        int nc, bool vec, int tid,
                                        int nthreads) {
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);
  if (vec) {  // C % 8 = 0 and w 16-byte aligned
    const int pieces = nc / 8;
    for (int i = tid; i < nk * pieces; i += nthreads) {
      const int kk = i / pieces;
      const int cc = (i % pieces) * 8;
      const int k = k0 + kk, c = c0 + cc;
      const bool in = k < a.K && c < a.C;
      cp_async16(ws + kk * wld + cc, in ? w + (long long)k * a.C + c : w, in);
    }
  } else {
    for (int i = tid; i < nk * nc; i += nthreads) {
      const int kk = i / nc;
      const int cc = i % nc;
      const int k = k0 + kk, c = c0 + cc;
      ws[kk * wld + cc] = (k < a.K && c < a.C) ? w[(long long)k * a.C + c]
                                               : __float2bfloat16(0.0f);
    }
  }
}

// 16-byte copies of x where every row starts on 16 bytes; of W where C is
// a multiple of 8 and w is 16-byte aligned
inline bool vec_x_ok(const void* x, long long sb, long long sp, long long sk,
                     int K) {
  return sk == 1 && K % 8 == 0 && sp % 8 == 0 && sb % 8 == 0 &&
         reinterpret_cast<size_t>(x) % 16 == 0;
}

inline bool vec_w_ok(const void* w, int C) {
  return C % 8 == 0 && reinterpret_cast<size_t>(w) % 16 == 0;
}

template <typename K>
cudaError_t allow_smem(K* kern, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) cudaGetLastError();  // must not fail the next call
  return err;
}

}  // namespace k1
}  // namespace mmvqa
