// The halo tiles shared by the depthwise 3x3 forward (depthwise3x3.cu) and
// backward (depthwise3x3_bwd.cu).
//
// A block owns one channel tile of `ct` channels (32, a multiple of 16
// bytes), a strip of `s` rows and a run of `tw` columns of the plane, and
// walks `steps` stages of `p` images each. A stage is the
// (p, s + 2, tw + 2, ct) halo tile of those images (the backward adds the
// (p, s, tw, ct) centre box of x), staged in shared memory in that order
// (channels innermost), in a ring of two: stage i + 1 loads while stage i
// computes. Positions outside the plane, images beyond B and channels
// beyond C arrive as zeros, so the SAME border costs no branch. The launch
// plan (ops/tiling.py::depthwise_plan) sizes the grid to one wave of the
// blocks an SM holds, each walking many stages.
//
// How a stage arrives (Plan.copy, chosen by the launch plan):
//   kTma       one thread asks the Tensor Memory Accelerator for each box: a
//              4-D tensor map over the channels-last map, dims (C, W, H, B),
//              box (ct, tw + 2, s + 2, p) from (c0, w0 - 1, h0 - 1, b0) (the
//              centre box: (ct, tw, s, p) from (c0, w0, h0, b0)); the
//              hardware fills what lies outside with zeros and reports to an
//              mbarrier. Needs the base address and C * bytes to be
//              multiples of 16 bytes.
//   kElements  where the rows are not 16-byte aligned no 16-byte copy is
//              possible: element copies, every thread its share, cp.async of
//              4 bytes for fp32, plain 2-byte loads for bf16, zeros outside.
// The tensor map is encoded on the host per call (common.cuh's
// tensor_map_encoder).
#pragma once

#include <cuda.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace mmvqa {
namespace dw3 {

// Threads of a block: more, smaller blocks an SM hide the stages' waits
// better; blocks of up to 256 threads ran slower at the flagship sites in
// both directions.
constexpr int kMaxThreads = 128;
constexpr int kTileAlign = 128;  // TMA's shared-memory destination
// Channels a thread owns, both directions and dtypes: 16 bytes of fp32, 8 of
// bf16. With 8 bf16 channels (16-byte reads) the forward's taps and window
// take twice the registers, an SM holds half the threads, and it ran slower
// at the flagship sites; the backward's window, taps and nine dW sums alone
// would take 216 registers.
constexpr int kVec = 4;

enum Copy : int { kTma = 0, kElements = 1 };

// ops/tiling.py::DepthwisePlan, less what the grid and block already say.
struct Plan {
  int B, H, W, C;
  int ct;     // channels of a tile
  int tw;     // columns of a tile
  int s;      // rows of a strip
  int p;      // images of a stage
  int steps;  // stages of a block
  int ncol;   // column tiles; gridDim.y = ncol * strips
};

__host__ __device__ inline int round_up(int a, int m) {
  return (a + m - 1) / m * m;
}

// The halo box of a stage, (p, s + 2, tw + 2, ct), and the backward's
// centre box of x, (p, s, tw, ct), in bytes.
template <typename T>
__host__ __device__ inline int halo_bytes(const Plan& pl) {
  return pl.p * (pl.s + 2) * (pl.tw + 2) * pl.ct * (int)sizeof(T);
}

template <typename T>
__host__ __device__ inline int centre_bytes(const Plan& pl) {
  return pl.p * pl.s * pl.tw * pl.ct * (int)sizeof(T);
}

// A stage: the halo box (the forward's x, the backward's dy), then in the
// backward the centre box of x, each from a 128-byte boundary.
template <typename T>
__host__ __device__ inline int stage_bytes(const Plan& pl, bool backward) {
  return round_up(halo_bytes<T>(pl), kTileAlign) +
         (backward ? round_up(centre_bytes<T>(pl), kTileAlign) : 0);
}

// Shared memory: [two stages, or the backward's reduction buffer if larger]
// [9 x ct fp32 taps] [two mbarriers, the backward's last-block flag: 32
// bytes]. ops/tiling.py::depthwise_plan computes the same sum.
template <typename T>
__host__ __device__ inline int stages_bytes(const Plan& pl, int threads,
                                            int vec, bool backward) {
  const int two = 2 * stage_bytes<T>(pl, backward);
  const int red = backward ? round_up(threads * vec * 4, kTileAlign) : 0;
  return two > red ? two : red;
}

template <typename T>
__host__ __device__ inline int smem_bytes(const Plan& pl, int threads, int vec,
                                          bool backward) {
  return stages_bytes<T>(pl, threads, vec, backward) + 9 * pl.ct * 4 + 32;
}

// 4 bytes from global to shared memory, or 4 zero bytes where !in.
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c, int w, int h,
                                        int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// The element copies: the (p, rows, cols, ct) box of src that starts at
// (b0, h0, w0, c0), every thread its share, zeros outside.
template <typename T>
__device__ __forceinline__ void copy_box(const T* __restrict__ src, T* dst,
                                         const Plan& pl, int c0, int h0,
                                         int w0, int b0, int rows, int cols) {
  const int n = pl.p * rows * cols * pl.ct;
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int e = q % pl.ct;
    const int pos = q / pl.ct;
    const int j = pos % cols;
    const int i = (pos / cols) % rows;
    const int img = pos / (cols * rows);
    const int c = c0 + e, w = w0 + j, h = h0 + i, b = b0 + img;
    const bool in =
        c < pl.C && w >= 0 && w < pl.W && h >= 0 && h < pl.H && b < pl.B;
    const T* from =
        in ? src + (((long long)b * pl.H + h) * pl.W + w) * pl.C + c : src;
    T* to = dst + pos * pl.ct + e;
    if constexpr (sizeof(T) == 4)
      cp_async(to, from, in);
    else
      *to = in ? *from : from_f32<T>(0.0f);
  }
}

// Stage images [b0, b0 + p): the halo box of `halo` (map: hmap) into dst
// and, where `centre` is given (the backward's x; map: cmap), its centre box
// right after. With kTma thread 0 issues the copies, which complete on *bar;
// otherwise every thread copies its share and commits one cp.async group
// (empty for bf16, whose plain loads are done when the wait comes).
template <typename T, int COPY>
__device__ __forceinline__ void issue_stage(
    const CUtensorMap* hmap, const T* __restrict__ halo,
    const CUtensorMap* cmap, const T* __restrict__ centre, T* dst,
    uint64_t* bar, const Plan& pl, int c0, int h0, int w0, int b0) {
  T* cdst = dst + round_up(halo_bytes<T>(pl), kTileAlign) / (int)sizeof(T);
  if constexpr (COPY == kTma) {
    if (threadIdx.x == 0) {
      // the stage was last read by the generic proxy (synchronised by the
      // caller); order those reads before the async proxy's writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const int bytes =
          halo_bytes<T>(pl) + (centre ? centre_bytes<T>(pl) : 0);
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
              smem_u32(bar)),
          "r"(bytes)
          : "memory");
      tma_box(dst, hmap, bar, c0, w0 - 1, h0 - 1, b0);
      if (centre) tma_box(cdst, cmap, bar, c0, w0, h0, b0);
    }
  } else {
    copy_box<T>(halo, dst, pl, c0, h0 - 1, w0 - 1, b0, pl.s + 2, pl.tw + 2);
    if (centre) copy_box<T>(centre, cdst, pl, c0, h0, w0, b0, pl.s, pl.tw);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
}

// Wait until the stage of use number `use` of this buffer has arrived, for
// every thread. `later` says whether a later stage's copies were issued.
template <int COPY>
__device__ __forceinline__ void wait_stage(uint64_t* bar, int use, bool later) {
  if constexpr (COPY == kTma) {
    mbar_wait(bar, use & 1);
  } else if (later) {
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  }
  __syncthreads();
}

// The block's 9 x ct tap slab, once, rounded to the map's dtype as the JAX
// package casts the weight (zeros beyond C). Read in the order of the
// weight's unit stride: the convolution's (C, 1, 3, 3) master (strides
// (1, 9)) and a dense (3, 3, C) weight (strides (C, 1)) both coalesce.
template <typename T>
__device__ __forceinline__ void load_taps(const TapWeights& w, float* taps,
                                          int c0, const Plan& pl) {
  const int n = 9 * pl.ct;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool by_tap = w.sc == 1;
    const int t = by_tap ? i / pl.ct : i % 9;
    const int cc = by_tap ? i % pl.ct : i / 9;
    const int c = c0 + cc;
    taps[t * pl.ct + cc] = c < pl.C ? to_f32(from_f32<T>(w.at(t, c))) : 0.0f;
  }
}

// One-time barrier set-up by thread 0 (kTma only); the caller synchronises.
__device__ __forceinline__ void init_barriers(uint64_t* bar) {
  mbar_init(&bar[0], 1);
  mbar_init(&bar[1], 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// VEC channels of a position from a shared-memory stage.
template <typename T, int VEC>
__device__ __forceinline__ void load_row3(const T* p, int ct,
                                          float (&out)[3][VEC]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) load_vec<T, VEC>(p + j * ct, out[j]);
}

template <typename T, int VEC, int GV>
__device__ __forceinline__ void store_global(T* p, int c, int C,
                                             const float (&in)[VEC]) {
  if constexpr (GV == VEC) {
    store_vec<T, VEC>(p, in);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      if (c + v < C) p[v] = from_f32<T>(in[v]);
  }
}

// The tensor map of a (B, H, W, C) channels-last map for a plan's halo box
// (halo = 1) or centre box (halo = 0). Returns false where the encoder
// refuses it (the wrapper then raises).
inline bool encode_box_map(CUtensorMap* map, const void* base, int dtype,
                           const Plan& pl, int halo) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t es = dtype == kBFloat16 ? 2 : 4;
  const cuuint64_t C = pl.C, W = pl.W, H = pl.H, B = pl.B;
  const cuuint64_t dims[4] = {C, W, H, B};
  const cuuint64_t strides[3] = {C * es, W * C * es, H * W * C * es};
  const cuuint32_t box[4] = {(cuuint32_t)pl.ct, (cuuint32_t)(pl.tw + 2 * halo),
                             (cuuint32_t)(pl.s + 2 * halo), (cuuint32_t)pl.p};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(map,
                dtype == kBFloat16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                4, const_cast<void*>(base), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Shared memory beyond 48 KB is asked for once per kernel and size.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int& granted) {
  if (bytes <= 48 * 1024 || bytes <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) granted = bytes;
  return err;
}

// The kernel variants a source builds: f(Type<T>{}, Int<COPY>{}) for the
// map's dtype and the plan's copy.
template <typename T>
struct Type {
  using type = T;
};
template <int N>
using Int = std::integral_constant<int, N>;

template <typename F>
inline cudaError_t dispatch(int dtype, int copy, F&& f) {
  auto by_copy = [&](auto t) -> cudaError_t {
    switch (copy) {
      case kTma:
        return f(t, Int<kTma>{});
      case kElements:
        return f(t, Int<kElements>{});
    }
    return cudaErrorInvalidValue;
  };
  if (dtype == kFloat32) return by_copy(Type<float>{});
  if (dtype == kBFloat16) return by_copy(Type<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

// Blocks of `kernel` an SM holds at once with this block and shared memory.
template <typename Kernel>
inline cudaError_t occupancy(Kernel kernel, int threads, int smem,
                             int& granted, int* blocks) {
  cudaError_t err = allow_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       threads, smem);
}

// n pieces of `size` cover `total`, and none is empty.
inline bool covers(long long n, long long size, long long total) {
  return n * size >= total && (n - 1) * size < total;
}

// Plan checks common to both entry points; false refuses the launch.
inline bool plan_ok(const Plan& pl, int vec, int tile_vec, int copy,
                    int threads, int nstrip, int groups, int smem) {
  constexpr int kSmemLimit = 232448;  // a block's shared memory on an H100
  constexpr int kMaxBox = 256;        // TMA's longest box side
  return vec == kVec && pl.B > 0 && pl.H > 0 && pl.W > 0 && pl.C > 0 &&
         pl.ct > 0 && pl.ct % tile_vec == 0 && pl.ct % vec == 0 &&
         pl.tw > 0 && pl.s > 0 && pl.p > 0 && pl.steps > 0 && pl.ncol > 0 &&
         nstrip > 0 && groups > 0 &&
         threads == pl.ct / vec * pl.tw * pl.p && threads <= kMaxThreads &&
         (copy == kTma || copy == kElements) &&
         pl.ncol * nstrip <= 65535 && groups <= 65535 &&
         covers(pl.ncol, pl.tw, pl.W) && covers(nstrip, pl.s, pl.H) &&
         covers(groups, pl.steps * pl.p, pl.B) && smem <= kSmemLimit &&
         pl.tw + 2 <= kMaxBox && pl.s + 2 <= kMaxBox && pl.p <= kMaxBox &&
         pl.ct <= kMaxBox;
}

}  // namespace dw3
}  // namespace mmvqa
