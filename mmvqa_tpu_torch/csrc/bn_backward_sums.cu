// K5: the two per-channel sums of a BatchNorm backward,
//   s1[c] = sum_n dy[n, c]
//   s2[c] = sum_n dy[n, c] * xhat[n, c],  xhat = (x - mean[c]) * inv_std[c],
// over an (N, C) map, accumulated in fp32.
//
// Replaces the TPU kernel tools/bn_probe.py::pallas_sums (kernel _kern,
// pallas_call at :73), which takes the map channel-major, (C, N), transposed
// for it beforehand, and carries the sums in scratch memory over a
// sequential grid of N tiles.
//
// Layout: the port's maps are channels last, so the kernel reads x and dy as
// they lie, (N, C) with C the unit-stride axis, and no transpose is made. A
// thread owns VEC neighbouring channels (one 16-byte load of x and one of
// dy a row) and walks down the rows; a block is lanes x row_groups threads
// with lanes * VEC covering a tile of channels, so a narrow map (24
// channels at the stem) still fills its block: 3 lanes x 85 row groups.
//
// What bounds it on an H100: bytes, x and dy read once and 2 C floats
// written. The plan (ops/tiling.py::channel_plan, ops/bn_sums.py) cuts the
// rows into one block an SM, within what the card says an SM holds
// (bn_backward_sums_occupancy), so every call runs in one wave. Where a
// thread's row is 16 bytes, it keeps kStages rows of x and dy in flight by
// cp.async into a ring of its own in shared memory, and reads back only what
// it copied itself, so no barrier orders the ring. (Loads into a register
// batch were no faster than one row at a time: the compiler used each row's
// registers before it issued the next row's loads.)
//
// One launch, no float atomics: a block adds its row groups in shared
// memory in a fixed order and writes one (2, C) fp32 partial; the last block
// of each channel tile to finish, found by a counter that atomicInc wraps
// back to 0, adds the tile's partials in block order. Two runs give
// identical bits.
#include <type_traits>

#include "mma_sync.cuh"

namespace mmvqa {
namespace k5 {

constexpr int kMaxThreads = 256;
constexpr int kStages = 8;  // rows of x and dy in flight a thread (16-byte
                            // rows: the ring)

// shared memory of a block of `threads` threads: the ring where a thread's
// row is 16 bytes, and in its place, once the rows are summed, the row
// groups' sums
inline int smem_bytes(int dtype, int vec, int threads) {
  const int red = 2 * vec * threads * 4;
  const bool ring = vec * (dtype == kBFloat16 ? 2 : 4) == 16;
  const int stages = ring ? kStages * threads * 32 : 0;
  return red > stages ? red : stages;
}

// VEC fp32 partials, bypassing L1: other blocks wrote them
template <int VEC>
__device__ __forceinline__ void load_partial(const float* p,
                                             float (&out)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 f = __ldcg(reinterpret_cast<const float4*>(p) + i);
      out[4 * i] = f.x;
      out[4 * i + 1] = f.y;
      out[4 * i + 2] = f.z;
      out[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = __ldcg(p + i);
  }
}

// Every thread's VEC pairs of sums, added over the row groups in order, into
// dst[0 .. C) (s1) and dst[C .. 2 C) (s2) for the block's channels. red:
// [sum][v][row group][lane].
template <int VEC>
__device__ __forceinline__ void column_sums(const float (&s1)[VEC],
                                            const float (&s2)[VEC],
                                            float* red, float* dst, int C) {
  const int lanes = blockDim.x, groups = blockDim.y;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    red[(v * groups + threadIdx.y) * lanes + threadIdx.x] = s1[v];
    red[((VEC + v) * groups + threadIdx.y) * lanes + threadIdx.x] = s2[v];
  }
  __syncthreads();
  const int tid = threadIdx.y * lanes + threadIdx.x;
  for (int i = tid; i < 2 * VEC * lanes; i += lanes * groups) {
    const int sv = i / lanes;
    const int lane = i % lanes;
    const int cc = (blockIdx.x * lanes + lane) * VEC + sv % VEC;
    if (cc >= C) continue;
    float s = 0.0f;
    for (int g = 0; g < groups; ++g)
      s += red[(sv * groups + g) * lanes + lane];
    dst[(sv / VEC) * C + cc] = s;
  }
}

// grid (ctiles, nrb), block (lanes, row_groups), smem_bytes. partial:
// (nrb, 2, C) fp32 scratch; out: (2, C); counter: ctiles unsigned ints, 0 on
// entry and on exit.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    bn_backward_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                            const float* __restrict__ mean,
                            const float* __restrict__ inv_std,
                            float* __restrict__ partial,
                            float* __restrict__ out,
                            unsigned* __restrict__ counter, long long R, int C,
                            int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* red = reinterpret_cast<float*>(smem_raw);
  __shared__ int last;

  const int groups = blockDim.y;
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const bool live = c < C;

  float s1[VEC], s2[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) s1[v] = s2[v] = 0.0f;

  if (live) {
    float mu[VEC], inv[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      mu[v] = mean[c + v];
      inv[v] = inv_std[c + v];
    }
    const long long r_begin = (long long)blockIdx.y * rows_per_block;
    const long long r_end = min(R, r_begin + rows_per_block);
    const long long r0 = r_begin + threadIdx.y;  // this thread's rows:
    const long long mine =                       // r0, r0 + groups, ...
        r0 < r_end ? (r_end - r0 + groups - 1) / groups : 0;
    if constexpr (VEC * sizeof(T) == 16) {
      // the ring: slot i % kStages holds row i's x and dy
      uint4* ring = reinterpret_cast<uint4*>(smem_raw);
      const int nthreads = blockDim.x * blockDim.y;
      const int tid = threadIdx.y * blockDim.x + threadIdx.x;
      auto issue = [&](long long i) {
        if (i < mine) {
          const long long at = (r0 + i * groups) * C + c;
          const int slot = (int)(i % kStages);
          cp_async16(&ring[2 * slot * nthreads + tid], x + at, true);
          cp_async16(&ring[(2 * slot + 1) * nthreads + tid], dy + at, true);
        }
        commit();  // an empty group past the last row keeps the count
      };
#pragma unroll
      for (int i = 0; i < kStages; ++i) issue(i);
      for (long long i = 0; i < mine; ++i) {
        wait_groups<kStages - 1>();  // row i has landed
        const int slot = (int)(i % kStages);
        float xv[VEC], d[VEC];
        load_vec<T, VEC>(
            reinterpret_cast<const T*>(&ring[2 * slot * nthreads + tid]), xv);
        load_vec<T, VEC>(
            reinterpret_cast<const T*>(&ring[(2 * slot + 1) * nthreads + tid]),
            d);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          s1[v] += d[v];
          s2[v] = fmaf(d[v], (xv[v] - mu[v]) * inv[v], s2[v]);
        }
        issue(i + kStages);  // into the slot just read
      }
      wait_groups<0>();
    } else {
      for (long long i = 0; i < mine; ++i) {
        const long long at = (r0 + i * groups) * C + c;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float d = to_f32(dy[at + v]);
          s1[v] += d;
          s2[v] = fmaf(d, (to_f32(x[at + v]) - mu[v]) * inv[v], s2[v]);
        }
      }
    }
  }
  __syncthreads();  // the ring's last reads before the row groups' sums
  column_sums<VEC>(s1, s2, red, partial + (long long)blockIdx.y * 2 * C, C);

  // the last block of this channel tile adds the tile's partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0)
    last = atomicInc(&counter[blockIdx.x], gridDim.y - 1) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int v = 0; v < VEC; ++v) s1[v] = s2[v] = 0.0f;
  if (live) {
    // thread (lane, group) adds partials group, group + groups, ... in order
#pragma unroll 2
    for (int j = threadIdx.y; j < (int)gridDim.y; j += groups) {
      float a1[VEC], a2[VEC];
      load_partial<VEC>(partial + (2LL * j) * C + c, a1);
      load_partial<VEC>(partial + (2LL * j + 1) * C + c, a2);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        s1[v] += a1[v];
        s2[v] += a2[v];
      }
    }
  }
  column_sums<VEC>(s1, s2, red, out, C);
}

// the most shared memory a launch of `kern` asks for: smem_bytes of a block
// of kMaxThreads threads
template <typename K>
cudaError_t allow_smem(K* kern) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(kBFloat16, 8, kMaxThreads));
  if (err != cudaSuccess) cudaGetLastError();  // must not fail the next call
  return err;
}

// f(T, VEC) for the kernel variant of (dtype, vec)
template <typename F>
cudaError_t dispatch(int dtype, int vec, F f) {
  if (dtype == kFloat32 && vec == 4)
    return f(float(), std::integral_constant<int, 4>());
  if (dtype == kFloat32 && vec == 1)
    return f(float(), std::integral_constant<int, 1>());
  if (dtype == kBFloat16 && vec == 8)
    return f(__nv_bfloat16(), std::integral_constant<int, 8>());
  if (dtype == kBFloat16 && vec == 1)
    return f(__nv_bfloat16(), std::integral_constant<int, 1>());
  return cudaErrorInvalidValue;
}

}  // namespace k5
}  // namespace mmvqa

// x, dy: (R, C) dense, one dtype; mean, inv_std: (C) fp32; partial:
// (nrb, 2, C) fp32 scratch; out: (2, C) fp32, [s1, s2]; counter: ctiles
// unsigned ints, zero on entry and on exit (the wrapper owns them, one
// buffer per stream: calls on two streams must not share one). vec is 16
// bytes of elements (4 fp32, 8 bf16; C a multiple of it, x and dy aligned
// to it) or 1. The launch plan is ops/tiling.py::channel_plan.
extern "C" int bn_backward_sums(const void* x, const void* dy, int dtype,
                                const void* mean, const void* inv_std,
                                void* partial, void* out, void* counter,
                                long long R, int C, int vec, int lanes,
                                int ctiles, int row_groups,
                                int rows_per_block, int nrb, void* stream) {
  using namespace mmvqa;
  if (lanes * row_groups > k5::kMaxThreads || nrb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int smem = k5::smem_bytes(dtype, vec, lanes * row_groups);
  return static_cast<int>(k5::dispatch(dtype, vec, [&](auto t, auto v) {
    using T = decltype(t);
    auto kern = k5::bn_backward_sums_kernel<T, decltype(v)::value>;
    cudaError_t err = k5::allow_smem(kern);
    if (err != cudaSuccess) return err;
    kern<<<dim3(ctiles, nrb), dim3(lanes, row_groups), smem, s>>>(
            static_cast<const T*>(x), static_cast<const T*>(dy),
            static_cast<const float*>(mean),
            static_cast<const float*>(inv_std), static_cast<float*>(partial),
            static_cast<float*>(out), static_cast<unsigned*>(counter), R, C,
            rows_per_block);
    return cudaGetLastError();
  }));
}

// Blocks of the kernel for (dtype, vec) that an SM holds at once with
// `threads` threads.
extern "C" int bn_backward_sums_occupancy(int dtype, int vec, int threads,
                                          int* blocks) {
  using namespace mmvqa;
  const int smem = k5::smem_bytes(dtype, vec, threads);
  return static_cast<int>(k5::dispatch(dtype, vec, [&](auto t, auto v) {
    auto kern = k5::bn_backward_sums_kernel<decltype(t), decltype(v)::value>;
    cudaError_t err = k5::allow_smem(kern);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                         threads, smem);
  }));
}
