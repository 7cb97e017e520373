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
// written. Rows are cut into nrb blocks to fill the card. Blocks run in no
// order: a block adds its row groups in shared memory in a fixed order and
// writes one (2, C) fp32 partial; a second kernel adds the partials in block
// order. No float atomics: two runs give identical bits.
#include "common.cuh"

namespace mmvqa {
namespace k5 {

constexpr int kMaxThreads = 256;
constexpr int kMaxVec = 8;

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    bn_backward_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                            const float* __restrict__ mean,
                            const float* __restrict__ inv_std,
                            float* __restrict__ partial, long long R, int C,
                            int rows_per_block) {
  // [sum][v][row group][lane]
  __shared__ float red[2 * kMaxVec * kMaxThreads];

  const int lanes = blockDim.x;
  const int groups = blockDim.y;
  const int c = (blockIdx.x * lanes + threadIdx.x) * VEC;
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
#pragma unroll 4
    for (long long r = r_begin + threadIdx.y; r < r_end; r += groups) {
      float xv[VEC], d[VEC];
      load_vec<T, VEC>(x + r * C + c, xv);
      load_vec<T, VEC>(dy + r * C + c, d);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        s1[v] += d[v];
        s2[v] = fmaf(d[v], (xv[v] - mu[v]) * inv[v], s2[v]);
      }
    }
  }

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
    for (int g = 0; g < groups; ++g) s += red[(sv * groups + g) * lanes + lane];
    partial[((long long)blockIdx.y * 2 + sv / VEC) * C + cc] = s;
  }
}

__global__ void bn_backward_sums_reduce_kernel(const float* __restrict__ part,
                                               float* __restrict__ out,
                                               long long n, int nparts) {
  sum_partials(part, out, n, nparts);
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* dy, const float* mean,
                   const float* inv_std, float* partial, float* out,
                   long long R, int C, int lanes, int ctiles, int row_groups,
                   int rows_per_block, int nrb, cudaStream_t stream) {
  bn_backward_sums_kernel<T, VEC>
      <<<dim3(ctiles, nrb), dim3(lanes, row_groups), 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(dy), mean, inv_std,
          partial, R, C, rows_per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = 2LL * C;
  bn_backward_sums_reduce_kernel<<<reduce_blocks(n), kReduceThreads, 0,
                                   stream>>>(partial, out, n, nrb);
  return cudaGetLastError();
}

}  // namespace k5
}  // namespace mmvqa

// x, dy: (R, C) dense, one dtype; mean, inv_std: (C) fp32; partial:
// (nrb, 2, C) fp32 scratch; out: (2, C) fp32, [s1, s2]. vec is 16 bytes of
// elements (4 fp32, 8 bf16; C a multiple of it, x and dy aligned to it) or 1.
// The launch plan is ops/tiling.py::channel_plan.
extern "C" int bn_backward_sums(const void* x, const void* dy, int dtype,
                                const void* mean, const void* inv_std,
                                void* partial, void* out, long long R, int C,
                                int vec, int lanes, int ctiles, int row_groups,
                                int rows_per_block, int nrb, void* stream) {
  using namespace mmvqa;
  auto s = static_cast<cudaStream_t>(stream);
  auto mp = static_cast<const float*>(mean);
  auto ip = static_cast<const float*>(inv_std);
  auto part = static_cast<float*>(partial);
  auto op = static_cast<float*>(out);
  if (lanes * row_groups > k5::kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kFloat32 && vec == 4) {
    err = k5::launch<float, 4>(x, dy, mp, ip, part, op, R, C, lanes, ctiles,
                               row_groups, rows_per_block, nrb, s);
  } else if (dtype == kFloat32 && vec == 1) {
    err = k5::launch<float, 1>(x, dy, mp, ip, part, op, R, C, lanes, ctiles,
                               row_groups, rows_per_block, nrb, s);
  } else if (dtype == kBFloat16 && vec == 8) {
    err = k5::launch<__nv_bfloat16, 8>(x, dy, mp, ip, part, op, R, C, lanes,
                                       ctiles, row_groups, rows_per_block, nrb,
                                       s);
  } else if (dtype == kBFloat16 && vec == 1) {
    err = k5::launch<__nv_bfloat16, 1>(x, dy, mp, ip, part, op, R, C, lanes,
                                       ctiles, row_groups, rows_per_block, nrb,
                                       s);
  }
  return static_cast<int>(err);
}
