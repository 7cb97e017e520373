// K3 backward: both gradients of the depthwise 3x3 convolution in one pass,
//   dx[p]    = sum_t dy[p - o_t] * k_t            (the taps flipped)
//   dW[t, c] = sum_{b, p} x[b, p, c] * dy[b, p - o_t, c]
// with o_t the offset of tap t and the zero border as in the forward.
//
// Replaces the TPU kernel mmvqa_tpu/ops/pallas_depthwise.py::_bwd_kernel
// (_bwd_call, pallas_call at :166). As there, one shifted dy per tap feeds
// both gradients: a thread loads dy[p - o_t] once, adds it times k_t into
// dx[p] and times x[p] into its running dW[t].
//
// Layout and thread map are the forward's (csrc/depthwise3x3.cu): channels
// last, a thread owns VEC neighbouring channels and walks over positions.
// What bounds it: bytes (x and dy read, dx written; 18 multiply-adds an
// element).
//
// dW is a sum over every position of every image, and blocks run in no
// order (the TPU kernel carries it in one output block over a sequential
// grid). Here a thread keeps its 9 x VEC sums in registers over its
// positions, the block adds its row groups in shared memory in a fixed
// order and writes one (9, C) fp32 partial, and a second kernel adds the
// partials in block order. No float atomics: two runs give identical bits.
#include "common.cuh"

namespace mmvqa {
namespace k3bwd {

constexpr int kMaxThreads = 256;
constexpr int kMaxVec = 4;

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    depthwise3x3_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                            TapWeights w, T* __restrict__ dx,
                            float* __restrict__ dwpart, int H, int W, int C,
                            int R, int rows_per_block) {
  // [t][v][row group][lane]: a warp's lanes write and read neighbours
  __shared__ float red[9 * kMaxVec * kMaxThreads];

  const int lanes = blockDim.x;
  const int groups = blockDim.y;
  const int c = (blockIdx.x * lanes + threadIdx.x) * VEC;
  const bool live = c < C;

  float wt[9][VEC];
  float dw[9][VEC];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      wt[t][v] = live ? to_f32(from_f32<T>(w.at(t, c + v))) : 0.0f;
      dw[t][v] = 0.0f;
    }

  // positions in 32 bits: two divisions a position, in 64 bits they would
  // cost more than the nine taps
  const int r_begin = blockIdx.y * rows_per_block;
  const int r_end = min(R, r_begin + rows_per_block);
  if (live) {
    for (int r = r_begin + threadIdx.y; r < r_end; r += groups) {
      const int wq = r % W;
      const int h = (r / W) % H;
      float xv[VEC], acc[VEC];
      load_vec<T, VEC>(x + (long long)r * C + c, xv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
#pragma unroll
      for (int di = -1; di <= 1; ++di) {
        if (h - di < 0 || h - di >= H) continue;
#pragma unroll
        for (int dj = -1; dj <= 1; ++dj) {
          if (wq - dj < 0 || wq - dj >= W) continue;
          float ds[VEC];
          load_vec<T, VEC>(dy + (long long)(r - di * W - dj) * C + c, ds);
          const int t = (di + 1) * 3 + dj + 1;
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            acc[v] = fmaf(ds[v], wt[t][v], acc[v]);
            dw[t][v] = fmaf(xv[v], ds[v], dw[t][v]);
          }
        }
      }
      store_vec<T, VEC>(dx + (long long)r * C + c, acc);
    }
  }

  // the block's row groups, added in order
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      red[((t * VEC + v) * groups + threadIdx.y) * lanes + threadIdx.x] =
          dw[t][v];
  __syncthreads();
  const int tid = threadIdx.y * lanes + threadIdx.x;
  for (int i = tid; i < 9 * VEC * lanes; i += lanes * groups) {
    const int tv = i / lanes;
    const int lane = i % lanes;
    const int cc = (blockIdx.x * lanes + lane) * VEC + tv % VEC;
    if (cc >= C) continue;
    float s = 0.0f;
    for (int g = 0; g < groups; ++g) s += red[(tv * groups + g) * lanes + lane];
    dwpart[((long long)blockIdx.y * 9 + tv / VEC) * C + cc] = s;
  }
}

__global__ void depthwise3x3_dw_reduce_kernel(const float* __restrict__ part,
                                              float* __restrict__ out,
                                              long long n, int nparts) {
  sum_partials(part, out, n, nparts);
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* dy, TapWeights w, void* dx, float* dwpart,
                   float* dw, int H, int W, int C, int R, int lanes,
                   int ctiles, int row_groups, int rows_per_block, int nrb,
                   cudaStream_t stream) {
  depthwise3x3_bwd_kernel<T, VEC>
      <<<dim3(ctiles, nrb), dim3(lanes, row_groups), 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(dy), w,
          static_cast<T*>(dx), dwpart, H, W, C, R, rows_per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = 9LL * C;
  depthwise3x3_dw_reduce_kernel<<<reduce_blocks(n), kReduceThreads, 0,
                                  stream>>>(dwpart, dw, n, nrb);
  return cudaGetLastError();
}

}  // namespace k3bwd
}  // namespace mmvqa

// x, dy, dx: (B, H, W, C) dense, x's dtype; w: (9, C) fp32 or bf16 by element strides;
// dwpart: (nrb, 9, C) fp32 scratch; dw: (9, C) fp32 out. vec and the launch
// plan as for depthwise3x3_fwd.
extern "C" int depthwise3x3_bwd(const void* x, int dtype, const void* dy,
                                const void* w, int wdtype, long long swt,
                                long long swc, void* dx, void* dwpart, void* dw, int B, int H,
                                int W, int C, int vec, int lanes, int ctiles,
                                int row_groups, int rows_per_block, int nrb,
                                void* stream) {
  using namespace mmvqa;
  auto s = static_cast<cudaStream_t>(stream);
  const TapWeights wp{w, wdtype, swt, swc};
  auto part = static_cast<float*>(dwpart);
  auto dwp = static_cast<float*>(dw);
  const long long rows = (long long)B * H * W;
  const int R = (int)rows;
  if (rows > (1LL << 30) || lanes * row_groups > k3bwd::kMaxThreads ||
      (vec != 1 && vec != 4) || (wdtype != kFloat32 && wdtype != kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kFloat32 && vec == 4) {
    err = k3bwd::launch<float, 4>(x, dy, wp, dx, part, dwp, H, W, C,
                                  R, lanes, ctiles, row_groups, rows_per_block,
                                  nrb, s);
  } else if (dtype == kFloat32) {
    err = k3bwd::launch<float, 1>(x, dy, wp, dx, part, dwp, H, W, C,
                                  R, lanes, ctiles, row_groups, rows_per_block,
                                  nrb, s);
  } else if (dtype == kBFloat16 && vec == 4) {
    err = k3bwd::launch<__nv_bfloat16, 4>(x, dy, wp, dx, part, dwp,
                                          H, W, C, R, lanes, ctiles, row_groups,
                                          rows_per_block, nrb, s);
  } else if (dtype == kBFloat16) {
    err = k3bwd::launch<__nv_bfloat16, 1>(x, dy, wp, dx, part, dwp,
                                          H, W, C, R, lanes, ctiles, row_groups,
                                          rows_per_block, nrb, s);
  }
  return static_cast<int>(err);
}
