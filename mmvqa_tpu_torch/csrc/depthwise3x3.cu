// K3 forward: depthwise 3x3 convolution, stride 1, zero border ("SAME"),
//   y[b, h, w, c] = sum_{di, dj in -1..1} x[b, h + di, w + dj, c] * k[di, dj, c].
//
// Replaces the TPU kernel mmvqa_tpu/ops/pallas_depthwise.py::depthwise3x3
// (_fwd_kernel / _fwd_call, pallas_call at :145).
//
// Layout: channels last, x and y dense (B, H, W, C), as the TPU kernel and as
// the port's trunk keeps its maps in memory (its NHWC input enters as a
// permuted view and every library convolution keeps that format). Channels
// are the unit-stride axis, so neighbouring threads take neighbouring
// channels and every load is coalesced whatever H and W are: the 7 x 7 and
// 14 x 14 planes of the flagship sites are no multiple of a warp, the channel
// counts (640 ... 3072) are. The TPU kernel rolls the flattened plane and
// masks the wraps; here a thread indexes (h, w) directly and skips the taps
// that fall outside the plane.
//
// What bounds it on an H100: bytes. Nine multiply-adds an element against one
// read and one write of the map. A thread owns VEC neighbouring channels
// (one 8- or 16-byte load) and walks over positions; the nine taps of a
// position are nine loads, of which eight hit lines that the neighbouring
// positions of the same block bring into L1. The nine weights of a thread's
// channels stay in registers, rounded to the map's dtype as the TPU kernel
// rounds them, products and sums in fp32.
#include "common.cuh"

namespace mmvqa {
namespace k3 {

constexpr int kMaxThreads = 256;

// grid (ctiles, nrb), block (lanes, row_groups). Thread (l, g) of block
// (ct, rb) owns channels [(ct * lanes + l) * VEC, + VEC) and the flattened
// positions r = rb * rows_per_block + g, + row_groups, ... of its block's
// range, r = (b * H + h) * W + w.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    depthwise3x3_fwd_kernel(const T* __restrict__ x,
                            TapWeights w, T* __restrict__ y, int H, int W,
                            int C, int R, int rows_per_block) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (c >= C) return;
  float wt[9][VEC];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      wt[t][v] = to_f32(from_f32<T>(w.at(t, c + v)));

  // positions in 32 bits: two divisions a position, in 64 bits they would
  // cost more than the nine taps
  const int r_begin = blockIdx.y * rows_per_block;
  const int r_end = min(R, r_begin + rows_per_block);
  for (int r = r_begin + threadIdx.y; r < r_end; r += blockDim.y) {
    const int wq = r % W;
    const int h = (r / W) % H;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
#pragma unroll
    for (int di = -1; di <= 1; ++di) {
      if (h + di < 0 || h + di >= H) continue;
#pragma unroll
      for (int dj = -1; dj <= 1; ++dj) {
        if (wq + dj < 0 || wq + dj >= W) continue;
        float xv[VEC];
        load_vec<T, VEC>(x + (long long)(r + di * W + dj) * C + c, xv);
        const int t = (di + 1) * 3 + dj + 1;
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = fmaf(xv[v], wt[t][v], acc[v]);
      }
    }
    store_vec<T, VEC>(y + (long long)r * C + c, acc);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, TapWeights w, void* y, int H, int W, int C,
                   int R, int lanes, int ctiles, int row_groups, int rows_per_block, int nrb,
                   cudaStream_t stream) {
  depthwise3x3_fwd_kernel<T, VEC>
      <<<dim3(ctiles, nrb), dim3(lanes, row_groups), 0, stream>>>(
          static_cast<const T*>(x), w, static_cast<T*>(y), H, W, C,
          R, rows_per_block);
  return cudaGetLastError();
}

}  // namespace k3
}  // namespace mmvqa

// x, y: (B, H, W, C) dense, x's dtype; w: (9, C) fp32 or bf16 (wdtype) by
// element strides (swt, swc), tap t = (di + 1) * 3 + dj + 1. vec is 4 (C a
// multiple of 4, x and y aligned to 4 elements) or 1. The launch plan is
// ops/tiling.py::channel_plan: lanes * row_groups <= 256 threads,
// ctiles * lanes * vec >= C, nrb * rows_per_block >= B * H * W.
extern "C" int depthwise3x3_fwd(const void* x, int dtype, const void* w,
                                int wdtype, long long swt, long long swc,
                                void* y, int B, int H, int W, int C, int vec, int lanes,
                                int ctiles, int row_groups, int rows_per_block,
                                int nrb, void* stream) {
  using namespace mmvqa;
  auto s = static_cast<cudaStream_t>(stream);
  const TapWeights wp{w, wdtype, swt, swc};
  const long long rows = (long long)B * H * W;
  const int R = (int)rows;
  if (rows > (1LL << 30) || lanes * row_groups > k3::kMaxThreads ||
      (vec != 1 && vec != 4) || (wdtype != kFloat32 && wdtype != kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kFloat32 && vec == 4) {
    err = k3::launch<float, 4>(x, wp, y, H, W, C, R, lanes, ctiles,
                               row_groups, rows_per_block, nrb, s);
  } else if (dtype == kFloat32) {
    err = k3::launch<float, 1>(x, wp, y, H, W, C, R, lanes, ctiles,
                               row_groups, rows_per_block, nrb, s);
  } else if (dtype == kBFloat16 && vec == 4) {
    err = k3::launch<__nv_bfloat16, 4>(x, wp, y, H, W, C, R, lanes,
                                       ctiles, row_groups, rows_per_block, nrb,
                                       s);
  } else if (dtype == kBFloat16) {
    err = k3::launch<__nv_bfloat16, 1>(x, wp, y, H, W, C, R, lanes,
                                       ctiles, row_groups, rows_per_block, nrb,
                                       s);
  }
  return static_cast<int>(err);
}
