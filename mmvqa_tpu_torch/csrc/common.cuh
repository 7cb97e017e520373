// Shared helpers for the hand-written Hopper kernels of mmvqa_tpu_torch.
//
// Every entry point has a plain C interface (loaded with ctypes), launches on
// the stream it is given, allocates nothing, and returns cudaGetLastError()
// so that the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mmvqa {

// dtype codes shared with the Python wrappers (ops/_dtypes in ops/*.py)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC neighbouring elements moved by one load or store. The
// address must be a multiple of sizeof(T) * VEC bytes; the wrappers choose
// VEC = 1 where the channel count or the base address does not allow more.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[VEC]) {
  const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(pk.v[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&in)[VEC]) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int i = 0; i < VEC; ++i) pk.v[i] = from_f32<T>(in[i]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
}

// The depthwise kernels' (9, C) tap weights: fp32 or bf16, read by element
// strides (tap, channel), so that the convolution's own (C, 1, 3, 3) tensor,
// the fp32 master included, goes in as a view.
struct TapWeights {
  const void* p;
  int dtype;
  long long st, sc;
  __device__ __forceinline__ float at(int t, int c) const {
    const long long i = t * st + c * sc;
    return dtype == kBFloat16
               ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
               : static_cast<const float*>(p)[i];
  }
};

// out[i] = sum over j < nparts, in order, of part[j * n + i]: the fixed-order
// second pass behind every sum that crosses blocks (no float atomics, so two
// runs give the same bits). Each source wraps it in a kernel of its own name,
// one thread per i, kReduceThreads a block.
constexpr int kReduceThreads = 128;

__device__ __forceinline__ void sum_partials(const float* __restrict__ part,
                                             float* __restrict__ out,
                                             long long n, int nparts) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int j = 0; j < nparts; ++j) s += part[(long long)j * n + i];
  out[i] = s;
}

inline unsigned reduce_blocks(long long n) {
  return (unsigned)((n + kReduceThreads - 1) / kReduceThreads);
}

}  // namespace mmvqa

extern "C" const char* mmvqa_error_string(int code);
