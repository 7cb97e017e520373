// K2 forward: the RealFormer residual-attention core for one layer.
//
// Replaces the TPU kernel mmvqa_tpu/ops/pallas_attention.py::
// realformer_attention_pallas (_core / _fwd_call, pallas_call at :146), with
// the semantics of the XLA path (mmvqa_tpu/ops/attention.py:131-142):
//
//   s   = q k^T / sqrt(E) (+ prev) - 10000 (1 - mask_q)   carried, fp32
//   ctx = softmax_keys(s) v                                 input dtype
//
// The softmax is taken over the stored scores, mask term included, as the
// XLA path does (the Pallas kernel leaves it out). Padded query rows become
// keys and values of the next layer, so their rounding is part of the
// result.
//
// What bounds it on an H100: neither bytes nor operations. At the VQA shape
// (B=16, H=8, T=28, E=96) one layer is 1.2 M multiply-adds per head and a
// few hundred KB in total; the cost is launch and latency. One block per
// (batch, head) keeps q, k, v and the score tile in shared memory and reads
// and writes device memory exactly once, while its tiles fit one block's
// shared memory (T=128 at E=96: 214 KB).
//
// Beyond that, the tiled kernel below takes any T: a block owns 32 query
// rows of one head and walks the keys 32 at a time, three times. The score
// rows it writes to the carry (which is (B, H, T, T) in device memory
// anyway) hold its softmax state: the first walk writes the scores, a warp
// a row then takes their maximum and sum, and the last walk turns them into
// probabilities and sums p v. The carry is read back twice from L2; the
// path is chosen by T and E alone (ops/attention.py::fits_one_block).
//
// q, k and v are read by strides, so the slices of the shared kqv projection
// go in as views.
#include "common.cuh"

namespace mmvqa {

constexpr float kNegBig = 10000.0f;
constexpr int kAttnThreads = 256;

struct Strides4 {
  long long b, t, h, e;
};

struct AttnStrides {
  Strides4 q, k, v, ctx;
};

// grid (B * H), block kAttnThreads. prev/scores are (B, H, T, T) fp32
// contiguous, mask (B, T) fp32 contiguous; prev and mask may be null.
template <typename T>
__global__ void realformer_attn_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ prev, const float* __restrict__ mask,
    float* __restrict__ scores, T* __restrict__ ctx, AttnStrides st, int H,
    int Tn, int E) {
  extern __shared__ __align__(16) float smem[];
  const int ke = E + 1;  // odd row stride: k rows are read across lanes
  float* qs = smem;               // Tn x E
  float* ks = qs + Tn * E;        // Tn x (E + 1)
  float* vs = ks + Tn * ke;       // Tn x E
  float* ss = vs + Tn * E;        // Tn x Tn scores, then probabilities
  float* negs = ss + Tn * Tn;     // Tn mask terms

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;

  for (int i = tid; i < Tn * E; i += blockDim.x) {
    const int t = i / E;
    const int e = i % E;
    qs[i] = to_f32(q[b * st.q.b + t * st.q.t + h * st.q.h + e * st.q.e]);
    ks[t * ke + e] = to_f32(k[b * st.k.b + t * st.k.t + h * st.k.h + e * st.k.e]);
    vs[i] = to_f32(v[b * st.v.b + t * st.v.t + h * st.v.h + e * st.v.e]);
  }
  for (int i = tid; i < Tn; i += blockDim.x) {
    negs[i] = mask ? kNegBig * (1.0f - mask[(long long)b * Tn + i]) : 0.0f;
  }
  __syncthreads();

  const float root_e = sqrtf((float)E);
  const long long head = ((long long)b * H + h) * Tn * Tn;
  for (int idx = tid; idx < Tn * Tn; idx += blockDim.x) {
    const int i = idx / Tn;
    const int j = idx % Tn;
    const float* qi = qs + i * E;
    const float* kj = ks + j * ke;
    float acc = 0.0f;
    for (int e = 0; e < E; ++e) acc = fmaf(qi[e], kj[e], acc);
    float s = acc / root_e;
    if (prev) s = s + prev[head + idx];
    if (mask) s = s - negs[i];
    scores[head + idx] = s;
    ss[idx] = s;
  }
  __syncthreads();

  // one warp per query row: softmax over the keys, in place
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < Tn; i += nwarps) {
    float* row = ss + i * Tn;
    float m = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < Tn; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.0f;
    for (int j = lane; j < Tn; j += 32) {
      const float p = expf(row[j] - m);
      row[j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < Tn; j += 32) row[j] = row[j] / sum;
  }
  __syncthreads();

  for (int idx = tid; idx < Tn * E; idx += blockDim.x) {
    const int i = idx / E;
    const int e = idx % E;
    const float* pi = ss + i * Tn;
    float acc = 0.0f;
    for (int j = 0; j < Tn; ++j) acc = fmaf(pi[j], vs[j * E + e], acc);
    ctx[b * st.ctx.b + i * st.ctx.t + h * st.ctx.h + e * st.ctx.e] =
        from_f32<T>(acc);
  }
}

size_t attn_smem_bytes(int Tn, int E) {
  return (size_t)(Tn * E + Tn * (E + 1) + Tn * E + Tn * Tn + Tn) *
         sizeof(float);
}

template <typename T>
cudaError_t launch_attn(const void* q, const void* k, const void* v,
                        const float* prev, const float* mask, float* scores,
                        void* ctx, const AttnStrides& st, int B, int H, int Tn,
                        int E, cudaStream_t stream) {
  const size_t smem = attn_smem_bytes(Tn, E);
  auto kern = realformer_attn_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // the refusal must not fail the next launch
    return err;
  }
  kern<<<B * H, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), prev, mask, scores, static_cast<T*>(ctx), st,
      H, Tn, E);
  return cudaGetLastError();
}

constexpr int kTileQ = 32;  // query rows a block of the tiled kernel owns
constexpr int kTileK = 32;  // keys a step of its walks

// grid (B * H, ceil(T / kTileQ)), block kAttnThreads; arguments as above.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    realformer_attn_fwd_tiled_kernel(const T* __restrict__ q,
                                     const T* __restrict__ k,
                                     const T* __restrict__ v,
                                     const float* __restrict__ prev,
                                     const float* __restrict__ mask,
                                     float* __restrict__ scores,
                                     T* __restrict__ ctx, AttnStrides st,
                                     int H, int Tn, int E) {
  extern __shared__ __align__(16) float smem[];
  const int ke = E + 1;  // odd row stride: key rows are read across lanes
  float* qs = smem;                      // kTileQ x E
  float* kvs = qs + kTileQ * E;          // kTileK x (E + 1), keys then values
  float* acc = kvs + kTileK * ke;        // kTileQ x E, p v
  float* ps = acc + kTileQ * E;          // kTileQ x (kTileK + 1)
  float* negs = ps + kTileQ * (kTileK + 1);  // kTileQ mask terms
  float* rmax = negs + kTileQ;           // kTileQ row maxima
  float* rinv = rmax + kTileQ;           // kTileQ 1 / row sums

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int i0 = blockIdx.y * kTileQ;
  const int rows = min(kTileQ, Tn - i0);
  const int tid = threadIdx.x;
  const long long head = ((long long)b * H + h) * Tn * Tn;
  const float root_e = sqrtf((float)E);

  for (int i = tid; i < kTileQ * E; i += blockDim.x) {
    const int t = i / E;
    const int e = i % E;
    qs[i] = t < rows ? to_f32(q[b * st.q.b + (i0 + t) * st.q.t + h * st.q.h +
                                e * st.q.e])
                     : 0.0f;
    acc[i] = 0.0f;
  }
  for (int i = tid; i < kTileQ; i += blockDim.x) {
    negs[i] = (mask && i < rows)
                  ? kNegBig * (1.0f - mask[(long long)b * Tn + i0 + i])
                  : 0.0f;
  }

  // walk 1: the scores, as the one-block kernel computes them
  for (int j0 = 0; j0 < Tn; j0 += kTileK) {
    const int cols = min(kTileK, Tn - j0);
    __syncthreads();  // q staged; the previous key tile consumed
    for (int i = tid; i < cols * E; i += blockDim.x) {
      const int t = i / E;
      const int e = i % E;
      kvs[t * ke + e] = to_f32(k[b * st.k.b + (j0 + t) * st.k.t +
                                 h * st.k.h + e * st.k.e]);
    }
    __syncthreads();
    for (int idx = tid; idx < rows * cols; idx += blockDim.x) {
      const int i = idx / cols;
      const int j = idx % cols;
      const float* qi = qs + i * E;
      const float* kj = kvs + j * ke;
      float a = 0.0f;
      for (int e = 0; e < E; ++e) a = fmaf(qi[e], kj[e], a);
      float s = a / root_e;
      const long long at = head + (long long)(i0 + i) * Tn + j0 + j;
      if (prev) s = s + prev[at];
      if (mask) s = s - negs[i];
      scores[at] = s;
    }
  }
  __syncthreads();  // the block's score rows are in device memory

  // a warp a row: maximum and sum of the stored scores
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < rows; i += nwarps) {
    const float* row = scores + head + (long long)(i0 + i) * Tn;
    float m = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < Tn; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.0f;
    for (int j = lane; j < Tn; j += 32) sum += expf(row[j] - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      rmax[i] = m;
      rinv[i] = 1.0f / sum;
    }
  }

  // walk 2: probabilities and p v
  for (int j0 = 0; j0 < Tn; j0 += kTileK) {
    const int cols = min(kTileK, Tn - j0);
    __syncthreads();  // row statistics set; the previous tile consumed
    for (int i = tid; i < cols * E; i += blockDim.x) {
      const int t = i / E;
      const int e = i % E;
      kvs[t * ke + e] = to_f32(v[b * st.v.b + (j0 + t) * st.v.t +
                                 h * st.v.h + e * st.v.e]);
    }
    for (int idx = tid; idx < rows * kTileK; idx += blockDim.x) {
      const int i = idx / kTileK;
      const int j = idx % kTileK;
      ps[i * (kTileK + 1) + j] =
          j < cols ? expf(scores[head + (long long)(i0 + i) * Tn + j0 + j] -
                          rmax[i]) *
                         rinv[i]
                   : 0.0f;
    }
    __syncthreads();
    for (int idx = tid; idx < rows * E; idx += blockDim.x) {
      const int i = idx / E;
      const int e = idx % E;
      const float* pi = ps + i * (kTileK + 1);
      float a = acc[idx];
      for (int j = 0; j < cols; ++j) a = fmaf(pi[j], kvs[j * ke + e], a);
      acc[idx] = a;
    }
  }
  for (int idx = tid; idx < rows * E; idx += blockDim.x) {
    const int i = idx / E;
    const int e = idx % E;
    ctx[b * st.ctx.b + (i0 + i) * st.ctx.t + h * st.ctx.h + e * st.ctx.e] =
        from_f32<T>(acc[idx]);
  }
}

size_t attn_tiled_smem_bytes(int E) {
  return (size_t)(2 * kTileQ * E + kTileK * (E + 1) +
                  kTileQ * (kTileK + 1) + 3 * kTileQ) *
         sizeof(float);
}

template <typename T>
cudaError_t launch_attn_tiled(const void* q, const void* k, const void* v,
                              const float* prev, const float* mask,
                              float* scores, void* ctx, const AttnStrides& st,
                              int B, int H, int Tn, int E,
                              cudaStream_t stream) {
  const size_t smem = attn_tiled_smem_bytes(E);
  auto kern = realformer_attn_fwd_tiled_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // the refusal must not fail the next launch
    return err;
  }
  const dim3 grid(B * H, (Tn + kTileQ - 1) / kTileQ);
  kern<<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), prev, mask, scores, static_cast<T*>(ctx), st,
      H, Tn, E);
  return cudaGetLastError();
}

}  // namespace mmvqa

// q, k, v, ctx: (B, T, H, E) by element strides, given in `strides` as 16
// int64 (q, k, v, ctx; each b, t, h, e). prev: (B, H, T, T) fp32 or null;
// mask: (B, T) fp32 or null; scores: (B, H, T, T) fp32 out. tiled: 0 for
// the one-block kernel, 1 for the tiled one.
extern "C" int realformer_attn_fwd(const void* q, const void* k, const void* v,
                                   const void* prev, const void* mask,
                                   void* scores, void* ctx,
                                   const long long* strides, int dtype, int B,
                                   int H, int Tn, int E, int tiled,
                                   void* stream) {
  using namespace mmvqa;
  AttnStrides st;
  Strides4* parts[4] = {&st.q, &st.k, &st.v, &st.ctx};
  for (int i = 0; i < 4; ++i) {
    parts[i]->b = strides[4 * i + 0];
    parts[i]->t = strides[4 * i + 1];
    parts[i]->h = strides[4 * i + 2];
    parts[i]->e = strides[4 * i + 3];
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto pv = static_cast<const float*>(prev);
  auto mk = static_cast<const float*>(mask);
  auto sc = static_cast<float*>(scores);
  cudaError_t err;
  if (dtype == kFloat32) {
    err = tiled ? launch_attn_tiled<float>(q, k, v, pv, mk, sc, ctx, st, B, H,
                                           Tn, E, s)
                : launch_attn<float>(q, k, v, pv, mk, sc, ctx, st, B, H, Tn, E,
                                     s);
  } else if (dtype == kBFloat16) {
    err = tiled ? launch_attn_tiled<__nv_bfloat16>(q, k, v, pv, mk, sc, ctx,
                                                   st, B, H, Tn, E, s)
                : launch_attn<__nv_bfloat16>(q, k, v, pv, mk, sc, ctx, st, B,
                                             H, Tn, E, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
