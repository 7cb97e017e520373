// K2 backward: gradients of the RealFormer residual-attention core.
//
// Replaces the TPU kernel mmvqa_tpu/ops/pallas_attention.py::_bwd_kernel
// (_bwd_call, pallas_call at :164; the custom VJP of _core). With the
// forward's stored carry s (csrc/realformer_attention.cu), the incoming
// gradients dctx and dcarry, and fp32 inside:
//
//   p     = softmax_keys(s)          recomputed from the stored carry, which
//                                    is exactly the forward's softmax input
//   dp    = dctx v^T
//   ds    = p (dp - sum_keys(dp p)) + dcarry
//   dprev = ds                       only where the layer had a prev
//   dq    = ds k / sqrt(E)    dk = ds^T q / sqrt(E)    dv = p^T dctx
//
// The query mask is a constant of the forward and gets no gradient.
//
// What bounds it on an H100: bytes, barely: at the training shape (B=128,
// H=8, T=75, E=96) a layer reads q, k, v, dctx and the carry and writes dq,
// dk, dv (and dprev), 80 MB in bf16 with fp32 carries, against 0.4 G
// multiply-adds a product. One block per (batch, head) keeps q, k, v, dctx
// and two T x T tiles (p and ds) in shared memory, 160 KB at T=75, E=96, so
// every input is read and every output written exactly once and nothing of
// shape (B, H, T, T) but the carries touches device memory. One block fits
// an SM; B * H = 1024 blocks keep the 132 SMs busy.
//
// Where those tiles outgrow one block's shared memory (T=100 at E=96), two
// tiled kernels take any T, in (B, H, T, T) fp32 score rows in device
// memory. The rows kernel owns 32 query rows of a head: it takes p's row
// statistics from the carry, walks the keys 32 at a time for dp and
// sum_keys(dp p), writes ds into dprev (or a scratch of the same shape) and
// walks them again for dq. The columns kernel owns 32 keys and walks the
// queries for dk and dv, reading ds and the row statistics the rows kernel
// left. The path is chosen by T and E alone (ops/attention.py).
//
// dq, dk and dv are written by strides: the wrapper hands in the three
// slices of one (B, T, H, 3E) buffer in (k, q, v) order, which is the
// gradient of the shared kqv projection's output as it stands.
#include "common.cuh"

namespace mmvqa {
namespace k2bwd {

constexpr int kThreads = 256;

struct Strides4 {
  long long b, t, h, e;
};

struct BwdStrides {
  Strides4 q, k, v, dctx, dq, dk, dv;
};

__device__ __forceinline__ long long at(const Strides4& s, int b, int t, int h,
                                        int e) {
  return b * s.b + t * s.t + h * s.h + e * s.e;
}

// grid (B * H), block kThreads. carry, dcarry, dprev: (B, H, T, T) fp32
// contiguous; dctx may be null (zero), dcarry may be null (zero), dprev may
// be null (not wanted).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    realformer_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v,
                               const float* __restrict__ carry,
                               const T* __restrict__ dctx,
                               const float* __restrict__ dcarry,
                               T* __restrict__ dq, T* __restrict__ dk,
                               T* __restrict__ dv, float* __restrict__ dprev,
                               BwdStrides st, int H, int Tn, int E) {
  extern __shared__ __align__(16) float smem[];
  const int ve = E + 1;  // odd row stride: v rows are read across lanes
  float* qs = smem;               // Tn x E
  float* ks = qs + Tn * E;        // Tn x E
  float* dcs = ks + Tn * E;       // Tn x E   dctx
  float* vs = dcs + Tn * E;       // Tn x (E + 1)
  float* ps = vs + Tn * ve;       // Tn x Tn  probabilities
  float* dss = ps + Tn * Tn;      // Tn x Tn  dp, then ds

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const long long head = ((long long)b * H + h) * Tn * Tn;

  for (int i = tid; i < Tn * E; i += kThreads) {
    const int t = i / E;
    const int e = i % E;
    qs[i] = to_f32(q[at(st.q, b, t, h, e)]);
    ks[i] = to_f32(k[at(st.k, b, t, h, e)]);
    vs[t * ve + e] = to_f32(v[at(st.v, b, t, h, e)]);
    dcs[i] = dctx ? to_f32(dctx[at(st.dctx, b, t, h, e)]) : 0.0f;
  }

  // one warp per query row: p = softmax over the keys of the stored carry
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads >> 5;
  for (int i = warp; i < Tn; i += nwarps) {
    const float* src = carry + head + (long long)i * Tn;
    float* row = ps + i * Tn;
    float m = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < Tn; j += 32) {
      const float s = src[j];
      row[j] = s;
      m = fmaxf(m, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.0f;
    for (int j = lane; j < Tn; j += 32) {
      const float pj = expf(row[j] - m);
      row[j] = pj;
      sum += pj;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < Tn; j += 32) row[j] = row[j] / sum;
  }
  __syncthreads();

  // dp[i, j] = dctx[i, :] . v[j, :]
  for (int idx = tid; idx < Tn * Tn; idx += kThreads) {
    const int i = idx / Tn;
    const int j = idx % Tn;
    const float* di = dcs + i * E;
    const float* vj = vs + j * ve;
    float acc = 0.0f;
    for (int e = 0; e < E; ++e) acc = fmaf(di[e], vj[e], acc);
    dss[idx] = acc;
  }
  __syncthreads();

  // ds = p (dp - sum_j dp p) + dcarry, one warp per query row
  for (int i = warp; i < Tn; i += nwarps) {
    const float* prow = ps + i * Tn;
    float* drow = dss + i * Tn;
    float r = 0.0f;
    for (int j = lane; j < Tn; j += 32) r = fmaf(drow[j], prow[j], r);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      r += __shfl_xor_sync(0xffffffffu, r, off);
    for (int j = lane; j < Tn; j += 32) {
      float ds = prow[j] * (drow[j] - r);
      const long long gi = head + (long long)i * Tn + j;
      if (dcarry) ds += dcarry[gi];
      drow[j] = ds;
      if (dprev) dprev[gi] = ds;
    }
  }
  __syncthreads();

  const float scale = 1.0f / sqrtf((float)E);
  for (int idx = tid; idx < Tn * E; idx += kThreads) {
    const int t = idx / E;
    const int e = idx % E;
    float aq = 0.0f, ak = 0.0f, av = 0.0f;
    const float* dsrow = dss + t * Tn;
    for (int j = 0; j < Tn; ++j) {
      aq = fmaf(dsrow[j], ks[j * E + e], aq);          // dq[t] over keys j
      ak = fmaf(dss[j * Tn + t], qs[j * E + e], ak);   // dk[t] over queries j
      av = fmaf(ps[j * Tn + t], dcs[j * E + e], av);   // dv[t] over queries j
    }
    dq[at(st.dq, b, t, h, e)] = from_f32<T>(aq * scale);
    dk[at(st.dk, b, t, h, e)] = from_f32<T>(ak * scale);
    dv[at(st.dv, b, t, h, e)] = from_f32<T>(av);
  }
}

size_t smem_bytes(int Tn, int E) {
  return (size_t)(3 * Tn * E + Tn * (E + 1) + 2 * Tn * Tn) * sizeof(float);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* carry, const void* dctx, const float* dcarry,
                   void* dq, void* dk, void* dv, float* dprev,
                   const BwdStrides& st, int B, int H, int Tn, int E,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(Tn, E);
  auto kern = realformer_attn_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // the refusal must not fail the next launch
    return err;
  }
  kern<<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), carry, static_cast<const T*>(dctx), dcarry,
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), dprev, st,
      H, Tn, E);
  return cudaGetLastError();
}

constexpr int kTile = 32;  // query rows or keys a block of the tiled kernels
                           // owns, and the step of its walks

// grid (B * H, ceil(T / kTile)), block kThreads. ds: (B, H, T, T) fp32 out
// (dprev, or a scratch); stats: (B, H, T, 2) fp32 out, each row's maximum
// and 1 / sum of exp. Other arguments as the one-block kernel's.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    realformer_attn_bwd_rows_kernel(const T* __restrict__ k,
                                    const T* __restrict__ v,
                                    const float* __restrict__ carry,
                                    const T* __restrict__ dctx,
                                    const float* __restrict__ dcarry,
                                    T* __restrict__ dq, float* __restrict__ ds,
                                    float* __restrict__ stats, BwdStrides st,
                                    int H, int Tn, int E) {
  extern __shared__ __align__(16) float smem[];
  const int ve = E + 1;  // odd row stride: key rows are read across lanes
  const int tp = kTile + 1;
  float* dcs = smem;                 // kTile x E      dctx rows
  float* kvs = dcs + kTile * E;      // kTile x (E + 1)  values, then keys
  float* acc = kvs + kTile * ve;     // kTile x E      dq
  float* ps = acc + kTile * E;       // kTile x (kTile + 1)  p
  float* dss = ps + kTile * tp;      // kTile x (kTile + 1)  dp, then ds
  float* rmax = dss + kTile * tp;    // kTile
  float* rinv = rmax + kTile;        // kTile
  float* rdot = rinv + kTile;        // kTile  sum_keys(dp p)

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int i0 = blockIdx.y * kTile;
  const int rows = min(kTile, Tn - i0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads >> 5;
  const long long head = ((long long)b * H + h) * Tn * Tn;

  for (int i = tid; i < kTile * E; i += kThreads) {
    const int t = i / E;
    const int e = i % E;
    dcs[i] = (dctx && t < rows) ? to_f32(dctx[at(st.dctx, b, i0 + t, h, e)])
                                : 0.0f;
    acc[i] = 0.0f;
  }
  // a warp a row: p's statistics from the stored carry
  for (int i = warp; i < rows; i += nwarps) {
    const float* row = carry + head + (long long)(i0 + i) * Tn;
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
      rdot[i] = 0.0f;
      float* sr = stats + 2 * (((long long)b * H + h) * Tn + i0 + i);
      sr[0] = m;
      sr[1] = 1.0f / sum;
    }
  }

  // walk 1: dp = dctx v^T into ds, and sum_keys(dp p)
  for (int j0 = 0; j0 < Tn; j0 += kTile) {
    const int cols = min(kTile, Tn - j0);
    __syncthreads();  // statistics set; the previous tile consumed
    for (int i = tid; i < cols * E; i += kThreads) {
      const int t = i / E;
      const int e = i % E;
      kvs[t * ve + e] = to_f32(v[at(st.v, b, j0 + t, h, e)]);
    }
    __syncthreads();
    for (int idx = tid; idx < rows * kTile; idx += kThreads) {
      const int i = idx / kTile;
      const int j = idx % kTile;
      float dp = 0.0f, p = 0.0f;
      if (j < cols) {
        const float* di = dcs + i * E;
        const float* vj = kvs + j * ve;
        for (int e = 0; e < E; ++e) dp = fmaf(di[e], vj[e], dp);
        const long long gi = head + (long long)(i0 + i) * Tn + j0 + j;
        p = expf(carry[gi] - rmax[i]) * rinv[i];
        ds[gi] = dp;
      }
      dss[i * tp + j] = dp * p;
    }
    __syncthreads();
    for (int i = warp; i < rows; i += nwarps) {  // kTile = 32 lanes
      float r = dss[i * tp + lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        r += __shfl_xor_sync(0xffffffffu, r, off);
      if (lane == 0) rdot[i] += r;
    }
  }

  // walk 2: ds = p (dp - sum_keys(dp p)) + dcarry, then dq += ds k
  for (int j0 = 0; j0 < Tn; j0 += kTile) {
    const int cols = min(kTile, Tn - j0);
    __syncthreads();  // rdot complete; the previous tile consumed
    for (int i = tid; i < cols * E; i += kThreads) {
      const int t = i / E;
      const int e = i % E;
      kvs[t * ve + e] = to_f32(k[at(st.k, b, j0 + t, h, e)]);
    }
    for (int idx = tid; idx < rows * kTile; idx += kThreads) {
      const int i = idx / kTile;
      const int j = idx % kTile;
      float d = 0.0f;
      if (j < cols) {
        const long long gi = head + (long long)(i0 + i) * Tn + j0 + j;
        const float p = expf(carry[gi] - rmax[i]) * rinv[i];
        d = p * (ds[gi] - rdot[i]);
        if (dcarry) d += dcarry[gi];
        ds[gi] = d;
      }
      dss[i * tp + j] = d;
    }
    __syncthreads();
    for (int idx = tid; idx < rows * E; idx += kThreads) {
      const int i = idx / E;
      const int e = idx % E;
      const float* di = dss + i * tp;
      float a = acc[idx];
      for (int j = 0; j < cols; ++j) a = fmaf(di[j], kvs[j * ve + e], a);
      acc[idx] = a;
    }
  }
  const float scale = 1.0f / sqrtf((float)E);
  for (int idx = tid; idx < rows * E; idx += kThreads) {
    const int i = idx / E;
    const int e = idx % E;
    dq[at(st.dq, b, i0 + i, h, e)] = from_f32<T>(acc[idx] * scale);
  }
}

// grid (B * H, ceil(T / kTile)), block kThreads: dk and dv of 32 keys, from
// the rows kernel's ds and statistics.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    realformer_attn_bwd_cols_kernel(const T* __restrict__ q,
                                    const float* __restrict__ carry,
                                    const T* __restrict__ dctx,
                                    const float* __restrict__ ds,
                                    const float* __restrict__ stats,
                                    T* __restrict__ dk, T* __restrict__ dv,
                                    BwdStrides st, int H, int Tn, int E) {
  extern __shared__ __align__(16) float smem[];
  const int tp = kTile + 1;
  float* qs = smem;                  // kTile x E  query rows
  float* dcs = qs + kTile * E;       // kTile x E  their dctx
  float* ak = dcs + kTile * E;       // kTile x E  dk
  float* av = ak + kTile * E;        // kTile x E  dv
  float* ps = av + kTile * E;        // kTile x (kTile + 1)  p[i, j]
  float* dss = ps + kTile * tp;      // kTile x (kTile + 1)  ds[i, j]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int j0 = blockIdx.y * kTile;
  const int cols = min(kTile, Tn - j0);
  const int tid = threadIdx.x;
  const long long head = ((long long)b * H + h) * Tn * Tn;
  const float* srow = stats + 2 * ((long long)b * H + h) * Tn;

  for (int i = tid; i < kTile * E; i += kThreads) {
    ak[i] = 0.0f;
    av[i] = 0.0f;
  }
  for (int i0 = 0; i0 < Tn; i0 += kTile) {
    const int rows = min(kTile, Tn - i0);
    __syncthreads();  // the previous query tile consumed
    for (int i = tid; i < rows * E; i += kThreads) {
      const int t = i / E;
      const int e = i % E;
      qs[i] = to_f32(q[at(st.q, b, i0 + t, h, e)]);
      dcs[i] = dctx ? to_f32(dctx[at(st.dctx, b, i0 + t, h, e)]) : 0.0f;
    }
    for (int idx = tid; idx < rows * kTile; idx += kThreads) {
      const int i = idx / kTile;
      const int j = idx % kTile;
      float p = 0.0f, d = 0.0f;
      if (j < cols) {
        const long long gi = head + (long long)(i0 + i) * Tn + j0 + j;
        const float* sr = srow + 2 * (i0 + i);
        p = expf(carry[gi] - sr[0]) * sr[1];
        d = ds[gi];
      }
      ps[i * tp + j] = p;
      dss[i * tp + j] = d;
    }
    __syncthreads();
    for (int idx = tid; idx < cols * E; idx += kThreads) {
      const int j = idx / E;
      const int e = idx % E;
      float a = ak[idx], c = av[idx];
      for (int i = 0; i < rows; ++i) {
        a = fmaf(dss[i * tp + j], qs[i * E + e], a);
        c = fmaf(ps[i * tp + j], dcs[i * E + e], c);
      }
      ak[idx] = a;
      av[idx] = c;
    }
  }
  const float scale = 1.0f / sqrtf((float)E);
  for (int idx = tid; idx < cols * E; idx += kThreads) {
    const int j = idx / E;
    const int e = idx % E;
    dk[at(st.dk, b, j0 + j, h, e)] = from_f32<T>(ak[idx] * scale);
    dv[at(st.dv, b, j0 + j, h, e)] = from_f32<T>(av[idx]);
  }
}

size_t rows_smem_bytes(int E) {
  return (size_t)(2 * kTile * E + kTile * (E + 1) + 2 * kTile * (kTile + 1) +
                  3 * kTile) *
         sizeof(float);
}

size_t cols_smem_bytes(int E) {
  return (size_t)(4 * kTile * E + 2 * kTile * (kTile + 1)) * sizeof(float);
}

template <typename T>
cudaError_t launch_tiled(const void* q, const void* k, const void* v,
                         const float* carry, const void* dctx,
                         const float* dcarry, void* dq, void* dk, void* dv,
                         float* ds, float* stats, const BwdStrides& st, int B,
                         int H, int Tn, int E, cudaStream_t stream) {
  auto rows = realformer_attn_bwd_rows_kernel<T>;
  auto cols = realformer_attn_bwd_cols_kernel<T>;
  const size_t smem_r = rows_smem_bytes(E), smem_c = cols_smem_bytes(E);
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_r);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        cols, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // the refusal must not fail the next launch
    return err;
  }
  const dim3 grid(B * H, (Tn + kTile - 1) / kTile);
  rows<<<grid, kThreads, smem_r, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), carry,
      static_cast<const T*>(dctx), dcarry, static_cast<T*>(dq), ds, stats, st,
      H, Tn, E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cols<<<grid, kThreads, smem_c, stream>>>(
      static_cast<const T*>(q), carry, static_cast<const T*>(dctx), ds, stats,
      static_cast<T*>(dk), static_cast<T*>(dv), st, H, Tn, E);
  return cudaGetLastError();
}

}  // namespace k2bwd
}  // namespace mmvqa

// q, k, v, dctx, dq, dk, dv: (B, T, H, E) by element strides, given in
// `strides` as 28 int64 (in that order; each b, t, h, e), all of one dtype.
// carry: (B, H, T, T) fp32, the forward's stored scores. dctx, dcarry: the
// gradients of the forward's two outputs, either may be null (zero). dprev:
// (B, H, T, T) fp32 out, or null where the layer had no prev. scratch, for
// the tiled kernels only: (B, H, T, T) fp32 for ds where dprev is null, and
// (B, H, T, 2) fp32 for the row statistics; null for the one-block kernel
// (tiled = 0).
extern "C" int realformer_attn_bwd(const void* q, const void* k, const void* v,
                                   const void* carry, const void* dctx,
                                   const void* dcarry, void* dq, void* dk,
                                   void* dv, void* dprev, void* ds_scratch,
                                   void* stats, const long long* strides,
                                   int dtype, int B, int H, int Tn, int E,
                                   int tiled, void* stream) {
  using namespace mmvqa;
  k2bwd::BwdStrides st;
  k2bwd::Strides4* parts[7] = {&st.q,  &st.k,  &st.v, &st.dctx,
                               &st.dq, &st.dk, &st.dv};
  for (int i = 0; i < 7; ++i) {
    parts[i]->b = strides[4 * i + 0];
    parts[i]->t = strides[4 * i + 1];
    parts[i]->h = strides[4 * i + 2];
    parts[i]->e = strides[4 * i + 3];
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto cr = static_cast<const float*>(carry);
  auto dc = static_cast<const float*>(dcarry);
  auto dp = static_cast<float*>(dprev);
  auto ds = dp ? dp : static_cast<float*>(ds_scratch);
  auto sts = static_cast<float*>(stats);
  cudaError_t err;
  if (dtype == kFloat32) {
    err = tiled ? k2bwd::launch_tiled<float>(q, k, v, cr, dctx, dc, dq, dk, dv,
                                             ds, sts, st, B, H, Tn, E, s)
                : k2bwd::launch<float>(q, k, v, cr, dctx, dc, dq, dk, dv, dp,
                                       st, B, H, Tn, E, s);
  } else if (dtype == kBFloat16) {
    err = tiled ? k2bwd::launch_tiled<__nv_bfloat16>(q, k, v, cr, dctx, dc, dq,
                                                     dk, dv, ds, sts, st, B, H,
                                                     Tn, E, s)
                : k2bwd::launch<__nv_bfloat16>(q, k, v, cr, dctx, dc, dq, dk,
                                               dv, dp, st, B, H, Tn, E, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
