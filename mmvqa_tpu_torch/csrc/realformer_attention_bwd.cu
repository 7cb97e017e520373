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
// What bounds it on an H100: bytes. At the training shape (B=128, H=8,
// T=75, E=96) a layer reads q, k, v, dctx and the carries and writes dq, dk,
// dv and dprev: 172 MB in bf16 with fp32 carries, 0.051 ms at 3.35 TB/s,
// against four products of 1.1 GFLOP each. Three paths, chosen by dtype, T
// and E alone (ops/attention.py::backward_path):
//
// * bf16 where a head fits (T up to 125 at E=96, E a multiple of 16 up to
//   128): the tensor-core kernel below (realformer_attn_bwd_mma_kernel). One
//   block a (batch, head) stages the head's q, k, v and dctx rows in bf16
//   shared memory by 16-byte cp.async, T padded to a multiple of 16 with zero
//   rows. The head's carry and dcarry, each a flat T x T fp32 block that
//   starts on 4 bytes only, come in beside them by 16-byte copies too, peeled
//   to the 16-byte boundary (read straight into the accumulator layout by
//   4-byte loads instead, they made a train layer 0.148 ms against 0.128:
//   tools/time_attention_backward.py on both versions). The copies come in
//   three groups, in the order the work needs them. A warp owns 16 query
//   rows: it
//   recomputes p in the mma accumulator layout (row max and row sum by quad
//   shuffles), takes dp = dctx v^T on mma.sync.m16n8k16, forms ds in fp32
//   registers and writes dprev from them. p and ds are held at fp32
//   accuracy in the products that follow: each is split into two bf16
//   terms, hi = bf16(x) and lo = bf16(x - hi), and both products are issued
//   (the other operand, k, q or dctx, is exact in bf16), so a product
//   differs from the fp32 one by about 2^-16 of it, far below the bf16
//   rounding of dq, dk and dv. dq takes ds from the warp's registers (the
//   accumulator layout of two key tiles is the A operand of one k step);
//   dk = ds^T q and dv = p^T dctx read ds and p back, transposed, by
//   ldmatrix.trans from bf16 tiles that take the place of v and the carries
//   once ds is taken (a warp holds one key tile's fragments of both terms in
//   registers across E), so that a head needs 109 KB at T=75, E=96 and two
//   blocks share an SM.
// * Other dtypes and widths where a head's fp32 tiles fit one block's shared
//   memory: the fp32 one-block kernel (realformer_attn_bwd_kernel), q, k, v,
//   dctx and two T x T tiles in fp32 shared memory, products on the CUDA
//   cores.
// * Beyond that, two tiled kernels take any T, in (B, H, T, T) fp32 score
//   rows in device memory. The rows kernel owns 32 query rows of a head: it
//   takes p's row statistics from the carry, walks the keys 32 at a time for
//   dp and sum_keys(dp p), writes ds into dprev (or a scratch of the same
//   shape) and walks them again for dq. The columns kernel owns 32 keys and
//   walks the queries for dk and dv, reading ds and the row statistics the
//   rows kernel left.
//
// dq, dk and dv are written by strides: the wrapper hands in the three
// slices of one (B, T, H, 3E) buffer in (k, q, v) order, which is the
// gradient of the shared kqv projection's output as it stands.
#include "attention_tile.cuh"

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

// ------------------------------------------------ bf16, tensor cores

namespace tc {

using namespace k2tc;

// shared memory of a head: q, k, dctx (Tp x (E + 8) bf16 each), then v and
// the flat carry and dcarry blocks, whose place p and ds take (hi and lo
// terms, Tp x (Tp + 8) bf16 each) once dp and ds are taken
__host__ __device__ inline size_t smem_bytes(int T, int Tp, int E) {
  const size_t rows = 2 * (size_t)Tp * (E + kPad);
  const size_t first = rows + 2 * 4 * (size_t)flat_floats(T);
  const size_t tiles = 4 * 2 * (size_t)Tp * (Tp + kPad);
  return 3 * rows + (first > tiles ? first : tiles);
}

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dctx;  // dctx may be null (zero)
  const float* carry;
  const float* dcarry;  // may be null (zero)
  __nv_bfloat16 *dq, *dk, *dv;
  float* dprev;         // may be null (not wanted)
  BwdStrides st;
  int H, T, E;
  float scale;
  int vec;              // 16-byte copies of q, k, v and dctx
};

// acc += a b, a exact in bf16
__device__ __forceinline__ void product(float (&acc)[4],
                                        const unsigned (&a)[4], unsigned b0,
                                        unsigned b1) {
  mma(acc, a, b0, b1);
}

// acc += (hi + lo) b: an fp32 operand as its two bf16 terms
__device__ __forceinline__ void split_product(float (&acc)[4],
                                              const unsigned (&hi)[4],
                                              const unsigned (&lo)[4],
                                              unsigned b0, unsigned b1) {
  mma(acc, hi, b0, b1);
  mma(acc, lo, b0, b1);
}

// rows r0 + g and r0 + g + 8, columns e0 + 8 n + 2 t4 of a (B, T, H, E)
// output from an m16n8 accumulator pair, times `scale`; rows >= T dropped
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const Strides4& s, int b, int h,
                                           int T, int r0, int e0,
                                           const float (&acc)[2][4],
                                           float scale, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= T) continue;
    __nv_bfloat16* row = out + b * s.b + r * s.t + h * s.h;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(row + e0 + 8 * n + 2 * t4) =
          __floats2bfloat162_rn(acc[n][2 * half] * scale,
                                acc[n][2 * half + 1] * scale);
    }
  }
}

// grid (B * H), block 32 * warps_for(NT) threads, smem_bytes(T, 16 NT, E).
// Tp = 16 NT >= T; E a multiple of 16. Warp w < NT owns query rows
// [16 w, 16 w + 16): thread (g = lane / 4, t4 = lane % 4) holds rows 16 w + g
// and 16 w + g + 8, columns 8 j + 2 t4 and + 1 of key tile j.
template <int NT>
__global__ void __launch_bounds__(32 * (NT < 4 ? 4 : NT))
    realformer_attn_bwd_mma_kernel(const Args a) {
  constexpr int Tp = 16 * NT;
  constexpr int TR = Tp + kPad;
  constexpr int NW = NT < 4 ? 4 : NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int E = a.E, ER = E + kPad;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + Tp * ER;
  __nv_bfloat16* dcs = ks + Tp * ER;
  __nv_bfloat16* vs = dcs + Tp * ER;  // until dp and ds are taken; then:
  float* cflat = reinterpret_cast<float*>(vs + Tp * ER);
  float* dflat = cflat + flat_floats(a.T);
  __nv_bfloat16* p_hi = vs;
  __nv_bfloat16* p_lo = p_hi + Tp * TR;
  __nv_bfloat16* ds_hi = p_lo + Tp * TR;
  __nv_bfloat16* ds_lo = ds_hi + Tp * TR;

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int T = a.T;
  const long long head = ((long long)b * a.H + h) * T * T;

  // three groups of copies, in the order the work needs them: p and dp
  // start while dcarry, q and k are still on their way
  stage(a.dctx, a.st.dctx, b, h, T, Tp, E, dcs, ER, a.vec, a.q, tid, 32 * NW);
  stage(a.v, a.st.v, b, h, T, Tp, E, vs, ER, a.vec, a.q, tid, 32 * NW);
  const int coff = stage_flat(a.carry + head, T * T, cflat, tid, 32 * NW);
  commit();
  const int doff =
      a.dcarry ? stage_flat(a.dcarry + head, T * T, dflat, tid, 32 * NW) : 0;
  commit();
  stage(a.q, a.st.q, b, h, T, Tp, E, qs, ER, a.vec, a.q, tid, 32 * NW);
  stage(a.k, a.st.k, b, h, T, Tp, E, ks, ER, a.vec, a.q, tid, 32 * NW);
  commit();
  wait_groups<2>();
  __syncthreads();

  const int r0 = 16 * warp;
  float p[2 * NT][4];   // p, then its terms go to shared memory
  float ds[2 * NT][4];  // dp, then ds
  if (warp < NT) {
    // the carry rows into the accumulator layout
    flat_to_acc<NT, false>(p, cflat + coff, T, r0, g, t4);
    softmax_rows<NT>(p);

    // dp = dctx v^T over this warp's rows and every key
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[j][i] = 0.0f;
    for (int e0 = 0; e0 < E; e0 += 16) {
      unsigned af[4];
      ldsm_x4(af, dcs + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ER + e0 +
                      ((lane >> 4) & 1) * 8);
#pragma unroll
      for (int j2 = 0; j2 < NT; ++j2) {
        unsigned bf[4];
        ldsm_x4(bf, vs + (16 * j2 + (lane & 7) + ((lane >> 4) & 1) * 8) * ER +
                        e0 + ((lane >> 3) & 1) * 8);
        product(ds[2 * j2], af, bf[0], bf[1]);
        product(ds[2 * j2 + 1], af, bf[2], bf[3]);
      }
    }
  }
  wait_groups<1>();
  __syncthreads();  // dcarry has landed

  if (warp < NT) {
    // ds = p (dp - sum_keys(dp p)) + dcarry; dprev = ds
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float d = 0.0f;
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
        d = fmaf(ds[j][2 * half], p[j][2 * half],
                 fmaf(ds[j][2 * half + 1], p[j][2 * half + 1], d));
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const int r = r0 + g + 8 * half;
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 2 * t4 + c;
          const bool in = r < T && col < T;
          float x = p[j][2 * half + c] * (ds[j][2 * half + c] - d);
          if (a.dcarry && in) x += dflat[doff + r * T + col];
          if (a.dprev && in) a.dprev[head + r * T + col] = x;
          ds[j][2 * half + c] = x;
        }
      }
    }
  }
  wait_groups<0>();
  __syncthreads();  // every warp is done with v, the carry and dcarry; q and
                    // k have landed

  if (warp < NT) {
    // p and ds as bf16 hi and lo terms, for the transposed products
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int at_rc = (r0 + g + 8 * half) * TR + 8 * j + 2 * t4;
        unsigned hi, lo;
        split(p[j][2 * half], p[j][2 * half + 1], hi, lo);
        *reinterpret_cast<unsigned*>(p_hi + at_rc) = hi;
        *reinterpret_cast<unsigned*>(p_lo + at_rc) = lo;
        split(ds[j][2 * half], ds[j][2 * half + 1], hi, lo);
        *reinterpret_cast<unsigned*>(ds_hi + at_rc) = hi;
        *reinterpret_cast<unsigned*>(ds_lo + at_rc) = lo;
      }
    }
    // dq = ds k / sqrt(E), ds from registers: key tiles 2 j2 and 2 j2 + 1
    // are the A operand of k step j2
    unsigned a_hi[NT][4], a_lo[NT][4];
#pragma unroll
    for (int j2 = 0; j2 < NT; ++j2) {
      split(ds[2 * j2][0], ds[2 * j2][1], a_hi[j2][0], a_lo[j2][0]);
      split(ds[2 * j2][2], ds[2 * j2][3], a_hi[j2][1], a_lo[j2][1]);
      split(ds[2 * j2 + 1][0], ds[2 * j2 + 1][1], a_hi[j2][2], a_lo[j2][2]);
      split(ds[2 * j2 + 1][2], ds[2 * j2 + 1][3], a_hi[j2][3], a_lo[j2][3]);
    }
    for (int e0 = 0; e0 < E; e0 += 16) {
      float acc[2][4] = {};
#pragma unroll
      for (int j2 = 0; j2 < NT; ++j2) {
        unsigned bf[4];
        const int krow = 16 * j2 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(bf, ks + krow * ER + e0 + ((lane >> 4) & 1) * 8);
        split_product(acc[0], a_hi[j2], a_lo[j2], bf[0], bf[1]);
        split_product(acc[1], a_hi[j2], a_lo[j2], bf[2], bf[3]);
      }
      store_rows(a.dq, a.st.dq, b, h, T, r0, e0, acc, a.scale, lane);
    }
  }
  __syncthreads();  // p and ds staged

  // dk = ds^T q / sqrt(E) and dv = p^T dctx: an item is one gradient's 16
  // keys, their A fragments (both terms, every query step) held in
  // registers across the 16-column steps of E
  for (int it = warp; it < 2 * NT; it += NW) {
    const bool is_dv = it >= NT;
    const int kt = is_dv ? it - NT : it;
    const __nv_bfloat16* t_hi = is_dv ? p_hi : ds_hi;
    const __nv_bfloat16* t_lo = is_dv ? p_lo : ds_lo;
    const __nv_bfloat16* bsrc = is_dv ? dcs : qs;
    const int acol = 16 * kt + ((lane >> 3) & 1) * 8;
    unsigned fh[NT][4], fl[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int arow = 16 * i + (lane & 7) + ((lane >> 4) & 1) * 8;
      ldsm_x4_t(fh[i], t_hi + arow * TR + acol);
      ldsm_x4_t(fl[i], t_lo + arow * TR + acol);
    }
    for (int e0 = 0; e0 < E; e0 += 16) {
      float acc[2][4] = {};
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        unsigned bf[4];
        const int brow = 16 * i + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(bf, bsrc + brow * ER + e0 + ((lane >> 4) & 1) * 8);
        split_product(acc[0], fh[i], fl[i], bf[0], bf[1]);
        split_product(acc[1], fh[i], fl[i], bf[2], bf[3]);
      }
      store_rows(is_dv ? a.dv : a.dk, is_dv ? a.st.dv : a.st.dk, b, h, T,
                 16 * kt, e0, acc, is_dv ? 1.0f : a.scale, lane);
    }
  }
}

template <int NT>
cudaError_t launch_nt(const Args& a, int B, cudaStream_t stream) {
  return launch_with_smem(realformer_attn_bwd_mma_kernel<NT>, B * a.H,
                          32 * warps_for(NT),
                          (int)smem_bytes(a.T, 16 * NT, a.E), a, stream);
}

template <int NT>
cudaError_t occupancy_nt(int T, int E, int* blocks) {
  return occupancy_of(realformer_attn_bwd_mma_kernel<NT>, 32 * warps_for(NT),
                      (int)smem_bytes(T, 16 * NT, E), blocks);
}

// dq, dk, dv written two elements a store
inline bool pairs_ok(const void* p, const Strides4& s) {
  return s.e == 1 && s.b % 2 == 0 && s.t % 2 == 0 && s.h % 2 == 0 &&
         reinterpret_cast<size_t>(p) % 4 == 0;
}

}  // namespace tc

// ------------------------------------------------ fp32, tensor cores

namespace tc32 {

using namespace k2tc;

// shared memory of a head: q, k, dctx as fp32 rows of ld32(E), then v and
// the flat carry and dcarry blocks, whose place the p and ds tiles (Tp
// query rows of ld32(Tp) keys each) take once ds is taken
__host__ __device__ inline size_t smem_bytes(int T, int Tp, int E) {
  const size_t rows = 4 * (size_t)Tp * ld32(E);
  const size_t first = rows + 2 * 4 * (size_t)flat_floats(T);
  const size_t tiles = 2 * 4 * (size_t)Tp * ld32(Tp);
  return 3 * rows + (first > tiles ? first : tiles);
}

struct Args {
  const float *q, *k, *v, *dctx;  // dctx may be null (zero)
  const float* carry;
  const float* dcarry;  // may be null (zero)
  float *dq, *dk, *dv;
  float* dprev;         // may be null (not wanted)
  BwdStrides st;
  int H, T, E;
  float scale;
  int vec;              // 16-byte copies of q, k, v and dctx
};

// grid (B * H), block 32 * warps_for(NT) threads, smem_bytes(T, 16 NT, E).
// Tp = 16 NT >= T; E a multiple of 16. Warp w < NT owns query rows
// [16 w, 16 w + 16): thread (g = lane / 4, t4 = lane % 4) holds rows 16 w + g
// and + 8 of key tile j, columns 2 t4 and 2 t4 + 1 of its m16n8
// accumulators, which are keys 8 j + t4 and + 4 (kperm).
template <int NT>
__global__ void __launch_bounds__(32 * warps_for(NT))
    realformer_attn_bwd_tf32x3_kernel(const Args a) {
  constexpr int Tp = 16 * NT, PT = ld32(Tp), NW = warps_for(NT);
  constexpr int NTH = 32 * NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int E = a.E, LD = ld32(E), T = a.T;
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + Tp * LD;
  float* dcs = ks + Tp * LD;
  float* vs = dcs + Tp * LD;  // until ds is taken; then the p and ds tiles
  float* cflat = vs + Tp * LD;
  float* dflat = cflat + flat_floats(T);
  float* pt = vs;
  float* dst = pt + Tp * PT;

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long long head = ((long long)b * a.H + h) * T * T;

  // three groups of copies, in the order the work needs them: p and dp
  // start while dcarry, q and k are still on their way
  stage32(a.dctx, a.st.dctx, b, h, T, Tp, E, dcs, a.vec, a.q, tid, NTH);
  stage32(a.v, a.st.v, b, h, T, Tp, E, vs, a.vec, a.q, tid, NTH);
  const int coff = stage_flat(a.carry + head, T * T, cflat, tid, NTH);
  commit();
  const int doff =
      a.dcarry ? stage_flat(a.dcarry + head, T * T, dflat, tid, NTH) : 0;
  commit();
  stage32(a.q, a.st.q, b, h, T, Tp, E, qs, a.vec, a.q, tid, NTH);
  stage32(a.k, a.st.k, b, h, T, Tp, E, ks, a.vec, a.q, tid, NTH);
  commit();
  wait_groups<2>();
  __syncthreads();

  const int r0 = 16 * warp;
  float p[2 * NT][4];   // p
  float ds[2 * NT][4];  // dp, then ds
  if (warp < NT) {
    // the carry rows into the accumulator layout, keys in kperm order
    flat_to_acc<NT, true>(p, cflat + coff, T, r0, g, t4);
    softmax_rows<NT, true>(p);

    // dp = dctx v^T over this warp's rows and every key, split TF32
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[j][i] = 0.0f;
    for (int e0 = 0; e0 < E; e0 += 8) {
      tf32::FragA fa;
      tf32::ldsm_a(fa, dcs, LD, r0, e0, lane);
#pragma unroll
      for (int j2 = 0; j2 < NT; ++j2) {
        tf32::FragB f0, f1;
        ldsm_b2_keys(f0, f1, vs, LD, e0, 16 * j2, lane);
        tf32::mma3_into(ds[2 * j2], fa, f0);
        tf32::mma3_into(ds[2 * j2 + 1], fa, f1);
      }
    }
  }
  wait_groups<1>();
  __syncthreads();  // dcarry has landed

  if (warp < NT) {
    // ds = p (dp - sum_keys(dp p)) + dcarry; dprev = ds. Written out here
    // and in the bf16 kernel rather than shared: as one function in
    // attention_tile.cuh it made this kernel 7% slower on the H100 at T=75,
    // B=16
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float d = 0.0f;
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
        d = fmaf(ds[j][2 * half], p[j][2 * half],
                 fmaf(ds[j][2 * half + 1], p[j][2 * half + 1], d));
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const int r = r0 + g + 8 * half;
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + t4 + 4 * c;
          const bool in = r < T && col < T;
          float x = p[j][2 * half + c] * (ds[j][2 * half + c] - d);
          if (a.dcarry && in) x += dflat[doff + r * T + col];
          if (a.dprev && in) a.dprev[head + r * T + col] = x;
          ds[j][2 * half + c] = x;
        }
      }
    }
  }
  wait_groups<0>();
  __syncthreads();  // every warp is done with v, the carry and dcarry; q and
                    // k have landed

  if (warp < NT) {
    // p and ds into their tiles (query rows, keys in natural order), for
    // the transposed products
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = r0 + g + 8 * half, col = 8 * j + t4 + 4 * c;
          *tf32::at(pt, PT, r, col) = p[j][2 * half + c];
          *tf32::at(dst, PT, r, col) = ds[j][2 * half + c];
        }
      }
    }
    // dq = ds k / sqrt(E): key tile j is the k step j, ds's A fragments
    // straight from the accumulators, k's B fragments in natural key order
    tf32::FragA da[2 * NT];
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) acc_to_a(da[j], ds[j]);
    for (int e0 = 0; e0 < E; e0 += 16) {
      float acc[2][4] = {};
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j) {
        tf32::FragB f0, f1;
        tf32::load_b(f0, ks, LD, 8 * j, e0, g, t4);
        tf32::load_b(f1, ks, LD, 8 * j, e0 + 8, g, t4);
        tf32::mma3_into(acc[0], da[j], f0);
        tf32::mma3_into(acc[1], da[j], f1);
      }
      store_rows32(a.dq, a.st.dq, b, h, T, r0, e0, acc, a.scale, lane);
    }
  }
  __syncthreads();  // p and ds staged

  // dk = ds^T q / sqrt(E) and dv = p^T dctx: an item is one gradient's 16
  // keys, their A fragments (every query step, from the tile read
  // transposed) held in registers across the 16-column steps of E
  for (int it = warp; it < 2 * NT; it += NW) {
    const bool is_dv = it >= NT;
    const int kt = is_dv ? it - NT : it;
    const float* tile = is_dv ? pt : dst;
    const float* bsrc = is_dv ? dcs : qs;
    tf32::FragA fa[2 * NT];
#pragma unroll
    for (int i = 0; i < 2 * NT; ++i)
      tf32::load_a_t(fa[i], tile, PT, 16 * kt, 8 * i, g, t4);
    for (int e0 = 0; e0 < E; e0 += 16) {
      float acc[2][4] = {};
#pragma unroll
      for (int i = 0; i < 2 * NT; ++i) {
        tf32::FragB f0, f1;
        tf32::load_b(f0, bsrc, LD, 8 * i, e0, g, t4);
        tf32::load_b(f1, bsrc, LD, 8 * i, e0 + 8, g, t4);
        tf32::mma3_into(acc[0], fa[i], f0);
        tf32::mma3_into(acc[1], fa[i], f1);
      }
      store_rows32(is_dv ? a.dv : a.dk, is_dv ? a.st.dv : a.st.dk, b, h, T,
                   16 * kt, e0, acc, is_dv ? 1.0f : a.scale, lane);
    }
  }
}

template <int NT>
cudaError_t launch_nt(const Args& a, int B, cudaStream_t stream) {
  return launch_with_smem(realformer_attn_bwd_tf32x3_kernel<NT>, B * a.H,
                          32 * warps_for(NT),
                          (int)smem_bytes(a.T, 16 * NT, a.E), a, stream);
}

template <int NT>
cudaError_t occupancy_nt(int T, int E, int* blocks) {
  return occupancy_of(realformer_attn_bwd_tf32x3_kernel<NT>,
                      32 * warps_for(NT), (int)smem_bytes(T, 16 * NT, E),
                      blocks);
}

}  // namespace tc32

}  // namespace k2bwd
}  // namespace mmvqa

// q, k, v, dctx, dq, dk, dv: (B, T, H, E) by element strides, given in
// `strides` as 28 int64 (in that order; each b, t, h, e), all of one dtype.
// carry: (B, H, T, T) fp32, the forward's stored scores. dctx, dcarry: the
// gradients of the forward's two outputs, either may be null (zero). dprev:
// (B, H, T, T) fp32 out, or null where the layer had no prev. path: 0 the
// fp32 one-block kernel, 1 the tiled kernels, 2 the tensor-core kernel of
// the dtype, bf16 or fp32 (split TF32) (ops/attention.py::backward_path).
// scratch, for the tiled kernels only: (B, H, T, T) fp32 for ds where dprev
// is null, and (B, H, T, 2) fp32 for the row statistics; null otherwise.
extern "C" int realformer_attn_bwd(const void* q, const void* k, const void* v,
                                   const void* carry, const void* dctx,
                                   const void* dcarry, void* dq, void* dk,
                                   void* dv, void* dprev, void* ds_scratch,
                                   void* stats, const long long* strides,
                                   int dtype, int B, int H, int Tn, int E,
                                   int path, void* stream) {
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
  if (path == 2 && dtype == kFloat32) {
    namespace tc32 = k2bwd::tc32;
    if (E % 16 != 0 || E < 16 || E > 128 || !tc32::pairs8(dq, st.dq) ||
        !tc32::pairs8(dk, st.dk) || !tc32::pairs8(dv, st.dv))
      return static_cast<int>(cudaErrorInvalidValue);
    using f = float;
    const tc32::Args a{static_cast<const f*>(q), static_cast<const f*>(k),
                       static_cast<const f*>(v), static_cast<const f*>(dctx),
                       cr, dc, static_cast<f*>(dq), static_cast<f*>(dk),
                       static_cast<f*>(dv), dp, st, H, Tn, E,
                       1.0f / sqrtf((float)E),
                       tc32::rows16(q, st.q, 4) && tc32::rows16(k, st.k, 4) &&
                           tc32::rows16(v, st.v, 4) &&
                           tc32::rows16(dctx, st.dctx, 4)};
    err = tc32::dispatch(Tn, [&](auto nt) {
      return tc32::launch_nt<decltype(nt)::value>(a, B, s);
    });
  } else if (path == 2) {
    namespace tc = k2bwd::tc;
    if (dtype != kBFloat16 || E % 16 != 0 || E < 16 ||
        !tc::pairs_ok(dq, st.dq) || !tc::pairs_ok(dk, st.dk) ||
        !tc::pairs_ok(dv, st.dv))
      return static_cast<int>(cudaErrorInvalidValue);
    using bf = __nv_bfloat16;
    const tc::Args a{static_cast<const bf*>(q), static_cast<const bf*>(k),
                     static_cast<const bf*>(v), static_cast<const bf*>(dctx),
                     cr, dc, static_cast<bf*>(dq), static_cast<bf*>(dk),
                     static_cast<bf*>(dv), dp, st, H, Tn, E,
                     1.0f / sqrtf((float)E),
                     tc::rows16(q, st.q) && tc::rows16(k, st.k) &&
                         tc::rows16(v, st.v) && tc::rows16(dctx, st.dctx)};
    err = tc::dispatch(Tn, [&](auto nt) {
      return tc::launch_nt<decltype(nt)::value>(a, B, s);
    });
  } else if (dtype == kFloat32) {
    err = path ? k2bwd::launch_tiled<float>(q, k, v, cr, dctx, dc, dq, dk, dv,
                                            ds, sts, st, B, H, Tn, E, s)
               : k2bwd::launch<float>(q, k, v, cr, dctx, dc, dq, dk, dv, dp,
                                      st, B, H, Tn, E, s);
  } else if (dtype == kBFloat16) {
    err = path ? k2bwd::launch_tiled<__nv_bfloat16>(q, k, v, cr, dctx, dc, dq,
                                                    dk, dv, ds, sts, st, B, H,
                                                    Tn, E, s)
               : k2bwd::launch<__nv_bfloat16>(q, k, v, cr, dctx, dc, dq, dk,
                                              dv, dp, st, B, H, Tn, E, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Blocks of the tensor-core backward of `dtype` (bf16 or fp32) for (T, E)
// that an SM holds at once.
extern "C" int realformer_attn_bwd_mma_occupancy(int dtype, int Tn, int E,
                                                 int* blocks) {
  using namespace mmvqa::k2bwd;
  if (dtype == mmvqa::kFloat32)
    return static_cast<int>(tc32::dispatch(Tn, [&](auto nt) {
      return tc32::occupancy_nt<decltype(nt)::value>(Tn, E, blocks);
    }));
  return static_cast<int>(tc::dispatch(Tn, [&](auto nt) {
    return tc::occupancy_nt<decltype(nt)::value>(Tn, E, blocks);
  }));
}
