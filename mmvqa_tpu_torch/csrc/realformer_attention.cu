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
// What bounds it on an H100: bytes. At the training shape (B=128, H=8,
// T=75, E=96, bf16, prev and mask) a layer reads q, k, v and prev and
// writes ctx and the carry: 105 MB, 0.031 ms at 3.35 TB/s, against two
// products of 1.1 GFLOP each. In fp32 at the CLIs' B=16 it moves 20.5 MB
// (0.0061 ms) against 0.28 GFLOP of split-TF32 products (0.0017 ms at 165
// TFLOP/s). Paths chosen by dtype, T and E alone
// (ops/attention.py::forward_path):
//
// * bf16 where a head fits one block (E a multiple of 16 up to 128, T up to
//   128): the tensor-core kernel (tc::realformer_attn_fwd_mma_kernel). One
//   block a (batch, head) stages the head's q, k and v rows in bf16 shared
//   memory by 16-byte cp.async, T padded to Tp, a multiple of 16, with zero
//   rows, and its prev, a flat T x T fp32 block that starts on 4 bytes
//   only, by 16-byte copies peeled to the carry's 16-byte boundary; the
//   copies come in three groups (q and k, prev, v), in the order the work
//   needs them. A warp owns 16 query rows: s = q k^T on mma.sync.m16n8k16
//   into fp32 accumulators (16 x Tp a warp, 40 registers at T=75), then the
//   scale, prev from shared memory in the accumulator layout and the mask
//   term, in the plain version's order. s goes into the flat block in
//   place of prev and out to the carry by 16-byte stores, the staging
//   reversed. The softmax runs in the registers (row max and sum by quad
//   shuffles; keys past T are -inf); p's accumulator fragments are the A
//   operand of p v with no trip through shared memory (two key tiles make
//   one k step), as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi),
//   because one term misses the bf16 tolerance (tests/test_torch_ops.py::
//   test_attention_bf16_forward_needs_both_terms); v is read as the B
//   operand by ldmatrix.trans. ctx is staged in bf16 in the warp's own q
//   rows and leaves by 16-byte stores. 73 KB a head at T=75, three blocks
//   an SM.
// * fp32 where a head's fp32 rows fit one block (E a multiple of 16 up to
//   128, T up to 128 at E=96: 213 KB): the split-TF32 kernel
//   (tc32::realformer_attn_fwd_tf32x3_kernel), the bf16 kernel's shape on
//   mma.sync.m16n8k8.tf32. q, k and v come in as fp32 rows of ld32(E)
//   values in tf32x3.cuh's swizzle (no padding) by 16-byte cp.async, prev
//   as in bf16. Every product is three TF32 products, a_lo b_hi + a_hi b_lo
//   + a_hi b_hi, each operand split as its fragment is loaded (hi = v
//   rounded to TF32, lo = the rest), summed into the fp32 accumulators: the
//   error is fp32's own (tests/test_torch_attention_fp32.py models it
//   against the JAX package), where one TF32 product would miss the fp32
//   tolerance. The m16n8k8 A fragment takes columns t4 and t4 + 4 of a
//   thread's row where the accumulator holds 2 t4 and 2 t4 + 1, so the
//   kernel gives ldmatrix the k rows of s's B fragments in the order kperm
//   (attention_tile.cuh): each accumulator pair is then keys t4 and t4 + 4,
//   and p goes into p v from the registers with v read in natural order.
//   The softmax takes expf, as the plain version does. ctx leaves by 8-byte
//   stores. 115 KB a head at T=75: two blocks an SM (B=16 gives 128).
// * Other dtypes and widths where a head's fp32 tiles fit one block's
//   shared memory: the one-block kernel below (realformer_attn_fwd_kernel),
//   q, k, v and the score tile in fp32 shared memory, products on the CUDA
//   cores, one thread an output element (T=128 at E=96: 214 KB).
// * Beyond that, the tiled kernel below takes any T: a block owns 32 query
//   rows of one head and walks the keys 32 at a time, three times. The
//   score rows it writes to the carry (which is (B, H, T, T) in device
//   memory anyway) hold its softmax state: the first walk writes the
//   scores, a warp a row then takes their maximum and sum, and the last
//   walk turns them into probabilities and sums p v. The carry is read back
//   twice from L2.
//
// q, k and v are read by strides, so the slices of the shared kqv projection
// go in as views.
#include "attention_tile.cuh"

namespace mmvqa {

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

// ------------------------------------------------ bf16, tensor cores

namespace tc {

using namespace k2tc;

struct Args {
  const __nv_bfloat16 *q, *k, *v;
  const float* prev;  // may be null
  const float* mask;  // may be null
  float* carry;
  __nv_bfloat16* ctx;
  AttnStrides st;
  int heads, H, T, E;
  float scale;  // 1 / sqrt(E)
  int vec;      // 16-byte copies of q, k and v
};

// shared memory of one head: q, k, v in bf16 rows of E + 8, then the flat
// (T, T) fp32 block of prev, then of s
inline size_t stage_bytes(int T, int Tp, int E) {
  return 3 * 2 * (size_t)Tp * (E + kPad) + 4 * (size_t)flat_floats(T);
}

struct Stage {
  __nv_bfloat16 *q, *k, *v;
  float* flat;
};

__device__ __forceinline__ Stage stage_at(unsigned char* base, int Tp,
                                          int E) {
  const int ER = E + kPad;
  Stage s;
  s.q = reinterpret_cast<__nv_bfloat16*>(base);
  s.k = s.q + Tp * ER;
  s.v = s.k + Tp * ER;
  s.flat = reinterpret_cast<float*>(s.v + Tp * ER);
  return s;
}

// head bh's copies into stage s, in three groups in the order its work
// needs them: q and k; prev; v. prev keeps the carry's offset within 16
// bytes, so that the same flat block goes out to the carry by 16-byte
// stores; where prev's offset differs, it comes in by plain loads.
template <int NT>
__device__ __forceinline__ void load(const Args& a, int bh, const Stage& s,
                                     int tid) {
  constexpr int Tp = 16 * NT, NTH = 32 * warps_for(NT);
  const int b = bh / a.H, h = bh % a.H, T = a.T, E = a.E, ER = E + kPad;
  stage(a.q, a.st.q, b, h, T, Tp, E, s.q, ER, a.vec, a.q, tid, NTH);
  stage(a.k, a.st.k, b, h, T, Tp, E, s.k, ER, a.vec, a.q, tid, NTH);
  commit();
  if (a.prev) {
    const long long head = (long long)bh * T * T;
    const int off = flat_offset(a.carry + head);
    if (flat_offset(a.prev + head) == off) {
      stage_flat(a.prev + head, T * T, s.flat, tid, NTH);
    } else {
      for (int i = tid; i < T * T; i += NTH) s.flat[off + i] = a.prev[head + i];
    }
  }
  commit();
  stage(a.v, a.st.v, b, h, T, Tp, E, s.v, ER, a.vec, a.q, tid, NTH);
  commit();
}

// head bh from stage s, whose three copy groups are the last committed.
// Warp w < NT owns query rows [16 w, 16 w + 16): thread (g = lane / 4,
// t4 = lane % 4) holds rows 16 w + g and 16 w + g + 8, columns 8 j + 2 t4
// and + 1 of key tile j, as mma.sync's accumulators.
// Each step's ldmatrix loads are issued before its products, which take
// independent accumulators where they can: the asm statements keep their
// order, so this is the schedule.
template <int NT>
__device__ __forceinline__ void compute(const Args& a, int bh, const Stage& s,
                                        int tid) {
  constexpr int NTH = 32 * warps_for(NT);
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int b = bh / a.H, h = bh % a.H, T = a.T, E = a.E, ER = E + kPad;
  const long long head = (long long)bh * T * T;
  const int off = flat_offset(a.carry + head);
  const int r0 = 16 * warp;
  float p[2 * NT][4];  // s, then p

  wait_groups<2>();
  __syncthreads();  // q and k have landed
  if (warp < NT) {
    // s = q k^T over this warp's rows and every key
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[j][i] = 0.0f;
    for (int e0 = 0; e0 < E; e0 += 16) {
      unsigned af[4], bf[NT][4];
      ldsm_x4(af, s.q + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ER + e0 +
                      ((lane >> 4) & 1) * 8);
#pragma unroll
      for (int j2 = 0; j2 < NT; ++j2)
        ldsm_x4(bf[j2], s.k + (16 * j2 + (lane & 7) + ((lane >> 4) & 1) * 8) *
                                  ER + e0 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int j2 = 0; j2 < NT; ++j2) {
        mma(p[2 * j2], af, bf[j2][0], bf[j2][1]);
        mma(p[2 * j2 + 1], af, bf[j2][2], bf[j2][3]);
      }
    }
  }
  wait_groups<1>();
  __syncthreads();  // prev has landed
  if (warp < NT)
    scores_to_flat<NT, false>(p, s.flat + off, a.prev != nullptr,
                              a.mask ? a.mask + (long long)b * T : nullptr,
                              T, r0, g, t4, a.scale);
  wait_groups<0>();
  __syncthreads();  // every row of s is in the flat block; v has landed
  store_flat(s.flat, T * T, a.carry + head, tid, NTH);
  if (warp < NT) {
    softmax_rows<NT>(p);
    // p as the A operand with no trip through shared memory: key tiles
    // 2 j2 and 2 j2 + 1 are the k step j2, each as two bf16 terms
    unsigned hi[NT][4], lo[NT][4];
#pragma unroll
    for (int j2 = 0; j2 < NT; ++j2) {
      split(p[2 * j2][0], p[2 * j2][1], hi[j2][0], lo[j2][0]);
      split(p[2 * j2][2], p[2 * j2][3], hi[j2][1], lo[j2][1]);
      split(p[2 * j2 + 1][0], p[2 * j2 + 1][1], hi[j2][2], lo[j2][2]);
      split(p[2 * j2 + 1][2], p[2 * j2 + 1][3], hi[j2][3], lo[j2][3]);
    }
    // ctx = p v, staged in bf16 in this warp's own q rows, done with; the
    // hi and lo products of each 8 columns in accumulators of their own
    __nv_bfloat16* out = s.q + r0 * ER;
    for (int e0 = 0; e0 < E; e0 += 16) {
      unsigned bf[NT][4];
#pragma unroll
      for (int j2 = 0; j2 < NT; ++j2)
        ldsm_x4_t(bf[j2], s.v + (16 * j2 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * ER +
                              e0 + ((lane >> 4) & 1) * 8);
      float acc[2][2][4] = {};  // columns e0 + 8 n, term
#pragma unroll
      for (int j2 = 0; j2 < NT; ++j2) {
        mma(acc[0][0], hi[j2], bf[j2][0], bf[j2][1]);
        mma(acc[1][0], hi[j2], bf[j2][2], bf[j2][3]);
        mma(acc[0][1], lo[j2], bf[j2][0], bf[j2][1]);
        mma(acc[1][1], lo[j2], bf[j2][2], bf[j2][3]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int n = 0; n < 2; ++n)
          *reinterpret_cast<__nv_bfloat162*>(
              out + (g + 8 * half) * ER + e0 + 8 * n + 2 * t4) =
              __floats2bfloat162_rn(
                  acc[n][0][2 * half] + acc[n][1][2 * half],
                  acc[n][0][2 * half + 1] + acc[n][1][2 * half + 1]);
    }
    __syncwarp();
    // the warp's rows below T out by 16-byte stores
    const int pieces = E / 8;
    for (int i = lane; i < 16 * pieces; i += 32) {
      const int r = i / pieces, e = (i % pieces) * 8;
      if (r0 + r < T)
        *reinterpret_cast<uint4*>(a.ctx + b * a.st.ctx.b +
                                  (r0 + r) * a.st.ctx.t + h * a.st.ctx.h + e) =
            *reinterpret_cast<const uint4*>(out + r * ER + e);
    }
  }
}

// grid: one block a head; block 32 * warps_for(NT) threads; stage_bytes(T,
// 16 NT, E) of shared memory. Tp = 16 NT >= T; E a multiple of 16.
template <int NT>
__global__ void __launch_bounds__(32 * warps_for(NT))
    realformer_attn_fwd_mma_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Stage s = stage_at(smem_raw, 16 * NT, a.E);
  load<NT>(a, blockIdx.x, s, threadIdx.x);
  compute<NT>(a, blockIdx.x, s, threadIdx.x);
}

template <int NT>
cudaError_t occupancy_nt(int T, int E, int* blocks) {
  return occupancy_of(realformer_attn_fwd_mma_kernel<NT>, 32 * warps_for(NT),
                      (int)stage_bytes(T, 16 * NT, E), blocks);
}

template <int NT>
cudaError_t launch_nt(const Args& a, cudaStream_t stream) {
  return launch_with_smem(realformer_attn_fwd_mma_kernel<NT>, a.heads,
                          32 * warps_for(NT),
                          (int)stage_bytes(a.T, 16 * NT, a.E), a, stream);
}

}  // namespace tc

// ------------------------------------------------ fp32, tensor cores

namespace tc32 {

using namespace k2tc;

struct Args {
  const float *q, *k, *v;
  const float* prev;  // may be null
  const float* mask;  // may be null
  float* carry;
  float* ctx;
  AttnStrides st;
  int H, T, E;
  float scale;  // 1 / sqrt(E)
  int vec;      // 16-byte copies of q, k and v
};

// shared memory of one head: q, k, v as fp32 rows of ld32(E), then the flat
// (T, T) fp32 block of prev, then of s
inline size_t stage_bytes(int T, int Tp, int E) {
  return 3 * 4 * (size_t)Tp * ld32(E) + 4 * (size_t)flat_floats(T);
}

// grid: one block a head; block 32 * warps_for(NT) threads; stage_bytes(T,
// 16 NT, E) of shared memory. Tp = 16 NT >= T; E a multiple of 16. Warp
// w < NT owns query rows [16 w, 16 w + 16): thread (g = lane / 4, t4 =
// lane % 4) holds rows 16 w + g and + 8 of key tile j, columns 2 t4 and
// 2 t4 + 1 of its m16n8 accumulators, which are keys 8 j + t4 and + 4
// (kperm).
template <int NT>
__global__ void __launch_bounds__(32 * warps_for(NT))
    realformer_attn_fwd_tf32x3_kernel(const Args a) {
  constexpr int Tp = 16 * NT, NTH = 32 * warps_for(NT);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int T = a.T, E = a.E, LD = ld32(E);
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + Tp * LD;
  float* vs = ks + Tp * LD;
  float* flat = vs + Tp * LD;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long long head = (long long)bh * T * T;
  const int off = flat_offset(a.carry + head);

  // three groups of copies, in the order the work needs them: q and k;
  // prev (at the carry's offset within 16 bytes, as the bf16 kernel keeps
  // it); v
  stage32(a.q, a.st.q, b, h, T, Tp, E, qs, a.vec, a.q, tid, NTH);
  stage32(a.k, a.st.k, b, h, T, Tp, E, ks, a.vec, a.q, tid, NTH);
  commit();
  if (a.prev) {
    if (flat_offset(a.prev + head) == off) {
      stage_flat(a.prev + head, T * T, flat, tid, NTH);
    } else {
      for (int i = tid; i < T * T; i += NTH) flat[off + i] = a.prev[head + i];
    }
  }
  commit();
  stage32(a.v, a.st.v, b, h, T, Tp, E, vs, a.vec, a.q, tid, NTH);
  commit();

  const int r0 = 16 * warp;
  float p[2 * NT][4];  // s, then p
  wait_groups<2>();
  __syncthreads();  // q and k have landed
  if (warp < NT) {
    // s = q k^T over this warp's rows and every key, three TF32 products a
    // product, summed into the accumulators (a contraction of E <= 128)
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[j][i] = 0.0f;
    for (int e0 = 0; e0 < E; e0 += 8) {
      tf32::FragA fa;
      tf32::ldsm_a(fa, qs, LD, r0, e0, lane);
#pragma unroll
      for (int j2 = 0; j2 < NT; ++j2) {
        tf32::FragB f0, f1;
        ldsm_b2_keys(f0, f1, ks, LD, e0, 16 * j2, lane);
        tf32::mma3_into(p[2 * j2], fa, f0);
        tf32::mma3_into(p[2 * j2 + 1], fa, f1);
      }
    }
  }
  wait_groups<1>();
  __syncthreads();  // prev has landed
  if (warp < NT)
    scores_to_flat<NT, true>(p, flat + off, a.prev != nullptr,
                             a.mask ? a.mask + (long long)b * T : nullptr, T,
                             r0, g, t4, a.scale);
  wait_groups<0>();
  __syncthreads();  // every row of s is in the flat block; v has landed
  store_flat(flat, T * T, a.carry + head, tid, NTH);
  if (warp < NT) {
    softmax_rows<NT, true>(p);
    // ctx = p v: key tile j is the k step j, p's A fragments straight from
    // the accumulators, v's B fragments in natural key order
    tf32::FragA pa[2 * NT];
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) acc_to_a(pa[j], p[j]);
    for (int e0 = 0; e0 < E; e0 += 16) {
      float acc[2][4] = {};
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j) {
        tf32::FragB f0, f1;
        tf32::load_b(f0, vs, LD, 8 * j, e0, g, t4);
        tf32::load_b(f1, vs, LD, 8 * j, e0 + 8, g, t4);
        tf32::mma3_into(acc[0], pa[j], f0);
        tf32::mma3_into(acc[1], pa[j], f1);
      }
      store_rows32(a.ctx, a.st.ctx, b, h, T, r0, e0, acc, 1.0f, lane);
    }
  }
}

template <int NT>
cudaError_t occupancy_nt(int T, int E, int* blocks) {
  return occupancy_of(realformer_attn_fwd_tf32x3_kernel<NT>,
                      32 * warps_for(NT), (int)stage_bytes(T, 16 * NT, E),
                      blocks);
}

template <int NT>
cudaError_t launch_nt(const Args& a, int heads, cudaStream_t stream) {
  return launch_with_smem(realformer_attn_fwd_tf32x3_kernel<NT>, heads,
                          32 * warps_for(NT),
                          (int)stage_bytes(a.T, 16 * NT, a.E), a, stream);
}

}  // namespace tc32

}  // namespace mmvqa

// q, k, v, ctx: (B, T, H, E) by element strides, given in `strides` as 16
// int64 (q, k, v, ctx; each b, t, h, e). prev: (B, H, T, T) fp32 or null;
// mask: (B, T) fp32 or null; scores: (B, H, T, T) fp32 out. path: 0 the
// one-block kernel, 1 the tiled one, 2 the tensor-core kernel of the dtype
// (ops/attention.py::forward_path): bf16, which writes ctx by 16-byte
// stores, or fp32 (split TF32), which writes it by 8-byte stores.
extern "C" int realformer_attn_fwd(const void* q, const void* k, const void* v,
                                   const void* prev, const void* mask,
                                   void* scores, void* ctx,
                                   const long long* strides, int dtype, int B,
                                   int H, int Tn, int E, int path,
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
  const bool tiled = path == 1;
  cudaError_t err;
  if (path == 2) {
    if (E % 16 != 0 || E < 16 || E > 128)
      return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == kBFloat16) {
      if (!tc::rows16(ctx, st.ctx))
        return static_cast<int>(cudaErrorInvalidValue);
      using bf = __nv_bfloat16;
      const tc::Args a{static_cast<const bf*>(q), static_cast<const bf*>(k),
                       static_cast<const bf*>(v), pv, mk, sc,
                       static_cast<bf*>(ctx), st, B * H, H, Tn, E,
                       1.0f / sqrtf((float)E),
                       tc::rows16(q, st.q) && tc::rows16(k, st.k) &&
                           tc::rows16(v, st.v)};
      err = tc::dispatch(Tn, [&](auto nt) {
        return tc::launch_nt<decltype(nt)::value>(a, s);
      });
    } else if (dtype == kFloat32) {
      if (!tc32::pairs8(ctx, st.ctx))
        return static_cast<int>(cudaErrorInvalidValue);
      const tc32::Args a{static_cast<const float*>(q),
                         static_cast<const float*>(k),
                         static_cast<const float*>(v), pv, mk, sc,
                         static_cast<float*>(ctx), st, H, Tn, E,
                         1.0f / sqrtf((float)E),
                         tc32::rows16(q, st.q, 4) && tc32::rows16(k, st.k, 4) &&
                             tc32::rows16(v, st.v, 4)};
      err = tc32::dispatch(Tn, [&](auto nt) {
        return tc32::launch_nt<decltype(nt)::value>(a, B * H, s);
      });
    } else {
      err = cudaErrorInvalidValue;
    }
  } else if (dtype == kFloat32) {
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

// Blocks of the tensor-core forward of `dtype` (bf16 or fp32) for (T, E)
// that an SM holds at once.
extern "C" int realformer_attn_fwd_mma_occupancy(int dtype, int Tn, int E,
                                                 int* blocks) {
  using namespace mmvqa;
  if (dtype == kFloat32)
    return static_cast<int>(tc32::dispatch(Tn, [&](auto nt) {
      return tc32::occupancy_nt<decltype(nt)::value>(Tn, E, blocks);
    }));
  return static_cast<int>(tc::dispatch(Tn, [&](auto nt) {
    return tc::occupancy_nt<decltype(nt)::value>(Tn, E, blocks);
  }));
}
