// K1 backward: gradients of out[b, c] = mean_p act(x[b, p, :] . W[:, c]).
//
// Replaces the TPU kernel mmvqa_tpu/ops/pallas_token_head.py::_bwd_kernel
// (_bwd_call, pallas_call at :273; the custom VJP of fused_token_head).
//
//   s    = x W                       recomputed per tile, fp32
//   gact = act'(s) * g[b, c] / P     fp32, never rounded to the input dtype
//   dx   = gact W^T                  (B, P, K), x's dtype, through dx's strides
//   dW   = sum_{b, p} x^T gact       (K, C), fp32
//
// Like the forward it never writes a (B, P, C) array.
//
// What bounds it on an H100: operations. At the flagship stage-0 tap (B=128,
// P=112*112, K=24, C=768) it does three products of 29.6 G multiply-adds
// each and 1.2 G evaluations of act' (for SERF an erf, a log1p and three
// exps) against 77 MB of x read and 77 MB of dx written in bf16.
//
// Design. A block owns whole position tiles (64 positions of one batch row)
// and walks the channel tiles (128) inside, so dx of a tile is complete
// within the block: it is summed over the channel tiles in shared memory
// and written once. Per (position tile, channel tile) the block
//   1. recomputes s as the forward does (register-tiled fp32 GEMM, K staged
//      32 at a time), turns it into gact and parks the 64 x 128 tile in
//      shared memory;
//   2. walks K again, 32 at a time and backwards, so that the chunk phase 1
//      staged last is not staged again, and takes both gradient products from
//      the parked tile as register-tiled GEMMs: dx[64, 32] over the 128
//      channels (4 positions x 2 k a thread) and dW[32, 128] over the 64
//      positions (2 k x 8 channels a thread).
// The TPU kernel carries dW in one output block over a sequential grid; CUDA
// blocks run in no order, so every block adds its dW into a partial of its
// own, (nblocks, K, C) fp32 in device memory (L2 holds the part in use), and
// a second kernel adds the partials in block order. No float atomics: two
// runs give identical bits.
//
// A first version staged K 8 at a time in both phases, with 2 x 1 and 1 x 4
// thread tiles for the gradient products. Measured in turns on one card
// (PERF.md; bf16, B=128, the five flagship taps summed): the 32-deep stage
// with these tiles 31.1 -> 27.4 ms; one staging less per tile pair and the
// dW partial read ahead of its product -> 25.2 ms; the fast exp and divide
// in the bf16 activation's derivative and no dW work on padded k's ->
// 23.1 ms. What holds the rest has not been profiled; the candidates are the
// activation's derivative, the barriers around each staging with only two
// blocks an SM, and the dW partial's trip through L2.
//
// x is read, and dx written, by strides, so the trunk's channels-last map
// and its gradient go through as views with no transposing copy.
#include "common.cuh"

namespace mmvqa {
namespace k1bwd {

constexpr int kTileP = 64;    // positions per tile
constexpr int kTileC = 128;   // channels per channel tile
constexpr int kChunk2 = 32;   // k's staged per step
constexpr int kThreads = 256;
constexpr int kRegP = 4;      // phase 1: positions per thread
constexpr int kRegC = 8;      // phase 1: channels per thread (contiguous)
constexpr int kGroupsP = kTileP / kRegP;
constexpr int kGroupsC = kTileC / kRegC;
static_assert(kGroupsP * kGroupsC == kThreads, "thread tile");
// row stride of the W and gact tiles: 16-byte aligned rows whose starts fall
// on different banks, so that eight rows are read without a conflict
constexpr int kRowC = kTileC + 4;

enum Act : int { kSerf = 0, kSerfFast = 1, kRelu = 2 };

// derivative of the activation (mmvqa_tpu/ops/pallas_token_head.py::_act_grad)
template <int ACT>
__device__ __forceinline__ float act_grad(float s) {
  if (ACT == kSerf) {
    const float y = log1pf(expf(fminf(s, 50.0f)));
    const float sig = 1.0f / (1.0f + expf(-s));
    // 2 / sqrt(pi)
    return erff(y) + s * 1.1283791670955126f * expf(-y * y) * sig;
  } else if (ACT == kSerfFast) {
    // x * sigmoid(p5(x)) with ops/activations.py::SERF_P5
    constexpr float c0 = 4.743144768698157e-04f, c1 = 9.427917061937980e-03f,
                    c2 = 7.255023041520858e-02f, c3 = 2.832661920672991e-01f,
                    c4 = 1.605305418315285e+00f, c5 = 7.293287033146151e-01f;
    const float q = ((((c0 * s + c1) * s + c2) * s + c3) * s + c4) * s + c5;
    const float dq =
        (((5.0f * c0 * s + 4.0f * c1) * s + 3.0f * c2) * s + 2.0f * c3) * s + c4;
    // the fast exp and divide (about 2 ulps each): this is the bf16
    // activation, and its derivative is a fifth of the kernel's instructions
    const float gate = __fdividef(1.0f, 1.0f + __expf(-q));
    return gate + s * gate * (1.0f - gate) * dq;
  } else {
    return s > 0.0f ? 1.0f : 0.0f;
  }
}

__host__ __device__ inline size_t smem_floats(int K) {
  return (size_t)kChunk2 * kTileP + (size_t)kChunk2 * kRowC +
         (size_t)kTileP * kRowC + kTileC + (size_t)kTileP * (K + 1);
}

// Stage x[t0 .. t0 + 64, k0 .. k0 + DEPTH] as xs[k][p] and W[k0 .. k0 + DEPTH,
// c0 .. c0 + 128] as ws[k][c]; out-of-range entries are zero.
template <typename T, int DEPTH>
__device__ __forceinline__ void stage(const T* __restrict__ xb, long long sp,
                                      long long sk, const T* __restrict__ w,
                                      float* xs, float* ws, int t0, int p_end,
                                      int k0, int c0, int K, int C, int tid) {
  for (int i = tid; i < DEPTH * kTileP; i += kThreads) {
    int k, p;
    if (sp == 1) {
      k = i / kTileP;
      p = i % kTileP;
    } else {
      p = i / DEPTH;
      k = i % DEPTH;
    }
    const int gp = t0 + p;
    const int gk = k0 + k;
    xs[k * kTileP + p] =
        (gp < p_end && gk < K)
            ? to_f32(xb[(long long)gp * sp + (long long)gk * sk])
            : 0.0f;
  }
  for (int i = tid; i < DEPTH * kTileC; i += kThreads) {
    const int k = i / kTileC;
    const int c = i % kTileC;
    const int gk = k0 + k;
    const int gc = c0 + c;
    ws[k * kRowC + c] =
        (gk < K && gc < C) ? to_f32(w[(long long)gk * C + gc]) : 0.0f;
  }
}

// grid (nblocks), block kThreads. Block j takes the work items
// [j * items_per_block, ...) of the B * ntiles (batch row, position tile)
// pairs, writes dx of each and adds its dW into dwpart[j].
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads, 2)
    token_head_bwd_kernel(const T* __restrict__ x, long long sb, long long sp,
                          long long sk, const T* __restrict__ w,
                          const float* __restrict__ g, T* __restrict__ dx,
                          long long dsb, long long dsp, long long dsk,
                          float* __restrict__ dwpart, int B, int P, int K,
                          int C, int ntiles, int items_per_block) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                           // [kChunk2][kTileP]
  float* ws = xs + kChunk2 * kTileP;          // [kChunk2][kRowC]
  float* gs = ws + kChunk2 * kRowC;           // [kTileP][kRowC]  gact tile
  float* gsc = gs + kTileP * kRowC;           // [kTileC]  g[b, c] / P
  float* dxs = gsc + kTileC;                  // [kTileP][K + 1]  dx tile
  const int kx = K + 1;

  const int tid = threadIdx.x;
  const int tc = tid % kGroupsC;
  const int tp = tid / kGroupsC;
  const int n_ctiles = (C + kTileC - 1) / kTileC;
  const long long n_items = (long long)B * ntiles;
  const long long first = (long long)blockIdx.x * items_per_block;
  const long long last = min(n_items, first + items_per_block);
  float* mypart = dwpart + (long long)blockIdx.x * K * C;
  const float inv_p = 1.0f / (float)P;

  for (long long item = first; item < last; ++item) {
    const int b = (int)(item / ntiles);
    const int t0 = (int)(item % ntiles) * kTileP;
    const int p_end = min(P, t0 + kTileP);
    const T* xb = x + (long long)b * sb;
    const bool fresh = item == first;  // the partial holds nothing yet

    for (int i = tid; i < kTileP * kx; i += kThreads) dxs[i] = 0.0f;

    for (int ct = 0; ct < n_ctiles; ++ct) {
      const int c0 = ct * kTileC;
      __syncthreads();  // the previous tile's gact and gsc are consumed
      if (tid < kTileC) {
        gsc[tid] =
            (c0 + tid < C) ? g[(long long)b * C + c0 + tid] * inv_p : 0.0f;
      }

      // 1. s = x W for this tile, as the forward computes it
      float acc[kRegP][kRegC];
#pragma unroll
      for (int i = 0; i < kRegP; ++i)
#pragma unroll
        for (int j = 0; j < kRegC; ++j) acc[i][j] = 0.0f;
      const int k_last = ((K - 1) / kChunk2) * kChunk2;
      for (int k0 = 0; k0 < K; k0 += kChunk2) {
        __syncthreads();
        stage<T, kChunk2>(xb, sp, sk, w, xs, ws, t0, p_end, k0, c0, K, C,
                          tid);
        __syncthreads();
        const int depth = min(kChunk2, K - k0);
#pragma unroll 4
        for (int k = 0; k < depth; ++k) {
          const float4 xv =
              *reinterpret_cast<const float4*>(&xs[k * kTileP + tp * kRegP]);
          const float4 wa =
              *reinterpret_cast<const float4*>(&ws[k * kRowC + tc * kRegC]);
          const float4 wb =
              *reinterpret_cast<const float4*>(&ws[k * kRowC + tc * kRegC + 4]);
          const float xr[kRegP] = {xv.x, xv.y, xv.z, xv.w};
          const float wr[kRegC] = {wa.x, wa.y, wa.z, wa.w,
                                   wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int i = 0; i < kRegP; ++i)
#pragma unroll
            for (int j = 0; j < kRegC; ++j)
              acc[i][j] = fmaf(xr[i], wr[j], acc[i][j]);
        }
      }
      // gact, zero at padded positions and channels (gsc is zero there)
#pragma unroll
      for (int i = 0; i < kRegP; ++i) {
        const int p = tp * kRegP + i;
        const bool valid = t0 + p < p_end;
        float out[kRegC];
#pragma unroll
        for (int j = 0; j < kRegC; ++j) {
          out[j] = valid ? act_grad<ACT>(acc[i][j]) * gsc[tc * kRegC + j] : 0.0f;
        }
        float4* dst = reinterpret_cast<float4*>(&gs[p * kRowC + tc * kRegC]);
        dst[0] = make_float4(out[0], out[1], out[2], out[3]);
        dst[1] = make_float4(out[4], out[5], out[6], out[7]);
      }

      // 2. both gradient products, K staged 32 at a time, last chunk
      // first: phase 1 left it staged
      for (int k0 = k_last; k0 >= 0; k0 -= kChunk2) {
        __syncthreads();  // gact is parked; the previous chunk is consumed
        if (k0 != k_last) {
          stage<T, kChunk2>(xb, sp, sk, w, xs, ws, t0, p_end, k0, c0, K, C,
                            tid);
          __syncthreads();
        }
        {
          // dx[p, k] += sum_c gact[p, c] W[k, c]: positions p0 .. p0 + 4,
          // k's ka and ka + 16 (neighbouring lanes read neighbouring rows)
          const int ka = tid % 16;
          const int p0 = (tid / 16) * 4;
          float a[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i][0] = a[i][1] = 0.0f;
#pragma unroll 4
          for (int c = 0; c < kTileC; c += 4) {
            const float4 w0 =
                *reinterpret_cast<const float4*>(&ws[ka * kRowC + c]);
            const float4 w1 =
                *reinterpret_cast<const float4*>(&ws[(ka + 16) * kRowC + c]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 gv =
                  *reinterpret_cast<const float4*>(&gs[(p0 + i) * kRowC + c]);
              a[i][0] = fmaf(gv.x, w0.x, a[i][0]);
              a[i][0] = fmaf(gv.y, w0.y, a[i][0]);
              a[i][0] = fmaf(gv.z, w0.z, a[i][0]);
              a[i][0] = fmaf(gv.w, w0.w, a[i][0]);
              a[i][1] = fmaf(gv.x, w1.x, a[i][1]);
              a[i][1] = fmaf(gv.y, w1.y, a[i][1]);
              a[i][1] = fmaf(gv.z, w1.z, a[i][1]);
              a[i][1] = fmaf(gv.w, w1.w, a[i][1]);
            }
          }
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int gk = k0 + ka + 16 * m;
            if (gk < K) {
#pragma unroll
              for (int i = 0; i < 4; ++i) dxs[(p0 + i) * kx + gk] += a[i][m];
            }
          }
        }
        {
          // dW[k, c] += sum_p x[p, k] gact[p, c]: k's ka * 2 and ka * 2 + 1,
          // channels cg * 4 .. + 4 and 64 + cg * 4 .. + 4 (neighbouring
          // lanes read neighbouring float4s)
          const int ka = (tid / 16) * 2;
          const int cg = (tid % 16) * 4;
          // both k's are padding (at K=24 two whole warps): nothing left to do
          // in this chunk, on to the next one's barrier
          if (k0 + ka >= K) continue;
          // the sums start from the partial's values, read ahead of the
          // product so that their latency hides behind it
          float a[2][8];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int gk = k0 + ka + m;
            const float* row = mypart + (long long)gk * C + c0;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int c = cg + (j < 4 ? j : 60 + j);
              a[m][j] = (!fresh && gk < K && c0 + c < C) ? row[c] : 0.0f;
            }
          }
#pragma unroll 4
          for (int p = 0; p < kTileP; ++p) {
            const float x0 = xs[ka * kTileP + p];
            const float x1 = xs[(ka + 1) * kTileP + p];
            const float4 ga =
                *reinterpret_cast<const float4*>(&gs[p * kRowC + cg]);
            const float4 gb =
                *reinterpret_cast<const float4*>(&gs[p * kRowC + 64 + cg]);
            const float gr[8] = {ga.x, ga.y, ga.z, ga.w,
                                 gb.x, gb.y, gb.z, gb.w};
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              a[0][j] = fmaf(x0, gr[j], a[0][j]);
              a[1][j] = fmaf(x1, gr[j], a[1][j]);
            }
          }
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int gk = k0 + ka + m;
            if (gk < K) {
              float* row = mypart + (long long)gk * C + c0;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int c = cg + (j < 4 ? j : 60 + j);
                if (c0 + c < C) row[c] = a[m][j];
              }
            }
          }
        }
      }
    }

    __syncthreads();  // every channel tile is in dxs
    for (int i = tid; i < kTileP * K; i += kThreads) {
      int k, p;
      if (dsp == 1) {
        k = i / kTileP;
        p = i % kTileP;
      } else {
        p = i / K;
        k = i % K;
      }
      if (t0 + p < p_end) {
        dx[(long long)b * dsb + (long long)(t0 + p) * dsp +
           (long long)k * dsk] = from_f32<T>(dxs[p * kx + k]);
      }
    }
    __syncthreads();  // dxs is free for the next item
  }
}

// dw[i] = sum over blocks, in block order, of dwpart[j, i]
__global__ void token_head_dw_reduce_kernel(const float* __restrict__ dwpart,
                                            float* __restrict__ dw,
                                            long long n, int nblocks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int j = 0; j < nblocks; ++j) s += dwpart[(long long)j * n + i];
  dw[i] = s;
}

template <typename T, int ACT>
cudaError_t launch(const void* x, long long sb, long long sp, long long sk,
                   const void* w, const float* g, void* dx, long long dsb,
                   long long dsp, long long dsk, float* dwpart, float* dw,
                   int B, int P, int K, int C, int items_per_block,
                   int nblocks, cudaStream_t stream) {
  const size_t smem = smem_floats(K) * sizeof(float);
  auto kern = token_head_bwd_kernel<T, ACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // the refusal must not fail the next launch
    return err;
  }
  const int ntiles = (P + kTileP - 1) / kTileP;
  kern<<<nblocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), sb, sp, sk, static_cast<const T*>(w), g,
      static_cast<T*>(dx), dsb, dsp, dsk, dwpart, B, P, K, C, ntiles,
      items_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)K * C;
  const int threads = 256;
  token_head_dw_reduce_kernel<<<(unsigned)((n + threads - 1) / threads),
                                threads, 0, stream>>>(dwpart, dw, n, nblocks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_act(int act, const void* x, long long sb, long long sp,
                         long long sk, const void* w, const float* g, void* dx,
                         long long dsb, long long dsp, long long dsk,
                         float* dwpart, float* dw, int B, int P, int K, int C,
                         int items_per_block, int nblocks,
                         cudaStream_t stream) {
  switch (act) {
    case kSerf:
      return launch<T, kSerf>(x, sb, sp, sk, w, g, dx, dsb, dsp, dsk, dwpart,
                              dw, B, P, K, C, items_per_block, nblocks, stream);
    case kSerfFast:
      return launch<T, kSerfFast>(x, sb, sp, sk, w, g, dx, dsb, dsp, dsk,
                                  dwpart, dw, B, P, K, C, items_per_block,
                                  nblocks, stream);
    case kRelu:
      return launch<T, kRelu>(x, sb, sp, sk, w, g, dx, dsb, dsp, dsk, dwpart,
                              dw, B, P, K, C, items_per_block, nblocks, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace k1bwd
}  // namespace mmvqa

// x, dx: (B, P, K) by element strides, x's dtype; w: (K, C) contiguous, x's
// dtype; g: (B, C) fp32 contiguous, the gradient of the output; dwpart:
// (nblocks, K, C) fp32 scratch; dw: (K, C) fp32 out. nblocks * items_per_block
// must cover the B * ceil(P / 64) work items with no block left empty
// (ops/token_head.py::backward_plan).
extern "C" int token_head_bwd(const void* x, int dtype, long long sb,
                              long long sp, long long sk, const void* w,
                              const void* g, void* dx, long long dsb,
                              long long dsp, long long dsk, void* dwpart,
                              void* dw, int B, int P, int K, int C, int act,
                              int items_per_block, int nblocks, void* stream) {
  using namespace mmvqa;
  auto s = static_cast<cudaStream_t>(stream);
  auto gp = static_cast<const float*>(g);
  auto part = static_cast<float*>(dwpart);
  auto dwp = static_cast<float*>(dw);
  cudaError_t err;
  if (dtype == kFloat32) {
    err = k1bwd::dispatch_act<float>(act, x, sb, sp, sk, w, gp, dx, dsb, dsp,
                                     dsk, part, dwp, B, P, K, C,
                                     items_per_block, nblocks, s);
  } else if (dtype == kBFloat16) {
    err = k1bwd::dispatch_act<__nv_bfloat16>(act, x, sb, sp, sk, w, gp, dx,
                                             dsb, dsp, dsk, part, dwp, B, P, K,
                                             C, items_per_block, nblocks, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
