// K4: a 1x1 convolution with the BatchNorm statistics of its output,
//   y = x @ W           (N, K) @ (K, C), fp32 accumulate, stored in x's dtype
//   stats[0, c] = sum_n y[n, c],  stats[1, c] = sum_n y[n, c]^2
// with both sums taken from the fp32 accumulator, before y is rounded, in
// the same pass that writes y.
//
// Replaces the TPU kernel mmvqa_tpu/ops/pallas_conv_bn.py::conv1x1_stats
// (_fwd_kernel / _fwd_call, pallas_call at :81).
//
// Layout: as the TPU kernel, x is the channels-last map flattened to rows,
// (N, K) with K the unit-stride axis, and y is (N, C). W is read by strides:
// the trunk hands over the convolution's (C, K) weight as its (K, C) view,
// whose unit stride on K is what the tensor-core path wants for its "col"
// operand; a dense (K, C) goes in as well.
//
// What bounds it on an H100: at the MBConv sites (K and C from 160 to 3072)
// operations, at the FusedMBConv sites (N = 401408, C = 48) bytes. So the
// bf16 path is a tensor-core product: a block owns 128 rows and 128 (or 64)
// columns, K is staged 32 deep through shared memory (rows padded to 40
// halves, which makes every fragment load conflict-free) with the next
// stage's loads in flight during the products, and each of 8 warps issues
// mma.sync.m16n8k16 on a 32 x 64 (32 x 32) tile with fp32 accumulators. The
// fp32 path is a register-tiled product on CUDA cores in full fp32, never
// TF32: it is the path held against the CPU. K and C are ragged against the
// tiles (176, 304, 1056, 1824): edges are zero-filled on the way into shared
// memory and masked on the way out, and zero rows add nothing to the sums.
//
// The sums cross blocks (the TPU kernel carries them in scratch over a
// sequential grid). A block walks over several row tiles and keeps the sums
// of its columns: each thread adds its accumulators' columns, the rows of
// a warp are added by shuffles and the warps in shared memory, all in a
// fixed order; the block writes one (2, C) fp32 partial and a second kernel
// adds the partials in block order. No float atomics: two runs give
// identical bits.
#include <cstdint>

#include "common.cuh"

namespace mmvqa {
namespace k4 {

constexpr int kThreads = 256;

// ------------------------------------------------------------------ bf16 ----
constexpr int kBM = 128;        // rows per tile
constexpr int kBK = 32;         // contraction depth per stage
constexpr int kRow = kBK + 8;   // shared-memory row in halves: 20 words, so the
                                // 8 x 4 lanes of a fragment load hit 32 banks
constexpr int kWarpsM = 4;      // warps along the rows, 32 rows each

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight bf16 values of one row, k0 + kc .. + 7, as one 16-byte word. `fast`
// says that the row's start and stride are multiples of 8 elements and the
// axis has unit stride, so that an aligned vector load serves; otherwise the
// values are read one by one by their stride. Outside the matrix: zeros.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ row,
                                       bool row_ok, int k, int K, long long sk,
                                       bool fast) {
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (!row_ok || k >= K) return out;
  if (fast) return *reinterpret_cast<const uint4*>(row + k);
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = (k + i < K) ? row[(long long)(k + i) * sk] : __float2bfloat16(0.0f);
  return *reinterpret_cast<const uint4*>(v);
}

// grid (ceil(C / BN), nrb), block 256. NT: n8 tiles per warp; BN = 16 * NT.
template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
    conv1x1_stats_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                              const __nv_bfloat16* __restrict__ w,
                              long long swk, long long swc,
                              __nv_bfloat16* __restrict__ y,
                              float* __restrict__ partial, int N, int K, int C,
                              int mtiles, int fast_x, int fast_w) {
  constexpr int BN = 16 * NT;
  constexpr int kAChunks = kBM * kBK / 8 / kThreads;  // 2
  constexpr int kBChunks = (BN * kBK / 8 + kThreads - 1) / kThreads;
  __shared__ __align__(16) __nv_bfloat16 As[kBM][kRow];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][kRow];
  __shared__ float red[kWarpsM][2][BN];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % kWarpsM;   // rows wm * 32 ..
  const int wn = warp / kWarpsM;   // columns wn * 8 * NT ..
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int c0 = blockIdx.x * BN;

  for (int i = tid; i < kWarpsM * 2 * BN; i += kThreads)
    (&red[0][0][0])[i] = 0.0f;

  uint4 pa[kAChunks], pb[kBChunks];
  auto fetch = [&](int m0, int k0) {
#pragma unroll
    for (int j = 0; j < kAChunks; ++j) {
      const int i = tid + j * kThreads;
      const int row = m0 + i / 4;
      pa[j] = load8(x + (long long)row * K, row < N, k0 + (i % 4) * 8, K, 1,
                    fast_x);
    }
#pragma unroll
    for (int j = 0; j < kBChunks; ++j) {
      const int i = tid + j * kThreads;
      const int n = c0 + i / 4;
      pb[j] = load8(w + (long long)n * swc, i < BN * 4 && n < C,
                    k0 + (i % 4) * 8, K, swk, fast_w);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int j = 0; j < kAChunks; ++j) {
      const int i = tid + j * kThreads;
      *reinterpret_cast<uint4*>(&As[i / 4][(i % 4) * 8]) = pa[j];
    }
#pragma unroll
    for (int j = 0; j < kBChunks; ++j) {
      const int i = tid + j * kThreads;
      if (i < BN * 4) *reinterpret_cast<uint4*>(&Bs[i / 4][(i % 4) * 8]) = pb[j];
    }
  };

  for (int mt = blockIdx.y; mt < mtiles; mt += gridDim.y) {
    const int m0 = mt * kBM;
    float acc[2][NT][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;

    fetch(m0, 0);
    for (int k0 = 0; k0 < K; k0 += kBK) {
      __syncthreads();  // the previous stage is consumed
      stage();
      __syncthreads();
      if (k0 + kBK < K) fetch(m0, k0 + kBK);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm * 32 + mi * 16 + g;
          a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * t4]);
          a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * t4]);
          a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * t4 + 8]);
          a[mi][3] =
              *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * t4 + 8]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = wn * 8 * NT + j * 8;
          if (c0 + n >= C) continue;  // a tile wholly beyond the last column
          const uint32_t b0 =
              *reinterpret_cast<const uint32_t*>(&Bs[n + g][kk + 2 * t4]);
          const uint32_t b1 =
              *reinterpret_cast<const uint32_t*>(&Bs[n + g][kk + 2 * t4 + 8]);
          mma_16816(acc[0][j], a[0], b0, b1);
          mma_16816(acc[1][j], a[1], b0, b1);
        }
      }
    }

    // y, and this tile's column sums. acc[mi][j] holds rows g and g + 8 of
    // its 16 x 8 tile at columns 2 * t4 and 2 * t4 + 1.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = wn * 8 * NT + j * 8 + 2 * t4;
      const int col = c0 + n;
      float s[2] = {0.0f, 0.0f}, q[2] = {0.0f, 0.0f};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float v0 = acc[mi][j][2 * hh], v1 = acc[mi][j][2 * hh + 1];
          s[0] += v0;
          s[1] += v1;
          q[0] = fmaf(v0, v0, q[0]);
          q[1] = fmaf(v1, v1, q[1]);
          const int row = m0 + wm * 32 + mi * 16 + hh * 8 + g;
          if (row < N && col < C) {
            __nv_bfloat16* dst = y + (long long)row * C + col;
            if (col + 1 < C && (C % 2 == 0)) {
              *reinterpret_cast<__nv_bfloat162*>(dst) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              dst[0] = __float2bfloat16(v0);
              if (col + 1 < C) dst[1] = __float2bfloat16(v1);
            }
          }
        }
      // the 8 row lanes (g) that share these two columns
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off *= 2) {
          s[e] += __shfl_xor_sync(0xffffffffu, s[e], off);
          q[e] += __shfl_xor_sync(0xffffffffu, q[e], off);
        }
        if (g == 0) {  // this lane alone owns red[wm][.][n + e]
          red[wm][0][n + e] += s[e];
          red[wm][1][n + e] += q[e];
        }
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < 2 * BN; i += kThreads) {
    const int which = i / BN, n = i % BN;
    if (c0 + n >= C) continue;
    float s = 0.0f;
#pragma unroll
    for (int m = 0; m < kWarpsM; ++m) s += red[m][which][n];
    partial[((long long)blockIdx.y * 2 + which) * C + c0 + n] = s;
  }
}

// ------------------------------------------------------------------ fp32 ----
constexpr int kFM = 64, kFN = 64, kFK = 16;  // tile; 16 x 16 threads, 4 x 4 each

__global__ void __launch_bounds__(kThreads)
    conv1x1_stats_fma_kernel(const float* __restrict__ x,
                             const float* __restrict__ w, long long swk,
                             long long swc, float* __restrict__ y,
                             float* __restrict__ partial, int N, int K, int C,
                             int mtiles) {
  __shared__ __align__(16) float As[kFK][kFM + 4];  // [k][row]
  __shared__ __align__(16) float Bs[kFK][kFN];      // [k][column]
  __shared__ float red[16][2][kFN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns 4 * tx ..
  const int ty = tid / 16;  // rows 4 * ty ..
  const int c0 = blockIdx.x * kFN;

  float cs[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cq[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int mt = blockIdx.y; mt < mtiles; mt += gridDim.y) {
    const int m0 = mt * kFM;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += kFK) {
      __syncthreads();
      for (int i = tid; i < kFM * kFK; i += kThreads) {
        const int row = i / kFK, k = i % kFK;  // K is x's unit-stride axis
        As[k][row] = (m0 + row < N && k0 + k < K)
                         ? x[(long long)(m0 + row) * K + k0 + k]
                         : 0.0f;
      }
      for (int i = tid; i < kFN * kFK; i += kThreads) {
        int k, n;
        if (swc == 1) {
          k = i / kFN;
          n = i % kFN;
        } else {
          n = i / kFK;
          k = i % kFK;
        }
        Bs[k][n] = (c0 + n < C && k0 + k < K)
                       ? w[(long long)(k0 + k) * swk + (long long)(c0 + n) * swc]
                       : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kFK; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(&As[k][4 * ty]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][4 * tx]);
        const float a[4] = {av.x, av.y, av.z, av.w};
        const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + 4 * tx + j;
        cs[j] += acc[i][j];
        cq[j] = fmaf(acc[i][j], acc[i][j], cq[j]);
        if (row < N && col < C)
          y[(long long)row * C + col] = acc[i][j];
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[ty][0][4 * tx + j] = cs[j];
    red[ty][1][4 * tx + j] = cq[j];
  }
  __syncthreads();
  for (int i = tid; i < 2 * kFN; i += kThreads) {
    const int which = i / kFN, n = i % kFN;
    if (c0 + n >= C) continue;
    float s = 0.0f;
#pragma unroll
    for (int m = 0; m < 16; ++m) s += red[m][which][n];
    partial[((long long)blockIdx.y * 2 + which) * C + c0 + n] = s;
  }
}

__global__ void conv1x1_stats_reduce_kernel(const float* __restrict__ part,
                                            float* __restrict__ out,
                                            long long n, int nparts) {
  sum_partials(part, out, n, nparts);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace k4
}  // namespace mmvqa

// x: (N, K) dense; w: (K, C) by element strides (swk, swc); y: (N, C) dense;
// all of one dtype. partial: (nrb, 2, C) fp32 scratch; stats: (2, C) fp32 out.
// nrb blocks along the rows share the ceil(N / tile_m) row tiles, tile_m 128
// for bf16 and 64 for fp32 (ops/conv_bn.py::launch_plan); nrb <= that count.
extern "C" int conv1x1_stats(const void* x, int dtype, const void* w,
                             long long swk, long long swc, void* y,
                             void* partial, void* stats, int N, int K, int C,
                             int nrb, void* stream) {
  using namespace mmvqa;
  using namespace mmvqa::k4;
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partial);
  if (dtype == kFloat32) {
    const int mtiles = (N + kFM - 1) / kFM;
    const dim3 grid((C + kFN - 1) / kFN, nrb);
    conv1x1_stats_fma_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), swk, swc,
        static_cast<float*>(y), part, N, K, C, mtiles);
  } else if (dtype == kBFloat16) {
    auto xp = static_cast<const __nv_bfloat16*>(x);
    auto wp = static_cast<const __nv_bfloat16*>(w);
    auto yp = static_cast<__nv_bfloat16*>(y);
    const int mtiles = (N + kBM - 1) / kBM;
    const int fast_x = K % 8 == 0 && aligned16(x);
    const int fast_w =
        swk == 1 && K % 8 == 0 && swc % 8 == 0 && aligned16(w);
    if (C <= 64) {
      const dim3 grid((C + 63) / 64, nrb);
      conv1x1_stats_bf16_kernel<4><<<grid, kThreads, 0, s>>>(
          xp, wp, swk, swc, yp, part, N, K, C, mtiles, fast_x, fast_w);
    } else {
      const dim3 grid((C + 127) / 128, nrb);
      conv1x1_stats_bf16_kernel<8><<<grid, kThreads, 0, s>>>(
          xp, wp, swk, swc, yp, part, N, K, C, mtiles, fast_x, fast_w);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = 2LL * C;
  conv1x1_stats_reduce_kernel<<<reduce_blocks(n), kReduceThreads, 0, s>>>(
      part, static_cast<float*>(stats), n, nrb);
  return static_cast<int>(cudaGetLastError());
}
