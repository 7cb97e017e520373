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
// K-major, which is what both tensor-core paths want for their B operand.
//
// What bounds it on an H100: in bf16, bytes at 15 of the flagship trunk's 18
// site shapes (32-250 operations a byte against the card's 295), operations
// at the three with K or C of 1824 and 3072. In fp32, with the products as
// three TF32 products on the tensor cores (165 TFLOP/s of fp32 products,
// csrc/tf32x3.cuh), operations at 13 of the 18 shapes and bytes at the five
// with C of 48 and 80 (the bound of all 98 sites at B=128: 5.36 ms, 4.56 of
// it at sites held by operations).
//
// bf16, TMA + wgmma (conv1x1_stats_tma_kernel; x dense with K % 8 = 0, W a
// K-major view with its row stride a multiple of 8, C % 8 = 0, 16-byte
// aligned bases: every site of the trunk). Persistent blocks, one an SM, each
// owning a column tile of BN channels (64, 128 or 192: C <= 192 in one tile,
// so that x is read once) and walking every nrb-th 192-row tile. One
// producer thread feeds a ring of 4-6 stages through the Tensor Memory
// Accelerator: a stage is a 192 x 64 box of x and a BN x 64 box of W,
// 128-byte swizzled, K zero-filled past its end and rows past N too (zero
// rows add nothing to the sums), full and empty mbarriers a stage. Three
// consumer warpgroups (setmaxnreg gives them the registers) each issue
// wgmma.mma_async.m64nBNk16 on their 64 rows, A and B from shared memory,
// keeping one k-step's group in flight. The loads hold the kernel at most
// shapes (tools/probe_conv_bn.py): W's box is staged again for every row
// tile, so the rows a tile takes (three warpgroups' worth, not two) set how
// often. The epilogue of a tile runs while the producer loads the next
// tile's stages: the sums and the sums of squares of each column from the
// fp32 accumulators, added over the 8 row lanes by a reduce-scatter of
// shuffles and kept in registers across the block's tiles; y rounded to
// bf16, staged per warp in 16 x 64 swizzled boxes and stored by TMA. At the
// end the 12 warps' sums are added in order into the block's (2, BN)
// partial, and the last block of each column tile (an atomicInc counter
// that wraps to 0, one buffer a stream) adds the partials in block order:
// one launch, no float atomics, two runs give identical bits.
//
// bf16, other shapes (conv1x1_stats_bf16_kernel): a block owns 128 rows and
// 128 (or 64) columns, K staged 32 deep through shared memory by register
// loads (rows padded to 40 halves), each of 8 warps issuing
// mma.sync.m16n8k16 on a 32 x 64 (32 x 32) tile; a path chosen by shape,
// as K3's element copies are. It walks several row tiles a block, keeps its
// columns' sums, writes one (2, C) partial a block, and a second kernel adds
// the partials in block order.
//
// fp32, every shape (conv1x1_stats_tf32x3_kernel): fp32 accuracy from three
// TF32 products a product on mma.sync (csrc/tf32x3.cuh: the split in
// registers, fragments by ldmatrix from 128-byte rows swizzled against bank
// conflicts). A block of 256 threads (8 warps, 2 x 4) owns a (BM, BN) tile
// of 128 or 64 each, x and W staged 32 deep through a three-stage cp.async
// ring (16-byte copies where the rows allow, element copies by W's strides
// otherwise, zeros past N, K and C), two blocks an SM. Below 128 x 128 the
// tensor cores sum a whole chunk before each fp32 add. The blocks walk row
// tiles as the other kernels do and keep their columns' sums in registers;
// the last block of a column tile adds the partials in block order (one
// launch, no float atomics). The tile, the blocks along the rows and the
// slices of K come from a model of the busiest SM's time read off the card
// (ops/conv_bn.py::tf32_plan). At the 7x7 sites of B=16 (N = 784, the
// CLI's batch) the tiles are fewer than the SMs and K is deep: K is cut
// into 2-4 slices, one a block, each writing its tile's sums to scratch,
// and the last of a tile's slices adds them in order before y and the
// column sums are taken. It reaches well under half of its bound at every
// site shape, held by the split's instructions and the chains of dependent
// products more than by the tensor cores (PERF.md §6 has the shares).
#include <cuda.h>

#include <cstdint>

#include "common.cuh"
#include "tf32x3.cuh"

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
namespace f32 {

constexpr int kStages = 3;  // of the ring: two (BM + BN) x 32 chunks ahead

// Dynamic shared memory of a (bm, bn) tile: the ring; at the end the warps'
// column sums reuse it.
__host__ __device__ inline int smem_bytes(int bm, int bn) {
  return 4 * kStages * (bm + bn) * tf32::kChunk;
}

// grid (ceil(C / BN), nrb), block 256, two blocks an SM. The tensor cores
// sum a whole 32-deep chunk before the fp32 add (tf32::product's CHUNK)
// where the accumulators leave the registers for it, below 128 x 128.
// Block (ct, r) owns columns
// [ct * BN, + BN) of the row tiles r, r + nrb, ... and writes their column
// sums as its (2, BN) partial; rows past N are zeros and add nothing. The
// last block of a column tile (an atomicInc counter that wraps to 0, one
// buffer a stream) adds the partials in block order: one launch.
// With ks > 1 (few tiles and a deep K: the 7x7 sites at B=16) the grid is
// (ceil(C / BN), row tiles, ks) and block (ct, mt, z) sums the z-th of ks
// slices of K (kseg deep, whole chunks) into ypart[z]; the last of a tile's
// ks blocks (a counter a tile) adds the slices in z order into y and takes
// the tile's column sums, which the column tile's last tile adds as above.
template <int BM, int BN>
__global__ void __launch_bounds__(tf32::kThreads, 2)
    conv1x1_stats_tf32x3_kernel(tf32::Dense xs, tf32::Dense ws,
                                float* __restrict__ y,
                                float* __restrict__ part,
                                float* __restrict__ stats,
                                unsigned* __restrict__ counter,
                                float* __restrict__ ypart, int N, int K,
                                int C, int mtiles, int kseg) {
  extern __shared__ __align__(16) float ring[];
  __shared__ int last;
  const int ks = gridDim.z, z = blockIdx.z;
  constexpr int MI = BM / 32, NI = BN / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = (warp / 4) * (BM / 2), wn = (warp % 4) * (BN / 4);
  const int c0 = blockIdx.x * BN;
  const bool pairs = C % 2 == 0;
  float cs[NI][2], cq[NI][2];
#pragma unroll
  for (int j = 0; j < NI; ++j)
    cs[j][0] = cs[j][1] = cq[j][0] = cq[j][1] = 0.0f;

  for (int mt = blockIdx.y; mt < mtiles; mt += gridDim.y) {
    const int m0 = mt * BM;
    float acc[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    tf32::product<BM, BN, kStages, tf32::kOuterRows, tf32::kOuterRows, 1,
                  BM * BN < 128 * 128>(
        acc, ring, xs, m0, z * kseg, ws, c0, z * kseg,
        min(kseg, K - z * kseg));
    if (ks > 1) {
      // this slice's sums to ypart[z]; the tile's last slice adds them all,
      // in z order, in place of acc
      float* mine = ypart + (long long)z * N * C;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = m0 + wm + i * 16 + (e / 2) * 8 + g;
            const int col = c0 + wn + j * 8 + 2 * q + e % 2;
            if (row < N && col < C) mine[(long long)row * C + col] = acc[i][j][e];
          }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0)
        last = atomicInc(&counter[gridDim.x + mt * gridDim.x + blockIdx.x],
                         ks - 1) == ks - 1;
      __syncthreads();
      if (!last) return;
      __threadfence();
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = m0 + wm + i * 16 + (e / 2) * 8 + g;
            const int col = c0 + wn + j * 8 + 2 * q + e % 2;
            float v = 0.0f;
            if (row < N && col < C)
              for (int r = 0; r < ks; ++r)
                v += __ldcg(&ypart[((long long)r * N + row) * C + col]);
            acc[i][j][e] = v;
          }
    }
    // y, and the sums of this thread's columns over its rows
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
          cs[j][0] += v0;
          cs[j][1] += v1;
          cq[j][0] = fmaf(v0, v0, cq[j][0]);
          cq[j][1] = fmaf(v1, v1, cq[j][1]);
          const int row = m0 + wm + i * 16 + h * 8 + g;
          const int col = c0 + wn + j * 8 + 2 * q;
          if (row < N && col < C) {
            float* dst = y + (long long)row * C + col;
            if (pairs) {
              *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
            } else {
              dst[0] = v0;
              if (col + 1 < C) dst[1] = v1;
            }
          }
        }
  }

  // the 8 row lanes that share a column, then the two warp rows in order
  // (the ring is free: the last product ended with a barrier)
  float* red = ring;  // [warp row][stat][BN]
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        cs[j][e] += __shfl_xor_sync(0xffffffffu, cs[j][e], off);
        cq[j][e] += __shfl_xor_sync(0xffffffffu, cq[j][e], off);
      }
      if (g == 0) {
        const int n = wn + j * 8 + 2 * q + e;
        red[((warp / 4) * 2 + 0) * BN + n] = cs[j][e];
        red[((warp / 4) * 2 + 1) * BN + n] = cq[j][e];
      }
    }
  __syncthreads();
  const long long cpad = (long long)gridDim.x * BN;
  for (int i = threadIdx.x; i < 2 * BN; i += tf32::kThreads) {
    const int stat = i / BN, n = i % BN;
    part[((long long)blockIdx.y * 2 + stat) * cpad + c0 + n] =
        red[stat * BN + n] + red[(2 + stat) * BN + n];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicInc(&counter[blockIdx.x], gridDim.y - 1) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < 2 * BN; i += tf32::kThreads) {
    const int stat = i / BN, n = i % BN;
    if (c0 + n >= C) continue;
    float sum = 0.0f;
    for (int r = 0; r < (int)gridDim.y; ++r)
      sum += __ldcg(&part[((long long)r * 2 + stat) * cpad + c0 + n]);
    stats[(long long)stat * C + c0 + n] = sum;
  }
}

// The shared memory each tile's kernel may use, asked for once (an array of
// this file: see tma_granted below)
static int granted[4];

template <int BM, int BN>
cudaError_t launch(const tf32::Dense& xs, const tf32::Dense& ws, float* y,
                   float* part, float* stats, unsigned* counter,
                   float* ypart, int N, int K, int C, int nrb, int ks,
                   int smem, int slot, cudaStream_t s) {
  auto kern = conv1x1_stats_tf32x3_kernel<BM, BN>;
  if (smem > granted[slot]) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
    granted[slot] = smem;
  }
  // K's slices in whole chunks
  const int kseg = ((K + ks - 1) / ks + tf32::kChunk - 1) / tf32::kChunk *
                   tf32::kChunk;
  kern<<<dim3((C + BN - 1) / BN, nrb, ks), tf32::kThreads, smem, s>>>(
      xs, ws, y, part, stats, counter, ypart, N, K, C, (N + BM - 1) / BM,
      kseg);
  return cudaGetLastError();
}

}  // namespace f32

__global__ void conv1x1_stats_reduce_kernel(const float* __restrict__ part,
                                            float* __restrict__ out,
                                            long long n, int nparts) {
  sum_partials(part, out, n, nparts);
}


// -------------------------------------------------- bf16: TMA and wgmma ----
namespace tma {

constexpr int kConsumerGroups = 3;     // consumer warpgroups, 64 rows each
constexpr int kBM = 64 * kConsumerGroups;  // rows of a tile
constexpr int kBK = 64;                // k's of a stage: a 128-byte row
constexpr int kConsumerThreads = 128 * kConsumerGroups;
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kThreads = 128 + kConsumerThreads;  // and the producer's
// registers a thread of the producer warpgroup and of a consumer one, all
// of the SM's 65536 between them: a consumer holds BN / 2 accumulators
constexpr int kProducerRegs = 24, kConsumerRegs = 160;
static_assert(128 * kProducerRegs + kConsumerThreads * kConsumerRegs <= 65536,
              "registers");
constexpr int kYBox = 64;              // columns of a y store box: 128 bytes
constexpr int kTileBytesA = kBM * kBK * 2;
constexpr int kYWarpBytes = 16 * kYBox * 2;  // a warp's y box

// Shared memory from a 1024-byte boundary (what the 128-byte swizzle's atoms
// need): the ring's stages (x box, W box), a y box a consumer warp, full and
// empty mbarriers a stage, the last-block flag; and 1024 bytes to find the
// boundary in. At the end the ring holds the warps' (2, BN) sums.
__host__ __device__ inline int smem_bytes(int bn, int stages) {
  return 1024 + stages * (kTileBytesA + bn * kBK * 2) +
         kConsumerWarps * kYWarpBytes + 2 * stages * 8 + 16;
}

// the wgmma descriptor of a K-major tile of 64-k rows (128 bytes each),
// 128-byte swizzle: start address, leading byte offset 16 (unused by this
// layout), 1024 bytes between groups of eight rows
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses of the accumulators across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n"
      " setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n"
      " setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n"
      " setp.ne.b32 p, %98, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da,
                                      uint64_t db, int scale_d) {
  if constexpr (BN == 64) wgmma_n64(d, da, db, scale_d);
  else if constexpr (BN == 128) wgmma_n128(d, da, db, scale_d);
  else wgmma_n192(d, da, db, scale_d);
}

__device__ __forceinline__ void expect_tx(uint64_t* bar,
                                          unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map,
                                         int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void store_box(const CUtensorMap* map, int c0,
                                          int c1, const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%1, %2}], [%3];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(smem_u32(src))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the y box's shared memory may be written again / every store is done
__device__ __forceinline__ void stores_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void stores_done() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// One step of a reduce-scatter over the lanes `bit` apart: each keeps the
// half of v[0, 2H) its bit selects, with its partner's copy added, in v[0, H).
template <int H>
__device__ __forceinline__ void halve(float* v, int lane, int bit) {
  const bool up = lane & bit;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
  }
}

__device__ __forceinline__ void named_sync() {  // the consumer warpgroups
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumerThreads) : "memory");
}

// grid (ceil(C / BN), nrb), block kThreads, one block an SM. Block (ct, r)
// owns columns [ct * BN, + BN) of the row tiles r, r + nrb, ...
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    conv1x1_stats_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                             const __grid_constant__ CUtensorMap map_w,
                             const __grid_constant__ CUtensorMap map_y,
                             float* __restrict__ part,
                             float* __restrict__ stats,
                             unsigned* __restrict__ counter, int N, int K,
                             int C, int stages) {
  constexpr int kTileBytesB = BN * kBK * 2;
  constexpr int R = BN / 2;  // accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  unsigned char* ring = base;
  unsigned char* ybox = ring + stages * (kTileBytesA + kTileBytesB);
  auto* full = reinterpret_cast<uint64_t*>(
      ybox + kConsumerWarps * kYWarpBytes);
  auto* empty = full + stages;
  int* flag = reinterpret_cast<int*>(empty + stages);

  const int ct = blockIdx.x, nrb = gridDim.y;
  const int c0 = ct * BN;
  const int mtiles = (N + kBM - 1) / kBM;
  const int nkb = (K + kBK - 1) / kBK;
  auto tile_a = [&](int s) { return ring + s * (kTileBytesA + kTileBytesB); };
  auto tile_b = [&](int s) { return tile_a(s) + kTileBytesA; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- the producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int i = 0;
      for (int m = blockIdx.y; m < mtiles; m += nrb) {
        for (int kb = 0; kb < nkb; ++kb, ++i) {
          const int s = i % stages;
          if (i >= stages) mbar_wait(&empty[s], (i / stages - 1) & 1);
          expect_tx(&full[s], kTileBytesA + kTileBytesB);
          load_box(tile_a(s), &map_x, kb * kBK, m * kBM, &full[s]);
          load_box(tile_b(s), &map_w, kb * kBK, c0, &full[s]);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroups, 64 rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int ctid = threadIdx.x - 128;
  const int group = ctid / 128;            // rows [64 group, + 64) of a tile
  const int cwarp = ctid / 32;
  const int lane = ctid % 32;
  const int lr = lane / 4, lc = (lane % 4) * 2;
  const int g = lane / 4;                  // the reduce-scatter's slice
  unsigned char* mybox = ybox + cwarp * kYWarpBytes;
  // the running sums of this lane's slice of each 64 columns, across the
  // block's tiles: values g * 4 .. g * 4 + 3 of the slice's 32 (below)
  float run[BN / 64][4];
#pragma unroll
  for (int q = 0; q < BN / 64; ++q)
#pragma unroll
    for (int k = 0; k < 4; ++k) run[q][k] = 0.0f;

  int i = 0;
  for (int m = blockIdx.y; m < mtiles; m += nrb) {
    float acc[R];
    for (int kb = 0; kb < nkb; ++kb, ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      const uint32_t a = smem_u32(tile_a(s)) + group * 64 * 128;
      const uint32_t b = smem_u32(tile_b(s));
      fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks)
        wgmma<BN>(acc, desc(a + ks * 32), desc(b + ks * 32), kb + ks > 0);
      commit();
      if (kb > 0) {  // the previous stage's products are done
        wait<1>();
        mbar_arrive(&empty[(i - 1) % stages]);
      }
    }
    wait<0>();
    fence_operands(acc);
    mbar_arrive(&empty[(i - 1) % stages]);

    // ---- the epilogue, 64 columns at a time: the column sums of the warp's
    // 16 rows into its running sums, then y through its box
    const int row0 = m * kBM + group * 64 + (cwarp % 4) * 16;
#pragma unroll
    for (int q = 0; q < BN / 64; ++q) {
      // v[stat * 16 + jj * 2 + e]: column q * 64 + jj * 8 + lc + e
      float v[32];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y0 = acc[(q * 8 + jj) * 4 + e];
          const float y1 = acc[(q * 8 + jj) * 4 + 2 + e];
          v[jj * 2 + e] = y0 + y1;
          v[16 + jj * 2 + e] = fmaf(y0, y0, y1 * y1);
        }
      halve<16>(v, lane, 16);
      halve<8>(v, lane, 8);
      halve<4>(v, lane, 4);
      // v[0, 4) is slice g: values g * 4 .. g * 4 + 3 of the 32
#pragma unroll
      for (int k = 0; k < 4; ++k) run[q][k] += v[k];

      if (lane == 0) stores_read();  // the box's previous store has read it
      __syncwarp();
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lr + 8 * h;  // swizzled: 16-byte chunk jj ^ (r % 8)
          *reinterpret_cast<__nv_bfloat162*>(
              mybox + r * 128 + ((jj ^ (r % 8)) << 4) + lc * 2) =
              __floats2bfloat162_rn(acc[(q * 8 + jj) * 4 + 2 * h],
                                    acc[(q * 8 + jj) * 4 + 2 * h + 1]);
        }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) store_box(&map_y, c0 + q * kYBox, row0, mybox);
    }
  }
  if (lane == 0) stores_done();

  // ---- the block's partial: the warps' sums, parked in the ring (every
  // load has been consumed), added in warp order; then the last block of
  // this column tile adds the partials in block order
  float* red = reinterpret_cast<float*>(ring);  // [warp][2][BN]
  named_sync();  // every warpgroup's products have read the ring
#pragma unroll
  for (int q = 0; q < BN / 64; ++q)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int o = g * 4 + k;
      const int stat = o / 16, jj = (o % 16) / 2, e = o % 2;
      red[(cwarp * 2 + stat) * BN + q * 64 + jj * 8 + lc + e] = run[q][k];
    }
  named_sync();
  const long long cpad = (long long)gridDim.x * BN;
  for (int j = ctid; j < 2 * BN; j += kConsumerThreads) {
    const int stat = j / BN, c = j % BN;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) s += red[(w * 2 + stat) * BN + c];
    part[((long long)blockIdx.y * 2 + stat) * cpad + c0 + c] = s;
  }
  __threadfence();
  named_sync();
  if (ctid == 0)
    *flag = atomicInc(&counter[ct], (unsigned)(nrb - 1)) == (unsigned)(nrb - 1);
  named_sync();
  if (!*flag) return;
  __threadfence();
  for (int j = ctid; j < 2 * BN; j += kConsumerThreads) {
    const int stat = j / BN, c = j % BN;
    if (c0 + c >= C) continue;
    float s = 0.0f;
    for (int r = 0; r < nrb; ++r)
      s += __ldcg(&part[((long long)r * 2 + stat) * cpad + c0 + c]);
    stats[(long long)stat * C + c0 + c] = s;
  }
}

// A 2-D tensor map of a bf16 (rows, cols) matrix, cols the unit-stride
// axis, rows `row_stride` elements apart, for boxes of (box_cols, box_rows),
// 128-byte swizzle, zeros outside. False where the encoder refuses it.
inline bool encode(CUtensorMap* map, const void* p, uint64_t cols,
                   uint64_t rows, uint64_t row_stride, uint32_t box_cols,
                   uint32_t box_rows) {
  const EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_stride * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t ones[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The shared memory each column tile's kernel may use, asked for once: an
// array of this file alone, so that copies of the library loaded side by
// side (tools/probe_conv_bn.py) each ask for their own.
static int tma_granted[3];

template <int BN>
cudaError_t launch(const CUtensorMap& mx, const CUtensorMap& mw,
                   const CUtensorMap& my, float* part, float* stats,
                   unsigned* counter, int N, int K, int C, int stages, int nrb,
                   int smem, cudaStream_t s) {
  auto kern = conv1x1_stats_tma_kernel<BN>;
  int& granted = tma_granted[BN / 64 - 1];
  if (smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
    granted = smem;
  }
  kern<<<dim3((C + BN - 1) / BN, nrb), kThreads, smem, s>>>(
      mx, mw, my, part, stats, counter, N, K, C, stages);
  return cudaGetLastError();
}

}  // namespace tma

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace k4
}  // namespace mmvqa

// bf16 shapes the TMA path does not take: x (N, K) dense; w (K, C) by
// element strides (swk, swc); y (N, C) dense; all bf16. partial: (nrb, 2, C)
// fp32 scratch; stats: (2, C) fp32 out. nrb blocks along the rows share the
// ceil(N / 128) row tiles (ops/conv_bn.py::launch_plan); nrb <= that count.
extern "C" int conv1x1_stats(const void* x, int dtype, const void* w,
                             long long swk, long long swc, void* y,
                             void* partial, void* stats, int N, int K, int C,
                             int nrb, void* stream) {
  using namespace mmvqa;
  using namespace mmvqa::k4;
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partial);
  if (dtype == kBFloat16) {
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

// fp32, split-TF32 products: x (N, K) dense; w (K, C) by element strides
// (swk, swc); y (N, C) dense. part: (nrb, 2, ceil(C / bn) * bn) fp32
// scratch; stats: (2, C) fp32 out; counter: ceil(C / bn) * (1 + row tiles)
// unsigned ints, zero on entry and on exit, one buffer a stream; ypart:
// (ks, N, C) fp32 scratch where ks > 1 (else unused). The plan
// (ops/conv_bn.py::tf32_plan): a (bm, bn) tile, each 128 or 64; nrb blocks
// along the rows, no more than the row tiles (all of them where ks > 1); ks
// slices of K; smem bytes of the ring.
extern "C" int conv1x1_stats_tf32x3(const void* x, const void* w,
                                    long long swk, long long swc, void* y,
                                    void* part, void* stats, void* counter,
                                    void* ypart, int N, int K, int C, int bm,
                                    int bn, int nrb, int ks, int smem,
                                    void* stream) {
  using namespace mmvqa;
  using namespace mmvqa::k4;
  const int mtiles = bm > 0 ? (N + bm - 1) / bm : 0;
  if (N < 1 || K < 1 || C < 1 || nrb < 1 || nrb > mtiles || nrb > 65535 ||
      ks < 1 || ks > 64 || (ks > 1 && (nrb != mtiles || ypart == nullptr)) ||
      (ks - 1) * tf32::kChunk >= K || smem != f32::smem_bytes(bm, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  auto xp = static_cast<const float*>(x);
  auto wp = static_cast<const float*>(w);
  // W's (c, k) element: its rows are the columns of y
  const tf32::Dense xs{xp, K, 1, N, K, K % 4 == 0 && aligned16(x)};
  const tf32::Dense ws{wp, swc, swk, C, K,
                       swk == 1 && swc % 4 == 0 && K % 4 == 0 &&
                           aligned16(w)};
  auto yp = static_cast<float*>(y);
  auto p = static_cast<float*>(part);
  auto st = static_cast<float*>(stats);
  auto cnt = static_cast<unsigned*>(counter);
  auto yparts = static_cast<float*>(ypart);
  auto s = static_cast<cudaStream_t>(stream);
  if (bm == 128 && bn == 128)
    return f32::launch<128, 128>(xs, ws, yp, p, st, cnt, yparts, N, K, C, nrb,
                                 ks, smem, 0, s);
  if (bm == 128 && bn == 64)
    return f32::launch<128, 64>(xs, ws, yp, p, st, cnt, yparts, N, K, C, nrb,
                                ks, smem, 1, s);
  if (bm == 64 && bn == 128)
    return f32::launch<64, 128>(xs, ws, yp, p, st, cnt, yparts, N, K, C, nrb,
                                ks, smem, 2, s);
  if (bm == 64 && bn == 64)
    return f32::launch<64, 64>(xs, ws, yp, p, st, cnt, yparts, N, K, C, nrb,
                               ks, smem, 3, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16, the TMA path: x (N, K) dense; w (K, C) with unit stride on K and
// `swc` elements between its columns; y (N, C) dense; K, C and swc multiples
// of 8, every base 16-byte aligned. part: (nrb, 2, ceil(C / bn) * bn) fp32
// scratch; stats: (2, C) fp32 out; counter: ceil(C / bn) unsigned ints, zero
// on entry and on exit, one buffer a stream. The plan
// (ops/conv_bn.py::tma_plan): bn channels a column tile (64, 128, 192),
// stages of the ring, nrb blocks along the rows (no more than the row tiles
// of 192), smem bytes.
extern "C" int conv1x1_stats_tma(const void* x, const void* w, long long swc,
                                 void* y, void* part, void* stats,
                                 void* counter, int N, int K, int C, int bn,
                                 int stages, int nrb, int smem,
                                 void* stream) {
  using namespace mmvqa;
  using namespace mmvqa::k4;
  const int mtiles = (N + tma::kBM - 1) / tma::kBM;
  if (N < 1 || K < 8 || C < 8 || K % 8 || C % 8 || swc % 8 || swc < K ||
      !aligned16(x) || !aligned16(w) || !aligned16(y) || stages < 2 ||
      smem != tma::smem_bytes(bn, stages) || smem > 232448 || nrb < 1 ||
      nrb > mtiles || nrb > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mw, my;
  if (!tma::encode(&mx, x, K, N, K, tma::kBK, tma::kBM) ||
      !tma::encode(&mw, w, K, C, swc, tma::kBK, bn) ||
      !tma::encode(&my, y, C, N, C, tma::kYBox, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto p = static_cast<float*>(part);
  auto st = static_cast<float*>(stats);
  auto cnt = static_cast<unsigned*>(counter);
  auto s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64:
      return tma::launch<64>(mx, mw, my, p, st, cnt, N, K, C, stages, nrb,
                             smem, s);
    case 128:
      return tma::launch<128>(mx, mw, my, p, st, cnt, N, K, C, stages, nrb,
                              smem, s);
    case 192:
      return tma::launch<192>(mx, mw, my, p, st, cnt, N, K, C, stages, nrb,
                              smem, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
