// K1 forward: the fused visual-token head, out[b, c] = mean_p act(x[b, p, :] . W[:, c]).
//
// Replaces the TPU kernel mmvqa_tpu/ops/pallas_token_head.py::fused_token_head
// (_fwd_kernel / _fwd_call, pallas_call at :247). Like it, it never writes
// the (B, P, C) projection to device memory, and it sums in fp32.
//
// What bounds it on an H100: the activation, not the products or the bytes.
// At the flagship stage-0 tap (B=128, P=112*112, K=24, C=768) it takes 1.2 G
// activations against 29.6 G multiply-adds and 77 MB of x; the bf16 path's
// SERF (its polynomial form) is a fast exp and a fast divide an element, two
// special functions, which at 16 a cycle an SM are the bound.
//
// bf16 (token_head_fwd_mma_kernel): the products on the tensor cores, the
// activation and the sums on their accumulator fragments. Positions are one
// axis of B * P rows, cut into tiles that may straddle images, as in the
// backward (token_head_tile.cuh). A block is four consumer warps and one
// producer warp and owns 256 channels (a warp 64 of them) of a run of row
// tiles. The producer stages x (and W where it streams) by cp.async into a
// ring of four stages guarded by mbarriers.
//   W resident (K <= 96: the narrow taps): W's 256 channels, all K, staged
//     once; where K <= 32 (stage 0) a warp also holds its W fragments in 32
//     registers, so that a 16-row step loads only x's (faster at stage 0:
//     the probe's w_shared). A stage is a 64-row tile of x, all K; a warp
//     computes s for 16 rows x 64 channels at a time, then takes their
//     activation.
//   W streamed (wider K): a stage is a 32-row x 32-k chunk of x and the
//     32 x 256 chunk of W; a warp sums 32 rows x 64 channels over K, then
//     takes the activation.
// How the activation overlaps the products: by warps, not by a second
// accumulator set. No block-wide barrier stands between a warp's products
// and its activation, so the 12 consumer warps of an SM (three blocks)
// drift apart and one warp's activation runs beside another's products.
// A second set, the next 16 rows' products issued before this step's
// activation, measured slower at stage 0 (tools/probe_token_head.py,
// two_sets; PERF.md): it leaves fewer registers for the activation's
// independent chains. The activation is held by its instruction count
// (the same probe's no_special and expf), so SERF's polynomial feeds ex2
// directly (act below).
// Each thread keeps running sums of its 16 channels for the image its rows
// are in, with no test per element: a 16-row step lies in one image but
// where an image ends inside it, and only then are its rows split by image.
// Rows past B * P arrive as zeros and act(0) = 0 for the three acts. When a
// warp leaves an image it adds its sums over the 8 row lanes by shuffles and
// writes them to the block's partial for that image.
//
// Across blocks, inside the kernel: the last block to finish an image (one
// atomicInc counter an image and channel tile, which wraps to 0) adds the
// partials of the blocks that share the image in block order, divides by P
// and casts. No float atomics: two runs give identical bits.
//
// fp32 (token_head_partial_kernel, the port's first): a register-tiled fp32
// GEMM on the CUDA cores (it serves the fp32 checks), (64 positions x 128
// channels) tiles, K staged through shared memory 8 at a time, every thread
// a 4 x 8 tile of sums that it activates and adds to one running sum per
// channel; the P axis cut into chunks that write (B, nchunks, C) partials,
// which a second small kernel adds in a fixed order, divides by P and
// casts. Registers capped for three blocks an SM, four waves of blocks
// (ops/token_head.py::launch_plan).
//
// x is read by strides, so the trunk's map goes in as its (B, P, K) view
// with no transposing copy; the bf16 kernel copies 16 bytes at a time where
// every row is 16-byte aligned and K-major, elements otherwise.
#include <climits>
#include <type_traits>

#include "token_head_tile.cuh"

namespace mmvqa {

constexpr int kTileP = 64;    // positions per tile
constexpr int kTileC = 128;   // channels per block
constexpr int kChunkK = 8;    // contraction depth staged per step
constexpr int kThreads = 256;
// blocks per SM: caps registers at 80 a thread (ptxas spills under 200
// bytes). Uncapped the kernel takes more than 85 and only two blocks fit;
// three measured about 10% faster at the early taps (PERF.md).
constexpr int kMinBlocks = 3;
constexpr int kRegP = 4;      // positions per thread
constexpr int kRegC = 8;      // channels per thread (contiguous)
constexpr int kGroupsP = kTileP / kRegP;  // 16 position groups
constexpr int kGroupsC = kTileC / kRegC;  // 16 channel groups
static_assert(kGroupsP * kGroupsC == kThreads, "thread tile");

// SERF sigmoid-gate polynomial (ops/activations.py::SERF_P5)
__constant__ float kSerfP5[6] = {
    4.743144768698157e-04f, 9.427917061937980e-03f, 7.255023041520858e-02f,
    2.832661920672991e-01f, 1.605305418315285e+00f, 7.293287033146151e-01f};

enum Act : int { kSerf = 0, kSerfFast = 1, kRelu = 2 };

template <int ACT>
__device__ __forceinline__ float activate(float s) {
  if (ACT == kSerf) {
    const float y = log1pf(expf(fminf(s, 50.0f)));
    return s * erff(y);
  } else if (ACT == kSerfFast) {
    float q = kSerfP5[0];
#pragma unroll
    for (int i = 1; i < 6; ++i) q = q * s + kSerfP5[i];
    return s * (1.0f / (1.0f + expf(-q)));
  } else {
    return fmaxf(s, 0.0f);
  }
}

// grid (B, ceil(C / kTileC), nchunks), block kThreads. Block (b, ct, z) sums
// act(x . W) over positions [z * chunk, min(P, (z + 1) * chunk)) for
// channels [ct * kTileC, ...) and writes partial[b, z, c].
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    token_head_partial_kernel(
    const T* __restrict__ x, long long sb, long long sp, long long sk,
    const T* __restrict__ w, float* __restrict__ partial, int P, int K, int C,
    int chunk, int nchunks) {
  __shared__ __align__(16) float xs[kChunkK][kTileP];  // [k][position]
  __shared__ __align__(16) float ws[kChunkK][kTileC];  // [k][channel]
  __shared__ float red[kGroupsP][kTileC];

  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kTileC;
  const int z = blockIdx.z;
  const int tid = threadIdx.x;
  const int tc = tid % kGroupsC;  // this thread's channels: tc * kRegC + j
  const int tp = tid / kGroupsC;  // this thread's positions: tp * kRegP + i

  const int p_begin = z * chunk;
  const int p_end = min(P, p_begin + chunk);
  const T* xb = x + (long long)b * sb;

  float csum[kRegC];
#pragma unroll
  for (int j = 0; j < kRegC; ++j) csum[j] = 0.0f;

  for (int t0 = p_begin; t0 < p_end; t0 += kTileP) {
    float acc[kRegP][kRegC];
#pragma unroll
    for (int i = 0; i < kRegP; ++i)
#pragma unroll
      for (int j = 0; j < kRegC; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += kChunkK) {
      __syncthreads();  // the previous chunk is consumed
      // x tile: kChunkK x kTileP values, the unit-stride axis fastest
      for (int i = tid; i < kChunkK * kTileP; i += kThreads) {
        int k, p;
        if (sp == 1) {
          k = i / kTileP;
          p = i % kTileP;
        } else {
          p = i / kChunkK;
          k = i % kChunkK;
        }
        const int gp = t0 + p;
        const int gk = k0 + k;
        xs[k][p] = (gp < p_end && gk < K)
                       ? to_f32(xb[(long long)gp * sp + (long long)gk * sk])
                       : 0.0f;
      }
      // W tile: kChunkK x kTileC values, channels fastest (W is contiguous)
      for (int i = tid; i < kChunkK * kTileC; i += kThreads) {
        const int k = i / kTileC;
        const int c = i % kTileC;
        const int gk = k0 + k;
        const int gc = c0 + c;
        ws[k][c] = (gk < K && gc < C) ? to_f32(w[(long long)gk * C + gc]) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kChunkK; ++k) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[k][tp * kRegP]);
        const float4 wa = *reinterpret_cast<const float4*>(&ws[k][tc * kRegC]);
        const float4 wb =
            *reinterpret_cast<const float4*>(&ws[k][tc * kRegC + 4]);
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
    // padded positions are left out of the sum; padded channels never leave
#pragma unroll
    for (int i = 0; i < kRegP; ++i) {
      if (t0 + tp * kRegP + i < p_end) {
#pragma unroll
        for (int j = 0; j < kRegC; ++j) csum[j] += activate<ACT>(acc[i][j]);
      }
    }
  }

  // add the kGroupsP position groups of each channel, in a fixed order
#pragma unroll
  for (int j = 0; j < kRegC; ++j) red[tp][tc * kRegC + j] = csum[j];
  __syncthreads();
  if (tid < kTileC && c0 + tid < C) {
    float s = 0.0f;
#pragma unroll
    for (int g = 0; g < kGroupsP; ++g) s += red[g][tid];
    partial[((long long)b * nchunks + z) * C + c0 + tid] = s;
  }
}

// out[b, c] = (sum over chunks, in order) / P, cast to the input dtype.
template <typename T>
__global__ void token_head_finalize_kernel(const float* __restrict__ partial,
                                           T* __restrict__ out, int B, int C,
                                           int nchunks, int P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * C) return;
  const long long b = i / C;
  const int c = (int)(i % C);
  float s = 0.0f;
  for (int z = 0; z < nchunks; ++z) s += partial[(b * nchunks + z) * C + c];
  out[i] = from_f32<T>(s / (float)P);
}

template <typename T, int ACT>
cudaError_t launch(const void* x, long long sb, long long sp, long long sk,
                   const void* w, float* partial, void* out, int B, int P,
                   int K, int C, int chunk, int nchunks, cudaStream_t stream) {
  const dim3 grid(B, (C + kTileC - 1) / kTileC, nchunks);
  token_head_partial_kernel<T, ACT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), sb, sp, sk, static_cast<const T*>(w), partial,
      P, K, C, chunk, nchunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  const long long n = (long long)B * C;
  token_head_finalize_kernel<T><<<(unsigned)((n + threads - 1) / threads),
                                  threads, 0, stream>>>(
      partial, static_cast<T*>(out), B, C, nchunks, P);
  return cudaGetLastError();
}

// ------------------------------------------------------- bf16: tensor cores

namespace k1 {
namespace fwd {

constexpr int kWarpC = 64;                     // channels of a consumer warp
constexpr int kNT = kWarpC / 8;                // its n8 fragments
constexpr int kConsumers = 4;                  // consumer warps
constexpr int kTileC = kConsumers * kWarpC;    // channels of a block
constexpr int kThreads = (kConsumers + 1) * 32;  // and the producer warp
constexpr int kStages = 4;                     // the ring
constexpr int kResidentK = 96;                 // W resident up to this K
constexpr int kStreamRows = 32;  // rows of a tile where W streams
constexpr int kWld = kTileC + 8;  // bf16 row stride of staged W: 528 bytes,
                                  // eight rows on distinct banks

// How W reaches the products: streamed with x through the ring; resident in
// shared memory (K <= 96); resident and, for K <= 32, its fragments held in
// registers as well, so that a 16-row step loads only x's fragments.
enum Mode : int { kStreamed = 0, kWShared = 1, kWRegisters = 2 };

__host__ __device__ inline int tile_rows(int mode) {
  return mode != kStreamed ? 64 : kStreamRows;
}

// bf16 elements of a ring stage
__host__ __device__ inline int stage_elems(int K, bool resident) {
  return resident ? 64 * (resident_k(K) + 8)
                  : kStreamRows * kXRow + kChunkK * kWld;
}

// Shared memory: W (resident: resident_k(K) x kWld), the ring, the full and
// empty mbarriers of its stages, the last-block flag.
__host__ __device__ inline int smem_bytes(int K, bool resident) {
  const int w = resident ? resident_k(K) * kWld : 0;
  return 2 * (w + kStages * stage_elems(K, resident)) + 2 * kStages * 8 + 16;
}

// The bf16 activation: SERF's polynomial with the fast exp and divide, two
// special functions an element; exact SERF; ReLU.
template <int ACT>
__device__ __forceinline__ float act(float s) {
  if (ACT == kSerf) {
    const float y = log1pf(expf(fminf(s, 50.0f)));
    return s * erff(y);
  } else if (ACT == kSerfFast) {
    // x * sigmoid(p5(x)) with ops/activations.py::SERF_P5. The polynomial's
    // coefficients carry -log2(e), so that exp(-p5) is one ex2: __expf
    // would add a multiply and a guard of three instructions against
    // results below 2^-126 (there the gate is 1 either way). The epilogue
    // is held by its instruction count (PERF.md).
    constexpr float m = -1.4426950408889634f;
    constexpr float c0 = 4.743144768698157e-04f * m,
                    c1 = 9.427917061937980e-03f * m,
                    c2 = 7.255023041520858e-02f * m,
                    c3 = 2.832661920672991e-01f * m,
                    c4 = 1.605305418315285e+00f * m,
                    c5 = 7.293287033146151e-01f * m;
    const float q = ((((c0 * s + c1) * s + c2) * s + c3) * s + c4) * s + c5;
    return __fdividef(s, 1.0f + ex2_ftz(q));
  } else {
    return fmaxf(s, 0.0f);
  }
}

struct Out {
  __nv_bfloat16* out;  // (B, C)
  float* part;         // (gridDim.y, slots, cpad) fp32: per-image sums
  unsigned* counter;   // (B, gridDim.x), zero on entry and on exit
  int per_block;       // row tiles of a block
  int slots;           // images a block's partial holds
  int cpad;            // gridDim.x * kTileC
};

// grid (ceil(C / kTileC), nblocks), block kThreads. Block (ct, j) owns the
// channels [ct * kTileC, + kTileC) of the row tiles [j * per_block, + per_block).
template <int ACT, int MODE>
__global__ void __launch_bounds__(kThreads, 3)
    token_head_fwd_mma_kernel(Args a, Out o, int vec_x, int vec_w) {
  constexpr bool RESIDENT = MODE != kStreamed;
  constexpr int TP = RESIDENT ? 64 : kStreamRows;
  constexpr int RB = TP / 16;  // 16-row steps of a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kr = resident_k(a.K);
  const int xld = RESIDENT ? kr + 8 : kXRow;  // row stride of a staged x
  const int sbuf = stage_elems(a.K, RESIDENT);
  __nv_bfloat16* wres = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = RESIDENT ? wres + kr * kWld : wres;
  auto* full = reinterpret_cast<uint64_t*>(ring + kStages * sbuf);
  auto* empty = full + kStages;
  int* flag = reinterpret_cast<int*>(empty + kStages);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lr = lane / 4, lc = (lane % 4) * 2;  // accumulator row, column
  const int ct = blockIdx.x;
  const int N = a.B * a.P;
  const int n_items = (N + TP - 1) / TP;
  const int first = blockIdx.y * o.per_block;
  const int last = min(n_items, first + o.per_block);
  const int b_first = first * TP / a.P;
  const int b_last = (min(N, last * TP) - 1) / a.P;
  const int n_kc = (a.K + kChunkK - 1) / kChunkK;
  const int per_tile = RESIDENT ? 1 : n_kc;  // stages a tile
  const int stages = (last - first) * per_tile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 64);  // each producer lane: its copies, its stores
      mbar_init(&empty[s], kConsumers);
    }
  }
  if (RESIDENT) {
    stage_w(a, wres, kWld, 0, kr, ct * kTileC, kTileC, vec_w, threadIdx.x,
            kThreads);
    commit();
    wait_groups<0>();
  }
  __syncthreads();

  if (warp == kConsumers) {
    // ---- the producer: stage i into buffer i % kStages once the consumers
    // have released its previous use
    for (int i = 0; i < stages; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(&empty[s], (i / kStages - 1) & 1);
      __nv_bfloat16* buf = ring + s * sbuf;
      const int item = first + i / per_tile;
      if (RESIDENT) {
        stage_x<TP>(a, buf, xld, item, 0, kr, vec_x, lane, 32);
      } else {
        const int k0 = (i % per_tile) * kChunkK;
        stage_x<TP>(a, buf, kXRow, item, k0, kChunkK, vec_x, lane, 32);
        stage_w(a, buf + TP * kXRow, kWld, k0, kChunkK, ct * kTileC, kTileC,
                vec_w, lane, 32);
      }
      cp_async_arrive(&full[s]);
      mbar_arrive(&full[s]);
    }
  } else {
    // ---- a consumer: 64 channels, every row of the block
    float sum[kNT][2];
#pragma unroll
    for (int n = 0; n < kNT; ++n) sum[n][0] = sum[n][1] = 0.0f;
    int b_cur = b_first;
    // the first row of the next image; none after the last image (its rows
    // past B * P are zeros)
    int next_b = b_cur == a.B - 1 ? INT_MAX : (b_cur + 1) * a.P;
    const int c_warp = ct * kTileC + warp * kWarpC;

    // the warp's sums over its 8 row lanes, into the block's partial for
    // image b; then zero
    auto flush = [&](int b) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int off = 4; off < 32; off *= 2)
            sum[n][e] += __shfl_xor_sync(0xffffffffu, sum[n][e], off);
      if (lr == 0) {
        float* dst = o.part +
                     ((long long)blockIdx.y * o.slots + (b - b_first)) * o.cpad +
                     c_warp + lc;
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          *reinterpret_cast<float2*>(dst + n * 8) =
              make_float2(sum[n][0], sum[n][1]);
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) sum[n][0] = sum[n][1] = 0.0f;
    };

    // act(s) of 16 rows (first row n0) into the running sums; where an
    // image ends inside the 16 rows, its rows are split off and flushed
    auto epilogue = [&](float (&acc)[kNT][4], int n0) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = act<ACT>(acc[n][e]);
      if (n0 + 16 <= next_b) {
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          sum[n][0] += acc[n][0];
          sum[n][1] += acc[n][1];
          sum[n][0] += acc[n][2];
          sum[n][1] += acc[n][3];
        }
        return;
      }
      int lo = 0;
      for (;;) {
        const int lim = next_b - n0;  // rows below lim are image b_cur's
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lr + 8 * h;
          if (r >= lo && r < lim) {
#pragma unroll
            for (int n = 0; n < kNT; ++n) {
              sum[n][0] += acc[n][2 * h];
              sum[n][1] += acc[n][2 * h + 1];
            }
          }
        }
        if (lim >= 16) break;
        flush(b_cur);
        ++b_cur;
        next_b = b_cur == a.B - 1 ? INT_MAX : next_b + a.P;
        lo = max(lim, 0);
      }
    };

    auto release = [&](int i) {  // stage i is read: its buffer may refill
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[i % kStages]);
    };
    auto wait_stage = [&](int i) {
      mbar_wait(&full[i % kStages], (i / kStages) & 1);
    };

    if constexpr (MODE != kStreamed) {
      const __nv_bfloat16* wcol = wres + warp * kWarpC;
      const int n_ks = (a.K + 15) / 16;
      // K <= 32: the warp's W fragments, both k16 steps, stay in registers
      unsigned wf[2][kNT / 2][4];
      if constexpr (MODE == kWRegisters) {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int n = 0; n < kNT; n += 2)
            ldsm_x4_t(wf[ks][n / 2], wcol + (ks * 16 + lane % 16) * kWld +
                                         n * 8 + (lane / 16) * 8);
      }
      float acc[kNT][4];
      for (int t = 0; t < stages; ++t) {
        wait_stage(t);
        const __nv_bfloat16* xs = ring + (t % kStages) * sbuf;
#pragma unroll
        for (int rb = 0; rb < TP / 16; ++rb) {
          // s of these 16 rows, all K, 64 channels
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
          const __nv_bfloat16* xrow = xs + (rb * 16 + lane % 16) * xld +
                                      (lane / 16) * 8;
          if constexpr (MODE == kWRegisters) {
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
              if (ks == n_ks) break;
              unsigned af[4];
              ldsm_x4(af, xrow + ks * 16);
#pragma unroll
              for (int n = 0; n < kNT; n += 2) {
                mma(acc[n], af, wf[ks][n / 2][0], wf[ks][n / 2][1]);
                mma(acc[n + 1], af, wf[ks][n / 2][2], wf[ks][n / 2][3]);
              }
            }
          } else {
            for (int ks = 0; ks < n_ks; ++ks) {
              unsigned af[4];
              ldsm_x4(af, xrow + ks * 16);
              const __nv_bfloat16* wrow = wcol + (ks * 16 + lane % 16) * kWld;
#pragma unroll
              for (int n = 0; n < kNT; n += 2) {
                unsigned bf[4];
                ldsm_x4_t(bf, wrow + n * 8 + (lane / 16) * 8);
                mma(acc[n], af, bf[0], bf[1]);
                mma(acc[n + 1], af, bf[2], bf[3]);
              }
            }
          }
          if (rb == TP / 16 - 1) release(t);
          epilogue(acc, (first + t) * TP + rb * 16);
        }
      }
    } else {
      float acc[RB][kNT][4];
      int i = 0;
      for (int item = first; item < last; ++item) {
#pragma unroll
        for (int m = 0; m < RB; ++m)
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
        for (int kc = 0; kc < n_kc; ++kc, ++i) {
          wait_stage(i);
          const __nv_bfloat16* xs = ring + (i % kStages) * sbuf;
          const __nv_bfloat16* wrow0 =
              xs + TP * kXRow + (lane % 16) * kWld + warp * kWarpC;
#pragma unroll
          for (int ks = 0; ks < kChunkK / 16; ++ks) {
            if (kc * kChunkK + ks * 16 >= a.K) break;
            unsigned af[RB][4];
#pragma unroll
            for (int m = 0; m < RB; ++m)
              ldsm_x4(af[m], xs + (m * 16 + lane % 16) * kXRow + ks * 16 +
                                 (lane / 16) * 8);
            const __nv_bfloat16* wrow = wrow0 + ks * 16 * kWld;
#pragma unroll
            for (int n = 0; n < kNT; n += 2) {
              unsigned bf[4];
              ldsm_x4_t(bf, wrow + n * 8 + (lane / 16) * 8);
#pragma unroll
              for (int m = 0; m < RB; ++m) {
                mma(acc[m][n], af[m], bf[0], bf[1]);
                mma(acc[m][n + 1], af[m], bf[2], bf[3]);
              }
            }
          }
          release(i);
        }
#pragma unroll
        for (int m = 0; m < RB; ++m) epilogue(acc[m], item * TP + m * 16);
      }
    }
    flush(b_cur);
  }

  // ---- the last block of each of its images and this channel tile adds
  // the partials of the blocks that share the image, in block order
  __threadfence();
  __syncthreads();
  const int rows_pb = o.per_block * TP;
  for (int b = b_first; b <= b_last; ++b) {
    const int j_lo = (int)((long long)b * a.P / rows_pb);
    const int j_hi = min((int)gridDim.y - 1,
                         (int)(((long long)(b + 1) * a.P - 1) / rows_pb));
    if (threadIdx.x == 0) {
      const unsigned n = (unsigned)(j_hi - j_lo);
      *flag = atomicInc(&o.counter[(long long)b * gridDim.x + ct], n) == n;
    }
    __syncthreads();
    if (*flag) {
      __threadfence();
      for (int c = threadIdx.x; c < kTileC; c += kThreads) {
        const int gc = ct * kTileC + c;
        if (gc >= a.C) break;
        float s = 0.0f;
        for (int j = j_lo; j <= j_hi; ++j) {
          const int bj = (int)((long long)j * rows_pb / a.P);  // its first
          s += __ldcg(&o.part[((long long)j * o.slots + (b - bj)) * o.cpad +
                              gc]);
        }
        o.out[(long long)b * a.C + gc] = __float2bfloat16(s / (float)a.P);
      }
    }
    __syncthreads();  // the flag is read before the next image's
  }
}

template <typename F>
cudaError_t for_kernel(int act, int mode, F&& f) {
  auto pick = [&](auto act_c) -> cudaError_t {
    constexpr int A = decltype(act_c)::value;
    switch (mode) {
      case kStreamed: return f(token_head_fwd_mma_kernel<A, kStreamed>);
      case kWShared: return f(token_head_fwd_mma_kernel<A, kWShared>);
      case kWRegisters: return f(token_head_fwd_mma_kernel<A, kWRegisters>);
    }
    return cudaErrorInvalidValue;
  };
  switch (act) {
    case kSerf: return pick(std::integral_constant<int, kSerf>());
    case kSerfFast: return pick(std::integral_constant<int, kSerfFast>());
    case kRelu: return pick(std::integral_constant<int, kRelu>());
  }
  return cudaErrorInvalidValue;
}

// The shared memory each (act, mode) variant may use, asked for once: an
// array of this file alone, so that copies of the library loaded side by
// side (tools/probe_token_head.py) each ask for their own.
static int fwd_granted[3][3];

// Raises the variant's limit to smem where it is below it and never lowers
// it: the occupancy query of a shape that needs less must not take away
// what a plan made earlier for a shape that needs more was granted.
template <typename Kern>
cudaError_t grant_smem(Kern kern, int act, int mode, int smem) {
  int& granted = fwd_granted[act][mode];
  if (smem <= granted) return cudaSuccess;
  cudaError_t err = allow_smem(kern, smem);
  if (err == cudaSuccess) granted = smem;
  return err;
}

}  // namespace fwd
}  // namespace k1
}  // namespace mmvqa

extern "C" const char* mmvqa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// fp32 only: x (B, P, K) by element strides (sb, sp, sk); w (K, C)
// contiguous; partial (B, nchunks, C) fp32 scratch; out (B, C). chunk is a
// multiple of 64 (ops/token_head.py::launch_plan).
extern "C" int token_head_fwd(const void* x, int dtype, long long sb,
                              long long sp, long long sk, const void* w,
                              void* partial, void* out, int B, int P, int K,
                              int C, int act, int chunk, int nchunks,
                              void* stream) {
  using namespace mmvqa;
  if (dtype != kFloat32) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partial);
  switch (act) {
    case kSerf:
      err = launch<float, kSerf>(x, sb, sp, sk, w, part, out, B, P, K, C,
                                 chunk, nchunks, s);
      break;
    case kSerfFast:
      err = launch<float, kSerfFast>(x, sb, sp, sk, w, part, out, B, P, K, C,
                                     chunk, nchunks, s);
      break;
    case kRelu:
      err = launch<float, kRelu>(x, sb, sp, sk, w, part, out, B, P, K, C,
                                 chunk, nchunks, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Blocks of the bf16 forward for (act, mode) an SM holds at once with
// `smem` bytes of shared memory: the plan fills one wave of them.
extern "C" int token_head_fwd_occupancy(int act, int mode, int smem,
                                        int* blocks) {
  using namespace mmvqa::k1;
  using namespace mmvqa::k1::fwd;
  return static_cast<int>(for_kernel(act, mode, [&](auto kern) {
    cudaError_t err = grant_smem(kern, act, mode, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                         kThreads, smem);
  }));
}

// bf16: x (B, P, K) by element strides; w (K, C) contiguous; part
// (nblocks, slots, ceil(C / 256) * 256) fp32 scratch; out (B, C); counter
// B * ceil(C / 256) unsigned ints, zero on entry and on exit, one buffer a
// stream. The plan (ops/token_head.py::forward_plan): tp rows a tile (64
// where W is resident, 32 where it streams), per_block tiles a block,
// nblocks blocks along the rows with none empty, mode (Mode: how W reaches
// the products), slots the images a block spans at most, smem bytes.
extern "C" int token_head_fwd_mma(const void* x, long long sb, long long sp,
                                  long long sk, const void* w, void* part,
                                  void* out, void* counter, int B, int P,
                                  int K, int C, int act, int tp,
                                  int per_block, int nblocks, int mode,
                                  int slots, int smem, void* stream) {
  using namespace mmvqa::k1;
  using namespace mmvqa::k1::fwd;
  const long long N = (long long)B * P;
  const long long items = (N + tp - 1) / tp;
  const int ctiles = (C + kTileC - 1) / kTileC;
  const long long rows_pb = (long long)per_block * tp;
  if (B < 1 || P < 1 || K < 1 || C < 1 || N >= (1ll << 31) ||
      mode < kStreamed || mode > kWRegisters || tp != tile_rows(mode) ||
      (mode == kWShared && resident_k(K) > kResidentK) ||
      (mode == kWRegisters && resident_k(K) != kChunkK) ||
      smem != smem_bytes(K, mode != kStreamed) || nblocks < 1 ||
      nblocks > 65535 ||
      (long long)nblocks * per_block < items ||
      (long long)(nblocks - 1) * per_block >= items ||
      slots < (B < (rows_pb - 1) / P + 2 ? B : (rows_pb - 1) / P + 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, sb, sp, sk, w, nullptr, nullptr, 0, 0, 0, nullptr, nullptr,
         nullptr, B, P, K, C, tp, per_block, mode};
  Out o{static_cast<__nv_bfloat16*>(out), static_cast<float*>(part),
        static_cast<unsigned*>(counter), per_block, slots, ctiles * kTileC};
  const int vec_x = vec_x_ok(x, sb, sp, sk, K);
  const int vec_w = vec_w_ok(w, C);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(for_kernel(act, mode, [&](auto kern) {
    cudaError_t err = grant_smem(kern, act, mode, smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3(ctiles, nblocks), kThreads, smem, st>>>(a, o, vec_x, vec_w);
    return cudaGetLastError();
  }));
}
