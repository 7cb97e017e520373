// K1 forward: the fused visual-token head, out[b, c] = mean_p act(x[b, p, :] . W[:, c]).
//
// Replaces the TPU kernel mmvqa_tpu/ops/pallas_token_head.py::fused_token_head
// (_fwd_kernel / _fwd_call, pallas_call at :247). Like it, it never writes
// the (B, P, C) projection to device memory, and it sums in fp32.
//
// What bounds it on an H100 in bf16: the activation, not the products or
// the bytes. At the flagship stage-0 tap (B=128, P=112*112, K=24, C=768) it
// takes 1.2 G activations against 29.6 G multiply-adds and 77 MB of x; the
// bf16 path's SERF (its polynomial form) is a fast exp and a fast divide an
// element, two special functions, which at 16 a cycle an SM are the bound.
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
// fp32 (token_head_fwd_tf32x3_kernel, the CLIs' default dtype): the same
// rows and tiles that cross images as bf16, with the products as split-TF32
// products on the tensor cores (csrc/tf32x3.cuh: three TF32 products of
// each operand's hi and lo parts, each k8 step summed from zero and added
// to the running sum in fp32, so that K up to 2048 keeps fp32 accuracy)
// and exact SERF (libm expf, log1pf, erff) in the accumulator fragments. A
// block is four consumer warps of 32 channels and one producer warp: 128
// channels of a run of row tiles. The producer stages 32-k chunks of x (and
// of W, where it streams) by cp.async into a four-stage ring guarded by
// mbarriers; 16-byte copies where x's rows are 16-byte aligned and K-major,
// element copies otherwise. W stays in shared memory, staged once, where
// K <= 96 (the taps with the most rows, whose activation binds): 16-row
// tiles, up to four blocks an SM, whose 16 consumer warps hide more of
// SERF's latency than fewer, wider ones did (32 rows at three blocks an SM
// took 2-14% longer at these taps: tools/probe_token_head.py --fp32). It
// streams with x beyond: 64-row tiles, two
// blocks an SM. As in bf16, no block-wide barrier stands between a warp's
// products and its activation: one warp's SERF runs beside another's
// products, and every sum across warps and blocks is taken by a warp
// alone. The deep taps have few rows (ResNet's layer4 at B=16: 784, 13
// tiles of 64 x 6 channel tiles against 132 SMs): there the plan
// (ops/token_head.py::fp32_forward_plan) cuts K's chunks into ks slices, a
// block each; each warp stores its slice's s, and the last of a tile's ks
// warps (an atomicInc counter a tile and warp) adds them in slice order
// before SERF, which is not linear and so is never taken of a part of K.
// Per-image sums: a warp's running sums go to its block's partial of an
// image where the image ends, and the last warp of an (image, 32 channels)
// adds the partials of the blocks that share the image in block order. No
// float atomics: two runs give identical bits. What bounds it on an H100:
// the products at K >= 176 (165 TFLOP/s of split-TF32 products), SERF's 45
// FP32 instructions an element at K <= 80 (tools/time_token_head.py reads
// them from the SASS); both run far from those bounds: mma.sync's TF32
// products, and SERF's dependent chains behind the branch in erff.
//
// x is read by strides, so the trunk's map goes in as its (B, P, K) view
// with no transposing copy; both kernels copy 16 bytes at a time where every
// row is 16-byte aligned and K-major, elements otherwise.
#include <climits>
#include <type_traits>

#include "tf32x3.cuh"
#include "token_head_tile.cuh"

namespace mmvqa {

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

// ------------------------------------------- fp32: split-TF32 tensor cores

namespace fwd32 {

constexpr int kWarpC = 32;                       // channels of a consumer warp
constexpr int kNT = kWarpC / 8;                  // its n8 fragments
constexpr int kConsumers = 4;                    // consumer warps
constexpr int kTileC = kConsumers * kWarpC;      // channels of a block
constexpr int kThreads = (kConsumers + 1) * 32;  // and the producer warp
constexpr int kStages = 4;                       // the ring
constexpr int kChunk = tf32::kChunk;             // k's of a stage
constexpr int kResidentK = 96;                   // W resident up to this K

// How W reaches the products: streamed with x through the ring, a 32 x 128
// chunk a stage; or resident in shared memory, all K, staged once.
enum Mode : int { kStreamed = 0, kResident = 1 };

__host__ __device__ inline int kpad(int K) { return (K + 31) / 32 * 32; }

// fp32 values of a ring stage: a TP x 32 chunk of x, and where W streams a
// 32 x 128 chunk of W
__host__ __device__ inline int stage_floats(int tp, bool resident) {
  return tp * kChunk + (resident ? 0 : kChunk * kTileC);
}

// Shared memory: W (resident: K in 32s x 128), the ring, its full and empty
// mbarriers. Rows of 32 and 128 values, unpadded, in tf32x3.cuh's swizzle.
__host__ __device__ inline int smem_bytes(int tp, int K, bool resident) {
  const int w = resident ? kpad(K) * kTileC : 0;
  return 4 * (w + kStages * stage_floats(tp, resident)) + 2 * kStages * 8;
}

struct Out {
  float* out;          // (B, C)
  float* part;         // (gridDim.y, slots, cpad) fp32: per-image sums
  unsigned* counter;   // (B, gridDim.x, kConsumers): an image's, by warp
  unsigned* kcounter;  // K split: (gridDim.y, gridDim.x, kConsumers): a
                       // tile's, by warp; all zero on entry and on exit
  float* spart;        // K split: (gridDim.y, gridDim.x, gridDim.z,
                       // kConsumers, TP * 32) fp32: the slices' s
  int per_block;       // row tiles of a block
  int slots;           // images a block's partial holds
  int cpad;            // gridDim.x * kTileC
};

// grid (ceil(C / kTileC), nblocks, ks), block kThreads. Block (ct, j, z)
// owns the channels [ct * kTileC, + kTileC) of the row tiles [j *
// per_block, + per_block) of TP rows, and the z-th of ks slices of K's
// 32-k chunks (ks > 1 only with one tile a block, at the deep taps: few
// rows, wide K). Stage i of the ring holds the block's chunk i % nkc of its
// tile i / nkc. Consumer warp w sums s for the tile's TP rows and its 32
// channels over its chunks (acc: TP / 16 m16 tiles x 4 n8 fragments);
// where K is split it stores that partial and the last of the ks warps
// that hold its tile's slices adds them in slice order. Then the warp takes
// SERF of each 16-row step, adds it to its per-image running sums, and
// flushes them to the block's partial of an image where the image ends;
// the last warp of an (image, 32 channels) to flush adds the partials of
// the blocks that share the image in block order.
template <int ACT, int TP, bool RESIDENT>
__global__ void __launch_bounds__(kThreads, RESIDENT ? 4 : 2)
    token_head_fwd_tf32x3_kernel(tf32::Positions xsrc, tf32::Dense wsrc,
                                 Out o, int B, int P, int K, int C) {
  using namespace tf32;
  constexpr int MT = TP / 16;  // m16 tiles of a warp
  constexpr int SB = TP * kChunk + (RESIDENT ? 0 : kChunk * kTileC);
  extern __shared__ __align__(128) float smem32[];
  const int kp = kpad(K);
  float* wres = smem32;  // resident: [kp][kTileC]
  float* ring = RESIDENT ? wres + kp * kTileC : smem32;
  auto* full = reinterpret_cast<uint64_t*>(ring + kStages * SB);
  auto* empty = full + kStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;  // accumulator row, column pair
  const int ct = blockIdx.x;
  const int c0 = ct * kTileC;
  const int N = B * P;
  const int n_items = (N + TP - 1) / TP;
  const int first = blockIdx.y * o.per_block;
  const int last = min(n_items, first + o.per_block);
  const int first_img = (int)((long long)first * TP / P);
  const int rows_pb = o.per_block * TP;
  // the block's chunks of K: all of them, or its slice where K is split
  const int ks = gridDim.z, z = blockIdx.z;
  const int n_kc = (K + kChunk - 1) / kChunk;
  const int kc_lo = z * n_kc / ks;
  const int nkc = (z + 1) * n_kc / ks - kc_lo;
  const int stages = (last - first) * nkc;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 64);  // each producer lane: its copies, its stores
      mbar_init(&empty[s], kConsumers);
    }
  }
  if (RESIDENT) {
    stage(wres, kp, kTileC, wsrc, 0, c0, threadIdx.x, kThreads);
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
      float* buf = ring + s * SB;
      const int item = first + i / nkc;
      const int k0 = (kc_lo + i % nkc) * kChunk;
      stage(buf, TP, kChunk, xsrc, item * TP, k0, lane, 32);
      if (!RESIDENT)
        stage(buf + TP * kChunk, kChunk, kTileC, wsrc, k0, c0, lane, 32);
      cp_async_arrive(&full[s]);
      mbar_arrive(&full[s]);
    }
    commit();
    wait_groups<0>();  // its copies land before it leaves
    return;
  }

  // ---- a consumer: 32 channels, every row of the block
  const int cw = warp * kWarpC;  // the warp's channels in the tile
  float sum[kNT][2];
#pragma unroll
  for (int n = 0; n < kNT; ++n) sum[n][0] = sum[n][1] = 0.0f;
  int b_cur = first_img;
  // the first row of the next image; none after the last image (its rows
  // past B * P are zeros)
  int next_b = b_cur == B - 1 ? INT_MAX : (b_cur + 1) * P;

  // the warp's sums over its 8 row lanes (a tree: lanes g ^ 1, then g ^ 2,
  // then g ^ 4), into the block's partial for image b, then zero; the last
  // warp of the image's blocks to get here (an atomicInc counter, which
  // wraps to 0) adds their partials of its 32 channels in block order
  auto flush = [&](int b) {
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off *= 2)
          sum[n][e] += __shfl_xor_sync(0xffffffffu, sum[n][e], off);
    if (g == 0) {
      float* dst = o.part +
                   ((long long)blockIdx.y * o.slots + (b - first_img)) *
                       o.cpad + c0 + cw + 2 * q;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) =
            make_float2(sum[n][0], sum[n][1]);
      __threadfence();
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n) sum[n][0] = sum[n][1] = 0.0f;
    __syncwarp();
    const int j_lo = (int)((long long)b * P / rows_pb);
    const int j_hi = min((int)gridDim.y - 1,
                         (int)(((long long)(b + 1) * P - 1) / rows_pb));
    int adds = 0;
    if (lane == 0) {
      const unsigned n = (unsigned)(j_hi - j_lo);
      adds = atomicInc(&o.counter[((long long)b * gridDim.x + ct) *
                                      kConsumers + warp], n) == n;
    }
    if (__shfl_sync(0xffffffffu, adds, 0)) {
      __threadfence();
      const int gc = c0 + cw + lane;
      if (gc < C) {
        float sm = 0.0f;
        for (int j = j_lo; j <= j_hi; ++j) {
          const int bj = (int)((long long)j * rows_pb / P);  // its first
          sm += __ldcg(&o.part[((long long)j * o.slots + (b - bj)) * o.cpad +
                               gc]);
        }
        o.out[(long long)b * C + gc] = sm / (float)P;
      }
    }
  };

  // act(s) of 16 rows (first row n0) into the running sums, row g before
  // row g + 8; where an image ends inside the 16 rows, its rows are split
  // off and flushed
  auto take_rows = [&](float (&acc)[kNT][4], int n0) {
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = fwd::act<ACT>(acc[n][e]);
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
        const int r = g + 8 * h;
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
      next_b = b_cur == B - 1 ? INT_MAX : next_b + P;
      lo = max(lim, 0);
    }
  };

  // K split: this slice's s into the tile's partials; whether this warp is
  // the last of its tile's ks, and then s summed over the slices in order
  auto gather = [&](float (&acc)[MT][kNT][4]) {
    const long long tile = (long long)blockIdx.y * gridDim.x + ct;
    const long long slice = (long long)kConsumers * TP * 32;
    float* base = o.spart + tile * ks * slice + warp * TP * 32;
    float4* mine = reinterpret_cast<float4*>(base + z * slice);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        mine[(m * kNT + n) * 32 + lane] =
            make_float4(acc[m][n][0], acc[m][n][1], acc[m][n][2],
                        acc[m][n][3]);
    __threadfence();
    __syncwarp();
    int adds = 0;
    if (lane == 0)
      adds = atomicInc(&o.kcounter[tile * kConsumers + warp],
                       (unsigned)(ks - 1)) == (unsigned)(ks - 1);
    if (!__shfl_sync(0xffffffffu, adds, 0)) return false;
    __threadfence();
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
    for (int zz = 0; zz < ks; ++zz) {
      const float4* p = reinterpret_cast<const float4*>(base + zz * slice);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const float4 v = __ldcg(p + (m * kNT + n) * 32 + lane);
          acc[m][n][0] += v.x;
          acc[m][n][1] += v.y;
          acc[m][n][2] += v.z;
          acc[m][n][3] += v.w;
        }
    }
    return true;
  };

  float acc[MT][kNT][4];
  bool active = true;  // this warp takes its tiles' activation
  int i = 0;
  for (int item = first; item < last; ++item) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
    for (int kc = 0; kc < nkc; ++kc, ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const float* xs = ring + s * SB;
      const float* ws = RESIDENT ? wres + (kc_lo + kc) * kChunk * kTileC
                                 : xs + TP * kChunk;
      const int klen = K - (kc_lo + kc) * kChunk;  // k's of it inside K
#pragma unroll
      for (int k8 = 0; k8 < kChunk; k8 += 8) {
        if (k8 >= klen) break;  // the rest is padding (warp-uniform)
        FragB fb[kNT];
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          load_b(fb[n], ws, kTileC, k8, cw + n * 8, g, q);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          FragA fa;
          ldsm_a(fa, xs, kChunk, m * 16, k8, lane);
          mma3_row(acc[m], fa, fb);
        }
      }
      // the chunk is read: its buffer may refill
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (ks > 1) active = gather(acc);
    if (active) {
#pragma unroll
      for (int m = 0; m < MT; ++m) take_rows(acc[m], item * TP + m * 16);
    }
  }
  if (active) flush(b_cur);
}

// W resident takes 16-row tiles, W streamed 64-row tiles
template <typename F>
cudaError_t for_kernel(int act, int tp, int mode, F&& f) {
  auto by_tile = [&](auto act_c) -> cudaError_t {
    constexpr int A = decltype(act_c)::value;
    if (mode == kResident && tp == 16)
      return f(token_head_fwd_tf32x3_kernel<A, 16, true>);
    if (mode == kStreamed && tp == 64)
      return f(token_head_fwd_tf32x3_kernel<A, 64, false>);
    return cudaErrorInvalidValue;
  };
  switch (act) {
    case kSerf: return by_tile(std::integral_constant<int, kSerf>());
    case kSerfFast: return by_tile(std::integral_constant<int, kSerfFast>());
    case kRelu: return by_tile(std::integral_constant<int, kRelu>());
  }
  return cudaErrorInvalidValue;
}

// The shared memory each (act, mode) variant may use, raised and never
// lowered, as fwd::grant_smem
static int granted[3][2];

template <typename Kern>
cudaError_t grant_smem(Kern kern, int act, int mode, int smem) {
  int& have = granted[act][mode];
  if (smem <= have) return cudaSuccess;
  cudaError_t err = allow_smem(kern, smem);
  if (err == cudaSuccess) have = smem;
  return err;
}

}  // namespace fwd32
}  // namespace k1
}  // namespace mmvqa

extern "C" const char* mmvqa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
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

// Blocks of the fp32 forward for (act, tp, mode) an SM holds at once with
// `smem` bytes of shared memory: the plan fills one wave of them.
extern "C" int token_head_fwd_tf32x3_occupancy(int act, int tp, int mode,
                                               int smem, int* blocks) {
  using namespace mmvqa::k1;
  using namespace mmvqa::k1::fwd32;
  return static_cast<int>(for_kernel(act, tp, mode, [&](auto kern) {
    cudaError_t err = grant_smem(kern, act, mode, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                         kThreads, smem);
  }));
}

// fp32: x (B, P, K) by element strides; w (K, C) contiguous; part
// (nblocks, slots, ceil(C / 128) * 128) fp32 scratch; out (B, C); counter
// (B + nblocks) * ceil(C / 128) * 4 unsigned ints, zero on entry and on
// exit, one buffer a stream; spart, where ks > 1, (nblocks, ceil(C / 128),
// ks, tp * 128) fp32 scratch. The plan (ops/token_head.py::
// fp32_forward_plan): tp rows a tile (32 where W is resident, 64 where it
// streams), per_block tiles a block, nblocks blocks along the rows with
// none empty, mode (fwd32::Mode), slots the images a block spans at most,
// smem bytes, ks slices of K (ks > 1: W streamed, one tile a block, each
// slice at least one 32-k chunk).
extern "C" int token_head_fwd_tf32x3(const void* x, long long sb,
                                     long long sp, long long sk,
                                     const void* w, void* part, void* out,
                                     void* counter, void* spart, int B,
                                     int P, int K, int C, int act, int tp,
                                     int per_block, int nblocks, int mode,
                                     int slots, int smem, int ks,
                                     void* stream) {
  using namespace mmvqa;
  using namespace mmvqa::k1;
  using namespace mmvqa::k1::fwd32;
  const long long N = (long long)B * P;
  const long long items = tp > 0 ? (N + tp - 1) / tp : 0;
  const int ctiles = (C + kTileC - 1) / kTileC;
  const long long rows_pb = (long long)per_block * tp;
  if (B < 1 || P < 1 || K < 1 || C < 1 || N >= (1ll << 31) || tp < 1 ||
      per_block < 1 || (mode == kResident && kpad(K) > kResidentK) ||
      smem != smem_bytes(tp, K, mode == kResident) || nblocks < 1 ||
      nblocks > 65535 || (long long)nblocks * per_block < items ||
      (long long)(nblocks - 1) * per_block >= items ||
      slots < (B < (rows_pb - 1) / P + 2 ? B : (rows_pb - 1) / P + 2) ||
      ks < 1 || ks > (K + kChunk - 1) / kChunk ||
      (ks > 1 && (mode != kStreamed || per_block != 1 || spart == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool xvec = sk == 1 && K % 4 == 0 && sp % 4 == 0 && sb % 4 == 0 &&
                    reinterpret_cast<size_t>(x) % 16 == 0;
  const bool wvec = C % 4 == 0 && reinterpret_cast<size_t>(w) % 16 == 0;
  const tf32::Positions xsrc{static_cast<const float*>(x), sb, sp, sk, P,
                             (int)N, K, xvec};
  const tf32::Dense wsrc{static_cast<const float*>(w), C, 1, K, C, wvec};
  auto* counters = static_cast<unsigned*>(counter);
  fwd32::Out o{static_cast<float*>(out),
               static_cast<float*>(part),
               counters,
               counters + (long long)B * ctiles * kConsumers,
               static_cast<float*>(spart),
               per_block,
               slots,
               ctiles * kTileC};
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(for_kernel(act, tp, mode, [&](auto kern) {
    cudaError_t err = grant_smem(kern, act, mode, smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3(ctiles, nblocks, ks), kThreads, smem, st>>>(xsrc, wsrc, o, B,
                                                            P, K, C);
    return cudaGetLastError();
  }));
}
