// K1 backward: gradients of out[b, c] = mean_p act(x[b, p, :] . W[:, c]).
//
// Replaces the TPU kernel mmvqa_tpu/ops/pallas_token_head.py::_bwd_kernel
// (_bwd_call, pallas_call at :273; the custom VJP of fused_token_head).
//
//   s    = x W                       recomputed per tile, fp32 sums
//   gact = act'(s) * g[b, c] / P     fp32, then rounded to x's dtype, as the
//                                    TPU kernel does (GACT_MM = "input")
//   dx   = gact W^T                  (B, P, K), x's dtype, through dx's strides
//   dW   = sum_{b, p} x^T gact       (K, C), fp32
//
// Like the forward it writes no (B, P, C) array, but for fp32's tiles mode
// at the deep taps, whose gact is small. Positions are taken as one axis of
// B * P rows: a tile of rows may straddle two images, so that the small maps
// (P = 49, 196) waste no padded tile per image.
//
// What bounds it on an H100: operations. At the flagship stage-0 tap (B=128,
// P=112*112, K=24, C=768) the three products are 29.6 G multiply-adds each
// and act' is taken 1.2 G times (the bf16 path's polynomial SERF: an exp and
// a reciprocal on the special-function units, two an element, which is the
// bound), against 77 MB of x read and 77 MB of dx written in bf16. In fp32
// the products run as three TF32 products on the tensor cores (165 TFLOP/s
// of fp32 products, csrc/tf32x3.cuh) and exact SERF's derivative takes six
// special functions an element (at 4.18 T/s); those bound stage 0 (0.22 ms
// against 0.13 for the products at B=16), the products the deeper taps.
//
// bf16: the three products on the tensor cores (mma.sync m16n8k16, fp32
// sums, fragments by ldmatrix). A block of 512 threads owns tiles of TP rows
// (64, or 32 and 16 where C or W needs the room) and all C channels; per
// tile it
//   1. computes s for 128 channels at a time from x and W, 32 k's at a time
//      (K padded to 16 with zeros), turns it into gact in the accumulator
//      fragments and parks gact, bf16, for all C in shared memory;
//   2. computes dx 32 k's at a time, summing over all C in registers: each
//      dx element is written once, for any K;
//   3. adds x^T gact into dW: each warp holds a 32 x 48 tile of dW in
//      registers. Where K <= 32 and C <= 768 (stage 0) one pass of the 16
//      warps covers dW and the tile stays in registers across all of the
//      block's row tiles; otherwise each pass reads and writes the block's
//      fp32 partial of dW.
// x and W arrive by cp.async (16-byte copies where rows are 16-byte aligned,
// element copies where not). Where W fits in shared memory beside gact (the
// narrow taps: at hidden 768, K up to 64 with 64 rows, up to 96 with 32), it
// is staged once and a tile's x, all of K, is one stage of a ring of two, a
// tile ahead: three barriers a tile. Otherwise x and W stream through a ring
// of six stages, five ahead, in 32-k chunks: (x, W) chunks for s, W chunks
// for dx, x chunks for dW. The ring runs on across the block's tiles.
//
// fp32 (k1::bwd::f32): gact stays fp32, as the plain version keeps it, and
// the three products are split-TF32 products on the tensor cores; 256
// threads a block, launched cooperatively; two modes by K alone
// (ops/token_head.py::backward_tile):
//   rows (K <= 96, stages 0-2): a block walks its share of the row tiles
//     once for each 128-channel tile, with W's K x 128 tile staged once per
//     channel tile: s, gact into shared memory, dx added into dx itself
//     (the block's own rows), dW for the channel tile held in registers
//     across the block's row tiles and written to the block's (K, C)
//     partial, which the blocks add after a grid barrier. At stage 0 K = 24
//     makes that partial 74 KB: the sum costs microseconds.
//   tiles (K > 96, stages 4 and 6): few rows and a wide K, where the row
//     tiles alone cannot fill the card (stage 6 at B=16 has 13 of 64 rows)
//     and a (K, C) partial a block would cost more than the products (1.5 MB
//     each at stage 6). gact goes to device memory (2.4 MB at stage 6,
//     B=16: it stays in the L2 cache), and after a grid barrier every 64 x
//     64 tile of dW (over the rows) and of dx (over the channels) is summed
//     whole by one block; dW's rows are cut into segments, added after a
//     second barrier, only where its tiles would be few and long.
//
// dW across blocks (bf16; fp32's rows mode): a block's partial is (K, C)
// fp32; the blocks are launched cooperatively, so that all of them are
// resident at once, meet at a barrier of two counters (arrivals,
// departures; both back at 0 when the kernel ends), and then each sums a
// share of dW's entries over the partials in block order. No float atomics:
// two runs give identical bits. One barrier buffer a (device, stream): the
// wrapper owns them (two barriers' counters, for fp32's tiles mode).
//
// x is read, and dx written, by strides, so the trunk's channels-last map
// and its gradient go through as views with no transposing copy.
#include "tf32x3.cuh"
#include "token_head_tile.cuh"

namespace mmvqa {
namespace k1 {
namespace bwd {

// derivative of the activation (mmvqa_tpu/ops/pallas_token_head.py::_act_grad)
template <int ACT>
__device__ __forceinline__ float act_grad(float s) {
  if (ACT == kSerf) {
    // the special-function unit's exp and log (errors of a few ulps, and
    // 2^-21 absolute for the log near 1: far inside the gradients'
    // tolerances, which hold sums of these terms to 1e-4), erf in full
    // sigmoid(s) = e / (1 + e) from the same e (1 to fp32 where s >= 50)
    const float e = __expf(fminf(s, 50.0f));
    const float y = __logf(1.0f + e);
    const float sig = __fdividef(e, 1.0f + e);
    // 2 / sqrt(pi)
    return erff(y) + s * 1.1283791670955126f * __expf(-y * y) * sig;
  } else if (ACT == kSerfFast) {
    // x * sigmoid(p5(x)) with ops/activations.py::SERF_P5
    constexpr float c0 = 4.743144768698157e-04f, c1 = 9.427917061937980e-03f,
                    c2 = 7.255023041520858e-02f, c3 = 2.832661920672991e-01f,
                    c4 = 1.605305418315285e+00f, c5 = 7.293287033146151e-01f;
    const float q = ((((c0 * s + c1) * s + c2) * s + c3) * s + c4) * s + c5;
    const float dq =
        (((5.0f * c0 * s + 4.0f * c1) * s + 3.0f * c2) * s + 2.0f * c3) * s + c4;
    // the fast exp and divide (about 2 ulps each): this is the bf16
    // activation, and its two special functions are the kernel's bound
    const float gate = __fdividef(1.0f, 1.0f + __expf(-q));
    return gate + s * gate * (1.0f - gate) * dq;
  } else {
    return s > 0.0f ? 1.0f : 0.0f;
  }
}

// ---------------------------------------------------------------- dW tail

// All blocks of the cooperative launch meet here. bar[0] counts arrivals;
// bar[1] counts departures with atomicInc, which wraps to 0 at the last one,
// and that last block sets bar[0] back to 0 (every other block has left the
// wait by then). A wait beyond about a minute traps instead of hanging.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned nblocks) {
  __threadfence();  // this thread's partial entries, device-wide
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(&bar[0], 1u);
    const long long t0 = clock64();
    while (*static_cast<volatile unsigned*>(&bar[0]) < nblocks) {
      __nanosleep(128);
      if (clock64() - t0 > (1ll << 37)) __trap();
    }
    __threadfence();
    if (atomicInc(&bar[1], nblocks - 1) == nblocks - 1) atomicExch(&bar[0], 0u);
  }
  __syncthreads();
}

// dw[i] = sum over blocks j of part[j][i], in a fixed order: the partials in
// groups of kSumGroup, each group summed in block order and the groups
// added in order, so that kSumGroup loads are in flight at once (a small
// grid has few threads to wait on device memory with). The grid's threads
// share the K * C entries.
constexpr int kSumGroup = 8;

__device__ __forceinline__ void sum_partials(const float* __restrict__ part,
                                             float* __restrict__ dw,
                                             long long n, int nblocks) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n % 4 == 0) {
    const long long n4 = n / 4;
    const float4* p4 = reinterpret_cast<const float4*>(part);
    for (long long i = first; i < n4; i += stride) {
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j0 = 0; j0 < nblocks; j0 += kSumGroup) {
        float4 v[kSumGroup];
#pragma unroll
        for (int j = 0; j < kSumGroup; ++j)
          v[j] = j0 + j < nblocks ? __ldcg(&p4[(long long)(j0 + j) * n4 + i])
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float4 t = v[0];
#pragma unroll
        for (int j = 1; j < kSumGroup; ++j) {
          t.x += v[j].x;
          t.y += v[j].y;
          t.z += v[j].z;
          t.w += v[j].w;
        }
        s.x += t.x;
        s.y += t.y;
        s.z += t.z;
        s.w += t.w;
      }
      reinterpret_cast<float4*>(dw)[i] = s;
    }
  } else {
    for (long long i = first; i < n; i += stride) {
      float s = 0.0f;
      for (int j0 = 0; j0 < nblocks; j0 += kSumGroup) {
        float v[kSumGroup];
#pragma unroll
        for (int j = 0; j < kSumGroup; ++j)
          v[j] = j0 + j < nblocks ? __ldcg(&part[(long long)(j0 + j) * n + i])
                                  : 0.0f;
        float t = v[0];
#pragma unroll
        for (int j = 1; j < kSumGroup; ++j) t += v[j];
        s += t;
      }
      dw[i] = s;
    }
  }
}

// ------------------------------------------------------- bf16: tensor cores

constexpr int kMmaThreads = 512;     // a block of the bf16 kernel: 16 warps
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kDwWarpC = 48;         // dW channels a warp holds in a pass
constexpr int kDwPassC = kMmaWarps * kDwWarpC;

// bf16 row stride of the parked gact: every 128-channel tile, and 16 bytes
// more, so that ldmatrix's eight rows fall on distinct banks
__host__ __device__ inline int gact_row(int C) {
  return (C + kChunkC - 1) / kChunkC * kChunkC + 8;
}

constexpr int kRing = 6;  // stages of the streamed mode's ring

// g / P of the (at most) two images a row tile spans, cached in shared
// memory: a row of C floats each, C in 4s
__host__ __device__ inline int g_cache_floats(int C) {
  return 2 * ((C + 3) / 4 * 4);
}

// Shared memory of the bf16 kernel: gact for every channel, then either W
// whole and a ring of two x tiles (resident) or a ring of kRing (x chunk, W
// chunk) stages (streamed), then each row's dx offset and image, then the g
// cache.
__host__ __device__ inline int mma_smem_bytes(int tp, int K, int C,
                                              int resident) {
  const int ring = resident
                       ? resident_k(K) * gact_row(C) +
                             2 * tp * (resident_k(K) + 8)
                       : kRing * (tp * kXRow + kChunkK * kWRow);
  return 2 * (tp * gact_row(C) + ring) + tp * (8 + 4) + 4 * g_cache_floats(C);
}

// Warp layouts of the three products for a tile of TP rows.
template <int TP>
struct Layout {
  // s: TP x 128 channels; a warp holds one m16 row of SNT fragments; warps
  // past SWM * SWN idle (TP = 16)
  static constexpr int SWM = TP / 16;
  static constexpr int SWN = kMmaWarps / SWM < 16 ? kMmaWarps / SWM : 16;
  static constexpr int SNT = kChunkC / 8 / SWN;
  // dx: TP x 32 k's; a warp holds one m16 x n8 fragment; warps past
  // DWM * DWN idle
  static constexpr int DWM = TP / 16;
  static constexpr int DWN = kChunkK / 8;
  static_assert(SNT == 1 || SNT % 2 == 0, "layout");
};

// The streamed mode's stage i: x and/or W chunks into ring buffer i % kRing.
struct Stage {
  int item, phase, a, b;  // phase 0: s (cc, kc); 1: dx (kd, cc); 2: dW (kt)
};

__device__ __forceinline__ Stage decode(int i, int first, int n_cc,
                                        int n_kc) {
  const int per_item = 2 * n_cc * n_kc + n_kc;
  Stage s;
  s.item = first + i / per_item;
  int l = i % per_item;
  if (l < n_cc * n_kc) {
    s.phase = 0;
    s.a = l / n_kc;  // cc
    s.b = l % n_kc;  // kc
    return s;
  }
  l -= n_cc * n_kc;
  if (l < n_cc * n_kc) {
    s.phase = 1;
    s.a = l / n_cc;  // kd
    s.b = l % n_cc;  // cc
    return s;
  }
  s.phase = 2;
  s.a = l - n_cc * n_kc;  // kt
  s.b = 0;
  return s;
}

// grid (nblocks), block kMmaThreads, launched cooperatively. Block j takes
// the row tiles [j * items_per_block, ...) of the ceil(B * P / TP) tiles.
// RESIDENT: W whole in shared memory, staged once, and each row tile's x
// (all K) one stage; else W and x stream through the ring in 32-k chunks.
template <int TP, int ACT, bool RESIDENT>
__global__ void __launch_bounds__(kMmaThreads, 1)
    token_head_bwd_mma_kernel(Args a, int vec_x, int vec_w) {
  using L = Layout<TP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldg = gact_row(a.C);
  const int kr = resident_k(a.K);
  const int xld = RESIDENT ? kr + 8 : kXRow;  // row stride of a staged x
  const int xbuf = TP * xld;
  const int sbuf = RESIDENT ? xbuf : xbuf + kChunkK * kWRow;
  const int nbuf = RESIDENT ? 2 : kRing;
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* wres = gs + TP * ldg;  // resident W, kr x ldg
  __nv_bfloat16* ring = RESIDENT ? wres + kr * ldg : wres;
  long long* dxoff = reinterpret_cast<long long*>(ring + nbuf * sbuf);
  int* brow = reinterpret_cast<int*>(dxoff + TP);
  float* gcache = reinterpret_cast<float*>(brow + TP);
  const int c4 = g_cache_floats(a.C) / 2;
  // the first image in gcache, and whether this tile's rows lie in its two
  // (every thread holds the same values)
  int gimg = -1;
  bool gcached = false;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int lr = lane / 4, lc = (lane % 4) * 2;  // accumulator row, column
  const int N = a.B * a.P;
  const int n_items = (N + TP - 1) / TP;
  const int first = blockIdx.x * a.items_per_block;
  const int last = min(n_items, first + a.items_per_block);
  const int n_cc = (a.C + kChunkC - 1) / kChunkC;
  const int n_kc = kr / kChunkK;
  const int n_cr = (a.C + kDwPassC - 1) / kDwPassC;
  // stage 0 holds all of dW: keep it in registers across the block's tiles
  const bool dw_resident = n_kc == 1 && n_cr == 1;
  const int per_item = RESIDENT ? 1 : 2 * n_cc * n_kc + n_kc;
  const int stages = (last - first) * per_item;
  const float inv_p = 1.0f / (float)a.P;
  float* mypart = a.part + (long long)blockIdx.x * a.K * a.C;

  float sacc[L::SNT][4];
  // dx sums over C in kDxChains independent chains of products, added at
  // the end: one chain would wait on each product before the next
  constexpr int kDxChains = 4;
  float dacc[kDxChains][4];
#pragma unroll
  for (int j = 0; j < kDxChains; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dacc[j][e] = 0.0f;
  float wacc[2][kDwWarpC / 8][4];
#pragma unroll
  for (int n = 0; n < L::SNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[n][e] = 0.0f;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < kDwWarpC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) wacc[m][n][e] = 0.0f;

  // ---- the three products, on staged tiles wherever they lie

  // s[TP, 128 channels of tile cc] += x[TP, 32] W[32, 128]: x at column xk
  // of xs; W at row wk, column wc of ws (row stride wld); k0 the absolute k
  const int wm = warp / L::SWN, wn = warp % L::SWN;
  auto s_mma = [&](float (&acc)[L::SNT][4], const __nv_bfloat16* xs, int xk,
                   const __nv_bfloat16* ws, int wld, int wk, int wc, int k0) {
    if (wm >= L::SWM) return;
#pragma unroll
    for (int ks = 0; ks < kChunkK / 16; ++ks) {
      if (k0 + ks * 16 >= a.K) break;
      unsigned af[4];
      ldsm_x4(af, xs + (wm * 16 + lane % 16) * xld + xk + ks * 16 +
                      (lane / 16) * 8);
      const __nv_bfloat16* wrow =
          ws + (wk + ks * 16 + lane % 16) * wld + wc + wn * L::SNT * 8;
      if constexpr (L::SNT == 1) {
        unsigned b0, b1;
        ldsm_x2_t(b0, b1, wrow);
        mma(acc[0], af, b0, b1);
      } else {
#pragma unroll
        for (int n = 0; n < L::SNT; n += 2) {
          unsigned bf[4];
          ldsm_x4_t(bf, wrow + n * 8 + (lane / 16) * 8);
          mma(acc[n], af, bf[0], bf[1]);
          mma(acc[n + 1], af, bf[2], bf[3]);
        }
      }
    }
  };

  // gact = act'(s) g / P, zero past the rows and channels, rounded to bf16
  // and parked for channel tile cc
  auto s_epilogue = [&](float (&acc)[L::SNT][4], int item, int cc) {
    if (wm >= L::SWM) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 16 + h * 8 + lr;
      const bool in = item * TP + r < N;
      // g / P from the cache, or from g where the tile spans more images
      const float* gsm = gcache + (brow[r] - gimg) * c4;
      const float* ggl = a.g + (long long)brow[r] * a.C;
#pragma unroll
      for (int nt = 0; nt < L::SNT; ++nt) {
        const int c = cc * kChunkC + wn * L::SNT * 8 + nt * 8 + lc;
        float g0 = 0.0f, g1 = 0.0f;
        if (gcached) {
          if (in && c < a.C) g0 = gsm[c];
          if (in && c + 1 < a.C) g1 = gsm[c + 1];
        } else {
          if (in && c < a.C) g0 = __ldg(ggl + c) * inv_p;
          if (in && c + 1 < a.C) g1 = __ldg(ggl + c + 1) * inv_p;
        }
        const float v0 = act_grad<ACT>(acc[nt][2 * h]) * g0;
        const float v1 = act_grad<ACT>(acc[nt][2 * h + 1]) * g1;
        *reinterpret_cast<__nv_bfloat162*>(gs + r * ldg + c) =
            __floats2bfloat162_rn(v0, v1);
        acc[nt][2 * h] = acc[nt][2 * h + 1] = 0.0f;
      }
    }
  };

  // dx[TP, 32 k's of chunk kd] += gact[TP, c0 .. c0 + 128] W[.., ..]^T: W's
  // rows at wk, its column c0 at wc of ws (row stride wld); a warp one m16 x
  // n8 fragment
  const int dwm = warp / L::DWN, dwn = warp % L::DWN;
  auto dx_mma = [&](const __nv_bfloat16* ws, int wld, int wk, int wc, int c0,
                    int kd) {
    if (dwm >= L::DWM || kd * kChunkK + dwn * 8 >= a.K) return;
#pragma unroll
    for (int cs = 0; cs < kChunkC / 16; ++cs) {
      const int c = c0 + cs * 16;
      if (c >= a.C) break;
      unsigned af[4], b0, b1;
      ldsm_x4(af, gs + (dwm * 16 + lane % 16) * ldg + c + (lane / 16) * 8);
      ldsm_x2(b0, b1, ws + (wk + dwn * 8 + lane % 8) * wld + wc + cs * 16 +
                          ((lane / 8) % 2) * 8);
      mma(dacc[cs % kDxChains], af, b0, b1);
    }
  };

  // every channel is in: write dx of chunk kd once, through its strides
  auto dx_store = [&](int item, int kd) {
    if (dwm >= L::DWM) return;
#pragma unroll
    for (int j = 1; j < kDxChains; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dacc[0][e] += dacc[j][e];
        dacc[j][e] = 0.0f;
      }
    __nv_bfloat16* dx = static_cast<__nv_bfloat16*>(a.dx);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = dwm * 16 + h * 8 + lr;
      if (item * TP + r < N) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = kd * kChunkK + dwn * 8 + lc + e;
          if (k < a.K)
            dx[dxoff[r] + (long long)k * a.dsk] =
                __float2bfloat16(dacc[0][2 * h + e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) dacc[0][e] = 0.0f;
  };

  // A pass of dW: rows [32 kt, + 32), channels [768 cr, + 768), each warp 48
  // of them. Away from stage 0 its tile comes from the block's partial
  // (zero on the block's first row tile) and goes back to it; float pairs
  // where C is even.
  const bool pairs = a.C % 2 == 0;
  auto load_pass = [&](int item, int kt, int cr) {
    const int cw = cr * kDwPassC + warp * kDwWarpC;
    const bool fresh = item == first;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = kt * kChunkK + m * 16 + h * 8 + lr;
#pragma unroll
        for (int nt = 0; nt < kDwWarpC / 8; ++nt) {
          const int c = cw + nt * 8 + lc;
          const float* src = mypart + (long long)k * a.C + c;
          float2 v = make_float2(0.0f, 0.0f);
          if (!fresh && k < a.K && c < a.C) {
            if (pairs) {
              v = *reinterpret_cast<const float2*>(src);
            } else {
              v.x = src[0];
              v.y = c + 1 < a.C ? src[1] : 0.0f;
            }
          }
          wacc[m][nt][2 * h] = v.x;
          wacc[m][nt][2 * h + 1] = v.y;
        }
      }
  };
  auto store_pass = [&](int kt, int cr) {
    const int cw = cr * kDwPassC + warp * kDwWarpC;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = kt * kChunkK + m * 16 + h * 8 + lr;
#pragma unroll
        for (int nt = 0; nt < kDwWarpC / 8; ++nt) {
          const int c = cw + nt * 8 + lc;
          float* dst = mypart + (long long)k * a.C + c;
          if (k < a.K && c < a.C) {
            if (pairs) {
              *reinterpret_cast<float2*>(dst) =
                  make_float2(wacc[m][nt][2 * h], wacc[m][nt][2 * h + 1]);
            } else {
              dst[0] = wacc[m][nt][2 * h];
              if (c + 1 < a.C) dst[1] = wacc[m][nt][2 * h + 1];
            }
          }
        }
      }
  };

  // dW[32 k's of chunk kt, all C] += x^T gact; x's chunk at column xk of xs.
  // With W resident the first pass of a tile is loaded ahead
  // (preload_pass), so that its latency hides behind the s and dx products.
  auto preload_pass = [&](int item) {
    if (!dw_resident) load_pass(item, 0, 0);
  };
  auto dw_passes = [&](int item, const __nv_bfloat16* xs, int xk, int kt) {
    const int kt0 = kt * kChunkK;
    for (int cr = 0; cr < n_cr; ++cr) {
      const int cw = cr * kDwPassC + warp * kDwWarpC;
      if (!dw_resident && (kt > 0 || cr > 0 || !RESIDENT))
        load_pass(item, kt, cr);
      if (cw < a.C) {
#pragma unroll
        for (int ps = 0; ps < TP / 16; ++ps) {
          unsigned af[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
            ldsm_x4_t(af[m], xs + (ps * 16 + (lane / 16) * 8 + lane % 8) * xld +
                                 xk + m * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
          for (int nt = 0; nt < kDwWarpC / 8; nt += 2) {
            if (cw + nt * 8 >= a.C) break;
            unsigned bf[4];
            ldsm_x4_t(bf, gs + (ps * 16 + lane % 16) * ldg + cw + nt * 8 +
                              (lane / 16) * 8);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              if (kt0 + m * 16 >= a.K) break;
              mma(wacc[m][nt], af[m], bf[0], bf[1]);
              mma(wacc[m][nt + 1], af[m], bf[2], bf[3]);
            }
          }
        }
      }
      if (!dw_resident || item == last - 1) store_pass(kt, cr);
    }
  };

  // each row's dx offset and image, and g / P of the tile's images, for
  // the tile that starts now (the previous tile's last barrier has ended
  // its use of them; the caller's next barrier publishes them)
  auto fill_rows = [&](int item) {
    const int b_first = item * TP / a.P;
    const int b_last = (min(N, item * TP + TP) - 1) / a.P;
    if (threadIdx.x < TP) {
      const int n = item * TP + threadIdx.x;
      const bool in = n < N;
      dxoff[threadIdx.x] = in ? row_offset(n, a.P, a.dsb, a.dsp) : 0;
      brow[threadIdx.x] = in ? n / a.P : b_last;
    }
    gcached = b_last - b_first <= 1;
    if (gcached && b_first != gimg) {
      for (int i = threadIdx.x; i < 2 * a.C; i += kMmaThreads) {
        const int j = i / a.C, c = i % a.C;
        gcache[j * c4 + c] =
            b_first + j < a.B ? a.g[(long long)(b_first + j) * a.C + c] * inv_p
                              : 0.0f;
      }
      gimg = b_first;
    }
  };

  if constexpr (RESIDENT) {
    // W once; then one stage a row tile: its x, all K, one tile ahead
    stage_w(a, wres, ldg, 0, kr, 0, n_cc * kChunkC, vec_w, threadIdx.x,
            kMmaThreads);
    auto issue = [&](int i) {
      if (i < stages)
        stage_x<TP>(a, ring + (i % 2) * sbuf, xld, first + i, 0, kr, vec_x,
                    threadIdx.x, kMmaThreads);
      commit();
    };
    issue(0);
    for (int i = 0; i < stages; ++i) {
      const int item = first + i;
      issue(i + 1);
      wait_groups<1>();
      fill_rows(item);
      __syncthreads();  // this tile's x (and W) and its rows are in
      preload_pass(item);
      const __nv_bfloat16* xs = ring + (i % 2) * sbuf;
      for (int cc = 0; cc < n_cc; ++cc) {
        for (int kc = 0; kc < n_kc; ++kc)
          s_mma(sacc, xs, kc * kChunkK, wres, ldg, kc * kChunkK, cc * kChunkC,
                kc * kChunkK);
        s_epilogue(sacc, item, cc);
      }
      __syncthreads();  // gact is parked for every channel
      for (int kd = 0; kd < n_kc; ++kd) {
        for (int cc = 0; cc < n_cc; ++cc)
          dx_mma(wres, ldg, kd * kChunkK, cc * kChunkC, cc * kChunkC, kd);
        dx_store(item, kd);
      }
      for (int kt = 0; kt < n_kc; ++kt) dw_passes(item, xs, kt * kChunkK, kt);
      __syncthreads();  // this tile's x consumed: its buffer may be refilled
    }
  } else {
    auto issue = [&](int i) {
      if (i < stages) {
        const Stage st = decode(i, first, n_cc, n_kc);
        __nv_bfloat16* xs = ring + (i % kRing) * sbuf;
        __nv_bfloat16* ws = xs + xbuf;
        if (st.phase == 0) {
          stage_x<TP>(a, xs, kXRow, st.item, st.b * kChunkK, kChunkK, vec_x,
                      threadIdx.x, kMmaThreads);
          stage_w(a, ws, kWRow, st.b * kChunkK, kChunkK, st.a * kChunkC,
                  kChunkC, vec_w, threadIdx.x, kMmaThreads);
        } else if (st.phase == 1) {
          stage_w(a, ws, kWRow, st.a * kChunkK, kChunkK, st.b * kChunkC,
                  kChunkC, vec_w, threadIdx.x, kMmaThreads);
        } else {
          stage_x<TP>(a, xs, kXRow, st.item, st.a * kChunkK, kChunkK, vec_x,
                      threadIdx.x, kMmaThreads);
        }
      }
      commit();
    };
    for (int i = 0; i < kRing - 1; ++i) issue(i);
    for (int i = 0; i < stages; ++i) {
      const Stage st = decode(i, first, n_cc, n_kc);
      issue(i + kRing - 1);  // into the buffer stage i - 1 left
      wait_groups<kRing - 1>();
      if (i % per_item == 0) fill_rows(st.item);
      __syncthreads();  // stage i is in; the element copies too
      const __nv_bfloat16* xs = ring + (i % kRing) * sbuf;
      const __nv_bfloat16* ws = xs + xbuf;
      if (st.phase == 0) {
        s_mma(sacc, xs, 0, ws, kWRow, 0, 0, st.b * kChunkK);
        if (st.b == n_kc - 1) s_epilogue(sacc, st.item, st.a);
      } else if (st.phase == 1) {
        dx_mma(ws, kWRow, 0, 0, st.b * kChunkC, st.a);
        if (st.b == n_cc - 1) dx_store(st.item, st.a);
      } else {
        dw_passes(st.item, xs, 0, st.a);
      }
      __syncthreads();  // stage i consumed: its buffer may be refilled
    }
  }
  wait_groups<0>();

  grid_barrier(a.bar, gridDim.x);
  sum_partials(a.part, a.dw, (long long)a.K * a.C, gridDim.x);
}

// ------------------------------------------------------ fp32: tensor cores
//
// Both modes run the three products as split-TF32 products on the tensor
// cores (csrc/tf32x3.cuh), gact in fp32 as the plain version keeps it, 256
// threads a block, launched cooperatively.

namespace f32 {

constexpr int kRowsMaxK = 96;  // the rows mode takes K up to this
constexpr int kCT = 128;       // the rows mode's channel tile
constexpr int kTile = 64;      // the tiles mode's output tiles, 64 x 64
constexpr int kStages = 4;     // the tiles mode's ring
enum Mode : int { kRows = 0, kTiles = 1 };

__host__ __device__ inline int kpad(int K) { return (K + 31) / 32 * 32; }

// W's K x 128 channel tile, two x tiles of tp x K, gact's tp x 128 tile (K
// in 32s, fp32)
__host__ __device__ inline int rows_smem_bytes(int tp, int K) {
  return 4 * (kpad(K) * kCT + 2 * tp * kpad(K) + tp * kCT);
}
// the ring of (64 x 32, 32 x 64) chunk pairs
__host__ __device__ inline int tiles_smem_bytes() {
  return 4 * kStages * 2 * kTile * tf32::kChunk;
}

// The rows mode (K <= 96: the taps with many positions and few channels).
// Block j takes the row tiles [j * n / nblocks, (j + 1) * n / nblocks) of the
// n = ceil(B * P / 32) tiles and walks them once for each 128-channel tile
// ct, with W's K x 128 tile staged once per ct and each row tile's x (all K)
// staged a tile ahead:
//   s = x W[:, ct] (32 x 128), gact = act'(s) g / P into shared memory;
//   dx += gact W[:, ct]^T (32 x K): written at ct = 0, read and added after
//     (the block owns its rows of dx: fp32, through dx's strides);
//   dW[:, ct] += x^T gact (K x 128), in registers across the block's tiles.
// At the end of a ct the block writes its (K, 128) slice of its (K, C)
// partial; after a grid barrier all blocks add the partials in block order.
// Warps: s 2 x 4 (16 rows x 32 channels each); dx 2 along the rows, the
// n8 columns of K dealt out among the 4 of a row; dW all of K by 16
// channels. KP is K in 32s: it sizes the accumulators, so that two blocks
// fit an SM.
template <int TP, int KP, int ACT>
__global__ void __launch_bounds__(tf32::kThreads, 2)
    token_head_bwd_rows_kernel(Args a, tf32::Positions xsrc, int vec_w) {
  using namespace tf32;
  constexpr int MIS = TP / 32;        // s: m16 tiles a warp
  constexpr int WMX = TP / 16;        // dx: warps along the rows
  constexpr int WNX = 8 / WMX;        // dx: warps sharing a row's columns
  constexpr int DXN = KP / 8 / WNX;   // dx: n8 tiles a warp
  constexpr int DWM = KP / 16;        // dW: m16 tiles a warp
  extern __shared__ __align__(16) float smem[];
  const int N = a.B * a.P, K = a.K, C = a.C;
  float* ws = smem;                // [KP][128]: W rows k
  float* xbuf = ws + KP * kCT;     // 2 x [TP][KP]
  float* gs = xbuf + 2 * TP * KP;  // [TP][128]
  const int n_items = (N + TP - 1) / TP;
  const int first = (int)((long long)blockIdx.x * n_items / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * n_items / gridDim.x);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q = lane % 4;
  const int wms = (warp / 4) * (TP / 2), wns = (warp % 4) * 32;
  const int mx = (warp % WMX) * 16, jx = warp / WMX;
  const float inv_p = 1.0f / (float)a.P;
  const float* w = static_cast<const float*>(a.w);
  float* dx = static_cast<float*>(a.dx);
  const Dense wsrc{w, C, 1, K, C, vec_w != 0};
  float* mypart = a.part + (long long)blockIdx.x * K * C;
  // the k8 steps, n8 tiles and m16 tiles that hold some k < K (K in 32s
  // pads the tiles, not the work: stage 0's K = 24 is three k8 steps)
  const int k8s = (K + 7) / 8 * 8, m16s = (K + 15) / 16;

  for (int c0 = 0; c0 < C; c0 += kCT) {
    float wacc[DWM][2][4];
#pragma unroll
    for (int i = 0; i < DWM; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) wacc[i][j][e] = 0.0f;
    stage(ws, KP, kCT, wsrc, 0, c0, threadIdx.x, kThreads);
    stage(xbuf, TP, KP, xsrc, first * TP, 0, threadIdx.x, kThreads);
    commit();
    for (int it = first; it < last; ++it) {
      const int buf = (it - first) & 1;
      if (it + 1 < last)
        stage(xbuf + (buf ^ 1) * TP * KP, TP, KP, xsrc, (it + 1) * TP, 0,
              threadIdx.x, kThreads);
      commit();
      wait_groups<1>();
      __syncthreads();  // this tile's x (and W) are in
      const float* xs = xbuf + buf * TP * KP;

      // 1. s = x W[:, ct]; 2. gact into shared memory, zero past the rows
      // and channels
      float sacc[MIS][4][4];
#pragma unroll
      for (int i = 0; i < MIS; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[i][j][e] = 0.0f;
#pragma unroll 1
      for (int k0 = 0; k0 < k8s; k0 += 8) {
        FragB fb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) load_b(fb[j], ws, kCT, k0, wns + j * 8, g, q);
#pragma unroll
        for (int i = 0; i < MIS; ++i) {
          FragA fa;
          ldsm_a(fa, xs, KP, wms + i * 16, k0, lane);
          mma3_row_into(sacc[i], fa, fb);
        }
      }
#pragma unroll
      for (int i = 0; i < MIS; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wms + i * 16 + h * 8 + g;
          const int n = it * TP + r;
          const float* grow = a.g + (long long)(n < N ? n / a.P : 0) * C;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = wns + j * 8 + 2 * q;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cc = c0 + c + e;
              v[e] = (n < N && cc < C)
                         ? act_grad<ACT>(sacc[i][j][2 * h + e]) *
                               (__ldg(grow + cc) * inv_p)
                         : 0.0f;
            }
            *reinterpret_cast<float2*>(at(gs, kCT, r, c)) =
                make_float2(v[0], v[1]);
          }
        }
      __syncthreads();  // gact is in

      // 3. dx += gact W[:, ct]^T
      float dacc[DXN][4];
#pragma unroll
      for (int i = 0; i < DXN; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dacc[i][e] = 0.0f;
#pragma unroll 1
      for (int c8 = 0; c8 < kCT; c8 += 8) {
        FragA fa;
        ldsm_a(fa, gs, kCT, mx, c8, lane);
#pragma unroll
        for (int i = 0; i < DXN; ++i) {
          if ((jx + WNX * i) * 8 < K) {  // else all padding (warp-uniform)
            FragB fb;
            ldsm_b1(fb, ws, kCT, c8, (jx + WNX * i) * 8, lane);
            mma3_into(dacc[i], fa, fb);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = it * TP + mx + h * 8 + g;
        if (n >= N) continue;
        float* row = dx + row_offset(n, a.P, a.dsb, a.dsp);
#pragma unroll
        for (int i = 0; i < DXN; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = (jx + WNX * i) * 8 + 2 * q + e;
            if (k < K) {
              float* d = row + (long long)k * a.dsk;
              *d = c0 == 0 ? dacc[i][2 * h + e] : *d + dacc[i][2 * h + e];
            }
          }
      }

      // 4. dW[:, ct] += x^T gact
#pragma unroll 1
      for (int r8 = 0; r8 < TP; r8 += 8) {
        FragB fb[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          load_b(fb[j], gs, kCT, r8, warp * 16 + j * 8, g, q);
#pragma unroll
        for (int i = 0; i < DWM; ++i) {
          if (i < m16s) {
            FragA fa;
            load_a_t(fa, xs, KP, i * 16, r8, g, q);
            mma3_row(wacc[i], fa, fb);
          }
        }
      }
      __syncthreads();  // x, gact and (at the last tile) W are consumed
    }
    // this ct's slice of the block's partial
#pragma unroll
    for (int i = 0; i < DWM; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = i * 16 + h * 8 + g;
          const int c = c0 + warp * 16 + j * 8 + 2 * q;
          if (k < K) {
            if (c < C) mypart[(long long)k * C + c] = wacc[i][j][2 * h];
            if (c + 1 < C)
              mypart[(long long)k * C + c + 1] = wacc[i][j][2 * h + 1];
          }
        }
  }
  wait_groups<0>();

  grid_barrier(a.bar, gridDim.x);
  sum_partials(a.part, a.dw, (long long)K * C, gridDim.x);
}

// The tiles mode (K > 96: the taps with few positions and many channels,
// where the rows alone cannot fill the card and a (K, C) partial a block
// would cost more than the products). Phases with a grid barrier between,
// each a list of 64 x 64 output tiles dealt out to the blocks in turn, each
// tile summed by one block through a ring of 32-deep chunks:
//   A: gact = act'(x W) g / P for a (64 rows, 64 channels) tile, written to
//      `part` as an fp32 (B * P, C) array (at the small taps it stays in
//      the L2 cache: 2.4 MB at stage 6, B=16);
//   B: dW for a (64 k's, 64 channels) tile, summed over the rows
//      (dW = x^T gact), then dx for a (64 rows, 64 k's) tile, summed over
//      every channel (dx = gact W^T), through dx's strides.
// Where dW has too few tiles to share the card with dx, its rows are cut
// into `rsplit` segments (of whole 32-row chunks): each (tile, segment)
// writes its sums after gact in `part`, and a third phase adds the
// segments in order. With rsplit = 1 (stage 6 at B=16) every entry of dx
// and dW is written once, with no partial and no third phase.
template <int ACT>
__global__ void __launch_bounds__(tf32::kThreads, 2)
    token_head_bwd_tiles_kernel(Args a, tf32::Positions xsrc, int vec_w,
                                int rsplit) {
  using namespace tf32;
  extern __shared__ __align__(16) float ring[];
  const int N = a.B * a.P, K = a.K, C = a.C;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 16;
  const float inv_p = 1.0f / (float)a.P;
  const float* w = static_cast<const float*>(a.w);
  float* gact = a.part;
  float* segs = a.part + (long long)N * C;  // [rsplit][K][C] where > 1
  float* dx = static_cast<float*>(a.dx);
  const Dense wsrc{w, C, 1, K, C, vec_w != 0};
  const Dense gsrc{gact, C, 1, N, C, C % 4 == 0};
  const int nr = (N + kTile - 1) / kTile, nc = (C + kTile - 1) / kTile;
  const int nk = (K + kTile - 1) / kTile;
  // rows of a segment: whole chunks
  const int seg_rows =
      ((N + rsplit - 1) / rsplit + kChunk - 1) / kChunk * kChunk;
  float acc[2][2][4];
  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  };
  // (row, column) of accumulator (i, j, e) of this thread, in the tile
  auto rc = [&](int i, int j, int e, int& r, int& c) {
    r = wm + i * 16 + (e / 2) * 8 + g;
    c = wn + j * 8 + 2 * q + e % 2;
  };

  for (int item = blockIdx.x; item < nr * nc; item += gridDim.x) {
    const int r0 = item / nc * kTile, c0 = item % nc * kTile;
    zero();
    product<kTile, kTile, kStages, kOuterRows, kInnerRows, 2>(
        acc, ring, xsrc, r0, 0, wsrc, 0, c0, K);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int r, c;
          rc(i, j, e, r, c);
          const int n = r0 + r, cc = c0 + c;
          if (n < N && cc < C)
            gact[(long long)n * C + cc] =
                act_grad<ACT>(acc[i][j][e]) *
                (__ldg(a.g + (long long)(n / a.P) * C + cc) * inv_p);
        }
  }

  grid_barrier(a.bar, gridDim.x);

  const int n_dw = nk * nc * rsplit;
  for (int item = blockIdx.x; item < n_dw + nr * nk; item += gridDim.x) {
    zero();
    if (item < n_dw) {  // dW[k0.., c0..] over a segment's rows: x^T gact
      const int t = item / rsplit, seg = item % rsplit;
      const int k0 = t / nc * kTile, c0 = t % nc * kTile;
      const int s0 = seg * seg_rows;
      product<kTile, kTile, kStages, kInnerRows, kInnerRows, 2>(
          acc, ring, xsrc, s0, k0, gsrc, s0, c0, min(seg_rows, N - s0));
      float* out = rsplit > 1 ? segs + (long long)seg * K * C : a.dw;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int r, c;
            rc(i, j, e, r, c);
            if (k0 + r < K && c0 + c < C)
              out[(long long)(k0 + r) * C + c0 + c] = acc[i][j][e];
          }
    } else {  // dx[n0.., k0..] = sum over channels of gact W^T
      const int j0 = item - n_dw;
      const int n0 = j0 / nk * kTile, k0 = j0 % nk * kTile;
      product<kTile, kTile, kStages, kOuterRows, kOuterRows, 2>(
          acc, ring, gsrc, n0, 0, wsrc, k0, 0, C);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int r, c;
            rc(i, j, e, r, c);
            const int n = n0 + r, k = k0 + c;
            if (n < N && k < K)
              dx[row_offset(n, a.P, a.dsb, a.dsp) + (long long)k * a.dsk] =
                  acc[i][j][e];
          }
    }
  }
  if (rsplit > 1) {
    // a barrier of its own: a block that left the first one may arrive
    // here before the last block has left it and set its counters back
    grid_barrier(a.bar + 2, gridDim.x);
    sum_partials(segs, a.dw, (long long)K * C, rsplit);
  }
}

}  // namespace f32

// -------------------------------------------------------------- launches

// kp: K in 32s, which sizes the fp32 rows kernel's accumulators
template <typename F>
cudaError_t for_kernel(int dtype, int act, int tp, int mode, int kp, F&& f) {
  auto pick = [&](auto act_c) -> cudaError_t {
    constexpr int A = decltype(act_c)::value;
    if (dtype == kFloat32) {
      if (mode == f32::kTiles)
        return tp == f32::kTile ? f(f32::token_head_bwd_tiles_kernel<A>)
                                : cudaErrorInvalidValue;
      // the row tile the plan gives each K in 32s
      // (ops/token_head.py::FP32_ROWS_TP)
      switch (tp * 1000 + kp) {
        case 64032: return f(f32::token_head_bwd_rows_kernel<64, 32, A>);
        case 32064: return f(f32::token_head_bwd_rows_kernel<32, 64, A>);
        case 32096: return f(f32::token_head_bwd_rows_kernel<32, 96, A>);
      }
      return cudaErrorInvalidValue;
    }
    if (dtype != kBFloat16) return cudaErrorInvalidValue;
    switch (tp * 2 + (mode ? 1 : 0)) {
      case 128: return f(token_head_bwd_mma_kernel<64, A, false>);
      case 129: return f(token_head_bwd_mma_kernel<64, A, true>);
      case 64: return f(token_head_bwd_mma_kernel<32, A, false>);
      case 65: return f(token_head_bwd_mma_kernel<32, A, true>);
      case 32: return f(token_head_bwd_mma_kernel<16, A, false>);
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

}  // namespace bwd
}  // namespace k1
}  // namespace mmvqa

// Blocks of the backward kernel for (dtype, act, tp, mode, K) that an SM
// holds at once with `smem` bytes of shared memory: the cooperative launch
// takes no more than this many times the SMs.
extern "C" int token_head_bwd_occupancy(int dtype, int act, int tp, int mode,
                                        int K, int smem, int* blocks) {
  using namespace mmvqa;
  using namespace mmvqa::k1;
  using namespace mmvqa::k1::bwd;
  return static_cast<int>(for_kernel(
      dtype, act, tp, mode, f32::kpad(K), [&](auto kern) {
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kern, dtype == kFloat32 ? tf32::kThreads : kMmaThreads, smem);
  }));
}

// x, dx: (B, P, K) by element strides, x's dtype; w: (K, C) contiguous, x's
// dtype; g: (B, C) fp32 contiguous, the gradient of the output; dw: (K, C)
// fp32 out; bar: four unsigned ints (two barriers' counters), zero on entry
// and on exit, one buffer a stream. The plan (ops/token_head.py::backward_plan): tp rows a tile,
// items_per_block tiles a block at most, nblocks blocks, all resident at
// once, none left empty; mode; smem bytes; rsplit. bf16: tp 64, 32 or 16,
// mode 1 where W is resident in shared memory (mma_smem_bytes), part
// (nblocks, K, C) fp32 scratch, rsplit 1. fp32: mode kRows (K <= 96; tp 32;
// part (nblocks, K, C); rsplit 1) or kTiles (tp 64; part the (B * P, C)
// fp32 gact, then rsplit (K, C) segments of dW where rsplit > 1).
extern "C" int token_head_bwd(const void* x, int dtype, long long sb,
                              long long sp, long long sk, const void* w,
                              const void* g, void* dx, long long dsb,
                              long long dsp, long long dsk, void* part,
                              void* dw, void* bar, int B, int P, int K, int C,
                              int act, int tp, int items_per_block,
                              int nblocks, int mode, int smem, int rsplit,
                              void* stream) {
  using namespace mmvqa;
  using namespace mmvqa::k1;
  using namespace mmvqa::k1::bwd;
  if (tp < 1 || nblocks < 1 || (long long)B * P >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = ((long long)B * P + tp - 1) / tp;
  bool ok;
  if (dtype == kFloat32 && mode == f32::kTiles) {
    ok = tp == f32::kTile && smem == f32::tiles_smem_bytes() && rsplit >= 1;
  } else if (dtype == kFloat32) {
    ok = mode == f32::kRows && K <= f32::kRowsMaxK &&
         smem == f32::rows_smem_bytes(tp, K) && nblocks <= items &&
         rsplit == 1;
  } else {
    ok = rsplit == 1 && smem == mma_smem_bytes(tp, K, C, mode) &&
         (long long)nblocks * items_per_block >= items &&
         (long long)(nblocks - 1) * items_per_block < items;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Args a{x,  sb,  sp,  sk, w,  static_cast<const float*>(g), dx, dsb, dsp,
         dsk, static_cast<float*>(part), static_cast<float*>(dw),
         static_cast<unsigned*>(bar), B, P, K, C, tp, items_per_block, mode};
  // 16-byte copies where every row of x (and W) starts on 16 bytes
  int vec_x = vec_x_ok(x, sb, sp, sk, K);
  int vec_w = vec_w_ok(w, C);
  const tf32::Positions xsrc{
      static_cast<const float*>(x), sb, sp, sk, P, B * P, K,
      sk == 1 && K % 4 == 0 && sp % 4 == 0 && sb % 4 == 0 &&
          reinterpret_cast<size_t>(x) % 16 == 0};
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(for_kernel(
      dtype, act, tp, mode, f32::kpad(K), [&](auto kern) {
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    void* fp32_args[] = {&a, const_cast<tf32::Positions*>(&xsrc), &vec_w,
                         &rsplit};
    void* bf16_args[] = {&a, &vec_x, &vec_w};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(kern), dim3(nblocks),
        dim3(dtype == kFloat32 ? tf32::kThreads : kMmaThreads),
        dtype == kFloat32 ? fp32_args : bf16_args, (size_t)smem, st);
    if (err != cudaSuccess) cudaGetLastError();
    return err;
  }));
}
