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
// Like the forward it never writes a (B, P, C) array. Positions are taken as
// one axis of B * P rows: a tile of rows may straddle two images, so that
// the small maps (P = 49, 196) waste no padded tile per image.
//
// What bounds it on an H100: operations. At the flagship stage-0 tap (B=128,
// P=112*112, K=24, C=768) the three products are 29.6 G multiply-adds each
// and act' is taken 1.2 G times (the bf16 path's polynomial SERF: an exp and
// a reciprocal on the special-function units, two an element, which is the
// bound), against 77 MB of x read and 77 MB of dx written in bf16.
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
// fp32: the same function on CUDA cores, never TF32 (the fp32 path serves the
// fp32 checks): register-tiled FMA products per (64-row tile, 128-channel
// tile), dx summed over the channel tiles in a (64, K + 1) shared tile where
// it fits and in dx itself (fp32, owned by one thread) where K is larger,
// dW added into the block's partial.
//
// dW across blocks: a block's partial is (K, C) fp32; the blocks are
// launched cooperatively, so that all of them are resident at once, meet at
// a barrier of two counters (arrivals, departures; both back at 0 when the
// kernel ends), and then each sums a share of dW's entries over the partials
// in block order. No float atomics: two runs give identical bits. One
// barrier buffer a (device, stream): the wrapper owns them.
//
// x is read, and dx written, by strides, so the trunk's channels-last map
// and its gradient go through as views with no transposing copy.
#include <type_traits>

#include "token_head_tile.cuh"

namespace mmvqa {
namespace k1 {
namespace bwd {

constexpr int kThreads = 256;  // a block of the fp32 kernel

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

// ------------------------------------------------------ fp32: CUDA cores

constexpr int kTileP = 64;    // rows of a tile
constexpr int kTileC = 128;   // channels of a channel tile
constexpr int kChunk2 = 32;   // k's staged per step
constexpr int kRegP = 4;      // s: rows per thread
constexpr int kRegC = 8;      // s: channels per thread (contiguous)
constexpr int kGroupsP = kTileP / kRegP;
constexpr int kGroupsC = kTileC / kRegC;
static_assert(kGroupsP * kGroupsC == kThreads, "thread tile");
// row stride of the W and gact tiles: 16-byte aligned rows whose starts fall
// on different banks, so that eight rows are read without a conflict
constexpr int kRowC = kTileC + 4;

// two stages of x and W chunks, then as the bf16 kernel's tables
__host__ __device__ inline int fma_smem_bytes(int K, int C, int dx_tile) {
  return 4 * (2 * (kChunk2 * kTileP + kChunk2 * kRowC) + kTileP * kRowC +
              (dx_tile ? kTileP * (K + 1) : 0)) +
         kTileP * (8 + 8 + 4) +  // row offsets of x and dx, images
         4 * g_cache_floats(C);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// Start the copies of x[rows, k0 .. k0 + 32] into xs[k][row] and W[k0 ..
// k0 + 32, c0 .. c0 + 128] into ws[k][c] and commit them as one group;
// out-of-range entries arrive as zeros (xoff < 0: no row). W by 16 bytes
// where C % 4 = 0 and w is 16-byte aligned (vec_w).
__device__ __forceinline__ void fma_issue(const float* __restrict__ x,
                                          const long long* xoff, long long sp,
                                          long long sk,
                                          const float* __restrict__ w,
                                          bool vec_w, float* xs, float* ws,
                                          int k0, int c0, int K, int C) {
  for (int i = threadIdx.x; i < kChunk2 * kTileP; i += kThreads) {
    int k, p;
    if (sp == 1) {
      k = i / kTileP;
      p = i % kTileP;
    } else {
      p = i / kChunk2;
      k = i % kChunk2;
    }
    const int gk = k0 + k;
    const bool in = xoff[p] >= 0 && gk < K;
    cp_async4(&xs[k * kTileP + p], in ? x + xoff[p] + (long long)gk * sk : x,
              in);
  }
  if (vec_w) {
    for (int i = threadIdx.x; i < kChunk2 * kTileC / 4; i += kThreads) {
      const int k = i / (kTileC / 4);
      const int c = (i % (kTileC / 4)) * 4;
      const int gk = k0 + k, gc = c0 + c;
      const bool in = gk < K && gc < C;
      cp_async16(&ws[k * kRowC + c], in ? w + (long long)gk * C + gc : w, in);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk2 * kTileC; i += kThreads) {
      const int k = i / kTileC;
      const int c = i % kTileC;
      const int gk = k0 + k, gc = c0 + c;
      const bool in = gk < K && gc < C;
      cp_async4(&ws[k * kRowC + c], in ? w + (long long)gk * C + gc : w, in);
    }
  }
  commit();
}

template <int ACT>
__global__ void __launch_bounds__(kThreads, 2)
    token_head_bwd_fma_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = kChunk2 * kTileP + kChunk2 * kRowC;
  float* ring = smem;                         // 2 x {[kChunk2][kTileP] x,
                                              //      [kChunk2][kRowC] W}
  float* gs = ring + 2 * kStage;              // [kTileP][kRowC]  gact tile
  float* dxs = gs + kTileP * kRowC;           // [kTileP][K + 1]  dx tile
  long long* xoff = reinterpret_cast<long long*>(
      dxs + (a.dx_tile ? kTileP * (a.K + 1) : 0));  // [kTileP]
  long long* dxoff = xoff + kTileP;                 // [kTileP]
  int* brow = reinterpret_cast<int*>(dxoff + kTileP);  // [kTileP]
  float* gcache = reinterpret_cast<float*>(brow + kTileP);  // as bf16's
  const int c4 = g_cache_floats(a.C) / 2;
  int gimg = -1;
  bool gcached = false;
  const int kx = a.K + 1;
  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);
  float* dx = static_cast<float*>(a.dx);
  const int K = a.K, C = a.C;

  const int tid = threadIdx.x;
  const int tc = tid % kGroupsC;
  const int tp = tid / kGroupsC;
  const int n_ctiles = (C + kTileC - 1) / kTileC;
  const int N = a.B * a.P;
  const int n_items = (N + kTileP - 1) / kTileP;
  const int first = blockIdx.x * a.items_per_block;
  const int last = min(n_items, first + a.items_per_block);
  float* mypart = a.part + (long long)blockIdx.x * K * C;
  const float inv_p = 1.0f / (float)a.P;
  const bool vec_w = C % 4 == 0 && reinterpret_cast<size_t>(w) % 16 == 0;
  const int n_kc = (K + kChunk2 - 1) / kChunk2;
  // chunk kc of channel tile c0 into ring buffer buf
  auto issue = [&](int kc, int c0, int buf) {
    fma_issue(x, xoff, a.sp, a.sk, w, vec_w, ring + buf * kStage,
              ring + buf * kStage + kChunk2 * kTileP, kc * kChunk2, c0, K, C);
  };

  for (int item = first; item < last; ++item) {
    const bool fresh = item == first;  // the partial holds nothing yet
    __syncthreads();  // the previous tile's offsets and dx tile are consumed
    const int b_first = item * kTileP / a.P;
    const int b_last = (min(N, item * kTileP + kTileP) - 1) / a.P;
    if (tid < kTileP) {
      const int n = item * kTileP + tid;
      const bool in = n < N;
      xoff[tid] = in ? row_offset(n, a.P, a.sb, a.sp) : -1;
      dxoff[tid] = in ? row_offset(n, a.P, a.dsb, a.dsp) : -1;
      brow[tid] = in ? n / a.P : b_last;
    }
    gcached = b_last - b_first <= 1;
    if (gcached && b_first != gimg) {  // g / P of the tile's two images
      for (int i = tid; i < 2 * C; i += kThreads) {
        const int j = i / C, c = i % C;
        gcache[j * c4 + c] =
            b_first + j < a.B ? a.g[(long long)(b_first + j) * C + c] * inv_p
                              : 0.0f;
      }
      gimg = b_first;
    }
    if (a.dx_tile)
      for (int i = tid; i < kTileP * kx; i += kThreads) dxs[i] = 0.0f;

    for (int ct = 0; ct < n_ctiles; ++ct) {
      const int c0 = ct * kTileC;
      __syncthreads();  // the previous tile's gact is consumed

      // 1. s = x W for this tile, as the forward computes it; chunk kc + 1
      // arrives while chunk kc is used
      float acc[kRegP][kRegC];
#pragma unroll
      for (int i = 0; i < kRegP; ++i)
#pragma unroll
        for (int j = 0; j < kRegC; ++j) acc[i][j] = 0.0f;
      issue(0, c0, 0);
      for (int kc = 0; kc < n_kc; ++kc) {
        if (kc + 1 < n_kc) issue(kc + 1, c0, (kc + 1) % 2);
        else commit();
        wait_groups<1>();
        __syncthreads();  // chunk kc is in
        const float* xs = ring + (kc % 2) * kStage;
        const float* ws = xs + kChunk2 * kTileP;
        const int depth = min(kChunk2, K - kc * kChunk2);
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
        __syncthreads();  // chunk kc is used: its buffer may be refilled
      }
      // gact, zero at rows past the end and at padded channels; g / P from
      // the cache, or from g where the tile spans more images
      // (read once for the thread's rows where they are of one image)
      float gv[kRegC];
      int gb = -1;
#pragma unroll
      for (int i = 0; i < kRegP; ++i) {
        const int p = tp * kRegP + i;
        const bool valid = xoff[p] >= 0;
        if (brow[p] != gb) {
          gb = brow[p];
#pragma unroll
          for (int j = 0; j < kRegC; ++j) {
            const int c = c0 + tc * kRegC + j;
            gv[j] = c >= C    ? 0.0f
                    : gcached ? gcache[(gb - gimg) * c4 + c]
                              : __ldg(a.g + (long long)gb * C + c) * inv_p;
          }
        }
        float out[kRegC];
#pragma unroll
        for (int j = 0; j < kRegC; ++j)
          out[j] = valid ? act_grad<ACT>(acc[i][j]) * gv[j] : 0.0f;
        float4* dst = reinterpret_cast<float4*>(&gs[p * kRowC + tc * kRegC]);
        dst[0] = make_float4(out[0], out[1], out[2], out[3]);
        dst[1] = make_float4(out[4], out[5], out[6], out[7]);
      }

      // 2. both gradient products, K staged 32 at a time, last chunk
      // first (phase 1 left it staged), the next lower chunk arriving
      // while one is used
      for (int kc = n_kc - 1; kc >= 0; --kc) {
        if (kc > 0) issue(kc - 1, c0, (kc - 1) % 2);
        else commit();
        wait_groups<1>();
        __syncthreads();  // gact is parked; chunk kc is in
        const float* xs = ring + (kc % 2) * kStage;
        const float* ws = xs + kChunk2 * kTileP;
        const int k0 = kc * kChunk2;
        {
          // dx[p, k] += sum_c gact[p, c] W[k, c]: rows p0 .. p0 + 4, k's ka
          // and ka + 16 (neighbouring lanes read neighbouring rows)
          const int ka = tid % 16;
          const int p0 = (tid / 16) * 4;
          float s[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.0f;
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
              s[i][0] = fmaf(gv.x, w0.x, s[i][0]);
              s[i][0] = fmaf(gv.y, w0.y, s[i][0]);
              s[i][0] = fmaf(gv.z, w0.z, s[i][0]);
              s[i][0] = fmaf(gv.w, w0.w, s[i][0]);
              s[i][1] = fmaf(gv.x, w1.x, s[i][1]);
              s[i][1] = fmaf(gv.y, w1.y, s[i][1]);
              s[i][1] = fmaf(gv.z, w1.z, s[i][1]);
              s[i][1] = fmaf(gv.w, w1.w, s[i][1]);
            }
          }
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int gk = k0 + ka + 16 * m;
            if (gk < K) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                if (a.dx_tile) {
                  dxs[(p0 + i) * kx + gk] += s[i][m];
                } else if (dxoff[p0 + i] >= 0) {
                  // dx itself holds the sum: this thread owns the entry
                  float* d = dx + dxoff[p0 + i] + (long long)gk * a.dsk;
                  *d = ct == 0 ? s[i][m] : *d + s[i][m];
                }
              }
            }
          }
        }
        {
          // dW[k, c] += sum_p x[p, k] gact[p, c]: k's ka * 2 and ka * 2 + 1,
          // channels cg * 4 .. + 4 and 64 + cg * 4 .. + 4 (neighbouring
          // lanes read neighbouring float4s)
          const int ka = (tid / 16) * 2;
          const int cg = (tid % 16) * 4;
          // (both k's padding, at K=24 two whole warps: nothing to do)
          if (k0 + ka < K) {
            // the sums start from the partial's values, read ahead of the
            // product so that their latency hides behind it
            float s[2][8];
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const int gk = k0 + ka + m;
              const float* row = mypart + (long long)gk * C + c0;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int c = cg + (j < 4 ? j : 60 + j);
                s[m][j] = (!fresh && gk < K && c0 + c < C) ? row[c] : 0.0f;
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
                s[0][j] = fmaf(x0, gr[j], s[0][j]);
                s[1][j] = fmaf(x1, gr[j], s[1][j]);
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
                  if (c0 + c < C) row[c] = s[m][j];
                }
              }
            }
          }
        }
        __syncthreads();  // chunk kc is used: its buffer may be refilled
      }
    }

    if (a.dx_tile) {
      __syncthreads();  // every channel tile is in dxs
      for (int i = tid; i < kTileP * K; i += kThreads) {
        int k, p;
        if (a.dsp == 1) {
          k = i / kTileP;
          p = i % kTileP;
        } else {
          p = i / K;
          k = i % K;
        }
        if (dxoff[p] >= 0) dx[dxoff[p] + (long long)k * a.dsk] = dxs[p * kx + k];
      }
    }
  }

  grid_barrier(a.bar, gridDim.x);
  sum_partials(a.part, a.dw, (long long)K * C, gridDim.x);
}

// -------------------------------------------------------------- launches

template <typename F>
cudaError_t for_kernel(int dtype, int act, int tp, int resident, F&& f) {
  auto pick = [&](auto act_c) -> cudaError_t {
    constexpr int A = decltype(act_c)::value;
    if (dtype == kFloat32) return f(token_head_bwd_fma_kernel<A>);
    if (dtype != kBFloat16) return cudaErrorInvalidValue;
    switch (tp * 2 + (resident ? 1 : 0)) {
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

// Blocks of the backward kernel for (dtype, act, tp, mode) that an SM holds
// at once with `smem` bytes of shared memory: the cooperative launch takes
// no more than this many times the SMs.
extern "C" int token_head_bwd_occupancy(int dtype, int act, int tp, int mode,
                                        int smem, int* blocks) {
  using namespace mmvqa;
  using namespace mmvqa::k1;
  using namespace mmvqa::k1::bwd;
  return static_cast<int>(for_kernel(dtype, act, tp, mode, [&](auto kern) {
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kern, dtype == kFloat32 ? kThreads : kMmaThreads, smem);
  }));
}

// x, dx: (B, P, K) by element strides, x's dtype; w: (K, C) contiguous, x's
// dtype; g: (B, C) fp32 contiguous, the gradient of the output; part:
// (nblocks, K, C) fp32 scratch; dw: (K, C) fp32 out; bar: two unsigned ints,
// zero on entry and on exit, one pair a stream. The plan
// (ops/token_head.py::backward_plan): tp rows a tile (64 in fp32; 64, 32 or
// 16 in bf16), items_per_block tiles a block, nblocks blocks with none left
// empty, all resident at once; mode: in fp32, 1 where dx is summed in a
// shared tile (fma_smem_bytes), in bf16, 1 where W is resident in shared
// memory (mma_smem_bytes); smem bytes.
extern "C" int token_head_bwd(const void* x, int dtype, long long sb,
                              long long sp, long long sk, const void* w,
                              const void* g, void* dx, long long dsb,
                              long long dsp, long long dsk, void* part,
                              void* dw, void* bar, int B, int P, int K, int C,
                              int act, int tp, int items_per_block,
                              int nblocks, int mode, int smem, void* stream) {
  using namespace mmvqa;
  using namespace mmvqa::k1;
  using namespace mmvqa::k1::bwd;
  const int need = dtype == kFloat32 ? fma_smem_bytes(K, C, mode)
                                     : mma_smem_bytes(tp, K, C, mode);
  const long long items = ((long long)B * P + tp - 1) / tp;
  if ((dtype == kFloat32 && tp != kTileP) || smem != need || nblocks < 1 ||
      (long long)B * P >= (1ll << 31) ||
      (long long)nblocks * items_per_block < items ||
      (long long)(nblocks - 1) * items_per_block >= items)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x,  sb,  sp,  sk, w,  static_cast<const float*>(g), dx, dsb, dsp,
         dsk, static_cast<float*>(part), static_cast<float*>(dw),
         static_cast<unsigned*>(bar), B, P, K, C, tp, items_per_block,
         dtype == kFloat32 ? mode : 0};
  // 16-byte copies where every row of x (and W) starts on 16 bytes
  int vec_x = vec_x_ok(x, sb, sp, sk, K);
  int vec_w = vec_w_ok(w, C);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(for_kernel(dtype, act, tp, mode, [&](auto kern) {
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    void* fp32_args[] = {&a};
    void* bf16_args[] = {&a, &vec_x, &vec_w};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(kern), dim3(nblocks),
        dim3(dtype == kFloat32 ? kThreads : kMmaThreads),
        dtype == kFloat32 ? fp32_args : bf16_args, (size_t)smem, st);
    if (err != cudaSuccess) cudaGetLastError();
    return err;
  }));
}
