// K3 backward: both gradients of the depthwise 3x3 convolution in one pass,
//   dx[p]    = sum_t dy[p - o_t] * k_t            (the taps flipped)
//   dW[t, c] = sum_{b, p} x[b, p, c] * dy[b, p - o_t, c]
// with o_t the offset of tap t and the zero border as in the forward.
//
// Replaces the TPU kernel mmvqa_tpu/ops/pallas_depthwise.py::_bwd_kernel
// (_bwd_call, pallas_call at :166). As there, one 3 x 3 window of dy feeds
// both sums. What bounds it on an H100: bytes (x and dy read, dx written;
// 18 multiply-adds an element).
//
// The design is the forward's (depthwise3x3.cu, depthwise3x3_tile.cuh): the
// block stages the dy halo tile of its channel tile, strip and columns in
// shared memory, two stages in flight, and a thread walks down one column
// with a 3 x 3 window of dy in registers. The centre x arrives with the same
// stage (a second box, no halo, on the same barrier): read from device
// memory row by row, one row ahead, it left the loop waiting on every row.
// A thread owns 4 channels in both dtypes (dw3::kVec: 16 bytes of fp32, 8
// of bf16): with 8 bf16 channels the window, the taps and the 9 dW sums
// alone would take 216 of its 255 registers.
//
// dW is a sum over every position of every image, and blocks run in no
// order. A thread keeps its 9 x 4 sums in registers over its stages; the
// block adds its columns in shared memory in a fixed order into one (9, ct)
// fp32 partial, written to `part` (one per strip, column tile and image
// group). Then the last block of a channel tile to finish (a counter per
// channel tile, after a fence) adds the partials in a fixed order and
// writes dW. The counter counts with atomicInc, which wraps to 0 at the last
// arrival, so it is zero again for the next call with no store of its own.
// No float atomics and no second kernel: two runs give identical bits.
#include "depthwise3x3_tile.cuh"

namespace mmvqa {
namespace k3bwd {

using dw3::Plan;

// One row of a thread's column: the dy window's rows a, b, c (c read here
// from `next`; d_a[j] = dy[h - 1 + a, w - 1 + j] pairs with tap
// (2 - a, 2 - j)) and the centre x from `xs` give dx and add into dW.
template <typename T, int VEC, int GV>
__device__ __forceinline__ void bwd_row(const T* next, const T* xs, int ct,
                                        const float (&a)[3][VEC],
                                        const float (&b)[3][VEC],
                                        float (&c)[3][VEC],
                                        const float (&k)[9][VEC],
                                        float (&dws)[9][VEC], T* out,
                                        bool store, int ch, int C) {
  dw3::load_row3<T, VEC>(next, ct, c);
  float xv[VEC], acc[VEC];
  load_vec<T, VEC>(xs, xv);
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      s = fmaf(a[j][v], k[8 - j][v], s);
      s = fmaf(b[j][v], k[5 - j][v], s);
      s = fmaf(c[j][v], k[2 - j][v], s);
      dws[8 - j][v] = fmaf(xv[v], a[j][v], dws[8 - j][v]);
      dws[5 - j][v] = fmaf(xv[v], b[j][v], dws[5 - j][v]);
      dws[2 - j][v] = fmaf(xv[v], c[j][v], dws[2 - j][v]);
    }
    acc[v] = s;
  }
  if (store) dw3::store_global<T, VEC, GV>(out, ch, C, acc);
}

template <typename T, int COPY>
__global__ void __launch_bounds__(dw3::kMaxThreads)
    depthwise3x3_bwd_kernel(const __grid_constant__ CUtensorMap dy_map,
                            const __grid_constant__ CUtensorMap x_map,
                            const T* __restrict__ x, const T* __restrict__ dy,
                            TapWeights w, T* __restrict__ dx,
                            float* __restrict__ part, float* __restrict__ dw,
                            unsigned* __restrict__ counter, Plan pl) {
  constexpr int VEC = dw3::kVec;
  constexpr int GV = COPY == dw3::kElements ? 1 : VEC;
  extern __shared__ __align__(128) unsigned char smem[];
  const int sb = dw3::stage_bytes<T>(pl, true);
  const int centre_at =
      dw3::round_up(dw3::halo_bytes<T>(pl), dw3::kTileAlign) / (int)sizeof(T);
  float* taps = reinterpret_cast<float*>(
      smem + dw3::stages_bytes<T>(pl, blockDim.x, VEC, true));
  uint64_t* bar = reinterpret_cast<uint64_t*>(taps + 9 * pl.ct);
  int* last = reinterpret_cast<int*>(bar + 2);

  const int lanes = pl.ct / VEC;
  const int lane = threadIdx.x % lanes;
  const int col = (threadIdx.x / lanes) % pl.tw;
  const int img = threadIdx.x / (lanes * pl.tw);
  const int c0 = blockIdx.x * pl.ct;
  const int h0 = (blockIdx.y / pl.ncol) * pl.s;
  const int w0 = (blockIdx.y % pl.ncol) * pl.tw;
  const int first = blockIdx.z * pl.steps * pl.p;
  const int c = c0 + lane * VEC, wq = w0 + col;
  const int rows = min(pl.s, pl.H - h0);
  const bool live = c < pl.C && wq < pl.W;
  const long long row_step = (long long)pl.W * pl.C;
  const int srow = (pl.tw + 2) * pl.ct;  // a row of the dy halo box
  const int xrow = pl.tw * pl.ct;        // a row of the x centre box

  if (COPY == dw3::kTma && threadIdx.x == 0) dw3::init_barriers(bar);
  dw3::load_taps<T>(w, taps, c0, pl);
  __syncthreads();
  auto stage = [&](int i) { return reinterpret_cast<T*>(smem + (i & 1) * sb); };
  auto issue = [&](int i) {
    dw3::issue_stage<T, COPY>(&dy_map, dy, &x_map, x, stage(i), &bar[i & 1],
                              pl, c0, h0, w0, first + i * pl.p);
  };
  issue(0);
  if (pl.steps > 1) issue(1);

  float k[9][VEC], dws[9][VEC];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      k[t][v] = taps[t * pl.ct + lane * VEC + v];
      dws[t][v] = 0.0f;
    }

  for (int st = 0; st < pl.steps; ++st) {
    dw3::wait_stage<COPY>(&bar[st & 1], st >> 1, st + 1 < pl.steps);
    const int b = first + st * pl.p + img;
    const T* tile =
        stage(st) + (img * (pl.s + 2) * srow + col * pl.ct + lane * VEC);
    const T* xs = stage(st) + (centre_at + img * pl.s * xrow + col * pl.ct +
                               lane * VEC);
    float d0[3][VEC], d1[3][VEC], d2[3][VEC];
    dw3::load_row3<T, VEC>(tile, pl.ct, d0);
    dw3::load_row3<T, VEC>(tile + srow, pl.ct, d1);
    T* out = dx + (((long long)b * pl.H + h0) * pl.W + wq) * pl.C + c;
    const bool store = live && b < pl.B;
    int r = 0;
    for (; r + 3 <= rows; r += 3) {
      bwd_row<T, VEC, GV>(tile + (r + 2) * srow, xs + r * xrow, pl.ct, d0, d1,
                          d2, k, dws, out, store, c, pl.C);
      bwd_row<T, VEC, GV>(tile + (r + 3) * srow, xs + (r + 1) * xrow, pl.ct,
                          d1, d2, d0, k, dws, out + row_step, store, c, pl.C);
      bwd_row<T, VEC, GV>(tile + (r + 4) * srow, xs + (r + 2) * xrow, pl.ct,
                          d2, d0, d1, k, dws, out + 2 * row_step, store, c,
                          pl.C);
      out += 3 * row_step;
    }
    if (r < rows)
      bwd_row<T, VEC, GV>(tile + (r + 2) * srow, xs + r * xrow, pl.ct, d0, d1,
                          d2, k, dws, out, store, c, pl.C);
    if (r + 1 < rows)
      bwd_row<T, VEC, GV>(tile + (r + 3) * srow, xs + (r + 1) * xrow, pl.ct,
                          d1, d2, d0, k, dws, out + row_step, store, c, pl.C);
    __syncthreads();
    if (st + 2 < pl.steps) issue(st + 2);
  }

  // the block's partial: its column slots added in order, tap by tap, in
  // the stage memory (free now: every copy has been waited for). Thread
  // q * lanes + lane holds channels lane * VEC.. of slot q, so
  // red[q * ct + i] is slot q's sum for channel c0 + i.
  float* red = reinterpret_cast<float*>(smem);
  const int slots = blockDim.x / lanes;
  const int nparts = gridDim.y * gridDim.z;
  const long long mine = (long long)blockIdx.z * gridDim.y + blockIdx.y;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[threadIdx.x * VEC + v] = dws[t][v];
    __syncthreads();
    for (int i = threadIdx.x; i < pl.ct && c0 + i < pl.C; i += blockDim.x) {
      float s = 0.0f;
      for (int q = 0; q < slots; ++q) s += red[q * pl.ct + i];
      part[(mine * 9 + t) * pl.C + c0 + i] = s;
    }
    __syncthreads();
  }

  // last block of this channel tile: the partials in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *last = atomicInc(&counter[blockIdx.x], (unsigned)(nparts - 1)) ==
            (unsigned)(nparts - 1);
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int i = threadIdx.x; i < 9 * pl.ct; i += blockDim.x) {
    const int t = i / pl.ct, cc = c0 + i % pl.ct;
    if (cc >= pl.C) continue;
    float s = 0.0f;
    for (int q = 0; q < nparts; ++q)
      s += __ldcg(&part[((long long)q * 9 + t) * pl.C + cc]);
    dw[(long long)t * pl.C + cc] = s;
  }
}

template <typename T, int COPY>
int& granted() {  // the shared memory this kernel variant may use
  static int bytes = 0;
  return bytes;
}

}  // namespace k3bwd
}  // namespace mmvqa

// x, dy, dx: (B, H, W, C) dense, x's dtype; w: (9, C) fp32 or bf16 by
// element strides; part: (ncol * nstrip * groups, 9, C) fp32 scratch; dw:
// (9, C) fp32 out; counter: ceil(C / ct) unsigned ints, zero on entry and
// on exit (the wrapper owns them, one buffer per stream: calls on two
// streams must not share one). The plan as for depthwise3x3_fwd.
extern "C" int depthwise3x3_bwd(const void* x, int dtype, const void* dy,
                                const void* w, int wdtype, long long swt,
                                long long swc, void* dx, void* part, void* dw,
                                void* counter, int B, int H, int W, int C,
                                int copy, int vec, int ct, int tw, int s,
                                int p, int steps, int ncol, int nstrip,
                                int groups, int threads, int smem,
                                void* stream) {
  using namespace mmvqa;
  const dw3::Plan pl{B, H, W, C, ct, tw, s, p, steps, ncol};
  const int es = dtype == kBFloat16 ? 2 : 4;
  const int want_smem =
      es == 2 ? dw3::smem_bytes<__nv_bfloat16>(pl, threads, vec, true)
              : dw3::smem_bytes<float>(pl, threads, vec, true);
  if ((wdtype != kFloat32 && wdtype != kBFloat16) ||
      !dw3::plan_ok(pl, vec, 16 / es, copy, threads, nstrip, groups, smem) ||
      smem != want_smem)
    return static_cast<int>(cudaErrorInvalidValue);
  const TapWeights wp{w, wdtype, swt, swc};
  const dim3 grid((C + ct - 1) / ct, ncol * nstrip, groups);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dw3::dispatch(dtype, copy, [&](auto t, auto cp) {
    using T = typename decltype(t)::type;
    auto kernel = k3bwd::depthwise3x3_bwd_kernel<T, decltype(cp)::value>;
    cudaError_t err = dw3::allow_smem(
        kernel, smem, k3bwd::granted<T, decltype(cp)::value>());
    if (err != cudaSuccess) return err;
    CUtensorMap dy_map{}, x_map{};
    if (cp == dw3::kTma && !(dw3::encode_box_map(&dy_map, dy, dtype, pl, 1) &&
                             dw3::encode_box_map(&x_map, x, dtype, pl, 0)))
      return cudaErrorInvalidValue;
    kernel<<<grid, threads, smem, st>>>(
        dy_map, x_map, static_cast<const T*>(x), static_cast<const T*>(dy), wp,
        static_cast<T*>(dx), static_cast<float*>(part), static_cast<float*>(dw),
        static_cast<unsigned*>(counter), pl);
    return cudaGetLastError();
  }));
}

// Blocks of the backward kernel for (dtype, copy) that an SM holds at once
// with `threads` threads and `smem` bytes of shared memory.
extern "C" int depthwise3x3_bwd_occupancy(int dtype, int copy, int threads,
                                          int smem, int* blocks) {
  using namespace mmvqa;
  return static_cast<int>(dw3::dispatch(dtype, copy, [&](auto t, auto cp) {
    using T = typename decltype(t)::type;
    return dw3::occupancy(
        k3bwd::depthwise3x3_bwd_kernel<T, decltype(cp)::value>, threads, smem,
        k3bwd::granted<T, decltype(cp)::value>(), blocks);
  }));
}
