// K3 forward: depthwise 3x3 convolution, stride 1, zero border ("SAME"),
//   y[b, h, w, c] = sum_{di, dj in -1..1} x[b, h + di, w + dj, c] * k[di, dj, c].
//
// Replaces the TPU kernel mmvqa_tpu/ops/pallas_depthwise.py::depthwise3x3
// (_fwd_kernel / _fwd_call, pallas_call at :145), which holds whole planes of
// a row block in VMEM. The Hopper counterpart: a whole plane (or a strip of
// it) of one channel tile per block in shared memory, fed by asynchronous
// copies (depthwise3x3_tile.cuh: TMA where the map is 16-byte aligned,
// element copies elsewhere), two stages in flight.
//
// Layout: channels last, x and y dense (B, H, W, C), as the trunk keeps its
// maps. What bounds it on an H100: bytes (nine multiply-adds an element
// against one read and one write of the map). So every element of x is read
// from device memory once, by the copy engine, and y is written once by
// vector stores; the halo rows and columns of a tile are the zeros the copy
// fills or neighbours that the same block needs anyway.
//
// Compute: a thread owns 4 channels (dw3::kVec) of one column of the tile
// and walks down it, keeping a 3 x 3 window of positions in fp32 registers:
// each output costs three shared-memory reads of 4 channels and no global
// read, position indices are loop counters, and the window's rows are
// renamed, not moved, three rows an iteration. A warp's lanes read
// neighbouring bytes of one row of the stage, so the reads are
// conflict-free. The nine taps of its channels sit in registers, rounded to
// x's dtype as the JAX package rounds them; products and sums in fp32.
#include "depthwise3x3_tile.cuh"

namespace mmvqa {
namespace k3 {

using dw3::Plan;

// One output row of a thread's column: the window's rows a, b (above, at)
// and c (below, read here from `next`), VEC channels.
template <typename T, int VEC, int GV>
__device__ __forceinline__ void fwd_row(const T* next, int ct,
                                        const float (&a)[3][VEC],
                                        const float (&b)[3][VEC],
                                        float (&c)[3][VEC],
                                        const float (&k)[9][VEC], T* out,
                                        bool store, int ch, int C) {
  dw3::load_row3<T, VEC>(next, ct, c);
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      s = fmaf(a[j][v], k[j][v], s);
      s = fmaf(b[j][v], k[3 + j][v], s);
      s = fmaf(c[j][v], k[6 + j][v], s);
    }
    acc[v] = s;
  }
  if (store) dw3::store_global<T, VEC, GV>(out, ch, C, acc);
}

template <typename T, int COPY>
__global__ void __launch_bounds__(dw3::kMaxThreads)
    depthwise3x3_fwd_kernel(const __grid_constant__ CUtensorMap map,
                            const T* __restrict__ x, TapWeights w,
                            T* __restrict__ y, Plan pl) {
  constexpr int VEC = dw3::kVec;
  constexpr int GV = COPY == dw3::kElements ? 1 : VEC;
  extern __shared__ __align__(128) unsigned char smem[];
  const int sb = dw3::stage_bytes<T>(pl, false);
  float* taps = reinterpret_cast<float*>(
      smem + dw3::stages_bytes<T>(pl, blockDim.x, VEC, false));
  uint64_t* bar = reinterpret_cast<uint64_t*>(taps + 9 * pl.ct);

  // thread -> (lane, column, image of the stage); block -> tile
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
  const int srow = (pl.tw + 2) * pl.ct;  // a stage row, elements

  if (COPY == dw3::kTma && threadIdx.x == 0) dw3::init_barriers(bar);
  dw3::load_taps<T>(w, taps, c0, pl);
  __syncthreads();
  auto stage = [&](int i) { return reinterpret_cast<T*>(smem + (i & 1) * sb); };
  auto issue = [&](int i) {
    dw3::issue_stage<T, COPY>(&map, x, nullptr, nullptr, stage(i),
                              &bar[i & 1], pl, c0, h0, w0, first + i * pl.p);
  };
  issue(0);
  if (pl.steps > 1) issue(1);

  float k[9][VEC];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int v = 0; v < VEC; ++v) k[t][v] = taps[t * pl.ct + lane * VEC + v];

  for (int st = 0; st < pl.steps; ++st) {
    dw3::wait_stage<COPY>(&bar[st & 1], st >> 1, st + 1 < pl.steps);
    const int b = first + st * pl.p + img;
    // stage row 0 is plane row h0 - 1, stage column 0 is plane column w0 - 1
    const T* tile =
        stage(st) + (img * (pl.s + 2) * srow + col * pl.ct + lane * VEC);
    float r0[3][VEC], r1[3][VEC], r2[3][VEC];
    dw3::load_row3<T, VEC>(tile, pl.ct, r0);
    dw3::load_row3<T, VEC>(tile + srow, pl.ct, r1);
    T* out = y + (((long long)b * pl.H + h0) * pl.W + wq) * pl.C + c;
    const bool store = live && b < pl.B;
    // three rows an iteration, the window's rows renamed instead of moved
    int r = 0;
    for (; r + 3 <= rows; r += 3) {
      fwd_row<T, VEC, GV>(tile + (r + 2) * srow, pl.ct, r0, r1, r2, k, out,
                          store, c, pl.C);
      fwd_row<T, VEC, GV>(tile + (r + 3) * srow, pl.ct, r1, r2, r0, k,
                          out + row_step, store, c, pl.C);
      fwd_row<T, VEC, GV>(tile + (r + 4) * srow, pl.ct, r2, r0, r1, k,
                          out + 2 * row_step, store, c, pl.C);
      out += 3 * row_step;
    }
    if (r < rows)
      fwd_row<T, VEC, GV>(tile + (r + 2) * srow, pl.ct, r0, r1, r2, k, out,
                          store, c, pl.C);
    if (r + 1 < rows)
      fwd_row<T, VEC, GV>(tile + (r + 3) * srow, pl.ct, r1, r2, r0, k,
                          out + row_step, store, c, pl.C);
    __syncthreads();  // every thread is done with this stage
    if (st + 2 < pl.steps) issue(st + 2);
  }
}

template <typename T, int COPY>
int& granted() {  // the shared memory this kernel variant may use
  static int bytes = 0;
  return bytes;
}

}  // namespace k3
}  // namespace mmvqa

// x, y: (B, H, W, C) dense, x's dtype; w: (9, C) fp32 or bf16 (wdtype) by
// element strides (swt, swc), tap t = (di + 1) * 3 + dj + 1. The plan is
// ops/tiling.py::depthwise_plan: copy (dw3::Copy), vec (dw3::kVec), ct, tw,
// s, p, steps, ncol, nstrip, groups, threads, smem; grid
// (ceil(C / ct), ncol * nstrip, groups).
extern "C" int depthwise3x3_fwd(const void* x, int dtype, const void* w,
                                int wdtype, long long swt, long long swc,
                                void* y, int B, int H, int W, int C, int copy,
                                int vec, int ct, int tw, int s, int p,
                                int steps, int ncol, int nstrip, int groups,
                                int threads, int smem, void* stream) {
  using namespace mmvqa;
  const dw3::Plan pl{B, H, W, C, ct, tw, s, p, steps, ncol};
  const int es = dtype == kBFloat16 ? 2 : 4;
  const int want_smem =
      es == 2 ? dw3::smem_bytes<__nv_bfloat16>(pl, threads, vec, false)
              : dw3::smem_bytes<float>(pl, threads, vec, false);
  if ((wdtype != kFloat32 && wdtype != kBFloat16) ||
      !dw3::plan_ok(pl, vec, 16 / es, copy, threads, nstrip, groups, smem) ||
      smem != want_smem)
    return static_cast<int>(cudaErrorInvalidValue);
  const TapWeights wp{w, wdtype, swt, swc};
  const dim3 grid((C + ct - 1) / ct, ncol * nstrip, groups);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dw3::dispatch(dtype, copy, [&](auto t, auto cp) {
    using T = typename decltype(t)::type;
    auto kernel = k3::depthwise3x3_fwd_kernel<T, decltype(cp)::value>;
    cudaError_t err = dw3::allow_smem(
        kernel, smem, k3::granted<T, decltype(cp)::value>());
    if (err != cudaSuccess) return err;
    CUtensorMap map{};
    if (cp == dw3::kTma && !dw3::encode_box_map(&map, x, dtype, pl, 1))
      return cudaErrorInvalidValue;
    kernel<<<grid, threads, smem, st>>>(map, static_cast<const T*>(x), wp,
                                        static_cast<T*>(y), pl);
    return cudaGetLastError();
  }));
}

// Blocks of the forward kernel for (dtype, copy) that an SM holds at once
// with `threads` threads and `smem` bytes of shared memory: the launch plan
// sizes its grid to them.
extern "C" int depthwise3x3_fwd_occupancy(int dtype, int copy, int threads,
                                          int smem, int* blocks) {
  using namespace mmvqa;
  return static_cast<int>(dw3::dispatch(dtype, copy, [&](auto t, auto cp) {
    using T = typename decltype(t)::type;
    return dw3::occupancy(k3::depthwise3x3_fwd_kernel<T, decltype(cp)::value>,
                          threads, smem, k3::granted<T, decltype(cp)::value>(),
                          blocks);
  }));
}
