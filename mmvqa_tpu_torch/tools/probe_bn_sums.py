#!/usr/bin/env python3
"""What holds the BatchNorm-backward sums (K5, bf16).

    python3 mmvqa_tpu_torch/tools/probe_bn_sums.py

Builds copies of ``csrc/bn_backward_sums.cu`` with one part cut out or
changed (``probe_token_head_backward.build_copies``), plans each copy for the
blocks of its own kernel that an SM holds, unless the copy names another
number (``WAVES``), and times each (CUDA events, median of 10, each call
queued behind a sleeping device with the L2 cache overwritten first) at
the 18 site shapes of the flagship trunk at B=128, then over one train
step's 156 sites. Each copy is timed twice: with the cache overwritten by
writes, as ``chip_smoke.py`` does (the timed kernel then also writes the
50 MB of dirty lines back to device memory as it evicts them), and by
reads (clean lines). The cut copies compute wrong sums: their times only
say what the cut part costs when the rest stays. The copies:

    base          the kernel as it is (eight rows of x and dy in flight a
                  thread, by cp.async into its ring in shared memory),
                  planned at as many blocks an SM as the card holds; the
                  wrapper plans one (ops/bn_sums.py BLOCKS_PER_SM): that is
                  one_a_sm below
    stages_4      four rows in flight
    stages_12     twelve rows in flight
    registers     no ring: four rows' 16-byte loads into registers a batch
                  (the compiler uses each row before it loads the next)
    tail_1        the last block's partials one at a time a thread, not two
    no_partials   no partial, no counter, no last block: each block writes
                  its sums straight to the output
    no_counter    the last block is the one of the highest row index, not
                  the last to finish: no atomicInc (wrong where it runs
                  before the others)
    one_a_sm      the plan of one block an SM, not as many as it holds
    one_16        one block an SM with sixteen rows in flight a thread
    two_a_sm      the plan of two blocks an SM
    four_waves    the plan of four times the blocks the card holds at once,
                  each walking a quarter of the rows

The last four change the plan (``WAVES``). Pass copy names as
arguments to time only those.
"""

from __future__ import annotations

import ctypes
import os
import sys

B = 128
RING = """\
      // the ring: slot i % kStages holds row i's x and dy
      uint4* ring = reinterpret_cast<uint4*>(smem_raw);
      const int nthreads = blockDim.x * blockDim.y;
      const int tid = threadIdx.y * blockDim.x + threadIdx.x;
      auto issue = [&](long long i) {
        if (i < mine) {
          const long long at = (r0 + i * groups) * C + c;
          const int slot = (int)(i % kStages);
          cp_async16(&ring[2 * slot * nthreads + tid], x + at, true);
          cp_async16(&ring[(2 * slot + 1) * nthreads + tid], dy + at, true);
        }
        commit();  // an empty group past the last row keeps the count
      };
#pragma unroll
      for (int i = 0; i < kStages; ++i) issue(i);
      for (long long i = 0; i < mine; ++i) {
        wait_groups<kStages - 1>();  // row i has landed
        const int slot = (int)(i % kStages);
        float xv[VEC], d[VEC];
        load_vec<T, VEC>(
            reinterpret_cast<const T*>(&ring[2 * slot * nthreads + tid]), xv);
        load_vec<T, VEC>(
            reinterpret_cast<const T*>(&ring[(2 * slot + 1) * nthreads + tid]),
            d);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          s1[v] += d[v];
          s2[v] = fmaf(d[v], (xv[v] - mu[v]) * inv[v], s2[v]);
        }
        issue(i + kStages);  // into the slot just read
      }
      wait_groups<0>();
"""
REGISTERS = """\
      for (long long i = 0; i < mine; i += 4) {
        Pack<T, VEC> xr[4], dr[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const long long at = (r0 + min(i + u, mine - 1) * groups) * C + c;
          xr[u] = *reinterpret_cast<const Pack<T, VEC>*>(x + at);
          dr[u] = *reinterpret_cast<const Pack<T, VEC>*>(dy + at);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const float d = i + u < mine ? to_f32(dr[u].v[v]) : 0.0f;
            s1[v] += d;
            s2[v] = fmaf(d, (to_f32(xr[u].v[v]) - mu[v]) * inv[v], s2[v]);
          }
        }
      }
"""
STAGES = "constexpr int kStages = 8;"
CUTS = {
    "base": [],
    "stages_4": [(STAGES, "constexpr int kStages = 4;")],
    "stages_12": [(STAGES, "constexpr int kStages = 12;")],
    "registers": [(RING, REGISTERS), (STAGES, "constexpr int kStages = 1;")],
    "tail_1": [("#pragma unroll 2\n    for", "#pragma unroll 1\n    for")],
    "no_partials": [
        ("  column_sums<VEC>(s1, s2, red, partial + (long long)blockIdx.y * 2"
         " * C, C);\n",
         "  column_sums<VEC>(s1, s2, red, out, C);\n  return;\n"),
    ],
    "no_counter": [
        ("    last = atomicInc(&counter[blockIdx.x], gridDim.y - 1) == "
         "gridDim.y - 1;",
         "    last = blockIdx.y == gridDim.y - 1;"),
    ],
    "one_a_sm": [],
    "one_16": [(STAGES, "constexpr int kStages = 16;")],
    "two_a_sm": [],
    "four_waves": [],
}
# blocks of a wave per SM, where a copy changes the plan: a number, or a
# multiple of the blocks an SM holds
WAVES = {"one_a_sm": 1, "one_16": 1, "two_a_sm": 2, "four_waves": "4x"}


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.abspath(os.path.join(here, "..", "..")))
    import torch

    from mmvqa_tpu_torch.native import loader
    from mmvqa_tpu_torch.ops import bn_sums, tiling
    from mmvqa_tpu_torch.tools.probe_token_head_backward import (
        build_copies,
        card_line,
    )
    from mmvqa_tpu_torch.tools.time_bn_sums import SITES, bound_ms
    from mmvqa_tpu_torch.tools.time_conv_bn import time_ms

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = card_line()
    print(card)

    def bind(lib):
        lib.bn_backward_sums.restype = ctypes.c_int
        lib.bn_backward_sums.argtypes = loader.BN_SUMS_ARGTYPES
        lib.bn_backward_sums_occupancy.restype = ctypes.c_int
        lib.bn_backward_sums_occupancy.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]

    names = sys.argv[1:] or list(CUTS)
    libs, _ = build_copies("bn_backward_sums.cu",
                           {name: CUTS[name] for name in names}, bind)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    ptr = loader.ptr
    totals = dict.fromkeys(names, 0.0)
    clean_totals = dict.fromkeys(names, 0.0)
    total_bound = 0.0

    class CleanFlush:
        """The L2 cache overwritten by reads, leaving clean lines."""

        def zero_(self):
            flush.sum()
    for (rows, C), count in sorted(SITES.items()):
        N = B * rows
        x = (torch.randn(N, C, device=dev, generator=gen) * 2 + 1).bfloat16()
        dy = torch.randn(N, C, device=dev, generator=gen).bfloat16()
        mean = torch.randn(C, device=dev, generator=gen)
        inv_std = 1 + torch.rand(C, device=dev, generator=gen)
        vec = tiling.vector_width(C, bn_sums.VEC_BYTES // 2, x, dy)
        out = torch.empty(2, C, device=dev)
        line = []
        for name, lib in libs.items():
            draft = tiling.channel_plan(N, C, vec, 1)
            slots = ctypes.c_int(0)
            loader.check(lib.bn_backward_sums_occupancy(
                loader.DTYPE_CODES[x.dtype], vec,
                draft.lanes * draft.row_groups, ctypes.byref(slots)), name)
            per_sm = WAVES.get(name, slots.value)
            if per_sm == "4x":
                per_sm = 4 * slots.value
            wave = per_sm * sms
            plan = tiling.channel_plan(N, C, vec, wave)
            part = torch.empty(plan.nrb, 2, C, device=dev)
            counter = torch.zeros(plan.ctiles, device=dev, dtype=torch.int32)

            def call():
                loader.check(lib.bn_backward_sums(
                    ptr(x), ptr(dy), loader.DTYPE_CODES[x.dtype], ptr(mean),
                    ptr(inv_std), ptr(part), ptr(out), ptr(counter), N, C,
                    *plan, loader.stream_ptr()), name)

            ms = time_ms(torch, call, flush)
            clean = time_ms(torch, call, CleanFlush())
            totals[name] += count * ms
            clean_totals[name] += count * clean
            line.append(f"{name} {ms:.4f} / {clean:.4f} ({per_sm}/SM)")
        bnd = bound_ms(N, C, 2)
        total_bound += count * bnd
        print(f"N={N} C={C} x{count} bound {bnd:.4f}, ms dirty / clean L2: "
              + "; ".join(line), flush=True)
    print(f"156 sites, ms dirty / clean L2 (bound {total_bound:.4f}): "
          + "; ".join(f"{name} {totals[name]:.4f} / {clean_totals[name]:.4f}"
                      for name in names))
    print(card)


if __name__ == "__main__":
    main()
