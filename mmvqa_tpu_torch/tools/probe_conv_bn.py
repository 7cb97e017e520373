#!/usr/bin/env python3
"""Where conv1x1 + BatchNorm statistics' TMA kernel (K4, bf16) spends its
time.

    python3 mmvqa_tpu_torch/tools/probe_conv_bn.py

Builds copies of ``csrc/conv1x1_stats.cu`` with one part of the TMA + wgmma
kernel cut out (``probe_token_head_backward.build_copies``) and times each
copy (CUDA events, median of 10, each call queued behind a sleeping device
with the L2 cache overwritten first) at the 18 site shapes of the flagship
trunk at B=128, then over one train step's 98 sites. The cut copies compute
wrong outputs: their times only say what the cut part costs when the rest
stays. The copies:

    base          the kernel as it is
    no_mma        no wgmma (the ring's loads and the epilogue stay)
    no_stats      no column sums (y is still stored)
    no_y          no store of y (its box is still written)
    no_epilogue   neither sums nor y
    loads_only    neither wgmma nor the epilogue: the ring's loads alone
    two_groups    two consumer warpgroups, 128-row tiles (with their own
                  stages and blocks along the rows), not three and 192
    l2_hints      the loads with L2 cache hints: x evict-first, W
                  evict-last
"""

from __future__ import annotations

import ctypes
import os
import sys

B = 128
HINT_OLD_LOAD = """\
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map,
                                         int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}"""
HINT_NEW_LOAD = """\
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map,
                                         int c0, int c1,
                                         uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;"
      ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}"""
HINT_OLD_CALLS = """\
          load_box(tile_a(s), &map_x, kb * kBK, m * kBM, &full[s]);
          load_box(tile_b(s), &map_w, kb * kBK, c0, &full[s]);"""
HINT_NEW_CALLS = """\
          load_box(tile_a(s), &map_x, kb * kBK, m * kBM, &full[s], px);
          load_box(tile_b(s), &map_w, kb * kBK, c0, &full[s], pw);"""
HINT_OLD_POLICY = """\
    if (threadIdx.x == 0) {
      int i = 0;"""
HINT_NEW_POLICY = """\
    if (threadIdx.x == 0) {
      uint64_t px, pw;
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                   : "=l"(px));
      asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
                   : "=l"(pw));
      int i = 0;"""
CUTS = {
    "base": [],
    "no_mma": [
        ("        wgmma<BN>(acc, desc(a + ks * 32), desc(b + ks * 32), kb + ks"
         " > 0);",
         "        if (ks < 0)\n          wgmma<BN>(acc, desc(a + ks * 32), "
         "desc(b + ks * 32), kb + ks > 0);"),
    ],
    "no_stats": [
        ("      halve<16>(v, lane, 16);\n      halve<8>(v, lane, 8);\n"
         "      halve<4>(v, lane, 4);\n", ""),
        ("      for (int k = 0; k < 4; ++k) run[q][k] += v[k];\n",
         "      (void)v;\n"),
    ],
    "no_y": [("      if (lane == 0) store_box(&map_y, c0 + q * kYBox, row0, "
              "mybox);\n", "")],
    "no_epilogue": [("    for (int q = 0; q < BN / 64; ++q) {",
                     "    for (int q = 0; q < 0; ++q) {")],
}
CUTS["loads_only"] = CUTS["no_mma"] + CUTS["no_epilogue"]
CUTS["two_groups"] = [
    ("constexpr int kConsumerGroups = 3;", "constexpr int kConsumerGroups = 2;"),
    ("constexpr int kProducerRegs = 24, kConsumerRegs = 160;",
     "constexpr int kProducerRegs = 40, kConsumerRegs = 232;"),
]
CUTS["l2_hints"] = [
    (HINT_OLD_LOAD, HINT_NEW_LOAD),
    (HINT_OLD_CALLS, HINT_NEW_CALLS),
    (HINT_OLD_POLICY, HINT_NEW_POLICY),
]


def plan_for(conv_bn, name, N, K, C, sms):
    """The plan of the kernel as it is; for two_groups, 128-row tiles with
    the same column tile, the deepest ring that fits, and the blocks along
    the rows that go with them."""
    plan = conv_bn.tma_plan(N, K, C, sms)
    if name != "two_groups":
        return plan

    def smem(stages):  # k4::tma::smem_bytes with 128 rows and 8 warps
        return (1024 + stages * (128 * 128 + plan.bn * 128) + 8 * 2048
                + 2 * stages * 8 + 16)

    stages = next(st for st in (6, 5, 4, 3) if smem(st) <= conv_bn.SMEM_LIMIT)
    nrb = max(1, min(-(-N // 128), sms // -(-C // plan.bn)))
    return conv_bn.TmaPlan(plan.bn, stages, nrb, smem(stages))


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.abspath(os.path.join(here, "..", "..")))
    import torch

    from mmvqa_tpu_torch.native import loader
    from mmvqa_tpu_torch.ops import conv_bn
    from mmvqa_tpu_torch.tools.probe_token_head_backward import (
        build_copies,
        card_line,
        time_ms,
    )
    from mmvqa_tpu_torch.tools.time_conv_bn import SITES

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = card_line()
    print(card)

    def bind(lib):
        lib.conv1x1_stats_tma.restype = ctypes.c_int
        lib.conv1x1_stats_tma.argtypes = loader.TMA_ARGTYPES

    libs, _ = build_copies("conv1x1_stats.cu", CUTS, bind)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    ptr = loader.ptr
    totals = dict.fromkeys(CUTS, 0.0)
    for (rows, K, C), count in sorted(SITES.items()):
        N = B * rows
        x = torch.randn(N, K, device=dev, generator=gen).bfloat16()
        w = (torch.randn(C, K, device=dev, generator=gen)
             * K ** -0.5).bfloat16().t()
        bn = conv_bn.tma_plan(N, K, C, sms).bn
        ctiles = -(-C // bn)
        y = torch.empty(N, C, device=dev, dtype=torch.bfloat16)
        part = torch.empty(sms, 2, ctiles * bn, device=dev)
        stats = torch.empty(2, C, device=dev)
        counter = torch.zeros(ctiles, device=dev, dtype=torch.int32)
        line = []
        for name, lib in libs.items():
            plan = plan_for(conv_bn, name, N, K, C, sms)

            def call():
                flush.zero_()
                loader.check(lib.conv1x1_stats_tma(
                    ptr(x), ptr(w), w.stride(1), ptr(y), ptr(part),
                    ptr(stats), ptr(counter), N, K, C, *plan,
                    loader.stream_ptr()), name)

            # the flush's own time, timed alone, comes off
            ms = time_ms(torch, call) - time_ms(torch, flush.zero_)
            totals[name] += count * ms
            line.append(f"{name} {ms:.4f}")
        print(f"N={N} K={K} C={C} x{count} bn={bn} ms: "
              + "; ".join(line), flush=True)
    print("98 sites, ms: " + "; ".join(f"{name} {totals[name]:.4f}"
                                        for name in CUTS))
    print(card)


if __name__ == "__main__":
    main()
