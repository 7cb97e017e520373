#!/usr/bin/env python3
"""Where the token head's bf16 forward kernel (K1-fwd) spends its time.

    python3 mmvqa_tpu_torch/tools/probe_token_head.py [--fp32]

Builds copies of ``csrc/token_head.cu`` with one part of the bf16 kernel cut
out or moved (``probe_token_head_backward.build_copies``) and times each
copy (CUDA events, median of 10, each call queued behind a sleeping device)
at the five flagship taps at B=128, as the trunk hands them over, with
SERF's bf16 polynomial and with ReLU. The cut copies compute wrong outputs:
their times only say what the cut part costs when the rest stays. The
copies:

    base          the kernel as it is
    w_shared      (stage 0) W's fragments loaded from shared memory for each
                  16-row step, as for K > 32, not held in registers
    two_sets      W resident: a second accumulator set, the next 16 rows'
                  products issued before this step's activation
    warps8        eight consumer warps of 32 channels a block, not four of 64
    expf          SERF's polynomial through __expf (a multiply and a guard
                  against results below 2^-126 more), not one ex2.approx.ftz
    no_special    SERF's polynomial without its two special functions
    no_act        the sums of s itself: no activation
    no_epilogue   neither activation nor sums (the products stay)
    no_tail       no last-block sums across blocks (nor their counters)

``--fp32`` instead times the fp32 forward (k1::fwd32) where W is resident
(the stem and the flagship's stages 0-2, at B=16 and 128) with other row
tiles and blocks an SM than the kernel's 16 rows at four, each copy
launched with the plan's other fields (one wave of the blocks the card
says an SM holds):

    base          16-row tiles, up to four blocks an SM
    r32x3         32-row tiles, up to three blocks an SM
    r32x4         32-row tiles, up to four
    r16x5         16-row tiles, up to five
"""

from __future__ import annotations

import ctypes
import os
import sys

TAPS = (("stage0", 112, 24), ("stage1", 56, 48), ("stage2", 28, 80),
        ("stage4", 14, 176), ("stage6", 7, 512))
B, HIDDEN = 128, 768
# the resident loop with a second accumulator set
TWO_OLD = """\
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
"""
TWO_NEW = """\
      // 16-row steps q = 4 t + rb: the products of step q + 1 are issued
      // before the activation of step q, into the other accumulator set
      const int steps = 4 * stages;
      auto products = [&](float (&acc)[kNT][4], int q) {
        const __nv_bfloat16* xs = ring + (q / 4 % kStages) * sbuf;
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
        const __nv_bfloat16* xrow = xs + ((q % 4) * 16 + lane % 16) * xld +
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
      };
      auto step = [&](int q, float (&cur)[kNT][4], float (&nxt)[kNT][4]) {
        if (q + 1 < steps) {
          if ((q + 1) % 4 == 0) {
            release(q / 4);
            wait_stage((q + 1) / 4);
          }
          products(nxt, q + 1);
        } else {
          release(q / 4);
        }
        epilogue(cur, (first + q / 4) * TP + (q % 4) * 16);
      };
      float acc0[kNT][4], acc1[kNT][4];
      wait_stage(0);
      products(acc0, 0);
      for (int q = 0; q < steps; q += 2) {
        step(q, acc0, acc1);
        step(q + 1, acc1, acc0);
      }
"""

# only the bf16 forward's kernels with SERF's polynomial and ReLU
TRIM = [("    case kSerf: return pick(std::integral_constant<int, kSerf>());\n"
         "    case kSerfFast: return pick(std::integral_constant<int, "
         "kSerfFast>());", "    case kSerfFast: return pick(std::"
         "integral_constant<int, kSerfFast>());")]
CUTS = {
    "base": [],
    "two_sets": [(TWO_OLD, TWO_NEW)],
    "warps8": [("constexpr int kWarpC = 64;", "constexpr int kWarpC = 32;"),
               ("constexpr int kConsumers = 4;", "constexpr int kConsumers = 8;")],
    "expf": [("    return __fdividef(s, 1.0f + ex2_ftz(q));",
              "    return __fdividef(s, 1.0f + __expf(-q * m));")],
    "no_special": [("    return __fdividef(s, 1.0f + ex2_ftz(q));",
                    "    return s * (1.0f + q * q);")],
    "no_act": [("acc[n][e] = act<ACT>(acc[n][e]);", "acc[n][e] = acc[n][e];")],
    "no_epilogue": [
        ("    auto epilogue = [&](float (&acc)[kNT][4], int n0) {\n",
         "    auto epilogue = [&](float (&acc)[kNT][4], int n0) {\n"
         "      return;\n"),
    ],
    "no_tail": [("  for (int b = b_first; b <= b_last; ++b) {",
                 "  for (int b = b_first; b < b_first; ++b) {")],
}


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.abspath(os.path.join(here, "..", "..")))
    import torch

    from mmvqa_tpu_torch.models.visual_tokens import tap_positions
    from mmvqa_tpu_torch.native import loader
    from mmvqa_tpu_torch.ops import token_head as th
    from mmvqa_tpu_torch.tools.probe_token_head_backward import (
        build_copies,
        card_line,
        time_ms,
    )

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = card_line()
    print(card)

    def bind(lib):
        lib.token_head_fwd_mma.restype = ctypes.c_int
        lib.token_head_fwd_mma.argtypes = loader.FWD_ARGTYPES
        lib.token_head_fwd_occupancy.restype = ctypes.c_int
        lib.token_head_fwd_occupancy.argtypes = loader.FWD_OCCUPANCY_ARGTYPES

    libs, _ = build_copies(
        "token_head.cu", {name: TRIM + edits for name, edits in CUTS.items()},
        bind)
    # the kernel as it is, W's fragments from shared memory at every tap
    libs = {"base": libs.pop("base"), "w_shared": None, **libs}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ptr = loader.ptr
    totals = {(name, act): 0.0 for name in libs
              for act in ("serf_fast", "relu")}
    for tap, side, K in TAPS:
        P = side * side
        feat = torch.randn(B, side, side, K, device=dev, generator=gen)
        x = tap_positions(feat.bfloat16().permute(0, 3, 1, 2))
        w = (torch.randn(K, HIDDEN, device=dev, generator=gen)
             * K ** -0.5).bfloat16()
        out = torch.empty(B, HIDDEN, device=dev, dtype=torch.bfloat16)
        ctiles = -(-HIDDEN // th.FWD_TILE_C)
        counter = torch.zeros(B * ctiles, device=dev, dtype=torch.int32)
        _, mode, smem = th.forward_tile(K)
        for act in ("serf_fast", "relu"):
            line = []
            for name, lib in libs.items():
                n = ctypes.c_int(0)
                m = mode
                if name == "w_shared":
                    lib = libs["base"]
                    m = th.FWD_W_SHARED if mode == th.FWD_W_REGISTERS else mode
                loader.check(lib.token_head_fwd_occupancy(
                    th.ACTS[act], m, smem, ctypes.byref(n)),
                    f"{name} occupancy")
                plan = th.forward_plan(B, P, K, HIDDEN, sms, n.value)._replace(
                    mode=m)
                part = torch.empty(plan.nblocks, plan.slots,
                                   ctiles * th.FWD_TILE_C, device=dev)

                def call():
                    loader.check(lib.token_head_fwd_mma(
                        ptr(x), *x.stride(), ptr(w), ptr(part), ptr(out),
                        ptr(counter), B, P, K, HIDDEN, th.ACTS[act], *plan,
                        loader.stream_ptr()), name)

                ms = time_ms(torch, call)
                totals[(name, act)] += ms
                line.append(f"{name} {ms:.4f}")
                del part
            print(f"{tap} B={B} P={P} K={K} {act} ms: " + "; ".join(line),
                  flush=True)
    for act in ("serf_fast", "relu"):
        print(f"five taps, {act}, ms: " + "; ".join(
            f"{name} {totals[(name, act)]:.4f}" for name in libs))
    print(card)


# the fp32 forward's resident tile: (rows, blocks an SM) of each copy
FP32_LB = "__launch_bounds__(kThreads, RESIDENT ? 4 : 2)"
FP32_TILE = ("    if (mode == kResident && tp == 16)\n"
             "      return f(token_head_fwd_tf32x3_kernel<A, 16, true>);")
FP32_COPIES = {"base": (16, 4), "r32x3": (32, 3), "r32x4": (32, 4),
               "r16x5": (16, 5)}


def fp32_main() -> None:
    """--fp32: copies of the fp32 forward with other resident tiles."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.abspath(os.path.join(here, "..", "..")))
    import torch

    from mmvqa_tpu_torch.native import loader
    from mmvqa_tpu_torch.ops import token_head as th
    from mmvqa_tpu_torch.tools.probe_token_head_backward import (
        build_copies,
        card_line,
        time_ms,
    )

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = card_line()
    print(card)

    def bind(lib):
        lib.token_head_fwd_tf32x3.restype = ctypes.c_int
        lib.token_head_fwd_tf32x3.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 12,
            ctypes.c_void_p]
        lib.token_head_fwd_tf32x3_occupancy.restype = ctypes.c_int
        lib.token_head_fwd_tf32x3_occupancy.argtypes = [
            *[ctypes.c_int] * 4, ctypes.POINTER(ctypes.c_int)]

    edits = {name: [(FP32_LB, FP32_LB.replace("? 4", f"? {per_sm}")),
                    (FP32_TILE, FP32_TILE.replace("16", str(tp)))]
             for name, (tp, per_sm) in FP32_COPIES.items() if name != "base"}
    libs, _ = build_copies("token_head.cu", {"base": [], **edits}, bind)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ptr = loader.ptr
    for B in (16, 128):
        for P, K in ((112 * 112, 64), (112 * 112, 24), (56 * 56, 48),
                     (28 * 28, 80)):
            x = torch.randn(B, P, K, device=dev, generator=gen)
            w = torch.randn(K, HIDDEN, device=dev, generator=gen) * K ** -0.5
            want = th.token_head_reference(x, w, "serf")
            out = torch.empty(B, HIDDEN, device=dev)
            line = []
            for name, lib in libs.items():
                tp = FP32_COPIES[name][0]
                smem = th.fp32_forward_smem_bytes(tp, K, True)
                n = ctypes.c_int(0)
                loader.check(lib.token_head_fwd_tf32x3_occupancy(
                    th.ACTS["serf"], tp, th.FP32_FWD_RESIDENT, smem,
                    ctypes.byref(n)), name)
                plan = th.fp32_forward_plan(B, P, K, HIDDEN, sms, n.value)
                items = -(-B * P // tp)
                per = -(-items // max(1, n.value * sms // 6))
                plan = plan._replace(tp=tp, per_block=per,
                                     nblocks=-(-items // per), smem=smem,
                                     slots=min(B, (per * tp - 1) // P + 2))
                shape, _, n_counters = th.fp32_forward_scratch(plan, B,
                                                               HIDDEN)
                part = torch.empty(shape, device=dev)
                counter = torch.zeros(n_counters, device=dev,
                                      dtype=torch.int32)

                def call():
                    loader.check(lib.token_head_fwd_tf32x3(
                        ptr(x), *x.stride(), ptr(w), ptr(part), ptr(out),
                        ptr(counter), None, B, P, K, HIDDEN,
                        th.ACTS["serf"], *plan, loader.stream_ptr()), name)

                call()
                torch.cuda.synchronize()
                if ((out - want).abs() > 1e-5 + 1e-4 * want.abs()).any():
                    sys.exit(f"{name} disagrees at B={B} P={P} K={K}")
                line.append(f"{name} {time_ms(torch, call):.4f} "
                            f"({n.value} an SM)")
            print(f"fp32 serf B={B} P={P} K={K} ms: " + "; ".join(line),
                  flush=True)
    print(card)


if __name__ == "__main__":
    if "--fp32" in sys.argv[1:]:
        fp32_main()
    else:
        main()
