#!/usr/bin/env python3
"""Where the attention backward's tensor-core kernel (K2-bwd, bf16) spends
its time.

    python3 mmvqa_tpu_torch/tools/probe_attention_backward.py

Builds copies of ``csrc/realformer_attention_bwd.cu`` with one part of the
tensor-core kernel cut out or changed
(``probe_token_head_backward.build_copies``) and times each copy (CUDA
events, median of 10, each call queued behind a sleeping device with the L2
cache overwritten first) at one train layer (B=128, T=75, 8 heads of 96,
prev, dcarry and dprev) and at T=28. The cut copies compute wrong
gradients: their times only say what the cut part costs when the rest
stays. The copies:

    base          the kernel as it is
    single_term   p and ds as one bf16 term each (no lo products)
    no_products   no mma.sync at all (the ldmatrix loads stay)
    no_softmax    p is the carry itself: no exp, no row max or sum
    no_carry      no carry or dcarry staged (p from zeros)
    no_dcarry     no dcarry staged
    no_stores     no dq, dk, dv or dprev stores (their products stay)
    loads_only    no products and no softmax: staging, the carry loads,
                  ldmatrix and the stores
"""

from __future__ import annotations

import ctypes
import os
import sys

H, E = 8, 96
CASES = ((128, 75), (128, 28))
CUTS = {
    "base": [],
    "single_term": [("  mma(acc, lo, b0, b1);\n", "")],
    "no_products": [
        ("  mma(acc, a, b0, b1);\n", ""),
        ("  mma(acc, hi, b0, b1);\n  mma(acc, lo, b0, b1);\n", ""),
    ],
    "no_softmax": [("    softmax_rows<NT>(p);\n", "")],
    "no_carry": [
        ("stage_flat(a.carry + head, T * T, cflat, tid, 32 * NW)", "0"),
        ("a.dcarry ? stage_flat(a.dcarry + head, T * T, dflat, tid, 32 * NW)"
         " : 0", "0"),
        ("    flat_to_acc<NT, false>(p, cflat + coff, T, r0, g, t4);\n",
         "    for (int j = 0; j < 2 * NT; ++j)\n"
         "      for (int i = 0; i < 4; ++i) p[j][i] = 0.0f;\n"),
        ("          if (a.dcarry && in) x += dflat[doff + r * T + col];\n",
         ""),
    ],
    "no_dcarry": [
        ("a.dcarry ? stage_flat(a.dcarry + head, T * T, dflat, tid, 32 * NW)"
         " : 0", "0"),
        ("          if (a.dcarry && in) x += dflat[doff + r * T + col];\n",
         ""),
    ],
    "no_stores": [
        ("    if (r >= T) continue;\n    __nv_bfloat16* row",
         "    if (r >= T || scale != 12345.0f) continue;\n"
         "    __nv_bfloat16* row"),
        ("if (a.dprev && in)", "if (a.dprev && in && x == 12345.0f)"),
    ],
}
CUTS["loads_only"] = CUTS["no_products"] + CUTS["no_softmax"]


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.abspath(os.path.join(here, "..", "..")))
    import torch

    from mmvqa_tpu_torch.native import loader
    from mmvqa_tpu_torch.ops import attention
    from mmvqa_tpu_torch.tools.probe_token_head_backward import (
        build_copies,
        in_namespace,
        card_line,
    )
    from mmvqa_tpu_torch.tools.time_conv_bn import time_ms

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = card_line()
    print(card)

    def bind(lib):
        lib.realformer_attn_bwd.restype = ctypes.c_int
        lib.realformer_attn_bwd.argtypes = (
            loader.library().realformer_attn_bwd.argtypes)

    libs, _ = build_copies("realformer_attention_bwd.cu",
                           in_namespace("realformer_attention_bwd.cu", "tc", CUTS),
                           bind)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    ptr = attention._ptr
    for B, T in CASES:
        kqv = torch.randn(B, T, H, 3 * E, device=dev,
                          generator=gen).bfloat16()
        k, q, v = kqv.split(E, dim=-1)
        prev = torch.randn(B, H, T, T, device=dev, generator=gen)
        lengths = torch.randint(T // 2, T + 1, (B,), device=dev,
                                generator=gen)
        mask = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()
        _, carry = attention.realformer_attention(q, k, v, prev, mask)
        dctx = torch.randn(B, T, H, E, device=dev, generator=gen).bfloat16()
        dcarry = 0.1 * torch.randn(B, H, T, T, device=dev, generator=gen)
        dkqv = torch.empty_like(kqv)
        dk, dq, dv = dkqv.split(E, dim=-1)
        dprev = torch.empty_like(carry)
        strides = (ctypes.c_longlong * 28)(
            *q.stride(), *k.stride(), *v.stride(), *dctx.stride(),
            *dq.stride(), *dk.stride(), *dv.stride())
        line = []
        for name, lib in libs.items():
            def call():
                loader.check(lib.realformer_attn_bwd(
                    ptr(q), ptr(k), ptr(v), ptr(carry), ptr(dctx),
                    ptr(dcarry), ptr(dq), ptr(dk), ptr(dv), ptr(dprev),
                    ptr(None), ptr(None), strides, loader.DTYPE_CODES[
                        kqv.dtype], B, H, T, E,
                    attention.PATH_CODES["mma"], loader.stream_ptr()), name)

            ms = time_ms(torch, call, flush)
            line.append(f"{name} {ms:.4f}")
        print(f"B={B} T={T} ms: " + "; ".join(line), flush=True)
    print(card)


if __name__ == "__main__":
    main()
