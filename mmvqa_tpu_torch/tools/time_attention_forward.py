#!/usr/bin/env python3
"""Time the attention forward (K2-fwd) of one checkout on the card.

    python3 mmvqa_tpu_torch/tools/time_attention_forward.py [CHECKOUT] [--fp32]

Imports ``mmvqa_tpu_torch`` from CHECKOUT (default: the checkout this file
lies in), builds its kernels and times ``realformer_attention`` at the
flagship's 8 heads of 96 in bf16: the four layers of a train step at B=128,
T=75 with padded queries (layer 0 has no prev), then one layer with prev at
T=28 (the eval path's length) at B=128 and B=16. With ``--fp32``, in fp32
(the CLIs' default dtype): the four layers of the CLIs' train step at B=16,
T=75, one layer with prev at T=28 at B=16 and B=1 (the Grad-CAM CLI's) and
at T=128 (the longest head the fp32 tensor-core forward takes at E=96).
Each case is first checked against the plain version (``chip_smoke.py``'s
tolerances), then timed: CUDA events, median of 10, each call queued behind
a sleeping device with the L2 cache overwritten first, beside the plain
version's time, the bound (inputs read once, outputs written once, over
3.35 TB/s; in fp32 the larger of that and the split-TF32 products at 165
TFLOP/s), and the host's cost of a call. To compare two versions, unpack
the other one (``git archive``) into a directory and run this script on
both checkouts in turns within one job on one card: A, B, B, A.
"""

from __future__ import annotations

import os
import sys

H, E = 8, 96
PEAK_BYTES = 3.35e12  # the H100 SXM data sheet
PEAK_TF32X3 = 495e12 / 3  # dense TF32, three products a split-TF32 product
# (label, B, T, the layer has a prev): the train step's four layers, then
# T=28
CASES = [("train layer 0", 128, 75, False),
         ("train layer 1", 128, 75, True),
         ("train layer 2", 128, 75, True),
         ("train layer 3", 128, 75, True),
         ("T=28 B=128", 128, 28, True),
         ("T=28 B=16", 16, 28, True)]
FP32_CASES = [("train layer 0", 16, 75, False),
              ("train layer 1", 16, 75, True),
              ("train layer 2", 16, 75, True),
              ("train layer 3", 16, 75, True),
              ("T=28 B=16", 16, 28, True),
              ("T=28 B=1", 1, 28, True),
              ("T=128 B=16", 16, 128, True)]


def bound_ms(B: int, T: int, with_prev: bool, itemsize: int = 2) -> float:
    """q, k, v in and ctx out in the dtype; the mask in; the fp32 carry out,
    and prev in where the layer has one; in fp32 (itemsize 4) the larger of
    that and the two products' split-TF32 operations."""
    tiles = 1 + int(with_prev)
    nbytes = (4 * B * T * H * E * itemsize + tiles * B * H * T * T * 4
              + B * T * 4)
    ops = 2 * 2.0 * B * H * T * T * E if itemsize == 4 else 0.0
    return 1e3 * max(nbytes / PEAK_BYTES, ops / PEAK_TF32X3)


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    args = [a for a in sys.argv[1:] if a != "--fp32"]
    fp32 = "--fp32" in sys.argv[1:]
    checkout = os.path.abspath(
        args[0] if args else os.path.join(here, "..", ".."))
    sys.path.insert(0, checkout)
    import torch

    from mmvqa_tpu_torch.ops.attention import (
        realformer_attention,
        realformer_attention_reference,
    )
    from mmvqa_tpu_torch.tools.time_conv_bn import host_us, time_ms

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    dtype = torch.float32 if fp32 else torch.bfloat16
    print(f"{checkout} on {torch.cuda.get_device_name(0)}, {dtype}")
    step = {"kernel": 0.0, "plain": 0.0, "bound": 0.0}
    for label, B, T, with_prev in FP32_CASES if fp32 else CASES:
        kqv = torch.randn(B, T, H, 3 * E, device=dev,
                          generator=g).to(dtype)
        k, q, v = kqv.split(E, dim=-1)
        prev = (torch.randn(B, H, T, T, device=dev, generator=g)
                if with_prev else None)
        lengths = torch.randint(T // 2, T + 1, (B,), device=dev, generator=g)
        valid = torch.arange(T, device=dev)[None] < lengths[:, None]
        mask = valid.float()

        def kernel():
            return realformer_attention(q, k, v, prev, mask)

        def plain():
            return realformer_attention_reference(q, k, v, prev, mask)

        ctx, carry = kernel()
        ctx_p, carry_p = plain()
        err = (ctx.float() - ctx_p.float()).abs()
        want = ctx_p.float().abs()
        if fp32:  # chip_smoke.py TOL_K2_VALID and TOL_K2_PADDED
            bad = ((err > 2e-5 + 2e-5 * want) & valid[..., None, None]).any()
            bad |= (err > 2e-3 + 5e-3 * want).any()
        else:  # chip_smoke.py TOL_BF16
            bad = (err > 2e-3 + 8e-3 * want).any()
        # chip_smoke.py TOL_K2_CARRY
        bad |= ((carry - carry_p).abs() > 2e-4 + 2e-5 * carry_p.abs()).any()
        if bad:
            sys.exit(f"K2-fwd disagrees: {label}")
        del ctx, carry, ctx_p, carry_p
        ms = time_ms(torch, kernel, flush)
        plain_ms = time_ms(torch, plain, flush)
        bnd = bound_ms(B, T, with_prev, kqv.element_size())
        host = host_us(torch, kernel)
        print(f"  {label:14s} B={B:3d} T={T} prev={int(with_prev)}: kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bnd:.4f} ms "
              f"({100 * bnd / ms:.1f}%)  host {host:.1f} us a call",
              flush=True)
        if label.startswith("train"):
            for key, val in (("kernel", ms), ("plain", plain_ms),
                             ("bound", bnd)):
                step[key] += val
    print(f"  train step, 4 layers: kernel {step['kernel']:.4f} ms  plain "
          f"{step['plain']:.4f} ms  bound {step['bound']:.4f} ms "
          f"({100 * step['bound'] / step['kernel']:.1f}%)")


if __name__ == "__main__":
    main()
