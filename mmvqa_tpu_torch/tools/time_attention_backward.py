#!/usr/bin/env python3
"""Time the attention backward (K2-bwd) of one checkout on the card.

    python3 mmvqa_tpu_torch/tools/time_attention_backward.py [CHECKOUT] [--fp32]

Imports ``mmvqa_tpu_torch`` from CHECKOUT (default: the checkout this file
lies in), builds its kernels and times ``realformer_attention_backward`` at
the flagship's 8 heads of 96 in bf16: the four layers of a train step at
B=128, T=75 with padded queries (layer 0 has no prev, so it wants no dprev;
the last layer's carry has no consumer, so it gets no dcarry), then one
layer with prev at T=28 (the eval path's length) at B=128 and B=16. With
``--fp32``, in fp32 (the CLIs' default dtype): the four layers of the CLIs'
train step at B=16, T=75, one layer with prev at T=28 at B=16 and B=1 (the
Grad-CAM CLI's) and at T=96 (the longest head the fp32 tensor-core
backward takes at E=96). Each case is first checked against the plain
version (``chip_smoke.py``'s tolerances), then timed: CUDA events, median
of 10, each call queued behind a sleeping device with the L2 cache
overwritten first, beside the plain version's time, the bound (inputs read
once, outputs written once, over 3.35 TB/s; in fp32 the larger of that and
the split-TF32 products at 165 TFLOP/s), and the host's cost of a call. To
compare two versions, unpack the other one (``git archive``) into a
directory and run this script on both checkouts in turns within one job on
one card: A, B, B, A.
"""

from __future__ import annotations

import os
import sys

H, E = 8, 96
PEAK_BYTES = 3.35e12  # the H100 SXM data sheet
PEAK_TF32X3 = 495e12 / 3  # dense TF32, three products a split-TF32 product
# (label, B, T, the layer has a prev (and wants dprev), its carry has a
# consumer (dcarry given)): the train step's four layers, then T=28
CASES = [("train layer 0", 128, 75, False, True),
         ("train layer 1", 128, 75, True, True),
         ("train layer 2", 128, 75, True, True),
         ("train layer 3", 128, 75, True, False),
         ("T=28 B=128", 128, 28, True, True),
         ("T=28 B=16", 16, 28, True, True)]
FP32_CASES = [("train layer 0", 16, 75, False, True),
              ("train layer 1", 16, 75, True, True),
              ("train layer 2", 16, 75, True, True),
              ("train layer 3", 16, 75, True, False),
              ("T=28 B=16", 16, 28, True, True),
              ("T=28 B=1", 1, 28, True, True),
              ("T=96 B=16", 16, 96, True, True)]


def bound_ms(B: int, T: int, with_prev: bool, with_dcarry: bool,
             itemsize: int = 2) -> float:
    """q, k, v, dctx in and dq, dk, dv out in the dtype; the fp32 carry in,
    dcarry in and dprev out where the layer has them; in fp32 (itemsize 4)
    the larger of that and the four products' split-TF32 operations."""
    tiles = 1 + int(with_prev) + int(with_dcarry)
    nbytes = 7 * B * T * H * E * itemsize + tiles * B * H * T * T * 4
    ops = 4 * 2.0 * B * H * T * T * E if itemsize == 4 else 0.0
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
        realformer_attention_backward,
        realformer_attention_backward_reference,
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
    for label, B, T, with_prev, with_dcarry in (FP32_CASES if fp32
                                                else CASES):
        kqv = torch.randn(B, T, H, 3 * E, device=dev,
                          generator=g).to(dtype)
        k, q, v = kqv.split(E, dim=-1)
        prev = (torch.randn(B, H, T, T, device=dev, generator=g)
                if with_prev else None)
        lengths = torch.randint(T // 2, T + 1, (B,), device=dev, generator=g)
        mask = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()
        _, carry = realformer_attention(q, k, v, prev, mask)
        dctx = torch.randn(B, T, H, E, device=dev, generator=g).to(dtype)
        dcarry = (0.1 * torch.randn(B, H, T, T, device=dev, generator=g)
                  if with_dcarry else None)

        def kernel():
            return realformer_attention_backward(kqv, carry, dctx, dcarry,
                                                 with_prev)

        def plain():
            return realformer_attention_backward_reference(q, k, v, carry,
                                                           dctx, dcarry)

        dkqv, dprev = kernel()
        dq, dk, dv, ds = plain()
        want = torch.cat([dk, dq, dv], dim=-1).float()
        # chip_smoke.py TOL_K2_BWD_BF16 (TOL_K2_BWD in fp32) and TOL_K2_BWD
        rtol = 5e-4 if fp32 else 8e-3
        bad = (dkqv.float() - want).abs() > 5e-5 + rtol * want.abs()
        if with_prev:
            bad_p = (dprev - ds).abs() > 5e-5 + 5e-4 * ds.abs()
            bad = bad.any() | bad_p.any()
        if bad.any():
            sys.exit(f"K2-bwd disagrees: {label}")
        del dkqv, dprev, dq, dk, dv, ds, want
        ms = time_ms(torch, kernel, flush)
        plain_ms = time_ms(torch, plain, flush)
        bnd = bound_ms(B, T, with_prev, with_dcarry, kqv.element_size())
        host = host_us(torch, kernel)
        print(f"  {label:14s} B={B:3d} T={T} prev={int(with_prev)} "
              f"dcarry={int(with_dcarry)}: kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  bound {bnd:.4f} ms ({100 * bnd / ms:.1f}%)"
              f"  host {host:.1f} us a call", flush=True)
        if label.startswith("train"):
            for key, val in (("kernel", ms), ("plain", plain_ms),
                             ("bound", bnd)):
                step[key] += val
    print(f"  train step, 4 layers: kernel {step['kernel']:.4f} ms  plain "
          f"{step['plain']:.4f} ms  bound {step['bound']:.4f} ms "
          f"({100 * step['bound'] / step['kernel']:.1f}%)")


if __name__ == "__main__":
    main()
