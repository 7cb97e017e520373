#!/usr/bin/env python3
"""Time the token head's backward kernel (K1-bwd) of one checkout on the card.

    python3 mmvqa_tpu_torch/tools/time_token_head_backward.py [CHECKOUT]

Imports ``mmvqa_tpu_torch`` from CHECKOUT (default: the checkout this file
lies in), builds its kernels, checks the backward against the plain version at
B=16 and prints the kernel's time (CUDA events, median of 10, each call queued
behind a sleeping device with the L2 cache overwritten first, so that the time
is the card's and not the host's) at the five flagship taps for bf16 and fp32
at B=128 and B=16, each with its sum; then
bf16 at B=128 with ReLU in place of SERF, whose derivative is a compare: the
same products and stages without the special functions. To compare two
versions of the kernel, unpack the other one (``git archive``) into a
directory and run this script on both checkouts in turns within one job on
one card: A, B, B, A.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

TAPS = ((112, 24), (56, 48), (28, 80), (14, 176), (7, 512))  # (side, K)
HIDDEN = 768
SM_CLOCK_HZ = 1.98e9


def time_ms(torch, fn, flush, reps: int = 10, warmup: int = 3) -> float:
    host = 0.0
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(int((2 * host + 1e-4) * SM_CLOCK_HZ))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    checkout = os.path.abspath(
        sys.argv[1] if len(sys.argv) > 1 else os.path.join(here, "..", ".."))
    sys.path.insert(0, checkout)
    import torch

    from mmvqa_tpu_torch.models.visual_tokens import tap_positions
    from mmvqa_tpu_torch.ops.token_head import (
        token_head_backward,
        token_head_backward_reference,
    )

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    print(f"{checkout} on {torch.cuda.get_device_name(0)}")
    for dtype, act, batches in ((torch.bfloat16, "serf_fast", (128, 16)),
                                (torch.float32, "serf", (128, 16)),
                                (torch.bfloat16, "relu", (128,))):
        for B in batches:
            times = []
            for side, K in TAPS:
                feat = torch.randn(B, side, side, K, device=dev, generator=g)
                x = tap_positions(feat.to(dtype).permute(0, 3, 1, 2))
                w = (torch.randn(K, HIDDEN, device=dev, generator=g)
                     * K ** -0.5).to(dtype)
                gout = torch.randn(B, HIDDEN, device=dev, generator=g)
                if B == 16:
                    dx, dw = token_head_backward(x, w, gout, act)
                    dx_p, dw_p = token_head_backward_reference(x, w, gout, act)
                    # a bf16 ulp is up to 2^-7 of its value; bf16 dW: where
                    # gact is rounded to bf16 before the product, sums of s
                    # in another order move dW by up to half of 1e-3 of its
                    # largest entry (chip_smoke.py, ATOL_K1_BWD_DW_BF16)
                    bf16 = dtype == torch.bfloat16
                    rel = 8e-3 if bf16 else 1e-4
                    rel_dw = 1e-3 if bf16 else 1e-4
                    for got, want, tol in ((dx, dx_p, rel), (dw, dw_p, rel_dw)):
                        err = (got.float() - want.float()).abs().max().item()
                        if err > tol * want.float().abs().max().item():
                            sys.exit(f"K1-bwd disagrees at B={B} K={K} "
                                     f"{dtype}: {err:.3e}")
                times.append(time_ms(
                    torch, lambda: token_head_backward(x, w, gout, act),
                    flush))
            print(f"  {str(dtype):15s} {act:9s} B={B:3d} ms per tap "
                  + " ".join(f"{t:.3f}" for t in times)
                  + f"  sum {sum(times):.3f}")


if __name__ == "__main__":
    main()
