#!/usr/bin/env python3
"""Time the token head's forward kernel (K1-fwd) of one checkout on the card.

    python3 mmvqa_tpu_torch/tools/time_token_head.py [CHECKOUT]

Imports ``mmvqa_tpu_torch`` from CHECKOUT (default: the checkout this file
lies in), builds its kernels, checks the forward against the plain version
at B=16 and prints the kernel's time (CUDA events, median of 10) at the five
flagship taps, as the trunk hands them over: bf16 with SERF's polynomial at
B=128 and B=16, each with its sum; then bf16 at B=128 with ReLU in place of
SERF (the same products and staging without the special functions); then
fp32 at B=16. To compare two versions of the kernel, unpack the other one
(``git archive``) into a directory and run this script on both checkouts in
turns within one job on one card: A, B, B, A.

Each timed call is queued behind a sleeping device with the L2 cache
overwritten first (as ``chip_smoke.py`` times the trunk's kernels), so that
the time is the card's and not the host's; the host's own cost of a call,
microseconds on the host clock over 200 calls queued back to back, follows
at B=16 for the bf16 path.
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


def host_us(torch, fn, reps: int = 200, warmup: int = 20) -> float:
    """Microseconds of host time per call of fn, calls queued back to back
    (the synchronise comes after the clock stops)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / reps * 1e6


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    checkout = os.path.abspath(
        sys.argv[1] if len(sys.argv) > 1 else os.path.join(here, "..", ".."))
    sys.path.insert(0, checkout)
    import torch

    from mmvqa_tpu_torch.models.visual_tokens import tap_positions
    from mmvqa_tpu_torch.ops.token_head import (
        fused_token_head,
        token_head_reference,
    )

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    print(f"{checkout} on {torch.cuda.get_device_name(0)}")
    for dtype, act, batches in ((torch.bfloat16, "serf_fast", (128, 16)),
                                (torch.bfloat16, "relu", (128,)),
                                (torch.float32, "serf", (16,))):
        for B in batches:
            times, host = [], []
            for side, K in TAPS:
                feat = torch.randn(B, side, side, K, device=dev, generator=g)
                x = tap_positions(feat.to(dtype).permute(0, 3, 1, 2))
                w = (torch.randn(K, HIDDEN, device=dev, generator=g)
                     * K ** -0.5).to(dtype)
                if B == 16:
                    # bf16: both round one fp32 mean, two ulps apart; fp32:
                    # sums in another order (chip_smoke.py's limits)
                    got = fused_token_head(x, w, act).float()
                    want = token_head_reference(x, w, act).float()
                    rtol, atol = ((8e-3, 2e-3) if dtype == torch.bfloat16
                                  else (1e-4, 1e-5))
                    if ((got - want).abs() > atol + rtol * want.abs()).any():
                        sys.exit(f"K1-fwd disagrees at B={B} K={K} {dtype}")
                times.append(time_ms(
                    torch, lambda: fused_token_head(x, w, act), flush))
                if B == 16 and dtype == torch.bfloat16 and act != "relu":
                    host.append(host_us(
                        torch, lambda: fused_token_head(x, w, act)))
            print(f"  {str(dtype):15s} {act:9s} B={B:3d} ms per tap "
                  + " ".join(f"{t:.4f}" for t in times)
                  + f"  sum {sum(times):.4f}")
            if host:
                print(f"  {'':15s} {'':9s} B={B:3d} host us per call "
                      + " ".join(f"{t:.1f}" for t in host))


if __name__ == "__main__":
    main()
