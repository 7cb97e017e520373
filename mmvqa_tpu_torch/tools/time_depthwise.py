#!/usr/bin/env python3
"""Time the depthwise 3x3 kernels (K3, forward and backward) of one checkout
on the card.

    python3 mmvqa_tpu_torch/tools/time_depthwise.py [CHECKOUT]

Imports ``mmvqa_tpu_torch`` from CHECKOUT (default: the checkout this file
lies in), builds its kernels, checks both kernels against their plain
versions at B=16, and prints their times at the five stride-1 site shapes of
the flagship trunk at B=128, bf16 and fp32: CUDA events, median of 10, each
call queued behind a sleeping device with the L2 cache overwritten first (as
``chip_smoke.py`` times them), then the sums over one train step's 42 sites.
The library's calls for the same functions (``F.conv2d(groups=C)``,
``aten.convolution_backward``) are timed beside them. Then the host's
cost of a call: microseconds per call on the host clock over 200 calls
queued back to back with no sleep and no synchronise, at the eval batch
B=16 (where the card finishes a call sooner than the host issues the
next), for the wrappers and the library's calls. To compare two
versions, unpack the other one (``git archive``) into a directory and run
this script on both checkouts in turns within one job on one card: A, B, B,
A.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

# (H, W, C): sites of a train step, EfficientNetV2-M at 224 px
SITES = {(14, 14, 640): 6, (14, 14, 960): 1, (14, 14, 1056): 13,
         (7, 7, 1824): 18, (7, 7, 3072): 4}
B = 128
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
    import torch.nn.functional as F

    from mmvqa_tpu_torch.ops.depthwise import (
        depthwise3x3,
        depthwise3x3_backward,
        depthwise3x3_backward_reference,
        depthwise3x3_reference,
    )

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    print(f"{checkout} on {torch.cuda.get_device_name(0)}")
    for dtype in (torch.bfloat16, torch.float32):
        rows = {"fwd": [], "bwd": [], "library fwd": [], "library bwd": []}
        for (H, W, C), count in SITES.items():
            x = torch.randn(B, H, W, C, device=dev, generator=g).to(dtype)
            dy = torch.randn(B, H, W, C, device=dev, generator=g).to(dtype)
            w4 = torch.randn(C, 1, 3, 3, device=dev, generator=g) / 3
            w = w4[:, 0].permute(1, 2, 0)   # the fp32 master as the trunk's view
            wc = w4.to(dtype)
            xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
            xs, dys = x[:16], dy[:16]
            y_p = depthwise3x3_reference(xs, w).float()
            dx_p, dw_p = depthwise3x3_backward_reference(xs, w, dys)
            dx, dw = depthwise3x3_backward(xs, w, dys)
            rel = 8e-3 if dtype == torch.bfloat16 else 1e-4
            for what, got, want in (("y", depthwise3x3(xs, w), y_p),
                                    ("dx", dx, dx_p), ("dW", dw, dw_p)):
                err = (got.float() - want.float()).abs().max().item()
                if err > rel * want.float().abs().max().item():
                    sys.exit(f"depthwise3x3 {what} disagrees at {H}x{W}x{C} "
                             f"{dtype}: {err:.3e}")
            rows["fwd"].append(time_ms(torch, lambda: depthwise3x3(x, w), flush))
            rows["bwd"].append(time_ms(
                torch, lambda: depthwise3x3_backward(x, w, dy), flush))
            rows["library fwd"].append(time_ms(
                torch, lambda: F.conv2d(xn, wc, padding=1, groups=C), flush))
            rows["library bwd"].append(time_ms(
                torch, lambda: torch.ops.aten.convolution_backward(
                    dyn, xn, wc, None, [1, 1], [1, 1], [1, 1], False, [0, 0],
                    C, [True, True, False]), flush))
            del x, dy, xn, dyn
        counts = list(SITES.values())
        for name, times in rows.items():
            step = sum(t * n for t, n in zip(times, counts))
            print(f"  {str(dtype):15s} {name:12s} ms per site shape "
                  + " ".join(f"{t:.4f}" for t in times)
                  + f"  per step (42 sites) {step:.3f}")
        host = {"fwd": [], "bwd": [], "library fwd": [], "library bwd": []}
        for (H, W, C), count in SITES.items():
            x = torch.randn(16, H, W, C, device=dev, generator=g).to(dtype)
            dy = torch.randn(16, H, W, C, device=dev, generator=g).to(dtype)
            w4 = torch.randn(C, 1, 3, 3, device=dev, generator=g) / 3
            w, wc = w4[:, 0].permute(1, 2, 0), w4.to(dtype)
            xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
            host["fwd"].append(host_us(torch, lambda: depthwise3x3(x, w)))
            host["bwd"].append(host_us(
                torch, lambda: depthwise3x3_backward(x, w, dy)))
            host["library fwd"].append(host_us(
                torch, lambda: F.conv2d(xn, wc, padding=1, groups=C)))
            host["library bwd"].append(host_us(
                torch, lambda: torch.ops.aten.convolution_backward(
                    dyn, xn, wc, None, [1, 1], [1, 1], [1, 1], False, [0, 0],
                    C, [True, True, False])))
        for name, us in host.items():
            step = sum(t * n for t, n in zip(us, counts))
            print(f"  {str(dtype):15s} {name:12s} host us per call, B=16 "
                  + " ".join(f"{t:.2f}" for t in us)
                  + f"  per step (42 sites) {step / 1e3:.3f} ms")


if __name__ == "__main__":
    main()
