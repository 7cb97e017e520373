#!/usr/bin/env python3
"""Time a training BatchNorm's two elementwise passes as the trunk writes
them (``models/effnetv2.py::_BatchNormTrain``), on the card:

    python3 mmvqa_tpu_torch/tools/time_bn_tensor_code.py

forward   out = x * a + b                  (a, b per channel, fp32)
backward  dx  = a * dy + p * x + q         (a, p, q per channel, fp32)

over a channels-last bf16 map, at three of the flagship trunk's shapes,
B=128: one ``addcmul`` forward, two with an fp32 temporary backward, each
result rounded once. The library's ``batch_norm_elemt`` /
``batch_norm_backward_elemt`` are timed beside them as a yardstick; the port
does not call them. Device time by CUDA events, each call queued behind a
sleeping device so that host time does not count, the L2 cache overwritten
before it.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time

import torch

SHAPES = ((128, 24, 112, 112), (128, 1056, 14, 14), (128, 1824, 7, 7))
CLOCK_HZ = 1.98e9


def device_ms(fn, flush, reps=5):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(int((2 * host + 1e-4) * CLOCK_HZ))
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    for B, C, H, W in SHAPES:
        x = torch.randn(B, H, W, C, device=dev, generator=g).bfloat16()
        dy = torch.randn(B, H, W, C, device=dev, generator=g).bfloat16()
        x4, dy4 = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        a, b, p, q = (torch.randn(C, device=dev, generator=g)
                      for _ in range(4))
        a4, b4, p4, q4 = (t.view(1, C, 1, 1) for t in (a, b, p, q))
        out4 = torch.empty_like(x4)
        ones = torch.ones(C, device=dev)
        zeros = torch.zeros(C, device=dev)
        count = torch.tensor([B * H * W], dtype=torch.int32, device=dev)

        def backward():
            t = torch.addcmul(q4, x4, p4)  # fp32
            return torch.addcmul(t, dy4, a4, out=out4)

        variants = {
            "fwd the trunk's addcmul":
                lambda: torch.addcmul(b4, x4, a4, out=out4),
            "fwd library batch_norm_elemt (yardstick)":
                lambda: torch.batch_norm_elemt(x4, ones, zeros, b, a, 0.0),
            "bwd the trunk's two addcmuls":
                backward,
            "bwd library batch_norm_backward_elemt (yardstick)":
                lambda: torch.batch_norm_backward_elemt(
                    dy4, x4, b, a, ones, zeros, zeros, count),
        }
        n = x.numel()
        print(f"map (B, C, H, W) = {(B, C, H, W)}, bf16, {n / 1e6:.2f} M "
              f"elements")
        for name, fn in variants.items():
            ms = device_ms(fn, flush)
            print(f"  {ms:8.4f} ms  {n * 1e-6 / ms:7.2f} G elements/s  {name}")


if __name__ == "__main__":
    main()
