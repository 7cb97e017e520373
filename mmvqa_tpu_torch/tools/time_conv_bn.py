#!/usr/bin/env python3
"""Time conv1x1 + BatchNorm statistics (K4) of one checkout on the card.

    python3 mmvqa_tpu_torch/tools/time_conv_bn.py [--fp32 [B]] [CHECKOUT]

Imports ``mmvqa_tpu_torch`` from CHECKOUT (default: the checkout this file
lies in), builds its kernels and, at each of the 18 site shapes of the
flagship trunk at B=128 in bf16 (w the convolution's (C, K) weight as its
(K, C) view, as the trunk hands it over), checks the kernel against its
plain version and prints its time beside the two library calls that give
the same results (``F.conv2d`` then ``torch.batch_norm_stats``) and the
bound: CUDA events, median of 10, each call queued behind a sleeping device
with the L2 cache overwritten first (as ``chip_smoke.py`` times them), and
the host's cost of a call: microseconds on the host clock over 200 calls
queued back to back. Then the sums over one train step's 98 sites. With
``--fp32`` the same in fp32 at batch B (default 128) with TF32 off, the
plain version timed too and the bound on the tensor cores as three TF32
products (a third of 495 TFLOP/s). To compare two versions, unpack the
other one (``git archive``) into a directory and run this script on both
checkouts in turns within one job on one card: A, B, B, A.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

# (N / B, K, C): sites of a train step, EfficientNetV2-M at 224 px
SITES = {(49, 304, 1824): 18, (49, 512, 3072): 4, (49, 1056, 304): 1,
         (49, 1824, 304): 17, (49, 1824, 512): 1, (49, 3072, 512): 4,
         (196, 160, 640): 6, (196, 160, 960): 1, (196, 176, 1056): 14,
         (196, 320, 160): 1, (196, 640, 160): 6, (196, 960, 176): 1,
         (196, 1056, 176): 13, (784, 80, 320): 1, (784, 192, 80): 1,
         (784, 320, 80): 4, (3136, 96, 48): 1, (3136, 192, 48): 4}
SM_CLOCK_HZ = 1.98e9
# the H100 SXM data sheet: bytes, dense bf16, a third of dense TF32
PEAK_BYTES, PEAK_BF16, PEAK_TF32X3 = 3.35e12, 989e12, 495e12 / 3


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
    args = sys.argv[1:]
    fp32 = args[:1] == ["--fp32"]
    B = 128
    if fp32:
        args = args[1:]
        if args[:1] and args[0].isdigit():
            B, args = int(args[0]), args[1:]
    here = os.path.dirname(os.path.abspath(__file__))
    checkout = os.path.abspath(
        args[0] if args else os.path.join(here, "..", ".."))
    sys.path.insert(0, checkout)
    import torch
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = torch.float32 if fp32 else torch.bfloat16
    size, peak = (4, PEAK_TF32X3) if fp32 else (2, PEAK_BF16)
    from mmvqa_tpu_torch.ops.conv_bn import (
        conv1x1_stats,
        conv1x1_stats_reference,
    )

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    print(f"{checkout} on {torch.cuda.get_device_name(0)}, {dtype}, B={B}")
    total = {"kernel": 0.0, "plain": 0.0, "library": 0.0, "bound": 0.0,
             "host": 0.0}
    for (rows, K, C), count in sorted(SITES.items()):
        N = B * rows
        x = torch.randn(N, K, device=dev, generator=g).to(dtype)
        wt = (torch.randn(C, K, device=dev, generator=g) * K ** -0.5).to(dtype)
        w = wt.t()
        y, st = conv1x1_stats(x, w)
        y_p, st_p = conv1x1_stats_reference(x, w)
        # y: bf16 two ulps, fp32 TOL_K4_F32; the sums: 1e-4 of their largest
        # (chip_smoke.py)
        rtol, atol = (2e-5, 2e-5) if fp32 else (8e-3, 2e-3)
        err = (y.float() - y_p.float()).abs()
        if (err > atol + rtol * y_p.float().abs()).any() or any(
                (st[i] - st_p[i]).abs().max() > 1e-4 * st_p[i].abs().max()
                for i in (0, 1)):
            sys.exit(f"K4 disagrees at N={N} K={K} C={C}")
        del y, st, y_p, st_p
        xn = x.view(B, rows, 1, K).permute(0, 3, 1, 2)
        w4 = wt.view(C, K, 1, 1)
        ms = time_ms(torch, lambda: conv1x1_stats(x, w), flush)
        plain = (time_ms(torch, lambda: conv1x1_stats_reference(x, w), flush)
                 if fp32 else 0.0)
        lib = time_ms(torch, lambda: torch.batch_norm_stats(
            F.conv2d(xn, w4), 1e-3), flush)
        bound = 1e3 * max(
            ((N * K + K * C + N * C) * size + 8 * C) / PEAK_BYTES,
            (2.0 * N * K * C + 3.0 * N * C) / peak)
        host = host_us(torch, lambda: conv1x1_stats(x, w))
        print(f"  N={N:6d} K={K:4d} C={C:4d} x{count:2d}: kernel {ms:.4f} ms"
              + (f"  plain {plain:.4f} ms" if fp32 else "")
              + f"  conv2d + batch_norm_stats {lib:.4f} ms  bound {bound:.4f}"
              f" ms ({100 * bound / ms:.1f}%)  host {host:.1f} us a call")
        for key, v in (("kernel", ms), ("plain", plain), ("library", lib),
                       ("bound", bound), ("host", host / 1e3)):
            total[key] += count * v
        del x, xn
    print(f"  98 sites: kernel {total['kernel']:.3f} ms"
          + (f"  plain {total['plain']:.3f} ms" if fp32 else "")
          + f"  conv2d + batch_norm_stats {total['library']:.3f} ms  bound "
          f"{total['bound']:.3f} ms  host {total['host']:.3f} ms")


if __name__ == "__main__":
    main()
