#!/usr/bin/env python3
"""Time the BatchNorm-backward sums (K5) of one checkout on the card.

    python3 mmvqa_tpu_torch/tools/time_bn_sums.py [CHECKOUT]

Imports ``mmvqa_tpu_torch`` from CHECKOUT (default: the checkout this file
lies in), builds its kernels and, at each of the 18 site shapes of the
flagship trunk at B=128 in bf16 (a channels-last (N, C) map, as the trunk
hands it over), checks the kernel against its plain version and prints its
time beside the library call that gives the same sums
(``torch.batch_norm_backward_reduce`` on the map's (B, C, H, W) view) and
the bound: CUDA events, median of 10, each call queued behind a sleeping
device with the L2 cache overwritten first (as ``chip_smoke.py`` times
them), and the host's cost of a call (microseconds over 200 calls queued
back to back). Then the sums over one train step's 156 sites. To compare
two versions, unpack the other one (``git archive``) into a directory and
run this script on both checkouts in turns within one job on one card:
A, B, B, A.
"""

from __future__ import annotations

import os
import sys

# (N / B, C): sites of a train step, EfficientNetV2-M at 224 px
# (chip_smoke.py::trunk_sites)
SITES = {(49, 304): 18, (49, 512): 5, (49, 1056): 1, (49, 1824): 36,
         (49, 3072): 8, (196, 160): 7, (196, 176): 14, (196, 320): 1,
         (196, 640): 12, (196, 960): 2, (196, 1056): 27, (784, 80): 5,
         (784, 192): 1, (784, 320): 5, (3136, 48): 5, (3136, 96): 1,
         (3136, 192): 4, (12544, 24): 4}
B = 128
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12  # the H100 SXM data sheet


def bound_ms(N: int, C: int, itemsize: int) -> float:
    """x and dy read once, mean and inv_std read, the (2, C) sums written;
    five fp32 operations an element."""
    return 1e3 * max((2 * N * C * itemsize + 16 * C) / PEAK_BYTES,
                     5.0 * N * C / PEAK_F32)


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    checkout = os.path.abspath(
        sys.argv[1] if len(sys.argv) > 1 else os.path.join(here, "..", ".."))
    sys.path.insert(0, checkout)
    import torch

    from mmvqa_tpu_torch.ops.bn_sums import (
        bn_backward_sums,
        bn_backward_sums_reference,
    )
    from mmvqa_tpu_torch.tools.time_conv_bn import host_us, time_ms

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    print(f"{checkout} on {torch.cuda.get_device_name(0)}")
    total = {"kernel": 0.0, "library": 0.0, "bound": 0.0, "host": 0.0}
    for (rows, C), count in sorted(SITES.items()):
        N = B * rows
        x = (torch.randn(N, C, device=dev, generator=g) * 2 + 1).bfloat16()
        dy = torch.randn(N, C, device=dev, generator=g).bfloat16()
        mean = torch.randn(C, device=dev, generator=g)
        inv_std = 1 + torch.rand(C, device=dev, generator=g)
        s = bn_backward_sums(x, dy, mean, inv_std)
        p = bn_backward_sums_reference(x, dy, mean, inv_std)
        # fp32 sums of the same terms in another order (chip_smoke.py REL_K5)
        if any((s[i] - p[i]).abs().max() > 1e-4 * p[i].abs().max()
               for i in (0, 1)):
            sys.exit(f"K5 disagrees at N={N} C={C}")
        xn = x.view(B, rows, 1, C).permute(0, 3, 1, 2)
        dyn = dy.view(B, rows, 1, C).permute(0, 3, 1, 2)
        ones = torch.ones(C, device=dev)
        ms = time_ms(torch, lambda: bn_backward_sums(x, dy, mean, inv_std),
                     flush)
        lib = time_ms(torch, lambda: torch.batch_norm_backward_reduce(
            dyn, xn, mean, inv_std, ones, True, True, True), flush)
        bnd = bound_ms(N, C, 2)
        host = host_us(torch, lambda: bn_backward_sums(x, dy, mean, inv_std))
        print(f"  N={N:7d} C={C:4d} x{count:2d}: kernel {ms:.4f} ms  "
              f"batch_norm_backward_reduce {lib:.4f} ms  bound {bnd:.4f} ms "
              f"({100 * bnd / ms:.1f}%)  host {host:.1f} us a call",
              flush=True)
        for key, v in (("kernel", ms), ("library", lib), ("bound", bnd),
                       ("host", host / 1e3)):
            total[key] += count * v
        del x, dy, xn, dyn
    share = 100 * total["bound"] / total["kernel"]
    print(f"  156 sites: kernel {total['kernel']:.3f} ms  "
          f"batch_norm_backward_reduce {total['library']:.3f} ms  bound "
          f"{total['bound']:.3f} ms ({share:.1f}%)  host {total['host']:.3f} "
          f"ms")


if __name__ == "__main__":
    main()
