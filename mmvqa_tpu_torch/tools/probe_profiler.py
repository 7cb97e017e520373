#!/usr/bin/env python3
"""How often torch.profiler records no device event around a little card
work, and under which conditions (card only, about a minute).

    python3 mmvqa_tpu_torch/tools/probe_profiler.py [ROUNDS]

Each case opens ROUNDS profiles in a row (default 200), each around one
call, and counts the kernels the profile reports. The calls: K5
(``bn_backward_sums``, a kernel launched through ctypes, as the card test
``test_bn_backward_sums_is_one_launch`` profiles it) and a library kernel
(``torch.add``). The conditions: device activity alone (the card test's
setting) or host and device activity (``chip_smoke.py``'s); back to back,
or with a pause between profiles; the card synchronised before the profile
opens, or not; the call alone in the profile, with 1 ms of idle time
inside the profile before it and after it, with 100 ms before the profile
stops, after another kernel launched inside the profile, or with 8 spin
kernels (``torch.cuda._sleep``) after it inside the profile; and 100
library kernels in one profile. For every case it prints the profiles that
saw no kernel, those that saw fewer than they launched, those that saw
more (a delayed record would show up in the next profile), the smallest,
largest and median count, and where the empty ones sit in the sequence.
The first profile of the process is reported apart.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> None:
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from mmvqa_tpu_torch.ops.bn_sums import bn_backward_sums

    if not torch.cuda.is_available():
        raise SystemExit("probe_profiler: no CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    N, C = 25088, 24
    x = torch.randn(N, C, device=dev, generator=g).to(torch.bfloat16)
    dy = torch.randn(N, C, device=dev, generator=g).to(torch.bfloat16)
    mean = torch.randn(C, device=dev, generator=g)
    inv_std = 1 + torch.rand(C, device=dev, generator=g)
    a = torch.randn(1 << 20, device=dev, generator=g)

    calls = {
        "ctypes K5": (lambda: bn_backward_sums(x, dy, mean, inv_std),
                      "bn_backward_sums"),
        "torch.add": (lambda: torch.add(a, 1.0), "elementwise"),
    }

    warm = torch.zeros(1, device=dev)

    def count(call, tag, activities, sync_before, margin=0.0, tail=0.0,
              warm_up=False, pad=0):
        if sync_before:
            torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            time.sleep(margin)
            if warm_up:  # another kernel first, inside the profile
                warm.fill_(1.0)
                torch.cuda.synchronize()
            call()
            torch.cuda.synchronize()
            time.sleep(margin + tail)
            for _ in range(pad):  # spin kernels last, inside the profile
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and tag in e.key)

    cuda = [ProfilerActivity.CUDA]
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    first = count(*calls["ctypes K5"], cuda, True)
    print(f"first profile of the process (ctypes K5, device activity only): "
          f"{first} kernel(s)")
    calls["torch.add x100"] = (
        lambda: [torch.add(a, 1.0) for _ in range(100)], "elementwise")
    # (call, what, activities, sync before, pause between, idle at both
    # ends, idle before the profile stops, another kernel first[, spin
    # kernels last])
    cases = [
        ("ctypes K5", "device only, 8 spin kernels last", cuda, True, 0.0,
         0.0, 0.0, False, 8),
        ("ctypes K5", "host + device, 8 spin kernels last", both, True, 0.0,
         0.0, 0.0, False, 8),
        ("torch.add x100", "host + device, 8 spin kernels last", both, True,
         0.0, 0.0, 0.0, False, 8),
        ("ctypes K5", "device only", cuda, True, 0.0, 0.0, 0.0, False),
        ("ctypes K5", "device only, no sync before", cuda, False, 0.0, 0.0,
         0.0, False),
        ("ctypes K5", "device only, 20 ms apart", cuda, True, 0.02, 0.0, 0.0,
         False),
        ("ctypes K5", "device only, 1 ms idle inside at both ends", cuda,
         True, 0.0, 0.001, 0.0, False),
        ("ctypes K5", "device only, 100 ms idle before the profile stops",
         cuda, True, 0.0, 0.0, 0.1, False),
        ("ctypes K5", "device only, another kernel first", cuda, True, 0.0,
         0.0, 0.0, True),
        ("ctypes K5", "host + device", both, True, 0.0, 0.0, 0.0, False),
        ("ctypes K5", "host + device, another kernel first", both, True, 0.0,
         0.0, 0.0, True),
        ("torch.add", "device only", cuda, True, 0.0, 0.0, 0.0, False),
        ("torch.add", "host + device", both, True, 0.0, 0.0, 0.0, False),
        ("torch.add x100", "device only", cuda, True, 0.0, 0.0, 0.0, False),
        ("torch.add x100", "host + device", both, True, 0.0, 0.0, 0.0, False),
    ]
    for name, what, acts, sync, pause, margin, tail, warm_up, *pad in cases:
        fn, tag = calls[name]
        fn()
        torch.cuda.synchronize()
        seq = []
        t0 = time.perf_counter()
        for _ in range(rounds):
            seq.append(count(fn, tag, acts, sync, margin, tail, warm_up,
                             *pad))
            if pause:
                time.sleep(pause)
        dt = time.perf_counter() - t0
        empty = [i for i, c in enumerate(seq) if c == 0]
        want = 100 if "x100" in name else 1
        short = [i for i, c in enumerate(seq) if 0 < c < want]
        more = [i for i, c in enumerate(seq) if c > want]
        print(f"{name}, {what}: {rounds} profiles in {dt:.1f} s, "
              f"{len(empty)} with no kernel (at {empty[:12]}), {len(short)} "
              f"with fewer than {want}, {len(more)} with more (at "
              f"{more[:12]}), counts {min(seq)}..{max(seq)}, median "
              f"{sorted(seq)[len(seq) // 2]}")


if __name__ == "__main__":
    main()
