#!/usr/bin/env python3
"""Time the token head's forward kernel (K1-fwd) of one checkout on the card.

    python3 mmvqa_tpu_torch/tools/time_token_head.py [CHECKOUT] [--fp32-only]
        [--slices]

Imports ``mmvqa_tpu_torch`` from CHECKOUT (default: the checkout this file
lies in), builds its kernels and prints the kernel's time (CUDA events,
median of 10) at the taps as the trunk hands them over:

- bf16 at the five flagship taps with SERF's polynomial at B=128 and B=16,
  each with its sum, checked against the plain version at B=16; then bf16 at
  B=128 with ReLU in place of SERF (the same products and staging without
  the special functions);
- fp32 with exact SERF (the CLIs' default dtype) at the five taps of both
  models, the flagship's and the default ResNet-152's, at B=16 (the CLIs')
  and B=128, each checked against the plain version, timed beside it, and
  beside its bound: the larger of the bytes (x and W read once, the output
  written once) over 3.35 TB/s, the products as split-TF32 products over
  165 TFLOP/s (a third of the dense TF32 rate) and SERF's own time, its FP32
  instructions an element over 128 lanes x 132 SMs x 1.98 GHz; the column
  ``binds`` names the largest. SERF's count is read from this checkout's
  SASS (``cuobjdump -sass``): the FP32 instructions of the fp32 forward
  kernel with SERF less those of the same kernel with ReLU, over the
  activations the kernel's code holds (where the checkout has that kernel;
  else no SERF time is given).

Each timed call is queued behind a sleeping device with the L2 cache
overwritten first (as ``chip_smoke.py`` times the trunk's kernels), so that
the time is the card's and not the host's; the host's own cost of a call,
microseconds on the host clock over 200 calls queued back to back, follows
at B=16 for the bf16 path. ``--fp32-only`` times the fp32 part alone.
``--slices`` then times the fp32 forward where W streams (K >= 176: the
taps of both models from the flagship's stage 4 and ResNet's layer3 down)
at B=8, 16 and 128 with K cut into 1, 2, 3, 4, 6, 8, 12 and 16 slices and
the plan's count, a 64-row tile a block where K is cut, and marks the
plan's count
(``fp32_forward_plan``; a checkout without it is not swept). To compare
two versions of the kernel, unpack the other one (``git archive``) into a
directory and run this script on both checkouts in turns within one job on
one card: A, B, B, A.
"""

from __future__ import annotations

import collections
import os
import re
import statistics
import subprocess
import sys
import time

TAPS = ((112, 24), (56, 48), (28, 80), (14, 176), (7, 512))  # (side, K)
RESNET_TAPS = ((7, 2048), (14, 1024), (28, 512), (56, 256), (112, 64))
HIDDEN = 768
SM_CLOCK_HZ = 1.98e9
PEAK_BYTES = 3.35e12        # H100 SXM device memory
PEAK_TF32X3 = 495e12 / 3    # fp32 products as three TF32 products
FP32_LANES = 128 * 132 * SM_CLOCK_HZ  # FP32 instructions a second
# the fp32 forward kernel's variants (csrc/token_head.cu, k1::fwd32):
# (rows a tile, W resident) -> the activations a thread's code holds, the
# m16 tiles of its rows times 4 n8 fragments times 4 accumulators
FP32_KERNEL = "token_head_fwd_tf32x3_kernel"
FP32_VARIANTS = {(16, 1): 1 * 16, (64, 0): 4 * 16}
ACT_CODE = {"serf": 0, "relu": 2}   # k1::Act


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


def sass_opcodes(library: str) -> dict:
    """{kernel's mangled name: Counter of its SASS opcodes} of the fp32
    forward's variants in ``library``."""
    from mmvqa_tpu_torch.native import loader

    cuobjdump = os.path.join(os.path.dirname(loader.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for body in re.split(r"\n\s+Function : ", sass)[1:]:
        name = body.split("\n", 1)[0].strip()
        if FP32_KERNEL not in name:
            continue
        ops = collections.Counter()
        for line in body.splitlines():
            m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)", line)
            if m:
                ops[m.group(1)] += 1
        out[name] = ops
    return out


def fp32_class(op: str) -> bool:
    """Instructions of the FP32 pipe (and the special-function unit's MUFU,
    counted apart)."""
    return op.startswith("F") or op.startswith("I2FP")


def serf_instructions(library: str):
    """SERF's FP32 instructions an element in the fp32 forward, from the
    SASS: for each variant, the FP32 instructions of its SERF kernel less
    its ReLU kernel's, over the activations its code holds; also the MUFU
    instructions an element and every opcode that differs. None where the
    library has no such kernel."""
    ops = sass_opcodes(library)
    found = {}
    for (tp, res), sites in FP32_VARIANTS.items():
        pair = []
        for act in ("serf", "relu"):
            key = f"{FP32_KERNEL}ILi{ACT_CODE[act]}ELi{tp}ELb{res}E"
            hit = [c for name, c in ops.items() if key in name]
            if len(hit) != 1:
                return None
            pair.append(hit[0])
        serf, relu = pair
        diff = {op: serf[op] - relu[op] for op in set(serf) | set(relu)
                if serf[op] != relu[op]}
        fp32 = sum(v for op, v in diff.items()
                   if fp32_class(op) and not op.startswith("MUFU"))
        mufu = sum(v for op, v in diff.items() if op.startswith("MUFU"))
        found[(tp, res)] = (fp32 / sites, mufu / sites, diff,
                            sum(serf.values()), sum(relu.values()))
    return found


def fp32_bound(B, P, K, serf_per_element):
    """(ms, what binds) of the fp32 forward: bytes, split-TF32 products or
    SERF's FP32 instructions."""
    parts = {"bytes": 4.0 * (B * P * K + K * HIDDEN + B * HIDDEN) / PEAK_BYTES,
             "products": 2.0 * B * P * K * HIDDEN / PEAK_TF32X3}
    if serf_per_element is not None:
        parts["SERF"] = B * P * HIDDEN * serf_per_element / FP32_LANES
    what = max(parts, key=parts.get)
    return 1e3 * parts[what], what, {k: 1e3 * v for k, v in parts.items()}


def slice_sweep(torch, dev, g, flush) -> None:
    """The fp32 forward at the wide-K taps with K cut into each slice count
    (``--slices``), calling the kernel's entry point with the plan's fields
    but ``ks`` (and a tile a block where ``ks`` > 1)."""
    from mmvqa_tpu_torch.native import loader
    from mmvqa_tpu_torch.ops import token_head as th

    if not hasattr(th, "fp32_forward_plan"):
        print("  --slices: no fp32_forward_plan in this checkout")
        return
    lib = loader.library()
    ptr = loader.ptr
    taps = sorted({(s * s, k) for s, k in TAPS + RESNET_TAPS if k >= 176},
                  key=lambda t: -t[1])
    for B in (8, 16, 128):
        for P, K in taps:
            x = torch.randn(B, P, K, device=dev, generator=g)
            w = torch.randn(K, HIDDEN, device=dev, generator=g) * K ** -0.5
            want = th.token_head_reference(x, w, "serf")
            chosen = th._fp32_forward_plan(x, K, HIDDEN, "serf")
            items = -(-B * P // chosen.tp)
            line = []
            for ks in sorted({1, 2, 3, 4, 6, 8, 12, 16, chosen.ks}):
                if ks > -(-K // 32):
                    continue
                per = chosen.per_block if ks == 1 else 1
                plan = chosen._replace(
                    per_block=per, nblocks=-(-items // per), ks=ks,
                    slots=min(B, (per * chosen.tp - 1) // P + 2))
                shape, spart_n, n_counters = th.fp32_forward_scratch(
                    plan, B, HIDDEN)
                part = torch.empty(shape, device=dev)
                spart = torch.empty(max(spart_n, 1), device=dev)
                counter = torch.zeros(n_counters, device=dev,
                                      dtype=torch.int32)
                out = torch.empty(B, HIDDEN, device=dev)

                def call():
                    loader.check(lib.token_head_fwd_tf32x3(
                        ptr(x), *x.stride(), ptr(w), ptr(part), ptr(out),
                        ptr(counter), ptr(spart), B, P, K, HIDDEN,
                        th.ACTS["serf"], *plan, loader.stream_ptr()),
                        "token_head_fwd_tf32x3")

                call()
                torch.cuda.synchronize()
                if ((out - want).abs() > 1e-5 + 1e-4 * want.abs()).any():
                    sys.exit(f"K1-fwd disagrees at B={B} P={P} K={K} "
                             f"ks={ks}")
                ms = time_ms(torch, call, flush)
                line.append(f"{ks}{'*' if ks == chosen.ks else ''} {ms:.4f}")
            print(f"  fp32 serf B={B:3d} P={P:5d} K={K:4d} ms by K slices "
                  f"(* the plan's): " + "; ".join(line))
            del x, w, want


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    fp32_only = "--fp32-only" in sys.argv[1:]
    slices = "--slices" in sys.argv[1:]
    checkout = os.path.abspath(
        args[0] if args else os.path.join(here, "..", ".."))
    sys.path.insert(0, checkout)
    import torch

    from mmvqa_tpu_torch.models.visual_tokens import tap_positions
    from mmvqa_tpu_torch.native import loader
    from mmvqa_tpu_torch.ops.token_head import (
        fused_token_head,
        token_head_reference,
    )

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    print(f"{checkout} on {torch.cuda.get_device_name(0)}")
    library = loader.build()
    serf = serf_instructions(library)
    per_element = None
    if serf:
        for (tp, res), (fp32, mufu, diff, n_serf, n_relu) in serf.items():
            print(f"  SERF in the SASS of {FP32_KERNEL}<TP={tp}, "
                  f"{'W resident' if res else 'W streamed'}>: {fp32:.2f} "
                  f"FP32 and {mufu:.2f} MUFU instructions an element "
                  f"({n_serf} instructions with SERF, {n_relu} with ReLU; "
                  f"the opcodes that differ: "
                  f"{sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:16]})")
        per_element = serf[(16, 1)][0]
    else:
        print(f"  SERF's instructions: no {FP32_KERNEL} in this checkout")

    def taps_tensors(dtype, B, side, K):
        feat = torch.randn(B, side, side, K, device=dev, generator=g)
        x = tap_positions(feat.to(dtype).permute(0, 3, 1, 2))
        w = (torch.randn(K, HIDDEN, device=dev, generator=g)
             * K ** -0.5).to(dtype)
        return x, w

    bf16_runs = () if fp32_only else (
        (torch.bfloat16, "serf_fast", (128, 16)),
        (torch.bfloat16, "relu", (128,)))
    for dtype, act, batches in bf16_runs:
        for B in batches:
            times, host = [], []
            for side, K in TAPS:
                x, w = taps_tensors(dtype, B, side, K)
                if B == 16:
                    # both round one fp32 mean, two ulps apart
                    got = fused_token_head(x, w, act).float()
                    want = token_head_reference(x, w, act).float()
                    if ((got - want).abs() > 2e-3 + 8e-3 * want.abs()).any():
                        sys.exit(f"K1-fwd disagrees at B={B} K={K} {dtype}")
                times.append(time_ms(
                    torch, lambda: fused_token_head(x, w, act), flush))
                if B == 16 and act != "relu":
                    host.append(host_us(
                        torch, lambda: fused_token_head(x, w, act)))
            print(f"  {str(dtype):15s} {act:9s} B={B:3d} ms per tap "
                  + " ".join(f"{t:.4f}" for t in times)
                  + f"  sum {sum(times):.4f}")
            if host:
                print(f"  {'':15s} {'':9s} B={B:3d} host us per call "
                      + " ".join(f"{t:.1f}" for t in host))

    # fp32, exact SERF, both models, against plain and bound
    for model, taps in (("flagship", TAPS), ("default", RESNET_TAPS)):
        for B in (16, 128):
            sums = [0.0, 0.0, 0.0]
            for side, K in taps:
                P = side * side
                x, w = taps_tensors(torch.float32, B, side, K)
                got = fused_token_head(x, w, "serf")
                want = token_head_reference(x, w, "serf")
                # sums in another order (chip_smoke.py's TOL_K1_F32)
                if ((got - want).abs() > 1e-5 + 1e-4 * want.abs()).any():
                    sys.exit(f"K1-fwd disagrees at B={B} P={P} K={K} fp32")
                del got, want
                ms = time_ms(torch, lambda: fused_token_head(x, w, "serf"),
                             flush)
                plain = time_ms(
                    torch, lambda: token_head_reference(x, w, "serf"), flush,
                    reps=5)
                bnd, what, parts = fp32_bound(B, P, K, per_element)
                for i, v in enumerate((ms, plain, bnd)):
                    sums[i] += v
                print(f"  fp32 serf {model:8s} B={B:3d} P={P:5d} K={K:4d}: "
                      f"kernel {ms:.4f} ms  plain {plain:.4f} ms  bound "
                      f"{bnd:.4f} ms ({what}; "
                      + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
                      + ")")
                del x, w
            print(f"  fp32 serf {model:8s} B={B:3d} five taps: kernel "
                  f"{sums[0]:.4f} ms  plain {sums[1]:.4f} ms  bound "
                  f"{sums[2]:.4f} ms")
            torch.cuda.empty_cache()
    if slices:
        slice_sweep(torch, dev, g, flush)


if __name__ == "__main__":
    main()
