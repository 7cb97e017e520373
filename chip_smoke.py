#!/usr/bin/env python3
"""Drive the PyTorch port (mmvqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

1. Device: refuses to run without CUDA; prints the card's name and power
   limit (nvidia-smi), the torch and CUDA versions; builds the CUDA kernels
   from mmvqa_tpu_torch/csrc with nvcc and prints the build time.
2. Kernels: each of the eight hand-written kernels (token head and
   RealFormer attention, forward and backward; the trunk's depthwise 3x3,
   forward and backward, conv1x1 + BN statistics and BN-backward sums)
   against its plain PyTorch version on the card, at the shapes the eval
   and the train path give it, in fp32 and bf16, with the tolerances below;
   prints the kernel's and the plain version's time (CUDA events, median)
   beside the least time the card could take (the larger of bytes over
   memory rate and operations over peak rate) and, where one PyTorch call
   computes the same function, that call's time; checks that two runs of
   every kernel that sums across blocks give identical bits.
3. Eval slice: the flagship VQA model (EfficientNetV2-M + RealFormer, hidden
   768, 4 layers, T=28, 224 px) with seeded random weights answers batches
   of 16 synthetic requests through ``make_vqa_eval_step``, in fp32 and in
   bf16. The launch counters must show the token head 5x, the attention
   4x and the depthwise 3x3 42x per forward; the fp32 logits must match the
   same model run on the CPU (plain path); the bf16 logits must be as close
   to those as the same bf16 model run on the CPU; every output must be finite. For each precision it
   then times each layer with CUDA events and traces the batches with
   torch.profiler for the device's busy share.
4. Train slice: the flagship ROCO MLM model (the same trunk and encoder at
   T=75, vocabulary 30522) with seeded random weights. (a) One fp32 train
   step (no dropout, fixed augmentation draws) on the card and on the CPU
   plain path from the same weights and batch: loss, logits, the gradients
   of a stated set of leaves and a BatchNorm's running variance must agree.
   (b) The main path: bf16 compute with fp32 parameters, dropout on,
   ``mlm_epoch`` over a repeated batch of 128 through ``make_mlm_steps``;
   every loss finite, the last below the first; ms per step, images per
   second, peak memory. (c) The launch counters must show, per step, the
   token head 5x forward and 5x backward, the attention 4x and 4x, the
   depthwise 3x3 42x and 42x, conv1x1 + statistics 98x and the BN-backward
   sums 156x. (d) Where the time goes: forward, backward and optimizer by
   CUDA events, the eight kernels, what is left of the library's batch-norm
   and depthwise kernels, and the device's busy share by torch.profiler; a
   library batch-norm kernel in the train step fails the run.

Prints a JSON line of kernel results, the card line again, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

SEED = 0
NUM_CLASSES = 1024  # no answer vocabulary ships with the repo; fixed here
EVAL_B = 16         # the eval path's batch (vqa_config's batch_size)
N_BATCHES = 3       # requests of EVAL_B per precision (the first warms up)
PAD_LAST = 3        # the last batch is a partial one: 3 padding samples
TRAIN_B = 128       # the train path's batch
TRAIN_STEPS = 6     # steps of the main path on one repeated batch
TRAIN_LR = 1e-4     # so that six steps move the loss beyond dropout's noise
CHECK_B = 8         # batch of the fp32 train step held against the CPU

# Tolerances, kernel vs plain version on the same card and inputs.
# fp32: both accumulate in fp32 in another order; the token head's sums run
# over up to 12544 positions, so 1e-4 relative.
TOL_K1_F32 = dict(rtol=1e-4, atol=1e-5)
# bf16: both round one fp32 result to bf16 (8 significant bits): two ulps.
TOL_BF16 = dict(rtol=8e-3, atol=2e-3)
# attention fp32, the JAX package's own tests/test_pallas_attention.py:
# valid query rows tight; padded rows carry -10000, whose fp32 ulp (1e-3)
# moves a softmax weight by up to 1e-3 relative; the carry itself.
TOL_K2_VALID = dict(rtol=2e-5, atol=2e-5)
TOL_K2_PADDED = dict(rtol=5e-3, atol=2e-3)
TOL_K2_CARRY = dict(rtol=2e-5, atol=2e-4)
# K1 backward, the JAX package's tests/test_token_head.py:44-47: gradients to
# rtol 1e-4. dx and dW are sums of up to 768 and B * 12544 fp32 terms of
# both signs, taken in another order, so the absolute term is 1e-4 of the
# largest entry of the plain result (set per case). In bf16 the kernel and
# the plain version compute the same fp32 values from the same bf16 inputs
# (gact is not rounded); dx is then rounded once, so two bf16 ulps (rtol
# 8e-3) on top of the same absolute term; dW stays fp32.
RTOL_K1_BWD = 1e-4
# K2 backward, tests/test_pallas_attention.py:92 (rtol 5e-4, atol 5e-5) for
# fp32; bf16 outputs are one rounding of the same fp32 values: two ulps.
TOL_K2_BWD = dict(rtol=5e-4, atol=5e-5)
TOL_K2_BWD_BF16 = dict(rtol=8e-3, atol=5e-5)
# K3, the JAX package's tests/test_pallas_depthwise.py: forward 2e-5 / 1e-5
# in fp32; gradients rtol 1e-4 with an absolute term scaled to the largest
# entry of the plain result (1e-4 for dx, a sum of 9 terms; 1e-3 for dW, a
# sum over every position of every image). bf16 y and dx are one rounding of
# the same fp32 value on each side: two ulps.
TOL_K3_F32 = dict(rtol=2e-5, atol=1e-5)
RTOL_K3_BWD, ATOL_K3_DX, ATOL_K3_DW = 1e-4, 1e-4, 1e-3
# K4, tests/test_conv_bn.py: y 2e-5 in fp32 (the absolute term for sums of up
# to 3072 products in another order); the sums to 1e-4 of their largest
# entry, in bf16 too: kernel and plain version both sum the unrounded fp32
# products of the same bf16 inputs. bf16 y: two ulps.
TOL_K4_F32 = dict(rtol=2e-5, atol=2e-5)
REL_K4_SUMS = 1e-4
# K5: fp32 sums of the same fp32 terms in another order, over up to 1.6 M
# rows: 1e-4 of the largest entry.
REL_K5 = 1e-4
# train step, fp32 on the card vs the CPU plain path: as TOL_SLICE for the
# logits; a gradient leaf or running statistic within 2e-3 of its largest
# entry (convolutions and batch statistics in another order on each device,
# through 57 trunk blocks forward and back)
GRAD_NORMWISE = 2e-3

# slice, fp32 logits on the card vs the CPU: convolutions and reductions in
# another order on each device, over 57 trunk blocks and 4 layers.
TOL_SLICE = dict(rtol=1e-3, atol=1e-3)
# slice, bf16: the card's bf16 logits may be at most this many times as far
# from the fp32 CPU logits as the same bf16 model on the CPU plain path is.
# Both round one network to bf16 at the same casts, in another order, so
# their bf16 errors are of one size; a fault in a bf16 path of the card
# (a kernel's bf16 read or write, a cast) shows as an error well beyond it.
BF16_SLICE_FACTOR = 2.0

# flagship taps at 224 px: (name, H*W, channels) of stages 0, 1, 2, 4, 6
TAPS = (("stage0", 112, 24), ("stage1", 56, 48), ("stage2", 28, 80),
        ("stage4", 14, 176), ("stage6", 7, 512))
HIDDEN = 768
HEADS, HEAD_DIM = 8, 96

# The card's peaks for the bounds (NVIDIA's H100 SXM data sheet): device
# memory rate; dense bf16 tensor rate; fp32 rate outside the tensor cores;
# special-function rate, 16 units an SM x 132 SMs x 1.98 GHz boost clock.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
SM_CLOCK_HZ = 1.98e9
PEAK_SFU = 16 * 132 * SM_CLOCK_HZ
# special-function evaluations per projected element: SERF is exp, log1p
# and erf forward, and those plus exp(-y^2) and a sigmoid backward; the
# bf16 polynomial form is one sigmoid (an exp and a reciprocal) both ways
SFU_PER_ELEMENT = {("serf", "fwd"): 3, ("serf", "bwd"): 6,
                   ("serf_fast", "fwd"): 2, ("serf_fast", "bwd"): 2}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def time_ms(fn, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Median device time of ``fn`` (CUDA events). With ``flush``, a buffer
    larger than the L2 cache, the call is timed as a step would find it: the
    buffer is overwritten first, so that ``fn`` reads its inputs from device
    memory, and the device is put to sleep while the host queues the call,
    so that the host's time to launch a small kernel does not count."""
    import torch

    host = 0.0
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
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


def close(name, got, want, tol) -> float:
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    err = (got - want).abs()
    bound = tol["atol"] + tol["rtol"] * want.abs()
    if (err > bound).any():
        fail(f"{name}: max abs err {err.max().item():.3e} beyond {tol}")
    return err.max().item()


def close_normwise(name, got, want, rel) -> float:
    """max |got - want| <= rel * max |want|; returns the error."""
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if err > rel * scale:
        fail(f"{name}: max abs err {err:.3e} beyond {rel} x {scale:.3e}")
    return err


def bound(nbytes: float, flops: float, sfu: float, dtype_name: str):
    """(ms, 'bytes' | 'operations'): the least time the card could take."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(flops / PEAK_FLOPS[dtype_name], sfu / PEAK_SFU)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k1_bound(B, P, K, C, itemsize, act, direction):
    """Token head: x read (and dx written), W read (dW written in fp32),
    the (B, C) output or its gradient; one product forward, three backward;
    the activation's special functions."""
    name = "bf16" if itemsize == 2 else "fp32"
    x, w, out = B * P * K * itemsize, K * C * itemsize, B * C * itemsize
    products = 2.0 * B * P * K * C
    sfu = SFU_PER_ELEMENT[(act, direction)] * B * P * C
    if direction == "fwd":
        return bound(x + w + out, products, sfu, name)
    return bound(2 * x + w + K * C * 4 + B * C * 4, 3 * products, sfu, name)


def k2_bound(B, H, T, E, itemsize, with_prev, with_mask, direction):
    """Attention core: q, k, v and ctx (their gradients and dctx backward),
    the fp32 carries; two products forward, four backward; one exp a score."""
    name = "bf16" if itemsize == 2 else "fp32"
    qkv, tile = B * T * H * E * itemsize, B * H * T * T * 4
    product = 2.0 * B * H * T * T * E
    sfu = B * H * T * T
    if direction == "fwd":
        nbytes = 4 * qkv + tile * (2 if with_prev else 1)
        nbytes += B * T * 4 if with_mask else 0
        return bound(nbytes, 2 * product, sfu, name)
    # carry in; dcarry in and dprev out where the layer had a prev
    nbytes = 7 * qkv + tile * (3 if with_prev else 1)
    return bound(nbytes, 4 * product, sfu, name)


KERNELS = {
    # name: (source, the pallas_call it replaces, why no single library call)
    "token_head": (
        "mmvqa_tpu_torch/csrc/token_head.cu",
        "mmvqa_tpu/ops/pallas_token_head.py:247",
        "no single PyTorch call fuses the projection, SERF and the mean"),
    "token_head_bwd": (
        "mmvqa_tpu_torch/csrc/token_head_bwd.cu",
        "mmvqa_tpu/ops/pallas_token_head.py:273",
        "no single PyTorch call gives dx and dW of the fused head"),
    "realformer_attention": (
        "mmvqa_tpu_torch/csrc/realformer_attention.cu",
        "mmvqa_tpu/ops/pallas_attention.py:146",
        "scaled_dot_product_attention takes no residual scores and returns "
        "no score carry"),
    "realformer_attention_bwd": (
        "mmvqa_tpu_torch/csrc/realformer_attention_bwd.cu",
        "mmvqa_tpu/ops/pallas_attention.py:164",
        "no PyTorch call takes a score carry and its gradient"),
    "depthwise3x3": (
        "mmvqa_tpu_torch/csrc/depthwise3x3.cu",
        "mmvqa_tpu/ops/pallas_depthwise.py:145",
        "F.conv2d(groups=C) on the channels-last map"),
    "depthwise3x3_bwd": (
        "mmvqa_tpu_torch/csrc/depthwise3x3_bwd.cu",
        "mmvqa_tpu/ops/pallas_depthwise.py:166",
        "torch.ops.aten.convolution_backward (dx and dW)"),
    "conv1x1_stats": (
        "mmvqa_tpu_torch/csrc/conv1x1_stats.cu",
        "mmvqa_tpu/ops/pallas_conv_bn.py:81",
        "no single PyTorch call returns a product and the sums of its "
        "output; the two calls F.conv2d + torch.batch_norm_stats are timed "
        "as context"),
    "bn_backward_sums": (
        "mmvqa_tpu_torch/csrc/bn_backward_sums.cu",
        "tools/bn_probe.py:73",
        "torch.batch_norm_backward_reduce, which returns sum dy, "
        "sum dy (x - mean) and that times inv_std"),
}
# kernels whose library_ms is a number, not null
WITH_LIBRARY = ("depthwise3x3", "depthwise3x3_bwd", "bn_backward_sums")


def kernel_phase(torch):
    """Every kernel against its plain version. The summary times are at the
    train path's shapes, bf16 at B=TRAIN_B: the five taps summed for the
    token head, one layer at T=75 with prev and padded queries for the
    attention."""
    from mmvqa_tpu_torch.models.visual_tokens import tap_positions
    from mmvqa_tpu_torch.ops.attention import (
        realformer_attention,
        realformer_attention_backward,
        realformer_attention_backward_reference,
        realformer_attention_reference,
    )
    from mmvqa_tpu_torch.ops.token_head import (
        fused_token_head,
        token_head_backward,
        token_head_backward_reference,
        token_head_reference,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    results = {name: {"err": {torch.float32: 0.0, torch.bfloat16: 0.0},
                      "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                      "bounds": []}
               for name in KERNELS}

    def note(name, dtype, err, summary, ms, plain, bnd):
        r = results[name]
        r["err"][dtype] = max(r["err"][dtype], err)
        if summary:
            r["ms"] += ms
            r["plain_ms"] += plain
            r["bounds"].append(bnd)

    # ---- K1, forward and backward: the five taps at the eval batch (16) in
    # both dtypes, at the train batch in bf16, stage 0 at the train batch in
    # fp32
    k1_cases = ([(torch.float32, EVAL_B, tap) for tap in TAPS]
                + [(torch.float32, TRAIN_B, TAPS[0])]
                + [(torch.bfloat16, B, tap) for B in (EVAL_B, TRAIN_B)
                   for tap in TAPS])
    for dtype, B, (name, side, K) in k1_cases:
        bf16 = dtype == torch.bfloat16
        act = "serf_fast" if bf16 else "serf"
        reps = 20 if B == EVAL_B else 5
        P = side * side
        feat = torch.randn(B, side, side, K, device=dev, generator=g)
        feat = feat.to(dtype).permute(0, 3, 1, 2)  # the trunk's layout
        x = tap_positions(feat)
        w = (torch.randn(K, HIDDEN, device=dev, generator=g)
             * K ** -0.5).to(dtype)
        gout = torch.randn(B, HIDDEN, device=dev, generator=g)
        summary = bf16 and B == TRAIN_B
        label = f"{name} B={B} P={P} K={K} {dtype}"

        got = fused_token_head(x, w, act)
        want = token_head_reference(x, w, act)
        torch.cuda.synchronize()
        err = close(f"token_head {label}", got, want,
                    TOL_BF16 if bf16 else TOL_K1_F32)
        ms = time_ms(lambda: fused_token_head(x, w, act), reps)
        plain = time_ms(lambda: token_head_reference(x, w, act), reps)
        bnd = k1_bound(B, P, K, HIDDEN, x.element_size(), act, "fwd")
        print(f"token_head {label}: max_abs_err {err:.3e}  kernel {ms:.4f} ms"
              f"  plain {plain:.4f} ms  bound {bnd[0]:.4f} ms ({bnd[1]})")
        note("token_head", dtype, err, summary, ms, plain, bnd)
        del got, want

        dx, dw = token_head_backward(x, w, gout, act)
        dx2, dw2 = token_head_backward(x, w, gout, act)
        dx_p, dw_p = token_head_backward_reference(x, w, gout, act)
        torch.cuda.synchronize()
        if not (torch.equal(dw, dw2) and torch.equal(dx, dx2)):
            fail(f"token_head_bwd {label}: two runs differ")
        if dx.stride() != x.stride():
            fail(f"token_head_bwd {label}: dx is not laid out as x")
        e_dw = close(f"token_head_bwd {label} dW", dw, dw_p, dict(
            rtol=RTOL_K1_BWD, atol=RTOL_K1_BWD * dw_p.abs().max().item()))
        dx_tol = dict(rtol=8e-3 if bf16 else RTOL_K1_BWD,
                      atol=RTOL_K1_BWD * dx_p.float().abs().max().item())
        e_dx = close(f"token_head_bwd {label} dx", dx, dx_p, dx_tol)
        del dx, dx2, dw2, dx_p, dw_p
        ms = time_ms(lambda: token_head_backward(x, w, gout, act), reps)
        plain = time_ms(
            lambda: token_head_backward_reference(x, w, gout, act), reps)
        bnd = k1_bound(B, P, K, HIDDEN, x.element_size(), act, "bwd")
        print(f"token_head_bwd {label}: max_abs_err dx {e_dx:.3e} dW "
              f"{e_dw:.3e}, two runs identical  kernel {ms:.4f} ms  plain "
              f"{plain:.4f} ms  bound {bnd[0]:.4f} ms ({bnd[1]})")
        note("token_head_bwd", dtype, max(e_dx, e_dw), summary, ms, plain, bnd)
        del feat, x

    # ---- K2, forward and backward
    H, E = HEADS, HEAD_DIM
    k2_cases = [(dtype, EVAL_B, T, wp, wm)
                for dtype in (torch.float32, torch.bfloat16)
                for T in (28, 75) for wp in (False, True)
                for wm in (False, True)]
    k2_cases += [(torch.bfloat16, TRAIN_B, 75, wp, True)
                 for wp in (False, True)]
    for dtype, B, T, with_prev, with_mask in k2_cases:
        bf16 = dtype == torch.bfloat16
        kqv = torch.randn(B, T, H, 3 * E, device=dev, generator=g).to(dtype)
        k, q, v = kqv.split(E, dim=-1)
        prev = (torch.randn(B, H, T, T, device=dev, generator=g)
                if with_prev else None)
        mask = None
        valid = torch.ones(B, T, dtype=torch.bool, device=dev)
        if with_mask:
            lengths = torch.randint(T // 2, T + 1, (B,), device=dev,
                                    generator=g)
            valid = torch.arange(T, device=dev)[None] < lengths[:, None]
            mask = valid.float()
        summary = bf16 and B == TRAIN_B and with_prev
        label = (f"B={B} T={T} prev={with_prev} mask={with_mask} {dtype}")

        ctx, carry = realformer_attention(q, k, v, prev, mask)
        ctx_p, carry_p = realformer_attention_reference(q, k, v, prev, mask)
        torch.cuda.synchronize()
        name = f"realformer_attention {label}"
        if bf16:
            e1 = e2 = close(name + " ctx", ctx, ctx_p, TOL_BF16)
        else:
            e1 = close(name + " ctx valid", ctx[valid], ctx_p[valid],
                       TOL_K2_VALID)
            e2 = close(name + " ctx", ctx, ctx_p, TOL_K2_PADDED)
        e3 = close(name + " carry", carry, carry_p, TOL_K2_CARRY)
        ms = time_ms(lambda: realformer_attention(q, k, v, prev, mask))
        plain = time_ms(
            lambda: realformer_attention_reference(q, k, v, prev, mask))
        bnd = k2_bound(B, H, T, E, kqv.element_size(), with_prev, with_mask,
                       "fwd")
        print(f"{name}: max_abs_err ctx {max(e1, e2):.3e} carry {e3:.3e}  "
              f"kernel {ms:.4f} ms  plain {plain:.4f} ms  bound "
              f"{bnd[0]:.4f} ms ({bnd[1]})")
        note("realformer_attention", dtype, max(e1, e2, e3), summary, ms,
             plain, bnd)

        # the backward from the kernel's own carry; a layer with a prev also
        # gets a gradient for its carry, a last layer (here: no prev) none
        dctx = torch.randn(B, T, H, E, device=dev, generator=g).to(dtype)
        dcarry = (0.1 * torch.randn(B, H, T, T, device=dev, generator=g)
                  if with_prev else None)
        dkqv, dprev = realformer_attention_backward(kqv, carry, dctx, dcarry,
                                                    with_prev)
        dq_p, dk_p, dv_p, ds_p = realformer_attention_backward_reference(
            q, k, v, carry, dctx, dcarry)
        torch.cuda.synchronize()
        name = f"realformer_attention_bwd {label}"
        want = torch.cat([dk_p, dq_p, dv_p], dim=-1)
        e1 = close(name + " dkqv", dkqv, want,
                   TOL_K2_BWD_BF16 if bf16 else TOL_K2_BWD)
        e2 = (close(name + " dprev", dprev, ds_p, TOL_K2_BWD)
              if with_prev else 0.0)
        ms = time_ms(lambda: realformer_attention_backward(
            kqv, carry, dctx, dcarry, with_prev))
        plain = time_ms(lambda: realformer_attention_backward_reference(
            q, k, v, carry, dctx, dcarry))
        bnd = k2_bound(B, H, T, E, kqv.element_size(), with_prev, with_mask,
                       "bwd")
        print(f"{name}: max_abs_err dkqv {e1:.3e} dprev {e2:.3e}  kernel "
              f"{ms:.4f} ms  plain {plain:.4f} ms  bound {bnd[0]:.4f} ms "
              f"({bnd[1]})")
        note("realformer_attention_bwd", dtype, max(e1, e2), summary, ms,
             plain, bnd)

    trunk_kernel_phase(torch, results)
    for name, r in results.items():
        library = (f"library_ms {r['library_ms']:.4f}: "
                   if name in WITH_LIBRARY else "library_ms null: ")
        print(f"kernel {name}: max_abs_err fp32 "
              f"{r['err'][torch.float32]:.3e}, bf16 "
              f"{r['err'][torch.bfloat16]:.3e}; {library}{KERNELS[name][2]}")
    return results


def trunk_sites(B: int, size: int = 224):
    """The flagship trunk's kernel sites at batch ``B``: three counters,
    K3 (H, W, C), K4 (N, K, C), K5 (N, C) -> how many sites have that
    shape. Follows models/effnetv2.py block by block."""
    from collections import Counter

    from mmvqa_tpu_torch.models.effnetv2 import V2_M_ARCH, V2_M_STEM

    k3, k4, k5 = Counter(), Counter(), Counter()
    s = -(-size // 2)
    k5[(B * s * s, V2_M_STEM)] += 1
    in_ch = V2_M_STEM
    for btype, reps, _k, stride, e, c, _se in V2_M_ARCH:
        for bi in range(reps):
            so = -(-s // (stride if bi == 0 else 1))
            mid = in_ch * e
            if btype == "fused" and e == 1:
                k5[(B * so * so, c)] += 1
            elif btype == "fused":
                k5[(B * so * so, mid)] += 1
                k4[(B * so * so, mid, c)] += 1
                k5[(B * so * so, c)] += 1
            else:
                k4[(B * s * s, in_ch, mid)] += 1
                k5[(B * s * s, mid)] += 1
                if so == s:
                    k3[(so, so, mid)] += 1
                k5[(B * so * so, mid)] += 1
                k4[(B * so * so, mid, c)] += 1
                k5[(B * so * so, c)] += 1
            s, in_ch = so, c
    return k3, k4, k5


def trunk_kernel_phase(torch, results):
    """K3 (forward, backward), K4 and K5 against their plain versions at
    every distinct site shape of the flagship trunk at B=TRAIN_B, fp32 and
    bf16, and untimed at the other batches the paths below give them: K3's
    forward at EVAL_B in both dtypes with the weight in x's dtype, as the
    eval model holds it, and all four in fp32 at CHECK_B, the fp32 train
    check's batch. The summary times are bf16, each shape's time multiplied
    by the number of sites that have it: one train step's worth. Every timed call
    finds its inputs in device memory (the L2 cache is overwritten before
    it), as in a step, where a map of tens of MB does not survive until its
    next reader."""
    import torch.nn.functional as F

    from mmvqa_tpu_torch.ops.bn_sums import (
        bn_backward_sums,
        bn_backward_sums_reference,
    )
    from mmvqa_tpu_torch.ops.conv_bn import (
        conv1x1_stats,
        conv1x1_stats_reference,
    )
    from mmvqa_tpu_torch.ops.depthwise import (
        depthwise3x3,
        depthwise3x3_backward,
        depthwise3x3_backward_reference,
        depthwise3x3_reference,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    k3_sites, k4_sites, k5_sites = trunk_sites(TRAIN_B)
    if (sum(k3_sites.values()), sum(k4_sites.values()),
            sum(k5_sites.values())) != (42, 98, 156):
        fail(f"trunk sites: {k3_sites} {k4_sites} {k5_sites}")
    B = TRAIN_B
    dtypes = (torch.float32, torch.bfloat16)

    def timed(fn):
        return time_ms(fn, 5, 2, flush)

    def note(name, dtype, err, count, ms, plain, library, bnd):
        r = results[name]
        r["err"][dtype] = max(r["err"][dtype], err)
        if dtype == torch.bfloat16:
            r["ms"] += count * ms
            r["plain_ms"] += count * plain
            r["library_ms"] += count * library
            r["bounds"] += [bnd] * count

    def maxabs(t):
        return t.float().abs().max().item()

    def check_k3_bwd(label, x, w, dy, bf16):
        """dx and dW against the plain backward, two runs bit for bit."""
        dx, dw = depthwise3x3_backward(x, w, dy)
        dx2, dw2 = depthwise3x3_backward(x, w, dy)
        dx_p, dw_p = depthwise3x3_backward_reference(x, w, dy)
        torch.cuda.synchronize()
        if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
            fail(f"depthwise3x3_bwd {label}: two runs differ")
        e_dx = close(f"depthwise3x3_bwd {label} dx", dx, dx_p, dict(
            rtol=8e-3 if bf16 else RTOL_K3_BWD,
            atol=ATOL_K3_DX * maxabs(dx_p)))
        e_dw = close(f"depthwise3x3_bwd {label} dW", dw, dw_p, dict(
            rtol=RTOL_K3_BWD, atol=ATOL_K3_DW * maxabs(dw_p)))
        return e_dx, e_dw

    def check_k4(label, x, w, bf16):
        """y and the sums against the plain version, two runs bit for bit;
        returns the errors and the largest plain sum."""
        y, st = conv1x1_stats(x, w)
        y2, st2 = conv1x1_stats(x, w)
        y_p, st_p = conv1x1_stats_reference(x, w)
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(st, st2)):
            fail(f"conv1x1_stats {label}: two runs differ")
        e_y = close(f"conv1x1_stats {label} y", y, y_p,
                    TOL_BF16 if bf16 else TOL_K4_F32)
        e_s = max(close_normwise(f"conv1x1_stats {label} sums[{i}]",
                                 st[i], st_p[i], REL_K4_SUMS)
                  for i in (0, 1))
        return e_y, e_s, maxabs(st_p)

    def check_k5(label, x, dy, mean, inv_std):
        """Both sums against the plain version, two runs bit for bit;
        returns the kernel's sums, the error and the largest plain sum."""
        s1, s2 = bn_backward_sums(x, dy, mean, inv_std)
        r1, r2 = bn_backward_sums(x, dy, mean, inv_std)
        p1, p2 = bn_backward_sums_reference(x, dy, mean, inv_std)
        torch.cuda.synchronize()
        if not (torch.equal(s1, r1) and torch.equal(s2, r2)):
            fail(f"bn_backward_sums {label}: two runs differ")
        err = max(
            close_normwise(f"bn_backward_sums {label} s1", s1, p1, REL_K5),
            close_normwise(f"bn_backward_sums {label} s2", s2, p2, REL_K5))
        return s1, s2, err, max(maxabs(p1), maxabs(p2))

    small = {name: 0 for name in ("depthwise3x3", "depthwise3x3_bwd",
                                  "conv1x1_stats", "bn_backward_sums")}

    def note_small(name, dtype, err):
        r = results[name]
        r["err"][dtype] = max(r["err"][dtype], err)
        small[name] += 1

    # ---- K3: the weight is the convolution's fp32 (C, 1, 3, 3) master, as
    # the trunk hands it over; operations at the fp32 rate (no tensor cores
    # in a depthwise product)
    for (H, W, C), count in sorted(k3_sites.items()):
        for dtype in dtypes:
            bf16 = dtype == torch.bfloat16
            size = B * H * W * C
            x = torch.randn(B, H, W, C, device=dev, generator=g).to(dtype)
            dy = torch.randn(B, H, W, C, device=dev, generator=g).to(dtype)
            w4 = torch.randn(C, 1, 3, 3, device=dev, generator=g) / 3
            w = w4[:, 0].permute(1, 2, 0)
            wc = w4.to(dtype)
            xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
            label = f"B={B} {H}x{W}x{C} {dtype} ({count} sites)"
            x_bytes = size * x.element_size()

            y = depthwise3x3(x, w)
            y_p = depthwise3x3_reference(x, w)
            torch.cuda.synchronize()
            err = close(f"depthwise3x3 {label}", y, y_p,
                        TOL_BF16 if bf16 else TOL_K3_F32)
            ms = timed(lambda: depthwise3x3(x, w))
            plain = timed(lambda: depthwise3x3_reference(x, w))
            lib = timed(lambda: F.conv2d(xn, wc, padding=1, groups=C))
            bnd = bound(2 * x_bytes + 36 * C, 18.0 * size, 0, "fp32")
            print(f"depthwise3x3 {label}: max_abs_err {err:.3e}  kernel "
                  f"{ms:.4f} ms  plain {plain:.4f} ms  library {lib:.4f} ms  "
                  f"bound {bnd[0]:.4f} ms ({bnd[1]})")
            note("depthwise3x3", dtype, err, count, ms, plain, lib, bnd)
            del y, y_p

            e_dx, e_dw = check_k3_bwd(label, x, w, dy, bf16)
            ms = timed(lambda: depthwise3x3_backward(x, w, dy))
            plain = timed(lambda: depthwise3x3_backward_reference(x, w, dy))
            lib = timed(lambda: torch.ops.aten.convolution_backward(
                dyn, xn, wc, None, [1, 1], [1, 1], [1, 1], False, [0, 0], C,
                [True, True, False]))
            bnd = bound(3 * x_bytes + 72 * C, 36.0 * size, 0, "fp32")
            print(f"depthwise3x3_bwd {label}: max_abs_err dx {e_dx:.3e} dW "
                  f"{e_dw:.3e}, two runs identical  kernel {ms:.4f} ms  plain "
                  f"{plain:.4f} ms  library {lib:.4f} ms  bound {bnd[0]:.4f} "
                  f"ms ({bnd[1]})")
            note("depthwise3x3_bwd", dtype, max(e_dx, e_dw), count, ms, plain,
                 lib, bnd)

            # the eval path: another batch, so another launch plan, and the
            # weight in x's dtype (the bf16 model holds a bf16 weight)
            xe, we = x[:EVAL_B], wc[:, 0].permute(1, 2, 0)
            lab = f"B={EVAL_B} {H}x{W}x{C} {dtype}, {we.dtype} weight"
            note_small("depthwise3x3", dtype, close(
                f"depthwise3x3 {lab}", depthwise3x3(xe, we),
                depthwise3x3_reference(xe, we),
                TOL_BF16 if bf16 else TOL_K3_F32))
            if not bf16:  # the fp32 train check
                xs, dys = x[:CHECK_B], dy[:CHECK_B]
                lab = f"B={CHECK_B} {H}x{W}x{C} {dtype}"
                note_small("depthwise3x3", dtype, close(
                    f"depthwise3x3 {lab}", depthwise3x3(xs, w),
                    depthwise3x3_reference(xs, w), TOL_K3_F32))
                note_small("depthwise3x3_bwd", dtype,
                           max(check_k3_bwd(lab, xs, w, dys, bf16)))
            del x, dy, xn, dyn

    # ---- K4: w is the convolution's (C, K) weight as its (K, C) view
    two_call_ms = 0.0
    for (N, K, C), count in sorted(k4_sites.items()):
        for dtype in dtypes:
            bf16 = dtype == torch.bfloat16
            x = torch.randn(N, K, device=dev, generator=g).to(dtype)
            wt = (torch.randn(C, K, device=dev, generator=g)
                  * K ** -0.5).to(dtype)
            w = wt.t()
            label = f"N={N} K={K} C={C} {dtype} ({count} sites)"
            e_y, e_s, s_max = check_k4(label, x, w, bf16)
            ms = timed(lambda: conv1x1_stats(x, w))
            plain = timed(lambda: conv1x1_stats_reference(x, w))
            # context, not a yardstick: the library's convolution followed by
            # its statistics reduction, two calls
            xn = x.view(B, N // B, 1, K).permute(0, 3, 1, 2)
            w4 = wt.view(C, K, 1, 1)
            two = timed(lambda: torch.batch_norm_stats(F.conv2d(xn, w4),
                                                       1e-3))
            size = x.element_size()
            bnd = bound((N * K + K * C + N * C) * size + 8 * C,
                        2.0 * N * K * C + 3.0 * N * C, 0,
                        "bf16" if bf16 else "fp32")
            print(f"conv1x1_stats {label}: max_abs_err y {e_y:.3e} sums "
                  f"{e_s:.3e} (of max {s_max:.3e}), two runs "
                  f"identical  kernel {ms:.4f} ms  plain {plain:.4f} ms  "
                  f"bound {bnd[0]:.4f} ms ({bnd[1]})  [conv2d + "
                  f"batch_norm_stats {two:.4f} ms]")
            note("conv1x1_stats", dtype, e_y, count, ms, plain, 0.0, bnd)
            if bf16:
                two_call_ms += count * two
            else:  # the fp32 train check's rows
                ns = N // B * CHECK_B
                note_small("conv1x1_stats", dtype, check_k4(
                    f"N={ns} K={K} C={C} {dtype}", x[:ns], w, bf16)[0])
            del x, xn

    # ---- K5; the library's call takes the (B, C, H, W) view of the same
    # channels-last map
    for (N, C), count in sorted(k5_sites.items()):
        for dtype in dtypes:
            x = (torch.randn(N, C, device=dev, generator=g) * 2 + 1).to(dtype)
            dy = torch.randn(N, C, device=dev, generator=g).to(dtype)
            mean = torch.randn(C, device=dev, generator=g)
            inv_std = 1 + torch.rand(C, device=dev, generator=g)
            label = f"N={N} C={C} {dtype} ({count} sites)"
            s1, s2, err, s_max = check_k5(label, x, dy, mean, inv_std)
            xn = x.view(B, N // B, 1, C).permute(0, 3, 1, 2)
            dyn = dy.view(B, N // B, 1, C).permute(0, 3, 1, 2)
            ones = torch.ones(C, device=dev)

            def library():
                return torch.batch_norm_backward_reduce(
                    dyn, xn, mean, inv_std, ones, True, True, True)

            l1, _, l2, _ = library()
            torch.cuda.synchronize()
            close_normwise(f"bn_backward_sums {label} s1 vs library", s1, l1,
                           REL_K5)
            close_normwise(f"bn_backward_sums {label} s2 vs library", s2, l2,
                           REL_K5)
            ms = timed(lambda: bn_backward_sums(x, dy, mean, inv_std))
            plain = timed(
                lambda: bn_backward_sums_reference(x, dy, mean, inv_std))
            lib = timed(library)
            bnd = bound(2 * N * C * x.element_size() + 16 * C, 5.0 * N * C, 0,
                        "fp32")
            print(f"bn_backward_sums {label}: max_abs_err {err:.3e} (of max "
                  f"{s_max:.3e}), two runs identical  "
                  f"kernel {ms:.4f} ms  plain {plain:.4f} ms  library "
                  f"{lib:.4f} ms  bound {bnd[0]:.4f} ms ({bnd[1]})")
            note("bn_backward_sums", dtype, err, count, ms, plain, lib, bnd)
            if dtype == torch.float32:  # the fp32 train check's rows
                ns = N // B * CHECK_B
                note_small("bn_backward_sums", dtype, check_k5(
                    f"N={ns} C={C} {dtype}", x[:ns], dy[:ns], mean,
                    inv_std)[2])
            del x, dy, xn, dyn
    print(f"conv1x1_stats: the two library calls (conv2d + batch_norm_stats) "
          f"take {two_call_ms:.4f} ms over the 98 sites, bf16")
    print(f"trunk kernels at the eval batch {EVAL_B} (depthwise3x3 forward, "
          f"fp32 and bf16 with the weight in x's dtype) and at the fp32 "
          f"train check's batch {CHECK_B}: cases within the same limits "
          f"{small}")


def check_outputs(torch, outs, label):
    for i, o in enumerate(outs):
        for key in ("loss", "logits"):
            if not torch.isfinite(o[key].float()).all():
                fail(f"slice {label} batch {i}: non-finite {key}")
        if tuple(o["logits"].shape) != (len(o["preds"]), NUM_CLASSES):
            fail(f"slice {label}: logits shape {tuple(o['logits'].shape)}")


def run_batches(torch, step, batches, label):
    """The main path: one eval step per batch, host clock around each."""
    torch.cuda.reset_peak_memory_stats()
    outs, times = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    peak = torch.cuda.max_memory_allocated() / 2**20
    steady = statistics.median(times[1:])
    print(f"slice {label}: ms per batch of {len(batches[0]['weights'])} "
          f"{['%.2f' % t for t in times]} (median after the first "
          f"{steady:.2f}); peak memory {peak:.1f} MiB")
    check_outputs(torch, outs, label)
    return outs


def time_layers(torch, model, step, batches, label):
    """Each top-level layer's device time per batch, from CUDA events that
    forward hooks record around it; median over ``batches``."""
    names = (["trans.trunk"]
             + [f"trans.token_conv_{i}" for i in range(len(model.trans.taps))]
             + ["bert_embedding", "encoder", "fc1", "classifier_0",
                "classifier_ln", "classifier_2"])
    events = {name: [] for name in names}
    hooks = []
    for name in names:
        def pre(_m, _a, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name].append([ev, None])

        def post(_m, _a, _o, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name][-1][1] = ev

        mod = model.get_submodule(name)
        hooks += [mod.register_forward_pre_hook(pre),
                  mod.register_forward_hook(post)]
    try:
        outs = [step(b) for b in batches]
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    check_outputs(torch, outs, label)
    ms = {name: statistics.median(a.elapsed_time(b) for a, b in pairs)
          for name, pairs in events.items()}
    print(f"slice {label}: ms per batch by layer (CUDA events, median of "
          f"{len(batches)}): " + ", ".join(f"{n} {t:.4f}" for n, t in ms.items()))


def trace_batches(torch, step, batches, label):
    """Device busy share under torch.profiler: summed kernel time over the
    host-clock span of ``batches``; prints the kernels that take most."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs = [step(b) for b in batches]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    check_outputs(torch, outs, label)
    kernels = [a for a in prof.key_averages()
               if a.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda a: a.self_device_time_total, reverse=True)
    n = len(batches)
    busy = sum(a.self_device_time_total for a in kernels) / 1e3
    if busy <= 0:
        print(f"slice {label}: device busy share not measured (the profiler "
              "saw no device time)")
        return
    print(f"slice {label}: traced {n} batches, wall {wall / n:.3f} ms/batch, "
          f"device busy {busy / n:.3f} ms/batch ({100 * busy / wall:.1f}%)")
    for a in kernels[:8]:
        print(f"  {a.self_device_time_total / 1e3 / n:9.4f} ms/batch "
              f"{a.count // n:5d} calls  {a.key[:80]}")


def slice_phase(torch):
    import copy

    from mmvqa_tpu_torch.core.config import vqa_config
    from mmvqa_tpu_torch.data.synthetic import vqa_batches
    from mmvqa_tpu_torch.models import MMBert
    from mmvqa_tpu_torch.train.steps import make_vqa_eval_step

    cfg = vqa_config(cnn_encoder="tf_efficientnetv2_m",
                     transformer_model="realformer", num_classes=NUM_CLASSES)
    batches = vqa_batches(cfg, N_BATCHES, NUM_CLASSES, SEED, PAD_LAST)
    model = MMBert(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"slice: MMBert VQA {cfg.cnn_encoder} + {cfg.transformer_model}, "
          f"hidden {cfg.hidden_size}, {cfg.n_layers} layers, T="
          f"{cfg.max_position_embeddings}, {cfg.image_size} px, "
          f"{n_params / 1e6:.2f} M parameters")

    refs = {}
    for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        cpu_model = model if dtype == torch.float32 else (
            copy.deepcopy(model).to(dtype))
        t0 = time.perf_counter()
        refs[label] = make_vqa_eval_step(cpu_model, cfg)(batches[0])
        print(f"slice: CPU reference (plain path, {label}) "
              f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
        del cpu_model

    model.to("cuda")
    reset_counts()
    outs, forwards = {}, 0
    for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        model.to(dtype)
        step = make_vqa_eval_step(model, cfg)
        outs[label] = run_batches(torch, step, batches, label)
        time_layers(torch, model, step, batches[1:], label)
        trace_batches(torch, step, batches[1:], label)
        forwards += len(batches) + 2 * len(batches[1:])
    launches = read_counts()
    print(f"slice: launches over {forwards} forwards: {launches}")
    want = dict.fromkeys(launches, 0)
    want.update(token_head=5 * forwards,
                realformer_attention=cfg.n_layers * forwards,
                depthwise3x3=42 * forwards)
    if launches != want:
        fail(f"eval launches {launches}, want {want}")

    ref32, ref16 = refs["fp32"], refs["bf16"]
    out32, out16 = outs["fp32"][0], outs["bf16"][0]
    err = close("slice fp32 logits vs CPU", out32["logits"].cpu(),
                ref32["logits"], TOL_SLICE)
    loss_err = abs(out32["loss"].item() - ref32["loss"].item())
    agree = (out32["preds"].cpu() == ref32["preds"]).float().mean().item()
    print(f"slice fp32: card vs CPU logits max_abs_err {err:.3e}, loss "
          f"{out32['loss'].item():.6f} (err {loss_err:.3e}), preds agree "
          f"{agree:.3f}")

    def gap(out):  # bf16 logits' distance from the fp32 CPU logits
        return (out["logits"].float().cpu() - ref32["logits"]).abs().max().item()

    card16, cpu16 = gap(out16), gap(ref16)
    d16 = (out16["logits"].float().cpu()
           - ref16["logits"].float()).abs().max().item()
    agree16 = (out16["preds"].cpu() == ref16["preds"]).float().mean().item()
    print(f"slice bf16: logits max_abs_err vs fp32 CPU: card {card16:.3e}, "
          f"CPU bf16 {cpu16:.3e} (limit {BF16_SLICE_FACTOR} x); card vs CPU "
          f"bf16 {d16:.3e}, preds agree {agree16:.3f}; loss card "
          f"{out16['loss'].item():.6f}, CPU bf16 {ref16['loss'].item():.6f}")
    if not card16 <= BF16_SLICE_FACTOR * cpu16:
        fail(f"slice bf16 logits: {card16:.3e} from the fp32 result, beyond "
             f"{BF16_SLICE_FACTOR} x the CPU bf16 path's {cpu16:.3e}")
    return launches


def flagship_mlm_config(**over):
    from mmvqa_tpu_torch.core.config import pretrain_config

    return pretrain_config(cnn_encoder="tf_efficientnetv2_m",
                           transformer_model="realformer", **over)


def _counters():
    """(kernel name, wrapper, attribute) of every launch counter."""
    from mmvqa_tpu_torch.ops.attention import realformer_attention
    from mmvqa_tpu_torch.ops.bn_sums import bn_backward_sums
    from mmvqa_tpu_torch.ops.conv_bn import conv1x1_stats
    from mmvqa_tpu_torch.ops.depthwise import depthwise3x3
    from mmvqa_tpu_torch.ops.token_head import fused_token_head

    return (("token_head", fused_token_head, "launches"),
            ("token_head_bwd", fused_token_head, "backward_launches"),
            ("realformer_attention", realformer_attention, "launches"),
            ("realformer_attention_bwd", realformer_attention,
             "backward_launches"),
            ("depthwise3x3", depthwise3x3, "launches"),
            ("depthwise3x3_bwd", depthwise3x3, "backward_launches"),
            ("conv1x1_stats", conv1x1_stats, "launches"),
            ("bn_backward_sums", bn_backward_sums, "launches"))


def reset_counts() -> None:
    for _, fn, attr in _counters():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, fn, attr in _counters()}


def gradient_copies() -> dict:
    """Gradients that reached a kernel site in another layout than its map
    and were copied into it (autograd promises none); expected 0."""
    from mmvqa_tpu_torch.models.effnetv2 import BatchNorm2d
    from mmvqa_tpu_torch.ops.depthwise import depthwise3x3

    return {"batchnorm": BatchNorm2d.gradient_copies,
            "depthwise3x3": depthwise3x3.gradient_copies}


# leaves whose gradients the fp32 check compares, and the statistic
CHECK_LEAVES = ([f"trans.token_conv_{i}.weight" for i in range(5)]
                + ["encoder.block_0.kqv.weight", "encoder.block_3.kqv.weight",
                   "trans.trunk.stem_conv.weight",
                   "trans.trunk.stage6_block4.pw_proj.weight",
                   "trans.trunk.stage4_block13.dw.weight",
                   "trans.trunk.stage4_block13.pw_exp.weight",
                   "trans.trunk.stage4_block13.bn1.weight",
                   "trans.trunk.stage1_block2.bn2.bias",
                   "bert_embedding.word_embeddings.weight",
                   "classifier_2.weight"])
CHECK_STATS = ["trans.trunk.stem_bn.running_var",
               "trans.trunk.stem_bn.running_mean",
               "trans.trunk.stage4_block13.bn2.running_var"]


def checked_train_step(torch, model, cfg, batch, draws):
    """One train step through ``make_mlm_steps`` with hooks that keep the
    logits and the gradients of CHECK_LEAVES."""
    from mmvqa_tpu_torch.train.state import create_train_state
    from mmvqa_tpu_torch.train.steps import make_mlm_steps

    kept = {}
    params = dict(model.named_parameters())
    hooks = [params[name].register_hook(
        lambda g, name=name: kept.__setitem__(name, g.detach().clone()))
        for name in CHECK_LEAVES]
    hooks.append(model.register_forward_hook(
        lambda _m, _a, out: kept.__setitem__("logits", out.detach())))
    try:
        train_step, _ = make_mlm_steps(model, cfg)
        state, metrics = train_step(create_train_state(model, cfg.lr), batch,
                                    draws=draws)
    finally:
        for h in hooks:
            h.remove()
    kept["loss"] = metrics["loss"]
    sd = model.state_dict()
    kept.update({name: sd[name].clone() for name in CHECK_STATS})
    return kept


def train_check_fp32(torch):
    """(a) one fp32 train step, card against CPU plain path."""
    import copy

    from mmvqa_tpu_torch.data.images import PRETRAIN_AUG, sample_draws
    from mmvqa_tpu_torch.data.synthetic import mlm_batches
    from mmvqa_tpu_torch.models import MMBert

    cfg = flagship_mlm_config(batch_size=CHECK_B, dropout_override=0.0)
    batch = mlm_batches(cfg, 1, SEED)[0]
    draws = sample_draws(CHECK_B, cfg.image_size,
                         torch.Generator().manual_seed(SEED), PRETRAIN_AUG)
    cpu_model = MMBert(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(SEED))
    card_model = copy.deepcopy(cpu_model).to("cuda")
    t0 = time.perf_counter()
    want = checked_train_step(torch, cpu_model, cfg, batch, draws)
    print(f"train fp32 check: CPU reference step (plain path, B={CHECK_B}) "
          f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
    del cpu_model
    got = checked_train_step(torch, card_model, cfg, batch, draws)
    torch.cuda.synchronize()
    del card_model

    loss_err = abs(got["loss"].item() - want["loss"].item())
    if not loss_err <= 1e-4 * abs(want["loss"].item()):
        fail(f"train fp32 loss: card {got['loss'].item():.6f}, CPU "
             f"{want['loss'].item():.6f}")
    err = close("train fp32 logits vs CPU", got["logits"].cpu(),
                want["logits"], TOL_SLICE)
    print(f"train fp32 check: loss card {got['loss'].item():.6f} CPU "
          f"{want['loss'].item():.6f} (err {loss_err:.3e}); logits "
          f"max_abs_err {err:.3e}")
    for name in CHECK_LEAVES + CHECK_STATS:
        e = close_normwise(f"train fp32 {name}", got[name].cpu(), want[name],
                           GRAD_NORMWISE)
        kind = "stat" if name in CHECK_STATS else "grad"
        print(f"train fp32 check: {kind} {name}: max_abs_err {e:.3e} of "
              f"max {want[name].abs().max().item():.3e}")


def train_breakdown(torch, model, cfg, state, batch, n: int) -> None:
    """(d) where a train step's time goes: the step's own phases written out
    (augment, forward, backward, optimizer) between CUDA events with a
    synchronise after each, then ``n`` whole steps under torch.profiler for
    the four kernels and the device's busy share."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from mmvqa_tpu_torch.data.images import process_batch
    from mmvqa_tpu_torch.ops.losses import weighted_token_nll
    from mmvqa_tpu_torch.train.steps import make_mlm_steps

    dev = model.device
    b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    phases = {"augment": [], "forward": [], "backward": [], "optimizer": []}

    def timed(name, fn):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        z.record()
        z.synchronize()
        phases[name].append(a.elapsed_time(z))
        return out

    model.set_mode(deterministic=False)
    for _ in range(n):
        with torch.no_grad():
            img = timed("augment", lambda: process_batch(
                b["image"], gen, augment=True))
        loss = timed("forward", lambda: weighted_token_nll(
            model(img, b["tokens"], b["segment_ids"], b["input_mask"]),
            b["labels"], b["weights"]))
        timed("backward", loss.backward)
        timed("optimizer", state.apply_gradients)
        del img, loss
    print(f"train bf16 B={TRAIN_B}: ms per phase (CUDA events, synchronised "
          f"between phases, median of {n}): " + ", ".join(
              f"{k} {statistics.median(v):.2f}" for k, v in phases.items()))

    train_step, _ = make_mlm_steps(model, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            train_step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [a for a in prof.key_averages()
               if a.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda a: a.self_device_time_total, reverse=True)
    busy = sum(a.self_device_time_total for a in kernels) / 1e3
    if busy <= 0:
        print("train: device busy share not measured (the profiler saw no "
              "device time)")
        return
    print(f"train bf16 B={TRAIN_B}: traced {n} steps, wall {wall / n:.2f} "
          f"ms/step, device busy {busy / n:.2f} ms/step "
          f"({100 * busy / wall:.1f}%)")
    ours = ("token_head_partial", "token_head_finalize", "token_head_bwd",
            "token_head_dw_reduce", "realformer_attn_fwd",
            "realformer_attn_bwd", "depthwise3x3_fwd", "depthwise3x3_bwd",
            "depthwise3x3_dw_reduce", "conv1x1_stats_bf16",
            "conv1x1_stats_reduce", "bn_backward_sums_kernel",
            "bn_backward_sums_reduce")

    def total(hit):
        return (sum(a.self_device_time_total for a in hit) / 1e3 / n,
                sum(a.count for a in hit) / n)

    for tag in ours:
        ms, calls = total([a for a in kernels if tag in a.key])
        print(f"  {ms:9.4f} ms/step {calls:7.1f} calls  {tag}")
    # what is left of the library's kernels at the routed sites: no batch
    # norm at all in training; depthwise only at the two stride-2 sites
    mine = [a for a in kernels if "mmvqa" in a.key]
    rest = [a for a in kernels if "mmvqa" not in a.key]
    bn = [a for a in rest if any(t in a.key.lower() for t in (
        "batch_norm", "batchnorm", "bn_fw", "bn_bw"))]
    dw = [a for a in rest if any(t in a.key.lower() for t in (
        "depthwise", "dwise", "dgrad2d_c1_k1", "wgrad2d_c1_k1",
        "conv2d_c1_k1"))]
    for tag, hit in (("library batch-norm kernels", bn),
                     ("library depthwise kernels (2 stride-2 sites)", dw),
                     ("all hand-written kernels", mine)):
        ms, calls = total(hit)
        print(f"  {ms:9.4f} ms/step {calls:7.1f} calls  {tag}")
        for a in hit if hit is not mine else ():
            print(f"      {a.count / n:7.1f} calls  {a.key[:90]}")
    if bn:
        fail("a library batch-norm kernel ran in the train step: "
             + ", ".join(a.key[:60] for a in bn))
    for a in kernels[:14]:
        print(f"  {a.self_device_time_total / 1e3 / n:9.4f} ms/step "
              f"{a.count // n:5d} calls  {a.key[:80]}")


def train_phase(torch):
    """(b), (c): the main path of the train slice; returns its launches."""
    from mmvqa_tpu_torch.data.synthetic import mlm_batches
    from mmvqa_tpu_torch.models import MMBert
    from mmvqa_tpu_torch.models.mmbert import compute_dtype_of
    from mmvqa_tpu_torch.train.state import create_train_state
    from mmvqa_tpu_torch.train.steps import make_mlm_steps
    from mmvqa_tpu_torch.train.trainer import mlm_epoch

    train_check_fp32(torch)

    cfg = flagship_mlm_config(batch_size=TRAIN_B, mixed_precision=True,
                              lr=TRAIN_LR, seed=SEED)
    model = MMBert(cfg, compute_dtype=compute_dtype_of(cfg),
                   generator=torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"train: MMBert MLM {cfg.cnn_encoder} + {cfg.transformer_model}, "
          f"hidden {cfg.hidden_size}, {cfg.n_layers} layers, T="
          f"{cfg.max_position_embeddings}, vocab {cfg.vocab_size}, "
          f"{cfg.image_size} px, {n_params / 1e6:.2f} M fp32 parameters, "
          f"compute {model.dtype}, B={TRAIN_B}, lr {cfg.lr}, on "
          f"{model.device}")
    state = create_train_state(model, cfg.lr, clip=cfg.clip)
    train_step, eval_step = make_mlm_steps(model, cfg)
    batch = mlm_batches(cfg, 1, SEED)[0]
    loader = [batch] * TRAIN_STEPS

    # per-step times and losses: the step wrapped in a host clock that ends
    # in a synchronise
    times, losses = [], []

    def clocked(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
        return state, m

    torch.cuda.reset_peak_memory_stats()
    state, first = mlm_epoch(clocked, state, loader, True)
    peak = torch.cuda.max_memory_allocated() / 2**20
    losses = [x.item() for x in losses]
    step_ms = statistics.median(times[1:])
    print(f"train bf16 B={TRAIN_B}: ms per step {['%.1f' % t for t in times]} "
          f"(median after the first {step_ms:.2f}, "
          f"{TRAIN_B / step_ms * 1e3:.1f} images/s); peak memory "
          f"{peak:.1f} MiB; losses {['%.4f' % x for x in losses]}; epoch "
          f"{first}")

    # the main path, undisturbed: one epoch through mlm_epoch, counters read
    # around it
    reset_counts()
    state, second = mlm_epoch(train_step, state, loader, True)
    launches = read_counts()
    print(f"train bf16 B={TRAIN_B}: mlm_epoch of {TRAIN_STEPS} steps: "
          f"{second}; launches {launches}")
    per_step = {"token_head": 5, "token_head_bwd": 5,
                "realformer_attention": cfg.n_layers,
                "realformer_attention_bwd": cfg.n_layers,
                "depthwise3x3": 42, "depthwise3x3_bwd": 42,
                "conv1x1_stats": 98, "bn_backward_sums": 156}
    want = {name: n * TRAIN_STEPS for name, n in per_step.items()}
    if launches != want:
        fail(f"train launches {launches}, want {want}")
    copies = gradient_copies()
    print(f"train: gradients copied into their map's layout: {copies}")
    if any(copies.values()):
        fail(f"train: a gradient reached a kernel site in another layout "
             f"than its map and was copied: {copies}")
    for name, m in (("first", first), ("second", second)):
        if not all(math.isfinite(v) for v in m.values()):
            fail(f"train: non-finite metric in the {name} epoch: {m}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train: loss did not fall on a repeated batch: {losses}")
    if not second["loss"] < first["loss"]:
        fail(f"train: the second epoch's loss {second['loss']} is not below "
             f"the first's {first['loss']}")
    if state.step != 2 * TRAIN_STEPS:
        fail(f"train: state.step {state.step}, want {2 * TRAIN_STEPS}")

    _, ev = mlm_epoch(eval_step, state, loader[:1], False)
    print(f"train: eval step on the trained batch: {ev}")
    if not math.isfinite(ev["loss"]):
        fail(f"train: eval loss {ev['loss']}")

    train_breakdown(torch, model, cfg, state, batch, 3)
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from mmvqa_tpu_torch.native import loader
    except ImportError as e:
        fail(f"cannot import the port ({e}): run from a checkout of the repo")

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    path = loader.build()
    loader.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(path, os.path.dirname(os.path.abspath(__file__)))}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = kernel_phase(torch)
    eval_launches = slice_phase(torch)
    train_launches = train_phase(torch)

    # launches: the counts read after each main path's run, counters set to
    # 0 just before it (the eval slice's forwards, then the train epoch).
    # ms, plain_ms, bound_ms, library_ms: at the train path's shapes in bf16,
    # B=TRAIN_B, summed over the calls of one pass (the trunk's kernels:
    # every site of a step, inputs not in the L2 cache); bound_by: what
    # binds the largest.
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1],
         "launches": eval_launches.get(name, 0) + train_launches[name],
         "launches_eval": eval_launches.get(name, 0),
         "launches_train": train_launches[name],
         "max_abs_err": max(r["err"].values()),
         "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": sum(ms for ms, _ in r["bounds"]),
         "bound_by": max(r["bounds"])[1],
         "library_ms": r["library_ms"] if name in WITH_LIBRARY else None}
        for name, r in kernels.items()
    ]}
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
