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
   every kernel that sums across blocks give identical bits. Beyond the
   main path's shapes: the token head's backward at K=2048 (the ResNet-152
   trunk's last tap) and the attention, forward and backward, at T=128 and
   T=512 (its tiled kernels). Each attention case must take the
   tensor-core kernels of its dtype (bf16, or fp32 as split TF32) where
   forward_path and backward_path say so, each on its own counter, and two
   runs of it must give identical bits. The token head's forward prints its
   rate (TFLOP/s of its products) and its share of the bound per tap at B=128
   and B=16; in fp32 every call must take its split-TF32 kernel, one launch,
   and two runs must give identical bits; conv1x1 + statistics must take
   its TMA + wgmma path at every bf16 trunk site shape; the attention at
   T=75 and T=28, forward and
   backward, and the BN-backward sums at every site shape print their
   share of the bound.
3. Eval slice: the flagship VQA model (EfficientNetV2-M + RealFormer, hidden
   768, 4 layers, T=28, 224 px) with seeded random weights answers batches
   of 16 synthetic requests through ``make_vqa_eval_step``, in fp32 and in
   bf16. The launch counters must show the token head 5x, the attention
   4x (in bf16 all on its tensor-core kernel) and the depthwise 3x3 42x per
   forward; the fp32 logits must match the
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
   token head 5x forward and 5x backward, the attention 4x and 4x (all on
   its tensor-core kernels), the depthwise 3x3 42x and 42x,
   conv1x1 + statistics 98x (all of them on its TMA path) and the
   BN-backward sums 156x. (d) Where the time goes: forward, backward and
   optimizer by CUDA events, the eight kernels, what is left of the
   library's batch-norm and depthwise kernels, and the device's busy share
   by torch.profiler; a library batch-norm kernel in the train step fails
   the run, and so does a second pass (a reduce or finalize kernel) of the
   token head, forward or backward, of the depthwise backward, of conv1x1 +
   statistics or of the BN-backward sums, and an attention kernel, forward
   or backward, other than the tensor-core ones of the step's dtype
   (``realformer_attn_{fwd,bwd}_mma`` in bf16, ``_tf32x3`` in fp32). Every
   traced step and eval
   batch fails where the token head's forward runs a kernel other than its
   dtype's: ``token_head_fwd_mma`` in bf16, ``token_head_fwd_tf32x3`` in
   fp32.

5. Fine-tune slice: VQA-Med fine-tuning of the flagship model. (a) One
   fp32 VQA train step at B=8 on the card and on the CPU plain path under
   each criterion (cross entropy, ASL, the category-smoothing table), held
   as the MLM step is. (b) The transfer: the flagship MLM model's weights
   saved (``save_weights``), loaded and filtered (``filtered_restore``) into
   the VQA model; exactly the tensors whose shape differs (``classifier_2``)
   stay fresh, every other tensor equals its saved value. (c) The main path:
   bf16 compute, B=16, dropout on, one step and then an epoch of 6 steps
   through ``vqa_epoch`` and ``make_vqa_steps`` on a repeated batch; the
   loss falls; per step the token head 5x and 5x, the attention 4x and 4x
   on its tensor-core kernels, the depthwise 3x3 42x and 42x,
   conv1x1 + statistics 98x on its TMA path, the BN-backward sums 156x;
   the profiler's rules of the train slice; ms per step, the device's busy
   time, items/s, peak memory; a validation pass, the plateau scheduler,
   the best weights and a recorder round trip. (d) grad_accum=2 in fp32:
   micro-step 1 leaves the parameters, micro-step 2 is Adam on the mean of
   the two micro-gradients, and a run resumed from a recorder written
   between them matches the run that never stopped (rtol 1e-6, atol 1e-7;
   cuDNN held deterministic for this check). Checkpoints go to
   ``_checkpoints/`` in the checkout and are removed at the end.
6. CLI slice: ROCO pretraining from disk through
   ``mmvqa_tpu_torch.cli.roco_train.main``. The port writes a ROCO fixture
   of 64 train and 32 validation JPEGs at 512x416 px (its numpy encoder);
   the decoded pixels of three of them, full size and through
   ``load_image`` at 224 px, must give the pinned digest that
   tests/test_torch_jpeg.py holds to PIL on the CPU; the host's decode +
   resize rate on one thread is printed with the host's CPU count. Then the
   flagship at full width and depth, B=16, four loader threads: two epochs
   with ``--mixed_precision`` (bf16 compute) and one at the CLI's default
   fp32. For each run the launch counters, set to 0 before and read after,
   must equal the run's train steps and eval forwards times each kernel's
   count a pass (bf16 on the tensor-core and TMA paths), every loss must be
   finite, the weights file and the metric lines must be written; train
   items/s and the share of each train epoch the loop waited on the loader
   are printed. The summary line's ``launches_cli`` holds these counts.
   The fixture and the bf16 run's weights stay for the next phase.
7. Drivers slice: the user's whole pipeline from disk at the same width,
   batch and loader threads. (a) SupCon pretraining through
   ``cli.roco_supcon_train.main`` (``--con_task supcon --similarity
   jaccard``, the loader at B // 2, two views a sample) on the CLI slice's
   fixture: one epoch in bf16 with the mask passed (``--use_sim_mask``),
   one in fp32 without; finite MLM, SupCon and validation losses and the
   weights file. (b) One fp32 SupCon step at 4 pairs with the Jaccard mask,
   card against the CPU plain path, held as the MLM step is, the projection
   head's gradients among the leaves. (c) Fine-tuning through
   ``cli.vqa_train.main`` on a VQA-Med fixture the port writes (65 train,
   30 val, 30 test questions at 512x416 px) from the CLI slice's bf16
   weights with its vocabulary: exactly ``classifier_2`` stays fresh; one
   epoch in bf16 with the category smoothing and
   ``--watch_histograms``
   (the histograms computed on the card), one in fp32 with ASL; the
   per-category keys of every metric line and both best checkpoints (the one
   by accuracy where a validation accuracy beat 0). (d) Evaluation through
   ``cli.vqa_eval.main`` of one model and of an ensemble of two: both
   files with a row a test question, ``total_acc`` equal to the share of
   right rows. Every run: the counters at their exact counts (train steps,
   histogram passes, validation, test and eval forwards), train items/s and
   the loader's wait share. The summary line's ``launches_drivers`` holds
   them.

8. Default-model slice: the model every CLI builds without encoder flags,
   the reference's MMBERT (ResNet-152, five visual tokens deepest first,
   four pre-norm BERT layers of 12 heads at hidden 768), seeded random
   weights, 224 px. (a) K1 at its five taps, K4 and K5 at every distinct
   site shape, at B=16 in fp32 and B=128 in bf16, and K1's forward in fp32
   at B=128 too, each against its plain version (two runs bit for bit) and
   timed beside it, its bound and, for K4 and K5, the library's calls. (b)
   Eval at B=16, T=28: fp32 logits
   against the CPU plain path, bf16 as the eval slice holds them, five K1
   launches a forward and no other kernel. (c) One fp32 MLM train step at
   B=8, T=75, card against the CPU, with its own leaves and statistics
   (``default_train_check_fp32`` says why the bn3 scales are lowered and the
   trunk's leaves allowed a ReLU-flip term); then the CLIs' fp32 step at
   B=16, five steps at exact counts and three traced (the card's busy
   time, the fp32 trace rules). (d) The bf16 main path at
   B=128 through ``mlm_epoch``: the loss falls; per step K1 5 and 5, K4 101
   on its TMA path, K5 155; the train slice's profiler rules. (e)
   ``roco_train.main`` (bf16 and fp32), ``vqa_train.main`` from its bf16
   weights and ``vqa_eval.main`` without encoder flags on the fixtures of
   the CLI and drivers slices, each at its exact launch counts. The summary
   line's ``launches_default`` holds the counts of (b), (d) and (e).

9. The remaining model paths, each at full width and 224 px, each held
   against the CPU plain path at the tolerances above (the default trunk's
   fp32 train steps with the bn3 scales and the ReLU term of 8 (c),
   ``held_step_fp32``), every count exact. (a) Distillation on the default
   model and the flagship: one fp32 ``make_distill_steps`` step at B=8
   (labels (B, 75, 768), seeded), the bf16 main path at B=16 (the loss
   falls; traced), then ``roco_train.main --task distillation
   --watch_histograms`` on the CLI slice's fixture, AUX_EPOCHS epochs in bf16
   and in fp32, a seeded stand-in in place of the dataset's ClinicalBERT
   teacher. (b) ``ImageOnlyClassifier`` with its keyword pathway on each
   trunk: an eval step at B=4, a fp32 step at B=8, the bf16 main path at
   B=16; K1 and K2 never launch. (c) ``MMBert`` with the feedback encoder
   on the default trunk: eval at B=16, a fp32 MLM step at B=8, T=75, the
   bf16 VQA main path at B=16, then ``vqa_train.main`` and
   ``vqa_eval.main`` with ``--transformer_model feedback-transformer`` on
   the drivers slice's fixture; K2 never launches. (d) ``SupConEncoder``
   on each trunk: a forward in train mode and one in eval mode at B=4,
   unit features. The summary line's ``launches_aux`` holds the counts of
   the main paths, eval, forwards and CLI runs.

10. Explain: Grad-CAM and the CAM zoo. ``tests/data/progressive.jpg`` decodes
   to its pinned digest (the port's progressive decoder, held to PIL on the
   CPU). (a) ``grad_cam_activations`` and ``grad_cam_heatmap`` at full width
   in fp32, B=1, on the card against the same seeded model on the CPU plain
   path, for the flagship and the default model: activations, gradients,
   logits and heatmap to stated normwise tolerances. (b) The kernels at the
   CLI's shapes against their plain versions: K1's forward at B=1 at every
   tap of both trunks and at B=32, its backward at B=1 at both deepest taps,
   K2 forward and backward at B=1, T=28 (forward at B=32 too), K3's forward
   at B=1 and B=32 at every site shape. (c) ``cli.grad_cam.main`` on the
   drivers slice's VQA-Med fixture with seeded weights: the six methods on
   each model, with and without ``--cnn_only``; each
   run's counters at the counts ``explain_runs`` derives, its printed lines,
   its file decoding to 224 x 224, its wall time. The summary line's
   ``launches_explain`` holds the counts of (c), and
   ``explain_max_abs_err`` the errors of (a).

11. Layouts: NCCL's collectives with one rank, then every multi-GPU layout's
   fp32 step of the full-width models at the CLIs' global B=16 on ranks that
   share the card over gloo, in two stages: data, FSDP and tensor
   parallelism and their composition (the flagship, the default model,
   SupCon, VQA with the clip), pipeline parallelism (pp=2 on both models,
   dp=2 x pp=2: K2 on each stage's microbatches), context parallelism (cp=3
   with the ring at T=75, cp=3 with the gathered encoder on both models: K2
   at full length on the flagship, VQA at cp=2 with the ring at T=28), each
   held to the single process's step on the card (``check_layout``: loss,
   leaves, norms, each parameter's change, equal replicas, local kernel
   shapes, exact launches a rank); ``roco_train`` under torchrun with
   ``--dp_size 2 --fsdp`` and with ``--pp_size 2``, whose stacked weights a
   single-process ``vqa_train`` takes up through ``adapt_encoder_layout``.
   The first stage runs beside phase 9 and the second beside phase 10 (their
   own processes; the host times those phases print are shared with them).
   The summary line's ``launches_layouts`` holds the checked steps' counts.

Every phase that traces with torch.profiler fails where the profiler saw no
device time twice (once more after a synchronise): a trace without device
events would check none of its rules.

Prints a JSON line of kernel results, the card line again, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line.
"""

from __future__ import annotations

import csv
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
FT_STEPS = 6        # fine-tune steps counted, after one that warms up
FT_VAL_BATCHES = 2  # validation batches of the fine-tune's B, the last partial
FT_SMOOTHING = 0.1  # the category-smoothing criterion's smoothing
ROOT = os.path.dirname(os.path.abspath(__file__))
CLI_IMAGE_SIZE = (512, 416)  # the CLI phase's JPEGs, width x height
CLI_TRAIN, CLI_VAL = 64, 32  # the CLI phase's fixture: JPEGs a split
CLI_B = 16                    # the CLI's default --batch_size
# the drivers phase's VQA fixture: questions a category in train, val, test
DRV_VQA_PER_CAT = (13, 6, 6)
CLI_ARGS = ["--mlm_prob", "0.15", "--cnn_encoder", "tf_efficientnetv2_m",
            "--transformer_model", "realformer", "--batch_size", str(CLI_B),
            "--num_workers", "4"]
# decode_digest of the CLI phase's fixture (tests/test_torch_jpeg.py computes
# it on the CPU, where PIL decodes the same files to the same pixels)
DECODE_DIGEST = "535f354c8ffae59bfd55cb9497b753107a903dbb70e2bf981bb2a61bd3774678"
# progressive_digest of tests/data/progressive.jpg (a PIL-written progressive
# file; tests/test_torch_jpeg.py holds the same decode to PIL on the CPU)
PROGRESSIVE_JPEG = os.path.join("tests", "data", "progressive.jpg")
PROGRESSIVE_DIGEST = "957e5fd8814647fe812f87551eddaee8bade975df93235506265ad2c5dbdec18"

# Tolerances, kernel vs plain version on the same card and inputs.
# fp32: both accumulate in fp32 in another order; the token head's sums run
# over up to 12544 positions, so 1e-4 relative.
TOL_K1_F32 = dict(rtol=1e-4, atol=1e-5)
# bf16: both round one fp32 result to bf16 (8 significant bits): two ulps.
TOL_BF16 = dict(rtol=8e-3, atol=2e-3)
# attention fp32, the JAX package's own tests/test_pallas_attention.py:
# valid query rows tight; padded rows carry -10000, whose fp32 ulp (1e-3)
# moves a softmax weight by up to 1e-3 relative; the carry itself. The
# split-TF32 kernels' arithmetic meets these (and TOL_K2_BWD) on the CPU
# within 7% of each, where one TF32 product a product misses them
# (tests/test_torch_attention_fp32.py).
TOL_K2_VALID = dict(rtol=2e-5, atol=2e-5)
TOL_K2_PADDED = dict(rtol=5e-3, atol=2e-3)
TOL_K2_CARRY = dict(rtol=2e-5, atol=2e-4)
# K1 backward, the JAX package's tests/test_token_head.py:44-47: gradients to
# rtol 1e-4. dx and dW are sums of up to 768 and B * 12544 fp32 terms of
# both signs, taken in another order, so the absolute term is 1e-4 of the
# largest entry of the plain result (set per case). In bf16 the kernel and
# the plain version both round gact to bf16 before the products, as the
# reference's kernel does; where their fp32 s differ in the last bits a
# gact lands one bf16 ulp apart, which moves a dx entry (a sum of 768 such
# terms) by up to 6.2e-4 of dx's largest entry: measured on the CPU between
# the plain version and the reference's kernel in interpret mode
# (tests/test_torch_train.py::
# test_token_head_bf16_backward_matches_the_reference_kernel, which holds
# dx to 1e-3 of its largest entry). So bf16 dx is held to two bf16 ulps
# (rtol 8e-3) on top of ATOL_K1_BWD_DX_BF16 of its largest entry. bf16 dW,
# fp32 sums of those terms, moves by up to half of ATOL_K1_BWD_DW_BF16 of its
# largest entry when only the order of s's sums changes (the plain version
# against itself with s summed in fp64, on the CPU at B=16 and K from 176
# to 2048: tests/test_torch_train.py::
# test_token_head_bf16_dw_moves_with_the_order_of_s): rtol RTOL_K1_BWD on
# top of ATOL_K1_BWD_DW_BF16 of its largest entry. At those long sums a
# kernel that kept gact in fp32 moves dW by 1.0e-3 to 1.9e-3, not always
# beyond the limit; so the rounding itself is held at the CPU test's short
# sum (B=2, P=700, K=24, C=64), where the plain version meets the
# reference's kernel in interpret mode within ATOL_K1_BWD_DW_ROUNDING of
# dW's largest entry (read 1.4e-5; tests/test_torch_train.py::
# test_token_head_bf16_backward_matches_the_reference_kernel) and the
# fp32-gact control must miss it.
RTOL_K1_BWD = 1e-4
ATOL_K1_BWD_DX_BF16 = 1e-3
ATOL_K1_BWD_DW_BF16 = 1e-3
ATOL_K1_BWD_DW_ROUNDING = 5e-5
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
# fp32 products on the tensor cores as three TF32 products (a third of the
# dense TF32 rate, 495 TFLOP/s: csrc/tf32x3.cuh); special-function rate, 16
# units an SM x 132 SMs x 1.98 GHz boost clock.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "tf32x3": 495e12 / 3}
SM_CLOCK_HZ = 1.98e9
PEAK_SFU = 16 * 132 * SM_CLOCK_HZ
# special-function evaluations per projected element: SERF is exp, log1p
# and erf forward, and those plus exp(-y^2) and a sigmoid backward; the
# bf16 polynomial form is one sigmoid (an exp and a reciprocal) both ways
SFU_PER_ELEMENT = {("serf", "fwd"): 3, ("serf", "bwd"): 6,
                   ("serf_fast", "fwd"): 2, ("serf_fast", "bwd"): 2}


def decode_digest(roco_dir: str) -> str:
    """sha256 over the pixels of the first three train images of a ROCO
    fixture the port wrote at CLI_IMAGE_SIZE from SEED: each decoded at full
    size, then through ``load_image`` at 224 px. The same constant holds the
    host build of both machines to one answer."""
    import hashlib

    from mmvqa_tpu_torch.data.images import load_image
    from mmvqa_tpu_torch.data.jpeg import read_rgb

    h = hashlib.sha256()
    for i in range(3):
        path = os.path.join(roco_dir, "train", "radiology", "images",
                            f"ROCO_train_{i:04d}.jpg")
        h.update(read_rgb(path).tobytes())
        h.update(load_image(path, 224).tobytes())
    return h.hexdigest()


def progressive_digest(path: str) -> str:
    """sha256 over the pixels of a progressive JPEG decoded at full size and
    through ``load_image`` at 224 px."""
    import hashlib

    from mmvqa_tpu_torch.data.images import load_image
    from mmvqa_tpu_torch.data.jpeg import read_rgb

    h = hashlib.sha256()
    h.update(read_rgb(path).tobytes())
    h.update(load_image(path, 224).tobytes())
    return h.hexdigest()


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


def rate(nbytes: float, ms: float, bound_ms: float) -> str:
    """The bytes a function must move over its time, and its bound's share
    of that time."""
    return (f"{nbytes / ms / 1e6:.1f} GB/s, {100 * bound_ms / ms:.1f}% of "
            f"the bound")


def k1_bound(B, P, K, C, itemsize, act, direction, tensor_cores=False):
    """Token head: x read (and dx written), W read (dW written in fp32),
    the (B, C) output or its gradient; one product forward, three backward;
    the activation's special functions. fp32 products at the CUDA cores'
    rate, or with ``tensor_cores`` as split-TF32 products."""
    name = ("bf16" if itemsize == 2 else
            "tf32x3" if tensor_cores else "fp32")
    x, w, out = B * P * K * itemsize, K * C * itemsize, B * C * itemsize
    products = 2.0 * B * P * K * C
    sfu = SFU_PER_ELEMENT[(act, direction)] * B * P * C
    if direction == "fwd":
        return bound(x + w + out, products, sfu, name)
    return bound(2 * x + w + K * C * 4 + B * C * 4, 3 * products, sfu, name)


def k1_fwd_rate(B, P, K, C, ms, bound_ms) -> str:
    """The product's rate and the bound's share of the time."""
    return (f"{2.0 * B * P * K * C / ms / 1e9:.1f} TFLOP/s, "
            f"{100 * bound_ms / ms:.1f}% of the bound")


def k1_bwd_rate(B, P, K, C, ms, bound_ms) -> str:
    """The three products' rate and the bound's share of the time."""
    return (f"{3 * 2.0 * B * P * K * C / ms / 1e9:.1f} TFLOP/s, "
            f"{100 * bound_ms / ms:.1f}% of the bound")


def checked_k1_fwd(label, x, w, act):
    """The forward twice, bit for bit, against the plain version; in fp32
    one launch a call on the split-TF32 kernel. Returns the error."""
    import torch

    from mmvqa_tpu_torch.ops.token_head import (
        fused_token_head,
        token_head_reference,
    )

    fp32 = x.dtype == torch.float32
    tf32x3 = fused_token_head.tf32x3_launches
    got = fused_token_head(x, w, act)
    again = fused_token_head(x, w, act)
    want = token_head_reference(x, w, act)
    torch.cuda.synchronize()
    if fused_token_head.tf32x3_launches - tf32x3 != (2 if fp32 else 0):
        fail(f"token_head {label}: fp32 off the split-TF32 path")
    if not torch.equal(got, again):
        fail(f"token_head {label}: two runs differ")
    return close(f"token_head {label}", got, want,
                 TOL_K1_F32 if fp32 else TOL_BF16)


def check_k1_bwd(label, x, dx, dw, dx_p, dw_p):
    """K1-bwd against its plain version: (dx error, dW error)."""
    bf16 = x.element_size() == 2
    if dx.stride() != x.stride():
        fail(f"token_head_bwd {label}: dx is not laid out as x")
    e_dw = close(f"token_head_bwd {label} dW", dw, dw_p, dict(
        rtol=RTOL_K1_BWD,
        atol=(ATOL_K1_BWD_DW_BF16 if bf16 else RTOL_K1_BWD)
        * dw_p.abs().max().item()))
    scale = dx_p.float().abs().max().item()
    dx_tol = (dict(rtol=8e-3, atol=ATOL_K1_BWD_DX_BF16 * scale) if bf16
              else dict(rtol=RTOL_K1_BWD, atol=RTOL_K1_BWD * scale))
    return close(f"token_head_bwd {label} dx", dx, dx_p, dx_tol), e_dw


def k2_bound(B, H, T, E, itemsize, with_prev, with_mask, direction,
             tensor_cores=False):
    """Attention core: q, k, v and ctx (their gradients and dctx backward),
    the fp32 carries; two products forward, four backward; one exp a score.
    fp32 products at the CUDA cores' rate, or with ``tensor_cores`` as
    split-TF32 products."""
    name = ("bf16" if itemsize == 2 else
            "tf32x3" if tensor_cores else "fp32")
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
    # every launch of the forward, whichever of its kernels took it (the
    # one-block kernel, the tiled one, the bf16 and fp32 tensor-core ones)
    "realformer_attention": (
        "mmvqa_tpu_torch/csrc/realformer_attention.cu",
        "mmvqa_tpu/ops/pallas_attention.py:146",
        "scaled_dot_product_attention takes no residual scores and returns "
        "no score carry"),
    # of those, realformer_attn_fwd_mma_kernel: bf16 on mma.sync, the eval
    # and train paths' only attention forward in bf16
    "realformer_attention_mma": (
        "mmvqa_tpu_torch/csrc/realformer_attention.cu",
        "mmvqa_tpu/ops/pallas_attention.py:146",
        "scaled_dot_product_attention takes no residual scores and returns "
        "no score carry"),
    # and realformer_attn_fwd_tf32x3_kernel: fp32 as split-TF32 products on
    # mma.sync, every fp32 attention forward of the flagship's paths
    "realformer_attention_tf32x3": (
        "mmvqa_tpu_torch/csrc/realformer_attention.cu",
        "mmvqa_tpu/ops/pallas_attention.py:146",
        "scaled_dot_product_attention takes no residual scores and returns "
        "no score carry"),
    # every launch of the backward, whichever of its kernels took it (the
    # one-block kernel, the tiled pair, the bf16 and fp32 tensor-core ones)
    "realformer_attention_bwd": (
        "mmvqa_tpu_torch/csrc/realformer_attention_bwd.cu",
        "mmvqa_tpu/ops/pallas_attention.py:164",
        "no PyTorch call takes a score carry and its gradient"),
    # of those, realformer_attn_bwd_mma_kernel: bf16 on mma.sync, the train
    # path's only attention backward
    "realformer_attention_bwd_mma": (
        "mmvqa_tpu_torch/csrc/realformer_attention_bwd.cu",
        "mmvqa_tpu/ops/pallas_attention.py:164",
        "no PyTorch call takes a score carry and its gradient"),
    # and realformer_attn_bwd_tf32x3_kernel: fp32 as split-TF32 products,
    # every fp32 attention backward of the flagship's paths
    "realformer_attention_bwd_tf32x3": (
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
    # of every launch of the token head, both ways, and of conv1x1 +
    # statistics, the fp32 ones: split-TF32 products on the tensor cores
    # (csrc/tf32x3.cuh); their ms, plain_ms and bound_ms are fp32's: K1's
    # five taps at the CLI's B=16, K4's 98 sites at B=128
    "token_head_tf32x3": (
        "mmvqa_tpu_torch/csrc/token_head.cu",
        "mmvqa_tpu/ops/pallas_token_head.py:247",
        "no single PyTorch call fuses the projection, SERF and the mean"),
    "token_head_bwd_tf32x3": (
        "mmvqa_tpu_torch/csrc/token_head_bwd.cu",
        "mmvqa_tpu/ops/pallas_token_head.py:273",
        "no single PyTorch call gives dx and dW of the fused head"),
    "conv1x1_stats_tf32x3": (
        "mmvqa_tpu_torch/csrc/conv1x1_stats.cu",
        "mmvqa_tpu/ops/pallas_conv_bn.py:81",
        "no single PyTorch call returns a product and the sums of its "
        "output; the two calls F.conv2d + torch.batch_norm_stats are timed "
        "as context"),
    # bn_backward_sums_kernel: one launch, the last block of a channel tile
    # adds the partials
    "bn_backward_sums": (
        "mmvqa_tpu_torch/csrc/bn_backward_sums.cu",
        "tools/bn_probe.py:73",
        "torch.batch_norm_backward_reduce, which returns sum dy, "
        "sum dy (x - mean) and that times inv_std"),
}
# kernels whose library_ms is a number, not null
WITH_LIBRARY = ("depthwise3x3", "depthwise3x3_bwd", "bn_backward_sums")


def add_fp32(r, count, ms, plain, library, bnd):
    """Adds ``count`` calls to a kernel's fp32 sums (FP32_SUMS)."""
    f = r["fp32"]
    f["ms"] += count * ms
    f["plain_ms"] += count * plain
    f["library_ms"] += count * library
    f["bounds"] += [bnd] * count


# what a kernel's fp32 sums cover: the CLIs' default dtype at their batch
# (B=16) where the token head and the attention are concerned, the trunk's
# kernels at the train path's B=128 as their bf16 sums are; bounds on the
# tensor cores (split-TF32) for K1 and K2, both ways, and K4, on the CUDA
# cores otherwise
FP32_SUMS = {
    "token_head": "the five taps at B=16",
    "token_head_bwd": "the five taps at B=16",
    "realformer_attention": "one layer at T=75, B=16, prev and mask",
    "realformer_attention_bwd": "one layer at T=75, B=16, prev and mask",
    "depthwise3x3": "the 42 sites at B=128",
    "depthwise3x3_bwd": "the 42 sites at B=128",
    "conv1x1_stats": "the 98 sites at B=128",
    "bn_backward_sums": "the 156 sites at B=128",
}


def kernel_phase(torch):
    """Every kernel against its plain version. The summary times are at the
    train path's shapes, bf16 at B=TRAIN_B: the five taps summed for the
    token head, one layer at T=75 with prev and padded queries for the
    attention; their fp32 sums are at the CLIs' B=16 (FP32_SUMS), K1-bwd's
    on the tensor cores' bound. The token head is timed as the trunk's
    kernels are: each call finds its inputs in device memory and queues
    behind a sleeping device, so that its time is the card's, not the
    host's."""
    from mmvqa_tpu_torch.models.visual_tokens import tap_positions
    from mmvqa_tpu_torch.ops.attention import (
        backward_path,
        forward_path,
        mma_occupancy,
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
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def checked_k1_bwd(label, x, w, gout, act):
        """Two runs of the backward, bit for bit, against the plain version;
        fp32 launches counted on the split-TF32 path."""
        tf32x3 = fused_token_head.backward_tf32x3_launches
        dx, dw = token_head_backward(x, w, gout, act)
        dx2, dw2 = token_head_backward(x, w, gout, act)
        dx_p, dw_p = token_head_backward_reference(x, w, gout, act)
        torch.cuda.synchronize()
        if (fused_token_head.backward_tf32x3_launches - tf32x3
                != (2 if x.dtype == torch.float32 else 0)):
            fail(f"token_head_bwd {label}: fp32 off the split-TF32 path")
        if not (torch.equal(dw, dw2) and torch.equal(dx, dx2)):
            fail(f"token_head_bwd {label}: two runs differ")
        e_dx, e_dw = check_k1_bwd(label, x, dx, dw, dx_p, dw_p)
        return dx, dw, e_dx, e_dw

    results = {name: {"err": {torch.float32: 0.0, torch.bfloat16: 0.0},
                      "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                      "bounds": [],
                      # fp32's sums at the CLIs' shapes (FP32_SUMS)
                      "fp32": {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                               "bounds": []}}
               for name in KERNELS}

    def note(name, dtype, err, summary, ms, plain, bnd, fp32_sum=False):
        r = results[name]
        r["err"][dtype] = max(r["err"][dtype], err)
        if summary:
            r["ms"] += ms
            r["plain_ms"] += plain
            r["bounds"].append(bnd)
        if fp32_sum:
            add_fp32(r, 1, ms, plain, 0.0, bnd)

    # ---- K1, forward and backward: the five taps at the eval batch (16,
    # the CLI's) and at the train batch, in both dtypes
    k1_cases = [(dtype, B, tap) for dtype in (torch.float32, torch.bfloat16)
                for B in (EVAL_B, TRAIN_B) for tap in TAPS]
    k1_fp32 = {B: [0.0, 0.0, 0.0] for B in (EVAL_B, TRAIN_B)}  # ms, plain, bound
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

        err = checked_k1_fwd(label, x, w, act)
        ms = time_ms(lambda: fused_token_head(x, w, act), reps, flush=flush)
        plain = time_ms(lambda: token_head_reference(x, w, act), reps,
                        flush=flush)
        bnd = k1_bound(B, P, K, HIDDEN, x.element_size(), act, "fwd",
                       tensor_cores=not bf16)
        print(f"token_head {label}: max_abs_err {err:.3e}, two runs identical"
              f"  kernel {ms:.4f} ms  plain {plain:.4f} ms  bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}{'' if bf16 else ', tensor cores'})"
              f"  {k1_fwd_rate(B, P, K, HIDDEN, ms, bnd[0])}")
        note("token_head", dtype, err, summary, ms, plain, bnd,
             fp32_sum=not bf16 and B == EVAL_B)
        if not bf16:
            note("token_head_tf32x3", dtype, err, B == EVAL_B, ms, plain, bnd)

        dx, dw, e_dx, e_dw = checked_k1_bwd(label, x, w, gout, act)
        del dx, dw
        ms = time_ms(lambda: token_head_backward(x, w, gout, act), reps,
                     flush=flush)
        plain = time_ms(
            lambda: token_head_backward_reference(x, w, gout, act), reps,
            flush=flush)
        bnd = k1_bound(B, P, K, HIDDEN, x.element_size(), act, "bwd")
        line = (f"token_head_bwd {label}: max_abs_err dx {e_dx:.3e} dW "
                f"{e_dw:.3e}, two runs identical  kernel {ms:.4f} ms  plain "
                f"{plain:.4f} ms  bound {bnd[0]:.4f} ms ({bnd[1]})  "
                f"{k1_bwd_rate(B, P, K, HIDDEN, ms, bnd[0])}")
        note("token_head_bwd", dtype, max(e_dx, e_dw), summary, ms, plain, bnd)
        if not bf16:
            tc = k1_bound(B, P, K, HIDDEN, 4, act, "bwd", tensor_cores=True)
            if B == EVAL_B:
                add_fp32(results["token_head_bwd"], 1, ms, plain, 0.0, tc)
            line += (f"; on the tensor cores: bound {tc[0]:.4f} ms ({tc[1]})"
                     f", {100 * tc[0] / ms:.1f}% of it")
            note("token_head_bwd_tf32x3", dtype, max(e_dx, e_dw),
                 B == EVAL_B, ms, plain, tc)
            for i, v in enumerate((ms, plain, tc[0])):
                k1_fp32[B][i] += v
        print(line)
        del feat, x
    for B, (ms, plain, tc) in k1_fp32.items():
        print(f"token_head_bwd fp32 B={B}, the five taps: kernel {ms:.4f} ms  "
              f"plain {plain:.4f} ms  bound on the tensor cores {tc:.4f} ms")

    # ---- K1 backward at K=2048, the ResNet-152 trunk's last tap (7x7),
    # which the flagship path does not reach: one row a dtype
    for dtype, B in ((torch.float32, EVAL_B), (torch.bfloat16, TRAIN_B)):
        bf16 = dtype == torch.bfloat16
        act = "serf_fast" if bf16 else "serf"
        P, K = 7 * 7, 2048
        feat = torch.randn(B, 7, 7, K, device=dev, generator=g)
        x = tap_positions(feat.to(dtype).permute(0, 3, 1, 2))
        w = (torch.randn(K, HIDDEN, device=dev, generator=g)
             * K ** -0.5).to(dtype)
        gout = torch.randn(B, HIDDEN, device=dev, generator=g)
        label = f"resnet_tap B={B} P={P} K={K} {dtype}"
        dx, dw, e_dx, e_dw = checked_k1_bwd(label, x, w, gout, act)
        del dx, dw
        ms = time_ms(lambda: token_head_backward(x, w, gout, act), 5,
                     flush=flush)
        plain = time_ms(
            lambda: token_head_backward_reference(x, w, gout, act), 5,
            flush=flush)
        bnd = k1_bound(B, P, K, HIDDEN, x.element_size(), act, "bwd")
        print(f"token_head_bwd {label}: max_abs_err dx {e_dx:.3e} dW "
              f"{e_dw:.3e}, two runs identical  kernel {ms:.4f} ms  plain "
              f"{plain:.4f} ms  bound {bnd[0]:.4f} ms ({bnd[1]})  "
              f"{k1_bwd_rate(B, P, K, HIDDEN, ms, bnd[0])}")
        note("token_head_bwd", dtype, max(e_dx, e_dw), False, ms, plain, bnd)
        if not bf16:
            note("token_head_bwd_tf32x3", dtype, max(e_dx, e_dw), False, ms,
                 plain, bnd)
        del feat, x

    # ---- K1 backward rounds gact to bf16 as the reference's kernel does:
    # at a short sum the kernel meets the plain version within
    # ATOL_K1_BWD_DW_ROUNDING, and the plain version that keeps gact in
    # fp32 misses it
    from mmvqa_tpu_torch.ops.token_head import _act_grad

    gc = torch.Generator().manual_seed(SEED)
    B, P, K, C = 2, 700, 24, 64
    x = torch.randn(B, P, K, generator=gc).bfloat16().to(dev)
    w = (torch.randn(K, C, generator=gc) * 0.1).bfloat16().to(dev)
    gout = torch.randn(B, C, generator=gc).to(dev)
    for act in ("serf", "serf_fast", "relu"):
        label = f"gact rounding B={B} P={P} K={K} C={C} {act}"
        dx, dw = token_head_backward(x, w, gout, act)
        dx_p, dw_p = token_head_backward_reference(x, w, gout, act)
        s32 = torch.einsum("bpk,kc->bpc", x.float(), w.float())
        gact = _act_grad(s32, act) * (gout / P)[:, None, :]
        dw_f = torch.einsum("bpk,bpc->kc", x.float(), gact)
        torch.cuda.synchronize()
        lim = ATOL_K1_BWD_DW_ROUNDING * dw_p.abs().max().item()
        e_dw = (dw - dw_p).abs().max().item()
        e_f = (dw_f - dw_p).abs().max().item()
        if not e_dw <= lim < e_f:
            fail(f"token_head_bwd {label}: dW err {e_dw:.3e}, fp32-gact "
                 f"control {e_f:.3e}, limit {lim:.3e}")
        e_dx = close(f"token_head_bwd {label} dx", dx, dx_p, dict(
            rtol=8e-3, atol=ATOL_K1_BWD_DX_BF16
            * dx_p.float().abs().max().item()))
        print(f"token_head_bwd {label}: max_abs_err dx {e_dx:.3e} dW "
              f"{e_dw:.3e} (limit {lim:.3e}; fp32-gact control {e_f:.3e})")
        note("token_head_bwd", torch.bfloat16, max(e_dx, e_dw), False, 0.0,
             0.0, None)

    # ---- K2, forward and backward
    H, E = HEADS, HEAD_DIM
    print("realformer_attention_mma: blocks an SM holds at E=96: " + ", "
          .join(f"T={T} {mma_occupancy(T, E, backward=False)}"
                for T in (28, 75, 128)))
    print("realformer_attention_bwd_mma: blocks an SM holds at E=96: " + ", "
          .join(f"T={T} {mma_occupancy(T, E, backward=True)}"
                for T in (28, 75, 125)))
    f32 = torch.float32
    print("realformer_attention_tf32x3: blocks an SM holds at E=96: " + ", "
          .join(f"T={T} {mma_occupancy(T, E, False, f32)}"
                for T in (28, 75, 128)))
    print("realformer_attention_bwd_tf32x3: blocks an SM holds at E=96: "
          + ", ".join(f"T={T} {mma_occupancy(T, E, True, f32)}"
                      for T in (28, 75, 96)))
    k2_cases = [(dtype, EVAL_B, T, wp, wm)
                for dtype in (torch.float32, torch.bfloat16)
                for T in (28, 75) for wp in (False, True)
                for wm in (False, True)]
    k2_cases += [(torch.bfloat16, TRAIN_B, T, wp, True)
                 for T in (28, 75) for wp in (False, True)]
    # past the tensor-core kernels' limits: the one-block kernels (the fp32
    # backward at T=97, the forward of either dtype at T=130) and the tiled
    # ones (the backward at T=128 and 130, both directions at T=512)
    k2_cases += [(dtype, EVAL_B, T, True, True)
                 for dtype in (torch.float32, torch.bfloat16)
                 for T in (128, 130, 512)]
    k2_cases += [(torch.float32, EVAL_B, 97, True, True)]
    # each case's (forward, backward) path at E=96, so that no case drifts
    # to another kernel unseen
    k2_paths = {(torch.float32, 97): ("mma", "one_block"),
                (torch.float32, 128): ("mma", "tiled"),
                (torch.bfloat16, 128): ("mma", "tiled"),
                (torch.float32, 130): ("one_block", "tiled"),
                (torch.bfloat16, 130): ("one_block", "tiled"),
                (torch.float32, 512): ("tiled", "tiled"),
                (torch.bfloat16, 512): ("tiled", "tiled")}
    for dtype, B, T, with_prev, with_mask in k2_cases:
        bf16 = dtype == torch.bfloat16
        want = k2_paths.get((dtype, T), ("mma", "mma"))
        if (forward_path(dtype, T, E), backward_path(dtype, T, E)) != want:
            fail(f"realformer_attention T={T} {dtype}: paths "
                 f"{forward_path(dtype, T, E)}, {backward_path(dtype, T, E)}"
                 f", the smoke expects {want[0]}, {want[1]}")
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
        summary = bf16 and B == TRAIN_B and T == 75 and with_prev
        label = (f"B={B} T={T} prev={with_prev} mask={with_mask} {dtype}")

        path = forward_path(dtype, T, E)
        # the dtype's tensor-core counter moves, the other one does not
        tc, other = (("mma_launches", "tf32x3_launches") if bf16
                     else ("tf32x3_launches", "mma_launches"))
        n0 = (realformer_attention.launches,
              getattr(realformer_attention, tc),
              getattr(realformer_attention, other))
        ctx, carry = realformer_attention(q, k, v, prev, mask)
        ctx2, carry2 = realformer_attention(q, k, v, prev, mask)
        ctx_p, carry_p = realformer_attention_reference(q, k, v, prev, mask)
        torch.cuda.synchronize()
        if (realformer_attention.launches - n0[0],
                getattr(realformer_attention, tc) - n0[1],
                getattr(realformer_attention, other) - n0[2]) != (
                    2, 2 if path == "mma" else 0, 0):
            fail(f"realformer_attention {label}: the {path} path did not "
                 f"take its kernel")
        if not (torch.equal(ctx, ctx2) and torch.equal(carry, carry2)):
            fail(f"realformer_attention {label}: two runs differ")
        del ctx2, carry2
        name = f"realformer_attention {label} ({path})"
        if bf16:
            e1 = e2 = close(name + " ctx", ctx, ctx_p, TOL_BF16)
        else:
            e1 = close(name + " ctx valid", ctx[valid], ctx_p[valid],
                       TOL_K2_VALID)
            e2 = close(name + " ctx", ctx, ctx_p, TOL_K2_PADDED)
        e3 = close(name + " carry", carry, carry_p, TOL_K2_CARRY)
        ms = time_ms(lambda: realformer_attention(q, k, v, prev, mask),
                     flush=flush)
        plain = time_ms(
            lambda: realformer_attention_reference(q, k, v, prev, mask),
            flush=flush)
        bnd = k2_bound(B, H, T, E, kqv.element_size(), with_prev, with_mask,
                       "fwd", tensor_cores=path == "mma")
        print(f"{name}: max_abs_err ctx {max(e1, e2):.3e} carry {e3:.3e}, "
              f"two runs identical  kernel {ms:.4f} ms  plain {plain:.4f} ms"
              f"  bound {bnd[0]:.4f} ms ({bnd[1]}); "
              f"{100 * bnd[0] / ms:.1f}% of the bound")
        k2_fp32 = not bf16 and T == 75 and with_prev and with_mask
        note("realformer_attention", dtype, max(e1, e2, e3), summary, ms,
             plain, bnd, fp32_sum=k2_fp32)
        if path == "mma":
            note("realformer_attention_mma" if bf16
                 else "realformer_attention_tf32x3", dtype, max(e1, e2, e3),
                 summary or k2_fp32, ms, plain, bnd)

        # the backward from the kernel's own carry; a layer with a prev also
        # gets a gradient for its carry, a last layer (here: no prev) none
        dctx = torch.randn(B, T, H, E, device=dev, generator=g).to(dtype)
        dcarry = (0.1 * torch.randn(B, H, T, T, device=dev, generator=g)
                  if with_prev else None)
        n0 = (realformer_attention.backward_launches,
              getattr(realformer_attention, "backward_" + tc),
              getattr(realformer_attention, "backward_" + other))
        dkqv, dprev = realformer_attention_backward(kqv, carry, dctx, dcarry,
                                                    with_prev)
        dkqv2, dprev2 = realformer_attention_backward(kqv, carry, dctx,
                                                      dcarry, with_prev)
        dq_p, dk_p, dv_p, ds_p = realformer_attention_backward_reference(
            q, k, v, carry, dctx, dcarry)
        torch.cuda.synchronize()
        path = backward_path(dtype, T, E)
        if (realformer_attention.backward_launches - n0[0],
                getattr(realformer_attention, "backward_" + tc) - n0[1],
                getattr(realformer_attention, "backward_" + other) - n0[2]
                ) != (2, 2 if path == "mma" else 0, 0):
            fail(f"realformer_attention_bwd {label}: the {path} path did not "
                 f"take its kernel")
        if not (torch.equal(dkqv, dkqv2)
                and (dprev is None or torch.equal(dprev, dprev2))):
            fail(f"realformer_attention_bwd {label}: two runs differ")
        del dkqv2, dprev2
        name = f"realformer_attention_bwd {label} ({path})"
        want = torch.cat([dk_p, dq_p, dv_p], dim=-1)
        e1 = close(name + " dkqv", dkqv, want,
                   TOL_K2_BWD_BF16 if bf16 else TOL_K2_BWD)
        e2 = (close(name + " dprev", dprev, ds_p, TOL_K2_BWD)
              if with_prev else 0.0)
        ms = time_ms(lambda: realformer_attention_backward(
            kqv, carry, dctx, dcarry, with_prev), flush=flush)
        plain = time_ms(lambda: realformer_attention_backward_reference(
            q, k, v, carry, dctx, dcarry), flush=flush)
        bnd = k2_bound(B, H, T, E, kqv.element_size(), with_prev, with_mask,
                       "bwd", tensor_cores=path == "mma")
        print(f"{name}: max_abs_err dkqv {e1:.3e} dprev {e2:.3e}, two runs "
              f"identical  kernel {ms:.4f} ms  plain {plain:.4f} ms  bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}); {100 * bnd[0] / ms:.1f}% of the "
              f"bound")
        note("realformer_attention_bwd", dtype, max(e1, e2), summary, ms,
             plain, bnd, fp32_sum=k2_fp32)
        if path == "mma":
            note("realformer_attention_bwd_mma" if bf16
                 else "realformer_attention_bwd_tf32x3", dtype, max(e1, e2),
                 summary or k2_fp32, ms, plain, bnd)

    trunk_kernel_phase(torch, results)
    for name, r in results.items():
        library = (f"library_ms {r['library_ms']:.4f}: "
                   if name in WITH_LIBRARY else "library_ms null: ")
        print(f"kernel {name}: max_abs_err fp32 "
              f"{r['err'][torch.float32]:.3e}, bf16 "
              f"{r['err'][torch.bfloat16]:.3e}; {library}{KERNELS[name][2]}")
    for name, what in FP32_SUMS.items():
        f = results[name]["fp32"]
        by = max(f["bounds"])[1]
        lib = (f"{f['library_ms']:.4f}" if name in WITH_LIBRARY
               else f"null (the two calls {f['library_ms']:.4f})"
               if name == "conv1x1_stats" else "null")
        print(f"kernel {name} fp32, {what}: ms {f['ms']:.4f}  plain_ms "
              f"{f['plain_ms']:.4f}  bound_ms "
              f"{sum(ms for ms, _ in f['bounds']):.4f} ({by})  library_ms "
              f"{lib}")
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
    eval model holds it, all four in fp32 at CHECK_B, the fp32 train
    check's batch, all four in bf16 at EVAL_B, the fine-tune step's
    batch, and in both dtypes at CLI_B, the CLI's, with K3's fp32 master
    weight. The summary times are bf16, each shape's time multiplied
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
    # the train steps' batches other than TRAIN_B: the fp32 check's and the
    # CLI's fp32 run's; the fine-tune step's and the CLI's bf16 run's
    SMALL_BATCHES = {torch.float32: sorted({CHECK_B, CLI_B}),
                     torch.bfloat16: sorted({EVAL_B, CLI_B})}
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
        elif name != "conv1x1_stats":  # K4 adds its tensor-core bound
            add_fp32(r, count, ms, plain, library, bnd)

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
        """y and the sums against the plain version, two runs bit for bit,
        bf16 through the TMA path, fp32 through the split-TF32 kernel;
        returns the errors and the largest plain sum."""
        tma = conv1x1_stats.tma_launches
        tf32x3 = conv1x1_stats.tf32x3_launches
        y, st = conv1x1_stats(x, w)
        y2, st2 = conv1x1_stats(x, w)
        if bf16 and conv1x1_stats.tma_launches != tma + 2:
            fail(f"conv1x1_stats {label}: a trunk shape took the mma.sync "
                 f"path")
        if not bf16 and conv1x1_stats.tf32x3_launches != tf32x3 + 2:
            fail(f"conv1x1_stats {label}: fp32 off the split-TF32 path")
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
                                  "conv1x1_stats", "conv1x1_stats_tf32x3",
                                  "bn_backward_sums")}

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
            nbytes = 2 * x_bytes + 36 * C
            bnd = bound(nbytes, 18.0 * size, 0, "fp32")
            print(f"depthwise3x3 {label}: max_abs_err {err:.3e}  kernel "
                  f"{ms:.4f} ms  plain {plain:.4f} ms  library {lib:.4f} ms  "
                  f"bound {bnd[0]:.4f} ms ({bnd[1]}); "
                  f"{rate(nbytes, ms, bnd[0])}")
            note("depthwise3x3", dtype, err, count, ms, plain, lib, bnd)
            del y, y_p

            e_dx, e_dw = check_k3_bwd(label, x, w, dy, bf16)
            ms = timed(lambda: depthwise3x3_backward(x, w, dy))
            plain = timed(lambda: depthwise3x3_backward_reference(x, w, dy))
            lib = timed(lambda: torch.ops.aten.convolution_backward(
                dyn, xn, wc, None, [1, 1], [1, 1], [1, 1], False, [0, 0], C,
                [True, True, False]))
            nbytes = 3 * x_bytes + 72 * C
            bnd = bound(nbytes, 36.0 * size, 0, "fp32")
            print(f"depthwise3x3_bwd {label}: max_abs_err dx {e_dx:.3e} dW "
                  f"{e_dw:.3e}, two runs identical  kernel {ms:.4f} ms  plain "
                  f"{plain:.4f} ms  library {lib:.4f} ms  bound {bnd[0]:.4f} "
                  f"ms ({bnd[1]}); {rate(nbytes, ms, bnd[0])}")
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
            # the train steps: the fp32 check's, the bf16 fine-tune's and
            # the CLI's (both dtypes), all with the fp32 master weight
            for bs in SMALL_BATCHES[dtype]:
                xs, dys = x[:bs], dy[:bs]
                lab = f"B={bs} {H}x{W}x{C} {dtype}"
                note_small("depthwise3x3", dtype, close(
                    f"depthwise3x3 {lab}", depthwise3x3(xs, w),
                    depthwise3x3_reference(xs, w),
                    TOL_BF16 if bf16 else TOL_K3_F32))
                note_small("depthwise3x3_bwd", dtype,
                           max(check_k3_bwd(lab, xs, w, dys, bf16)))
            del x, dy, xn, dyn

    # ---- K4: w is the convolution's (C, K) weight as its (K, C) view. fp32
    # is timed at the CLI's batch too, beside the same two library calls
    two_call_ms = 0.0
    k4_fp32 = {B: [0.0, 0.0, 0.0, 0.0] for B in (CLI_B, TRAIN_B)}

    def k4_bounds(N, K, C, size):
        """(bf16 or fp32 CUDA cores, split-TF32 on the tensor cores)"""
        nbytes = (N * K + K * C + N * C) * size + 8 * C
        ops = 2.0 * N * K * C + 3.0 * N * C
        return (bound(nbytes, ops, 0, "bf16" if size == 2 else "fp32"),
                bound(nbytes, ops, 0, "tf32x3"))

    def two_calls(x, wt, bs):
        xn = x.view(bs, x.shape[0] // bs, 1, x.shape[1]).permute(0, 3, 1, 2)
        w4 = wt.view(wt.shape[0], wt.shape[1], 1, 1)
        return timed(lambda: torch.batch_norm_stats(F.conv2d(xn, w4), 1e-3))

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
            two = two_calls(x, wt, B)
            bnd, tc = k4_bounds(N, K, C, x.element_size())
            line = (f"conv1x1_stats {label}: max_abs_err y {e_y:.3e} sums "
                    f"{e_s:.3e} (of max {s_max:.3e}), two runs "
                    f"identical  kernel {ms:.4f} ms  plain {plain:.4f} ms  "
                    f"bound {bnd[0]:.4f} ms ({bnd[1]})  [conv2d + "
                    f"batch_norm_stats {two:.4f} ms]")
            note("conv1x1_stats", dtype, e_y, count, ms, plain, 0.0, bnd)
            if bf16:
                two_call_ms += count * two
            else:
                line += (f"; on the tensor cores: bound {tc[0]:.4f} ms "
                         f"({tc[1]}), {100 * tc[0] / ms:.1f}% of it")
                # note() sums bf16 only: the fp32 sub-counter's row by hand
                r = results["conv1x1_stats_tf32x3"]
                r["err"][dtype] = max(r["err"][dtype], e_y)
                r["ms"] += count * ms
                r["plain_ms"] += count * plain
                r["bounds"] += [tc] * count
                add_fp32(results["conv1x1_stats"], count, ms, plain, two, tc)
                for i, v in enumerate((ms, plain, two, tc[0])):
                    k4_fp32[B][i] += count * v
            print(line)
            # the rows of the train steps at their smaller batches; fp32 at
            # the CLI's batch timed
            for bs in SMALL_BATCHES[dtype]:
                ns = N // B * bs
                xs = x[:ns]
                lab = f"N={ns} K={K} C={C} {dtype}"
                e_y = check_k4(lab, xs, w, bf16)[0]
                note_small("conv1x1_stats", dtype, e_y)
                if bf16 or bs != CLI_B:
                    continue
                note_small("conv1x1_stats_tf32x3", dtype, e_y)
                ms = timed(lambda: conv1x1_stats(xs, w))
                plain = timed(lambda: conv1x1_stats_reference(xs, w))
                two = two_calls(xs, wt, bs)
                _, tc = k4_bounds(ns, K, C, 4)
                print(f"conv1x1_stats {lab} ({count} sites): kernel {ms:.4f} "
                      f"ms  plain {plain:.4f} ms  [conv2d + batch_norm_stats "
                      f"{two:.4f} ms]  bound on the tensor cores "
                      f"{tc[0]:.4f} ms ({tc[1]}), {100 * tc[0] / ms:.1f}% of "
                      f"it")
                for i, v in enumerate((ms, plain, two, tc[0])):
                    k4_fp32[bs][i] += count * v
            del x

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
            nbytes = 2 * N * C * x.element_size() + 16 * C
            print(f"bn_backward_sums {label}: max_abs_err {err:.3e} (of max "
                  f"{s_max:.3e}), two runs identical  "
                  f"kernel {ms:.4f} ms  plain {plain:.4f} ms  library "
                  f"{lib:.4f} ms  bound {bnd[0]:.4f} ms ({bnd[1]}); "
                  f"{rate(nbytes, ms, bnd[0])}")
            note("bn_backward_sums", dtype, err, count, ms, plain, lib, bnd)
            # the rows of the train steps at their smaller batches
            for bs in SMALL_BATCHES[dtype]:
                ns = N // B * bs
                note_small("bn_backward_sums", dtype, check_k5(
                    f"N={ns} C={C} {dtype}", x[:ns], dy[:ns], mean,
                    inv_std)[2])
            del x, dy, xn, dyn
    print(f"conv1x1_stats: the two library calls (conv2d + batch_norm_stats) "
          f"take {two_call_ms:.4f} ms over the 98 sites, bf16")
    for bs, (ms, plain, two, tc) in k4_fp32.items():
        print(f"conv1x1_stats fp32 B={bs}, the 98 sites: kernel {ms:.4f} ms  "
              f"plain {plain:.4f} ms  conv2d + batch_norm_stats {two:.4f} ms  "
              f"bound on the tensor cores {tc:.4f} ms")
    print(f"trunk kernels at the eval batch {EVAL_B} (depthwise3x3 forward, "
          f"fp32 and bf16 with the weight in x's dtype), at the fp32 train "
          f"check's batch {CHECK_B}, the bf16 fine-tune step's batch "
          f"{EVAL_B} and the CLI's {CLI_B} in both dtypes (all four): cases "
          f"within the same limits {small}")


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


def device_work(prof, n: int, label: str):
    """The kernels and memory operations the card ran under ``prof``, by
    device time. A host-side annotation (``Optimizer.step#Adam.step``) also
    shows a device-side range, which spans the kernels it launched and the
    card's idle time between them: such ranges are printed, not counted."""
    from torch.profiler import DeviceType

    averages = prof.key_averages()
    host = {a.key for a in averages if a.device_type == DeviceType.CPU}
    device = sorted((a for a in averages if a.device_type == DeviceType.CUDA),
                    key=lambda a: a.self_device_time_total, reverse=True)
    for a in device:
        if a.key in host:
            print(f"{label}: not counted, the device-side range of the host "
                  f"annotation {a.key[:60]}: "
                  f"{a.self_device_time_total / 1e3 / n:.4f} ms per pass")
    return [a for a in device if a.key not in host]


def traced(torch, run, label: str):
    """``run()`` under torch.profiler, host and device activity, the card
    synchronised before and after: (its result, the wall time in ms, the
    profile). Where the profiler saw no device time it runs once more after
    a synchronise (F6, tools/probe_profiler.py: on some machines most
    traces of one short kernel come back empty; the smoke's traces hold
    thousands), and returns None if it again sees none."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    for attempt in (1, 2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        if any(a.device_type == DeviceType.CUDA
               and a.self_device_time_total > 0
               for a in prof.key_averages()):
            return out, wall, prof
        print(f"{label}: the profiler saw no device time (attempt {attempt} "
              "of 2)")
    return None


def profiled(torch, run, n: int, label: str):
    """``run()`` (``n`` passes) as ``traced`` traces it: the result, the
    wall time in ms and the device's kernels (``device_work``). Fails where
    the profiler saw no device time twice: a trace without device events
    checks no rule."""
    got = traced(torch, run, label)
    if got is None:
        fail(f"{label}: the profiler saw no device time twice: its rules "
             "were not checked")
    out, wall, prof = got
    kernels = device_work(prof, n, label)
    if sum(a.self_device_time_total for a in kernels) <= 0:
        fail(f"{label}: the profiler saw device time only in host "
             "annotations: its rules were not checked")
    return out, wall, kernels


def check_token_head_forward(kernels, label: str, bf16: bool) -> None:
    """Fails where the token head's forward ran a kernel other than its
    dtype's: token_head_fwd_mma in bf16, token_head_fwd_tf32x3 in fp32 (no
    partial or finalize kernel: each sums across its blocks itself)."""
    want = "token_head_fwd_mma" if bf16 else "token_head_fwd_tf32x3"
    other = [a.key for a in kernels if "token_head" in a.key
             and "token_head_bwd" not in a.key and want not in a.key]
    if other:
        fail(f"{label}: the token head's forward ran a kernel other than "
             f"{want}: {other}")


def trace_batches(torch, step, batches, label):
    """Device busy share under torch.profiler: summed kernel time over the
    host-clock span of ``batches``; prints the kernels that take most.
    Fails where the token head's forward runs another kernel than its
    dtype's (``label`` names the dtype)."""
    n = len(batches)
    outs, wall, kernels = profiled(torch, lambda: [step(b) for b in batches],
                                   n, f"slice {label}")
    check_outputs(torch, outs, label)
    check_token_head_forward(kernels, f"slice {label}", label == "bf16")
    busy = sum(a.self_device_time_total for a in kernels) / 1e3
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
        if dtype == torch.bfloat16:
            bf16_forwards = len(batches) + 2 * len(batches[1:])
    launches = read_counts()
    print(f"slice: launches over {forwards} forwards ({bf16_forwards} in "
          f"bf16): {launches}")
    want = dict.fromkeys(launches, 0)
    want.update(token_head=5 * forwards,
                token_head_tf32x3=5 * (forwards - bf16_forwards),
                realformer_attention=cfg.n_layers * forwards,
                realformer_attention_mma=cfg.n_layers * bf16_forwards,
                realformer_attention_tf32x3=cfg.n_layers
                * (forwards - bf16_forwards),
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
    from mmvqa_tpu_torch.parallel.world import counters

    return counters()


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


def checked_train_step(torch, model, cfg, batch, draws, make_steps=None,
                       leaves=CHECK_LEAVES, stats=CHECK_STATS):
    """One train step through ``make_steps`` (``make_mlm_steps`` where None)
    with hooks that keep the logits (the first output of a SupCon model),
    the gradients of ``leaves`` and the running statistics ``stats``."""
    from mmvqa_tpu_torch.train.state import create_train_state
    from mmvqa_tpu_torch.train.steps import make_mlm_steps

    kept = {}
    params = dict(model.named_parameters())
    hooks = [params[name].register_hook(
        lambda g, name=name: kept.__setitem__(name, g.detach().clone()))
        for name in leaves]
    hooks.append(model.register_forward_hook(
        lambda _m, _a, out: kept.__setitem__(
            "logits", (out[0] if isinstance(out, tuple) else out).detach())))
    try:
        train_step, _ = (make_steps or make_mlm_steps)(model, cfg)
        state, metrics = train_step(create_train_state(model, cfg.lr), batch,
                                    draws=draws)
    finally:
        for h in hooks:
            h.remove()
    kept["loss"] = metrics["loss"]
    sd = model.state_dict()
    kept.update({name: sd[name].clone() for name in stats})
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

    compare_fp32_step(torch, "train fp32", got, want)


def compare_fp32_step(torch, label, got, want, leaves=CHECK_LEAVES,
                      stats=CHECK_STATS, allow=None) -> None:
    """A train step's kept values on the card against the CPU plain path:
    the loss to 1e-4 relative, the logits as TOL_SLICE, the gradient
    ``leaves`` and the statistics ``stats`` to GRAD_NORMWISE of their
    largest entry, plus ``allow[name]`` where given (an absolute term for a
    leaf whose own conditioning is coarser, ``default_train_check_fp32``)."""
    allow = allow or {}
    loss_err = abs(got["loss"].item() - want["loss"].item())
    if not loss_err <= 1e-4 * abs(want["loss"].item()):
        fail(f"{label} loss: card {got['loss'].item():.6f}, CPU "
             f"{want['loss'].item():.6f}")
    err = close(f"{label} logits vs CPU", got["logits"].cpu(),
                want["logits"], TOL_SLICE)
    print(f"{label} check: loss card {got['loss'].item():.6f} CPU "
          f"{want['loss'].item():.6f} (err {loss_err:.3e}); logits "
          f"max_abs_err {err:.3e}")
    for name in list(leaves) + list(stats):
        g, w = got[name].cpu().float(), want[name].float()
        if not torch.isfinite(g).all():
            fail(f"{label} {name}: non-finite output")
        e = (g - w).abs().max().item()
        scale = w.abs().max().item()
        lim = GRAD_NORMWISE * scale + allow.get(name, 0.0)
        if e > lim:
            fail(f"{label} {name}: max abs err {e:.3e} beyond {lim:.3e} "
                 f"({GRAD_NORMWISE} x {scale:.3e}"
                 f"{f' + {allow[name]:.3e}' if name in allow else ''})")
        kind = "stat" if name in stats else "grad"
        extra = (f" (allowed {GRAD_NORMWISE} x max + {allow[name]:.3e})"
                 if name in allow else "")
        print(f"{label} check: {kind} {name}: max_abs_err {e:.3e} of "
              f"max {scale:.3e}{extra}")


def train_breakdown(torch, model, cfg, state, batch, n: int) -> None:
    """(d) where a train step's time goes: the step's own phases written out
    (augment, forward, backward, optimizer) between CUDA events with a
    synchronise after each, then ``n`` whole steps under torch.profiler for
    the four kernels and the device's busy share."""
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
    traced_train_steps(torch, lambda: train_step(state, batch), n,
                       f"train bf16 B={TRAIN_B}")


def fp32_step_trace(torch, n: int = 3, default: bool = False) -> float:
    """(e) the CLIs' fp32 step: the flagship MLM model (``default``: the
    default model, ResNet-152 and the pre-norm BERT encoder) in fp32 at
    their batch (CLI_B), one synthetic batch. Five steps on the host clock,
    each ending in a synchronise, with every counter at its exact count (K4,
    K1 and, in the flagship, K2, both ways, on their split-TF32 kernels);
    then ``n`` steps under
    torch.profiler, as the bf16 steps are traced: the card's busy time and
    the kernels by name. Returns the busy ms a step."""
    from mmvqa_tpu_torch.core.config import pretrain_config
    from mmvqa_tpu_torch.data.synthetic import mlm_batches
    from mmvqa_tpu_torch.models import MMBert
    from mmvqa_tpu_torch.models.mmbert import compute_dtype_of
    from mmvqa_tpu_torch.train.state import create_train_state
    from mmvqa_tpu_torch.train.steps import make_mlm_steps

    make_cfg = pretrain_config if default else flagship_mlm_config
    cfg = make_cfg(batch_size=CLI_B, lr=TRAIN_LR, seed=SEED)
    model = MMBert(cfg, compute_dtype=compute_dtype_of(cfg),
                   generator=torch.Generator().manual_seed(SEED))
    state = [create_train_state(model, cfg.lr, clip=cfg.clip)]
    train_step, _ = make_mlm_steps(model, cfg)
    batch = mlm_batches(cfg, 1, SEED)[0]
    label = f"{'default ' if default else ''}train fp32 B={CLI_B}"

    def run_step():
        state[0], m = train_step(state[0], batch)
        return m

    times, losses = [], []
    reset_counts()
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(run_step()["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    check_launches(label, read_counts(), (default_launches if default else
                                          expected_launches)(5, 0, False))
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: non-finite loss {losses}")
    print(f"{label}: ms per step {['%.1f' % t for t in times]} (median after "
          f"the first {statistics.median(times[1:]):.2f}); losses "
          f"{['%.4f' % x for x in losses]}; every K4, K1 and K2 launch on "
          f"its split-TF32 kernel")
    busy = traced_train_steps(torch, run_step, n, label, bf16=False)
    del model, state
    torch.cuda.empty_cache()
    return busy


def traced_train_steps(torch, run_step, n: int, label: str,
                       bf16: bool = True) -> float:
    """``n`` calls of ``run_step`` (one train step) under torch.profiler:
    the device's busy share, the eight kernels and what is left of the
    library's batch-norm and depthwise kernels. Fails on a library
    batch-norm kernel, a second pass of the token head, the depthwise
    backward, conv1x1 + statistics or the BN-backward sums, an attention
    kernel other than the tensor-core ones, a token-head forward kernel
    other than its dtype's (``check_token_head_forward``), and a trace
    without device time (``profiled``). An fp32 step (``bf16`` False) fails
    where conv1x1 + statistics, the token head or the attention, either way,
    runs any kernel other than its split-TF32 one. Returns the busy ms per
    step."""
    _, wall, kernels = profiled(
        torch, lambda: [run_step() for _ in range(n)], n, label)
    busy = sum(a.self_device_time_total for a in kernels) / 1e3
    print(f"{label}: traced {n} steps, wall {wall / n:.2f} "
          f"ms/step, device busy {busy / n:.2f} ms/step "
          f"({100 * busy / wall:.1f}%)")
    ours = ("token_head_fwd_mma", "token_head_fwd_tf32x3",
            "token_head_bwd", "token_head_bwd_rows", "token_head_bwd_tiles",
            "realformer_attn_fwd", "realformer_attn_fwd_mma",
            "realformer_attn_fwd_tf32x3",
            "realformer_attn_bwd", "realformer_attn_bwd_mma",
            "realformer_attn_bwd_tf32x3",
            "depthwise3x3_fwd", "depthwise3x3_bwd",
            "conv1x1_stats_tma", "conv1x1_stats_bf16",
            "conv1x1_stats_tf32x3", "conv1x1_stats_reduce",
            "bn_backward_sums_kernel", "bn_backward_sums_reduce")

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
        fail(f"{label}: a library batch-norm kernel ran in the train step: "
             + ", ".join(a.key[:60] for a in bn))
    # the depthwise backward and the token head, both ways, conv1x1 +
    # statistics and the BN-backward sums add their partials themselves
    second = [a.key for a in mine if "reduce" in a.key and any(
        t in a.key for t in ("depthwise", "token_head", "conv1x1",
                             "bn_backward_sums"))
              or "token_head_finalize" in a.key]
    if second:
        fail(f"{label}: a second pass of the depthwise backward, the token "
             f"head, conv1x1 + statistics or the BN-backward sums ran in the "
             f"train step: {second}")
    # the attention runs on its tensor-core kernels alone, both ways: bf16
    # products, or fp32 as split TF32
    check_token_head_forward(mine, label, bf16)
    for way in ("fwd", "bwd"):
        want = f"realformer_attn_{way}_{'mma' if bf16 else 'tf32x3'}"
        other = [a.key for a in mine if f"realformer_attn_{way}" in a.key
                 and want not in a.key]
        if other:
            fail(f"{label}: an attention {way} kernel other than {want} ran "
                 f"in the train step: {other}")
    if not bf16:
        other = [a.key for a in mine if ("conv1x1" in a.key
                                         and "tf32x3" not in a.key)
                 or ("token_head_bwd" in a.key and "_rows_" not in a.key
                     and "_tiles_" not in a.key)]
        if other:
            fail(f"{label}: conv1x1 + statistics or the token head's "
                 f"backward ran off its split-TF32 kernel: {other}")
    for a in kernels[:14]:
        print(f"  {a.self_device_time_total / 1e3 / n:9.4f} ms/step "
              f"{a.count // n:5d} calls  {a.key[:80]}")
    return busy / n


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
                "realformer_attention_mma": cfg.n_layers,
                "realformer_attention_tf32x3": 0,
                "realformer_attention_bwd": cfg.n_layers,
                "realformer_attention_bwd_mma": cfg.n_layers,
                "realformer_attention_bwd_tf32x3": 0,
                "depthwise3x3": 42, "depthwise3x3_bwd": 42,
                "conv1x1_stats": 98, "conv1x1_stats_tma": 98,
                "token_head_tf32x3": 0, "token_head_bwd_tf32x3": 0,
                "conv1x1_stats_tf32x3": 0,
                "bn_backward_sums": 156}
    want = {name: n * TRAIN_STEPS for name, n in per_step.items()}
    other = launches["conv1x1_stats"] - launches["conv1x1_stats_tma"]
    if other:
        fail(f"train: {other} conv1x1 + statistics launches took the "
             f"mma.sync path")
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
    del model, state
    torch.cuda.empty_cache()
    fp32_step_trace(torch)
    return launches

def flagship_vqa_config(**over):
    from mmvqa_tpu_torch.core.config import vqa_config

    return vqa_config(cnn_encoder="tf_efficientnetv2_m",
                      transformer_model="realformer", num_classes=NUM_CLASSES,
                      **over)


def finetune_check_fp32(torch) -> None:
    """(a) one fp32 VQA train step, card against the CPU plain path, under
    each criterion: cross entropy, ASL, the category-smoothing table."""
    import copy

    from mmvqa_tpu_torch.data.images import FINETUNE_AUG, sample_draws
    from mmvqa_tpu_torch.data.synthetic import (
        CATS2ANS,
        smoothing_columns,
        vqa_batches,
    )
    from mmvqa_tpu_torch.models import MMBert
    from mmvqa_tpu_torch.train.category_smoothing import (
        build_category_smoothing_table,
    )
    from mmvqa_tpu_torch.train.steps import make_vqa_steps

    cfg0 = flagship_vqa_config(batch_size=CHECK_B, dropout_override=0.0)
    batches = vqa_batches(cfg0, 1, NUM_CLASSES, SEED)
    table = build_category_smoothing_table(
        *smoothing_columns(batches), NUM_CLASSES, CATS2ANS, FT_SMOOTHING)
    draws = sample_draws(CHECK_B, cfg0.image_size,
                         torch.Generator().manual_seed(SEED), FINETUNE_AUG)
    base = MMBert(cfg0, device="cpu",
                  generator=torch.Generator().manual_seed(SEED))
    for label, over, tab in (
            ("CE", {}, None),
            ("ASL", dict(loss="ASLSingleLabel"), None),
            ("category smoothing", dict(smoothing=FT_SMOOTHING), table)):
        cfg = cfg0.replace(**over)

        def make_steps(m, c, tab=tab):
            return make_vqa_steps(m, c, category_smoothing_table=tab)

        t0 = time.perf_counter()
        want = checked_train_step(torch, copy.deepcopy(base), cfg,
                                  batches[0], draws, make_steps)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        got = checked_train_step(torch, copy.deepcopy(base).to("cuda"), cfg,
                                 batches[0], draws, make_steps)
        torch.cuda.synchronize()
        print(f"finetune fp32 {label}: CPU reference step (plain path, "
              f"B={CHECK_B}) {cpu_ms:.0f} ms")
        compare_fp32_step(torch, f"finetune fp32 {label}", got, want)
    del base


def transfer(torch, ckpt_dir: str):
    """(b) pretrained MLM weights -> save_weights -> load_weights ->
    filtered_restore into the bf16 VQA model, which is returned. Exactly
    the tensors whose shape differs stay as the VQA model drew them."""
    from mmvqa_tpu_torch.models import MMBert
    from mmvqa_tpu_torch.models.mmbert import compute_dtype_of
    from mmvqa_tpu_torch.train import checkpoint
    from mmvqa_tpu_torch.train.state import create_train_state

    mcfg = flagship_mlm_config(seed=SEED)
    mlm = MMBert(mcfg, device="cpu",
                 generator=torch.Generator().manual_seed(SEED))
    path = os.path.join(ckpt_dir, "roco", "best")
    t0 = time.perf_counter()
    checkpoint.save_weights(path, create_train_state(mlm, mcfg.lr))
    save_s = time.perf_counter() - t0
    del mlm
    cfg = flagship_vqa_config(mixed_precision=True, seed=SEED)
    # another seed than the MLM model's, so that a transferred tensor shows
    model = MMBert(cfg, compute_dtype=compute_dtype_of(cfg),
                   generator=torch.Generator().manual_seed(SEED + 1))
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    loaded = checkpoint.load_weights(path)
    merged, n_ok, n_all = checkpoint.filtered_restore(model.state_dict(),
                                                      loaded)
    model.load_state_dict(merged, strict=True)
    load_s = time.perf_counter() - t0
    print(f"transfer: MLM weights ({len(loaded)} tensors, "
          f"{os.path.getsize(path) / 2**20:.1f} MiB) saved in {save_s:.2f} "
          f"s; loaded and filtered into the VQA model in {load_s:.2f} s: "
          f"{n_ok} / {n_all} tensors transferred")
    kept = sorted(k for k in fresh if k not in loaded
                  or loaded[k].shape != fresh[k].shape)
    if kept != ["classifier_2.bias", "classifier_2.weight"] or (
            n_ok != n_all - len(kept)):
        fail(f"transfer: the VQA model kept {kept} fresh ({n_ok} / {n_all} "
             f"loaded); want exactly classifier_2")
    sd = model.state_dict()
    for k, v in sd.items():
        want = fresh[k] if k in kept else loaded[k]
        if not torch.equal(v.cpu(), want.cpu()):
            fail(f"transfer: {k} is neither its saved nor its fresh value")
    moved = sum(not torch.equal(fresh[k], sd[k]) for k in sd)
    print(f"transfer: fresh: {kept}; {moved} tensors differ from the VQA "
          f"model's own draw; the position table "
          f"{tuple(sd['bert_embedding.position_embeddings'].shape)} keeps "
          f"BERT's 512 rows in both models, so the shape filter takes it")
    return model, cfg


def finetune_phase(torch):
    """(b), (c), (d): the VQA-Med fine-tuning path; returns the launches of
    its main path (the fine-tune epoch)."""
    import shutil

    import numpy as np

    from mmvqa_tpu_torch.data.synthetic import vqa_batches
    from mmvqa_tpu_torch.train import checkpoint
    from mmvqa_tpu_torch.train.plateau import ReduceLROnPlateau
    from mmvqa_tpu_torch.train.state import create_train_state
    from mmvqa_tpu_torch.train.steps import make_vqa_steps
    from mmvqa_tpu_torch.train.trainer import vqa_epoch

    finetune_check_fp32(torch)
    torch.cuda.empty_cache()
    ckpt_dir = os.path.join(ROOT, "_checkpoints")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        model, cfg = transfer(torch, ckpt_dir)
        if cfg.batch_size != EVAL_B:  # the trunk kernels were checked there
            fail(f"finetune: B={cfg.batch_size}, the kernels were held at "
                 f"B={EVAL_B}")
        n_params = sum(p.numel() for p in model.parameters())
        print(f"finetune: MMBert VQA {cfg.cnn_encoder} + "
              f"{cfg.transformer_model}, hidden {cfg.hidden_size}, "
              f"{cfg.n_layers} layers, T={cfg.max_position_embeddings}, "
              f"{cfg.image_size} px, {NUM_CLASSES} classes, "
              f"{n_params / 1e6:.2f} M fp32 parameters, compute "
              f"{model.dtype}, B={cfg.batch_size}, lr {cfg.lr}, dropout on, "
              f"on {model.device}")
        state = create_train_state(model, cfg.lr, clip=cfg.clip,
                                   grad_accum=cfg.grad_accum)
        train_step, eval_step = make_vqa_steps(model, cfg)
        batch = vqa_batches(cfg, 1, NUM_CLASSES, SEED)[0]
        losses = []

        def recorded(state, batch):
            state, m = train_step(state, batch)
            losses.append(m["loss"])
            return state, m

        torch.cuda.reset_peak_memory_stats()
        state, _ = vqa_epoch(recorded, state, [batch], True)
        # the main path, undisturbed: one epoch through vqa_epoch, counters
        # read around it
        reset_counts()
        state, second = vqa_epoch(recorded, state, [batch] * FT_STEPS, True)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**20
        losses = [x.item() for x in losses]
        print(f"finetune bf16 B={cfg.batch_size}: vqa_epoch of {FT_STEPS} "
              f"steps after one: loss {second['loss']:.4f}, "
              f"{second['items_per_sec']:.1f} items/s; peak memory "
              f"{peak:.1f} MiB; losses {['%.4f' % x for x in losses]}; "
              f"launches {launches}")
        per_step = {"token_head": 5, "token_head_bwd": 5,
                    "realformer_attention": cfg.n_layers,
                    "realformer_attention_mma": cfg.n_layers,
                    "realformer_attention_tf32x3": 0,
                    "realformer_attention_bwd": cfg.n_layers,
                    "realformer_attention_bwd_mma": cfg.n_layers,
                    "realformer_attention_bwd_tf32x3": 0,
                    "depthwise3x3": 42, "depthwise3x3_bwd": 42,
                    "conv1x1_stats": 98, "conv1x1_stats_tma": 98,
                    "token_head_tf32x3": 0, "token_head_bwd_tf32x3": 0,
                    "conv1x1_stats_tf32x3": 0,
                    "bn_backward_sums": 156}
        want = {name: n * FT_STEPS for name, n in per_step.items()}
        other = launches["conv1x1_stats"] - launches["conv1x1_stats_tma"]
        if other:
            fail(f"finetune: {other} conv1x1 + statistics launches took the "
                 f"mma.sync path")
        if launches != want:
            fail(f"finetune launches {launches}, want {want}")
        if not all(math.isfinite(x) for x in losses):
            fail(f"finetune: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            fail(f"finetune: loss did not fall on a repeated batch: {losses}")
        if len(second["preds"]) != FT_STEPS * cfg.batch_size:
            fail(f"finetune: {len(second['preds'])} predictions")

        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        step_ms = statistics.median(times)
        label = f"finetune bf16 B={cfg.batch_size}"
        busy = traced_train_steps(torch, lambda: train_step(state, batch), 3,
                                  label)
        print(f"{label}: ms per step {['%.2f' % t for t in times]} (median "
              f"{step_ms:.2f}, {cfg.batch_size / step_ms * 1e3:.1f} items/s), "
              f"device busy {busy:.2f} ms a step")
        copies = gradient_copies()
        if any(copies.values()):
            fail(f"finetune: a gradient reached a kernel site in another "
                 f"layout than its map and was copied: {copies}")

        # validation, the plateau scheduler, the best weights, the recorder
        val = vqa_batches(cfg, FT_VAL_BATCHES, NUM_CLASSES, SEED + 1,
                          PAD_LAST)
        _, vm = vqa_epoch(eval_step, state, val, False, collect_logits=True)
        n_real = FT_VAL_BATCHES * cfg.batch_size - PAD_LAST
        if not (math.isfinite(vm["loss"]) and len(vm["preds"]) == n_real
                and vm["logits"].shape == (n_real, NUM_CLASSES)
                and np.isfinite(vm["logits"]).all()):
            fail(f"finetune: validation {vm['loss']}, "
                 f"{len(vm['preds'])} predictions")
        acc = 100.0 * float((vm["preds"] == vm["targets"]).mean())
        sched = ReduceLROnPlateau(lr=cfg.lr, patience=cfg.patience,
                                  factor=cfg.factor)
        state.with_lr(sched.step(vm["loss"]))
        checkpoint.save_weights(
            os.path.join(ckpt_dir, cfg.task, cfg.run_name + "_loss"), state)
        if acc > 0.0:
            checkpoint.save_weights(
                os.path.join(ckpt_dir, cfg.task, cfg.run_name), state)
        t0 = time.perf_counter()
        checkpoint.save_recorder(ckpt_dir, 1, state, sched.state_dict())
        at = state.step
        state, sched_state, epoch = checkpoint.restore_recorder(ckpt_dir,
                                                                state)
        rec_s = time.perf_counter() - t0
        state, m = train_step(state, batch)
        if not (epoch == 1 and sched_state == sched.state_dict()
                and state.step == at + 1 and math.isfinite(m["loss"].item())):
            fail(f"finetune: recorder round trip: epoch {epoch}, step "
                 f"{state.step}, loss {m['loss'].item()}")
        print(f"finetune: validation over {n_real} samples: loss "
              f"{vm['loss']:.4f}, accuracy {acc:.2f}%, lr {state.lr}; "
              f"recorder saved and restored in {rec_s:.2f} s, the next "
              f"step's loss {m['loss'].item():.4f}")
        del model, state, train_step, eval_step
        torch.cuda.empty_cache()
        accumulate_and_resume(torch, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return launches


def accumulate_and_resume(torch, ckpt_dir: str) -> None:
    """(d) grad_accum=2 in fp32: micro-step 1 leaves the parameters,
    micro-step 2 is Adam on the mean of the two micro-gradients, and a run
    resumed from a recorder taken between them lands where the run that
    never stopped does. cuDNN is held to deterministic algorithms for this
    check alone: its convolutions' weight gradients may otherwise sum in
    another order on each run."""
    from mmvqa_tpu_torch.data.images import FINETUNE_AUG, sample_draws
    from mmvqa_tpu_torch.data.synthetic import vqa_batches
    from mmvqa_tpu_torch.models import MMBert
    from mmvqa_tpu_torch.train import checkpoint
    from mmvqa_tpu_torch.train.state import create_train_state
    from mmvqa_tpu_torch.train.steps import make_vqa_steps

    cfg = flagship_vqa_config(batch_size=CHECK_B, dropout_override=0.0,
                              grad_accum=2, seed=SEED)
    b1, b2 = vqa_batches(cfg, 2, NUM_CLASSES, SEED + 2)
    gen = torch.Generator().manual_seed(SEED)
    d1, d2 = (sample_draws(CHECK_B, cfg.image_size, gen, FINETUNE_AUG)
              for _ in range(2))
    rec_dir = os.path.join(ckpt_dir, "accumulate")

    def fresh():
        model = MMBert(cfg, generator=torch.Generator().manual_seed(SEED))
        state = create_train_state(model, cfg.lr, grad_accum=cfg.grad_accum)
        return state, make_vqa_steps(model, cfg)[0]

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        state, step = fresh()
        params = dict(state.model.named_parameters())
        p0 = {n: p.detach().clone() for n, p in params.items()}
        grads = []
        apply = state.apply_gradients

        def keep_grads():
            grads.append({n: (torch.zeros_like(p) if p.grad is None
                              else p.grad.detach().clone())
                          for n, p in params.items()})
            apply()

        state.apply_gradients = keep_grads
        state, _ = step(state, b1, draws=d1)
        still = all(torch.equal(p, p0[n]) for n, p in params.items())
        checkpoint.save_recorder(rec_dir, 0, state, {})
        state, _ = step(state, b2, draws=d2)
        del state.apply_gradients
        ref = {n: p.clone() for n, p in p0.items()}
        adam = torch.optim.Adam(ref.values(), lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=0.0)
        for n, r in ref.items():
            g1, g2 = grads[0][n], grads[1][n]
            r.grad = g1 + (g2 - g1) / 2.0
        adam.step()
        err_mean = max((params[n] - r).abs().max().item()
                       for n, r in ref.items())
        off_mean = [n for n, r in ref.items() if not torch.allclose(
            params[n], r, rtol=1e-6, atol=1e-7)]
        moved = sum(not torch.equal(params[n], p0[n]) for n in params)
        del ref, adam, grads, p0

        resumed, rstep = fresh()
        resumed, _, _ = checkpoint.restore_recorder(rec_dir, resumed)
        mini = resumed.mini_step
        resumed, _ = rstep(resumed, b2, draws=d2)
        rparams = dict(resumed.model.named_parameters())
        err_resume = max((rparams[n] - p).abs().max().item()
                         for n, p in params.items())
        off_resume = [n for n, p in params.items() if not torch.allclose(
            rparams[n], p, rtol=1e-6, atol=1e-7)]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"accumulate fp32 B={CHECK_B}, grad_accum 2: micro-step 1 left "
          f"the parameters {'unchanged' if still else 'CHANGED'}; "
          f"micro-step 2 moved {moved} of {len(params)} tensors, max abs err "
          f"against Adam on the mean gradient {err_mean:.3e}; resumed from "
          f"the recorder at micro-step {mini}: max abs err against the run "
          f"that never stopped {err_resume:.3e} (rtol 1e-6, atol 1e-7)")
    if not still:
        fail("accumulate: micro-step 1 changed the parameters")
    if off_mean or moved == 0:
        fail(f"accumulate: micro-step 2 is not Adam on the mean gradient: "
             f"{off_mean[:5]} ({moved} tensors moved)")
    if mini != 1 or off_resume:
        fail(f"accumulate: the resumed run (micro-step {mini}) differs: "
             f"{off_resume[:5]}")



class TimedLoader:
    """Iterates a loader and adds up the time the loop waited for each
    batch (``next`` on the loader's iterator)."""

    def __init__(self, loader, waits: list):
        self.loader, self.waits = loader, waits

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.waits.append(time.perf_counter() - t0)
            yield batch


class TimedTrainEpochs:
    """Within ``with``, ``module.<name>`` (an epoch loop that takes the loader
    third and, but for ``supcon_epoch``, ``train`` fourth) times each train
    epoch's waits on its loader: ``epochs`` gets (wait share, batches, wall
    s) a train epoch."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.epochs: list = []

    def __enter__(self):
        def timed(step_fn, state, loader, *args, **kw):
            train = (self.name == "supcon_epoch"
                     or (args[0] if args else kw.get("train")))
            if not train:
                return self.real(step_fn, state, loader, *args, **kw)
            waits: list = []
            t0 = time.perf_counter()
            out = self.real(step_fn, state, TimedLoader(loader, waits), *args,
                            **kw)
            wall = time.perf_counter() - t0
            self.epochs.append((sum(waits) / wall, len(waits), wall))
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


class TF32Off:
    """Turns PyTorch's two TF32 flags on before a CLI's ``main`` runs and
    fails unless both are off when it returns: the CLIs turn them off
    themselves (``cli/common.py::setup_runtime``), whatever the process had,
    so that their fp32 is fp32 (cuDNN's convolutions run TF32 by default).
    Leaves them off, as the rest of the smoke runs."""

    def __init__(self, torch, label: str):
        self.flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
        self.label = label

    def __enter__(self):
        for f in self.flags:
            f.allow_tf32 = True
        return self

    def __exit__(self, kind, *_):
        on = [f.allow_tf32 for f in self.flags]
        for f in self.flags:
            f.allow_tf32 = False
        if kind is None and any(on):
            fail(f"{self.label}: TF32 still on after main (matmul, cudnn: "
                 f"{on}); the CLI must turn it off itself")


class Tee:
    """Within ``with``, standard output goes on to the terminal and is kept
    in ``text``."""

    def __enter__(self):
        import io

        self.buf, self.out = io.StringIO(), sys.stdout
        sys.stdout = self
        return self

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def __exit__(self, *exc):
        sys.stdout = self.out
        return False

    @property
    def text(self) -> str:
        return self.buf.getvalue()


def expected_launches(train: int, forwards: int, bf16: bool) -> dict:
    """Each counter after ``train`` train steps (forward and backward, the
    trunk on batch statistics) and ``forwards`` eval forwards of the
    flagship model; in bf16 every attention call takes the tensor-core
    kernels and every conv1x1 + statistics call its TMA path, in fp32 every
    conv1x1 + statistics call, every token-head forward and backward and
    every attention call its split-TF32 kernel."""
    f = train + forwards
    return {"token_head": 5 * f, "token_head_tf32x3": 0 if bf16 else 5 * f,
            "token_head_bwd": 5 * train,
            "token_head_bwd_tf32x3": 0 if bf16 else 5 * train,
            "realformer_attention": 4 * f,
            "realformer_attention_mma": 4 * f if bf16 else 0,
            "realformer_attention_tf32x3": 0 if bf16 else 4 * f,
            "realformer_attention_bwd": 4 * train,
            "realformer_attention_bwd_mma": 4 * train if bf16 else 0,
            "realformer_attention_bwd_tf32x3": 0 if bf16 else 4 * train,
            "depthwise3x3": 42 * f, "depthwise3x3_bwd": 42 * train,
            "conv1x1_stats": 98 * train,
            "conv1x1_stats_tma": 98 * train if bf16 else 0,
            "conv1x1_stats_tf32x3": 0 if bf16 else 98 * train,
            "bn_backward_sums": 156 * train}


def check_launches(label: str, got: dict, want: dict) -> None:
    if got != want:
        fail(f"{label}: launches {got}, want {want}")


def metric_lines(save: str, run: str) -> list:
    with open(os.path.join(save, f"{run}_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def add_counts(total: dict, got: dict) -> None:
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def cli_phase(torch, work: str):
    """(6) ROCO pretraining from disk through ``roco_train.main``: a JPEG
    fixture written by the port into ``work``, the decoder held to its
    pinned digest, the host's decode + resize rate on one thread, then the
    full-width flagship for two epochs in bf16 (``--mixed_precision``) and
    one in fp32 (the CLI's default). Per run: the launch counters set to 0
    before and read after (every one of the eight kernels must move, at the
    exact count of its train steps and eval forwards), finite losses, the
    weights file and the metric lines, train items/s and the share of each
    train epoch the loop waited on the loader; both TF32 flags turned on
    before ``main`` and off after it (``TF32Off``). The fixture and the bf16
    run's weights stay in ``work`` for the drivers phase. Returns the
    launches of both runs."""
    from mmvqa_tpu_torch.cli import roco_train
    from mmvqa_tpu_torch.data.fixtures import make_roco_fixture
    from mmvqa_tpu_torch.data.images import load_image

    t0 = time.perf_counter()
    data = make_roco_fixture(os.path.join(work, "roco"), CLI_TRAIN, CLI_VAL,
                             SEED, CLI_IMAGE_SIZE)
    print(f"cli: ROCO fixture of {CLI_TRAIN} + {CLI_VAL} JPEGs at "
          f"{CLI_IMAGE_SIZE[0]}x{CLI_IMAGE_SIZE[1]} px written by the "
          f"port in {time.perf_counter() - t0:.1f} s")
    digest = decode_digest(data)
    if digest != DECODE_DIGEST:
        fail(f"cli: decoded pixels' digest {digest}, pinned "
             f"{DECODE_DIGEST}")
    print("cli: decoded pixels match the pinned digest")
    paths = [os.path.join(data, "train", "radiology", "images",
                          f"ROCO_train_{i:04d}.jpg") for i in range(16)]
    load_image(paths[0], 224)
    t0 = time.perf_counter()
    for p in paths:
        load_image(p, 224)
    rate = len(paths) / (time.perf_counter() - t0)
    print(f"cli: host decode + resize to 224 px, one thread: "
          f"{rate:.1f} images/s; host CPUs {os.cpu_count()}")

    steps = -(-CLI_TRAIN // CLI_B)
    evals = -(-CLI_VAL // CLI_B)
    launches: dict = {}
    for label, extra, n_epochs in (("bf16", ["--mixed_precision"], 2),
                                   ("fp32", [], 1)):
        save = os.path.join(work, label)
        reset_counts()
        t0 = time.perf_counter()
        with TF32Off(torch, f"cli {label}"), TimedTrainEpochs(
                roco_train, "mlm_epoch") as timer:
            roco_train.main(["-r", f"cli_{label}", "--data_dir", data,
                             "--save_dir", save, "--epochs", str(n_epochs),
                             *CLI_ARGS, *extra])
        wall = time.perf_counter() - t0
        got = read_counts()
        tr, ev = steps * n_epochs, evals * n_epochs
        print(f"cli {label}: roco_train.main, {n_epochs} epochs of {steps} "
              f"train steps and {evals} validation batches at B={CLI_B}, "
              f"{wall:.1f} s; launches {got}")
        check_launches(f"cli {label}", got,
                       expected_launches(tr, ev, label == "bf16"))
        lines = metric_lines(save, f"cli_{label}")
        if len(lines) != n_epochs or not os.path.exists(
                os.path.join(save, "MLM", f"cli_{label}")):
            fail(f"cli {label}: {len(lines)} metric lines, weights "
                 f"{os.listdir(os.path.join(save, 'MLM'))}")
        for line, (share, n, ep_wall) in zip(lines, timer.epochs):
            if not all(math.isfinite(line[k]) for k in (
                    "epoch_train_loss", "epoch_val_loss",
                    "train_items_per_sec")):
                fail(f"cli {label}: non-finite metric in {line}")
            print(f"cli {label} epoch {line['epoch']}: train loss "
                  f"{line['epoch_train_loss']:.4f}, val loss "
                  f"{line['epoch_val_loss']:.4f}, "
                  f"{line['train_items_per_sec']:.1f} train items/s, "
                  f"waited on the loader {100 * share:.1f}% of the "
                  f"train epoch ({n} batches, {ep_wall:.2f} s)")
        add_counts(launches, got)
        torch.cuda.empty_cache()
    return launches


# leaves of the SupCon check: CHECK_LEAVES and the projection head
SUPCON_LEAVES = CHECK_LEAVES + ["head_0.weight", "head_2.weight"]


def supcon_check_fp32(torch) -> None:
    """(7b) one fp32 SupCon train step at B=CHECK_B (CHECK_B // 2 pairs of
    views) with the Jaccard mask of synthetic captions, card against the
    CPU plain path, held as the MLM step is, the projection head's
    gradients among the leaves."""
    import copy

    import numpy as np

    from mmvqa_tpu_torch.core.config import supcon_config
    from mmvqa_tpu_torch.data.fixtures import WORDS
    from mmvqa_tpu_torch.data.images import PRETRAIN_AUG, sample_draws
    from mmvqa_tpu_torch.data.synthetic import mlm_batches
    from mmvqa_tpu_torch.models import MMBert
    from mmvqa_tpu_torch.similarity import SimilarityCalculator
    from mmvqa_tpu_torch.train.steps import make_supcon_steps

    pairs = CHECK_B // 2
    cfg = supcon_config(cnn_encoder="tf_efficientnetv2_m",
                        transformer_model="realformer", batch_size=pairs,
                        dropout_override=0.0)
    b0, b1 = mlm_batches(cfg, 2, SEED)
    batch = dict(b0, aug_tokens=(b1["tokens"] * b0["input_mask"]).astype(
        np.int32), aug_labels=(b1["labels"] * b0["input_mask"]).astype(
        np.int32))
    rng = np.random.default_rng(SEED)
    caps = [" ".join(rng.choice(WORDS, 8)) for _ in range(2 * pairs)]
    sim = SimilarityCalculator("jaccard")(caps[:pairs], caps[pairs:])
    gen = torch.Generator().manual_seed(SEED)
    draws = tuple(sample_draws(pairs, cfg.image_size, gen, PRETRAIN_AUG)
                  for _ in range(2))

    def make_steps(model, c):
        step, evaluate = make_supcon_steps(model, c)
        return (lambda state, b, draws: step(state, b, draws, sim_mask=sim),
                evaluate)

    cpu_model = MMBert(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(SEED))
    card_model = copy.deepcopy(cpu_model).to("cuda")
    t0 = time.perf_counter()
    want = checked_train_step(torch, cpu_model, cfg, batch, draws, make_steps,
                              SUPCON_LEAVES)
    print(f"drivers supcon fp32 check: CPU reference step (plain path, "
          f"{pairs} pairs, Jaccard mask with off-diagonal mean "
          f"{(sim.sum() - pairs) / (pairs * pairs - pairs):.3f}) "
          f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
    del cpu_model
    got = checked_train_step(torch, card_model, cfg, batch, draws, make_steps,
                             SUPCON_LEAVES)
    torch.cuda.synchronize()
    del card_model
    compare_fp32_step(torch, "drivers supcon fp32", got, want, SUPCON_LEAVES)


def print_epochs(label: str, lines: list, epochs: list, loss_key: str) -> None:
    for i, (line, (share, n, wall)) in enumerate(zip(lines, epochs)):
        print(f"{label} epoch {i}: train loss "
              f"{line[loss_key]:.4f}, {line['train_items_per_sec']:.1f} train "
              f"items/s, waited on the loader {100 * share:.1f}% of the train "
              f"epoch ({n} batches, {wall:.2f} s)")


def drivers_phase(torch, work: str) -> dict:
    """(7) The remaining drivers from disk at full width: SupCon
    pretraining on the CLI phase's ROCO fixture, the fp32 SupCon step card
    vs CPU, fine-tuning from the CLI phase's bf16 weights on a VQA fixture
    the port writes, and evaluation (one model and an ensemble of two).
    Every run has each counter at its exact count and turns TF32 off itself
    (``TF32Off``); returns the launches of all the runs."""
    from mmvqa_tpu_torch.cli import roco_supcon_train, vqa_eval, vqa_train
    from mmvqa_tpu_torch.data.fixtures import make_vqa_fixture
    from mmvqa_tpu_torch.train import checkpoint

    roco = os.path.join(work, "roco")
    vocab = os.path.join(roco, "vocab.txt")
    launches: dict = {}

    # (a) SupCon pretraining: the loader at B // 2, two views a sample
    steps = -(-CLI_TRAIN // (CLI_B // 2))
    evals = -(-CLI_VAL // CLI_B)
    for label, extra, n_epochs in (
            ("bf16", ["--mixed_precision", "--use_sim_mask"], 1),
            ("fp32", [], 1)):
        run = f"supcon_{label}"
        save = os.path.join(work, run)
        reset_counts()
        t0 = time.perf_counter()
        with TF32Off(torch, f"drivers {run}"), TimedTrainEpochs(
                roco_supcon_train, "supcon_epoch") as timer:
            roco_supcon_train.main([
                "-r", run, "--data_dir", roco, "--save_dir", save,
                "--epochs", str(n_epochs), "--con_task", "supcon",
                "--similarity", "jaccard", *CLI_ARGS, *extra])
        wall = time.perf_counter() - t0
        got = read_counts()
        print(f"drivers {run}: roco_supcon_train.main {' '.join(extra)}, "
              f"{n_epochs} epochs of {steps} train steps ({CLI_B // 2} pairs "
              f"of views) and {evals} validation batches of {CLI_B}, "
              f"{wall:.1f} s; launches {got}")
        check_launches(f"drivers {run}", got, expected_launches(
            steps * n_epochs, evals * n_epochs, label == "bf16"))
        lines = metric_lines(save, run)
        if len(lines) != n_epochs or not os.path.exists(
                os.path.join(save, "MLM", run)):
            fail(f"drivers {run}: {len(lines)} metric lines, weights "
                 f"{os.listdir(os.path.join(save, 'MLM'))}")
        for line in lines:
            if not all(math.isfinite(line[k]) for k in (
                    "epoch_train_mlm_loss", "epoch_train_supcon_loss",
                    "epoch_val_loss", "train_items_per_sec")):
                fail(f"drivers {run}: non-finite metric in {line}")
            print(f"drivers {run} epoch {line['epoch']}: mlm loss "
                  f"{line['epoch_train_mlm_loss']:.4f}, supcon loss "
                  f"{line['epoch_train_supcon_loss']:.4f}, val loss "
                  f"{line['epoch_val_loss']:.4f}")
        print_epochs(f"drivers {run}", lines, timer.epochs,
                     "epoch_train_loss")
        add_counts(launches, got)
        torch.cuda.empty_cache()

    # (b) one fp32 SupCon step, card against CPU
    supcon_check_fp32(torch)
    torch.cuda.empty_cache()

    # (c) fine-tuning from the CLI phase's bf16 pretraining
    t0 = time.perf_counter()
    vqa = make_vqa_fixture(os.path.join(work, "vqa"), DRV_VQA_PER_CAT, SEED,
                           CLI_IMAGE_SIZE)
    n_train, n_val, n_test = (5 * n for n in DRV_VQA_PER_CAT)
    print(f"drivers: VQA fixture of {n_train} + {n_val} + {n_test} questions "
          f"(JPEGs at {CLI_IMAGE_SIZE[0]}x{CLI_IMAGE_SIZE[1]} px) written "
          f"in {time.perf_counter() - t0:.1f} s")
    pretrained = os.path.join(work, "bf16", "MLM", "cli_bf16")
    vqa_flags = ["--data_dir", vqa, "--num_vis", "5", "--hidden_size", "768",
                 *CLI_ARGS[2:], "--vocab_file", vocab]
    tr, va, te = (-(-n // CLI_B) for n in (n_train, n_val, n_test))
    checkpoints = {}
    for label, extra, n_epochs in (
            ("bf16", ["--mixed_precision", "--smoothing", str(FT_SMOOTHING),
                      "--watch_histograms"], 1),
            ("fp32", ["--loss", "ASLSingleLabel"], 1)):
        run = f"vqa_{label}"
        save = os.path.join(work, run)
        hist = n_epochs if "--watch_histograms" in extra else 0
        reset_counts()
        t0 = time.perf_counter()
        with TF32Off(torch, f"drivers {run}"), Tee() as out, \
                TimedTrainEpochs(vqa_train, "vqa_epoch") as timer:
            vqa_train.main(["--run_name", run, "--save_dir", save,
                            "--epochs", str(n_epochs), "--use_pretrained",
                            "--model_dir", pretrained, *vqa_flags, *extra])
        wall = time.perf_counter() - t0
        got = read_counts()
        print(f"drivers {run}: vqa_train.main {' '.join(extra)}, {n_epochs} "
              f"epochs of {tr} train steps, {va} val and {te} test batches "
              f"at B={CLI_B}, {hist} histogram steps, {wall:.1f} s; "
              f"launches {got}")
        check_launches(f"drivers {run}", got, expected_launches(
            tr * n_epochs + hist, (va + te) * n_epochs, label == "bf16"))
        moved = [line for line in out.text.splitlines()
                 if line.startswith("[mmvqa] transferred ")]
        n_ok, n_all = (int(x) for x in moved[0].split()[2].split("/"))
        # the tensors that could not come across: a key or a shape the
        # pretrained file lacks, read off the run's checkpoint
        by_loss = os.path.join(save, "MLM", run + "_loss")
        pre = checkpoint.load_weights(pretrained)
        fresh = sorted(k for k, v in checkpoint.load_weights(by_loss).items()
                       if k not in pre or pre[k].shape != v.shape)
        print(f"drivers {run}: {n_ok} of {n_all} tensors transferred from "
              f"the CLI phase's bf16 pretraining; fresh: {fresh}")
        if fresh != ["classifier_2.bias", "classifier_2.weight"] or (
                n_all - n_ok != len(fresh)):
            fail(f"drivers {run}: {n_all - n_ok} tensors stayed fresh "
                 f"({fresh}); want exactly classifier_2")
        lines = metric_lines(save, run)
        epochs = [line for line in lines if "histograms" not in line]
        if len(epochs) != n_epochs or len(lines) - n_epochs != hist:
            fail(f"drivers {run}: {len(epochs)} metric lines and "
                 f"{len(lines) - len(epochs)} histogram lines")
        keys = {f"{c}_{m}" for c in ("total", "binary", "plane", "organ",
                                     "modality", "abnorm")
                for m in ("acc", "bleu")} | {"val_total_acc"}
        for line in epochs:
            if not keys <= line.keys() or not all(math.isfinite(line[k]) for k in (
                    "train_loss", "val_loss", "test_loss", "total_bleu",
                    "train_items_per_sec")):
                fail(f"drivers {run}: per-category keys or finite losses "
                     f"missing in {line}")
            print(f"drivers {run}: train loss {line['train_loss']:.4f}, "
                  f"val loss {line['val_loss']:.4f}, test loss "
                  f"{line['test_loss']:.4f}, val acc "
                  f"{line['val_total_acc']:.2f}, test acc "
                  f"{line['total_acc']:.2f}, test BLEU "
                  f"{line['total_bleu']:.4f}")
        print_epochs(f"drivers {run}", epochs, timer.epochs, "train_loss")
        by_acc = os.path.join(save, "MLM", run)
        acc_seen = max(line["val_total_acc"] for line in epochs) > 0
        if not os.path.exists(by_loss) or os.path.exists(by_acc) != acc_seen:
            fail(f"drivers {run}: best checkpoints "
                 f"{os.listdir(os.path.join(save, 'MLM'))}, a val accuracy "
                 f"above 0: {acc_seen}")
        checkpoints[label] = [by_acc, by_loss] if acc_seen else [by_loss]
        add_counts(launches, got)
        torch.cuda.empty_cache()

    # (d) evaluation of the bf16 run's best model, then of its two best
    # checkpoints (the fp32 run's best by loss where the bf16 run saved no
    # best by accuracy)
    pair = (checkpoints["bf16"] if len(checkpoints["bf16"]) == 2
            else checkpoints["bf16"] + checkpoints["fp32"][-1:])
    for label, dirs in (("single", pair[:1]), ("ensemble", pair)):
        save = os.path.join(work, "eval_" + label)
        name = os.path.basename(dirs[0])
        reset_counts()
        t0 = time.perf_counter()
        with TF32Off(torch, f"drivers eval {label}"):
            vqa_eval.main(["--run_name", "eval", "--save_dir", save,
                           "--mixed_precision", *vqa_flags, "--model_dir",
                           dirs[0], "--model_dirs", *dirs])
        wall = time.perf_counter() - t0
        got = read_counts()
        print(f"drivers eval {label}: vqa_eval.main of "
              f"{[os.path.relpath(d, work) for d in dirs]}, {te} test "
              f"batches a model, {wall:.1f} s ({n_test * len(dirs) / wall:.1f} "
              f"questions/s with set-up); launches {got}")
        check_launches(f"drivers eval {label}", got,
                       expected_launches(0, te * len(dirs), True))
        with open(os.path.join(save, f"{name}_preds.csv"), newline="") as f:
            rows = list(csv.reader(f))
        with open(os.path.join(save, f"{name}_res.txt")) as f:
            res = f.read().splitlines()
        if len(rows) != n_test + 1 or len(res) != n_test:
            fail(f"drivers eval {label}: {len(rows) - 1} prediction rows and "
                 f"{len(res)} submission lines for {n_test} questions")
        col = rows[0].index("decode_preds")
        share = 100.0 * sum(r[col] == r[col + 1] for r in rows[1:]) / n_test
        acc = metric_lines(save, f"testing-{name}")[0]["total_acc"]
        print(f"drivers eval {label}: test accuracy {acc:.4f}, the share of "
              f"right rows in {name}_preds.csv {share:.4f}")
        if acc != round(share, 4):
            fail(f"drivers eval {label}: total_acc {acc}, rows {share}")
        add_counts(launches, got)
        torch.cuda.empty_cache()
    return launches


# ------------------------------------------------- the default model ----

# the CLIs' default model: ResNet-152 and the pre-norm BERT encoder
DEF_SITES = (101, 155)   # K4 and K5 sites of a train step (models/resnet.py)
DEF_TRAIN_STEPS = 4      # bf16 main-path steps an epoch, on one repeated batch
DEF_CLI_ARGS = ["--mlm_prob", "0.15", "--batch_size", str(CLI_B),
                "--num_workers", "4"]
# ResNet-152's taps at 224 px, deepest first: (name, side, channels)
DEF_TAPS = (("layer4", 7, 2048), ("layer3", 14, 1024), ("layer2", 28, 512),
            ("layer1", 56, 256), ("stem", 112, 64))
DEF_CHECK_LEAVES = ([f"trans.token_conv_{i}.weight" for i in range(5)]
                    + ["trans.trunk.conv1.weight",
                       "trans.trunk.layer3_block17.conv1.weight",
                       "trans.trunk.layer3_block17.conv3.weight",
                       "trans.trunk.layer3_block17.bn2.weight",
                       "encoder.attention_0.proj_q.weight",
                       "encoder.norm1.weight",
                       "encoder.feedforward_3.fc2.weight",
                       "bert_embedding.word_embeddings.weight",
                       "classifier_2.weight"])
# At the seed's weights (every BatchNorm scale 1) the default model's
# forward in training mode amplifies rounding: a relative change of 1e-6 at
# its K4 outputs moves the MLM logits (up to 5.6) by 4.6e-3 on the CPU plain
# path (mmvqa_tpu_torch/tools/probe_conditioning.py), as the 50 residual
# blocks each add a unit-variance branch, so no two fp32 implementations
# meet at TOL_SLICE (on an H100 the card's logits lay 2.8e-2 from the CPU's
# at unit scales). With
# every block's bn3 scale multiplied by DEF_CHECK_BN3_SCALE the same change
# moves them 3.0e-5: the fp32 check runs there (torchvision's
# zero_init_residual sets the scale to 0).
DEF_CHECK_BN3_SCALE = 0.2
# the relative change of every K4 output in the check's second card step,
# and how many times that step's distance a trunk leaf may lie farther
# from the CPU's (default_train_check_fp32)
DEF_CHECK_NUDGE = 1e-6
DEF_CHECK_FLIPS = 4.0
DEF_CHECK_STATS = ["trans.trunk.bn1.running_var",
                   "trans.trunk.layer3_block17.bn2.running_var",
                   "trans.trunk.layer4_block0.downsample_bn.running_var"]


def default_launches(train: int, forwards: int, bf16: bool) -> dict:
    """Each counter after ``train`` train steps and ``forwards`` eval
    forwards of the default model: K1 on its five taps, K4 at its 101 sites
    (bf16 on the TMA path, fp32 split-TF32), K5 at its 155; no attention or
    depthwise kernel."""
    k4, k5 = DEF_SITES
    want = dict.fromkeys(expected_launches(0, 0, bf16), 0)
    want.update(token_head=5 * (train + forwards),
                token_head_tf32x3=0 if bf16 else 5 * (train + forwards),
                token_head_bwd=5 * train,
                token_head_bwd_tf32x3=0 if bf16 else 5 * train,
                conv1x1_stats=k4 * train,
                conv1x1_stats_tma=k4 * train if bf16 else 0,
                conv1x1_stats_tf32x3=0 if bf16 else k4 * train,
                bn_backward_sums=k5 * train)
    return want


def resnet_sites(B: int, size: int = 224):
    """ResNet-152's K4 (N, K, C) and K5 (N, C) site shapes at batch ``B``,
    each with how many sites have it; follows models/resnet.py."""
    from collections import Counter

    from mmvqa_tpu_torch.models.resnet import (
        EXPANSION,
        RESNET152_STAGES,
        STAGE_WIDTHS,
        STEM_CH,
    )

    k4, k5 = Counter(), Counter()
    s = size // 2
    k5[(B * s * s, STEM_CH)] += 1
    s, in_ch = s // 2, STEM_CH
    for si, (blocks, w) in enumerate(zip(RESNET152_STAGES, STAGE_WIDTHS)):
        for bi in range(blocks):
            stride = 2 if si > 0 and bi == 0 else 1
            so = s // stride
            k4[(B * s * s, in_ch, w)] += 1
            k5[(B * s * s, w)] += 1
            k5[(B * so * so, w)] += 1
            k4[(B * so * so, w, w * EXPANSION)] += 1
            k5[(B * so * so, w * EXPANSION)] += 1
            if bi == 0:
                k5[(B * so * so, w * EXPANSION)] += 1
                if stride == 1:
                    k4[(B * s * s, in_ch, w * EXPANSION)] += 1
            s, in_ch = so, w * EXPANSION
    return k4, k5


def default_kernel_phase(torch, results) -> dict:
    """K1 at the five taps, K4 and K5 at every distinct site shape of
    ResNet-152, at B=CLI_B in fp32 and B=TRAIN_B in bf16, against their
    plain versions (two runs bit for bit), each timed beside its plain
    version, its bound and the library's call where there is one (F.conv2d +
    torch.batch_norm_stats beside K4, torch.batch_norm_backward_reduce
    beside K5), inputs not in the L2 cache. Errors go into ``results``;
    returns each kernel's sums over one train step's sites at each
    (dtype, B): [ms, plain, bound, library]."""
    import torch.nn.functional as F

    from mmvqa_tpu_torch.models.visual_tokens import tap_positions
    from mmvqa_tpu_torch.ops.bn_sums import (
        bn_backward_sums,
        bn_backward_sums_reference,
    )
    from mmvqa_tpu_torch.ops.conv_bn import (
        conv1x1_stats,
        conv1x1_stats_reference,
    )
    from mmvqa_tpu_torch.ops.token_head import (
        fused_token_head,
        token_head_backward,
        token_head_backward_reference,
        token_head_reference,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    sums: dict = {}

    def timed(fn):
        return time_ms(fn, 5, 2, flush)

    def add(name, dtype, B, count, ms, plain, bnd, lib=0.0):
        row = sums.setdefault((name, "bf16" if dtype == torch.bfloat16
                               else "fp32", B), [0.0, 0.0, 0.0, 0.0])
        for i, v in enumerate((ms, plain, bnd, lib)):
            row[i] += count * v

    def err(name, dtype, e):
        r = results[name]["err"]
        r[dtype] = max(r[dtype], e)

    def k1_forward(label, x, w, act):
        """checked_k1_fwd, then timed beside the plain version and its
        bound."""
        B, P, K = x.shape
        bf16 = x.dtype == torch.bfloat16
        e = checked_k1_fwd(label, x, w, act)
        ms = timed(lambda: fused_token_head(x, w, act))
        plain = timed(lambda: token_head_reference(x, w, act))
        bnd = k1_bound(B, P, K, HIDDEN, x.element_size(), act, "fwd",
                       tensor_cores=not bf16)
        print(f"token_head {label}: max_abs_err {e:.3e}, two runs "
              f"identical  kernel {ms:.4f} ms  plain {plain:.4f} ms  "
              f"bound {bnd[0]:.4f} ms ({bnd[1]}"
              f"{'' if bf16 else ', tensor cores'})  library null  "
              f"{k1_fwd_rate(B, P, K, HIDDEN, ms, bnd[0])}")
        err("token_head", x.dtype, e)
        if not bf16:
            err("token_head_tf32x3", x.dtype, e)
        add("token_head", x.dtype, B, 1, ms, plain, bnd[0])
        return e

    # ---- K1's fp32 forward at the train batch too (the CLIs' fp32 runs
    # take it at B=16; the flagship's taps are held at both in kernel_phase)
    for name, side, K in DEF_TAPS:
        P = side * side
        feat = torch.randn(TRAIN_B, side, side, K, device=dev, generator=g)
        x = tap_positions(feat.permute(0, 3, 1, 2))
        w = torch.randn(K, HIDDEN, device=dev, generator=g) * K ** -0.5
        k1_forward(f"default {name} B={TRAIN_B} P={P} K={K} "
                   f"{torch.float32}", x, w, "serf")
        del feat, x
    torch.cuda.empty_cache()

    for dtype, B in ((torch.float32, CLI_B), (torch.bfloat16, TRAIN_B)):
        bf16 = dtype == torch.bfloat16
        act = "serf_fast" if bf16 else "serf"
        # ---- K1, forward and backward, at each tap
        for name, side, K in DEF_TAPS:
            P = side * side
            feat = torch.randn(B, side, side, K, device=dev, generator=g)
            x = tap_positions(feat.to(dtype).permute(0, 3, 1, 2))
            w = (torch.randn(K, HIDDEN, device=dev, generator=g)
                 * K ** -0.5).to(dtype)
            gout = torch.randn(B, HIDDEN, device=dev, generator=g)
            label = f"default {name} B={B} P={P} K={K} {dtype}"
            e = k1_forward(label, x, w, act)

            tf32x3 = fused_token_head.backward_tf32x3_launches
            dx, dw = token_head_backward(x, w, gout, act)
            dx2, dw2 = token_head_backward(x, w, gout, act)
            dx_p, dw_p = token_head_backward_reference(x, w, gout, act)
            torch.cuda.synchronize()
            if (fused_token_head.backward_tf32x3_launches - tf32x3
                    != (0 if bf16 else 2)):
                fail(f"token_head_bwd {label}: fp32 off the split-TF32 path")
            if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
                fail(f"token_head_bwd {label}: two runs differ")
            e_dx, e_dw = check_k1_bwd(label, x, dx, dw, dx_p, dw_p)
            del dx, dw, dx2, dw2, dx_p, dw_p
            ms = timed(lambda: token_head_backward(x, w, gout, act))
            plain = timed(
                lambda: token_head_backward_reference(x, w, gout, act))
            bnd = k1_bound(B, P, K, HIDDEN, x.element_size(), act, "bwd",
                           tensor_cores=not bf16)
            print(f"token_head_bwd {label}: max_abs_err dx {e_dx:.3e} dW "
                  f"{e_dw:.3e}, two runs identical  kernel {ms:.4f} ms  "
                  f"plain {plain:.4f} ms  bound {bnd[0]:.4f} ms ({bnd[1]}"
                  f"{'' if bf16 else ', tensor cores'})  library null  "
                  f"{k1_bwd_rate(B, P, K, HIDDEN, ms, bnd[0])}")
            err("token_head_bwd", dtype, max(e_dx, e_dw))
            if not bf16:
                err("token_head_bwd_tf32x3", dtype, max(e_dx, e_dw))
            add("token_head_bwd", dtype, B, 1, ms, plain, bnd[0])
            del feat, x
        torch.cuda.empty_cache()

        # ---- K4 at each site shape: w as the trunk passes it
        k4_sites, k5_sites = resnet_sites(B)
        if (sum(k4_sites.values()), sum(k5_sites.values())) != DEF_SITES:
            fail(f"ResNet-152 sites: {k4_sites} {k5_sites}")
        for (N, K, C), count in sorted(k4_sites.items()):
            x = torch.randn(N, K, device=dev, generator=g).to(dtype)
            wt = (torch.randn(C, K, device=dev, generator=g)
                  * K ** -0.5).to(dtype)
            w = wt.t()
            label = f"default N={N} K={K} C={C} {dtype} ({count} sites)"
            path = (conv1x1_stats.tma_launches, conv1x1_stats.tf32x3_launches)
            y, st = conv1x1_stats(x, w)
            y2, st2 = conv1x1_stats(x, w)
            y_p, st_p = conv1x1_stats_reference(x, w)
            torch.cuda.synchronize()
            moved = (conv1x1_stats.tma_launches - path[0],
                     conv1x1_stats.tf32x3_launches - path[1])
            if moved != ((2, 0) if bf16 else (0, 2)):
                fail(f"conv1x1_stats {label}: off the "
                     f"{'TMA' if bf16 else 'split-TF32'} path {moved}")
            if not (torch.equal(y, y2) and torch.equal(st, st2)):
                fail(f"conv1x1_stats {label}: two runs differ")
            e_y = close(f"conv1x1_stats {label} y", y, y_p,
                        TOL_BF16 if bf16 else TOL_K4_F32)
            e_s = max(close_normwise(f"conv1x1_stats {label} sums[{i}]",
                                     st[i], st_p[i], REL_K4_SUMS)
                      for i in (0, 1))
            del y, y2, st, st2, y_p, st_p
            ms = timed(lambda: conv1x1_stats(x, w))
            plain = timed(lambda: conv1x1_stats_reference(x, w))
            xn = x.view(B, N // B, 1, K).permute(0, 3, 1, 2)
            w4 = wt.view(C, K, 1, 1)
            lib = timed(lambda: torch.batch_norm_stats(F.conv2d(xn, w4),
                                                       1e-5))
            nbytes = (N * K + K * C + N * C) * x.element_size() + 8 * C
            bnd = bound(nbytes, 2.0 * N * K * C + 3.0 * N * C, 0,
                        "bf16" if bf16 else "tf32x3")
            print(f"conv1x1_stats {label}: max_abs_err y {e_y:.3e} sums "
                  f"{e_s:.3e}, two runs identical  kernel {ms:.4f} ms  plain "
                  f"{plain:.4f} ms  bound {bnd[0]:.4f} ms ({bnd[1]}"
                  f"{'' if bf16 else ', tensor cores'})  library (conv2d + "
                  f"batch_norm_stats) {lib:.4f} ms")
            err("conv1x1_stats", dtype, e_y)
            if not bf16:
                err("conv1x1_stats_tf32x3", dtype, e_y)
            add("conv1x1_stats", dtype, B, count, ms, plain, bnd[0], lib)
            del x, xn
        torch.cuda.empty_cache()

        # ---- K5 at each site shape, beside the library's reduction on the
        # (B, C, H, W) view of the same channels-last map
        for (N, C), count in sorted(k5_sites.items()):
            x = (torch.randn(N, C, device=dev, generator=g) * 2 + 1).to(dtype)
            dy = torch.randn(N, C, device=dev, generator=g).to(dtype)
            mean = torch.randn(C, device=dev, generator=g)
            inv_std = 1 + torch.rand(C, device=dev, generator=g)
            label = f"default N={N} C={C} {dtype} ({count} sites)"
            s1, s2 = bn_backward_sums(x, dy, mean, inv_std)
            r1, r2 = bn_backward_sums(x, dy, mean, inv_std)
            p1, p2 = bn_backward_sums_reference(x, dy, mean, inv_std)
            torch.cuda.synchronize()
            if not (torch.equal(s1, r1) and torch.equal(s2, r2)):
                fail(f"bn_backward_sums {label}: two runs differ")
            e = max(close_normwise(f"bn_backward_sums {label} s1", s1, p1,
                                   REL_K5),
                    close_normwise(f"bn_backward_sums {label} s2", s2, p2,
                                   REL_K5))
            xn = x.view(B, N // B, 1, C).permute(0, 3, 1, 2)
            dyn = dy.view(B, N // B, 1, C).permute(0, 3, 1, 2)
            ones = torch.ones(C, device=dev)
            ms = timed(lambda: bn_backward_sums(x, dy, mean, inv_std))
            plain = timed(
                lambda: bn_backward_sums_reference(x, dy, mean, inv_std))
            lib = timed(lambda: torch.batch_norm_backward_reduce(
                dyn, xn, mean, inv_std, ones, True, True, True))
            bnd = bound(2 * N * C * x.element_size() + 16 * C, 5.0 * N * C,
                        0, "fp32")
            print(f"bn_backward_sums {label}: max_abs_err {e:.3e}, two runs "
                  f"identical  kernel {ms:.4f} ms  plain {plain:.4f} ms  "
                  f"bound {bnd[0]:.4f} ms ({bnd[1]})  library "
                  f"(batch_norm_backward_reduce) {lib:.4f} ms")
            err("bn_backward_sums", dtype, e)
            add("bn_backward_sums", dtype, B, count, ms, plain, bnd[0], lib)
            del x, dy, xn, dyn
        torch.cuda.empty_cache()
    for (name, dt, B), (ms, plain, bnd, lib) in sums.items():
        print(f"default kernels: {name} {dt} B={B}, one train step's sites: "
              f"kernel {ms:.4f} ms  plain {plain:.4f} ms  bound {bnd:.4f} ms"
              f"  library {lib:.4f} ms" if lib else
              f"default kernels: {name} {dt} B={B}, one train step's sites: "
              f"kernel {ms:.4f} ms  plain {plain:.4f} ms  bound {bnd:.4f} ms"
              f"  library null")
    return sums


def default_eval(torch) -> dict:
    """(a) The default VQA model answers EVAL_B requests at T=28 in fp32 and
    bf16 through ``make_vqa_eval_step``: fp32 logits within TOL_SLICE of the
    CPU plain path, bf16 ones within BF16_SLICE_FACTOR of the same bf16
    model's distance on the CPU, five K1 launches a forward and no other
    kernel. Returns the launches."""
    import copy

    from mmvqa_tpu_torch.core.config import vqa_config
    from mmvqa_tpu_torch.data.synthetic import vqa_batches
    from mmvqa_tpu_torch.models import MMBert
    from mmvqa_tpu_torch.train.steps import make_vqa_eval_step

    cfg = vqa_config(num_classes=NUM_CLASSES)
    if (cfg.cnn_encoder, cfg.transformer_model) != ("resnet152",
                                                     "transformer"):
        fail(f"default: vqa_config builds {cfg.cnn_encoder} + "
             f"{cfg.transformer_model}")
    batches = vqa_batches(cfg, 2, NUM_CLASSES, SEED, PAD_LAST)
    model = MMBert(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(SEED))
    print(f"default eval: MMBert VQA {cfg.cnn_encoder} + "
          f"{cfg.transformer_model}, hidden {cfg.hidden_size}, {cfg.heads} "
          f"heads, {cfg.n_layers} layers, T={cfg.max_position_embeddings}, "
          f"{cfg.image_size} px, B={cfg.batch_size}, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M "
          f"parameters")
    refs = {}
    for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        cpu_model = model if dtype == torch.float32 else (
            copy.deepcopy(model).to(dtype))
        refs[label] = make_vqa_eval_step(cpu_model, cfg)(batches[0])
        del cpu_model
    model.to("cuda")
    reset_counts()
    outs = {}
    for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        model.to(dtype)
        outs[label] = run_batches(torch, make_vqa_eval_step(model, cfg),
                                  batches, f"default {label}")[0]
    launches = read_counts()
    want = default_launches(0, 2 * len(batches), True)
    want["token_head_tf32x3"] = 5 * len(batches)  # the fp32 forwards
    check_launches("default eval", launches, want)
    e32 = close("default eval fp32 logits vs CPU", outs["fp32"]["logits"].cpu(),
                refs["fp32"]["logits"], TOL_SLICE)
    ref32 = refs["fp32"]["logits"]
    card16 = (outs["bf16"]["logits"].float().cpu() - ref32).abs().max().item()
    cpu16 = (refs["bf16"]["logits"].float() - ref32).abs().max().item()
    print(f"default eval: fp32 card vs CPU logits max_abs_err {e32:.3e}; "
          f"bf16 logits vs fp32 CPU: card {card16:.3e}, CPU bf16 "
          f"{cpu16:.3e} (limit {BF16_SLICE_FACTOR} x); launches {launches}")
    if not card16 <= BF16_SLICE_FACTOR * cpu16:
        fail(f"default eval bf16 logits: {card16:.3e} from the fp32 result, "
             f"beyond {BF16_SLICE_FACTOR} x the CPU bf16 path's {cpu16:.3e}")
    del model
    torch.cuda.empty_cache()
    return launches


def scale_bn3(torch, model) -> None:
    """Every residual branch's last BatchNorm named bn3 (each ResNet block's,
    each EfficientNetV2 MBConv block's) scaled by DEF_CHECK_BN3_SCALE (see
    there): the conditioning at which a fp32 forward of a trunk in training
    mode can be held against the CPU where no encoder's LayerNorm follows.
    The image-only model's logits on EfficientNetV2-M (up to 3.4 at B=8)
    move 1.9e-4 on the CPU when every K4 output moves by a relative 1e-6,
    3.6e-5 with the MBConv scales lowered (on the card they lay 1.3e-3
    from the CPU's without)."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if name.endswith(".bn3"):
                mod.weight.mul_(DEF_CHECK_BN3_SCALE)


def held_step_fp32(torch, label, cpu_model, cfg, batch, draws, make_steps,
                   leaves, stats, want_launches, nudged=None) -> None:
    """One fp32 train step of ``cpu_model`` (``make_steps``) on the CPU plain
    path and of a copy on the card, the card's launches at
    ``want_launches``, the kept values held by ``compare_fp32_step``. With
    ``nudged`` (the prefix of a trunk's leaves) a second card step runs
    with every K4 output moved by a relative DEF_CHECK_NUDGE, and a leaf
    under that prefix may lie DEF_CHECK_FLIPS times that step's distance
    from the first farther from the CPU's: on ResNet for its ReLUs
    (``default_train_check_fp32`` says why), on the image-only model's
    EfficientNetV2-M for its conditioning (its gradient reaches stage 4
    through stages 5 and 6 alone, and there, at the bn3 scales of
    ``scale_bn3``, stage4_block13's depthwise gradient lay 2.05e-3 of its
    largest entry from the CPU's on the H100; the flagship's checks read
    1.2e-3 at that leaf)."""
    import copy

    from mmvqa_tpu_torch.models import effnetv2

    card_model = copy.deepcopy(cpu_model).to("cuda")
    twin_model = copy.deepcopy(card_model) if nudged else None
    t0 = time.perf_counter()
    want = checked_train_step(torch, cpu_model, cfg, batch, draws,
                              make_steps, leaves, stats)
    print(f"{label} check: CPU reference step (plain path, "
          f"B={len(batch['weights'])}) "
          f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
    reset_counts()
    got = checked_train_step(torch, card_model, cfg, batch, draws,
                             make_steps, leaves, stats)
    torch.cuda.synchronize()
    check_launches(label, read_counts(), want_launches)
    del card_model
    allow = {}
    if nudged:
        kernel = effnetv2.conv1x1_stats
        gen = torch.Generator(device="cuda").manual_seed(SEED)

        def nudged_kernel(x, w):
            y, st = kernel(x, w)
            noise = torch.randn(y.shape, device=y.device, generator=gen)
            return y * (1.0 + DEF_CHECK_NUDGE * noise), st

        effnetv2.conv1x1_stats = nudged_kernel
        try:
            twin = checked_train_step(torch, twin_model, cfg, batch, draws,
                                      make_steps, leaves, stats)
        finally:
            effnetv2.conv1x1_stats = kernel
        del twin_model
        for name in leaves:
            spread = (twin[name] - got[name]).abs().max().item()
            print(f"{label} check: {name}: the nudged card step lies "
                  f"{spread:.3e} from the card step (of max "
                  f"{got[name].abs().max().item():.3e})")
            if name.startswith(nudged):
                allow[name] = DEF_CHECK_FLIPS * spread
    compare_fp32_step(torch, label, got, want, leaves, stats, allow)


def default_train_check_fp32(torch) -> None:
    """(b) One fp32 MLM train step of the default model at B=CHECK_B, T=75,
    card against the CPU plain path, held as the flagship's step is, its
    own leaves and statistics, every bn3 scale multiplied by
    DEF_CHECK_BN3_SCALE. The trunk's weight gradients pass through ReLUs,
    whose derivative jumps at 0: a ReLU input within rounding of 0 can take
    the other side on the card, which moves a conv weight's gradient by a
    whole term, about 1/sqrt(N) of it (1-4% at layer3, B=8). So the same
    card step is run again with every K4 output moved by a relative 1e-6
    (DEF_CHECK_NUDGE, about the split-TF32 products' error), and a trunk
    leaf may lie DEF_CHECK_FLIPS times that run's distance from the first
    farther from the CPU's than GRAD_NORMWISE allows; every other value is
    held as the flagship's."""
    from mmvqa_tpu_torch.core.config import pretrain_config
    from mmvqa_tpu_torch.data.images import PRETRAIN_AUG, sample_draws
    from mmvqa_tpu_torch.data.synthetic import mlm_batches
    from mmvqa_tpu_torch.models import MMBert
    from mmvqa_tpu_torch.train.steps import make_mlm_steps

    cfg = pretrain_config(batch_size=CHECK_B, dropout_override=0.0)
    batch = mlm_batches(cfg, 1, SEED)[0]
    draws = sample_draws(CHECK_B, cfg.image_size,
                         torch.Generator().manual_seed(SEED), PRETRAIN_AUG)
    cpu_model = MMBert(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(SEED))
    scale_bn3(torch, cpu_model)
    held_step_fp32(torch, "default train fp32", cpu_model, cfg, batch,
                   draws, make_mlm_steps, DEF_CHECK_LEAVES, DEF_CHECK_STATS,
                   default_launches(1, 0, False), nudged="trans.trunk.")


def default_train(torch) -> dict:
    """(c) The bf16 main path at B=TRAIN_B, T=75: an epoch of
    DEF_TRAIN_STEPS steps through ``mlm_epoch`` on a repeated batch (ms a
    step, images/s, peak memory; the loss falls), a second one with the
    counters read around it (exact counts), then the train step's profiler
    rules and the card's busy time. Returns the second epoch's launches."""
    from mmvqa_tpu_torch.core.config import pretrain_config
    from mmvqa_tpu_torch.data.synthetic import mlm_batches
    from mmvqa_tpu_torch.models import MMBert
    from mmvqa_tpu_torch.models.mmbert import compute_dtype_of
    from mmvqa_tpu_torch.train.state import create_train_state
    from mmvqa_tpu_torch.train.steps import make_mlm_steps
    from mmvqa_tpu_torch.train.trainer import mlm_epoch

    cfg = pretrain_config(batch_size=TRAIN_B, mixed_precision=True,
                          lr=TRAIN_LR, seed=SEED)
    model = MMBert(cfg, compute_dtype=compute_dtype_of(cfg),
                   generator=torch.Generator().manual_seed(SEED))
    print(f"default train: MMBert MLM {cfg.cnn_encoder} + "
          f"{cfg.transformer_model}, T={cfg.max_position_embeddings}, "
          f"compute {model.dtype}, B={TRAIN_B}, lr {cfg.lr}")
    state = create_train_state(model, cfg.lr, clip=cfg.clip)
    train_step, _ = make_mlm_steps(model, cfg)
    batch = mlm_batches(cfg, 1, SEED)[0]
    loader = [batch] * DEF_TRAIN_STEPS
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
    print(f"default train bf16 B={TRAIN_B}: ms per step "
          f"{['%.1f' % t for t in times]} (median after the first "
          f"{step_ms:.2f}, {TRAIN_B / step_ms * 1e3:.1f} images/s); peak "
          f"memory {peak:.1f} MiB; losses {['%.4f' % x for x in losses]}")
    reset_counts()
    state, second = mlm_epoch(train_step, state, loader, True)
    launches = read_counts()
    print(f"default train bf16: mlm_epoch of {DEF_TRAIN_STEPS} steps: "
          f"{second}; launches {launches}")
    check_launches("default train bf16", launches,
                   default_launches(DEF_TRAIN_STEPS, 0, True))
    copies = gradient_copies()
    if any(copies.values()):
        fail(f"default train: gradients copied into their map's layout: "
             f"{copies}")
    if not all(math.isfinite(x) for x in losses) or not all(
            math.isfinite(v) for v in second.values()):
        fail(f"default train: non-finite loss {losses} {second}")
    if not (losses[-1] < losses[0] and second["loss"] < first["loss"]):
        fail(f"default train: the loss did not fall on a repeated batch: "
             f"{losses}, epochs {first['loss']} -> {second['loss']}")

    def run_step():
        nonlocal state
        state, m = train_step(state, batch)
        return m

    traced_train_steps(torch, run_step, 2, f"default train bf16 B={TRAIN_B}")
    del model, state
    torch.cuda.empty_cache()
    return launches


def default_clis(torch, work: str) -> dict:
    """(d) The CLIs with their own encoder defaults on the CLI phase's
    fixtures: ``roco_train.main`` one epoch in bf16 and one in fp32,
    ``vqa_train.main`` one epoch in bf16 from the bf16 weights (exactly
    ``classifier_2`` fresh), ``vqa_eval.main`` of its best weights. Every
    run: its counters at their exact counts, finite losses, its files.
    Returns the launches of all four."""
    from mmvqa_tpu_torch.cli import roco_train, vqa_eval, vqa_train

    roco, vqa = os.path.join(work, "roco"), os.path.join(work, "vqa")
    launches: dict = {}
    steps, evals = -(-CLI_TRAIN // CLI_B), -(-CLI_VAL // CLI_B)
    for label, extra in (("bf16", ["--mixed_precision"]), ("fp32", [])):
        run = f"default_{label}"
        save = os.path.join(work, run)
        reset_counts()
        t0 = time.perf_counter()
        with TF32Off(torch, f"default cli {label}"):
            roco_train.main(["-r", run, "--data_dir", roco, "--save_dir",
                             save, "--epochs", "1", *DEF_CLI_ARGS, *extra])
        got = read_counts()
        check_launches(f"default cli {run}", got,
                       default_launches(steps, evals, label == "bf16"))
        (line,) = metric_lines(save, run)
        if not all(math.isfinite(line[k]) for k in (
                "epoch_train_loss", "epoch_val_loss")) or not os.path.exists(
                os.path.join(save, "MLM", run)):
            fail(f"default cli {run}: {line}, weights "
                 f"{os.listdir(os.path.join(save, 'MLM'))}")
        print(f"default cli {run}: roco_train.main without encoder flags, "
              f"{steps} train steps and {evals} validation batches at "
              f"B={CLI_B}, {time.perf_counter() - t0:.1f} s; train loss "
              f"{line['epoch_train_loss']:.4f}, val loss "
              f"{line['epoch_val_loss']:.4f}, "
              f"{line['train_items_per_sec']:.1f} train items/s")
        add_counts(launches, got)
        torch.cuda.empty_cache()

    n_train, n_val, n_test = (5 * n for n in DRV_VQA_PER_CAT)
    tr, va, te = (-(-n // CLI_B) for n in (n_train, n_val, n_test))
    run = "default_vqa"
    save = os.path.join(work, run)
    flags = ["--data_dir", vqa, "--num_vis", "5", "--hidden_size", "768",
             "--batch_size", str(CLI_B), "--num_workers", "4", "--vocab_file",
             os.path.join(roco, "vocab.txt"), "--mixed_precision"]
    reset_counts()
    t0 = time.perf_counter()
    with TF32Off(torch, "default cli vqa"), Tee() as out:
        vqa_train.main(["--run_name", run, "--save_dir", save, "--epochs",
                        "1", "--use_pretrained", "--model_dir",
                        os.path.join(work, "default_bf16", "MLM",
                                     "default_bf16"), *flags])
    got = read_counts()
    check_launches(f"default cli {run}", got, default_launches(tr, va + te,
                                                               True))
    moved = [x for x in out.text.splitlines()
             if x.startswith("[mmvqa] transferred ")]
    n_ok, n_all = (int(x) for x in moved[0].split()[2].split("/"))
    if n_all - n_ok != 2:
        fail(f"default cli {run}: {moved[0]}; want exactly classifier_2 "
             f"fresh")
    (line,) = metric_lines(save, run)
    best = os.path.join(save, "MLM", run + "_loss")
    if not all(math.isfinite(line[k]) for k in (
            "train_loss", "val_loss", "test_loss")) or not os.path.exists(
            best):
        fail(f"default cli {run}: {line}, {os.listdir(save)}")
    print(f"default cli {run}: vqa_train.main without encoder flags, "
          f"{tr} train steps, {va} val and {te} test batches, "
          f"{n_ok}/{n_all} tensors transferred, "
          f"{time.perf_counter() - t0:.1f} s; train loss "
          f"{line['train_loss']:.4f}, val loss {line['val_loss']:.4f}, test "
          f"loss {line['test_loss']:.4f}, "
          f"{line['train_items_per_sec']:.1f} train items/s")
    add_counts(launches, got)

    save = os.path.join(work, "default_eval")
    reset_counts()
    with TF32Off(torch, "default cli eval"):
        vqa_eval.main(["--run_name", "eval", "--save_dir", save,
                       "--model_dir", best, *flags])
    got = read_counts()
    check_launches("default cli eval", got, default_launches(0, te, True))
    with open(os.path.join(save, f"{run}_loss_preds.csv"), newline="") as f:
        rows = list(csv.reader(f))
    if len(rows) != n_test + 1:
        fail(f"default cli eval: {len(rows) - 1} rows for {n_test} questions")
    print(f"default cli eval: vqa_eval.main without encoder flags, {te} "
          f"test batches, {len(rows) - 1} prediction rows")
    add_counts(launches, got)
    torch.cuda.empty_cache()
    return launches


def default_phase(torch, results, work: str) -> dict:
    """(8) The model the CLIs build by default, the reference's MMBERT:
    ResNet-152, the pre-norm BERT encoder, hidden 768, 12 heads, 4 layers,
    seeded random weights, 224 px. Its kernels at its shapes, eval, the fp32
    train step against the CPU, the CLIs' fp32 step at B=CLI_B traced, the
    bf16 main path and the CLIs. Returns the launches of the main-path runs
    (eval, the bf16 epoch, the CLIs)."""
    t0 = time.perf_counter()
    default_kernel_phase(torch, results)
    launches = default_eval(torch)
    default_train_check_fp32(torch)
    torch.cuda.empty_cache()
    fp32_step_trace(torch, default=True)
    torch.cuda.empty_cache()
    add_counts(launches, default_train(torch))
    add_counts(launches, default_clis(torch, work))
    print(f"default phase: {time.perf_counter() - t0:.1f} s")
    return launches


# batch of the remaining paths' eval and forward checks against the CPU; their
# fp32 train steps are held at CHECK_B, the batch at which the default
# trunk's ReLU term (DEF_CHECK_FLIPS) was set: at B=4 a flipped ReLU moves a
# trunk gradient by twice the share, and the image-only model's layer3
# gradient, which reaches it through layer4 alone, lay 5.7 nudged spreads
# from the CPU's on the H100
AUX_B = 4
AUX_STEPS = 4     # bf16 steps of each remaining path's main path, B=CLI_B
AUX_EPOCHS = 2    # epochs of the distillation CLI runs
NUM_KEYWORDS = 32  # the image-only model's keyword vocabulary here
TEACHER_HIDDEN = 768  # ClinicalBERT's hidden states, the distillation labels
# the default trunk's leaves and statistics under the image-only model and
# the SupCon encoder (``trunk.``, not ``trans.trunk.``)
RESNET_LEAVES = ["trunk.conv1.weight", "trunk.layer3_block17.conv1.weight",
                 "trunk.layer3_block17.conv3.weight",
                 "trunk.layer3_block17.bn2.weight"]
RESNET_STATS = ["trunk.bn1.running_var",
                "trunk.layer3_block17.bn2.running_var",
                "trunk.layer4_block0.downsample_bn.running_var"]
EFFNET_LEAVES = ["trunk.stem_conv.weight",
                 "trunk.stage6_block4.pw_proj.weight",
                 "trunk.stage4_block13.dw.weight",
                 "trunk.stage4_block13.pw_exp.weight",
                 "trunk.stage4_block13.bn1.weight",
                 "trunk.stage1_block2.bn2.bias"]
EFFNET_STATS = ["trunk.stem_bn.running_var", "trunk.stem_bn.running_mean",
                "trunk.stage4_block13.bn2.running_var"]
FEEDBACK_LEAVES = ([l for l in DEF_CHECK_LEAVES if not l.startswith(
    "encoder.")] + ["encoder.segment.shared_kv.weight",
                    "encoder.segment.rel_bias.weight",
                    "encoder.segment.layer_weight",
                    "encoder.segment.to_q_0.weight",
                    "encoder.segment.ff_3.w_out.weight"])


def trunk_launches(trunk: str, train: int, forwards: int, bf16: bool,
                   train_forwards: int = 0) -> dict:
    """Each counter after ``train`` train steps, ``forwards`` eval forwards
    and ``train_forwards`` forwards in training mode (no backward) of a
    trunk alone, the image-only model's and the SupCon encoder's: K4 and K5
    at ResNet-152's 101 and 155 sites, or K3, K4 and K5 at
    EfficientNetV2-M's 42, 98 and 156; never K1 or K2."""
    want = dict.fromkeys(expected_launches(0, 0, bf16), 0)
    k4_passes = train + train_forwards
    if "resnet" in trunk:
        k4, k5 = DEF_SITES
    else:
        k4, k5 = 98, 156
        want.update(depthwise3x3=42 * (train + forwards + train_forwards),
                    depthwise3x3_bwd=42 * train)
    want.update(conv1x1_stats=k4 * k4_passes,
                conv1x1_stats_tma=k4 * k4_passes if bf16 else 0,
                conv1x1_stats_tf32x3=0 if bf16 else k4 * k4_passes,
                bn_backward_sums=k5 * train)
    return want


def with_teacher_states(torch, batches, hidden: int = TEACHER_HIDDEN):
    """MLM batches made distillation batches: ``labels`` the teacher's
    (B, T, hidden) states, fp32 from a seeded generator, where the input
    mask is set and zero on the padding."""
    gen = torch.Generator().manual_seed(SEED)
    out = []
    for b in batches:
        B, T = b["tokens"].shape
        states = torch.randn(B, T, hidden, generator=gen).numpy()
        keep = (b["input_mask"] > 0)[..., None]
        out.append(dict(b, labels=(states * keep).astype("float32")))
    return out


def teacher_stand_in(torch, vocab_size: int, hidden: int = TEACHER_HIDDEN):
    """The dataset's teacher interface, ids (1, L) -> states (1, L, hidden),
    as a seeded torch table with a position term: a stand-in for the
    ClinicalBERT checkpoint, which is not in the repository."""
    gen = torch.Generator().manual_seed(SEED)
    table = torch.randn(vocab_size, hidden, generator=gen) * 0.5
    pos = torch.randn(512, hidden, generator=gen) * 0.1

    def run(ids):
        t = torch.as_tensor(ids).long()
        return (table[t] + pos[: t.shape[-1]]).numpy()

    return run


def aux_main_path(torch, label, model, train_step, batch, want_step,
                  aug) -> dict:
    """The bf16 main path of a remaining model: AUX_STEPS train steps on a
    repeated batch of CLI_B under the same draws of ``aug`` (one input
    repeated: with fresh crops each step the image-only model's loss on
    EfficientNetV2-M rose and fell by more than four steps move it, on the
    CPU in fp32 too), each ending in a synchronise (ms a step, peak
    memory), the counters at ``want_step`` times the steps, finite losses
    that fall; then two steps traced (``traced_train_steps``: the card's
    busy time and the profiler's rules). Returns the counted launches."""
    from mmvqa_tpu_torch.data.images import sample_draws
    from mmvqa_tpu_torch.train.state import create_train_state

    state = [create_train_state(model, TRAIN_LR)]
    n, size = batch["image"].shape[:2]
    draws = sample_draws(n, size, torch.Generator(
        device="cuda").manual_seed(SEED), aug)

    def run_step():
        state[0], m = train_step(state[0], batch, draws)
        return m

    times, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for _ in range(AUX_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(run_step()["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_counts()
    check_launches(label, launches,
                   {k: v * AUX_STEPS for k, v in want_step.items()})
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses) or not (
            losses[-1] < losses[0]):
        fail(f"{label}: the loss did not fall on a repeated batch: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"{label}: ms per step {['%.1f' % t for t in times]} (median after "
          f"the first {statistics.median(times[1:]):.2f}); peak memory "
          f"{peak:.1f} MiB; losses {['%.4f' % x for x in losses]}; "
          f"launches {launches}")
    traced_train_steps(torch, run_step, 2, label)
    return launches


def distill_phase(torch, work: str) -> dict:
    """(9a) Distillation. One fp32 ``make_distill_steps`` step at B=CHECK_B,
    T=75, labels (B, 75, 768) from a seeded generator, card against the CPU
    plain path on the default model (bn3 scales and the ReLU term of
    ``default_train_check_fp32``) and on the flagship, the encoder's output
    among the kept values; the bf16 main path of each at B=CLI_B; then
    ``roco_train.main --task distillation`` without encoder flags on the
    CLI phase's fixture, AUX_EPOCHS epochs in bf16 and in fp32 with
    ``--watch_histograms``, a seeded stand-in in place of the dataset's
    ClinicalBERT teacher. Exact counts everywhere. Returns the launches of
    the main paths and the CLI runs."""
    from mmvqa_tpu_torch.cli import roco_train
    from mmvqa_tpu_torch.core.config import pretrain_config
    from mmvqa_tpu_torch.data import datasets
    from mmvqa_tpu_torch.data.images import PRETRAIN_AUG, sample_draws
    from mmvqa_tpu_torch.data.synthetic import mlm_batches
    from mmvqa_tpu_torch.data.tokenizer import WordPieceTokenizer
    from mmvqa_tpu_torch.models import MMBert
    from mmvqa_tpu_torch.train.steps import make_distill_steps

    launches: dict = {}
    for name, make_cfg, leaves, stats, counts, relu in (
            ("default", pretrain_config, DEF_CHECK_LEAVES, DEF_CHECK_STATS,
             default_launches, "trans.trunk."),
            ("flagship", flagship_mlm_config, CHECK_LEAVES, CHECK_STATS,
             expected_launches, None)):
        leaves = [x for x in leaves if not x.startswith("classifier")]
        cfg = make_cfg(batch_size=CHECK_B, dropout_override=0.0,
                       task="distillation")
        (batch,) = with_teacher_states(torch, mlm_batches(cfg, 1, SEED))
        draws = sample_draws(CHECK_B, cfg.image_size,
                             torch.Generator().manual_seed(SEED),
                             PRETRAIN_AUG)
        cpu_model = MMBert(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(SEED))
        if any(hasattr(cpu_model, h) for h in ("fc1", "classifier_2")):
            fail(f"distill {name}: the distillation model has heads")
        if relu:
            scale_bn3(torch, cpu_model)
        held_step_fp32(torch, f"distill {name} fp32", cpu_model, cfg,
                       batch, draws, make_distill_steps, leaves, stats,
                       counts(1, 0, False), nudged=relu)
        del cpu_model
        torch.cuda.empty_cache()

        cfg = make_cfg(batch_size=CLI_B, mixed_precision=True, lr=TRAIN_LR,
                       task="distillation", seed=SEED)
        (batch,) = with_teacher_states(torch, mlm_batches(cfg, 1, SEED))
        model = MMBert(cfg, compute_dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(SEED))
        train_step, _ = make_distill_steps(model, cfg)
        add_counts(launches, aux_main_path(
            torch, f"distill {name} bf16 B={CLI_B}", model, train_step,
            batch, counts(1, 0, True), PRETRAIN_AUG))
        del model, train_step
        torch.cuda.empty_cache()

    roco = os.path.join(work, "roco")
    teacher = teacher_stand_in(
        torch, WordPieceTokenizer.find_and_load(roco, "").vocab_size)
    steps, evals = -(-CLI_TRAIN // CLI_B), -(-CLI_VAL // CLI_B)
    real = datasets.ROCODataset._teacher
    datasets.ROCODataset._teacher = lambda self: teacher
    try:
        for label, extra in (("bf16", ["--mixed_precision"]), ("fp32", [])):
            run = f"distill_{label}"
            save = os.path.join(work, run)
            reset_counts()
            t0 = time.perf_counter()
            with TF32Off(torch, f"distill cli {label}"):
                roco_train.main(["-r", run, "--data_dir", roco, "--save_dir",
                                 save, "--task", "distillation", "--epochs",
                                 str(AUX_EPOCHS), "--watch_histograms",
                                 *DEF_CLI_ARGS, *extra])
            got = read_counts()
            # each epoch: its train steps, a histogram pass, its validation
            check_launches(f"distill cli {run}", got, default_launches(
                (steps + 1) * AUX_EPOCHS, evals * AUX_EPOCHS,
                label == "bf16"))
            lines = metric_lines(save, run)
            epochs = [x for x in lines if "histograms" not in x]
            hists = [x for x in lines if "histograms" in x]
            weights = os.path.join(save, "distillation", run)
            if len(epochs) != AUX_EPOCHS or len(hists) != AUX_EPOCHS or not (
                    all(math.isfinite(x[k]) for x in epochs for k in (
                        "epoch_train_loss", "epoch_val_loss"))) or not (
                    os.path.exists(weights)):
                fail(f"distill cli {run}: {epochs}, {len(hists)} histogram "
                     f"records, weights {os.path.exists(weights)}")
            print(f"distill cli {run}: roco_train.main --task distillation "
                  f"--watch_histograms, {AUX_EPOCHS} epochs of {steps} train "
                  f"steps, a histogram pass and {evals} validation batches "
                  f"at B={CLI_B}, {time.perf_counter() - t0:.1f} s; train "
                  f"losses {[round(x['epoch_train_loss'], 4) for x in epochs]}"
                  f", val losses "
                  f"{[round(x['epoch_val_loss'], 4) for x in epochs]}, "
                  f"{len(hists[0]['histograms'])} histograms an epoch, "
                  f"{epochs[-1]['train_items_per_sec']:.1f} train items/s")
            add_counts(launches, got)
            torch.cuda.empty_cache()
    finally:
        datasets.ROCODataset._teacher = real
    return launches


def img_only_phase(torch) -> dict:
    """(9b) ``ImageOnlyClassifier`` with the keyword pathway on each trunk
    at full width, 224 px: one eval step at B=AUX_B against the CPU plain
    path (logits within TOL_SLICE), one fp32 train step at B=CHECK_B held
    as the default model's (bn3 scales, ``scale_bn3``, and the nudged
    step's term on the trunk's leaves), then the bf16 main path at
    B=CLI_B. K1 and K2 never launch. Returns the main
    path's launches."""
    import copy

    from mmvqa_tpu_torch.core.config import vqa_config
    from mmvqa_tpu_torch.data.images import FINETUNE_AUG, sample_draws
    from mmvqa_tpu_torch.data.synthetic import vqa_batches
    from mmvqa_tpu_torch.models import ImageOnlyClassifier
    from mmvqa_tpu_torch.train.steps import make_img_only_steps

    launches: dict = {}
    for trunk, leaves, stats in (
            ("resnet152", RESNET_LEAVES, RESNET_STATS),
            ("tf_efficientnetv2_m", EFFNET_LEAVES, EFFNET_STATS)):
        label = f"img_only {trunk}"
        cfg = vqa_config(cnn_encoder=trunk, batch_size=AUX_B,
                         num_classes=NUM_CLASSES, lr=TRAIN_LR)
        (batch,) = vqa_batches(cfg, 1, NUM_CLASSES, SEED, 1)
        batch["keyword"] = (batch["answer"] % NUM_KEYWORDS).astype("int32")
        cpu_model = ImageOnlyClassifier(
            NUM_CLASSES, trunk, NUM_KEYWORDS, device="cpu",
            generator=torch.Generator().manual_seed(SEED))
        scale_bn3(torch, cpu_model)
        card_model = copy.deepcopy(cpu_model).to("cuda")
        _, cpu_eval = make_img_only_steps(cpu_model, cfg)
        _, card_eval = make_img_only_steps(card_model, cfg)
        want = cpu_eval(None, batch)
        reset_counts()
        got = card_eval(None, batch)
        torch.cuda.synchronize()
        check_launches(f"{label} eval", read_counts(),
                       trunk_launches(trunk, 0, 1, False))
        err = close(f"{label} eval logits vs CPU", got["logits"].cpu(),
                    want["logits"], TOL_SLICE)
        print(f"{label} eval: B={AUX_B} logits max_abs_err {err:.3e} "
              f"against the CPU plain path; no K1 or K2 launch")
        del card_model
        cfg = cfg.replace(batch_size=CHECK_B)
        (batch,) = vqa_batches(cfg, 1, NUM_CLASSES, SEED, 1)
        batch["keyword"] = (batch["answer"] % NUM_KEYWORDS).astype("int32")
        draws = sample_draws(CHECK_B, cfg.image_size,
                             torch.Generator().manual_seed(SEED),
                             FINETUNE_AUG)
        held_step_fp32(torch, f"{label} fp32", cpu_model, cfg, batch,
                       draws, make_img_only_steps,
                       leaves + ["head.weight", "keyword_embed.weight"],
                       stats, trunk_launches(trunk, 1, 0, False),
                       nudged="trunk.")
        del cpu_model
        torch.cuda.empty_cache()

        cfg = cfg.replace(batch_size=CLI_B)
        (batch,) = vqa_batches(cfg, 1, NUM_CLASSES, SEED)
        batch["keyword"] = (batch["answer"] % NUM_KEYWORDS).astype("int32")
        model = ImageOnlyClassifier(
            NUM_CLASSES, trunk, NUM_KEYWORDS, compute_dtype=torch.bfloat16,
            generator=torch.Generator().manual_seed(SEED))
        train_step, _ = make_img_only_steps(model, cfg)
        add_counts(launches, aux_main_path(
            torch, f"{label} bf16 B={CLI_B}", model, train_step, batch,
            trunk_launches(trunk, 1, 0, True), FINETUNE_AUG))
        del model, train_step
        torch.cuda.empty_cache()
    return launches


def feedback_phase(torch, work: str) -> dict:
    """(9c) ``MMBert`` with the feedback encoder on the default trunk
    (hidden 768, 4 layers, 8 heads of 64, memory 256): eval of two batches
    of EVAL_B on VQA in fp32, the first against the CPU plain path; one
    fp32 MLM step at B=CHECK_B, T=75, card against the CPU (bn3 scales and
    the ReLU term of ``default_train_check_fp32``), the encoder's shared
    projection, bias table and layer weights among the leaves; the bf16 VQA
    main path at B=CLI_B; ``vqa_train.main`` (bf16, one epoch) and
    ``vqa_eval.main`` with ``--transformer_model feedback-transformer`` on
    the drivers phase's fixture. K2 never launches. Returns the launches of
    eval, the main path and the CLIs."""
    import copy

    from mmvqa_tpu_torch.cli import vqa_eval, vqa_train
    from mmvqa_tpu_torch.core.config import pretrain_config, vqa_config
    from mmvqa_tpu_torch.data.images import (
        FINETUNE_AUG,
        PRETRAIN_AUG,
        sample_draws,
    )
    from mmvqa_tpu_torch.data.synthetic import mlm_batches, vqa_batches
    from mmvqa_tpu_torch.models import MMBert
    from mmvqa_tpu_torch.train.steps import (
        make_mlm_steps,
        make_vqa_eval_step,
        make_vqa_steps,
    )

    fb = "feedback-transformer"
    cfg = vqa_config(transformer_model=fb, num_classes=NUM_CLASSES)
    batches = vqa_batches(cfg, 2, NUM_CLASSES, SEED, PAD_LAST)
    cpu_model = MMBert(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(SEED))
    print(f"feedback: MMBert VQA {cfg.cnn_encoder} + {fb}, hidden "
          f"{cfg.hidden_size}, {cfg.n_layers} layers, T="
          f"{cfg.max_position_embeddings}, B={cfg.batch_size}, "
          f"{sum(p.numel() for p in cpu_model.parameters()) / 1e6:.2f} M "
          f"parameters")
    t0 = time.perf_counter()
    want = make_vqa_eval_step(cpu_model, cfg)(batches[0])
    print(f"feedback eval: CPU reference (plain path, fp32) "
          f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
    card_model = copy.deepcopy(cpu_model).to("cuda")
    del cpu_model
    reset_counts()
    outs = run_batches(torch, make_vqa_eval_step(card_model, cfg), batches,
                       "feedback fp32")[0]  # the first batch's
    launches = read_counts()
    check_launches("feedback eval", launches, dict(
        default_launches(0, 0, True), token_head=5 * len(batches),
        token_head_tf32x3=5 * len(batches)))
    err = close("feedback eval fp32 logits vs CPU", outs["logits"].cpu(),
                want["logits"], TOL_SLICE)
    print(f"feedback eval: fp32 card vs CPU logits max_abs_err {err:.3e}; "
          f"launches {launches}")
    del card_model
    torch.cuda.empty_cache()

    cfg = pretrain_config(transformer_model=fb, batch_size=CHECK_B,
                          dropout_override=0.0)
    (batch,) = mlm_batches(cfg, 1, SEED)
    draws = sample_draws(CHECK_B, cfg.image_size,
                         torch.Generator().manual_seed(SEED), PRETRAIN_AUG)
    cpu_model = MMBert(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(SEED))
    scale_bn3(torch, cpu_model)
    held_step_fp32(torch, "feedback mlm fp32", cpu_model, cfg, batch,
                   draws, make_mlm_steps, FEEDBACK_LEAVES, DEF_CHECK_STATS,
                   default_launches(1, 0, False), nudged="trans.trunk.")
    del cpu_model
    torch.cuda.empty_cache()

    cfg = vqa_config(transformer_model=fb, num_classes=NUM_CLASSES,
                     batch_size=CLI_B, mixed_precision=True, lr=TRAIN_LR)
    (batch,) = vqa_batches(cfg, 1, NUM_CLASSES, SEED)
    model = MMBert(cfg, compute_dtype=torch.bfloat16,
                   generator=torch.Generator().manual_seed(SEED))
    train_step, _ = make_vqa_steps(model, cfg)
    add_counts(launches, aux_main_path(
        torch, f"feedback vqa bf16 B={CLI_B}", model, train_step, batch,
        default_launches(1, 0, True), FINETUNE_AUG))
    del model, train_step
    torch.cuda.empty_cache()

    roco, vqa = os.path.join(work, "roco"), os.path.join(work, "vqa")
    n_train, n_val, n_test = (5 * n for n in DRV_VQA_PER_CAT)
    tr, va, te = (-(-n // CLI_B) for n in (n_train, n_val, n_test))
    run = "feedback_vqa"
    save = os.path.join(work, run)
    flags = ["--data_dir", vqa, "--num_vis", "5", "--hidden_size", "768",
             "--batch_size", str(CLI_B), "--num_workers", "4", "--vocab_file",
             os.path.join(roco, "vocab.txt"), "--mixed_precision",
             "--transformer_model", fb]
    reset_counts()
    t0 = time.perf_counter()
    with TF32Off(torch, "feedback cli vqa"):
        vqa_train.main(["--run_name", run, "--save_dir", save, "--epochs",
                        "1", *flags])
    got = read_counts()
    check_launches(f"feedback cli {run}", got,
                   default_launches(tr, va + te, True))
    (line,) = metric_lines(save, run)
    best = os.path.join(save, "MLM", run + "_loss")
    if not all(math.isfinite(line[k]) for k in (
            "train_loss", "val_loss", "test_loss")) or not os.path.exists(
            best):
        fail(f"feedback cli {run}: {line}, {os.listdir(save)}")
    print(f"feedback cli {run}: vqa_train.main --transformer_model {fb}, "
          f"{tr} train steps, {va} val and {te} test batches, "
          f"{time.perf_counter() - t0:.1f} s; train loss "
          f"{line['train_loss']:.4f}, val loss {line['val_loss']:.4f}, test "
          f"loss {line['test_loss']:.4f}, "
          f"{line['train_items_per_sec']:.1f} train items/s")
    add_counts(launches, got)
    save = os.path.join(work, "feedback_eval")
    reset_counts()
    with TF32Off(torch, "feedback cli eval"):
        vqa_eval.main(["--run_name", "eval", "--save_dir", save,
                       "--model_dir", best, *flags])
    got = read_counts()
    check_launches("feedback cli eval", got, default_launches(0, te, True))
    with open(os.path.join(save, f"{run}_loss_preds.csv"), newline="") as f:
        rows = list(csv.reader(f))
    if len(rows) != n_test + 1:
        fail(f"feedback cli eval: {len(rows) - 1} rows for {n_test} "
             f"questions")
    print(f"feedback cli eval: vqa_eval.main --transformer_model {fb}, {te} "
          f"test batches, {len(rows) - 1} prediction rows")
    add_counts(launches, got)
    torch.cuda.empty_cache()
    return launches


def supcon_encoder_phase(torch) -> dict:
    """(9d) ``SupConEncoder`` (the ``mlp`` head, 128 features) on each trunk
    at full width, 224 px, B=AUX_B: a forward in train mode (the trunk on
    batch statistics; ResNet's bn3 scales lowered as for the train checks)
    and one in eval mode, each against the CPU plain path: features within
    TOL_SLICE and of unit norm to 1e-5, the statistics the train-mode
    forward folds in within GRAD_NORMWISE of their largest entry. Counts
    exact; K1 and K2 never launch. Returns the launches."""
    import copy

    from mmvqa_tpu_torch.data.images import process_batch
    from mmvqa_tpu_torch.models import SupConEncoder

    launches: dict = {}
    gen = torch.Generator().manual_seed(SEED)
    img = torch.randint(0, 256, (AUX_B, 224, 224, 3), generator=gen,
                        dtype=torch.uint8)
    for trunk, stats in (("resnet152", RESNET_STATS),
                         ("tf_efficientnetv2_m", EFFNET_STATS)):
        label = f"supcon encoder {trunk}"
        cpu_model = SupConEncoder(
            trunk, "mlp", device="cpu",
            generator=torch.Generator().manual_seed(SEED))
        if "resnet" in trunk:
            scale_bn3(torch, cpu_model)
        card_model = copy.deepcopy(cpu_model).to("cuda")
        for mode in ("train", "eval"):
            train = mode == "train"
            cpu_model.train(train)
            card_model.train(train)
            with torch.no_grad():
                want = cpu_model(process_batch(img))
                reset_counts()
                got = card_model(process_batch(img.cuda()))
                torch.cuda.synchronize()
            counts = read_counts()
            check_launches(f"{label} {mode}", counts, trunk_launches(
                trunk, 0, 0 if train else 1, False, 1 if train else 0))
            add_counts(launches, counts)
            err = close(f"{label} {mode} features vs CPU", got.cpu(), want,
                        TOL_SLICE)
            norm = (torch.linalg.vector_norm(got.float(), dim=-1) - 1).abs()
            if not norm.max().item() <= 1e-5:
                fail(f"{label} {mode}: features off the unit sphere by "
                     f"{norm.max().item():.3e}")
            print(f"{label} {mode}: features max_abs_err {err:.3e} against "
                  f"the CPU plain path, unit norm to {norm.max().item():.1e}")
        sd_cpu, sd_card = cpu_model.state_dict(), card_model.state_dict()
        for name in stats:
            g, w = sd_card[name].cpu(), sd_cpu[name]
            e = (g - w).abs().max().item()
            if not e <= GRAD_NORMWISE * w.abs().max().item():
                fail(f"{label} {name}: max abs err {e:.3e} after the "
                     f"train-mode forward")
            print(f"{label} train: stat {name}: max_abs_err {e:.3e} of max "
                  f"{w.abs().max().item():.3e}")
        del cpu_model, card_model
        torch.cuda.empty_cache()
    return launches


def aux_phase(torch, work: str) -> dict:
    """(9) The remaining model paths: distillation, the image-only model,
    the feedback encoder and the SupCon encoder. Returns their launches."""
    t0 = time.perf_counter()
    launches: dict = {}
    for name, part in (("distill", lambda: distill_phase(torch, work)),
                       ("img_only", lambda: img_only_phase(torch)),
                       ("feedback", lambda: feedback_phase(torch, work)),
                       ("supcon_encoder",
                        lambda: supcon_encoder_phase(torch))):
        t_part = time.perf_counter()
        add_counts(launches, part())
        torch.cuda.empty_cache()
        print(f"aux {name}: {time.perf_counter() - t_part:.1f} s")
    print(f"aux phase: {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------------ (10) explain --

EXPLAIN_CHUNK = 32  # ScoreCAM's masked images and AblationCAM's reruns a call
# (a) Grad-CAM on the card against the CPU plain path, fp32, B=1: the deepest
# map after the whole trunk within 1e-3 of its largest entry (convolutions in
# another order over 57 or 50 blocks; the eval logits are held to TOL_SLICE
# after the same trunk and the encoder); the gradients, through the encoder
# and one token head backward, as the train step's leaves (GRAD_NORMWISE);
# the channel mean of their products before the ReLU likewise; the heatmap,
# in [0, 1], to the same 2e-3
EXPLAIN_ACTS_NORMWISE = 1e-3
EXPLAIN_HEAT = 2e-3


def b1_kernel_checks(torch, results) -> None:
    """(b) The kernels at the Grad-CAM CLI's shapes, fp32, untimed, each
    against its plain version with the kernel phase's tolerances and its
    error into the summary's fp32 max_abs_err: K1's forward at B=1 at every
    tap of both trunks (one split-TF32 launch a call, two runs bit for bit)
    and at B=32 (ScoreCAM's chunk; AblationCAM's at the deepest tap); K1's
    backward at B=1 at both deepest taps (K=512 and 2048); K2 forward and
    backward at B=1, T=28, 8 heads, with and without prev (a first layer and
    the others), the forward at B=32 too, one split-TF32 launch a call each
    way, two runs bit for bit; K3's forward at B=1 and B=32 at every site
    shape of EfficientNetV2-M."""
    from mmvqa_tpu_torch.models.visual_tokens import tap_positions
    from mmvqa_tpu_torch.ops.attention import (
        realformer_attention,
        realformer_attention_backward,
        realformer_attention_backward_reference,
        realformer_attention_reference,
    )
    from mmvqa_tpu_torch.ops.depthwise import (
        depthwise3x3,
        depthwise3x3_reference,
    )
    from mmvqa_tpu_torch.ops.token_head import (
        fused_token_head,
        token_head_backward,
        token_head_backward_reference,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    f32 = torch.float32

    def note(name, err):
        results[name]["err"][f32] = max(results[name]["err"][f32], err)

    worst = dict.fromkeys(("token_head", "token_head_bwd",
                           "realformer_attention", "realformer_attention_bwd",
                           "depthwise3x3"), 0.0)
    deepest = {("flagship", 7, 512), ("default", 7, 2048)}
    for model, taps in (("flagship", TAPS), ("default", DEF_TAPS)):
        for B in (1, EXPLAIN_CHUNK):
            for name, side, K in taps:
                if B > 1 and model == "default" and side != 7:
                    continue
                feat = torch.randn(B, side, side, K, device=dev, generator=g)
                x = tap_positions(feat.permute(0, 3, 1, 2))
                w = torch.randn(K, HIDDEN, device=dev, generator=g) * K ** -0.5
                label = f"B={B} {model} {name} P={side * side} K={K} fp32"
                worst["token_head"] = max(worst["token_head"], checked_k1_fwd(
                    label, x, w, "serf"))
                if B > 1 or (model, side, K) not in deepest:
                    continue
                gout = torch.randn(B, HIDDEN, device=dev, generator=g)
                tf32x3 = fused_token_head.backward_tf32x3_launches
                dx, dw = token_head_backward(x, w, gout, "serf")
                dx2, dw2 = token_head_backward(x, w, gout, "serf")
                dx_p, dw_p = token_head_backward_reference(x, w, gout, "serf")
                torch.cuda.synchronize()
                if fused_token_head.backward_tf32x3_launches - tf32x3 != 2:
                    fail(f"token_head_bwd {label}: off the split-TF32 path")
                if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
                    fail(f"token_head_bwd {label}: two runs differ")
                e = max(check_k1_bwd(label, x, dx, dw, dx_p, dw_p))
                worst["token_head_bwd"] = max(worst["token_head_bwd"], e)

    H, E, T = HEADS, HEAD_DIM, 28
    for B in (1, EXPLAIN_CHUNK):
        for with_prev in (False, True):
            kqv = torch.randn(B, T, H, 3 * E, device=dev, generator=g)
            k, q, v = kqv.split(E, dim=-1)
            prev = (torch.randn(B, H, T, T, device=dev, generator=g)
                    if with_prev else None)
            valid = torch.arange(T, device=dev)[None] < 19 + torch.arange(
                B, device=dev)[:, None] % 10
            mask = valid.float()
            label = f"B={B} T={T} prev={with_prev} fp32"
            tf32x3 = realformer_attention.tf32x3_launches
            ctx, carry = realformer_attention(q, k, v, prev, mask)
            ctx2, carry2 = realformer_attention(q, k, v, prev, mask)
            ctx_p, carry_p = realformer_attention_reference(q, k, v, prev,
                                                            mask)
            torch.cuda.synchronize()
            if realformer_attention.tf32x3_launches - tf32x3 != 2:
                fail(f"realformer_attention {label}: off the split-TF32 "
                     "path")
            if not (torch.equal(ctx, ctx2) and torch.equal(carry, carry2)):
                fail(f"realformer_attention {label}: two runs differ")
            name = f"realformer_attention {label}"
            e = max(close(name + " ctx valid", ctx[valid], ctx_p[valid],
                          TOL_K2_VALID),
                    close(name + " ctx", ctx, ctx_p, TOL_K2_PADDED),
                    close(name + " carry", carry, carry_p, TOL_K2_CARRY))
            worst["realformer_attention"] = max(
                worst["realformer_attention"], e)
            if B > 1:
                continue
            dctx = torch.randn(B, T, H, E, device=dev, generator=g)
            dcarry = (0.1 * torch.randn(B, H, T, T, device=dev, generator=g)
                      if with_prev else None)
            tf32x3 = realformer_attention.backward_tf32x3_launches
            dkqv, dprev = realformer_attention_backward(kqv, carry, dctx,
                                                        dcarry, with_prev)
            dkqv2, dprev2 = realformer_attention_backward(kqv, carry, dctx,
                                                          dcarry, with_prev)
            dq_p, dk_p, dv_p, ds_p = realformer_attention_backward_reference(
                q, k, v, carry, dctx, dcarry)
            torch.cuda.synchronize()
            if realformer_attention.backward_tf32x3_launches - tf32x3 != 2:
                fail(f"realformer_attention_bwd {label}: off the split-TF32 "
                     "path")
            if not (torch.equal(dkqv, dkqv2)
                    and (dprev is None or torch.equal(dprev, dprev2))):
                fail(f"realformer_attention_bwd {label}: two runs differ")
            name = f"realformer_attention_bwd {label}"
            e = close(name + " dkqv", dkqv, torch.cat([dk_p, dq_p, dv_p], -1),
                      TOL_K2_BWD)
            if with_prev:
                e = max(e, close(name + " dprev", dprev, ds_p, TOL_K2_BWD))
            worst["realformer_attention_bwd"] = max(
                worst["realformer_attention_bwd"], e)

    for B in (1, EXPLAIN_CHUNK):
        for (h, w_, c) in sorted(trunk_sites(B)[0]):
            x = torch.randn(B, h, w_, c, device=dev, generator=g)
            w = (torch.randn(c, 1, 3, 3, device=dev, generator=g) / 3)[
                :, 0].permute(1, 2, 0)
            y = depthwise3x3(x, w)
            y_p = depthwise3x3_reference(x, w)
            worst["depthwise3x3"] = max(worst["depthwise3x3"], close(
                f"depthwise3x3 B={B} {h}x{w_}x{c} fp32", y, y_p, TOL_K3_F32))
    for name, e in worst.items():
        note(name, e)
    print("explain kernels at B=1 (and B=32): max_abs_err " + ", ".join(
        f"{name} {e:.3e}" for name, e in worst.items()))


def explain_inputs(torch, cfg, seed: int):
    """One seeded request: a normalized (1, S, S, 3) image and a question of
    T tokens with padding."""
    import numpy as np

    rng = np.random.default_rng(seed)
    T, S = cfg.max_position_embeddings, cfg.image_size
    n = 19
    ids = np.zeros((1, T), np.int64)
    ids[0, :n] = rng.integers(1000, cfg.vocab_size, n)
    mask = (np.arange(T) < n).astype(np.float32)[None]
    seg = (np.arange(T) >= 7).astype(np.int64)[None] * mask.astype(np.int64)
    img = rng.normal(size=(1, S, S, 3)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (img, ids, seg, mask))


def explain_card_vs_cpu(torch) -> dict:
    """(a) ``grad_cam_activations`` and ``grad_cam_heatmap`` on the card
    against the same seeded model on the CPU plain path, fp32, B=1: the
    flagship and the default model (ResNet-152 + the pre-norm encoder). The
    answer explained is the first class, counting from 0, whose CPU heatmap
    is not all zero (the ReLU of a channel mean that is negative everywhere
    zeroes it, and then compares nothing); the map before the ReLU is held
    too. Returns the errors."""
    from mmvqa_tpu_torch.core.config import vqa_config
    from mmvqa_tpu_torch.explain.gradcam import (
        grad_cam_activations,
        grad_cam_heatmap,
    )
    from mmvqa_tpu_torch.models import MMBert

    errors = {}
    for label, cfg in (("flagship", flagship_vqa_config()),
                       ("default", vqa_config(num_classes=NUM_CLASSES))):
        args = explain_inputs(torch, cfg, SEED + 2)
        model = MMBert(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(SEED))
        t0 = time.perf_counter()
        for answer in range(16):
            want_heat, _ = grad_cam_heatmap(model, *args, answer)
            if want_heat.max() > 0:
                break
        else:
            fail(f"explain {label}: the CPU heatmaps of classes 0-15 are "
                 "all zero")
        want = grad_cam_activations(model, *args, answer)
        cpu_s = time.perf_counter() - t0
        model.to("cuda")
        dargs = [a.cuda() for a in args]
        grad_cam_activations(model, *dargs, answer)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = grad_cam_activations(model, *dargs, answer)
        torch.cuda.synchronize()
        card_ms = 1e3 * (time.perf_counter() - t0)
        heat, _ = grad_cam_heatmap(model, *dargs, answer)
        name = f"explain {label} (class {answer})"

        def cam(acts, grads):  # the heatmap before its ReLU and scaling
            return (acts * grads.mean(dim=(0, 1, 2))).mean(dim=-1)

        e = {"acts": close_normwise(name + " acts", got[0].cpu(), want[0],
                                    EXPLAIN_ACTS_NORMWISE),
             "grads": close_normwise(name + " grads", got[1].cpu(), want[1],
                                     GRAD_NORMWISE),
             "logits": close(name + " logits", got[2].cpu(), want[2],
                             TOL_SLICE),
             "cam": close_normwise(name + " cam", cam(*got[:2]).cpu(),
                                   cam(*want[:2]), GRAD_NORMWISE),
             "heatmap": close_normwise(name + " heatmap",
                                       torch.from_numpy(heat),
                                       torch.from_numpy(want_heat),
                                       EXPLAIN_HEAT)}
        print(f"{name}: grad_cam_activations card vs CPU, deepest map "
              f"{tuple(got[0].shape)}, max_abs_err " + ", ".join(
                  f"{k} {v:.3e}" for k, v in e.items())
              + f"; card {card_ms:.1f} ms a call, CPU {cpu_s:.1f} s")
        errors[label] = e
        del model
        torch.cuda.empty_cache()
    return errors


def explain_launches(trunks: int, k1: int, k1_bwd: int, k2: int, k2_bwd: int,
                     effnet: bool) -> dict:
    """Each counter after a Grad-CAM CLI run in fp32: ``trunks`` eval passes
    of the trunk (K3 at EfficientNetV2-M's 42 sites; ResNet-152 has none in
    eval mode), ``k1`` token-head forwards, ``k1_bwd`` backwards, ``k2`` and
    ``k2_bwd`` attention calls; every token-head and attention call on its
    split-TF32 kernel, no K3 backward, K4 or K5."""
    want = dict.fromkeys(expected_launches(0, 0, False), 0)
    want.update(token_head=k1, token_head_tf32x3=k1, token_head_bwd=k1_bwd,
                token_head_bwd_tf32x3=k1_bwd, realformer_attention=k2,
                realformer_attention_tf32x3=k2,
                realformer_attention_bwd=k2_bwd,
                realformer_attention_bwd_tf32x3=k2_bwd,
                depthwise3x3=42 * trunks if effnet else 0)
    return want


# the methods also run with --cnn_only: a gradient method (its gradients are
# tensor code there), EigenCAM, ScoreCAM (its trunk passes) and AblationCAM
# (its own ablation target, cli/grad_cam.py's --cnn_only branch); the other
# two gradient methods' --cnn_only runs, the same branch as gradcam's, were
# cut to keep the smoke within its time
CNN_ONLY_METHODS = ("gradcam", "eigencam", "scorecam", "ablationcam")


def explain_runs() -> list:
    """(model, method, --cnn_only, expected launches) of the CLI runs: each
    of the six methods on each model, and CNN_ONLY_METHODS with
    --cnn_only too. Derived
    from the code, with n the deepest map's channels over the chunk of 32
    (flagship 512 -> 16, default 2048 -> 64). A gradient method (gradcam,
    gradcam++, xgradcam) or eigencam: the trunk once (42 K3 on the
    flagship; ResNet-152 has no hand-written kernel in eval mode), the five
    token heads (K1), the encoder (K2 x 4 on the flagship's RealFormer; the
    default's BertEncoder has none), backward through the encoder (K2-bwd x
    4) and the deepest head (K1-bwd x 1): flagship K3 42, K1 5, K2 4, K2-bwd
    4, K1-bwd 1; default K1 5, K1-bwd 1. scorecam adds n full-model
    forwards at B=32 (42 K3, 5 K1, 4 K2 each); ablationcam adds n reruns
    from the tap at B=32 (1 K1, 4 K2 each). --cnn_only runs the trunk alone,
    once (flagship K3 42, default nothing), and its scorecam adds n trunk
    passes at B=32; its gradients and its ablation rerun are tensor code."""
    runs = []
    for model, effnet, n, k2 in (("flagship", True, 512 // EXPLAIN_CHUNK, 4),
                                 ("default", False, 2048 // EXPLAIN_CHUNK, 0)):
        for method in ("gradcam", "gradcam++", "xgradcam", "eigencam",
                       "scorecam", "ablationcam"):
            score = n if method == "scorecam" else 0
            ablate = n if method == "ablationcam" else 0
            runs.append((model, method, False, explain_launches(
                1 + score, 5 + 5 * score + ablate, 1,
                k2 * (1 + score + ablate), k2, effnet)))
            if method in CNN_ONLY_METHODS:
                runs.append((model, method, True, explain_launches(
                    1 + score, 0, 0, 0, 0, effnet)))
    return runs


def explain_clis(torch, work: str) -> dict:
    """(c) ``cli.grad_cam.main`` end to end on the drivers phase's VQA-Med
    fixture, fp32 at B=1 (ScoreCAM and AblationCAM in chunks of 32), with
    seeded weights (a state dict, as ``save_weights`` writes): every run of
    ``explain_runs`` with its counters set to 0 before and held to their
    derived counts after, its printed lines, and its file
    (``<category>_<vqa_img>``) decoded by the port to the 224 px image's
    size; each run's wall time. Returns the launches of all runs."""
    from mmvqa_tpu_torch.cli import common, grad_cam
    from mmvqa_tpu_torch.data.datasets import (
        build_answer_vocab,
        load_vqa_data,
    )
    from mmvqa_tpu_torch.data.jpeg import read_rgb
    from mmvqa_tpu_torch.models import MMBert

    vqa = os.path.join(work, "vqa")
    out = os.path.join(work, "explain")
    img, category = "synpic_train_organ_0.jpg", "organ"
    base = ["--data_dir", vqa, "--vocab_file",
            os.path.join(work, "roco", "vocab.txt"), "--vqa_img", img,
            "--category", category, "--mode", "Train"]
    models = {"flagship": [], "default": ["--cnn_encoder", "resnet152",
                                          "--transformer_model",
                                          "transformer"]}
    weights = {}
    for label, flags in models.items():
        # the CLI's own config: its parser, the vocabulary, the answers
        args = grad_cam.build_parser().parse_args(base + flags
                                                  + ["--model_dir", "m"])
        cfg = common.config_from_args(args).replace(category=None)
        cfg = common.load_tokenizer(cfg)[1]
        n = build_answer_vocab(*load_vqa_data(cfg))[4]
        model = MMBert(cfg.replace(num_classes=n), device="cpu",
                       generator=torch.Generator().manual_seed(SEED + 3))
        weights[label] = os.path.join(out, f"{label}.pt")
        os.makedirs(out, exist_ok=True)
        torch.save(model.state_dict(), weights[label])
        del model
    launches: dict = {}
    for label, method, cnn_only, want in explain_runs():
        save = os.path.join(out, f"{label}_{method}{'_cnn' * cnn_only}")
        argv = base + models[label] + [
            "--model_dir", weights[label], "--save_dir", save, "--method",
            method] + (["--cnn_only"] if cnn_only else [])
        run = f"{label} {method}{' --cnn_only' if cnn_only else ''}"
        reset_counts()
        t0 = time.perf_counter()
        with TF32Off(torch, f"explain cli {run}"), Tee() as tee:
            grad_cam.main(argv)
        wall = time.perf_counter() - t0
        got = read_counts()
        check_launches(f"explain cli {run}", got, want)
        lines = tee.text.splitlines()[-4:]
        heads = ["question", "answer",
                 "target feature channel" if cnn_only else "preds", "saved"]
        path = os.path.join(save, f"{category}_{img}")
        if [x.split(":")[0] for x in lines] != heads or not lines[
                -1].endswith(path):
            fail(f"explain cli {run}: printed {lines}")
        shape = read_rgb(path).shape
        if shape != (224, 224, 3):
            fail(f"explain cli {run}: {path} decodes to {shape}")
        print(f"explain cli {run}: {wall:.2f} s wall, {path} "
              f"{os.path.getsize(path)} bytes; launches " + ", ".join(
                  f"{k} {v}" for k, v in got.items() if v))
        add_counts(launches, got)
        torch.cuda.empty_cache()
    return launches


def explain_phase(torch, results, work: str):
    """(10) Grad-CAM and the CAM zoo: the committed progressive JPEG's
    decode digest, the kernels at B=1, Grad-CAM card vs CPU on both models,
    then the CLI runs. Returns (launches, errors of (a))."""
    t0 = time.perf_counter()
    digest = progressive_digest(os.path.join(ROOT, PROGRESSIVE_JPEG))
    if digest != PROGRESSIVE_DIGEST:
        fail(f"explain: progressive JPEG's digest {digest}, pinned "
             f"{PROGRESSIVE_DIGEST}")
    print(f"explain: {PROGRESSIVE_JPEG} decodes to the pinned digest")
    b1_kernel_checks(torch, results)
    errors = explain_card_vs_cpu(torch)
    launches = explain_clis(torch, work)
    print(f"explain phase: {time.perf_counter() - t0:.1f} s")
    return launches, errors


# the layouts phase (11): the CLIs' global batch over every layout, one
# step each at full width in fp32; a spawned world's time limit
LAYOUT_B = CLI_B
LAYOUT_TIMEOUT = 420
# the gradient's global norm (and the clip's) on the card, relative: the
# leaves' own entries differ by up to 3e-4 of their largest on the H100; a
# norm of partial gradients or one counted twice is off by tens of percent
LAYOUT_NORM_TOL = 1e-3
LAYOUT_PAD = 3  # the global batch's padded samples: the data ranks hold
# different sums of weights
VQA_LEAVES = CHECK_LEAVES[:-1] + ["fc1.weight", "classifier_0.weight",
                                  "classifier_2.weight"]
# the feedback encoder's split and replicated leaves in place of the
# RealFormer's
FEEDBACK_TP_LEAVES = [k for k in CHECK_LEAVES if ".block_" not in k] + [
    f"encoder.segment.{k}" for k in (
        "shared_kv.weight", "to_q_0.weight", "to_out_3.weight",
        "ff_0.w_in.weight", "ff_3.w_out.weight", "rel_bias.weight",
        "layer_weight")]


def stacked_keys(keys):
    """The pipelined model's names of the sequential model's keys
    (``parallel.pipeline.stacked_key``), each once."""
    from mmvqa_tpu_torch.parallel.pipeline import stacked_key

    return list(dict.fromkeys(stacked_key(k) for k in keys))


def layout_jobs(torch):
    """{world size: {name: ``parallel.world.layout_step`` job}}: the
    flagship's and the default model's full-width fp32 steps at the CLIs'
    B=LAYOUT_B, T=75 (VQA: 28), 224 px. Two worlds of two ranks run side by
    side with the worlds of three and four. A job's ``ref`` names the
    layout whose single-process step is its reference too (the same model
    and batch: the ring and the gathered encoder run as one process at
    cp = 1)."""
    import numpy as np

    from mmvqa_tpu_torch.core.config import pretrain_config, supcon_config
    from mmvqa_tpu_torch.data.synthetic import mlm_batches, vqa_batches

    # --watch: the per-module norms of the reduced gradient, held per rank
    over = dict(batch_size=LAYOUT_B, dropout_override=0.0, watch=True)
    mlm_cfg = flagship_mlm_config(**over)
    mlm = mlm_batches(mlm_cfg, 1, SEED, pad_last=LAYOUT_PAD)[0]
    sup_cfg = supcon_config(cnn_encoder="tf_efficientnetv2_m",
                            transformer_model="realformer", **over)
    b0, b1 = mlm_batches(sup_cfg, 2, SEED + 1, pad_last=LAYOUT_PAD)[::-1]
    sup = dict(b0, aug_tokens=(b1["tokens"] * b0["input_mask"]).astype(
        np.int32), aug_labels=(b1["labels"] * b0["input_mask"]).astype(
        np.int32))
    vqa_cfg = flagship_vqa_config(**over)
    vqa = vqa_batches(vqa_cfg, 1, NUM_CLASSES, SEED, pad_last=LAYOUT_PAD)[0]
    def_cfg = pretrain_config(**over)
    keep = CHECK_LEAVES + CHECK_STATS
    def_keep = DEF_CHECK_LEAVES + DEF_CHECK_STATS
    flag = dict(cfg=mlm_cfg, kind="mlm", batch=mlm, keep=keep)
    default = dict(cfg=def_cfg, kind="mlm", batch=mlm, keep=def_keep,
                   bn3_scale=DEF_CHECK_BN3_SCALE)
    pp_flag = dict(flag, cfg=flagship_mlm_config(pp_size=2, **over),
                   keep=stacked_keys(keep))
    ring = dict(attention_impl="ring")
    two = {
        "dp2": dict(flag, dp=2, tp=1, fsdp=False),
        "dp2 fsdp": dict(flag, dp=2, tp=1, fsdp=True),
        "tp2": dict(flag, dp=1, tp=2, fsdp=False),
        "default dp2": dict(default, dp=2, tp=1, fsdp=False),
        "supcon dp2": dict(cfg=sup_cfg, kind="supcon", batch=sup, dp=2, tp=1,
                           fsdp=False, keep=SUPCON_LEAVES + CHECK_STATS),
        "vqa tp2 clip": dict(cfg=vqa_cfg, kind="vqa", batch=vqa, dp=1, tp=2,
                             fsdp=False, clip=True,
                             keep=VQA_LEAVES + CHECK_STATS),
    }
    two_more = {
        "pp2": dict(pp_flag, dp=1, tp=1, pp=2, fsdp=False),
        "default pp2": dict(default, cfg=pretrain_config(pp_size=2, **over),
                            keep=stacked_keys(def_keep), dp=1, tp=1, pp=2,
                            fsdp=False),
        "vqa cp2 ring clip": dict(
            cfg=flagship_vqa_config(**over, **ring), kind="vqa", batch=vqa,
            dp=1, tp=1, cp=2, fsdp=False, clip=True,
            keep=VQA_LEAVES + CHECK_STATS, ref="vqa tp2 clip"),
    }
    three = {
        "cp3 ring": dict(flag, cfg=flagship_mlm_config(**over, **ring), dp=1,
                         tp=1, cp=3, fsdp=False, ref="dp2"),
        "cp3": dict(flag, dp=1, tp=1, cp=3, fsdp=False, ref="dp2"),
        "default cp3": dict(default, dp=1, tp=1, cp=3, fsdp=False,
                            ref="default dp2"),
    }
    four = {"dp2 x tp2 fsdp": dict(flag, dp=2, tp=2, fsdp=True),
            "dp2 x pp2": dict(pp_flag, dp=2, tp=1, pp=2, fsdp=False,
                              ref="pp2")}
    # the flagship's trunk with the feedback encoder (4 layers, 8 heads of
    # 64, T=75 in 38 windows), its heads and memory split over 'model'
    feedback = {"feedback tp2": dict(
        flag, cfg=pretrain_config(cnn_encoder="tf_efficientnetv2_m",
                                  transformer_model="feedback-transformer",
                                  **over),
        keep=FEEDBACK_TP_LEAVES + CHECK_STATS, dp=1, tp=2, fsdp=False)}
    return {"2": two, "2b": two_more, "2f": feedback, "3": three,
            "4": four}


def layout_reference(torch, job, nudge=False, device="cuda"):
    """The job's step in this process on the card, no mesh: the reference
    (``parallel.world.single_step``); with ``nudge`` every K4 output moved
    by a relative DEF_CHECK_NUDGE (``held_step_fp32``'s twin)."""
    from mmvqa_tpu_torch.models import effnetv2
    from mmvqa_tpu_torch.parallel.world import single_step

    kernel = effnetv2.conv1x1_stats
    if nudge:
        gen = torch.Generator(device=device).manual_seed(SEED)

        def nudged(x, w):
            y, st = kernel(x, w)
            noise = torch.randn(y.shape, device=y.device, generator=gen)
            return y * (1.0 + DEF_CHECK_NUDGE * noise), st

        effnetv2.conv1x1_stats = nudged
    try:
        return single_step(job, device)
    finally:
        effnetv2.conv1x1_stats = kernel
        torch.cuda.empty_cache()


def check_layout(torch, name, job, ranks, ref, allow) -> None:
    """A layout's ranks against the single process on the card: the loss
    to 1e-4 relative, each kept gradient leaf and running statistic to
    GRAD_NORMWISE of its largest entry (plus ``allow``), the gradient's
    global norm (and under ``clip`` the clip's) to LAYOUT_NORM_TOL
    relative, each kept parameter's change in the update to
    ``world.update_problems``' 2% of lr at the entries whose gradient lies
    beyond twice its own tolerance (Adam's first step moves an entry by
    about lr whatever its gradient's size, so a closer entry may step
    either way: those are counted and printed), the same state on every
    rank, the kernel sites' local shapes and the exact launch counts."""
    import numpy as np

    from mmvqa_tpu_torch.parallel.world import (
        expected_launches as rank_launches,
        site_problems,
        update_problems,
    )
    from mmvqa_tpu_torch.train.state import CLIP_NORM

    r0 = ranks[0]
    err = abs(r0["loss"] - ref["loss"])
    if not err <= 1e-4 * abs(ref["loss"]):
        fail(f"layouts {name}: loss {r0['loss']:.6f}, single process "
             f"{ref['loss']:.6f}")
    norms = ("grad_norm", "clip_norm") if job.get("clip") else ("grad_norm",)
    for what in norms:
        for r in ranks:
            e = abs(r[what] - ref[what])
            if not e <= LAYOUT_NORM_TOL * ref[what]:
                fail(f"layouts {name} rank {r['rank']}: {what} {r[what]:.6e}"
                     f", single process {ref[what]:.6e}")
    # --watch: each module's norm of the reduced gradient, on every rank
    watched = {k: float(v) for k, v in ref["metrics"].items()
               if k.startswith("gnorm/")}
    if job["kind"] != "vqa" and len(watched) < 7:
        fail(f"layouts {name}: the single process logged {sorted(watched)}")
    module_err = 0.0
    for r in ranks:
        got = {k: float(v) for k, v in r["metrics"].items()
               if k.startswith("gnorm/")}
        if got.keys() != watched.keys():
            fail(f"layouts {name} rank {r['rank']}: gnorm {sorted(got)}, "
                 f"single process {sorted(watched)}")
        for k, want in watched.items():
            e = abs(got[k] - want) / want
            if not e <= LAYOUT_NORM_TOL:
                fail(f"layouts {name} rank {r['rank']}: {k} {got[k]:.6e}, "
                     f"single process {want:.6e}")
            module_err = max(module_err, e)
    worst, grad_tol = [], {}
    for kind in ("grads", "state"):
        for k, want in ref[kind].items():
            w = np.asarray(want, np.float64)
            g = np.asarray(r0[kind][k], np.float64)
            if not np.isfinite(g).all():
                fail(f"layouts {name}: {kind} {k} not finite")
            lim = GRAD_NORMWISE * float(np.abs(w).max()) + allow.get(k, 0.0)
            if kind == "grads":
                grad_tol[k] = lim
            elif k in ref["grads"]:
                continue  # a parameter: its change is held below
            e = float(np.abs(g - w).max())
            if e > lim:
                fail(f"layouts {name}: {kind} {k}: max abs err {e:.3e} "
                     f"beyond {lim:.3e}")
            worst.append((e / max(lim, 1e-30), kind, k, e))
    ratio, kind, k, e = max(worst)
    lr = job.get("lr", job["cfg"].lr)
    scale = (min(1.0, CLIP_NORM / ref["clip_norm"]) if job.get("clip")
             else 1.0)
    problems, held, dropped = update_problems(
        ref["before"], r0["state"], ref["state"], ref["grads"], lr, scale,
        grad_tol)
    if problems:
        fail(f"layouts {name}: the update: {problems[0]}")
    if not held:
        fail(f"layouts {name}: the update held at no entry, {dropped} "
             "dropped")
    for r in ranks[1:]:
        if r["digest"] != r0["digest"] or r["loss"] != r0["loss"]:
            fail(f"layouts {name}: rank {r['rank']} holds another state "
                 "than rank 0 after the step")
    dp, tp = job["dp"], job["tp"]
    k4_sites = len([1 for x, w in ref["sites"]["K4"]
                    if tp == 1 or w[1] > w[0]])
    want = dict(ref["launches"])
    if tp > 1 and want["conv1x1_stats"]:  # (the CPU launches none)
        want.update(conv1x1_stats=k4_sites, conv1x1_stats_tf32x3=k4_sites,
                    conv1x1_stats_tma=0)
    for r in ranks:
        problems = site_problems(ref["sites"], r["sites"], dp, tp, job)
        if problems:
            fail(f"layouts {name} rank {r['rank']}: {problems[0]}")
        if r["rest_problems"]:  # FSDP: the blocks alone at rest
            fail(f"layouts {name} rank {r['rank']}: at rest "
                 f"{r['rest_problems'][:2]}")
        memory = [m[:2] + (m[2] // tp,) for m in ref["sites"]["memory"]]
        if r["sites"]["memory"] != [(m[0] // dp,) + m[1:] for m in memory]:
            fail(f"layouts {name} rank {r['rank']}: the feedback memory "
                 f"{r['sites']['memory'][:1]}, single process "
                 f"{ref['sites']['memory'][:1]}")
        check_launches(f"layouts {name} rank {r['rank']}", r["launches"],
                       rank_launches(want, job, r["coords"]))
    print(f"layouts {name}: loss {r0['loss']:.6f} (single process "
          f"{ref['loss']:.6f}, err {err:.2e}); {len(worst)} leaves held, the "
          f"closest to its limit {kind} {k} at {e:.2e} ({ratio:.2f} of it); "
          f"{', '.join(f'{w} {r0[w]:.6e} ({ref[w]:.6e})' for w in norms)}; "
          + (f"{len(watched)} module norms on every rank within "
             f"{module_err:.1e} relative; " if watched else "")
          + f"the update held at {held} entries, {dropped} dropped; "
          f"every rank's state equal; K1 C={r0['sites']['K1'][0][1][1]}, "
          f"K2 H={r0['sites']['K2'][0][2] if r0['sites']['K2'] else '-'}, "
          f"K4 sites {k4_sites}; launches by rank coordinates (data, model, "
          f"context, pipe): "
          f"{ {tuple(r['coords']): {k: v for k, v in r['launches'].items() if v} for r in ranks} }")


def layout_costs(name, ranks, ref, card) -> None:
    """A layout's peak memory a rank beside the single process's and the
    bytes its checked step staged through host memory (the step times are
    ``mmvqa_tpu_torch/tools/time_layouts.py``'s: here the worlds share the
    card with each other and with the CLI run)."""
    mib = 2.0 ** 20
    peaks = ", ".join(f"{r['peak_bytes'] / mib:.0f}" for r in ranks)
    held = ", ".join(f"{r['held_bytes'] / mib:.0f}" for r in ranks)
    rest = ", ".join(f"{r['rest_bytes'] / mib:.0f}" for r in ranks)
    fsdp = sum(n for n, _, _ in ranks[0]["fsdp_leaves"].values())
    print(f"layouts {name} [{card}]: the step's peak above what a rank held "
          f"before it, MiB {peaks} (single process "
          f"{ref['peak_bytes'] / mib:.0f}), held before it {held}, at rest "
          f"after it (with Adam's moments) {rest} (single process "
          f"{ref['rest_bytes'] / mib:.0f}); FSDP blocks a rank "
          f"{fsdp * 4 / mib:.0f} MiB of parameters; staged "
          f"through host memory "
          f"{sum(r['staged_bytes'] for r in ranks) / 1e6:.1f} MB in "
          f"{sum(r['staged_calls'] for r in ranks)} calls (all ranks, the "
          "checked step)")


def layouts_cli_start(work: str, name: str, flags: list):
    """Start ``cli/roco_train.py`` with ``flags`` under torchrun on the CLI
    phase's fixture, two ranks sharing the card, one epoch; returns
    (process, save dir, log paths, start time, name)."""
    save = os.path.join(work, f"layouts_{name}")
    os.makedirs(save, exist_ok=True)
    logs = (os.path.join(save, "stdout.txt"), os.path.join(save, "stderr.txt"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "mmvqa_tpu_torch.cli.roco_train",
           "-r", "layouts", "--data_dir", os.path.join(work, "roco"),
           "--save_dir", save, "--epochs", "1", *CLI_ARGS, *flags,
           *LAYOUT_CLI_WATCH,
           # two loader workers a rank: the worlds share the host's cores
           "--num_workers", "2"]
    with open(logs[0], "w") as out, open(logs[1], "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=err)
    return proc, save, logs, time.perf_counter(), name


def cli_watch_check(what: str, line: dict, hists: dict, cfg) -> dict:
    """A CLI run's watch output under a layout: rank 0's epoch ``line``
    holds each module's norm (``--watch``), finite and positive, and its
    one histogram pass (``--watch_histograms``) an entry a parameter's
    gradient and weight under the single process's name (the sequential
    encoder's layers where ``cfg`` stacks them), each counting the full
    tensor's elements. Returns the norms."""
    from mmvqa_tpu_torch.bridge import flax_names
    from mmvqa_tpu_torch.models import MMBert

    gnorms = {k: v for k, v in line.items() if k.startswith("gnorm/")}
    if len(gnorms) < 7 or not all(math.isfinite(v) and v > 0
                                  for v in gnorms.values()):
        fail(f"{what}: rank 0 logged {gnorms}")
    seq = MMBert(cfg.replace(pp_size=1), device="cpu")
    names = flax_names(seq)
    want = {f"{kind}/{names[k]}": p.numel()
            for k, p in seq.named_parameters() for kind in ("ghist", "whist")}
    if hists.keys() != want.keys():
        fail(f"{what}: {len(hists)} histograms, names "
             f"{sorted(set(hists) ^ set(want))[:4]} differ")
    bad = [k for k, h in hists.items() if sum(h["counts"]) != want[k]]
    if bad:
        fail(f"{what}: {bad[0]} counts {sum(hists[bad[0]]['counts'])} "
             f"elements, not {want[bad[0]]}")
    return gnorms


def layouts_cli_finish(torch, started, work: str) -> None:
    """Wait for a CLI run: rank 0 alone logged one epoch and saved the
    weights, which are one process's file of that layout. The pipeline's
    (pp2) stack the encoder's four layers; a single-process ``vqa_train``
    (bf16, one epoch) takes them up through ``adapt_encoder_layout`` into
    its sequential encoder: every tensor but ``classifier_2``. Each run
    also logs the module norms (``--watch``) and writes one histogram
    pass (``--watch_histograms``), each entry counting its full tensor's
    elements."""
    from mmvqa_tpu_torch.cli import vqa_train
    from mmvqa_tpu_torch.models import MMBert
    from mmvqa_tpu_torch.train import checkpoint

    proc, save, logs, t0, name = started
    try:
        code = proc.wait(timeout=LAYOUT_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"layouts cli {name}: torchrun still running after "
             f"{LAYOUT_TIMEOUT} s")
    wall = time.perf_counter() - t0
    stdout, stderr = (open(path).read() for path in logs)
    if code != 0:
        fail(f"layouts cli {name}: torchrun exited {code}:\n"
             f"{stdout[-2000:]}\n{stderr[-3000:]}")
    lines = metric_lines(save, "layouts")
    weights = os.path.join(save, "MLM", "layouts")
    epochs = [x for x in lines if "histograms" not in x]
    hists = [x["histograms"] for x in lines if "histograms" in x]
    if len(epochs) != 1 or len(hists) != 1 or not os.path.exists(weights):
        fail(f"layouts cli {name}: {len(epochs)} epoch lines, {len(hists)} "
             f"histogram lines, weights {os.path.exists(weights)}")
    line = epochs[0]
    if not all(math.isfinite(line[k]) for k in ("epoch_train_loss",
                                                "epoch_val_loss")):
        fail(f"layouts cli {name}: non-finite metric in {line}")
    loaded = checkpoint.load_weights(weights)
    pp = 2 if name == "pp2" else 1
    cfg = flagship_mlm_config(pp_size=pp, vocab_size=len(
        loaded["bert_embedding.word_embeddings.weight"]))
    checkpoint.check_compatible(MMBert(cfg, device="cpu").state_dict(),
                                loaded, what=f"layouts cli {name}")
    gnorms = cli_watch_check(f"layouts cli {name}", line, hists[0], cfg)
    shown = [ln for ln in stdout.splitlines() if "[mmvqa]" in ln]
    print(f"layouts cli {name}: torchrun roco_train {' '.join(LAYOUT_CLI_WATCH)}"
          f", 1 epoch at global B={CLI_B}, {wall:.1f} s beside the worlds; "
          f"train loss {line['epoch_train_loss']:.4f}, val loss "
          f"{line['epoch_val_loss']:.4f}; {len(gnorms)} module norms "
          f"{ {k: round(v, 4) for k, v in gnorms.items()} }; {len(hists[0])} "
          f"histograms, each of its full tensor's elements; rank 0's lines "
          f"{shown[:3]}")
    if pp == 1:
        return
    stacked = loaded["encoder.pp_layers.kqv.weight"]
    if stacked.shape[0] != cfg.n_layers:
        fail(f"layouts cli {name}: the file stacks {stacked.shape[0]} "
             f"layers, not {cfg.n_layers}")
    vqa = os.path.join(work, "vqa")
    n_train, n_val, n_test = (5 * n for n in DRV_VQA_PER_CAT)
    tr, va, te = (-(-n // CLI_B) for n in (n_train, n_val, n_test))
    run = "vqa_from_pp2"
    reset_counts()
    t0 = time.perf_counter()
    with TF32Off(torch, f"layouts cli {run}"), Tee() as out:
        vqa_train.main(["--run_name", run, "--save_dir",
                        os.path.join(work, run), "--epochs", "1",
                        "--use_pretrained", "--model_dir", weights,
                        "--data_dir", vqa, "--num_vis", "5", "--hidden_size",
                        "768", *CLI_ARGS[2:], "--vocab_file",
                        os.path.join(work, "roco", "vocab.txt"),
                        "--mixed_precision"])
    got = read_counts()
    check_launches(f"layouts cli {run}", got,
                   expected_launches(tr, va + te, True))
    moved = [x for x in out.text.splitlines()
             if x.startswith("[mmvqa] transferred ")]
    n_ok, n_all = (int(x) for x in moved[0].split()[2].split("/"))
    by_loss = checkpoint.load_weights(os.path.join(work, run, "MLM",
                                                   run + "_loss"))
    if n_all - n_ok != 2 or "encoder.block_3.kqv.weight" not in by_loss:
        fail(f"layouts cli {run}: {moved[0]}; want every tensor but "
             "classifier_2 taken up by a sequential encoder")
    # the sequential model's first training step began at the stacked
    # file's layers (the update moved them by about lr)
    moved_by = float((by_loss["encoder.block_3.kqv.weight"]
                      - stacked[3]).abs().max())
    if not moved_by < 0.05:
        fail(f"layouts cli {run}: block_3.kqv moved {moved_by:.3e} from the "
             "pipelined file's layer 3")
    print(f"layouts cli {run}: single-process vqa_train took up the "
          f"pipeline-stacked file ({n_ok}/{n_all} tensors through "
          f"adapt_encoder_layout; block_3.kqv within {moved_by:.2e} of the "
          f"file's layer 3 after the epoch), "
          f"{time.perf_counter() - t0:.1f} s")


# the layouts phase's two stages: the worlds that run side by side and the
# pretraining CLI started with them under torchrun
LAYOUT_STAGES = ((("2", "2f", "3"), ("dp2 fsdp", ["--dp_size", "2",
                                                  "--fsdp"])),
                 (("2b", "4"), ("pp2", ["--pp_size", "2"])))
# the CLI runs' watch flags: the module norms in the epoch's line and one
# histogram pass under the layout
LAYOUT_CLI_WATCH = ["--watch", "--watch_histograms"]


def layouts_start(torch, work: str, device: str = "cuda:0") -> dict:
    """The layouts phase's start: NCCL's collectives with one rank, then
    the first stage's worlds and CLI started (they run on while this process
    goes on with other work, the explain phase in ``main``)."""
    from mmvqa_tpu_torch.parallel.world import collectives_probe, run_world

    t_phase = time.perf_counter()
    folder = os.path.join(work, "layouts")
    os.makedirs(folder, exist_ok=True)
    if device != "cpu":
        nccl = run_world(collectives_probe, 1, (),
                         os.path.join(folder, "nccl"), device, 120,
                         backend="nccl")[0]
        if not nccl["ok"] or nccl["backend"] != "nccl" \
                or nccl["staged_calls"]:
            fail(f"layouts: the NCCL collectives with one rank: {nccl}")
        print(f"layouts: NCCL's three collectives with one rank on the card "
              f"are right and staged nothing ({nccl})")
    worlds_jobs = layout_jobs(torch)
    return {"t_phase": t_phase, "folder": folder, "jobs": worlds_jobs,
            "device": device,
            "stages": [layouts_stage_start(worlds_jobs, LAYOUT_STAGES[0],
                                           work, folder, device)]}


def layouts_next(started: dict, work: str) -> None:
    """Start the next stage of ``layouts_start``'s phase, once the card's
    memory has room for it (the previous stage's ranks have ended)."""
    stages = started["stages"]
    worlds, cli_run = stages[-1]
    for jobs, world in worlds:
        world.wait_done()
    if cli_run is not None:
        try:
            cli_run[0].wait(timeout=LAYOUT_TIMEOUT)
        except subprocess.TimeoutExpired:
            pass  # layouts_cli_finish fails it
    stages.append(layouts_stage_start(
        started["jobs"], LAYOUT_STAGES[len(stages)], work, started["folder"],
        started["device"]))


def layouts_stage_start(worlds_jobs, stage, work, folder, device):
    """Start a stage's worlds and its CLI: (worlds, CLI run or None)."""
    from mmvqa_tpu_torch.parallel.world import run_jobs, start_world

    keys, cli = stage
    worlds = [(worlds_jobs[key], start_world(
                  run_jobs, int(key[0]), (list(worlds_jobs[key].values()),),
                  os.path.join(folder, f"world{key}"), device))
              for key in keys]
    return worlds, (layouts_cli_start(work, *cli) if device != "cpu"
                    else None)


def layouts_phase(torch, work: str, device: str = "cuda:0",
                  started=None) -> dict:
    """(11) The multi-GPU layouts on ranks that share the card (gloo; NCCL
    refuses two ranks on one device): the NCCL path's collectives once with
    one rank; then, in two stages, the two worlds of two, the world of
    three, the world of four and two pretraining CLIs under torchrun
    (``--dp_size 2 --fsdp``, then ``--pp_size 2``) run side by side while
    this process takes the single process's steps on the card (the stages
    may have been started by ``layouts_start`` and ``layouts_next`` beside
    other phases); each layout's step is held to those (``check_layout``) and its
    memory and staged bytes printed; the pipeline's checkpoint is taken up
    by a single-process ``vqa_train``. Nothing here is timed
    (``mmvqa_tpu_torch/tools/time_layouts.py`` times the layouts one at a
    time). Returns the ranks' launches of the checked steps, summed."""
    import numpy as np

    t_rest = time.perf_counter()
    started = started or layouts_start(torch, work, device)
    t_phase, folder = started["t_phase"], started["folder"]
    card = card_line()
    worlds_jobs = started["jobs"]
    every = {name: job for jobs in worlds_jobs.values()
             for name, job in jobs.items()}
    refs, by_step, launches = {}, {}, {}
    allow = {}
    # two stages, so that the card's memory holds every rank's step: the
    # worlds of two and three and the FSDP CLI, then the second world of
    # two, the world of four and the pipeline's CLI; this process takes the
    # single-process steps of each stage's layouts beside its worlds
    for i_stage, (stage, _) in enumerate(LAYOUT_STAGES):
        if len(started["stages"]) <= i_stage:
            layouts_next(started, work)
        worlds, cli_run = started["stages"][i_stage]
        t0 = time.perf_counter()
        for key in stage:
            for name, job in worlds_jobs[key].items():
                # layouts of one model and batch share one single-process
                # step
                base = job.get("ref", name)
                k = (job["kind"], id(every[base]["cfg"]), id(job["batch"]))
                if k not in by_step:
                    by_step[k] = layout_reference(torch, every[base],
                                                  device=device)
                refs[name] = by_step[k]
        if not allow:
            twin = layout_reference(torch, every["default dp2"], nudge=True,
                                    device=device)
            allow = {k: DEF_CHECK_FLIPS * float(np.abs(
                         twin["grads"][k].numpy() - g.numpy()).max())
                     for k, g in refs["default dp2"]["grads"].items()
                     if k.startswith("trans.trunk.")}
        print(f"layouts: single-process references of worlds {stage} on "
              f"the card, {time.perf_counter() - t0:.1f} s beside them")
        for jobs, world in worlds:
            outs = world.results(LAYOUT_TIMEOUT)
            print(f"layouts: world of {world.size} ranks on {device} (gloo), "
                  f"{len(jobs)} layouts, done "
                  f"{time.perf_counter() - t_phase:.1f} s into the phase")
            for i, (name, job) in enumerate(jobs.items()):
                ranks = [o[i] for o in outs]
                if any(r["jax_modules"] for r in ranks):
                    fail(f"layouts {name}: a rank imported "
                         f"{ranks[0]['jax_modules']}")
                check_layout(torch, name, job, ranks, refs[name],
                             allow if name.startswith("default") else {})
                layout_costs(name, ranks, refs[name], card)
                for r in ranks:
                    add_counts(launches, r["launches"])
        if cli_run is not None:
            layouts_cli_finish(torch, cli_run, work)
        torch.cuda.empty_cache()
    print(f"layouts phase: {time.perf_counter() - t_phase:.1f} s since its "
          f"start, {time.perf_counter() - t_rest:.1f} s after the phases "
          "it ran beside")
    return launches


def phase_time(name: str, t0: float) -> float:
    """Print a phase's seconds since ``t0``; returns the clock now."""
    now = time.perf_counter()
    print(f"{name} phase: {now - t0:.1f} s")
    return now


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, ROOT)
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
          f"{os.path.relpath(path, ROOT)}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kernels = kernel_phase(torch)
    t0 = phase_time("kernel", t0)
    eval_launches = slice_phase(torch)
    t0 = phase_time("slice", t0)
    train_launches = train_phase(torch)
    torch.cuda.empty_cache()
    t0 = phase_time("train", t0)
    finetune_launches = finetune_phase(torch)
    torch.cuda.empty_cache()
    phase_time("finetune", t0)
    import shutil

    work = os.path.join(ROOT, "_checkpoints", "cli")
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        cli_launches = cli_phase(torch, work)
        phase_time("cli", t0)
        t0 = time.perf_counter()
        driver_launches = drivers_phase(torch, work)
        print(f"drivers phase: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        default_launches_ = default_phase(torch, kernels, work)
        torch.cuda.empty_cache()
        # the layouts' stages run in their own processes beside the remaining
        # paths' phase and the explain phase (the smoke's time; nothing
        # there is timed for a claim)
        layouts = layouts_start(torch, work)
        aux_launches = aux_phase(torch, work)
        torch.cuda.empty_cache()
        layouts_next(layouts, work)
        explain_launches_, explain_errors = explain_phase(torch, kernels,
                                                          work)
        torch.cuda.empty_cache()
        layout_launches = layouts_phase(torch, work, started=layouts)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # launches: the counts read after each main path's run, counters set to
    # 0 just before it (the eval slice's forwards, the train epoch, the
    # fine-tune epoch, the CLI's two runs, the drivers' eight runs, the
    # default model's eval, bf16 epoch and four CLI runs, the remaining
    # paths' main paths, eval and CLI runs, the Grad-CAM CLI's runs).
    # ms, plain_ms, bound_ms, library_ms: at the train path's shapes in bf16,
    # B=TRAIN_B, summed over the calls of one pass (the trunk's kernels:
    # every site of a step, inputs not in the L2 cache); bound_by: what
    # binds the largest. The five _tf32x3 rows are fp32's, bounds on the
    # tensor cores: K1's five taps, forward and backward, at B=CLI_B, K2's
    # layer at T=75, B=CLI_B, prev and mask, both ways, K4's 98 sites at
    # B=TRAIN_B.
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1],
         "launches": (eval_launches.get(name, 0) + train_launches[name]
                      + finetune_launches[name] + cli_launches[name]
                      + driver_launches[name]
                      + default_launches_[name] + aux_launches[name]
                      + explain_launches_[name]
                      + layout_launches.get(name, 0)),
         "launches_eval": eval_launches.get(name, 0),
         "launches_train": train_launches[name],
         "launches_finetune": finetune_launches[name],
         "launches_cli": cli_launches[name],
         "launches_drivers": driver_launches[name],
         "launches_default": default_launches_[name],
         "launches_aux": aux_launches[name],
         "launches_explain": explain_launches_[name],
         "launches_layouts": layout_launches.get(name, 0),
         "max_abs_err": max(r["err"].values()),
         "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": sum(ms for ms, _ in r["bounds"]),
         "bound_by": max(r["bounds"])[1],
         "library_ms": r["library_ms"] if name in WITH_LIBRARY else None}
        for name, r in kernels.items()
    ], "explain_max_abs_err": explain_errors}
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
