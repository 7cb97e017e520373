#!/usr/bin/env python3
"""Time the multi-GPU layouts' train steps on one card.

    python3 mmvqa_tpu_torch/tools/time_layouts.py [--root DIR] [--no_single]
        [LAYOUT ...]

Builds the kernels, then takes the flagship's fp32 MLM step at full width
(EfficientNetV2-M + RealFormer), the CLIs' global B=16 with three padded
samples, T=75, 224 px: once in this process, then under each layout on
ranks spawned on cuda:0 over gloo, one world at a time (dp=2, dp=2 with
FSDP, tp=2, the default model at dp=2, the pipeline pp=2 on the flagship and
on the default model, the flagship's VQA step at T=28 with the ring at
cp=2; cp=3 with the ring on the flagship and cp=3 with the gathered encoder
on the flagship and the default model on three ranks; the flagship's trunk
with the feedback encoder at tp=2; dp=2 x tp=2 with FSDP and dp=2 x pp=2
on four ranks). For each it prints a second step's wall ms and the card's busy ms
in it (torch.profiler, the card's activity only) for every rank, the MiB a
rank held before the first step (its placed parameters: under FSDP its
blocks), the step's peak above that, and what it holds at rest after the
first step (the parameters and Adam's moments), and the bytes its first
step staged through host memory, beside the single process's, with the
card's name and power limit. ``chip_smoke.py::layouts_phase`` checks the
same steps against the single process; it runs its worlds side by side and
times none of them.

LAYOUT names the layouts to time (``dp2``, ``dp2-fsdp``, ``tp2``,
``default-dp2``, ``pp2``, ``default-pp2``, ``vqa-cp2-ring``,
``feedback-tp2``, ``cp3-ring``, ``cp3``, ``default-cp3``,
``dp2-tp2-fsdp``, ``dp2-pp2``; all by default); ``--no_single`` skips
the single process; ``--root DIR`` times the port of another checkout
(a parent commit unpacked beside this one, for runs A B B A), whose kernels
are built there.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
B, PAD = 16, 3


def main() -> None:
    import argparse
    import shutil

    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("layouts", nargs="*")
    parser.add_argument("--root", default=ROOT)
    parser.add_argument("--no_single", action="store_true")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from mmvqa_tpu_torch.core.config import pretrain_config, vqa_config
    from mmvqa_tpu_torch.data.synthetic import mlm_batches, vqa_batches
    from mmvqa_tpu_torch.native import loader
    from mmvqa_tpu_torch.parallel.world import (
        run_jobs,
        run_world,
        single_step,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; the port of {root}")
    loader.build()
    loader.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    flag_cfg = pretrain_config(cnn_encoder="tf_efficientnetv2_m",
                               transformer_model="realformer", batch_size=B,
                               dropout_override=0.0)
    def_cfg = pretrain_config(batch_size=B, dropout_override=0.0)
    batch = mlm_batches(flag_cfg, 1, 0, pad_last=PAD)[0]
    flag = dict(cfg=flag_cfg, kind="mlm", batch=batch, keep=[], timed=True)
    deft = dict(flag, cfg=def_cfg)
    vqa_cfg = vqa_config(cnn_encoder="tf_efficientnetv2_m",
                         transformer_model="realformer", num_classes=10,
                         batch_size=B, dropout_override=0.0)
    vqa = dict(flag, cfg=vqa_cfg, kind="vqa", clip=True,
               batch=vqa_batches(vqa_cfg, 1, 10, 0, pad_last=PAD)[0])
    pp_flag = dict(flag, cfg=flag_cfg.replace(pp_size=2))
    feedback = dict(flag, cfg=flag_cfg.replace(
        transformer_model="feedback-transformer"))
    ring = dict(attention_impl="ring")
    worlds = (
        (2, {"dp2": dict(flag, dp=2, tp=1, fsdp=False),
             "dp2 fsdp": dict(flag, dp=2, tp=1, fsdp=True),
             "tp2": dict(flag, dp=1, tp=2, fsdp=False),
             "default dp2": dict(deft, dp=2, tp=1, fsdp=False),
             "pp2": dict(pp_flag, dp=1, tp=1, pp=2, fsdp=False),
             "default pp2": dict(deft, cfg=def_cfg.replace(pp_size=2), dp=1,
                                 tp=1, pp=2, fsdp=False),
             "vqa cp2 ring": dict(vqa, cfg=vqa_cfg.replace(**ring), dp=1,
                                  tp=1, cp=2, fsdp=False),
             "feedback tp2": dict(feedback, dp=1, tp=2, fsdp=False)}),
        (3, {"cp3 ring": dict(flag, cfg=flag_cfg.replace(**ring), dp=1, tp=1,
                              cp=3, fsdp=False),
             "cp3": dict(flag, dp=1, tp=1, cp=3, fsdp=False),
             "default cp3": dict(deft, dp=1, tp=1, cp=3, fsdp=False)}),
        (4, {"dp2 x tp2 fsdp": dict(flag, dp=2, tp=2, fsdp=True),
             "dp2 x pp2": dict(pp_flag, dp=2, tp=1, pp=2, fsdp=False)}),
    )
    if args.layouts:
        worlds = tuple((size, {n: j for n, j in jobs.items()
                               if n.replace(" x ", "-").replace(" ", "-")
                               in args.layouts})
                       for size, jobs in worlds)
    mib = 2.0 ** 20
    singles = ({} if args.no_single else
               {"flagship": single_step(flag, "cuda"),
                "default": single_step(deft, "cuda"),
                "flagship vqa": single_step(vqa, "cuda"),
                "flagship feedback": single_step(feedback, "cuda")})
    for name, r in singles.items():
        print(f"single process, {name}: a second step {r['step_ms']:.1f} ms, "
              f"the card busy {r['busy_ms']:.2f} ms; held "
              f"{r['held_bytes'] / mib:.0f} MiB, the step's peak "
              f"{r['peak_bytes'] / mib:.0f} MiB above it, at rest after it "
              f"{r.get('rest_bytes', 0) / mib:.0f} [{card}]")
    torch.cuda.empty_cache()
    folder = os.path.join(ROOT, "_checkpoints", "time_layouts")
    os.makedirs(folder, exist_ok=True)
    for size, jobs in worlds:
        if not jobs:
            continue
        outs = run_world(run_jobs, size, (list(jobs.values()),),
                         os.path.join(folder, f"world{size}"), "cuda:0", 900,
                         threads=max(1, (os.cpu_count() or 1) // size))
        for i, name in enumerate(jobs):
            ranks = [o[i] for o in outs]
            print(f"{name}: a second step, ms a rank "
                  f"{[round(r['step_ms'], 1) for r in ranks]}, the card "
                  f"busy in it, ms a rank "
                  f"{[round(r['busy_ms'], 2) for r in ranks]}; MiB a rank "
                  f"held {[round(r['held_bytes'] / mib) for r in ranks]}, "
                  f"the step's peak above it "
                  f"{[round(r['peak_bytes'] / mib) for r in ranks]}, at rest "
                  f"after it {[round(r.get('rest_bytes', 0) / mib) for r in ranks]}"
                  f"; staged "
                  f"through host memory by the first step, all ranks, "
                  f"{sum(r['staged_bytes'] for r in ranks) / 1e6:.1f} MB in "
                  f"{sum(r['staged_calls'] for r in ranks)} calls; every "
                  f"rank's replicated state equal after the first: "
                  f"{all(r['digest'] == ranks[0]['digest'] for r in ranks)}"
                  f" [{card}]")
    shutil.rmtree(folder, ignore_errors=True)


if __name__ == "__main__":
    main()
