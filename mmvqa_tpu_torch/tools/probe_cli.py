#!/usr/bin/env python3
"""Where the pretraining CLI's train epochs go on the card's machine (card
only, about two minutes).

    python3 mmvqa_tpu_torch/tools/probe_cli.py

Writes the ROCO fixture of ``chip_smoke.py``'s CLI phase (64 train and 32
validation JPEGs at 512x416 px, seed 0), times the host's decode + resize
(``load_image`` at 224 px) on one thread and on four at once, then runs
``roco_train.main`` on the full-width flagship in bf16 at B=16 for three
epochs under each loader setting: four threads (the CLI's default), one
thread, four threads with ``--cache_images`` (the epochs after the first
decode nothing). For each train epoch it prints the items/s the CLI logs,
the share of the epoch the loop waited for a batch, and the median host
time of a step (the loop body between two batches: the step launches its
kernels and returns; the card runs behind).
"""

from __future__ import annotations

import os
import shutil
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARGS = ["--mlm_prob", "0.15", "--cnn_encoder", "tf_efficientnetv2_m",
        "--transformer_model", "realformer", "--batch_size", "16",
        "--mixed_precision", "--epochs", "3"]


def main() -> None:
    sys.path.insert(0, ROOT)
    import torch

    from mmvqa_tpu_torch.cli import roco_train
    from mmvqa_tpu_torch.data.fixtures import make_roco_fixture
    from mmvqa_tpu_torch.data.images import load_image

    if not torch.cuda.is_available():
        raise SystemExit("probe_cli: no CUDA device")
    work = os.path.join(ROOT, "_checkpoints", "probe_cli")
    shutil.rmtree(work, ignore_errors=True)
    real_epoch = roco_train.mlm_epoch
    try:
        data = make_roco_fixture(os.path.join(work, "roco"), 64, 32, 0,
                                 (512, 416))
        paths = [os.path.join(data, "train", "radiology", "images",
                              f"ROCO_train_{i:04d}.jpg") for i in range(64)]
        load_image(paths[0], 224)
        t0 = time.perf_counter()
        for p in paths[:32]:
            load_image(p, 224)
        one = 32 / (time.perf_counter() - t0)
        with ThreadPoolExecutor(4) as pool:
            t0 = time.perf_counter()
            list(pool.map(lambda p: load_image(p, 224), paths))
            four = 64 / (time.perf_counter() - t0)
        print(f"decode + resize to 224 px: one thread {one:.1f} images/s, "
              f"four threads {four:.1f} images/s; host CPUs {os.cpu_count()}")

        epochs = []

        def timed_epoch(step_fn, state, loader, train):
            if not train:
                return real_epoch(step_fn, state, loader, train)
            waits, bodies = [], []

            def timed():
                it = iter(loader)
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    t1 = time.perf_counter()
                    waits.append(t1 - t0)
                    yield batch
                    bodies.append(time.perf_counter() - t1)

            t0 = time.perf_counter()
            state, m = real_epoch(step_fn, state, timed(), train)
            wall = time.perf_counter() - t0
            epochs.append((m["items_per_sec"], sum(waits) / wall,
                           statistics.median(bodies) * 1e3, wall))
            return state, m

        roco_train.mlm_epoch = timed_epoch
        for label, extra in (("4 threads", ["--num_workers", "4"]),
                             ("1 thread", ["--num_workers", "1"]),
                             ("4 threads, --cache_images",
                              ["--num_workers", "4", "--cache_images"])):
            del epochs[:]
            save = os.path.join(work, label.split(",")[0].replace(" ", "_"))
            roco_train.main(["-r", "probe", "--data_dir", data, "--save_dir",
                             save, *ARGS, *extra])
            for i, (ips, share, body, wall) in enumerate(epochs):
                print(f"{label}, epoch {i}: {ips:.1f} train items/s, waited "
                      f"{100 * share:.1f}% of {wall:.2f} s, a step's host "
                      f"time {body:.1f} ms (median of 4)")
            torch.cuda.empty_cache()
    finally:
        roco_train.mlm_epoch = real_epoch
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
