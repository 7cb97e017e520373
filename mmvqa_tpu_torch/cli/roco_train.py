"""ROCO pretraining CLI, MLM or distillation (counterpart of
mmvqa_tpu/cli/roco_train.py).

    python -m mmvqa_tpu_torch.cli.roco_train -r RUN --data_dir DIR/roco \\
        --mlm_prob 0.15 [--task distillation] [--cnn_encoder \\
        tf_efficientnetv2_m --transformer_model realformer] \\
        [--mixed_precision] ...

Without encoder flags it pretrains the reference's default model, ResNet-152
and the pre-norm BERT encoder; the two flags above select the flagship,
``--transformer_model feedback-transformer`` the feedback encoder.
``--task distillation`` trains the encoder's output towards the hidden
states of the ClinicalBERT teacher (``--clinicalbert``, a local checkpoint
that the dataset loads at first use) through ``make_distill_steps``.

The reference's flags and epoch protocol: train -> validate -> plateau LR
on the validation loss -> the recorder every 5 epochs -> the weights at
each better validation loss, with the same metric names. It runs on the
CUDA card; ``main(argv, device="cpu")`` runs the plain paths on the host
(tests). Under ``torchrun`` with ``--dp_size``, ``--tp_size``, ``--fsdp``,
``--cp_size`` (with ``--attention_impl ring`` or without) and ``--pp_size``
(``--pp_microbatches``) each rank trains its layout of the model on its
shard of the data (``cli/common.py``).
"""

from __future__ import annotations

import math
import os
from typing import Optional, Union

import torch

from mmvqa_tpu_torch.cli.common import (
    KeepFirst,
    config_from_args,
    load_tokenizer,
    make_hist_logger,
    make_image_cache,
    place_model,
    pretrain_parser,
    rank_loader,
    setup_runtime,
)
from mmvqa_tpu_torch.data.datasets import ROCODataset, get_keywords, load_mlm_data
from mmvqa_tpu_torch.data.images import PRETRAIN_AUG
from mmvqa_tpu_torch.models import MMBert
from mmvqa_tpu_torch.train import checkpoint
from mmvqa_tpu_torch.train.plateau import ReduceLROnPlateau
from mmvqa_tpu_torch.train.state import create_train_state
from mmvqa_tpu_torch.train.steps import make_distill_steps, make_mlm_steps
from mmvqa_tpu_torch.train.trainer import mlm_epoch
from mmvqa_tpu_torch.utils.logging import MetricSink, seed_everything

SAVE_RECORDER_EVERY = 5


def main(argv: Optional[list] = None,
         device: Union[str, torch.device, None] = None) -> None:
    args = pretrain_parser().parse_args(argv)
    cfg = config_from_args(args)
    if cfg.dataset not in cfg.data_dir:  # roco_train.py:64
        raise ValueError(f"--dataset {cfg.dataset} not in --data_dir "
                         f"{cfg.data_dir}")
    seed_everything(cfg.seed)
    dev, dtype = setup_runtime(cfg, device)
    sink = MetricSink(cfg.run_name, cfg.save_dir, cfg.wandb, config=vars(args))

    tok, cfg = load_tokenizer(cfg)
    train_df, val_df = load_mlm_data(cfg)
    keywords = get_keywords(cfg.data_dir)
    print(f"[mmvqa] train {len(train_df)} / val {len(val_df)} samples, "
          f"device {dev}, compute {dtype}")

    img_cache = make_image_cache(cfg)
    train_ds = ROCODataset(cfg, train_df, tok, keywords, "train",
                           image_cache=img_cache)
    val_ds = ROCODataset(cfg, val_df, tok, keywords, "validation",
                         image_cache=img_cache)
    train_loader = KeepFirst(rank_loader(
        train_ds, cfg.batch_size, shuffle=True, seed=cfg.seed,
        num_workers=cfg.num_workers, cache_images=args.cache_images))
    val_loader = rank_loader(
        val_ds, cfg.batch_size, num_workers=cfg.num_workers,
        cache_images=args.cache_images)

    model = MMBert(cfg, device=dev, compute_dtype=dtype)
    state = create_train_state(model, cfg.lr, clip=cfg.clip,
                               grad_accum=cfg.grad_accum,
                               layout=place_model(model, cfg))
    scheduler = ReduceLROnPlateau(lr=cfg.lr, patience=cfg.patience,
                                  factor=cfg.factor)
    mlm = cfg.task == "MLM"
    make_steps = make_mlm_steps if mlm else make_distill_steps
    train_step, eval_step = make_steps(model, cfg, PRETRAIN_AUG)

    start_epoch = 0
    best_loss = math.inf
    if cfg.resume:
        state, sstate, epoch = checkpoint.restore_recorder(cfg.save_dir, state)
        scheduler.load_state_dict(sstate)
        state = state.with_lr(scheduler.lr)
        start_epoch = epoch + 1
        if math.isinf(cfg.val_loss_resume):
            print("using val loss registered in scheduler")
            best_loss = scheduler.best
        else:
            print("using val loss given as argument")
            best_loss = cfg.val_loss_resume
        print(best_loss)

    os.makedirs(os.path.join(cfg.save_dir, cfg.task), exist_ok=True)
    hist_logger = None
    prof = None
    if cfg.profile_dir:
        # a trace of the first epoch, train and validation
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()

    for epoch in range(start_epoch, cfg.epochs):
        print(f"Epoch {epoch + 1}/{cfg.epochs}")
        state, tm = mlm_epoch(train_step, state, train_loader, True)
        _, vm = mlm_epoch(eval_step, state, val_loader, False)

        if prof is not None:
            prof.stop()
            os.makedirs(cfg.profile_dir, exist_ok=True)
            path = os.path.join(cfg.profile_dir, f"{cfg.run_name}_trace.json")
            prof.export_chrome_trace(path)
            print(f"[mmvqa] profiler trace written to {path}")
            prof = None
        new_lr = scheduler.step(vm["loss"])
        state = state.with_lr(new_lr)

        if (epoch + 1) % SAVE_RECORDER_EVERY == 0:
            checkpoint.save_recorder(cfg.save_dir, epoch, state,
                                     scheduler.state_dict())

        log = {
            "epoch_train_loss": tm["loss"],
            "epoch_val_loss": vm["loss"],
            "learning_rate": new_lr,
            "epoch": epoch,
            "train_items_per_sec": tm["items_per_sec"],
        }
        # --watch: per-module grad norms (wandb.watch equivalent)
        log.update({k: v for k, v in tm.items() if k.startswith("gnorm/")})
        if mlm:
            log["epoch_train_acc"] = tm.get("acc")
            log["epoch_val_acc"] = vm.get("acc")
            content = (
                f"Learning rate: {new_lr:.7f}, Train loss: {tm['loss']:.4f}, "
                f"Train acc: {tm.get('acc', 0):.4f} ,Val loss: "
                f"{vm['loss']:.4f}, Val acc: {vm.get('acc', 0):.4f}"
            )
        else:
            content = (
                f"Learning rate: {new_lr:.7f}, Train loss: {tm['loss']:.4f}, "
                f"Val loss: {vm['loss']:.4f}"
            )
        sink.log(log)
        if cfg.watch_histograms and train_loader.batch is not None:
            # per-parameter grad/weight histograms on the run's first train
            # batch; the training state is left as it was
            if hist_logger is None:
                hist_logger = make_hist_logger(
                    cfg, model, PRETRAIN_AUG, train_loader.batch,
                    "mlm" if mlm else "distill", layout=state.layout)
            sink.log_histograms(hist_logger(epoch), step=epoch)
        print(content)
        print(f"[mmvqa] {tm['items_per_sec']:.1f} train items/s")

        if vm["loss"] < best_loss:
            print("Saving model")
            checkpoint.save_weights(
                os.path.join(cfg.save_dir, cfg.task, cfg.run_name), state)
            best_loss = vm["loss"]
    if prof is not None:
        prof.stop()
    sink.finish()


if __name__ == "__main__":
    main()
