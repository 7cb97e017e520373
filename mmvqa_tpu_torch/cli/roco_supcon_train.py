"""ROCO MLM + SupCon/SimCLR joint pretraining CLI (counterpart of
mmvqa_tpu/cli/roco_supcon_train.py).

    python -m mmvqa_tpu_torch.cli.roco_supcon_train -r RUN \\
        --data_dir DIR/roco --mlm_prob 0.15 --con_task supcon \\
        --similarity jaccard [--cnn_encoder tf_efficientnetv2_m \\
        --transformer_model realformer] [--use_sim_mask] [--mixed_precision]

The reference's flags and protocol (pretrain/roco_supcon_train.py): the
similarity calculator, the loader at ``batch_size // 2`` (the two views
restore the full batch, :137-138), the joint NLL + SupCon loss, plain-MLM
validation, the plateau LR on the validation loss, the recorder every 5
epochs, ``--resume`` from the recorder or (``--no_recorder``) from the
weights at ``--resume_dir``, and the weights at each better validation
loss. As in the reference, the similarity mask is computed but not passed to
the loss (supcon_utils.py:286-287) unless ``--use_sim_mask`` is set. It runs
on the CUDA card; ``main(argv, device="cpu")`` runs the plain paths on the
host (tests). Without encoder flags the model is the reference's default,
ResNet-152 and the pre-norm BERT encoder; ``--transformer_model
feedback-transformer`` selects the feedback encoder. Under ``torchrun`` the
mesh flags lay the run out over the ranks (``cli/common.py``), and a
checkpoint of either encoder layout loads (``adapt_encoder_layout``). The
similarity backends other than ``jaccard`` need their packages and local
weights.
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
    load_full_weights,
    make_image_cache,
    place_model,
    pretrain_parser,
    rank_loader,
    setup_runtime,
)
from mmvqa_tpu_torch.data.datasets import ROCODataset, get_keywords, load_mlm_data
from mmvqa_tpu_torch.data.images import PRETRAIN_AUG
from mmvqa_tpu_torch.models import MMBert
from mmvqa_tpu_torch.similarity import SimilarityCalculator, build_mask
from mmvqa_tpu_torch.train import checkpoint
from mmvqa_tpu_torch.train.plateau import ReduceLROnPlateau
from mmvqa_tpu_torch.train.state import create_train_state
from mmvqa_tpu_torch.train.steps import make_supcon_steps
from mmvqa_tpu_torch.train.trainer import mlm_epoch, supcon_epoch
from mmvqa_tpu_torch.utils.logging import MetricSink, seed_everything

SAVE_RECORDER_EVERY = 5


def main(argv: Optional[list] = None,
         device: Union[str, torch.device, None] = None) -> None:
    args = pretrain_parser(supcon=True).parse_args(argv)
    cfg = config_from_args(args).replace(supcon=True)
    if cfg.dataset not in cfg.data_dir:  # the JAX CLI asserts it
        raise ValueError(f"--dataset {cfg.dataset} not in --data_dir "
                         f"{cfg.data_dir}")
    seed_everything(cfg.seed)
    dev, dtype = setup_runtime(cfg, device)
    sink = MetricSink(cfg.run_name, cfg.save_dir, cfg.wandb, config=vars(args))

    tok, cfg = load_tokenizer(cfg)
    train_df, val_df = load_mlm_data(cfg)
    keywords = get_keywords(cfg.data_dir)

    calculator = None
    if cfg.con_task == "supcon":
        calculator = SimilarityCalculator(
            cfg.similarity, clinicalbert=cfg.clinicalbert,
            bert_score_model=cfg.bert_score,
            max_token_length=cfg.max_token_length,
        )
    print("Similarity", cfg.similarity, "| con_task", cfg.con_task,
          "| mask wired into loss:", cfg.use_sim_mask)
    print(f"[mmvqa] train {len(train_df)} / val {len(val_df)} samples, "
          f"device {dev}, compute {dtype}")

    img_cache = make_image_cache(cfg)
    train_ds = ROCODataset(cfg, train_df, tok, keywords, "train",
                           two_text_views=True, image_cache=img_cache)
    val_ds = ROCODataset(cfg, val_df, tok, keywords, "validation",
                         image_cache=img_cache)
    # batch_size // 2: the two views restore the full batch
    train_loader = KeepFirst(rank_loader(
        train_ds, cfg.batch_size // 2, shuffle=True, seed=cfg.seed,
        num_workers=cfg.num_workers, cache_images=args.cache_images))
    val_loader = rank_loader(val_ds, cfg.batch_size,
                             num_workers=cfg.num_workers,
                             cache_images=args.cache_images)

    model = MMBert(cfg, device=dev, compute_dtype=dtype)
    layout = place_model(model, cfg)
    state = create_train_state(model, cfg.lr, clip=cfg.clip,
                               grad_accum=cfg.grad_accum, layout=layout)
    scheduler = ReduceLROnPlateau(lr=cfg.lr, patience=cfg.patience,
                                  factor=cfg.factor)
    train_step, eval_step = make_supcon_steps(model, cfg, PRETRAIN_AUG)

    # the reference's live path computes the mask and drops it (:286-287):
    # only --use_sim_mask passes one
    sim_mask_fn = None
    if cfg.use_sim_mask and cfg.con_task == "supcon":
        def sim_mask_fn(captions, augs):
            return build_mask(cfg.con_task, captions, augs, calculator)

    start_epoch = 0
    best_loss = math.inf
    if cfg.resume:
        print("Resuming training")
        if cfg.no_recorder:
            loaded = checkpoint.adapt_encoder_layout(
            model.state_dict(), checkpoint.load_weights(cfg.resume_dir))
            load_full_weights(model, layout, loaded, what=cfg.resume_dir)
        else:
            state, sstate, epoch = checkpoint.restore_recorder(cfg.save_dir,
                                                               state)
            scheduler.load_state_dict(sstate)
            state = state.with_lr(scheduler.lr)
            start_epoch = epoch + 1
        best_loss = (scheduler.best if math.isinf(cfg.val_loss_resume)
                     else cfg.val_loss_resume)
        print(best_loss)

    os.makedirs(os.path.join(cfg.save_dir, cfg.task), exist_ok=True)
    hist_logger = None
    for epoch in range(start_epoch, cfg.epochs):
        print(f"Epoch {epoch + 1}/{cfg.epochs}")
        state, tm = supcon_epoch(train_step, state, train_loader,
                                 sim_mask_fn=sim_mask_fn)
        _, vm = mlm_epoch(eval_step, state, val_loader, False)

        new_lr = scheduler.step(vm["loss"])
        state = state.with_lr(new_lr)

        if (epoch + 1) % SAVE_RECORDER_EVERY == 0:
            checkpoint.save_recorder(cfg.save_dir, epoch, state,
                                     scheduler.state_dict())

        log = {
            "epoch_train_loss": tm["loss"],
            "epoch_val_loss": vm["loss"],
            "epoch_train_acc": tm["acc"],
            "epoch_val_acc": vm.get("acc"),
            "epoch_train_mlm_loss": tm["mlm_loss"],
            "epoch_train_supcon_loss": tm["supcon_loss"],
            "learning_rate": new_lr,
            "epoch": epoch,
            "train_items_per_sec": tm["items_per_sec"],
        }
        # --watch: per-module grad norms (wandb.watch equivalent)
        log.update({k: v for k, v in tm.items() if k.startswith("gnorm/")})
        sink.log(log)
        if cfg.watch_histograms and train_loader.batch is not None:
            # per-parameter grad/weight histograms of NLL + SupCon on the
            # run's first train batch; the training state is left as it was
            if hist_logger is None:
                hist_logger = make_hist_logger(cfg, model, PRETRAIN_AUG,
                                               train_loader.batch, "supcon",
                                               layout=state.layout)
            sink.log_histograms(hist_logger(epoch), step=epoch)
        print(
            f"Learning rate: {new_lr:.7f}, Train loss: {tm['loss']:.4f}, "
            f"Train acc: {tm['acc']:.4f} ,Val loss: {vm['loss']:.4f}, "
            f"Val acc: {vm.get('acc', 0):.4f} "
            f"({tm['items_per_sec']:.1f} items/s)"
        )

        if vm["loss"] < best_loss:
            print("Saving model")
            checkpoint.save_weights(
                os.path.join(cfg.save_dir, cfg.task, cfg.run_name), state)
            best_loss = vm["loss"]
    sink.finish()


if __name__ == "__main__":
    main()
