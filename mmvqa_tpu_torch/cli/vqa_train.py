"""VQA-Med 2019 fine-tuning CLI (counterpart of mmvqa_tpu/cli/vqa_train.py).

    python -m mmvqa_tpu_torch.cli.vqa_train --run_name RUN \\
        --data_dir DIR/vqa --save_dir SAVE --num_vis 5 \\
        [--cnn_encoder tf_efficientnetv2_m --transformer_model realformer] \\
        --hidden_size 768 [--use_pretrained --model_dir SAVE/MLM/RUN \\
        --vocab_file DIR/roco/vocab.txt] [--mixed_precision] ...

The reference's flags and protocol (vqamed2019/train.py): the answer
vocabulary over the train + val + test union, the pretrained weights
carried over by key and shape (``--use_pretrained``; the classifier's
output layer stays fresh) or a fine-tuned checkpoint taken up whole
(``--resume_training``), CE, ASL or the category smoothing, every epoch a
train, a val and a test pass, the plateau LR on the val loss, two best
checkpoints (``<run>_loss`` by val loss, ``<run>`` by val accuracy) and
early stopping after ``--counter`` epochs without a better accuracy. It runs
on the CUDA card; ``main(argv, device="cpu")`` runs the plain paths on the
host (tests). Without encoder flags the model is the reference's default,
ResNet-152 and the pre-norm BERT encoder; ``--transformer_model
feedback-transformer`` selects the feedback encoder. ``--task`` only names
the save subdirectory, as in the JAX CLI. Under ``torchrun`` the mesh flags
lay the run out over the ranks (``cli/common.py``); a checkpoint of either
encoder layout, sequential or pipeline-stacked, loads into the model's
(``train.checkpoint.adapt_encoder_layout``).
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
    rank_loader,
    setup_runtime,
    vqa_parser,
)
from mmvqa_tpu_torch.data.datasets import (
    VQADataset,
    build_answer_vocab,
    load_vqa_data,
)
from mmvqa_tpu_torch.data.images import FINETUNE_AUG
from mmvqa_tpu_torch.evaluation import (
    bleu_score,
    per_category_accuracy,
    per_category_bleu,
)
from mmvqa_tpu_torch.models import MMBert
from mmvqa_tpu_torch.train import checkpoint
from mmvqa_tpu_torch.train.category_smoothing import (
    build_category_smoothing_table,
)
from mmvqa_tpu_torch.train.plateau import EarlyStopping, ReduceLROnPlateau
from mmvqa_tpu_torch.train.state import create_train_state
from mmvqa_tpu_torch.train.steps import make_vqa_steps
from mmvqa_tpu_torch.train.trainer import vqa_epoch
from mmvqa_tpu_torch.utils.logging import MetricSink, seed_everything


def main(argv: Optional[list] = None,
         device: Union[str, torch.device, None] = None) -> None:
    args = vqa_parser(eval_only=False).parse_args(argv)
    cfg = config_from_args(args)
    seed_everything(cfg.seed)
    dev, dtype = setup_runtime(cfg, device)
    sink = MetricSink(cfg.run_name, cfg.save_dir, cfg.wandb, config=vars(args))

    tok, cfg = load_tokenizer(cfg)
    train_df, val_df, test_df = load_vqa_data(cfg)
    train_df, val_df, test_df, idx2ans, num_classes = build_answer_vocab(
        train_df, val_df, test_df, cfg.category
    )
    cfg = cfg.replace(num_classes=num_classes)
    print("numclasses", num_classes)
    print(f"[mmvqa] train {len(train_df)} / val {len(val_df)} / test "
          f"{len(test_df)} questions, device {dev}, compute {dtype}")

    img_cache = make_image_cache(cfg)
    train_ds = VQADataset(cfg, train_df, tok, "train", image_cache=img_cache)
    val_ds = VQADataset(cfg, val_df, tok, "eval", image_cache=img_cache)
    test_ds = VQADataset(cfg, test_df, tok, "test", image_cache=img_cache)

    def loader(ds, shuffle):
        return rank_loader(ds, cfg.batch_size, shuffle=shuffle, seed=cfg.seed,
                           num_workers=cfg.num_workers,
                           cache_images=args.cache_images)

    train_loader = KeepFirst(loader(train_ds, True))
    val_loader, test_loader = loader(val_ds, False), loader(test_ds, False)

    model = MMBert(cfg, device=dev, compute_dtype=dtype)

    if cfg.use_pretrained:
        print("loading model from roco")
        print(cfg.model_dir)
        loaded = checkpoint.adapt_encoder_layout(
            model.state_dict(), checkpoint.load_weights(cfg.model_dir))
        merged, n_ok, n_all = checkpoint.filtered_restore(
            model.state_dict(), loaded)
        model.load_state_dict(merged, strict=True)
        print(f"[mmvqa] transferred {n_ok}/{n_all} tensors "
              "(classifier head re-initialized)")
    elif cfg.resume_training:
        print("resume training", cfg.resume_dir)
        loaded = checkpoint.adapt_encoder_layout(
            model.state_dict(), checkpoint.load_weights(cfg.resume_dir))
        checkpoint.check_compatible(model.state_dict(), loaded,
                                    what=cfg.resume_dir)
        model.load_state_dict(loaded, strict=True)
    else:
        print("from scratch")
    # the full weights are in: each rank keeps its layout's blocks
    state = create_train_state(model, cfg.lr, clip=cfg.clip,
                               grad_accum=cfg.grad_accum,
                               layout=place_model(model, cfg))

    smoothing_table = None
    if cfg.smoothing:
        print("Using label smoothing")
        smoothing_table = build_category_smoothing_table(
            train_df.column("category"), train_df.column("answer"),
            num_classes, train_ds.cats2ans, cfg.smoothing)
    elif cfg.loss == "ASLSingleLabel":
        print("Using ASLSingleLabel")
    else:
        print("Using CrossEntropyLoss")

    train_step, eval_step = make_vqa_steps(
        model, cfg, FINETUNE_AUG, category_smoothing_table=smoothing_table)
    scheduler = ReduceLROnPlateau(lr=cfg.lr, patience=cfg.patience,
                                  factor=cfg.factor)
    stopper = EarlyStopping(patience=cfg.counter)
    hist_logger = None

    best_acc1 = 0.0
    best_loss = math.inf
    os.makedirs(os.path.join(cfg.save_dir, cfg.task), exist_ok=True)
    prof = None
    if cfg.profile_dir:
        # a trace of the first epoch: train, val and test
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()

    for epoch in range(cfg.epochs):
        print(f"Epoch {epoch + 1}/{cfg.epochs}")
        state, tm = vqa_epoch(train_step, state, train_loader, True)
        _, vm = vqa_epoch(eval_step, state, val_loader, False)
        _, sm = vqa_epoch(eval_step, state, test_loader, False)

        if prof is not None:
            prof.stop()
            os.makedirs(cfg.profile_dir, exist_ok=True)
            path = os.path.join(cfg.profile_dir, f"{cfg.run_name}_trace.json")
            prof.export_chrome_trace(path)
            print(f"[mmvqa] profiler trace written to {path}")
            prof = None
        new_lr = scheduler.step(vm["loss"])
        state = state.with_lr(new_lr)

        if not cfg.category:
            val_acc = per_category_accuracy(
                vm["preds"], vm["targets"], val_df.column("category"), "val_")
            test_acc = per_category_accuracy(
                sm["preds"], sm["targets"], test_df.column("category"))
            test_bleu = per_category_bleu(
                sm["preds"], sm["targets"], test_df.column("category"),
                idx2ans)
            log = dict(test_acc)
            log.update(test_bleu)
            log.update(
                train_loss=tm["loss"], val_loss=vm["loss"],
                test_loss=sm["loss"], learning_rate=new_lr,
                val_total_acc=val_acc["val_total_acc"],
                train_items_per_sec=tm["items_per_sec"],
            )
            sink.log(log)
            monitored = val_acc["val_total_acc"]
            print(
                f"train {tm['loss']:.4f} val {vm['loss']:.4f} test "
                f"{sm['loss']:.4f} val_acc {monitored:.2f} "
                f"test_acc {test_acc['total_acc']:.2f} "
                f"({tm['items_per_sec']:.1f} items/s)"
            )
        else:
            val_acc_v = float((vm["preds"] == vm["targets"]).mean() * 100)
            test_acc_v = float((sm["preds"] == sm["targets"]).mean() * 100)
            sink.log({
                "train_loss": tm["loss"], "val_loss": vm["loss"],
                "test_loss": sm["loss"], "learning_rate": new_lr,
                f"val_{cfg.category}_acc": val_acc_v,
                f"{cfg.category}_acc": test_acc_v,
                f"val_{cfg.category}_bleu": bleu_score(
                    vm["preds"], vm["targets"], idx2ans),
                f"{cfg.category}_bleu": bleu_score(
                    sm["preds"], sm["targets"], idx2ans),
            })
            monitored = val_acc_v
            print(f"val_{cfg.category}_acc {val_acc_v:.2f}")

        if cfg.watch_histograms and train_loader.batch is not None:
            # per-parameter grad/weight histograms of the train criterion on
            # the run's first train batch; the training state is left as it
            # was
            if hist_logger is None:
                hist_logger = make_hist_logger(
                    cfg, model, FINETUNE_AUG, train_loader.batch, "vqa",
                    smoothing_table=smoothing_table, layout=state.layout)
            sink.log_histograms(hist_logger(epoch), step=epoch)

        if vm["loss"] < best_loss:
            print("Saving model by loss")
            checkpoint.save_weights(
                os.path.join(cfg.save_dir, cfg.task, cfg.run_name + "_loss"),
                state)
            best_loss = vm["loss"]

        if monitored > best_acc1:
            print("Saving model")
            checkpoint.save_weights(
                os.path.join(cfg.save_dir, cfg.task, cfg.run_name), state)
            best_acc1 = monitored

        if stopper.update(best_acc1):
            print("Counter expired, finishing.")
            break
        if stopper.counter:
            print(f"Counter {stopper.counter}/{cfg.counter}")
    if prof is not None:
        prof.stop()
    sink.finish()


if __name__ == "__main__":
    main()
