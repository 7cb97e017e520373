"""VQA-Med 2019 evaluation and submission writer (counterpart of
mmvqa_tpu/cli/vqa_eval.py).

    python -m mmvqa_tpu_torch.cli.vqa_eval --run_name RUN \\
        --data_dir DIR/vqa --save_dir OUT --num_vis 5 \\
        [--cnn_encoder tf_efficientnetv2_m --transformer_model realformer] \\
        --hidden_size 768 --model_dir SAVE/MLM/RUN \\
        [--model_dirs A B ...] [--mixed_precision]

The reference's protocol (vqamed2019/eval.py): the answer vocabulary
rebuilt over the same union in the same order, a fine-tuned checkpoint
loaded whole, the test set's predictions (the mean of the models' logits
where ``--model_dirs`` names several, final_test of utils.py:845-872),
per-category accuracy and BLEU, and ``<model>_preds.csv`` and the
pipe-separated ImageCLEF ``<model>_res.txt`` in ``--save_dir``. It runs on
the CUDA card; ``main(argv, device="cpu")`` runs the plain paths on the host
(tests). ``--task`` is taken and not used, as by the JAX CLI. The mesh flags
and checkpoints of either encoder layout as in ``cli/vqa_train.py``.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from mmvqa_tpu_torch.cli.common import (
    config_from_args,
    load_tokenizer,
    load_full_weights,
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
from mmvqa_tpu_torch.evaluation import (
    ensemble_logits,
    per_category_accuracy,
    per_category_bleu,
    write_predictions,
    write_submission,
)
from mmvqa_tpu_torch.models import MMBert
from mmvqa_tpu_torch.train import checkpoint
from mmvqa_tpu_torch.train.steps import make_vqa_steps
from mmvqa_tpu_torch.train.trainer import vqa_epoch
from mmvqa_tpu_torch.utils.logging import MetricSink, seed_everything


def main(argv: Optional[list] = None,
         device: Union[str, torch.device, None] = None) -> None:
    parser = vqa_parser(eval_only=True)
    parser.add_argument(
        "--model_dirs", nargs="+", default=None,
        help="ensemble: average logits over several checkpoints "
             "(final_test, vqamed2019/utils.py:845-872)",
    )
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    seed_everything(cfg.seed)
    dev, dtype = setup_runtime(cfg, device)
    model_name = os.path.basename(cfg.model_dir)
    # wandb where the package is installed, else the JSONL lines only
    sink = MetricSink("testing-" + model_name, cfg.save_dir, use_wandb=True,
                      config=vars(args))

    tok, cfg = load_tokenizer(cfg)
    train_df, val_df, test_df = load_vqa_data(cfg)
    train_df, val_df, test_df, idx2ans, num_classes = build_answer_vocab(
        train_df, val_df, test_df, cfg.category
    )
    cfg = cfg.replace(num_classes=num_classes)

    test_ds = VQADataset(cfg, test_df, tok, "test",
                         image_cache=make_image_cache(cfg))
    test_loader = rank_loader(test_ds, cfg.batch_size,
                              num_workers=cfg.num_workers)

    model = MMBert(cfg, device=dev, compute_dtype=dtype)
    layout = place_model(model, cfg)
    _, eval_step = make_vqa_steps(model, cfg)

    model_paths = args.model_dirs or [cfg.model_dir]
    all_logits = []
    sm = None
    for path in model_paths:
        print("Loading model at ", path)
        loaded = checkpoint.adapt_encoder_layout(
            model.state_dict(), checkpoint.load_weights(path))
        load_full_weights(model, layout, loaded, what=path)
        _, sm = vqa_epoch(eval_step, None, test_loader, False,
                          collect_logits=True)
        all_logits.append(sm["logits"])
    if len(all_logits) > 1:
        sm = dict(sm)
        sm["preds"] = np.argmax(ensemble_logits(all_logits), axis=-1)
        print(f"[mmvqa] ensembled {len(all_logits)} models")

    categories = test_df.column("category")
    acc = per_category_accuracy(sm["preds"], sm["targets"], categories)
    bleu = per_category_bleu(sm["preds"], sm["targets"], categories, idx2ans)
    sink.log({"test_loss": sm["loss"], **acc, **bleu})

    os.makedirs(cfg.save_dir, exist_ok=True)
    write_predictions(test_df, sm["preds"], idx2ans,
                      os.path.join(cfg.save_dir, f"{model_name}_preds.csv"))
    write_submission(test_df, sm["preds"], idx2ans,
                     os.path.join(cfg.save_dir, f"{model_name}_res.txt"))
    print("acc", acc)
    print("bleu", bleu)
    sink.finish()


if __name__ == "__main__":
    main()
