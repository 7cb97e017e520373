"""Grad-CAM CLI: visual explanation for one VQA-Med image and question
(counterpart of mmvqa_tpu/cli/grad_cam.py).

    python -m mmvqa_tpu_torch.cli.grad_cam --data_dir DIR/vqa \\
        --model_dir FT/MLM/RUN --vocab_file DIR/vocab.txt \\
        --vqa_img synpic371.jpg --category organ --mode Train \\
        [--method gradcam|gradcam++|xgradcam|eigencam|scorecam|ablationcam] \\
        [--cnn_only] [--save_dir ./gradcam-images]

CLI-compatible rebuild of vqamed2019/grad_cam2.py (the full multimodal
model) with grad_cam.py's CAM zoo and its classifier-stripped trunk
(``--cnn_only``). The default model is the flagship: EfficientNetV2-M and
the RealFormer, hidden 768, 4 layers, T=28, fp32. Writes the overlay as
``<category>_<vqa_img>`` into ``--save_dir`` (the port's baseline JPEG
encoder: quality 75, 4:2:0, PIL's default layout) and prints the question,
the answer, the prediction (or the target feature channel) and the file.

It runs on the CUDA card; ``main(argv, device="cpu")`` runs the plain paths
on the host (tests). The trunk runs once a call: ScoreCAM's masked images
go through the model in batches of 32 without a graph, and AblationCAM
reruns from the tap, the deepest map with 32 channels ablated at a time
through its token head and the encoder, the other taps' tokens kept (the
JAX CLI reruns the whole model with ``perturb = ablated - acts``; the trunk
does not depend on it).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Union

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Grad-CAM for VQA-Med")
    p.add_argument("--data_dir", type=str, default="../ImageClef-2019-VQA-Med")
    p.add_argument("--model_dir", type=str, required=True)
    p.add_argument("--cnn_encoder", type=str, default="tf_efficientnetv2_m")
    p.add_argument("--use_relu", action="store_true", default=False)
    p.add_argument("--transformer_model", type=str, default="realformer",
                   choices=["transformer", "realformer", "feedback-transformer"])
    p.add_argument("--dataset", type=str, default="VQA-Med")
    p.add_argument("--num_vis", type=int, default=5)
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--hidden_dropout_prob", type=float, default=0.3)
    p.add_argument("--n_layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--vocab_size", type=int, default=30522)
    p.add_argument("--task", type=str, default="MLM")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--train_pct", type=float, default=1.0)
    p.add_argument("--valid_pct", type=float, default=1.0)
    p.add_argument("--test_pct", type=float, default=1.0)
    p.add_argument("--max_position_embeddings", type=int, default=28)
    p.add_argument("--vqa_img", type=str, default="synpic371.jpg")
    p.add_argument("--category", type=str, default="organ",
                   choices=["organ", "modality", "plane", "abnormality", "binary"])
    p.add_argument("--mode", type=str, default="Train",
                   choices=["Train", "Val", "Test"])
    p.add_argument("--save_dir", type=str, default="./gradcam-images")
    p.add_argument("--vocab_file", type=str, default="")
    p.add_argument("--method", type=str, default="gradcam",
                   choices=["gradcam", "gradcam++", "xgradcam", "eigencam",
                            "scorecam", "ablationcam"],
                   help="CAM variant (reference grad_cam.py:65-72 zoo)")
    p.add_argument("--tiny_cnn", action="store_true", default=False,
                   help="1-block-per-stage CNN trunks (smoke runs/CI only)")
    p.add_argument("--cnn_only", action="store_true", default=False,
                   help="question-independent CAM over the standalone "
                        "fine-tuned CNN trunk (reference grad_cam.py's "
                        "classifier-stripped timm model, :112-133)")
    return p


def select_row(table, img_path: str, category: str):
    """(question, answer) of the one row of ``table`` for this image and
    category, with pandas' errors: none matches, or ``.item()`` of more
    than one."""
    rows = [r for r in table.rows
            if r[table.columns.index("img_id")] == img_path
            and r[table.columns.index("category")] == category]
    if not rows:
        raise ValueError("Image does not exist in data split.")
    if len(rows) > 1:
        raise ValueError("can only convert an array of size 1 to a Python "
                         "scalar")
    row = dict(zip(table.columns, rows[0]))
    return row["question"], int(row["answer"])


def main(argv: Optional[list] = None,
         device: Union[str, torch.device, None] = None) -> None:
    args = build_parser().parse_args(argv)

    from mmvqa_tpu_torch.cli.common import (
        config_from_args,
        load_tokenizer,
        setup_runtime,
    )
    from mmvqa_tpu_torch.data import jpeg
    from mmvqa_tpu_torch.data.datasets import (
        Table,
        build_answer_vocab,
        load_vqa_data,
    )
    from mmvqa_tpu_torch.data.images import load_image
    from mmvqa_tpu_torch.data.text_encoding import encode_text_vqa
    from mmvqa_tpu_torch.explain import CAM_METHODS, overlay_heatmap
    from mmvqa_tpu_torch.explain.cam_zoo import ablation_cam, score_cam
    from mmvqa_tpu_torch.explain.gradcam import (
        ablation_rerun,
        cnn_only_activations,
        deepest_map,
        grad_cam_from_maps,
        grad_cam_heatmap,
        vqa_scores,
    )
    from mmvqa_tpu_torch.models import MMBert
    from mmvqa_tpu_torch.train import checkpoint
    from mmvqa_tpu_torch.utils.logging import seed_everything

    # one call a step: the config's TPU super-stepping default does not apply
    cfg = config_from_args(args).replace(category=None, steps_per_call=1)
    seed_everything(cfg.seed)
    dev, _ = setup_runtime(cfg, device)
    tok, cfg = load_tokenizer(cfg)

    train_t, val_t, test_t = load_vqa_data(cfg)
    train_t, val_t, test_t, idx2ans, num_classes = build_answer_vocab(
        train_t, val_t, test_t)
    cfg = cfg.replace(num_classes=num_classes)
    table = Table.concat([train_t, val_t, test_t])
    img_path = os.path.join(cfg.data_dir, args.mode, "images", args.vqa_img)
    question, answer = select_row(table, img_path, args.category)

    model = MMBert(cfg, device=dev)
    img_u8 = load_image(img_path, cfg.image_size)
    img = (torch.from_numpy(img_u8).to(dev, torch.float32) / 255.0 - 0.5) / 0.5
    img = img[None]
    enc = encode_text_vqa(question, tok, cfg.max_position_embeddings)
    ids, seg, mask = (torch.from_numpy(a)[None].to(dev) for a in (
        enc.tokens, enc.segment_ids, enc.input_mask))

    loaded = checkpoint.adapt_encoder_layout(
        model.state_dict(), checkpoint.load_weights(args.model_dir))
    checkpoint.check_compatible(model.state_dict(), loaded,
                                what=args.model_dir)
    model.load_state_dict(loaded, strict=True)

    if args.cnn_only:
        acts, grads, pooled, target = cnn_only_activations(model, img)
        logits = pooled  # the stripped classifier's "scores" (feature GAP)
        d = model.trans.deepest
        if args.method == "scorecam":
            def score_fn(masked):
                maps = model.trans.tapped_maps(masked.to(model.dtype))
                return maps[d].mean(dim=(2, 3))[:, target]

            heat = score_cam(acts, img, score_fn)[0]
        elif args.method == "ablationcam":
            heat = ablation_cam(
                acts, lambda a: a.mean(dim=(1, 2))[:, target],
                pooled[:1, target])[0]
        elif args.method == "eigencam":
            heat = CAM_METHODS["eigencam"](acts)[0]
        else:
            heat = CAM_METHODS[args.method](acts, grads)[0]
    elif args.method == "gradcam":
        heat, logits = grad_cam_heatmap(model, img, ids, seg, mask, answer)
    else:
        maps, _ = deepest_map(model, img)
        acts, grads, logits, kept = grad_cam_from_maps(model, maps, ids, seg,
                                                       mask, answer)
        if args.method == "scorecam":
            heat = score_cam(acts, img, vqa_scores(model, ids, seg, mask,
                                                   answer))[0]
        elif args.method == "ablationcam":
            heat = ablation_cam(
                acts, ablation_rerun(model, kept, ids, seg, mask, answer),
                logits[:1, answer])[0]
        elif args.method == "eigencam":
            heat = CAM_METHODS["eigencam"](acts)[0]
        else:
            heat = CAM_METHODS[args.method](acts, grads)[0]
    heat = np.asarray(torch.as_tensor(heat).float().cpu())
    logits = np.asarray(torch.as_tensor(logits).float().cpu())
    overlay = overlay_heatmap(img_u8, heat)

    os.makedirs(args.save_dir, exist_ok=True)
    out_path = os.path.join(args.save_dir, f"{args.category}_{args.vqa_img}")
    with open(out_path, "wb") as f:
        f.write(jpeg.encode(overlay))

    print("question: ", question)
    print("answer: ", answer, idx2ans[answer])
    if args.cnn_only:
        print("target feature channel:", int(np.argmax(logits[0])))
    else:
        pred = int(np.argmax(logits[0]))
        print("preds:", pred, idx2ans[pred])
    print("saved:", out_path)


if __name__ == "__main__":
    main()
