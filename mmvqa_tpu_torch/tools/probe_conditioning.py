"""How far the default model's fp32 train step moves when every K4 output
(conv1x1 + statistics) is nudged by a relative ``--nudge``: the logits, the
loss and each gradient leaf and statistic that ``chip_smoke.py``'s
``default_train_check_fp32`` holds, each as its largest change over its
largest entry, for each bn3 scale factor in ``--scales`` (1: the seed's
weights). Two correct fp32 runs of a step lie about this far apart, so it
is the resolution a card-against-CPU comparison of that step can have.

    python3 mmvqa_tpu_torch/tools/probe_conditioning.py [--device cpu|cuda]
        [--scales 1 0.2] [--nudge 1e-6]

On the CPU it takes about a minute a scale (two steps of ResNet-152 at
B=8, 224 px).
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cpu")
    p.add_argument("--scales", type=float, nargs="+", default=[1.0, 0.2])
    p.add_argument("--nudge", type=float, default=1e-6)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from mmvqa_tpu_torch.core.config import pretrain_config
    from mmvqa_tpu_torch.data.images import PRETRAIN_AUG, sample_draws
    from mmvqa_tpu_torch.data.synthetic import mlm_batches
    from mmvqa_tpu_torch.models import MMBert, effnetv2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = pretrain_config(batch_size=cs.CHECK_B, dropout_override=0.0)
    batch = mlm_batches(cfg, 1, cs.SEED)[0]
    draws = sample_draws(cs.CHECK_B, cfg.image_size,
                         torch.Generator().manual_seed(cs.SEED), PRETRAIN_AUG)
    kernel = effnetv2.conv1x1_stats
    names = ["logits", *cs.DEF_CHECK_LEAVES, *cs.DEF_CHECK_STATS]
    for scale in args.scales:
        model = MMBert(cfg, device=args.device,
                       generator=torch.Generator().manual_seed(cs.SEED))
        with torch.no_grad():
            for name, mod in model.named_modules():
                if name.endswith(".bn3"):
                    mod.weight.mul_(scale)
        twin = copy.deepcopy(model)
        kept = cs.checked_train_step(torch, model, cfg, batch, draws,
                                     leaves=cs.DEF_CHECK_LEAVES,
                                     stats=cs.DEF_CHECK_STATS)
        gen = torch.Generator(device=args.device).manual_seed(cs.SEED)

        def nudged(x, w):
            y, st = kernel(x, w)
            noise = torch.randn(y.shape, device=y.device, generator=gen)
            return y * (1.0 + args.nudge * noise), st

        effnetv2.conv1x1_stats = nudged
        try:
            moved = cs.checked_train_step(torch, twin, cfg, batch, draws,
                                          leaves=cs.DEF_CHECK_LEAVES,
                                          stats=cs.DEF_CHECK_STATS)
        finally:
            effnetv2.conv1x1_stats = kernel
        print(f"bn3 scale x {scale}, K4 outputs nudged by {args.nudge} on "
              f"{args.device}: loss {kept['loss'].item():.6f} -> "
              f"{moved['loss'].item():.6f}")
        for name in names:
            a, b = kept[name].float().cpu(), moved[name].float().cpu()
            change = (a - b).abs().max().item()
            print(f"  {name}: {change:.3e} of max {a.abs().max().item():.3e}"
                  f" ({change / a.abs().max().item():.2e})")


if __name__ == "__main__":
    main()
