"""Generate synthetic ROCO + VQA-Med fixture datasets for smoke runs
(counterpart of mmvqa_tpu/cli/make_fixtures.py), without pandas or PIL.

Usage: python -m mmvqa_tpu_torch.cli.make_fixtures --out DIR
           [--image_size 512 416]   # width [height]; one value: square
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="make synthetic fixture datasets")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--n_train", type=int, default=32)
    p.add_argument("--n_val", type=int, default=16)
    p.add_argument("--n_per_cat", type=int, default=8)
    p.add_argument("--image_size", type=int, nargs="+", default=[224],
                   help="width and height, or one side of a square")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if len(args.image_size) > 2:
        p.error("--image_size takes a width and at most a height")
    size = (args.image_size[0] if len(args.image_size) == 1
            else tuple(args.image_size))

    from mmvqa_tpu_torch.data.fixtures import make_roco_fixture, make_vqa_fixture

    roco = make_roco_fixture(os.path.join(args.out, "roco"), args.n_train,
                             args.n_val, args.seed, size)
    vqa = make_vqa_fixture(os.path.join(args.out, "vqa"), args.n_per_cat,
                           args.seed, size)
    print(f"ROCO fixture: {roco}")
    print(f"VQA-Med fixture: {vqa}")


if __name__ == "__main__":
    main()
