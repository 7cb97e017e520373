"""Per-category label-smoothing table (the host half of LabelSmoothByCategory;
counterpart of mmvqa_tpu/train/category_smoothing.py).

Per question category, a vector spreads ``smoothing`` mass uniformly over
the answers that occur in that category in the train split
(vqamed2019/utils.py:1266-1293); the train step then sets the true answer's
entry to ``1 - smoothing`` per sample (:1247-1256,
``train.steps.make_vqa_steps``). The vectors are stacked into one
(n_categories, num_classes) array indexed by the dataset's category ids.

The JAX function reads a pandas DataFrame; this one takes the split's
``category`` and ``answer`` columns as arrays, so that it runs where pandas
is not installed.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def build_category_smoothing_table(
    categories: Sequence,
    answers: Sequence[int],
    num_classes: int,
    cats2ans: Dict[str, int],
    smoothing: float = 0.1,
) -> np.ndarray:
    categories = np.asarray(categories)
    answers = np.asarray(answers, int)
    table = np.zeros((len(cats2ans), num_classes), np.float32)
    for cat, row in cats2ans.items():
        idx = np.unique(answers[categories == cat])
        if len(idx):
            table[row, idx] = smoothing / len(idx)
    return table
