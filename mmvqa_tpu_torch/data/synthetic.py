"""Seeded synthetic VQA-Med eval batches and ROCO MLM batches with the JAX
loader's keys.

No dataset ships with the repository; the smoke run feeds the steps with
these. Images are uniform uint8 noise, questions are
random token ids with ``[CLS]`` first, ``[SEP]`` last and zero-padded tails
of random length, answers are uniform over ``num_classes``. Each answer
belongs to one of VQA-Med 2019's five question categories (answer id modulo
five), which gives each sample its ``category`` id, as the category-smoothing
criterion reads it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from mmvqa_tpu_torch.core.config import Config

CLS_ID, SEP_ID, MASK_ID = 101, 102, 103
# VQA-Med 2019's question categories (mmvqa_tpu/evaluation/metrics.py:18),
# in the order of their ids
CATEGORIES = ("binary", "plane", "organ", "modality", "abnormality")
CATS2ANS = {name: i for i, name in enumerate(CATEGORIES)}


def vqa_batches(cfg: Config, n_batches: int, num_classes: int, seed: int = 0,
                pad_last: int = 0) -> List[Dict[str, np.ndarray]]:
    """``n_batches`` batches of ``cfg.batch_size`` at ``cfg.image_size`` and
    T = ``cfg.max_position_embeddings``; the last batch carries
    ``pad_last`` padding samples (weight 0), as an epoch's last one does;
    ``category`` is the answer's category id."""
    rng = np.random.default_rng(seed)
    B, T, S = cfg.batch_size, cfg.max_position_embeddings, cfg.image_size
    batches = []
    for i in range(n_batches):
        lengths = rng.integers(cfg.num_vis + 3, T + 1, size=B)
        mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
        tokens = rng.integers(1000, cfg.vocab_size, size=(B, T))
        tokens[:, 0] = CLS_ID
        tokens[np.arange(B), lengths - 1] = SEP_ID
        weights = np.ones(B, np.float32)
        if i == n_batches - 1 and pad_last:
            weights[B - pad_last:] = 0.0
        batches.append({
            "image": rng.integers(0, 256, size=(B, S, S, 3), dtype=np.uint8),
            "tokens": (tokens * mask).astype(np.int32),
            "segment_ids": np.zeros((B, T), np.int32),
            "input_mask": mask,
            "answer": rng.integers(0, num_classes, size=B).astype(np.int32),
            "weights": weights,
        })
        batches[-1]["category"] = (batches[-1]["answer"] % len(CATEGORIES)
                                   ).astype(np.int32)
    return batches


def smoothing_columns(batches: Sequence[Dict[str, np.ndarray]]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The train split's ``category`` (names) and ``answer`` columns over
    the real samples of ``batches``: what
    ``train.category_smoothing.build_category_smoothing_table`` takes, with
    ``CATS2ANS``."""
    real = np.concatenate([b["weights"] for b in batches]) > 0
    cats = np.concatenate([b["category"] for b in batches])[real]
    answers = np.concatenate([b["answer"] for b in batches])[real]
    return np.asarray(CATEGORIES)[cats], answers


def mlm_batches(cfg: Config, n_batches: int, seed: int = 0,
                pad_last: int = 0) -> List[Dict[str, np.ndarray]]:
    """``n_batches`` ROCO MLM batches of ``cfg.batch_size``: captions of
    random ids and random length behind the ``cfg.num_vis`` visual slots,
    ``cfg.mlm_prob`` of the caption tokens replaced by ``[MASK]`` with the
    original id as the label (0 = not masked); the last batch carries
    ``pad_last`` padding samples (weight 0)."""
    rng = np.random.default_rng(seed)
    B, T, S = cfg.batch_size, cfg.max_position_embeddings, cfg.image_size
    first = cfg.num_vis + 1  # visual slots, then [CLS]
    batches = []
    for i in range(n_batches):
        lengths = rng.integers(first + 2, T + 1, size=B)
        pos = np.arange(T)[None]
        mask = (pos < lengths[:, None]).astype(np.float32)
        low = min(1000, cfg.vocab_size // 2)  # past BERT's special ids
        tokens = rng.integers(low, cfg.vocab_size, size=(B, T))
        tokens[:, :first] = CLS_ID
        tokens[np.arange(B), lengths - 1] = SEP_ID
        tokens = (tokens * mask).astype(np.int32)
        caption = (pos >= first) & (pos < lengths[:, None] - 1)
        masked = caption & (rng.random((B, T)) < cfg.mlm_prob)
        labels = np.where(masked, tokens, 0).astype(np.int32)
        tokens = np.where(masked, min(MASK_ID, cfg.vocab_size - 1),
                          tokens).astype(np.int32)
        weights = np.ones(B, np.float32)
        if i == n_batches - 1 and pad_last:
            weights[B - pad_last:] = 0.0
        batches.append({
            "image": rng.integers(0, 256, size=(B, S, S, 3), dtype=np.uint8),
            "tokens": tokens,
            "segment_ids": np.zeros((B, T), np.int32),
            "input_mask": mask,
            "labels": labels,
            "weights": weights,
        })
    return batches
