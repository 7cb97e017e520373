"""Evaluation metrics and artifact writers (counterpart of
mmvqa_tpu/evaluation/metrics.py), without nltk or pandas:

* exact-match accuracy, overall and per category (vqamed2019/utils.py:745-753);
* unigram BLEU between decoded answer strings, nltk's
  ``sentence_bleu([ref.split()], hyp.split(), weights=[1])``
  (utils.py:328-330) written out: clipped unigram precision times the
  brevity penalty ``exp(1 - r / c)`` where the hypothesis is shorter than
  the reference, 0 where no word matches;
* the prediction CSV and the pipe-separated ImageCLEF submission file
  (eval.py:171-178), written by the ``csv`` module as pandas' ``to_csv``
  writes them (minimal quoting, ``"\\n"`` line ends), so that both files
  equal the JAX package's byte for byte.
"""

from __future__ import annotations

import csv
import math
import os
from collections import Counter
from typing import Dict, Mapping, Sequence

import numpy as np

from mmvqa_tpu_torch.data.datasets import Table

CATEGORIES = ("binary", "plane", "organ", "modality", "abnormality")


def sentence_bleu1(reference: Sequence[str], hypothesis: Sequence[str]) -> float:
    """nltk's ``sentence_bleu([reference], hypothesis, weights=[1])`` for one
    reference, with nltk's arithmetic (its ``Fraction`` taken to a float,
    then ``exp(log(p))``)."""
    counts = Counter(hypothesis)
    ref_counts = Counter(reference)
    matched = sum(min(n, ref_counts[w]) for w, n in counts.items())
    if matched == 0:
        return 0.0
    total = max(1, sum(counts.values()))
    c, r = len(hypothesis), len(reference)
    bp = 1.0 if c > r else math.exp(1 - r / c)
    return bp * math.exp(math.fsum([math.log(matched / total)]))


def bleu_score(
    preds: np.ndarray, targets: np.ndarray, idx2ans: Mapping[int, str]
) -> float:
    """The mean of the samples' unigram BLEU (utils.py:328-330); nan for no
    sample."""
    if len(preds) == 0:
        return float("nan")
    scores = [sentence_bleu1(idx2ans[int(t)].split(), idx2ans[int(p)].split())
              for p, t in zip(preds, targets)]
    return float(np.mean(scores))


def per_category_accuracy(
    preds: np.ndarray,
    targets: np.ndarray,
    categories: Sequence[str],
    prefix: str = "",
) -> Dict[str, float]:
    cats = np.asarray(categories)
    acc = {f"{prefix}total_acc": float((preds == targets).mean() * 100.0)}
    for c in CATEGORIES:
        sel = cats == c
        key = "abnorm" if c == "abnormality" else c
        acc[f"{prefix}{key}_acc"] = float(
            (preds[sel] == targets[sel]).mean() * 100.0
        ) if sel.any() else float("nan")
    return {k: round(v, 4) for k, v in acc.items()}


def per_category_bleu(
    preds: np.ndarray,
    targets: np.ndarray,
    categories: Sequence[str],
    idx2ans: Mapping[int, str],
    prefix: str = "",
) -> Dict[str, float]:
    cats = np.asarray(categories)
    bleu = {f"{prefix}total_bleu": bleu_score(preds, targets, idx2ans)}
    for c in CATEGORIES:
        sel = cats == c
        key = "abnorm" if c == "abnormality" else c
        bleu[f"{prefix}{key}_bleu"] = bleu_score(
            preds[sel], targets[sel], idx2ans
        )
    return {k: round(v, 4) for k, v in bleu.items()}


def _cell(x) -> str:
    """A cell as ``to_csv`` writes it: NaN empty, anything else its str."""
    if isinstance(x, float) and math.isnan(x):
        return ""
    return str(x)


def _write_rows(path: str, rows, delimiter: str = ",") -> None:
    with open(path, "w", newline="", encoding="utf-8") as f:
        out = csv.writer(f, delimiter=delimiter, lineterminator="\n")
        for row in rows:
            out.writerow([_cell(x) for x in row])


def write_predictions(
    test_df: Table,
    preds: np.ndarray,
    idx2ans: Mapping[int, str],
    out_csv: str,
) -> Table:
    """<model>_preds.csv: the test rows with ``preds``, ``decode_preds`` and
    ``decode_ans`` added (eval.py:171-174). Returns that table."""
    if len(preds) != len(test_df):
        raise ValueError(f"{len(preds)} predictions for {len(test_df)} rows")
    answers = test_df.column("answer")
    table = Table(
        test_df.columns + ["preds", "decode_preds", "decode_ans"],
        [row + [int(p), idx2ans[int(p)], idx2ans[int(a)]]
         for row, p, a in zip(test_df.rows, preds, answers)])
    _write_rows(out_csv, [table.columns] + table.rows)
    return table


def write_submission(
    test_df: Table,
    preds: np.ndarray,
    idx2ans: Mapping[int, str],
    out_txt: str,
) -> None:
    """ImageCLEF submission: ``img_id|answer`` rows, no header
    (eval.py:176-178)."""
    img_ids = [os.path.basename(p).rsplit(".", 1)[0]
               for p in test_df.column("img_id")]
    _write_rows(out_txt, zip(img_ids, (idx2ans[int(p)] for p in preds)),
                delimiter="|")


def ensemble_logits(all_logits: Sequence[np.ndarray]) -> np.ndarray:
    """final_test averaging (utils.py:845-872): mean of per-model logits."""
    return np.mean(np.stack(all_logits), axis=0)
