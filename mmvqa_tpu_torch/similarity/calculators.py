"""Caption-similarity calculators for the SupCon mask, copied from
mmvqa_tpu/similarity/calculators.py (which imports no jax, but whose
package ``__init__`` does); tests/test_torch_supcon.py holds the two to the
same masks.

Reference: SimilarityCalculator (supcon_utils.py:86-192) with four backends:
* ``jaccard`` — word-set IoU, diagonal forced to 1 (:110-138). Pure python,
  always available.
* ``cosine`` — ClinicalBERT mean-pooled last-hidden-state cosine (:140-159).
* ``sentence_transformers`` — all-mpnet-base-v2 util.cos_sim (:162-168).
* ``bert_score`` — BERTScorer F1 (:170-182).

The three model-backed backends require their respective checkpoints and
packages; they raise a clear error at construction unless the package is
importable AND its weights are local. These are host-side computations by
design: the mask is a (B, B) host array that the train step moves to the
card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class SimilarityCalculator:
    def __init__(self, similarity: str, device=None, clinicalbert: str = "",
                 bert_score_model: str = "bert", max_token_length: int = 512):
        self.similarity = similarity
        if similarity == "jaccard":
            pass
        elif similarity == "cosine":
            try:
                from transformers import AutoModel, AutoTokenizer

                self._tok = AutoTokenizer.from_pretrained(
                    clinicalbert, model_max_length=max_token_length,
                    local_files_only=True,
                )
                self._model = AutoModel.from_pretrained(
                    clinicalbert, local_files_only=True
                )
            except Exception as e:  # offline / missing weights
                raise RuntimeError(
                    f"cosine similarity needs a local ClinicalBERT checkpoint "
                    f"({clinicalbert}): {e}"
                ) from e
        elif similarity == "sentence_transformers":
            try:
                from sentence_transformers import SentenceTransformer

                self._model = SentenceTransformer("all-mpnet-base-v2")
            except Exception as e:
                raise RuntimeError(
                    f"sentence_transformers backend unavailable: {e}"
                ) from e
        elif similarity == "bert_score":
            try:
                from bert_score import BERTScorer

                if bert_score_model == "scibert":
                    self._scorer = BERTScorer(
                        lang="en", model_type="allenai/scibert_scivocab_uncased"
                    )
                else:
                    self._scorer = BERTScorer(lang="en", rescale_with_baseline=True)
            except Exception as e:
                raise RuntimeError(f"bert_score backend unavailable: {e}") from e
        else:
            raise ValueError(f"unknown similarity {similarity}")

    # -- jaccard (set IoU, supcon_utils.py:110-138) ---------------------------

    @staticmethod
    def jaccard(captions: Sequence[str], augs: Sequence[str]) -> np.ndarray:
        sets1 = [set(c.lower().split()) for c in captions]
        sets2 = [set(a.lower().split()) for a in augs]
        n = len(sets1)
        mask = np.zeros((n, n), np.float32)
        for i, s1 in enumerate(sets1):
            for j, s2 in enumerate(sets2):
                if i == j:
                    mask[i, j] = 1.0
                else:
                    union = s1 | s2
                    mask[i, j] = (
                        len(s1 & s2) / len(union) if union else 0.0
                    )
        return mask

    def _cosine(self, captions, augs) -> np.ndarray:
        import torch

        enc = self._tok(
            list(captions) + list(augs), return_tensors="pt",
            truncation=True, padding=True,
        )
        self._model.eval()
        with torch.no_grad():
            out = self._model(**enc).last_hidden_state
            bsz = len(captions)
            f1, f2 = out[:bsz].mean(1), out[bsz:].mean(1)
            f1 = f1 / f1.norm(dim=1, keepdim=True).clamp_min(1e-8)
            f2 = f2 / f2.norm(dim=1, keepdim=True).clamp_min(1e-8)
            sim = (f1 @ f2.T).numpy()
        np.fill_diagonal(sim, 1.0)
        return sim.astype(np.float32)

    def _sentence(self, captions, augs) -> np.ndarray:
        e1 = self._model.encode(list(captions))
        e2 = self._model.encode(list(augs))
        e1 = e1 / np.linalg.norm(e1, axis=1, keepdims=True)
        e2 = e2 / np.linalg.norm(e2, axis=1, keepdims=True)
        sim = e1 @ e2.T
        np.fill_diagonal(sim, 1.0)
        return sim.astype(np.float32)

    def _bert_score(self, captions, augs) -> np.ndarray:
        n = len(captions)
        mask = np.eye(n, dtype=np.float32)
        for i in range(n):
            for j in range(n):
                if i != j:
                    _, _, f1 = self._scorer.score([captions[i]], [augs[j]])
                    mask[i, j] = float(f1.item())
        return mask

    def __call__(self, captions, augs) -> np.ndarray:
        if self.similarity == "jaccard":
            return self.jaccard(captions, augs)
        if self.similarity == "cosine":
            return self._cosine(captions, augs)
        if self.similarity == "sentence_transformers":
            return self._sentence(captions, augs)
        return self._bert_score(captions, augs)


def build_mask(
    con_task: str,
    captions: Sequence[str],
    augs: Sequence[str],
    calculator: Optional[SimilarityCalculator],
) -> Optional[np.ndarray]:
    """buildMask (supcon_utils.py:195-199): None for simclr."""
    if con_task == "simclr" or calculator is None:
        return None
    return calculator(captions, augs)
