"""Sequence layout + keyword-targeted MLM masking (host-side, fixed shapes),
copied from mmvqa_tpu/data/text_encoding.py; tests/test_torch_text.py holds
the two copies to the same arrays under the same ``random.Random``.

Parity targets:
* ``mask_word`` (pretrain/roco_utils.py:135-160): only whitespace-split words
  present in the ROCO keyword list are mask candidates; each of their
  wordpieces is masked independently with prob ``mlm_prob``; label = original
  token id, 0 elsewhere.
* ``encode_text`` MLM layout (roco_utils.py:162-199):
  ``[CLS] + num_vis*0 + [SEP] + caption + [SEP]`` padded to
  ``max_position_embeddings``; segment ids 0 over the visual part, 1 over the
  text; labels ``[0]*(2+num_vis) + word_labels + [0] + pad``.
* VQA layout (vqamed2019/utils.py:156-170): hard-codes FIVE visual slots and
  a ``max_position_embeddings - 8`` text budget regardless of --num_vis
  (reference inconsistency, preserved).

All outputs are fixed-shape numpy arrays ready to batch.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Set, Tuple

import numpy as np

from mmvqa_tpu_torch.data.tokenizer import WordPieceTokenizer


@dataclass
class EncodedText:
    tokens: np.ndarray       # (T,) int32
    segment_ids: np.ndarray  # (T,) int32
    input_mask: np.ndarray   # (T,) float32
    labels: np.ndarray       # (T,) int32 (MLM) — zeros for VQA


def mask_word(
    sentence: str,
    tokenizer: WordPieceTokenizer,
    keywords: Set[str],
    mlm_prob: float,
    rng: random.Random,
) -> Tuple[List[str], List[int]]:
    """Keyword-targeted wordpiece masking (roco_utils.py:135-160).

    The reference labels a masked piece with ``tokenizer.encode(t[j])[1]`` —
    the first wordpiece id of RE-tokenizing that piece in isolation (for a
    '##'-continuation piece this re-tokenizes without the prefix; faithful).
    """
    new_tokens: List[str] = []
    labels: List[int] = []
    for word in sentence.split():
        pieces = tokenizer.tokenize(word)
        if word in keywords:
            for j, piece in enumerate(pieces):
                if rng.random() < mlm_prob:
                    labels.append(tokenizer.encode(piece)[1])
                    pieces[j] = "[MASK]"
                else:
                    labels.append(0)
            new_tokens.extend(pieces)
        else:
            new_tokens.extend(pieces)
            labels.extend([0] * len(pieces))
    assert len(new_tokens) == len(labels)
    return new_tokens, labels


def encode_text_mlm(
    caption: str,
    tokenizer: WordPieceTokenizer,
    keywords: Set[str],
    num_vis: int,
    max_position_embeddings: int,
    mlm_prob: float,
    rng: random.Random,
) -> EncodedText:
    """MLM layout (roco_utils.py:162-199)."""
    total_special = num_vis + 3
    budget = max_position_embeddings - total_special
    pieces, labels = mask_word(caption, tokenizer, keywords, mlm_prob, rng)
    ids = tokenizer.convert_tokens_to_ids(pieces)[:budget]
    labels = labels[:budget]

    tokens = (
        [tokenizer.cls_token_id]
        + [0] * num_vis
        + [tokenizer.sep_token_id]
        + ids
        + [tokenizer.sep_token_id]
    )
    segment_ids = [0] * (num_vis + 2) + [1] * (len(ids) + 1)
    input_mask = [1] * len(tokens)
    n_pad = max_position_embeddings - len(tokens)
    tokens += [0] * n_pad
    segment_ids += [0] * n_pad
    input_mask += [0] * n_pad
    full_labels = [0] * (2 + num_vis) + labels + [0] + [0] * n_pad
    return EncodedText(
        tokens=np.asarray(tokens, np.int32),
        segment_ids=np.asarray(segment_ids, np.int32),
        input_mask=np.asarray(input_mask, np.float32),
        labels=np.asarray(full_labels, np.int32),
    )


def encode_text_vqa(
    question: str,
    tokenizer: WordPieceTokenizer,
    max_position_embeddings: int,
) -> EncodedText:
    """VQA layout with hard-coded 5 visual slots (vqamed2019/utils.py:156-170)."""
    part1 = [0] * 5
    part2 = tokenizer.encode(question)[1:-1]
    budget = max_position_embeddings - 8
    tokens = (
        [tokenizer.cls_token_id]
        + part1
        + [tokenizer.sep_token_id]
        + part2[:budget]
        + [tokenizer.sep_token_id]
    )
    segment_ids = [0] * 7 + [1] * (len(part2[:budget]) + 1)
    input_mask = [1] * len(tokens)
    n_pad = max_position_embeddings - len(tokens)
    tokens += [0] * n_pad
    segment_ids += [0] * n_pad
    input_mask += [0] * n_pad
    return EncodedText(
        tokens=np.asarray(tokens, np.int32),
        segment_ids=np.asarray(segment_ids, np.int32),
        input_mask=np.asarray(input_mask, np.float32),
        labels=np.zeros(max_position_embeddings, np.int32),
    )


def encode_text_distillation(
    caption: str,
    tokenizer,
    teacher,
    num_vis: int,
    max_position_embeddings: int,
    max_token_length: int,
) -> EncodedText:
    """Distillation layout (roco_utils.py:112-132, 162-199): labels are the
    teacher's last-hidden-state vectors for the caption tokens (CLS/SEP
    stripped), zero vectors elsewhere; same [CLS]+vis+[SEP]+text+[SEP] token
    layout as MLM. ``teacher(input_ids, attention_mask)`` -> (1, L, H) array.
    """
    total_special = num_vis + 3
    budget = max_position_embeddings - total_special
    pieces = tokenizer.tokenize(caption)[: max_token_length - 2]
    ids = tokenizer.convert_tokens_to_ids(pieces)
    teach_in = np.asarray(
        [[tokenizer.cls_token_id] + ids + [tokenizer.sep_token_id]], np.int32
    )
    hidden = np.asarray(teacher(teach_in))  # (1, L, H)
    vec_labels = hidden[0, 1:-1]  # strip CLS/SEP (roco_utils.py:127-129)

    ids = ids[:budget]
    vec_labels = vec_labels[:budget]
    tokens = (
        [tokenizer.cls_token_id] + [0] * num_vis + [tokenizer.sep_token_id]
        + ids + [tokenizer.sep_token_id]
    )
    segment_ids = [0] * (num_vis + 2) + [1] * (len(ids) + 1)
    input_mask = [1] * len(tokens)
    n_pad = max_position_embeddings - len(tokens)
    tokens += [0] * n_pad
    segment_ids += [0] * n_pad
    input_mask += [0] * n_pad
    H = vec_labels.shape[-1]
    labels = np.zeros((max_position_embeddings, H), np.float32)
    labels[num_vis + 2 : num_vis + 2 + len(ids)] = vec_labels
    return EncodedText(
        tokens=np.asarray(tokens, np.int32),
        segment_ids=np.asarray(segment_ids, np.int32),
        input_mask=np.asarray(input_mask, np.float32),
        labels=labels,
    )


def flatten_keywords(key_dict: dict) -> List[str]:
    """med_vocab.pkl {roco_id: [keywords]} -> flat keyword list
    (roco_utils.py:47-63). The reference's ``keywords.extend(word + '.')``
    extends with the CHARACTERS of "word." (a str is iterable) — faithfully
    reproduced: the net effect is adding single characters to the list.
    """
    keywords: List[str] = []
    for v in key_dict.values():
        keywords.extend(v)
    uniq = list(set(keywords))
    for word in uniq:
        keywords.extend(word + ".")  # iterates characters, as the reference
    return list(set(keywords))
