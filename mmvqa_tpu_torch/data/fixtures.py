"""Hermetic synthetic datasets in the on-disk layouts the datasets read
(counterpart of mmvqa_tpu/data/fixtures.py), written without pandas or PIL:
CSVs through the ``csv`` module and JPEGs through the numpy encoder of
``data/jpeg.py``, so that the card's machine can write its own.

Captions, questions, keywords, answers and ``vocab.txt`` come from the same
``random.Random(seed)`` draws as the JAX package's fixtures, and the pixels
from the same ``np.random.default_rng(seed)`` draws; only the JPEG bytes
differ (another encoder). ``image_size`` is a side or a ``(width, height)``
pair.
"""

from __future__ import annotations

import csv
import os
import pickle
import random
from typing import List, Sequence, Tuple, Union

import numpy as np

from mmvqa_tpu_torch.data import jpeg
from mmvqa_tpu_torch.data.tokenizer import build_vocab_from_corpus, write_vocab

WORDS = (
    "chest x-ray shows bilateral pneumonia with pleural effusion ct scan of "
    "the abdomen demonstrates hepatic lesion mri axial view brain tumour in "
    "left lobe ultrasound image gallbladder cholecystitis suspected plane "
    "lungs heart normal abnormal mass fracture bone spine contrast sagittal "
    "coronal radiograph lateral"
).split()
KEYWORDS = ["pneumonia", "effusion", "lesion", "tumour", "fracture", "mass"]
CATEGORIES = ["plane", "modality", "binary", "organ", "abnormality"]
ANSWERS = {
    "plane": ["axial", "sagittal", "coronal", "lateral"],
    "modality": ["ct", "mri", "ultrasound", "x-ray"],
    "binary": ["yes", "no"],
    "organ": ["lung", "heart", "brain", "liver"],
    "abnormality": ["pneumonia", "tumour", "fracture", "mass"],
}
ImageSize = Union[int, Tuple[int, int]]


def _caption(rng: random.Random, n: int = 10) -> str:
    words = [rng.choice(WORDS) for _ in range(n)]
    words.insert(rng.randrange(n), rng.choice(KEYWORDS))
    return " ".join(words)


def _write_image(path: str, rng: np.random.Generator, size: ImageSize) -> None:
    w, h = (size, size) if isinstance(size, int) else size
    arr = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(jpeg.encode(arr))


def _write_csv(path: str, columns: Sequence[str], rows: List[dict]) -> None:
    """As ``pd.DataFrame(rows).to_csv(path, index=False)`` writes it."""
    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow(columns)
        for row in rows:
            out.writerow([row[c] for c in columns])


def make_roco_fixture(
    root: str, n_train: int = 16, n_val: int = 8, seed: int = 0,
    image_size: ImageSize = 64,
) -> str:
    """<root>/{train,validation}/radiology/{images,csv} + vocab/med_vocab.pkl
    + vocab.txt (WordPiece vocab over the fixture corpus)."""
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    captions: List[str] = []
    for split, n, name_csv in (
        ("train", n_train, "traindata.csv"),
        ("validation", n_val, "valdata.csv"),
    ):
        img_dir = os.path.join(root, split, "radiology", "images")
        os.makedirs(img_dir, exist_ok=True)
        rows = []
        for i in range(n):
            name = f"ROCO_{split}_{i:04d}.jpg"
            _write_image(os.path.join(img_dir, name), nrng, image_size)
            cap = _caption(rng)
            captions.append(cap)
            # columns: id,name,caption,fr,de,es (back-translation columns
            # 3..5 as consumed by supcon_utils.py:237-244)
            rows.append({"id": f"ROCO_{i}", "name": name, "caption": cap,
                         "fr": cap + " fr", "de": cap + " de",
                         "es": cap + " es"})
        _write_csv(os.path.join(root, split, "radiology", name_csv),
                   ("id", "name", "caption", "fr", "de", "es"), rows)
    os.makedirs(os.path.join(root, "vocab"), exist_ok=True)
    med = {f"ROCO_{i}": rng.sample(KEYWORDS, 2) for i in range(n_train)}
    with open(os.path.join(root, "vocab", "med_vocab.pkl"), "wb") as f:
        pickle.dump(med, f)
    _write_wordpiece_vocab(root, captions)
    return root


def make_vqa_fixture(
    root: str, n_per_cat: Union[int, Tuple[int, int, int]] = 4, seed: int = 0,
    image_size: ImageSize = 64,
) -> str:
    """<root>/{traindf,valdf,testdf}.csv + {Train,Val,Test}/images, with
    ``n_per_cat`` questions of each category in each split, or a
    (train, val, test) triple of such counts."""
    counts = ((n_per_cat,) * 3 if isinstance(n_per_cat, int)
              else tuple(n_per_cat))
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    questions = []
    for (split, mode), n in zip(
            (("Train", "train"), ("Val", "val"), ("Test", "test")), counts):
        img_dir = os.path.join(root, split, "images")
        os.makedirs(img_dir, exist_ok=True)
        rows = []
        for cat in CATEGORIES:
            for i in range(n):
                img_id = f"synpic_{mode}_{cat}_{i}"
                _write_image(os.path.join(img_dir, img_id + ".jpg"), nrng,
                             image_size)
                q = f"what {cat} is shown in this {rng.choice(WORDS)} image"
                questions.append(q)
                rows.append({"img_id": img_id, "question": q,
                             "answer": rng.choice(ANSWERS[cat]),
                             "category": cat, "mode": mode})
        name = {"train": "traindf", "val": "valdf", "test": "testdf"}[mode]
        _write_csv(os.path.join(root, f"{name}.csv"),
                   ("img_id", "question", "answer", "category", "mode"), rows)
    _write_wordpiece_vocab(root, questions + [" ".join(WORDS)])
    return root


def _write_wordpiece_vocab(root: str, texts: List[str]) -> None:
    corpus = texts + [" ".join(WORDS), " ".join(KEYWORDS)]
    for answers in ANSWERS.values():
        corpus.append(" ".join(answers))
    vocab = build_vocab_from_corpus(corpus, max_size=4000)
    write_vocab(vocab, os.path.join(root, "vocab.txt"))
