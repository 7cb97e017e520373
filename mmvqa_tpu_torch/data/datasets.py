"""Dataset loading: ROCO (pretrain) and VQA-Med 2019 (fine-tune), the
counterpart of mmvqa_tpu/data/datasets.py, reading its CSVs without pandas.

On-disk layouts are the reference's, so existing data directories work
unchanged:

ROCO (pretrain/roco_utils.py:71-97, 545-587):
  <data_dir>/{train,validation}/radiology/images/<name>
  <data_dir>/{train,validation}/radiology/{traindata,valdata}.csv  (name,caption[,fr,de,es])
  <data_dir>/vocab/med_vocab.pkl  {roco_id: [keywords]}

VQA-Med 2019 (vqamed2019/utils.py:51-79):
  <data_dir>/{traindf,valdf,testdf}.csv  (img_id,question,answer,category,mode)
  <data_dir>/{Train,Val,Test}/images/<img_id>.jpg

``Table`` keeps the pandas behaviour the JAX package relies on: an empty
cell is NaN (``str`` of it is ``"nan"``), ``sample(frac)`` draws
``np.random.choice(n, round(frac * n), replace=False)`` from numpy's global
generator, ``unique`` keeps first-seen order. Unlike pandas it keeps every
other cell as the text the file holds (a column of numbers stays text).
"""

from __future__ import annotations

import csv
import os
import pickle
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mmvqa_tpu_torch.core.config import Config
from mmvqa_tpu_torch.data.images import load_image, random_rotate_host
from mmvqa_tpu_torch.data.text_encoding import (
    encode_text_distillation,
    encode_text_mlm,
    encode_text_vqa,
    flatten_keywords,
)
from mmvqa_tpu_torch.data.tokenizer import WordPieceTokenizer

# hard-coded bad samples dropped by the reference (roco_train.py:70-72)
ROCO_BAD_IMAGES = (
    "PMC4345544_yjbm_88_1_93_g04.jpg",
    "PMC4240561_MA-68-291-g002.jpg",
    "PMC4093298_jadp-03-059-g02.jpg",
)


class Table:
    """Rows of a CSV by position, with the few frame operations the
    datasets use."""

    def __init__(self, columns: Sequence[str], rows: Sequence[Sequence]):
        self.columns = list(columns)
        self.rows = [list(r) for r in rows]
        self._pos = {c: i for i, c in enumerate(self.columns)}

    @classmethod
    def read_csv(cls, path: str) -> "Table":
        with open(path, newline="", encoding="utf-8") as f:
            reader = csv.reader(f)
            columns = next(reader)
            rows = [[float("nan") if cell == "" else cell for cell in row]
                    for row in reader if row]
        return cls(columns, rows)

    def __len__(self) -> int:
        return len(self.rows)

    def column(self, name: str) -> list:
        i = self._pos[name]
        return [r[i] for r in self.rows]

    def cell(self, row: int, name: str):
        return self.rows[row][self._pos[name]]

    def map_column(self, name: str, fn: Callable) -> "Table":
        i = self._pos[name]
        return Table(self.columns,
                     [r[:i] + [fn(r[i])] + r[i + 1:] for r in self.rows])

    def where(self, keep: Sequence[bool]) -> "Table":
        return Table(self.columns, [r for r, k in zip(self.rows, keep) if k])

    def take(self, idx: Sequence[int]) -> "Table":
        return Table(self.columns, [self.rows[int(i)] for i in idx])

    def sample(self, frac: float) -> "Table":
        """``DataFrame.sample(frac=frac)`` without a random state: numpy's
        global generator."""
        n = len(self.rows)
        return self.take(np.random.choice(n, size=round(frac * n),
                                          replace=False))

    def unique(self, name: str) -> list:
        return list(dict.fromkeys(self.column(name)))

    def rename(self, columns: Sequence[str]) -> "Table":
        """``df.columns = columns``."""
        if len(columns) != len(self.columns):
            raise ValueError(f"{len(columns)} names for {len(self.columns)} "
                             "columns")
        return Table(columns, self.rows)

    def drop(self, names: Sequence[str]) -> "Table":
        keep = [i for i, c in enumerate(self.columns) if c not in names]
        return Table([self.columns[i] for i in keep],
                     [[r[i] for i in keep] for r in self.rows])

    def with_column(self, name: str, value) -> "Table":
        """``df[name] = value`` for a new column of one value."""
        if name in self._pos:
            raise ValueError(f"column {name!r} exists")
        return Table(self.columns + [name], [r + [value] for r in self.rows])

    @staticmethod
    def concat(tables: Sequence["Table"]) -> "Table":
        """``pd.concat``: the columns of the first table, then any new
        column of a later one in first-seen order; a cell a table lacks is
        NaN."""
        columns = list(dict.fromkeys(c for t in tables for c in t.columns))
        rows = []
        for t in tables:
            if t.columns == columns:
                rows.extend(t.rows)
            else:
                rows.extend([r[t._pos[c]] if c in t._pos else float("nan")
                             for c in columns] for r in t.rows)
        return Table(columns, rows)


def _lower(x):
    """``Series.str.lower()``: NaN stays NaN."""
    return x.lower() if isinstance(x, str) else x


def _decode_image(cache, path: str, size: int) -> np.ndarray:
    """Decode via the optional cache (RamImageCache / DecodedImageCache):
    the one place both datasets route decodes through."""
    if cache is not None:
        return cache.load(path, size)
    return load_image(path, size)


def get_keywords(data_dir: str) -> List[str]:
    """med_vocab.pkl -> flat keyword list (roco_utils.py:47-63)."""
    with open(os.path.join(data_dir, "vocab", "med_vocab.pkl"), "rb") as f:
        key = pickle.load(f)
    return flatten_keywords(key)


def load_mlm_data(cfg: Config) -> Tuple[Table, Table]:
    """traindata/valdata CSVs filtered to images on disk (roco_utils.py:71-97),
    with the known-bad exclusions applied (roco_train.py:70-72)."""
    train_path = os.path.join(cfg.data_dir, "train", "radiology")
    val_path = os.path.join(cfg.data_dir, "validation", "radiology")
    train_names = set(os.listdir(os.path.join(train_path, "images")))
    val_names = set(os.listdir(os.path.join(val_path, "images")))
    train = Table.read_csv(os.path.join(train_path, "traindata.csv"))
    train = train.where([n in train_names and n not in ROCO_BAD_IMAGES
                         for n in train.column("name")])
    val = Table.read_csv(os.path.join(val_path, "valdata.csv"))
    val = val.where([n in val_names for n in val.column("name")])
    if cfg.train_pct != 1.0:
        train = train.sample(cfg.train_pct)
    if cfg.valid_pct != 1.0:
        val = val.sample(cfg.valid_pct)
    return train, val


def load_vqa_data(cfg: Config) -> Tuple[Table, Table, Table]:
    """traindf/valdf/testdf with path mapping + lowercasing
    (vqamed2019/utils.py:51-79)."""
    tables = []
    for split, sub in (("traindf", "Train"), ("valdf", "Val"), ("testdf", "Test")):
        t = Table.read_csv(os.path.join(cfg.data_dir, f"{split}.csv"))
        t = t.map_column("img_id", lambda x: os.path.join(
            cfg.data_dir, sub, "images", x + ".jpg"))
        t = t.map_column("category", _lower).map_column("answer", _lower)
        tables.append(t)
    train, val, test = tables
    if cfg.train_pct != 1.0:
        train = train.sample(cfg.train_pct)
    if cfg.valid_pct != 1.0:
        val = val.sample(cfg.valid_pct)
    if cfg.test_pct != 1.0:
        test = test.sample(cfg.test_pct)
    return train, val, test


def build_answer_vocab(
    train: Table, val: Table, test: Table, category: Optional[str] = None,
) -> Tuple[Table, Table, Table, Dict[int, str], int]:
    """Answer-id mapping over the train+val+test union in first-seen order
    (train.py:101-110; pandas .unique() is insertion-ordered, which is what
    makes train- and eval-time vocabs line up in the reference)."""
    tables = [train, val, test]
    if category:
        tables = [t.where([c == category for c in t.column("category")])
                  for t in tables]
        tables = [t.where([a not in ("yes", "no") for a in t.column("answer")])
                  for t in tables]
    union = Table.concat(tables)
    ans2idx = {ans: idx for idx, ans in enumerate(union.unique("answer"))}
    idx2ans = {idx: ans for ans, idx in ans2idx.items()}
    union = union.map_column("answer", lambda a: int(ans2idx[a]))
    modes = union.column("mode")
    train, val, test = (union.where([m == mode for m in modes])
                        for mode in ("train", "val", "test"))
    return train, val, test, idx2ans, len(ans2idx)


# ---------------------------------------------------------------------------
# indexable datasets producing fixed-shape numpy sample dicts
# ---------------------------------------------------------------------------

@dataclass
class ROCODataset:
    """(roco_utils.py:545-587). ``two_text_views=True`` adds the
    back-translated caption pick for SupCon (supcon_utils.py:219-244)."""

    cfg: Config
    df: Table
    tokenizer: WordPieceTokenizer
    keywords: Sequence[str]
    mode: str  # 'train' | 'validation'
    two_text_views: bool = False
    rotate_deg: float = 5.0  # host half of RandomRotation (train only)
    # optional decode cache (images.RamImageCache / DecodedImageCache):
    # caches only the deterministic decode half; rotation and masking stay
    # per-epoch random
    image_cache: Optional[object] = None
    _rows: list = field(init=False)

    def __post_init__(self):
        self._rows = self.df.rows
        self._keyset = set(self.keywords)
        self._rand = random.Random(self.cfg.seed)
        self._nprand = np.random.default_rng(self.cfg.seed)

    def __len__(self) -> int:
        return len(self._rows)

    def image_path(self, idx: int) -> str:
        name = self._rows[idx][1]
        return os.path.join(
            self.cfg.data_dir, self.mode, "radiology", "images", name
        )

    def _teacher(self):
        """Lazy ClinicalBERT teacher for --task distillation
        (roco_utils.py:554-562); requires a local checkpoint."""
        if not hasattr(self, "_teacher_fn"):
            try:
                import torch
                from transformers import AutoModel

                model = AutoModel.from_pretrained(
                    self.cfg.clinicalbert, local_files_only=True
                ).eval()
            except Exception as e:
                raise RuntimeError(
                    "distillation needs a local ClinicalBERT checkpoint "
                    f"({self.cfg.clinicalbert}): {e}"
                ) from e

            def run(ids):
                with torch.no_grad():
                    t = torch.from_numpy(np.asarray(ids)).long()
                    return model(t, torch.ones_like(t)).last_hidden_state.numpy()

            self._teacher_fn = run
        return self._teacher_fn

    def _decode(self, idx: int) -> np.ndarray:
        return _decode_image(
            self.image_cache, self.image_path(idx), self.cfg.image_size
        )

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img = self._decode(idx)
        if self.mode == "train":
            img = random_rotate_host(img, self.rotate_deg, self._nprand)
        caption = str(self._rows[idx][2]).strip()
        if self.cfg.task == "distillation":
            enc = encode_text_distillation(
                caption, self.tokenizer, self._teacher(), self.cfg.num_vis,
                self.cfg.max_position_embeddings, self.cfg.max_token_length,
            )
            return {
                "image": img,
                "tokens": enc.tokens,
                "segment_ids": enc.segment_ids,
                "input_mask": enc.input_mask,
                "labels": enc.labels,
            }
        enc = encode_text_mlm(
            caption, self.tokenizer, self._keyset, self.cfg.num_vis,
            self.cfg.max_position_embeddings, self.cfg.mlm_prob, self._rand,
        )
        out = {
            "image": img,
            "tokens": enc.tokens,
            "segment_ids": enc.segment_ids,
            "input_mask": enc.input_mask,
            "labels": enc.labels,
        }
        if self.two_text_views:
            # random back-translation column 3..5 (supcon_utils.py:237-244)
            col = self._rand.randint(3, 5)
            aug_caption = str(self._rows[idx][col]).strip()
            aug = encode_text_mlm(
                aug_caption, self.tokenizer, self._keyset, self.cfg.num_vis,
                self.cfg.max_position_embeddings, self.cfg.mlm_prob,
                self._rand,
            )
            out["aug_tokens"] = aug.tokens
            out["aug_labels"] = aug.labels
            out["caption"] = caption
            out["aug_caption"] = aug_caption
        return out


@dataclass
class VQADataset:
    """(vqamed2019/utils.py:215-257). Train mode adds the category id using
    first-seen category order (utils.py:227-229)."""

    cfg: Config
    df: Table
    tokenizer: WordPieceTokenizer
    mode: str  # 'train' | 'eval' | 'test'
    rotate_deg: float = 10.0  # host half of RandomRotation (train only)
    image_cache: Optional[object] = None  # decode cache (see ROCODataset)
    _cats2ans: Dict[str, int] = field(init=False, default_factory=dict)

    def __post_init__(self):
        self._nprand = np.random.default_rng(self.cfg.seed)
        if self.mode == "train":
            cats = self.df.unique("category")
            self._cats2ans = {c: i for i, c in enumerate(cats)}

    def __len__(self) -> int:
        return len(self.df)

    @property
    def cats2ans(self) -> Dict[str, int]:
        return self._cats2ans

    def image_path(self, idx: int) -> str:
        return self.df.cell(idx, "img_id")

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img = _decode_image(
            self.image_cache, self.image_path(idx), self.cfg.image_size
        )
        if self.mode == "train":
            img = random_rotate_host(img, self.rotate_deg, self._nprand)
        enc = encode_text_vqa(
            str(self.df.cell(idx, "question")), self.tokenizer,
            self.cfg.max_position_embeddings,
        )
        out = {
            "image": img,
            "tokens": enc.tokens,
            "segment_ids": enc.segment_ids,
            "input_mask": enc.input_mask,
            "answer": np.asarray(self.df.cell(idx, "answer"), np.int32),
        }
        if self.mode == "train":
            out["category"] = np.asarray(
                self._cats2ans[self.df.cell(idx, "category")], np.int32
            )
        return out
