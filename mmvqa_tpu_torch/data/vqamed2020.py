"""VQA-Med 2020 auxiliary data paths (counterpart of
mmvqa_tpu/data/vqamed2020.py; reference vqamed2019/utils.py:81-147, 260-324),
on the port's ``Table`` instead of pandas.

* ``load_2020_data``: the 2020 train and val CSVs with the hard-coded bad
  images and the yes/no questions taken out, merged with the 2019 data
  (relabelled with the keyword 'abnorm') whose answers occur in the 2020
  class set; answer and keyword vocabularies sorted over train + val
  (utils.py:81-147).
* ``VQAMed2020Dataset``: imgid/question/answer[/keyword] rows.
* ``VQAMedBinary``: the binary yes/no variant (utils.py:260-324).

Where pandas reads a column of numbers as numbers, ``Table`` keeps the
text; the VQA-Med CSVs hold text answers, keywords and image ids.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from mmvqa_tpu_torch.core.config import Config
from mmvqa_tpu_torch.data.datasets import Table, load_vqa_data
from mmvqa_tpu_torch.data.images import load_image
from mmvqa_tpu_torch.data.text_encoding import encode_text_vqa
from mmvqa_tpu_torch.data.tokenizer import WordPieceTokenizer

REMOVE_TRAIN2020 = (
    "synpic52595", "synpic61281", "synpic43628", "synpic15348",
    "synpic35145", "synpic20101", "synpic20412", "synpic45126",
    "synpic26398", "synpic15349", "synpic37214", "synpic52598",
    "synpic46660", "synpic36320", "synpic34054", "synpic58686",
    "synpic15888", "synpic19909", "synpic24243", "synpic39311",
    "synpic18484", "synpic24871", "synpic31586", "synpic47242",
    "synpic36969", "synpic21626", "synpic22983", "synpic40377",
    "synpic48870", "synpic43583", "synpic45128", "synpic32198",
    "synpic31080", "synpic45115", "synpic28125", "synpic45123",
    "synpic23844", "synpic17714", "synpic52608", "synpic52601",
    "synpic47246", "synpic15351", "synpic46658", "synpic45039",
    "synpic31101", "synpic52611", "synpic31083", "synpic49269",
    "synpic23197", "synpic27940", "synpic37880",
)
REMOVE_VAL2020 = (
    "synpic48867", "synpic22792", "synpic20410", "synpic52301",
    "synpic52606", "synpic41310", "synpic21537", "synpic28001",
    "synpic21967", "synpic45120", "synpic45129", "synpic30873",
    "synpic20402",
)
REMOVE_TRAIN2019 = (
    "synpic21456", "synpic21845", "synpic47995", "synpic48869",
    "synpic52613", "synpic31716", "synpic27917", "synpic39365",
    "synpic19434", "synpic52600", "synpic56649", "synpic52603",
    "synpic52610", "synpic46659", "synpic19533",
)
YES_NO = ("yes", "no")


def _drop(t: Table, column: str, values) -> Table:
    """``t[~t[column].isin(values)]``."""
    return t.where([v not in values for v in t.column(column)])


def load_2020_data(
    cfg: Config, datapath2020: str, testpath: str = ""
) -> Tuple[Table, Table, Table, Dict[int, str], int]:
    """(utils.py:81-147). Returns (train, val, test, idx2ans, num_classes)."""
    trainset = os.path.join(datapath2020, "VQAMed2020-VQAnswering-TrainingSet")
    train = Table.read_csv(os.path.join(trainset, "train.csv"))
    train = _drop(_drop(train, "imgid", REMOVE_TRAIN2020), "answer", YES_NO)
    val = Table.read_csv(os.path.join(trainset, "val.csv"))
    val = _drop(_drop(val, "imgid", REMOVE_VAL2020), "answer", YES_NO)
    test = Table.read_csv(os.path.join(trainset, "test.csv"))

    train = train.map_column("imgid", lambda x: os.path.join(
        trainset, "VQAnswering_2020_Train_images", x + "_224.jpg"))
    val = val.map_column("imgid", lambda x: os.path.join(
        datapath2020, "VQAMed2020-VQAnswering-ValidationSet",
        "VQAnswering_2020_Val_images", x + "_224.jpg"))
    if testpath:
        test = test.map_column("imgid", lambda x: os.path.join(
            testpath, "Task1-2020-VQAnswering-Test-Images", x + "_224.jpg"))

    classes2020 = set(train.unique("answer") + val.unique("answer"))

    # merge 2019 data re-labeled with keyword 'abnorm' (utils.py:112-123)
    t19, v19, s19 = load_vqa_data(cfg.replace(train_pct=1.0, valid_pct=1.0,
                                              test_pct=1.0))
    df2019 = Table.concat([t19, v19, s19])
    df2019 = df2019.where([
        os.path.basename(p).split(".")[0] not in REMOVE_TRAIN2019
        for p in df2019.column("img_id")])
    df2019 = df2019.drop(["category", "mode"]).with_column("keyword", "abnorm")
    df2019 = df2019.where([a in classes2020 for a in df2019.column("answer")])
    df2019 = df2019.rename(["imgid", "question", "answer", "keyword"])
    train = Table.concat([train, df2019])

    both = Table.concat([train, val])
    ans2idx = {a: i for i, a in enumerate(sorted(both.unique("answer")))}
    idx2ans = {i: a for a, i in ans2idx.items()}
    key2idx = {k: i for i, k in enumerate(sorted(both.unique("keyword")))}

    def lookup(table):  # Series.map(dict): an unknown key maps to NaN
        return lambda v: table.get(v, float("nan"))

    train = train.map_column("answer", lookup(ans2idx))
    val = val.map_column("answer", lookup(ans2idx))
    train = train.map_column("keyword", lookup(key2idx))
    val = val.map_column("keyword", lookup(key2idx))
    if "keyword" in test.columns:
        test = test.map_column("keyword", lookup(key2idx))
    return train, val, test, idx2ans, len(ans2idx)


@dataclass
class VQAMed2020Dataset:
    """imgid/question/answer[/keyword] rows (column layout of the 2020 CSVs)."""

    cfg: Config
    df: Table
    tokenizer: WordPieceTokenizer
    mode: str = "train"  # 'train' | 'eval' | 'test'

    def __len__(self):
        return len(self.df)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img = load_image(self.df.cell(idx, "imgid"), self.cfg.image_size)
        enc = encode_text_vqa(
            str(self.df.cell(idx, "question")), self.tokenizer,
            self.cfg.max_position_embeddings,
        )
        out = {
            "image": img,
            "tokens": enc.tokens,
            "segment_ids": enc.segment_ids,
            "input_mask": enc.input_mask,
        }
        if self.mode != "test":
            out["answer"] = np.asarray(self.df.cell(idx, "answer"), np.int32)
        if "keyword" in self.df.columns:
            out["keyword"] = np.asarray(self.df.cell(idx, "keyword"), np.int32)
        return out


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer)) and not isinstance(v, bool)


@dataclass
class VQAMedBinary:
    """Binary yes/no variant (utils.py:260-324): same sample layout as
    VQADataset but over the yes/no rows with 2 classes. As the reference,
    it keeps the rows whose answer is the integer 0 or 1 (an answer id,
    where the vocabulary was applied) or the text yes or no, and maps yes to
    1 and anything else to 0 unless every answer is an integer."""

    cfg: Config
    df: Table
    tokenizer: WordPieceTokenizer
    mode: str = "train"

    def __post_init__(self):
        self.df = self.df.where([
            (_is_int(a) and a in (0, 1)) or a in YES_NO
            for a in self.df.column("answer")])
        if not all(_is_int(a) for a in self.df.column("answer")):
            self.df = self.df.map_column("answer", lambda a: int(a == "yes"))

    def __len__(self):
        return len(self.df)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img = load_image(self.df.cell(idx, "img_id"), self.cfg.image_size)
        enc = encode_text_vqa(
            str(self.df.cell(idx, "question")), self.tokenizer,
            self.cfg.max_position_embeddings,
        )
        return {
            "image": img,
            "tokens": enc.tokens,
            "segment_ids": enc.segment_ids,
            "input_mask": enc.input_mask,
            "answer": np.asarray(self.df.cell(idx, "answer"), np.int32),
        }
