"""The port's datasets, fixtures and batch loader against the JAX package's:
the fixtures' CSVs read equal by pandas (and their JPEGs open in PIL and
decode as PIL decodes them), the CSV table's pandas quirks, every sample
dict of ``ROCODataset`` and ``VQADataset`` equal, images included, and the
``BatchLoader`` batch for batch over two epochs; then the cases of
tests/test_loader.py against the port's loader.
"""

import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from mmvqa_tpu.core.config import pretrain_config as jax_pretrain_config
from mmvqa_tpu.core.config import vqa_config as jax_vqa_config
from mmvqa_tpu.data import datasets as jax_datasets
from mmvqa_tpu.data.fixtures import make_roco_fixture as jax_make_roco
from mmvqa_tpu.data.fixtures import make_vqa_fixture as jax_make_vqa
from mmvqa_tpu.data.loader import BatchLoader as JaxBatchLoader
from mmvqa_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from mmvqa_tpu.utils.logging import seed_everything as jax_seed_everything

import mmvqa_tpu_torch.data.images as images_mod
from mmvqa_tpu_torch.core.config import pretrain_config, vqa_config
from mmvqa_tpu_torch.data import datasets, jpeg
from mmvqa_tpu_torch.data.fixtures import make_roco_fixture, make_vqa_fixture
from mmvqa_tpu_torch.data.images import DecodedImageCache, RamImageCache
from mmvqa_tpu_torch.data.loader import BatchLoader
from mmvqa_tpu_torch.data.tokenizer import WordPieceTokenizer
from mmvqa_tpu_torch.utils.logging import seed_everything

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

S = 32  # image side of the dataset tests


@pytest.fixture(scope="module")
def roco(tmp_path_factory):
    """The port's ROCO fixture (10 train samples: a padded last batch of 4)
    and the JAX package's, from the same seed."""
    base = tmp_path_factory.mktemp("roco")
    ours = make_roco_fixture(str(base / "port"), 10, 6, seed=3,
                             image_size=(40, 28))
    ref = jax_make_roco(str(base / "jax"), 10, 6, seed=3, image_size=24)
    return ours, ref


@pytest.fixture(scope="module")
def vqa(tmp_path_factory):
    base = tmp_path_factory.mktemp("vqa")
    ours = make_vqa_fixture(str(base / "port"), 3, seed=5, image_size=20)
    ref = jax_make_vqa(str(base / "jax"), 3, seed=5, image_size=20)
    return ours, ref


def _jpegs(root):
    out = []
    for d, _, files in sorted(os.walk(root)):
        out += [os.path.join(d, f) for f in sorted(files) if f.endswith(".jpg")]
    return out


@pytest.mark.parametrize("kind", ["roco", "vqa"])
def test_fixtures_read_equal_by_pandas(roco, vqa, kind):
    ours, ref = roco if kind == "roco" else vqa
    csvs = (["train/radiology/traindata.csv",
             "validation/radiology/valdata.csv"] if kind == "roco"
            else ["traindf.csv", "valdf.csv", "testdf.csv"])
    for name in csvs:
        pd.testing.assert_frame_equal(pd.read_csv(os.path.join(ours, name)),
                                      pd.read_csv(os.path.join(ref, name)))
    with open(os.path.join(ours, "vocab.txt"), "rb") as a, \
            open(os.path.join(ref, "vocab.txt"), "rb") as b:
        assert a.read() == b.read()
    if kind == "roco":
        with open(os.path.join(ours, "vocab/med_vocab.pkl"), "rb") as a, \
                open(os.path.join(ref, "vocab/med_vocab.pkl"), "rb") as b:
            assert pickle.load(a) == pickle.load(b)
    mine, theirs = _jpegs(ours), _jpegs(ref)
    assert ([os.path.relpath(p, ours) for p in mine]
            == [os.path.relpath(p, ref) for p in theirs])
    want_size = (40, 28) if kind == "roco" else (20, 20)
    for p in mine:
        im = Image.open(p)
        assert (im.format, im.size) == ("JPEG", want_size)
        np.testing.assert_array_equal(jpeg.read_rgb(p),
                                      np.asarray(im.convert("RGB")))


def test_table_keeps_pandas_quirks(tmp_path):
    p = str(tmp_path / "t.csv")
    with open(p, "w") as f:
        f.write('name,caption,n\na.jpg,"one, two",1\nb.jpg,,2\n'
                'c.jpg,"say ""x""",\nb.jpg,again,4\n')
    t = datasets.Table.read_csv(p)
    df = pd.read_csv(p)
    assert t.columns == list(df.columns) and len(t) == len(df)
    assert ([str(x) for x in t.column("caption")]
            == [str(x) for x in df["caption"]])
    assert str(t.cell(1, "caption")) == "nan"
    assert t.unique("name") == list(df["name"].unique())
    for seed in (0, 7):
        np.random.seed(seed)
        a = t.sample(0.5).column("name")
        np.random.seed(seed)
        assert a == list(df.sample(frac=0.5)["name"])


def _configs(root, **kw):
    kw = dict(data_dir=root, image_size=S, mlm_prob=0.5,
              max_position_embeddings=24, batch_size=4, seed=11, **kw)
    cfg = pretrain_config(**kw)
    tok = WordPieceTokenizer.find_and_load(root, "")
    cfg = cfg.replace(vocab_size=tok.vocab_size)
    return cfg, tok, jax_pretrain_config(**kw).replace(
        vocab_size=tok.vocab_size), JaxTokenizer.find_and_load(root, "")


def _equal(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        if isinstance(a[k], (str, list)):
            assert a[k] == b[k], (what, k)
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, (what, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("train_pct", [1.0, 0.6])
def test_roco_datasets_give_the_jax_samples(roco, train_pct):
    """The port's files through both packages: the same rows (also under
    train_pct < 1 after the same seed_everything), keywords and samples,
    images included, in train mode (rotation, masks, the back-translated
    view) and in validation mode."""
    root, _ = roco
    cfg, tok, jcfg, jtok = _configs(root, train_pct=train_pct, valid_pct=0.5)
    jax_seed_everything(4)
    jtrain, jval = jax_datasets.load_mlm_data(jcfg)
    seed_everything(4)
    train, val = datasets.load_mlm_data(cfg)
    assert train.column("name") == list(jtrain["name"])
    assert val.column("caption") == list(jval["caption"])
    assert len(train) == round(train_pct * 10) and len(val) == 3
    keywords = datasets.get_keywords(root)
    assert sorted(keywords) == sorted(jax_datasets.get_keywords(root))
    for mode, ours, ref in (("train", train, jtrain),
                            ("validation", val, jval)):
        a = datasets.ROCODataset(cfg, ours, tok, keywords, mode,
                                 two_text_views=True)
        b = jax_datasets.ROCODataset(jcfg, ref, jtok, keywords, mode,
                                     two_text_views=True)
        assert len(a) == len(b)
        for epoch in range(2):
            for i in range(len(a)):
                _equal(a[i], b[i], f"{mode} {epoch} {i}")


@pytest.mark.parametrize("category", [None, "abnormality"])
def test_vqa_data_and_datasets_give_the_jax_samples(vqa, category):
    root, _ = vqa
    kw = dict(data_dir=root, image_size=S, max_position_embeddings=20,
              seed=2, train_pct=0.8)
    cfg, jcfg = vqa_config(**kw), jax_vqa_config(**kw)
    tok = WordPieceTokenizer.find_and_load(root, "")
    jtok = JaxTokenizer.find_and_load(root, "")
    jax_seed_everything(1)
    jframes = jax_datasets.load_vqa_data(jcfg)
    seed_everything(1)
    frames = datasets.load_vqa_data(cfg)
    for t, df in zip(frames, jframes):
        assert t.columns == list(df.columns)
        assert t.rows == df.values.tolist()
    *ours, idx2ans, n = datasets.build_answer_vocab(*frames, category)
    *ref, jidx2ans, jn = jax_datasets.build_answer_vocab(*jframes, category)
    assert (idx2ans, n) == (jidx2ans, jn)
    for mode, t, df in zip(("train", "eval", "test"), ours, ref):
        assert t.rows == df.values.tolist()
        a = datasets.VQADataset(cfg, t, tok, mode)
        b = jax_datasets.VQADataset(jcfg, df, jtok, mode)
        assert a.cats2ans == b.cats2ans and len(a) == len(b)
        for i in range(len(a)):
            _equal(a[i], b[i], f"{mode} {i}")


def test_loader_gives_the_jax_batches_over_two_epochs(roco):
    """Shuffled, a padded last batch, one worker (with several, the order
    in which threads draw from a dataset's generators is the scheduler's,
    in either package)."""
    root, _ = roco
    cfg, tok, jcfg, jtok = _configs(root)
    keywords = datasets.get_keywords(root)
    a = BatchLoader(datasets.ROCODataset(
        cfg, datasets.Table.read_csv(
            os.path.join(root, "train/radiology/traindata.csv")),
        tok, keywords, "train"), 4, shuffle=True, seed=cfg.seed,
        num_workers=1)
    b = JaxBatchLoader(jax_datasets.ROCODataset(
        jcfg, pd.read_csv(os.path.join(root, "train/radiology/traindata.csv")),
        jtok, keywords, "train"), 4, shuffle=True, seed=cfg.seed,
        num_workers=1)
    assert len(a) == len(b) == 3
    for epoch in range(2):
        got, want = list(a), list(b)
        assert len(got) == len(want) == 3
        for i, (x, y) in enumerate(zip(got, want)):
            _equal(x, y, f"epoch {epoch} batch {i}")
        np.testing.assert_array_equal(got[-1]["weights"], [1, 1, 0, 0])
        assert got[0]["image"].shape == (4, S, S, 3)


# ------------------------------------- tests/test_loader.py, on the port ----

class ToyDataset:
    def __init__(self, n, with_text=False):
        self.n = n
        self.with_text = with_text

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        out = {"x": np.full((3,), i, np.float32),
               "y": np.asarray(i, np.int32)}
        if self.with_text:
            out["caption"] = f"caption {i}"
        return out


def test_fixed_shapes_and_padding_weights():
    loader = BatchLoader(ToyDataset(10), batch_size=4, num_workers=2)
    batches = list(loader)
    assert len(batches) == 3
    for b in batches:
        assert b["x"].shape == (4, 3)
        assert b["weights"].shape == (4,)
    np.testing.assert_array_equal(batches[-1]["weights"], [1, 1, 0, 0])
    seen = np.concatenate([b["y"][b["weights"] > 0] for b in batches])
    assert sorted(seen.tolist()) == list(range(10))


def test_drop_last():
    batches = list(BatchLoader(ToyDataset(10), batch_size=4, drop_last=True))
    assert len(batches) == 2
    assert all((b["weights"] == 1).all() for b in batches)


def test_sharding_partitions_dataset():
    seen = []
    for idx in range(3):
        for b in BatchLoader(ToyDataset(10), batch_size=4, shard_index=idx,
                             shard_count=3):
            seen.extend(b["y"][b["weights"] > 0].tolist())
    assert sorted(seen) == list(range(10))


def test_shuffle_changes_order_per_epoch():
    loader = BatchLoader(ToyDataset(16), batch_size=16, shuffle=True, seed=1)
    e1 = next(iter(loader))["y"].tolist()
    e2 = next(iter(loader))["y"].tolist()
    assert sorted(e1) == sorted(e2) == list(range(16))
    assert e1 != e2  # the epoch counter reseeds


def test_string_fields_stay_lists():
    b = next(iter(BatchLoader(ToyDataset(4, with_text=True), batch_size=2)))
    assert isinstance(b["caption"], list) and len(b["caption"]) == 2


def test_image_cache_hits():
    calls = []

    class Counting(ToyDataset):
        def __getitem__(self, i):
            calls.append(i)
            return super().__getitem__(i)

    loader = BatchLoader(Counting(4), batch_size=4, cache_images=True)
    list(loader)
    list(loader)
    assert len(calls) == 4  # the second epoch comes from the cache


def _roco_dataset(tmp_path, n_train, n_val, mode, **kw):
    root = make_roco_fixture(str(tmp_path / "roco"), n_train, n_val, seed=0,
                             image_size=S)
    cfg = pretrain_config(data_dir=root, image_size=S, mlm_prob=0.5,
                          max_position_embeddings=24, batch_size=4)
    tok = WordPieceTokenizer.find_and_load(root, "")
    cfg = cfg.replace(vocab_size=tok.vocab_size)
    csv = ("train/radiology/traindata.csv" if mode == "train"
           else "validation/radiology/valdata.csv")
    df = datasets.Table.read_csv(os.path.join(root, csv))
    return datasets.ROCODataset(cfg, df, tok, ["lung", "scan"], mode, **kw)


def test_cache_images_keeps_train_randomness(tmp_path, monkeypatch):
    """On a train dataset the cache holds only the decode: rotation and
    masks differ between epochs, and each image is decoded once."""
    ds = _roco_dataset(tmp_path, 6, 2, "train")
    calls = []
    orig = images_mod.load_image
    monkeypatch.setattr(images_mod, "load_image",
                        lambda p, size=224: (calls.append(p), orig(p, size))[1])
    loader = BatchLoader(ds, batch_size=6, num_workers=1, cache_images=True)
    assert loader._cache is None and ds.image_cache is not None
    e1 = next(iter(loader))
    e2 = next(iter(loader))
    assert len(calls) == 6
    assert (not np.array_equal(e1["image"], e2["image"])
            or not np.array_equal(e1["labels"], e2["labels"]))


def test_cache_images_eval_dataset_keeps_sample_cache(tmp_path):
    ds = _roco_dataset(tmp_path, 4, 4, "validation")
    loader = BatchLoader(ds, batch_size=4, num_workers=1, cache_images=True)
    assert loader._cache is not None
    list(loader)
    assert len(loader._cache) == 4


def test_cache_images_layers_ram_over_disk_cache(tmp_path):
    disk = DecodedImageCache(str(tmp_path / "cache"), S)
    ds = _roco_dataset(tmp_path, 4, 2, "train", image_cache=disk)
    BatchLoader(ds, batch_size=4, num_workers=1, cache_images=True)
    assert isinstance(ds.image_cache, RamImageCache)
    assert ds.image_cache._backing is disk
    assert ds[0]["image"].shape == (S, S, 3) and len(disk) >= 1
    reads = []
    orig = disk.load
    disk.load = lambda p, s: (reads.append(p), orig(p, s))[1]
    ds[0]
    assert reads == []
