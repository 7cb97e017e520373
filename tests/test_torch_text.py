"""The port's text half of the host data layer against the JAX package's: the
WordPiece tokenizer (Python path and the native fast path built by
``mmvqa_tpu_torch.native.loader``) and the text encodings, on the fixture
corpus and on the edge cases of tests/test_tokenizer.py and
tests/test_native.py. Tokens and encodings must be equal.
"""

import random

import numpy as np
import pytest
import torch

from mmvqa_tpu.data import text_encoding as jax_text
from mmvqa_tpu.data import tokenizer as jax_tokenizer
from mmvqa_tpu.data.fixtures import make_roco_fixture as jax_make_roco

from mmvqa_tpu_torch.data import text_encoding, tokenizer
from mmvqa_tpu_torch.native import loader

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

EDGE = [
    "Chest X-ray showing bilateral pneumonia with pleural effusion.",
    "CT scan of the abdomen demonstrates a hepatic lesion!",
    "MRI axial view, T2-weighted, brain tumour in the left lobe!",
    "Ultrasound image of the gallbladder; cholecystitis suspected?",
    "ultra-sound image; gall.bladder, suspected...",
    "numbers 123 and mixed a1b2c3 tokens",
    "café au lait spots observed 中文 text",
    "Ångström naïve résumé",
    "zzgibberishqq ß",
    "weird   spacing\tand\nnewlines",
    "UPPER lower MiXeD",
    "a [MASK] b [CLS] [SEP] [PAD] [UNK]",
    "[mask] lowercase special",
    "a" * 150,
    "  spaces   ",
    "...",
    "",
    "\x00control\x07chars�",
]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The JAX fixture's captions and vocab.txt, with the edge cases."""
    root = tmp_path_factory.mktemp("roco")
    jax_make_roco(str(root), n_train=8, n_val=4, image_size=16)
    import pandas as pd

    caps = list(pd.read_csv(root / "train/radiology/traindata.csv")["caption"])
    return str(root / "vocab.txt"), caps + EDGE


@pytest.fixture(scope="module")
def edge_vocab(tmp_path_factory):
    """A vocab over the edge cases themselves (their words are known)."""
    vocab = jax_tokenizer.build_vocab_from_corpus(EDGE * 2, max_size=2000)
    path = str(tmp_path_factory.mktemp("vocab") / "vocab.txt")
    tokenizer.write_vocab(vocab, path)
    return path


@pytest.mark.parametrize("which", ["fixture", "edge"])
def test_tokenizer_ids_equal_jax(corpus, edge_vocab, which):
    vocab_file, texts = corpus
    if which == "edge":
        vocab_file = edge_vocab
    ours = tokenizer.WordPieceTokenizer.from_vocab_file(vocab_file)
    ref = jax_tokenizer.WordPieceTokenizer.from_vocab_file(vocab_file)
    assert ours.vocab == ref.vocab and ours.vocab_size == ref.vocab_size
    for text in texts:
        assert ours.tokenize(text) == ref.tokenize(text), text
        assert ours.encode(text) == ref.encode(text), text
        assert (ours.encode(text, add_special_tokens=False)
                == ref.encode(text, add_special_tokens=False)), text
    assert ours.convert_ids_to_tokens(range(40)) == ref.convert_ids_to_tokens(
        range(40))


def test_native_ids_equal_python_ids(corpus):
    """The C++ fast path gives the Python path's ids; non-ASCII text and text
    with a bracket (special tokens) take the Python path."""
    vocab_file, texts = corpus
    fast = tokenizer.WordPieceTokenizer.from_vocab_file(vocab_file)
    slow = tokenizer.WordPieceTokenizer.from_vocab_file(vocab_file)
    slow._native_lib = None
    assert fast._native_lib is not None
    native_taken = 0
    for text in texts:
        ids = fast._native_ids(text)
        if not text.isascii() or "[" in text:
            assert ids is None, text
        else:
            native_taken += 1
            assert ids == slow.encode(text, add_special_tokens=False), text
        assert fast.tokenize(text) == slow.tokenize(text), text
        assert fast.encode(text) == slow.encode(text), text
    assert native_taken >= 20


def test_vocab_from_corpus_equals_jax(corpus):
    _, texts = corpus
    for max_size in (40, 4000):
        assert (tokenizer.build_vocab_from_corpus(texts, max_size=max_size)
                == jax_tokenizer.build_vocab_from_corpus(texts,
                                                         max_size=max_size))


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """No quiet fallback: a compiler that fails makes the build raise."""
    monkeypatch.setattr(loader, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        loader.build_host("wordpiece")


def _tokenizers(vocab_file):
    return (tokenizer.WordPieceTokenizer.from_vocab_file(vocab_file),
            jax_tokenizer.WordPieceTokenizer.from_vocab_file(vocab_file))


KEYWORDS = {"pneumonia", "effusion", "lesion", "tumour", "fracture", "mass",
            "x-ray", "ct"}


@pytest.mark.parametrize("mlm_prob", [0.15, 0.5, 1.0])
def test_mlm_encoding_equals_jax(corpus, mlm_prob):
    """Same random.Random(seed) -> the same masks, labels and layout, over a
    stream of captions (the generator's state carries from one to the
    next), at a length that truncates some."""
    vocab_file, texts = corpus
    ours, ref = _tokenizers(vocab_file)
    r1, r2 = random.Random(5), random.Random(5)
    for text in texts:
        for maxlen in (75, 12):
            a = text_encoding.encode_text_mlm(text, ours, KEYWORDS, 5, maxlen,
                                              mlm_prob, r1)
            b = jax_text.encode_text_mlm(text, ref, KEYWORDS, 5, maxlen,
                                         mlm_prob, r2)
            for f in ("tokens", "segment_ids", "input_mask", "labels"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f"{f}: {text}")
    assert r1.random() == r2.random()


def test_mask_word_equals_jax(corpus):
    vocab_file, texts = corpus
    ours, ref = _tokenizers(vocab_file)
    r1, r2 = random.Random(9), random.Random(9)
    for text in texts:
        assert (text_encoding.mask_word(text, ours, KEYWORDS, 0.7, r1)
                == jax_text.mask_word(text, ref, KEYWORDS, 0.7, r2)), text


def test_vqa_and_distillation_encodings_equal_jax(corpus):
    vocab_file, texts = corpus
    ours, ref = _tokenizers(vocab_file)

    def teacher(ids):  # a fake teacher: hidden states from the ids
        ids = np.asarray(ids, np.float32)
        return np.stack([ids * 0.5, ids + 1.0, -ids], axis=-1)

    for text in texts:
        for maxlen in (28, 10):
            pairs = [
                (text_encoding.encode_text_vqa(text, ours, maxlen),
                 jax_text.encode_text_vqa(text, ref, maxlen)),
                (text_encoding.encode_text_distillation(
                    text, ours, teacher, 5, maxlen + 10, 20),
                 jax_text.encode_text_distillation(
                     text, ref, teacher, 5, maxlen + 10, 20)),
            ]
            for a, b in pairs:
                for f in ("tokens", "segment_ids", "input_mask", "labels"):
                    np.testing.assert_array_equal(
                        getattr(a, f), getattr(b, f), err_msg=f"{f}: {text}")


def test_flatten_keywords_equals_jax_with_its_quirk():
    kd = {"a": ["pneumonia", "ct"], "b": ["ct", "mass"], "c": []}
    got = text_encoding.flatten_keywords(kd)
    assert sorted(got) == sorted(jax_text.flatten_keywords(kd))
    assert "." in got and "p" in got and "pneumonia." not in got
