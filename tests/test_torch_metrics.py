"""The port's evaluation metrics and writers (mmvqa_tpu_torch.evaluation)
against nltk and the JAX package, on the CPU: unigram BLEU to nltk's
``sentence_bleu(weights=[1])`` to 1e-12 (on every answer pair of a fixture
and on drawn word lists), the per-category accuracy and BLEU equal to the
JAX functions, both writers' files byte for byte against the JAX writers,
and the ensemble's mean."""

import math
import os
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from nltk.translate.bleu_score import sentence_bleu

from mmvqa_tpu.core.config import vqa_config as jax_vqa_config
from mmvqa_tpu.data import datasets as jax_datasets
from mmvqa_tpu.evaluation import metrics as jax_metrics

from mmvqa_tpu_torch.core.config import vqa_config
from mmvqa_tpu_torch.data import datasets
from mmvqa_tpu_torch.data.fixtures import make_vqa_fixture
from mmvqa_tpu_torch.evaluation import metrics

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)


def _nltk(ref, hyp):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # nltk warns where nothing matches
        return float(sentence_bleu([ref], hyp, weights=[1]))


@pytest.fixture(scope="module")
def vqa(tmp_path_factory):
    """Both packages' test split of one port-written fixture after the
    answer vocabulary, with a test CSV rewritten to hold the cells a CSV
    writer must quote: commas, quotes, a pipe, an empty cell."""
    root = make_vqa_fixture(str(tmp_path_factory.mktemp("vqa")), n_per_cat=4,
                            seed=3, image_size=16)
    tricky = [
        ("synpic_a", 'what, "exactly" is shown', "a|b", "plane"),
        ("synpic_b", "", "c, d", "organ"),
        ("synpic_c", "is this normal", "yes", "binary"),
        ("synpic_d", "what modality", 'say "ct"', "modality"),
        ("synpic_e", "which abnormality", "mass", "abnormality"),
    ]
    with open(os.path.join(root, "testdf.csv"), "a", newline="") as f:
        import csv

        w = csv.writer(f, lineterminator="\n")
        for img, q, a, c in tricky:
            w.writerow([img, q, a, c, "test"])
    cfg = vqa_config(data_dir=root)
    jcfg = jax_vqa_config(data_dir=root)
    port = datasets.build_answer_vocab(*datasets.load_vqa_data(cfg))
    ref = jax_datasets.build_answer_vocab(*jax_datasets.load_vqa_data(jcfg))
    assert port[3] == ref[3] and port[4] == ref[4]
    return dict(port=port, ref=ref, idx2ans=port[3], n=port[4])


def test_bleu_matches_nltk_on_every_answer_pair_of_a_fixture(vqa):
    answers = list(vqa["idx2ans"].values())
    assert len(answers) > 10
    for ref in answers:
        for hyp in answers:
            got = metrics.sentence_bleu1(ref.split(), hyp.split())
            assert abs(got - _nltk(ref.split(), hyp.split())) <= 1e-12


WORDS = st.lists(st.sampled_from(["a", "b", "c", "mass", "ct", "x-ray"]),
                 max_size=7)


@settings(max_examples=300, deadline=None)
@given(ref=WORDS, hyp=WORDS)
def test_bleu_matches_nltk_on_drawn_word_lists(ref, hyp):
    """Empty hypotheses and references, repeated words (clipping), shorter
    and longer hypotheses (the brevity penalty)."""
    assert abs(metrics.sentence_bleu1(ref, hyp) - _nltk(ref, hyp)) <= 1e-12


def _draw(vqa, seed):
    rng = np.random.default_rng(seed)
    test = vqa["port"][2]
    targets = np.asarray(test.column("answer"), np.int64)
    preds = np.where(rng.random(len(targets)) < 0.4, targets,
                     rng.integers(0, vqa["n"], len(targets)))
    return preds, targets, test.column("category")


def test_bleu_score_and_its_empty_selection_match_jax(vqa):
    preds, targets, _ = _draw(vqa, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_metrics.bleu_score(preds, targets, vqa["idx2ans"])
    got = metrics.bleu_score(preds, targets, vqa["idx2ans"])
    assert abs(got - want) <= 1e-12
    assert math.isnan(metrics.bleu_score(preds[:0], targets[:0],
                                         vqa["idx2ans"]))


@pytest.mark.parametrize("prefix", ["", "val_"])
@pytest.mark.parametrize("seed", [0, 1])
def test_per_category_metrics_equal_the_jax_ones(vqa, prefix, seed):
    preds, targets, cats = _draw(vqa, seed)
    sel = np.asarray(cats) != "organ"  # a category with no sample: nan
    preds, targets = preds[sel], targets[sel]
    cats = [c for c, s in zip(cats, sel) if s]
    for port_fn, jax_fn, extra in (
            (metrics.per_category_accuracy, jax_metrics.per_category_accuracy,
             ()),
            (metrics.per_category_bleu, jax_metrics.per_category_bleu,
             (vqa["idx2ans"],))):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jax_fn(preds, targets, np.asarray(cats), *extra,
                          prefix=prefix)
        got = port_fn(preds, targets, cats, *extra, prefix=prefix)
        assert list(got) == list(want)
        np.testing.assert_equal(got, want)
    assert math.isnan(got[f"{prefix}organ_bleu"])
    assert f"{prefix}abnorm_bleu" in got


def test_writers_write_the_jax_writers_bytes(vqa, tmp_path):
    preds, _, _ = _draw(vqa, 2)
    test, ref_test = vqa["port"][2], vqa["ref"][2]
    assert len(test) == len(ref_test) == 25
    files = {}
    for who, mod, df in (("port", metrics, test),
                         ("jax", jax_metrics, ref_test)):
        csv_path = str(tmp_path / f"{who}_preds.csv")
        txt_path = str(tmp_path / f"{who}_res.txt")
        mod.write_predictions(df, preds, vqa["idx2ans"], csv_path)
        mod.write_submission(df, preds, vqa["idx2ans"], txt_path)
        files[who] = [open(p, "rb").read() for p in (csv_path, txt_path)]
    assert files["port"] == files["jax"]
    text = files["port"][0].decode()
    assert '"a|b"' in files["port"][1].decode() and '""exactly""' in text
    assert "\r" not in text


def test_write_predictions_returns_the_rows_it_wrote(vqa, tmp_path):
    preds, _, _ = _draw(vqa, 3)
    out = metrics.write_predictions(vqa["port"][2], preds, vqa["idx2ans"],
                                    str(tmp_path / "p.csv"))
    assert out.columns[-3:] == ["preds", "decode_preds", "decode_ans"]
    assert out.column("preds") == [int(p) for p in preds]
    assert out.column("decode_ans") == [vqa["idx2ans"][a]
                                        for a in vqa["port"][2].column("answer")]
    with pytest.raises(ValueError, match="predictions"):
        metrics.write_predictions(vqa["port"][2], preds[:-1], vqa["idx2ans"],
                                  str(tmp_path / "q.csv"))


def test_ensemble_logits_is_the_mean_the_jax_one_takes(rng):
    logits = [rng.normal(size=(4, 7)).astype(np.float32) for _ in range(3)]
    np.testing.assert_array_equal(metrics.ensemble_logits(logits),
                                  jax_metrics.ensemble_logits(logits))
    np.testing.assert_allclose(metrics.ensemble_logits(logits[:2]),
                               (logits[0] + logits[1]) / 2)
