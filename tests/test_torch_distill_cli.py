"""Distillation from disk in the port against the JAX package on the CPU:
the distillation batch of both ROCO datasets item for item, ``roco_train
--task distillation`` beside the JAX CLI on one fixture (the default model,
one block a ResNet stage, hidden 48, one layer; the port's run with
``--watch_histograms``), and ``vqa_train`` / ``vqa_eval`` with ``--task
distillation``, which, as in the JAX CLIs, only names the save
subdirectory.

The teacher, ClinicalBERT in a real run, is a small ``transformers`` BERT
built from a config in code with seeded weights: both packages' datasets
get the same one in place of their ``_teacher``."""

import math
import os

import numpy as np
import pytest
import torch

from mmvqa_tpu.cli import roco_train as jax_roco_train
from mmvqa_tpu.core.config import pretrain_config as jax_pretrain_config
from mmvqa_tpu.data import datasets as jax_datasets
from mmvqa_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer

from mmvqa_tpu_torch.cli import roco_train, vqa_eval, vqa_train
from mmvqa_tpu_torch.core.config import pretrain_config
from mmvqa_tpu_torch.data import datasets
from mmvqa_tpu_torch.data.fixtures import make_roco_fixture, make_vqa_fixture
from mmvqa_tpu_torch.data.tokenizer import WordPieceTokenizer
from mmvqa_tpu_torch.train import checkpoint

from test_torch_vqa_cli import _jax_cli_globals, _lines, _quiet

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

TEACHER_HIDDEN = 48


def _teacher(vocab_size):
    """A seeded two-layer BERT of hidden TEACHER_HIDDEN, the datasets'
    ``_teacher`` interface: ids (1, L) -> last hidden states (1, L, H)."""
    from transformers import BertConfig, BertModel

    torch.manual_seed(0)
    model = BertModel(BertConfig(
        vocab_size=vocab_size, hidden_size=TEACHER_HIDDEN,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=96,
        max_position_embeddings=512)).eval()

    def run(ids):
        with torch.no_grad():
            t = torch.from_numpy(np.asarray(ids)).long()
            return model(t, torch.ones_like(t)).last_hidden_state.numpy()

    return run


@pytest.fixture(scope="module")
def teacher_fixture(tmp_path_factory):
    """A ROCO fixture and both datasets' ``_teacher`` replaced by one
    random BERT over its vocabulary."""
    root = make_roco_fixture(str(tmp_path_factory.mktemp("distill") / "roco"),
                             3, 3, seed=0, image_size=(40, 30))
    tok = WordPieceTokenizer.find_and_load(root, "")
    fn = _teacher(tok.vocab_size)
    with pytest.MonkeyPatch.context() as mp:
        for cls in (datasets.ROCODataset, jax_datasets.ROCODataset):
            mp.setattr(cls, "_teacher", lambda self: fn)
        yield root, tok


def test_distillation_batches_equal_the_jax_datasets(teacher_fixture):
    """tokens, segments, mask and the teacher's states under ``labels``,
    item for item and bit for bit."""
    root, tok = teacher_fixture
    kw = dict(data_dir=root, image_size=32, task="distillation",
              max_position_embeddings=24, seed=11,
              vocab_size=tok.vocab_size)
    cfg, jcfg = pretrain_config(**kw), jax_pretrain_config(**kw)
    table = datasets.Table.read_csv(
        os.path.join(root, "validation/radiology/valdata.csv"))
    import pandas as pd  # the JAX dataset's table

    df = pd.read_csv(os.path.join(root, "validation/radiology/valdata.csv"))
    a = datasets.ROCODataset(cfg, table, tok, [], "validation")
    b = jax_datasets.ROCODataset(jcfg, df, JaxTokenizer.find_and_load(
        root, ""), [], "validation")
    assert len(a) == len(b) == 3
    for i in range(3):
        x, y = a[i], b[i]
        assert x.keys() == y.keys() and "labels" in x
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        assert x["labels"].shape == (24, TEACHER_HIDDEN)
        assert np.abs(x["labels"]).max() > 0


DEFAULT_TINY = ["--tiny_cnn", "--hidden_size", str(TEACHER_HIDDEN),
                "--n_layers", "1", "--image_size", "32", "--batch_size", "8",
                "--num_workers", "1", "--max_position_embeddings", "16"]


@pytest.fixture(scope="module")
def cli_runs(teacher_fixture, tmp_path_factory):
    """``roco_train --task distillation`` of both packages for two epochs
    on the fixture (the port's with ``--watch_histograms``)."""
    root, _ = teacher_fixture
    base = tmp_path_factory.mktemp("distill_cli")
    out = {}
    for who, main, extra in (("port", roco_train.main, {"device": "cpu"}),
                             ("jax", jax_roco_train.main, {})):
        save = str(base / who)
        flags = (["--watch_histograms"] if who == "port"
                 else ["--steps_per_call", "1"])
        with _jax_cli_globals():
            out[f"{who}_stdout"] = _quiet(main, [
                "-r", "d", "--data_dir", root, "--save_dir", save,
                "--task", "distillation", "--mlm_prob", "0.15", "--epochs",
                "2", *DEFAULT_TINY, *flags], **extra)
        out[who] = (save, _lines(save, "d"))
    return out


def test_distillation_cli_runs_as_the_jax_cli(cli_runs):
    """The same metric keys a line (no accuracy), finite losses, the
    weights under ``distillation/`` without heads, the histograms of every
    parameter each epoch."""
    save, lines = cli_runs["port"]
    port = [x for x in lines if "histograms" not in x]
    hists = [x["histograms"] for x in lines if "histograms" in x]
    jax_lines = cli_runs["jax"][1]
    assert len(port) == len(jax_lines) == len(hists) == 2
    for a, b in zip(port, jax_lines):
        assert a.keys() == b.keys()
        assert "epoch_train_acc" not in a
        for k in ("epoch_train_loss", "epoch_val_loss"):
            assert math.isfinite(a[k]) and math.isfinite(b[k]), (k, a, b)
    w = checkpoint.load_weights(os.path.join(save, "distillation", "d"))
    assert "encoder.attention_0.proj_q.weight" in w
    assert not any(k.startswith(("fc1", "classifier")) for k in w)
    assert "Val loss" in cli_runs["port_stdout"]
    assert "Val acc" not in cli_runs["port_stdout"]
    names = {n for n, p in checkpoint.load_weights(os.path.join(
        save, "distillation", "d")).items()}
    for h in hists:
        assert "ghist/encoder/attention_0/proj_q/kernel" in h
        assert len(h) == 2 * len([n for n in names if "running_" not in n
                                  and "num_batches" not in n])


VQA = ["--num_vis", "5", *DEFAULT_TINY]


def test_vqa_clis_take_task_distillation_as_a_directory_name(tmp_path):
    """``--task distillation`` trains and evaluates as ``--task MLM`` does,
    metric for metric, and only moves the weights to
    ``<save>/distillation/``."""
    vqa = make_vqa_fixture(str(tmp_path / "vqa"), (3, 2, 2), seed=1,
                           image_size=(40, 30))
    lines = {}
    for task in ("MLM", "distillation"):
        save = str(tmp_path / task)
        _quiet(vqa_train.main, ["--run_name", "q", "--data_dir", vqa,
                                "--save_dir", save, "--epochs", "1",
                                "--task", task, *VQA], device="cpu")
        (line,) = _lines(save, "q")
        lines[task] = {k: v for k, v in line.items()
                       if k != "ts" and "per_sec" not in k}
        assert os.path.exists(os.path.join(save, task, "q_loss"))
        assert not os.path.exists(os.path.join(
            save, "MLM" if task != "MLM" else "distillation"))
    assert lines["MLM"] == lines["distillation"]
    out = str(tmp_path / "eval")
    _quiet(vqa_eval.main, [
        "--run_name", "q", "--data_dir", vqa, "--save_dir", out,
        "--task", "distillation", "--model_dir",
        str(tmp_path / "distillation" / "distillation" / "q_loss"), *VQA],
        device="cpu")
    assert os.path.exists(os.path.join(out, "q_loss_preds.csv"))
