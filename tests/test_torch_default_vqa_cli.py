"""The port's fine-tuning and evaluation CLIs with their own encoder
defaults (no ``--cnn_encoder`` or ``--transformer_model`` flag: ResNet-152
and the pre-norm BERT encoder) against the JAX package's on the CPU, with
``--tiny_cnn``, hidden 48 and one layer (tests/test_torch_default_cli.py's
flags): ``vqa_train`` for one epoch on one port-written VQA fixture, and
``vqa_eval`` on the JAX CLI's fine-tuned weights carried across by the
bridge, whose files must equal the JAX ``vqa_eval``'s but at near-ties."""

import csv
import math
import os

import numpy as np
import pytest
import torch

from mmvqa_tpu.cli import vqa_eval as jax_vqa_eval
from mmvqa_tpu.cli import vqa_train as jax_vqa_train
from mmvqa_tpu.train import checkpoint as jax_checkpoint

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.cli import common, vqa_eval, vqa_train
from mmvqa_tpu_torch.data.fixtures import make_vqa_fixture
from mmvqa_tpu_torch.models import MMBert
from mmvqa_tpu_torch.train import checkpoint

from test_torch_default_cli import VQA
from test_torch_vqa_cli import _jax_cli_globals, _lines, _quiet

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both fine-tuning CLIs for one epoch from fresh weights on one VQA
    fixture (15, 10, 10 questions); both ``vqa_eval`` CLIs on the JAX CLI's
    best-by-loss weights (the port's copy carried across by the bridge),
    with the JAX run's logits."""
    base = tmp_path_factory.mktemp("default_vqa_cli")
    vqa = make_vqa_fixture(str(base / "vqa"), (3, 2, 2), seed=1,
                           image_size=(40, 30))
    out = {}
    for who, main, extra in (("port", vqa_train.main, {"device": "cpu"}),
                             ("jax", jax_vqa_train.main, {})):
        save = str(base / f"{who}_ft")
        flags = [] if who == "port" else ["--steps_per_call", "1"]
        with _jax_cli_globals():
            out[f"{who}_ft_stdout"] = _quiet(main, [
                "--run_name", "q", "--data_dir", vqa, "--save_dir", save,
                "--epochs", "1", "--lr", "1e-3", *VQA, *flags], **extra)
        out[f"{who}_ft"] = (save, _lines(save, "q"))

    # the JAX CLI's best-by-loss weights, in the port's format
    jw = os.path.join(out["jax_ft"][0], "MLM", "q_loss")
    args = common.vqa_parser(True).parse_args(
        ["--run_name", "e", "--data_dir", vqa, *VQA])
    tree = jax_checkpoint.load_weights(jw)
    n_classes = np.shape(tree["params"]["classifier_2"]["bias"])[0]
    cfg = common.load_tokenizer(common.config_from_args(args).replace(
        num_classes=n_classes))[1]
    model = MMBert(cfg, device="cpu")
    pw = str(base / "port_w" / "q_loss")
    os.makedirs(os.path.dirname(pw))
    torch.save(bridge.to_state_dict(tree, model), pw)
    logits = []
    original = jax_vqa_eval.vqa_epoch

    def keep(*a, **kw):
        state, m = original(*a, **kw)
        logits.append(np.asarray(m["logits"]))
        return state, m

    jax_vqa_eval.vqa_epoch = keep
    try:
        jdir = str(base / "jax_eval")
        with _jax_cli_globals():
            _quiet(jax_vqa_eval.main, [
                "--run_name", "e", "--data_dir", vqa, "--save_dir", jdir,
                "--model_dir", jw, "--steps_per_call", "1", *VQA])
    finally:
        jax_vqa_eval.vqa_epoch = original
    pdir = str(base / "port_eval")
    _quiet(vqa_eval.main, ["--run_name", "e", "--data_dir", vqa,
                           "--save_dir", pdir, "--model_dir", pw, *VQA],
           device="cpu")
    out.update(jdir=jdir, pdir=pdir, logits=logits[0])
    return out


def test_finetuning_cli_runs_the_default_model_as_the_jax_cli(runs):
    """The same answer vocabulary, metric keys and files; finite losses."""
    port, jax_lines = runs["port_ft"][1], runs["jax_ft"][1]
    assert len(port) == len(jax_lines) == 1
    assert port[0].keys() == jax_lines[0].keys()
    for k in ("train_loss", "val_loss", "test_loss", "total_acc",
              "total_bleu"):
        assert math.isfinite(port[0][k]), (k, port[0])
    classes = [line for line in runs["port_ft_stdout"].splitlines()
               if line.startswith("numclasses")]
    assert classes and classes[0] in runs["jax_ft_stdout"]
    w = checkpoint.load_weights(os.path.join(runs["port_ft"][0], "MLM",
                                             "q_loss"))
    assert all(torch.isfinite(v.float()).all() for v in w.values())
    assert "trans.trunk.layer1_block0.conv1.weight" in w


def _rows(path, delimiter=","):
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter=delimiter))


def test_eval_cli_files_equal_the_jax_clis_but_at_near_ties(runs):
    """tests/test_torch_vqa_cli.py's rule: both files line by line, equal
    wherever the JAX logits' top two are more than 1e-4 apart."""
    top2 = np.sort(runs["logits"], axis=-1)[:, -2:]
    tie = (top2[:, 1] - top2[:, 0]) <= 1e-4
    assert len(tie) == 10 and tie.sum() <= 5, tie
    for name, delim, header in (("q_loss_preds.csv", ",", 1),
                                ("q_loss_res.txt", "|", 0)):
        got = _rows(os.path.join(runs["pdir"], name), delim)
        want = _rows(os.path.join(runs["jdir"], name), delim)
        assert len(got) == len(want) == 10 + header
        assert got[:header] == want[:header]
        for i, (g, w) in enumerate(zip(got[header:], want[header:])):
            assert g == w if not tie[i] else g[0] == w[0], (name, i)


