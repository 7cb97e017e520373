"""The port's CLIs with their own encoder defaults (no ``--cnn_encoder`` or
``--transformer_model`` flag: ResNet-152 and the pre-norm BERT encoder, the
reference's MMBERT) on the CPU, with ``--tiny_cnn`` (one block a stage at
full widths), hidden 48 (the default 12 heads of 4) and one layer:
``roco_train`` against the JAX CLI on one port-written ROCO fixture, then
the port's ``vqa_train`` from its pretrained weights; every CLI with
``--transformer_model feedback-transformer``. The fine-tuning and
evaluation CLIs against the JAX ones are in
tests/test_torch_default_vqa_cli.py."""

import math
import os

import pytest
import torch

from mmvqa_tpu.cli import roco_train as jax_roco_train

from mmvqa_tpu_torch.cli import common, roco_supcon_train, roco_train
from mmvqa_tpu_torch.cli import vqa_eval, vqa_train
from mmvqa_tpu_torch.data.fixtures import make_roco_fixture, make_vqa_fixture
from mmvqa_tpu_torch.models import MMBert
from mmvqa_tpu_torch.models.resnet import ResNetFeatures
from mmvqa_tpu_torch.models.transformer import BertEncoder
from mmvqa_tpu_torch.train import checkpoint

from test_torch_vqa_cli import _jax_cli_globals, _lines, _quiet

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

# no encoder flags: the parsers' defaults
TINY = ["--tiny_cnn", "--hidden_size", "48", "--n_layers", "1",
        "--image_size", "32", "--batch_size", "8", "--num_workers", "1",
        "--max_position_embeddings", "16"]
PRE = [*TINY, "--mlm_prob", "0.15", "--epochs", "2"]
VQA = ["--num_vis", "5", *TINY]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both pretraining CLIs for two epochs on one ROCO fixture (3 + 3
    samples); the port's fine-tuning CLI for one epoch on a VQA fixture
    (15, 10, 10 questions) from the port's pretrained weights, with the
    ROCO vocabulary (``--vocab_file``), as a user's pipeline runs."""
    base = tmp_path_factory.mktemp("default_cli")
    roco = make_roco_fixture(str(base / "roco"), 3, 3, seed=0,
                             image_size=(40, 30))
    vqa = make_vqa_fixture(str(base / "vqa"), (3, 2, 2), seed=1,
                           image_size=(40, 30))
    out = {}
    for who, main, extra in (("port", roco_train.main, {"device": "cpu"}),
                             ("jax", jax_roco_train.main, {})):
        save = str(base / f"{who}_pre")
        flags = [] if who == "port" else ["--steps_per_call", "1"]
        with _jax_cli_globals():
            _quiet(main, ["-r", "p", "--data_dir", roco, "--save_dir", save,
                          *PRE, *flags], **extra)
        out[f"{who}_pre"] = (save, _lines(save, "p"))
    save = str(base / "port_ft")
    out["ft_stdout"] = _quiet(vqa_train.main, [
        "--run_name", "q", "--data_dir", vqa, "--save_dir", save,
        "--epochs", "1", "--lr", "1e-3", "--use_pretrained", "--model_dir",
        os.path.join(out["port_pre"][0], "MLM", "p"), "--vocab_file",
        os.path.join(roco, "vocab.txt"), *VQA], device="cpu")
    out["ft"] = (save, _lines(save, "q"))
    return out


def test_pretraining_cli_runs_the_default_model_as_the_jax_cli(runs):
    """The same metric keys a line, finite losses that fall, the weights of
    the default model (a ResNet trunk, a BERT encoder) under MLM/."""
    save, port = runs["port_pre"]
    jax_lines = runs["jax_pre"][1]
    assert len(port) == len(jax_lines) == 2
    for a, b in zip(port, jax_lines):
        assert a.keys() == b.keys()
        for k in ("epoch_train_loss", "epoch_val_loss", "train_items_per_sec"):
            assert math.isfinite(a[k]), (k, a)
    w = checkpoint.load_weights(os.path.join(save, "MLM", "p"))
    assert "trans.trunk.layer4_block0.downsample_bn.running_var" in w
    assert "encoder.attention_0.proj_q.bias" in w
    assert "encoder.norm2.weight" not in w


def test_finetuning_from_the_pretrained_default_model(runs):
    """Every pretrained tensor but ``classifier_2`` transferred (the JAX
    CLI prints 115/117 for these flags), finite losses, loadable weights."""
    n = len(checkpoint.load_weights(
        os.path.join(runs["port_pre"][0], "MLM", "p")))
    assert n == 117
    assert f"transferred {n - 2}/{n} tensors" in runs["ft_stdout"]
    (line,) = runs["ft"][1]
    for k in ("train_loss", "val_loss", "test_loss", "total_acc",
              "total_bleu"):
        assert math.isfinite(line[k]), (k, line)
    w = checkpoint.load_weights(os.path.join(runs["ft"][0], "MLM", "q_loss"))
    assert all(torch.isfinite(v.float()).all() for v in w.values())


def test_parsers_default_to_the_reference_mmbert():
    for parser, argv in ((common.pretrain_parser(), ["-r", "x",
                                                      "--mlm_prob", "0.15"]),
                         (common.pretrain_parser(True), [
                             "-r", "x", "--mlm_prob", "0.15", "--con_task",
                             "supcon", "--similarity", "jaccard"]),
                         (common.vqa_parser(), ["--run_name", "x",
                                                "--num_vis", "5"]),
                         (common.vqa_parser(True), ["--run_name", "x",
                                                    "--num_vis", "5"])):
        cfg = common.config_from_args(parser.parse_args(argv))
        assert (cfg.cnn_encoder, cfg.transformer_model) == (
            "resnet152", "transformer")
    model = MMBert(cfg.replace(tiny_cnn=True, hidden_size=48, n_layers=1),
                   device="cpu")
    assert isinstance(model.trans.trunk, ResNetFeatures)
    assert isinstance(model.encoder, BertEncoder)


@pytest.mark.parametrize("main,argv", [
    (roco_train.main, ["-r", "x", "--data_dir", "roco", "--epochs", "1",
                       "--mlm_prob", "0.15"]),
    (roco_supcon_train.main, ["-r", "x", "--data_dir", "roco", "--epochs",
                              "1", "--mlm_prob", "0.15", "--con_task",
                              "supcon", "--similarity", "jaccard"]),
    (vqa_train.main, ["--run_name", "x", "--epochs", "1", "--num_vis", "5"]),
    (vqa_eval.main, ["--run_name", "x", "--num_vis", "5"]),
], ids=["roco_train", "roco_supcon_train", "vqa_train", "vqa_eval"])
def test_every_cli_runs_the_feedback_encoder(tmp_path, main, argv):
    """Every CLI builds its model from its flags: with
    ``--transformer_model feedback-transformer`` each runs one tiny epoch
    of the default trunk and the feedback encoder (``vqa_eval`` on the
    weights of a ``vqa_train`` run of it), its losses finite and its files
    written."""
    data = make_roco_fixture(str(tmp_path / "roco"), 1, 1, seed=0,
                             image_size=16) if "roco" in argv else \
        make_vqa_fixture(str(tmp_path / "vqa"), 1, image_size=16)
    argv = [a if a != "roco" else data for a in argv]
    if "--data_dir" not in argv:
        argv += ["--data_dir", data]
    flags = [*TINY, "--transformer_model", "feedback-transformer"]
    save = str(tmp_path / "s")
    if main is vqa_eval.main:
        _quiet(vqa_train.main, ["--run_name", "ft", "--epochs", "1",
                                "--num_vis", "5", "--data_dir", data,
                                "--save_dir", str(tmp_path / "ft"), *flags],
               device="cpu")
        argv += ["--model_dir", str(tmp_path / "ft" / "MLM" / "ft_loss")]
    _quiet(main, [*argv, "--save_dir", save, *flags], device="cpu")
    if main is vqa_eval.main:
        assert os.path.exists(os.path.join(save, "ft_loss_preds.csv"))
        return
    (line,) = _lines(save, "x")
    losses = [v for k, v in line.items() if k.endswith("loss")]
    assert losses and all(math.isfinite(v) for v in losses), line
    w = checkpoint.load_weights(os.path.join(
        save, "MLM", "x_loss" if main is vqa_train.main else "x"))
    assert "encoder.segment.shared_kv.weight" in w
    assert "encoder.segment.layer_weight" in w
