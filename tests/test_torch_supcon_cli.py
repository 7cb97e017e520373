"""The port's SupCon pretraining CLI (``mmvqa_tpu_torch.cli.
roco_supcon_train``) against the JAX package's, on the CPU at tiny width:
both CLIs on one port-written ROCO fixture with the Jaccard mask passed
(the same files and log keys, finite losses, the CLI's first train batch
equal to the JAX loader's first at ``batch_size // 2``), then the port's
CLI alone: the reference's live path (mask computed, not passed), SimCLR,
the recorder every 5 epochs taken up by ``--resume``, ``--resume
--no_recorder`` from the best weights, and --watch / --watch_histograms
leaving the losses as they were.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from mmvqa_tpu.cli import common as jax_common
from mmvqa_tpu.cli import roco_supcon_train as jax_supcon_train
from mmvqa_tpu.data import datasets as jax_datasets
from mmvqa_tpu.data.loader import BatchLoader as JaxBatchLoader
from mmvqa_tpu.utils.logging import seed_everything as jax_seed_everything

from mmvqa_tpu_torch.cli import roco_supcon_train
from mmvqa_tpu_torch.data.fixtures import make_roco_fixture
from mmvqa_tpu_torch.train import checkpoint

from test_torch_vqa_cli import _jax_cli_globals, _lines, _quiet

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

FLAGS = ["--mlm_prob", "0.5", "--cnn_encoder", "tf_efficientnetv2_m",
         "--transformer_model", "realformer", "--tiny_cnn",
         "--hidden_size", "32", "--n_layers", "1", "--image_size", "32",
         "--batch_size", "16", "--num_workers", "1", "--lr", "1e-3",
         "--max_position_embeddings", "24", "--similarity", "jaccard"]
SUPCON = ["--con_task", "supcon", "--use_sim_mask", *FLAGS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs for two epochs with the mask passed, on a port-written
    fixture of 12 train samples (two batches of 8, the last padded: the two
    views make 16; the JAX CLI spreads a batch over the 8 CPU devices
    tests/conftest.py sets up) and 3 validation samples; then the port's
    CLI alone: the live path (no mask passed) and SimCLR for an epoch
    each, five epochs (the recorder), resumed from it for one more, resumed
    from the best weights without it, and an epoch with --watch
    --watch_histograms."""
    base = tmp_path_factory.mktemp("supcon_cli")
    data = make_roco_fixture(str(base / "roco"), 12, 3, seed=2,
                             image_size=(40, 30))
    out = {"data": data}
    first, masks = {}, []
    make_steps = roco_supcon_train.make_supcon_steps

    def recording(model, cfg, aug):
        train_step, eval_step = make_steps(model, cfg, aug)

        def step(state, batch, draws=None, sim_mask=None):
            first.setdefault("batch", {k: (np.array(v) if not isinstance(
                v, list) else v) for k, v in batch.items()})
            masks.append(sim_mask)
            return train_step(state, batch, draws, sim_mask=sim_mask)

        return step, eval_step

    roco_supcon_train.make_supcon_steps = recording
    try:
        for name, args in (("port", SUPCON + ["--epochs", "2"]),
                           ("live", ["--con_task", "supcon", *FLAGS,
                                     "--epochs", "1"]),
                           ("simclr", ["--con_task", "simclr", *FLAGS,
                                       "--epochs", "1"]),
                           ("five", SUPCON + ["--epochs", "5"])):
            del masks[:]
            first.clear()
            save = str(base / name)
            out[name + "_stdout"] = _quiet(roco_supcon_train.main, [
                "-r", "s", "--data_dir", data, "--save_dir", save, *args],
                device="cpu")
            out[name] = _lines(save, "s")
            out[name + "_dir"] = save
            out[name + "_masks"] = list(masks)
            out[name + "_first"] = first.get("batch")
    finally:
        roco_supcon_train.make_supcon_steps = make_steps

    for name, extra in (
            ("resumed", ["--epochs", "6", "--resume"]),
            ("weights", ["--epochs", "1", "--resume", "--no_recorder",
                         "--resume_dir", os.path.join(out["five_dir"], "MLM",
                                                      "s")]),
            ("watched", ["--epochs", "1", "--watch", "--watch_histograms"])):
        save = str(base / name)
        os.makedirs(save)
        if name == "resumed":
            os.link(os.path.join(out["five_dir"], "recorder_2.pt"),
                    os.path.join(save, "recorder_2.pt"))
        out[name + "_stdout"] = _quiet(roco_supcon_train.main, [
            "-r", "s", "--data_dir", data, "--save_dir", save, *SUPCON,
            *extra], device="cpu")
        out[name] = _lines(save, "s")

    jsave = str(base / "jax")
    with _jax_cli_globals():
        _quiet(jax_supcon_train.main, [
            "-r", "s", "--data_dir", data, "--save_dir", jsave,
            "--steps_per_call", "1", *SUPCON, "--epochs", "2"])
    out.update(jsave=jsave, jax=_lines(jsave, "s"))
    return out


def test_cli_writes_the_jax_clis_files_and_log_keys(runs):
    def names(d):
        return sorted(os.listdir(d)) + sorted(
            "MLM/" + n for n in os.listdir(os.path.join(d, "MLM")))

    assert names(runs["port_dir"]) == names(runs["jsave"]) == [
        "MLM", "s_metrics.jsonl", "MLM/s"]
    assert len(runs["port"]) == len(runs["jax"]) == 2
    for a, b in zip(runs["port"], runs["jax"]):
        assert a.keys() == b.keys()


def test_cli_losses_are_finite_and_the_weights_load(runs):
    for name in ("port", "live", "simclr", "five"):
        for r in runs[name]:
            for k in ("epoch_train_loss", "epoch_val_loss",
                      "epoch_train_mlm_loss", "epoch_train_supcon_loss",
                      "epoch_train_acc", "epoch_val_acc",
                      "train_items_per_sec", "learning_rate"):
                assert math.isfinite(r[k]), (name, k, r)
            assert r["epoch_train_loss"] == pytest.approx(
                r["epoch_train_mlm_loss"] + r["epoch_train_supcon_loss"])
    w = checkpoint.load_weights(os.path.join(runs["port_dir"], "MLM", "s"))
    assert {"head_0.weight", "head_2.weight"} <= w.keys()
    assert all(torch.isfinite(v.float()).all() for v in w.values())


def test_the_mask_reaches_the_step_only_with_use_sim_mask(runs):
    """Two steps an epoch; the Jaccard mask of the batch's captions where
    --use_sim_mask is set, None on the reference's live path and SimCLR."""
    got = runs["port_masks"]
    assert len(got) == 4 and all(m.shape == (8, 8) for m in got)
    assert all(np.array_equal(np.diag(m), np.ones(8)) for m in got)
    assert all(m is None for m in runs["live_masks"] + runs["simclr_masks"])
    assert len(runs["live_masks"]) == len(runs["simclr_masks"]) == 2
    assert "mask wired into loss: True" in runs["port_stdout"]


def test_first_train_batch_is_the_jax_loaders_first(runs):
    """The JAX package's loader over its two-view ROCODataset at
    batch_size // 2, built from the same flags after the same seeding; the
    captions leave the batch before the step."""
    args = jax_common.pretrain_parser(supcon=True).parse_args(
        ["-r", "s", "--data_dir", runs["data"], *SUPCON])
    cfg = jax_common.config_from_args(args).replace(supcon=True)
    jax_seed_everything(cfg.seed)
    tok, cfg = jax_common.load_tokenizer(cfg)
    train_df, _ = jax_datasets.load_mlm_data(cfg)
    ds = jax_datasets.ROCODataset(cfg, train_df, tok,
                                  jax_datasets.get_keywords(cfg.data_dir),
                                  "train", two_text_views=True)
    loader = JaxBatchLoader(ds, cfg.batch_size // 2, shuffle=True,
                            seed=cfg.seed, num_workers=cfg.num_workers)
    want = next(iter(loader))
    want = {k: v for k, v in want.items()
            if k not in ("caption", "aug_caption")}
    got = runs["port_first"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["image"].shape == (8, 32, 32, 3) and got["aug_labels"].any()


def test_resume_takes_up_the_recorder_or_the_weights(runs):
    """--resume: the epoch after the recorder's (written at the fifth) and
    its scheduler; --no_recorder: the best weights, from epoch 0."""
    assert os.path.exists(os.path.join(runs["five_dir"], "recorder_2.pt"))
    resumed = runs["resumed"]
    assert [r["epoch"] for r in resumed] == [5]
    assert resumed[0]["learning_rate"] == runs["five"][-1]["learning_rate"]
    weights = runs["weights"]
    assert [r["epoch"] for r in weights] == [0]
    assert math.isfinite(weights[0]["epoch_train_loss"])
    assert "Resuming training" in runs["weights_stdout"]


def test_watch_flags_log_and_leave_the_training_alone(runs):
    """--watch adds the per-module gradient norms, --watch_histograms a
    histogram line of NLL + SupCon after each epoch's metrics; the losses
    are those of the run without either flag."""
    watched, plain = runs["watched"], runs["port"]
    assert ["histograms" in r for r in watched] == [False, True]
    hist = watched[1]["histograms"]
    assert sum(hist["ghist/head_2/kernel"]["counts"]) == 32 * 128
    for a, b in zip(plain, watched[0::2]):
        assert b["gnorm/head_0"] > 0 and b["gnorm/trans"] > 0
        for k in ("epoch_train_loss", "epoch_val_loss",
                  "epoch_train_supcon_loss", "epoch_train_acc"):
            assert a[k] == b[k], k
