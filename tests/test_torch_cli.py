"""The port's pretraining CLI (``mmvqa_tpu_torch.cli.roco_train``) against the
JAX package's, on the CPU at tiny width: the flag surface held to the
reference table of tests/test_cli_surface.py, the flags the port refuses,
imports with jax, pandas and PIL blocked, and two runs of both CLIs on one
port-written fixture (the same files and log keys, finite losses, the
recorder taken up by ``--resume``, and the CLI's first train batch equal to
the JAX loader's first batch).
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmvqa_tpu.cli import common as jax_common
from mmvqa_tpu.cli import roco_train as jax_roco_train
from mmvqa_tpu.core import mesh as mesh_module
from mmvqa_tpu.data import datasets as jax_datasets
from mmvqa_tpu.data.loader import BatchLoader as JaxBatchLoader
from mmvqa_tpu.ops import attention
from mmvqa_tpu.utils.logging import seed_everything as jax_seed_everything

from mmvqa_tpu_torch.cli import common, roco_train
from mmvqa_tpu_torch.data.fixtures import make_roco_fixture

from test_cli_surface import (
    ALLOWED_ADDITIVE,
    REF_CHOICES,
    REF_ROCO_TRAIN,
    TASK_CHOICES,
    surface,
)

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEPT = {"vocab_file", "cache_images", "image_cache_dir", "image_size",
        "watch", "watch_histograms", "profile_dir", "grad_accum", "tiny_cnn",
        "steps_per_call", "dp_size", "tp_size", "cp_size", "fsdp", "pp_size",
        "pp_microbatches", "attention_impl"}


def test_parser_matches_the_reference_surface():
    got = surface(common.pretrain_parser())
    missing = [f for f in REF_ROCO_TRAIN if f not in got]
    assert not missing
    for flag, want in REF_ROCO_TRAIN.items():
        have = got[flag][0]
        if isinstance(want, float) and math.isinf(want):
            assert isinstance(have, float) and math.isinf(have), flag
        elif isinstance(want, float):
            assert have == pytest.approx(want), flag
        else:
            assert have == want, flag
    extra = set(got) - set(REF_ROCO_TRAIN)
    assert extra <= ALLOWED_ADDITIVE and extra == KEPT
    for flag, want in REF_CHOICES.items():
        if flag in REF_ROCO_TRAIN:
            assert got[flag][1] == want, flag
    assert got["task"][1] == TASK_CHOICES["pre"]
    act = next(a for a in common.pretrain_parser()._actions
               if "--run_name" in a.option_strings)
    assert "-r" in act.option_strings


BASE = ["-r", "t", "--mlm_prob", "0.15"]


@pytest.mark.parametrize("flag", ["--dp_size 2", "--tp_size 2",
                                  "--cp_size 2", "--fsdp", "--pp_size 2"])
def test_mesh_flags_wait_for_multi_gpu(flag):
    """The mesh flags lay a run out over its ranks: in one process a
    two-rank mesh fails with the JAX mesh's own error, a world of two
    builds it (context and pipeline parallelism as data and tensor
    parallelism), and --fsdp alone runs."""
    from mmvqa_tpu_torch.core import mesh

    cfg = common.config_from_args(
        common.pretrain_parser().parse_args(BASE + flag.split()))
    if flag == "--fsdp":
        assert cfg.fsdp
        assert common.setup_runtime(cfg, "cpu")[0] == torch.device("cpu")
        assert mesh.CURRENT is None  # one process: nothing to shard
    else:
        with pytest.raises(ValueError, match="device count 1|1 devices not"):
            common.setup_runtime(cfg, "cpu")
        spec = mesh.make_mesh(cfg.dp_size, cfg.tp_size, cfg.cp_size,
                              cfg.pp_size, world_size=2, rank=1)
        want = {"--dp_size 2": (2, 1, 1, 1), "--tp_size 2": (1, 2, 1, 1),
                "--cp_size 2": (1, 1, 2, 1), "--pp_size 2": (1, 1, 1, 2)}
        assert spec.sizes == want[flag]


def test_steps_per_call_takes_only_1_and_the_runtime_its_device():
    parse = common.pretrain_parser().parse_args
    cfg = common.config_from_args(parse(BASE + ["--steps_per_call", "4"]))
    with pytest.raises(ValueError, match="steps_per_call 4"):
        common.setup_runtime(cfg, "cpu")
    cfg = common.config_from_args(parse(BASE))
    assert cfg.steps_per_call == 1
    assert common.setup_runtime(cfg, "cpu") == (torch.device("cpu"),
                                                torch.float32)
    cfg = common.config_from_args(parse(BASE + ["--mixed_precision"]))
    assert common.setup_runtime(cfg, "cpu")[1] == torch.bfloat16


BLOCKER = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "pandas", "PIL",
                                  "mmvqa_tpu", "optax", "orbax"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import mmvqa_tpu_torch.cli.roco_train
from mmvqa_tpu_torch.cli import make_fixtures
make_fixtures.main(["--out", sys.argv[1], "--n_train", "2", "--n_val", "1",
                    "--n_per_cat", "1", "--image_size", "24", "18"])
from mmvqa_tpu_torch.data.images import load_image
assert load_image(sys.argv[1] + "/roco/train/radiology/images/"
                  "ROCO_train_0000.jpg", 16).shape == (16, 16, 3)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "pandas", "PIL", "mmvqa_tpu")]
assert not bad, bad
print("clean")
"""


def test_cli_imports_and_writes_fixtures_without_jax_pandas_or_pil(tmp_path):
    out = subprocess.run([sys.executable, "-c", BLOCKER, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("clean")


FLAGS = ["--mlm_prob", "0.5", "--cnn_encoder", "tf_efficientnetv2_m",
         "--transformer_model", "realformer", "--tiny_cnn",
         "--hidden_size", "32", "--n_layers", "1", "--image_size", "32",
         "--batch_size", "8", "--num_workers", "1", "--lr", "1e-3",
         "--max_position_embeddings", "24", "--watch"]


def _lines(save, run):
    with open(os.path.join(save, f"{run}_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs, five epochs each (the recorder is written at the fifth),
    on one port-written fixture of 3 train samples (one batch of 8, padded)
    and 3 validation samples; then the port's CLI resumed for two more, with
    and without --watch_histograms. The JAX CLI spreads a batch over the
    8 CPU devices tests/conftest.py sets up."""
    base = tmp_path_factory.mktemp("cli")
    data = make_roco_fixture(str(base / "roco"), 3, 3, seed=0,
                             image_size=(40, 30))
    first = {}
    make_steps = roco_train.make_mlm_steps

    def recording(model, cfg, aug):
        train_step, eval_step = make_steps(model, cfg, aug)

        def step(state, batch):
            first.setdefault("batch", {k: np.array(v) for k, v in
                                       batch.items()})
            return train_step(state, batch)

        return step, eval_step

    roco_train.make_mlm_steps = recording
    try:
        save = str(base / "port")
        roco_train.main(["-r", "p", "--data_dir", data, "--save_dir", save,
                         "--epochs", "5", *FLAGS], device="cpu")
    finally:
        roco_train.make_mlm_steps = make_steps
    again = {}
    for extra in ([], ["--watch_histograms"]):
        resumed = str(base / f"resumed{len(extra)}")
        os.makedirs(resumed)
        os.link(os.path.join(save, "recorder_2.pt"),
                os.path.join(resumed, "recorder_2.pt"))
        roco_train.main(["-r", "p", "--data_dir", data, "--save_dir", resumed,
                         "--epochs", "7", "--resume", *FLAGS, *extra],
                        device="cpu")
        again[bool(extra)] = _lines(resumed, "p")
    jsave = str(base / "jax")
    # the JAX CLI installs a process-wide mesh and attention settings; put
    # them back here, where the per-test guard of conftest.py is not yet
    # around a module's fixture
    saved = (mesh_module.CURRENT, attention.IMPL_DEFAULT, attention.RING_MESH)
    try:
        jax_roco_train.main(["-r", "p", "--data_dir", data, "--save_dir",
                             jsave, "--epochs", "5", "--steps_per_call", "1",
                             *FLAGS])
    finally:
        (mesh_module.CURRENT, attention.IMPL_DEFAULT,
         attention.RING_MESH) = saved
    return dict(data=data, save=save, jsave=jsave, port=_lines(save, "p"),
                jax=_lines(jsave, "p"), again=again, first=first["batch"])


def test_cli_writes_the_jax_clis_files_and_log_keys(runs):
    """Files: the metrics lines, the best weights under MLM/, the recorder
    (``recorder_2.pt`` here, an orbax directory ``recorder_2`` there)."""
    def names(d):
        out = set()
        for dirpath, dirs, files in os.walk(d):
            rel = os.path.relpath(dirpath, d)
            if rel == "." or rel == "MLM":
                out |= {os.path.normpath(os.path.join(rel, f))
                        for f in files + dirs}
        return out

    port, ref = names(runs["save"]), names(runs["jsave"])
    assert port == {n + ".pt" if n == "recorder_2" else n for n in ref}
    assert {"p_metrics.jsonl", "MLM", "MLM/p", "recorder_2.pt"} <= port
    assert len(runs["port"]) == len(runs["jax"]) == 5
    for a, b in zip(runs["port"], runs["jax"]):
        assert a.keys() == b.keys()


def test_cli_losses_are_finite_and_the_weights_load(runs):
    from mmvqa_tpu_torch.train import checkpoint

    epochs = [r for r in runs["port"] if "epoch" in r]
    assert [r["epoch"] for r in epochs] == list(range(5))
    for r in epochs:
        for k in ("epoch_train_loss", "epoch_val_loss", "train_items_per_sec",
                  "epoch_train_acc", "epoch_val_acc", "learning_rate"):
            assert math.isfinite(r[k]), (k, r)
        assert r["gnorm/trans"] > 0
    assert epochs[-1]["epoch_train_loss"] < epochs[0]["epoch_train_loss"]
    w = checkpoint.load_weights(os.path.join(runs["save"], "MLM", "p"))
    assert all(torch.isfinite(v.float()).all() for v in w.values())


def test_resume_takes_up_the_recorder(runs):
    """--resume: the epoch after the recorder's, the scheduler's state and
    its best loss; the next epochs logged."""
    epochs = [r for r in runs["again"][False] if "epoch" in r]
    assert [r["epoch"] for r in epochs] == [5, 6]
    assert math.isfinite(epochs[0]["epoch_train_loss"])
    assert epochs[0]["learning_rate"] == runs["port"][-1]["learning_rate"]


def test_watch_histograms_logs_them_and_leaves_the_training_alone(runs):
    """The histogram line of the JAX package's names (``grad_weight_
    histograms``, held to the JAX function by tests/test_torch_finetune.py)
    after the epoch's metrics, and the same losses as without the flag."""
    plain, watched = runs["again"][False], runs["again"][True]
    assert ["histograms" in r for r in watched] == [False, True] * 2
    hist = watched[1]["histograms"]
    assert sum(hist["ghist/fc1/kernel"]["counts"]) == 32 * 32
    assert {k.split("/")[0] for k in hist} == {"ghist", "whist"}
    for a, b in zip(plain, watched[0::2]):
        for k in ("epoch_train_loss", "epoch_val_loss", "epoch_train_acc",
                  "gnorm/trans"):
            assert a[k] == b[k], k


def test_first_train_batch_is_the_jax_loaders_first(runs):
    """The JAX package's loader over its ROCODataset, built from the same
    flags on the same files after the same seeding."""
    args = jax_common.pretrain_parser(supcon=False).parse_args(
        ["-r", "p", "--data_dir", runs["data"], *FLAGS])
    cfg = jax_common.config_from_args(args)
    jax_seed_everything(cfg.seed)
    tok, cfg = jax_common.load_tokenizer(cfg)
    train_df, _ = jax_datasets.load_mlm_data(cfg)
    ds = jax_datasets.ROCODataset(cfg, train_df, tok,
                                  jax_datasets.get_keywords(cfg.data_dir),
                                  "train")
    loader = JaxBatchLoader(ds, cfg.batch_size, shuffle=True, seed=cfg.seed,
                            num_workers=cfg.num_workers)
    want = next(iter(loader))
    got = runs["first"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["image"].shape == (8, 32, 32, 3) and got["labels"].any()
    np.testing.assert_array_equal(got["weights"], [1] * 3 + [0] * 5)
