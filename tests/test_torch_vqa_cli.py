"""The port's VQA-Med drivers (``mmvqa_tpu_torch.cli.vqa_train`` and
``cli.vqa_eval``) against the JAX package's, on the CPU at tiny width: the
flag surfaces held to the reference tables of tests/test_cli_surface.py
(the SupCon parser's too), imports with jax, pandas, PIL and nltk blocked,
both fine-tuning CLIs on one port-written fixture (the same answer
vocabulary, files and log keys, finite losses, the CLI's first train batch
equal to the JAX loader's), the port's early stopping, category branch,
histograms, transfer and resume, the port's ``vqa_eval`` given the JAX
CLI's fine-tuned weights through the bridge (its ``_preds.csv`` and
``_res.txt`` equal to the JAX ``vqa_eval``'s but at near-ties, alone and as
an ensemble), the VQA-Med 2020 data paths, and the similarity backends
under tests/test_similarity_backends.py's fakes.
"""

import contextlib
import csv
import io
import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax

from mmvqa_tpu.cli import common as jax_common
from mmvqa_tpu.cli import vqa_eval as jax_vqa_eval
from mmvqa_tpu.cli import vqa_train as jax_vqa_train
from mmvqa_tpu.core import mesh as mesh_module
from mmvqa_tpu.core.config import vqa_config as jax_vqa_config
from mmvqa_tpu.data import datasets as jax_datasets
from mmvqa_tpu.data import vqamed2020 as jax_vqamed2020
from mmvqa_tpu.data.loader import BatchLoader as JaxBatchLoader
from mmvqa_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from mmvqa_tpu.ops import attention
from mmvqa_tpu.similarity import SimilarityCalculator as JaxCalculator
from mmvqa_tpu.train import checkpoint as jax_checkpoint
from mmvqa_tpu.utils.logging import seed_everything as jax_seed_everything

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.cli import common, vqa_eval, vqa_train
from mmvqa_tpu_torch.core.config import vqa_config
from mmvqa_tpu_torch.data import datasets, vqamed2020
from mmvqa_tpu_torch.data.fixtures import make_vqa_fixture
from mmvqa_tpu_torch.data.tokenizer import WordPieceTokenizer
from mmvqa_tpu_torch.models import MMBert
from mmvqa_tpu_torch.similarity import SimilarityCalculator
from mmvqa_tpu_torch.train import checkpoint

from test_cli_surface import (
    ALLOWED_ADDITIVE,
    DEFAULT_EXCEPTIONS,
    REF_CHOICES,
    REF_SUPCON,
    REF_VQA_EVAL,
    REF_VQA_TRAIN,
    TASK_CHOICES,
    surface,
)
from test_torch_cli import KEPT
from test_vqamed2020 import data_dirs  # noqa: F401  (a fixture)

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ------------------------------------------------------------ the parsers ----

PARSERS = {
    "sup": (lambda: common.pretrain_parser(supcon=True), REF_SUPCON,
            KEPT | {"use_sim_mask"}),
    # the reference's VQA drivers have --image_size already
    "vqa": (lambda: common.vqa_parser(False), REF_VQA_TRAIN,
            KEPT - {"image_size"}),
    "eval": (lambda: common.vqa_parser(True), REF_VQA_EVAL,
             KEPT - {"image_size", "watch", "watch_histograms"}),
}


@pytest.mark.parametrize("name", sorted(PARSERS))
def test_parsers_match_the_reference_surface(name):
    make, ref, kept = PARSERS[name]
    got = surface(make())
    assert not [f for f in ref if f not in got]
    for flag, want in ref.items():
        want = DEFAULT_EXCEPTIONS.get((name, flag), want)
        have = got[flag][0]
        if isinstance(want, float) and math.isinf(want):
            assert isinstance(have, float) and math.isinf(have), flag
        elif isinstance(want, float):
            assert have == pytest.approx(want), flag
        else:
            assert have == want, flag
    extra = set(got) - set(ref)
    assert extra <= ALLOWED_ADDITIVE and extra == kept, extra ^ kept
    for flag, want in REF_CHOICES.items():
        if flag in ref:
            assert got[flag][1] == want, flag
    assert got["task"][1] == TASK_CHOICES[name]


BLOCKER = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "pandas", "PIL",
                                  "mmvqa_tpu", "optax", "orbax", "nltk"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
import mmvqa_tpu_torch.cli.vqa_train, mmvqa_tpu_torch.cli.vqa_eval
import mmvqa_tpu_torch.cli.roco_supcon_train
from mmvqa_tpu_torch.core.config import supcon_config
from mmvqa_tpu_torch.data import vqamed2020
from mmvqa_tpu_torch.data.datasets import Table
from mmvqa_tpu_torch.evaluation import bleu_score, write_predictions
from mmvqa_tpu_torch.similarity import SimilarityCalculator
from mmvqa_tpu_torch.train.steps import make_supcon_steps
from mmvqa_tpu_torch.train.trainer import supcon_epoch
assert bleu_score(np.array([0]), np.array([1]), {0: "a b", 1: "a"}) == 0.5
write_predictions(Table(["img_id", "answer"], [["x/y.jpg", 1]]),
                  np.array([0]), {0: "a", 1: "b"}, sys.argv[1] + "/p.csv")
assert open(sys.argv[1] + "/p.csv").read() == \\
    "img_id,answer,preds,decode_preds,decode_ans\\nx/y.jpg,1,0,a,b\\n"
assert SimilarityCalculator("jaccard")(["a b"], ["b c"])[0, 0] == 1.0
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "pandas", "PIL", "mmvqa_tpu", "nltk")]
assert not bad, bad
print("clean")
"""


def test_drivers_import_without_jax_pandas_pil_or_nltk(tmp_path):
    out = subprocess.run([sys.executable, "-c", BLOCKER, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("clean")


# ----------------------------------------------------- the fine-tuning CLIs ----

FLAGS = ["--num_vis", "5", "--cnn_encoder", "tf_efficientnetv2_m",
         "--transformer_model", "realformer", "--tiny_cnn",
         "--hidden_size", "32", "--n_layers", "1", "--image_size", "32",
         "--batch_size", "8", "--num_workers", "1",
         "--max_position_embeddings", "16"]
TRAIN = ["--epochs", "2", "--lr", "1e-3", "--smoothing", "0.1", *FLAGS]


def _lines(save, run):
    with open(os.path.join(save, f"{run}_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _quiet(fn, *args, **kw):
    """Run ``fn`` with its standard output kept; returns that output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kw)
    return out.getvalue()


@contextlib.contextmanager
def _jax_cli_globals():
    """The JAX CLIs install a process-wide mesh and attention settings; put
    them back here, where the per-test guard of conftest.py is not yet
    around a module's fixture."""
    saved = (mesh_module.CURRENT, attention.IMPL_DEFAULT, attention.RING_MESH)
    try:
        yield
    finally:
        (mesh_module.CURRENT, attention.IMPL_DEFAULT,
         attention.RING_MESH) = saved


def _recording(module, name, into):
    """Wrap ``module.name`` so that each call's result is appended to
    ``into``; returns the original."""
    original = getattr(module, name)

    def wrapped(*a, **k):
        out = original(*a, **k)
        into.append(out)
        return out

    setattr(module, name, wrapped)
    return original


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both fine-tuning CLIs for two epochs with the category smoothing on
    one port-written fixture (15 train, 10 val, 10 test questions; batches
    of 8, the last padded); the JAX CLI spreads a batch over the 8 CPU
    devices tests/conftest.py sets up. Then the port's CLI again with
    --watch_histograms for one epoch, with --lr 0 and --counter 0, with
    --category organ, and resumed from its own best weights."""
    base = tmp_path_factory.mktemp("vqa_cli")
    data = make_vqa_fixture(str(base / "vqa"), (3, 2, 2), seed=1,
                            image_size=(40, 30))
    out = {"data": data, "base": base}
    vocab, jvocab, first = [], [], {}
    make_steps = vqa_train.make_vqa_steps

    def recording(model, cfg, aug, **kw):
        train_step, eval_step = make_steps(model, cfg, aug, **kw)

        def step(state, batch):
            first.setdefault("batch", {k: np.array(v) for k, v in
                                       batch.items()})
            return train_step(state, batch)

        return step, eval_step

    vqa_train.make_vqa_steps = recording
    original = _recording(vqa_train, "build_answer_vocab", vocab)
    try:
        save = str(base / "port")
        out["stdout"] = _quiet(vqa_train.main, [
            "--run_name", "p", "--data_dir", data, "--save_dir", save,
            *TRAIN], device="cpu")
    finally:
        vqa_train.make_vqa_steps = make_steps
        vqa_train.build_answer_vocab = original
    out.update(save=save, port=_lines(save, "p"), first=first["batch"],
               vocab=vocab[0][3])

    for name, extra in (
            ("hist", ["--epochs", "1", "--watch_histograms"]),
            ("stop", ["--epochs", "4", "--lr", "0", "--counter", "0"]),
            ("organ", ["--epochs", "1", "--category", "organ"]),
            ("resume", ["--epochs", "1", "--resume_training", "--resume_dir",
                        os.path.join(save, "MLM", "p")])):
        d = str(base / name)
        argv = ["--run_name", "p", "--data_dir", data, "--save_dir", d,
                *TRAIN, *extra]
        out[name + "_stdout"] = _quiet(vqa_train.main, argv, device="cpu")
        out[name] = _lines(d, "p")
        out[name + "_dir"] = d

    jsave = str(base / "jax")
    original = _recording(jax_vqa_train, "build_answer_vocab", jvocab)
    try:
        with _jax_cli_globals():
            _quiet(jax_vqa_train.main, [
                "--run_name", "p", "--data_dir", data, "--save_dir", jsave,
                "--steps_per_call", "1", *TRAIN])
    finally:
        jax_vqa_train.build_answer_vocab = original
    out.update(jsave=jsave, jax=_lines(jsave, "p"), jvocab=jvocab[0][3])
    return out


def test_both_clis_build_one_answer_vocabulary(runs):
    assert runs["vocab"] == runs["jvocab"] and len(runs["vocab"]) > 5
    assert "numclasses " + str(len(runs["vocab"])) in runs["stdout"]


def test_cli_writes_the_jax_clis_files_and_log_keys(runs):
    """The metric lines with their per-category keys, and both best
    checkpoints under MLM/ (files here, orbax directories there)."""
    def names(d):
        return sorted(os.listdir(d)) + sorted(
            "MLM/" + n for n in os.listdir(os.path.join(d, "MLM")))

    for d, lines in ((runs["save"], runs["port"]), (runs["jsave"],
                                                     runs["jax"])):
        # the accuracy checkpoint where a val accuracy beat 0 (the models
        # start from different random weights)
        acc = max(r["val_total_acc"] for r in lines) > 0
        assert names(d) == ["MLM", "p_metrics.jsonl"] + ["MLM/p"] * acc + [
            "MLM/p_loss"], d
    assert len(runs["port"]) == len(runs["jax"]) == 2
    for a, b in zip(runs["port"], runs["jax"]):
        assert a.keys() == b.keys()
    assert {"total_acc", "abnorm_acc", "binary_bleu", "val_total_acc",
            "test_loss"} <= runs["port"][0].keys()


def test_cli_losses_are_finite_and_the_weights_load(runs):
    for r in runs["port"]:
        for k in ("train_loss", "val_loss", "test_loss", "val_total_acc",
                  "total_acc", "total_bleu", "train_items_per_sec",
                  "learning_rate"):
            assert math.isfinite(r[k]), (k, r)
    for name in ("p", "p_loss"):
        w = checkpoint.load_weights(os.path.join(runs["save"], "MLM", name))
        assert all(torch.isfinite(v.float()).all() for v in w.values())
        assert w["classifier_2.weight"].shape[0] == len(runs["vocab"])


def test_first_train_batch_is_the_jax_loaders_first(runs):
    """The JAX package's loader over its VQADataset, built from the same
    flags on the same files after the same seeding."""
    args = jax_common.vqa_parser(False).parse_args(
        ["--run_name", "p", "--data_dir", runs["data"], *TRAIN])
    cfg = jax_common.config_from_args(args)
    jax_seed_everything(cfg.seed)
    tok, cfg = jax_common.load_tokenizer(cfg)
    train_df, val_df, test_df = jax_datasets.load_vqa_data(cfg)
    train_df, *_ = jax_datasets.build_answer_vocab(train_df, val_df, test_df)
    ds = jax_datasets.VQADataset(cfg, train_df, tok, "train")
    loader = JaxBatchLoader(ds, cfg.batch_size, shuffle=True, seed=cfg.seed,
                            num_workers=cfg.num_workers)
    want = next(iter(loader))
    got = runs["first"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["image"].shape == (8, 32, 32, 3)


def test_watch_histograms_logs_them_and_leaves_the_training_alone(runs):
    """The histogram line (of the train criterion: the category smoothing
    here) after the epoch's metrics, and the first epoch's numbers of the
    run without the flag."""
    lines = runs["hist"]
    assert ["histograms" in r for r in lines] == [False, True]
    hist = lines[1]["histograms"]
    assert sum(hist["ghist/classifier_2/kernel"]["counts"]) == 32 * len(
        runs["vocab"])
    assert {k.split("/")[0] for k in hist} == {"ghist", "whist"}
    for k in ("train_loss", "val_loss", "test_loss", "total_acc"):
        assert lines[0][k] == runs["port"][0][k], k


def test_early_stopping_ends_the_run_as_the_counter_says(runs):
    """--counter 0 with the weights held (--lr 0): the run ends at the first
    epoch whose best validation accuracy is no better, as EarlyStopping
    replayed over the logged accuracies says, before --epochs."""
    from mmvqa_tpu_torch.train.plateau import EarlyStopping

    lines = runs["stop"]
    stopper, best, stop_at = EarlyStopping(patience=0), 0.0, None
    for i, r in enumerate(lines):
        best = max(best, r["val_total_acc"])
        if stopper.update(best):
            stop_at = i
            break
    assert stop_at == len(lines) - 1 < 3
    assert "Counter expired, finishing." in runs["stop_stdout"]


def test_category_branch_logs_its_keys_and_vocabulary(runs):
    """--category organ: the vocabulary of that category's answers over the
    three splits (the JAX function's), the category's four keys."""
    line = runs["organ"][0]
    assert {"val_organ_acc", "organ_acc", "val_organ_bleu",
            "organ_bleu"} <= line.keys()
    assert all(math.isfinite(line[k]) for k in ("organ_acc", "organ_bleu"))
    jcfg = jax_vqa_config(data_dir=runs["data"])
    want = jax_datasets.build_answer_vocab(
        *jax_datasets.load_vqa_data(jcfg), "organ")[3]
    assert f"numclasses {len(want)}" in runs["organ_stdout"]


def test_resume_training_takes_up_the_weights_and_refuses_others(runs,
                                                                 tmp_path):
    assert "resume training" in runs["resume_stdout"]
    assert math.isfinite(runs["resume"][0]["val_loss"])
    # weights of another category's head do not fit this model
    other = os.path.join(runs["organ_dir"], "MLM", "p_loss")
    argv = ["--run_name", "q", "--data_dir", runs["data"], "--save_dir",
            str(tmp_path), *TRAIN, "--resume_training", "--resume_dir"]
    with pytest.raises(ValueError, match="incompatible"):
        _quiet(vqa_train.main, argv + [other], device="cpu")
    # a pipeline-stacked file of these weights is taken up through
    # adapt_encoder_layout; one whose stacked layers do not fit is refused
    from mmvqa_tpu_torch.parallel.pipeline import stack_encoder_state

    weights = checkpoint.load_weights(os.path.join(runs["save"], "MLM",
                                                   "p_loss"))
    stacked = stack_encoder_state(weights)
    assert "encoder.pp_layers.kqv.weight" in stacked
    torch.save(stacked, str(tmp_path / "stacked"))
    back = checkpoint.adapt_encoder_layout(weights, stacked)
    assert back.keys() == weights.keys() and all(
        torch.equal(back[k], weights[k]) for k in weights)
    stacked["encoder.pp_layers.kqv.weight"] = torch.zeros(1)
    torch.save(stacked, str(tmp_path / "bad_stacked"))
    with pytest.raises(ValueError, match="incompatible"):
        _quiet(vqa_train.main, argv + [str(tmp_path / "bad_stacked")],
               device="cpu")


def test_use_pretrained_transfers_all_but_the_answer_layer(runs, tmp_path):
    """Weights of a model with another answer vocabulary (the organ run's):
    every tensor but ``classifier_2`` transfers."""
    src = os.path.join(runs["organ_dir"], "MLM", "p_loss")
    printed = _quiet(vqa_train.main, [
        "--run_name", "q", "--data_dir", runs["data"], "--save_dir",
        str(tmp_path), *TRAIN, "--epochs", "1", "--use_pretrained",
        "--model_dir", src], device="cpu")
    n = len(checkpoint.load_weights(src))
    assert f"transferred {n - 2}/{n} tensors" in printed


# ------------------------------------------------------ the evaluation CLI ----

def _port_weights(tree, cfg, path):
    """A JAX weights tree -> the port's weights file, through the bridge."""
    model = MMBert(cfg, device="cpu")
    sd = bridge.to_state_dict(tree, model)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(sd, path)


@pytest.fixture(scope="module")
def evals(runs):
    """The JAX CLI's fine-tuned weights (A) and a copy moved by seeded
    noise (B), each carried to the port's format by the bridge; both
    ``vqa_eval`` CLIs on A and on the ensemble A + B. Keeps each run's
    files and the JAX run's logits."""
    base = runs["base"] / "eval"
    a = os.path.join(runs["jsave"], "MLM", "p_loss")
    tree = jax_checkpoint.load_weights(a)
    rng = np.random.default_rng(9)
    noisy = jax.tree.map(
        lambda x: np.asarray(x) + 0.3 * np.std(x) * rng.normal(
            size=np.shape(x)).astype(np.float32), tree)
    b = str(base / "jax_w" / "p_b")
    jax_checkpoint.save_pytree(b, noisy)
    args = common.vqa_parser(True).parse_args(
        ["--run_name", "e", "--data_dir", runs["data"], *FLAGS])
    cfg = common.config_from_args(args).replace(num_classes=len(runs["vocab"]))
    cfg = common.load_tokenizer(cfg)[1]
    pa, pb = str(base / "port_w" / "p_loss"), str(base / "port_w" / "p_b")
    _port_weights(tree, cfg, pa)
    _port_weights(noisy, cfg, pb)

    out = {}
    for label, jdirs, pdirs in (("single", [a], [pa]),
                                ("ensemble", [a, b], [pa, pb])):
        logits = []
        original = jax_vqa_eval.vqa_epoch

        def keep(*args, **kw):
            state, m = original(*args, **kw)
            logits.append(np.asarray(m["logits"]))
            return state, m

        jax_vqa_eval.vqa_epoch = keep
        try:
            jdir = str(base / f"jax_{label}")
            with _jax_cli_globals():
                _quiet(jax_vqa_eval.main, [
                    "--run_name", "e", "--data_dir", runs["data"],
                    "--save_dir", jdir, "--model_dir", a, "--model_dirs",
                    *jdirs, "--steps_per_call", "1", *FLAGS])
        finally:
            jax_vqa_eval.vqa_epoch = original
        pdir = str(base / f"port_{label}")
        printed = _quiet(vqa_eval.main, [
            "--run_name", "e", "--data_dir", runs["data"], "--save_dir", pdir,
            "--model_dir", pa, "--model_dirs", *pdirs, *FLAGS], device="cpu")
        out[label] = dict(jdir=jdir, pdir=pdir, printed=printed,
                          logits=np.mean(np.stack(logits), axis=0))
    return out


def _rows(path, delimiter=","):
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter=delimiter))


@pytest.mark.parametrize("label", ["single", "ensemble"])
def test_eval_files_equal_the_jax_clis_but_at_near_ties(evals, label):
    """Both files, line by line: equal wherever the JAX logits' top two are
    more than 1e-4 apart; a near-tie line may differ in the answer only."""
    e = evals[label]
    top2 = np.sort(e["logits"], axis=-1)[:, -2:]
    tie = (top2[:, 1] - top2[:, 0]) <= 1e-4
    assert len(tie) == 10 and tie.sum() <= 5, tie
    for name, delim, header in (("p_loss_preds.csv", ",", 1),
                                ("p_loss_res.txt", "|", 0)):
        got = _rows(os.path.join(e["pdir"], name), delim)
        want = _rows(os.path.join(e["jdir"], name), delim)
        assert len(got) == len(want) == 10 + header
        assert got[:header] == want[:header]
        for i, (g, w) in enumerate(zip(got[header:], want[header:])):
            if not tie[i]:
                assert g == w, (name, i)
            else:
                assert g[0] == w[0]
        raw = open(os.path.join(e["pdir"], name), "rb").read()
        if not tie.any():
            assert raw == open(os.path.join(e["jdir"], name), "rb").read()
    assert ("ensembled 2 models" in e["printed"]) == (label == "ensemble")


def test_eval_metric_line_has_the_jax_keys(evals):
    """The ``testing-<model>`` line: the test loss and the per-category
    accuracy and BLEU, as the JAX CLI logs them; the accuracy is the share
    of _preds.csv rows whose prediction is the answer."""
    e = evals["single"]
    got = _lines(e["pdir"], "testing-p_loss")[0]
    want = _lines(e["jdir"], "testing-p_loss")[0]
    assert got.keys() == want.keys()
    rows = _rows(os.path.join(e["pdir"], "p_loss_preds.csv"))
    col = rows[0].index("decode_preds")
    share = np.mean([r[col] == r[col + 1] for r in rows[1:]]) * 100
    assert got["total_acc"] == pytest.approx(round(share, 4))


# -------------------------------------------------- VQA-Med 2020 data paths ----

def _plain(table_rows):
    return [[None if isinstance(x, float) and math.isnan(x) else
             (x.item() if hasattr(x, "item") else x) for x in r]
            for r in table_rows]


def test_load_2020_data_equals_the_jax_function(data_dirs):  # noqa: F811
    clef2019, root2020 = data_dirs
    kw = dict(data_dir=clef2019, image_size=32, max_position_embeddings=20)
    want = jax_vqamed2020.load_2020_data(jax_vqa_config(**kw), root2020)
    got = vqamed2020.load_2020_data(vqa_config(**kw), root2020)
    assert got[3:] == want[3:] and got[4] >= 1
    for g, w in zip(got[:3], want[:3]):
        assert g.columns == w.columns.tolist()
        assert _plain(g.rows) == _plain(w.values.tolist())
    tok = WordPieceTokenizer.find_and_load(data_dir=clef2019)
    jtok = JaxTokenizer.find_and_load(data_dir=clef2019)
    cfg, jcfg = vqa_config(**kw), jax_vqa_config(**kw)
    for mode, i in (("train", 0), ("eval", 1)):
        ds = vqamed2020.VQAMed2020Dataset(cfg, got[i], tok, mode)
        ref = jax_vqamed2020.VQAMed2020Dataset(
            jcfg, want[i].reset_index(drop=True), jtok, mode)
        assert len(ds) == len(ref) > 0
        for j in range(len(ds)):
            a, b = ds[j], ref[j]
            assert a.keys() == b.keys() and "keyword" in a
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("vocab", [False, True])
def test_binary_dataset_equals_the_jax_one(tmp_path, vocab):
    """On text answers (yes and no kept, mapped to 1 and 0) and, the
    reference's quirk, on answer ids (ids 0 and 1 kept as they are)."""
    from mmvqa_tpu.data.fixtures import make_vqa_fixture as jax_fixture

    root = jax_fixture(str(tmp_path / "vqa"), n_per_cat=3)
    kw = dict(data_dir=root, image_size=32, max_position_embeddings=20)
    cfg, jcfg = vqa_config(**kw), jax_vqa_config(**kw)
    port = datasets.load_vqa_data(cfg)
    ref = jax_datasets.load_vqa_data(jcfg)
    if vocab:
        port = datasets.build_answer_vocab(*port)[:3]
        ref = jax_datasets.build_answer_vocab(*ref)[:3]
    ds = vqamed2020.VQAMedBinary(cfg, port[0], WordPieceTokenizer
                                 .find_and_load(data_dir=root), "train")
    want = jax_vqamed2020.VQAMedBinary(jcfg, ref[0], JaxTokenizer
                                       .find_and_load(data_dir=root), "train")
    assert len(ds) == len(want) > 0
    for j in range(len(ds)):
        a, b = ds[j], want[j]
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------- the similarity backends ----

CAPS = ["chest x ray", "brain mri scan", "left hand"]
AUGS = ["the chest x ray", "mri scan of brain", "right foot"]


class _FakeTok:
    def __call__(self, texts, **kw):
        ids = [[sum(map(ord, w)) % 97 + 1 for w in t.split()] for t in texts]
        n = max(len(r) for r in ids)
        return {"input_ids": torch.tensor([r + [0] * (n - len(r))
                                           for r in ids])}


class _FakeBert(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.emb = torch.nn.Embedding(98, 8)

    def forward(self, input_ids):
        return types.SimpleNamespace(last_hidden_state=self.emb(input_ids))


def _fakes(monkeypatch):
    """The packages of the three model-backed backends, replaced by fakes
    of the API surface the reference consumes (nothing is loaded)."""
    import transformers

    torch.manual_seed(0)
    tok, bert = _FakeTok(), _FakeBert()
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        classmethod(lambda cls, *a, **k: tok))
    monkeypatch.setattr(transformers.AutoModel, "from_pretrained",
                        classmethod(lambda cls, *a, **k: bert))
    table = {t: np.random.default_rng(len(t)).normal(size=6).astype(
        np.float32) for t in CAPS + AUGS}

    class FakeST:
        def __init__(self, name):
            assert name == "all-mpnet-base-v2"

        def encode(self, texts):
            return np.stack([table[t] for t in texts])

    class FakeScorer:
        def __init__(self, **kw):
            self.kw = kw

        def score(self, cands, refs):
            f1 = 0.01 * (len(cands[0]) + 3 * len(refs[0]))
            return None, None, torch.tensor([f1])

    for name, attr, cls in (("sentence_transformers", "SentenceTransformer",
                             FakeST), ("bert_score", "BERTScorer",
                                       FakeScorer)):
        mod = types.ModuleType(name)
        setattr(mod, attr, cls)
        monkeypatch.setitem(sys.modules, name, mod)


@pytest.mark.parametrize("kind", ["jaccard", "cosine", "sentence_transformers",
                                  "bert_score"])
def test_similarity_backends_give_the_jax_masks(monkeypatch, kind):
    _fakes(monkeypatch)
    got = SimilarityCalculator(kind, clinicalbert="fake")(CAPS, AUGS)
    want = JaxCalculator(kind, clinicalbert="fake")(CAPS, AUGS)
    assert got.dtype == want.dtype == np.float32 and got.shape == (3, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.diag(got), 1.0)


def test_a_backend_without_local_weights_raises_clearly():
    with pytest.raises(RuntimeError, match="cosine similarity needs"):
        SimilarityCalculator("cosine", clinicalbert="/nonexistent/path")
