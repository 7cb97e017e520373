"""The port's Grad-CAM CLI (``mmvqa_tpu_torch.cli.grad_cam``) against the
JAX package's (``mmvqa_tpu.cli.grad_cam``) on the CPU: the parser action by
action, the row selection's errors (pandas' own), imports with jax, pandas,
PIL and matplotlib blocked, and both CLIs on one port-written VQA-Med
fixture with the JAX weights carried across by the bridge (the tiny
flagship at 224 px, the CLI having no image-size flag).

For ``gradcam``, ``gradcam++``, ``eigencam`` and ``--cnn_only gradcam``: the
same printed lines, the heatmaps to 1e-4 (the tolerance of
tests/test_torch_gradcam.py; EigenCAM up to the sign its JAX function leaves
to rounding, ROADMAP.md Queue 3, F11), and the written files held by their
decode: the JAX CLI saves with PIL, the port with its own baseline encoder
(the same layout, other arithmetic), so PIL's decode of the port's file
must lie no farther from the port's overlay, in PSNR, than 1 dB short of
PIL's decode of the JAX file from the JAX overlay. ``scorecam`` and
``ablationcam`` run through the port CLI only: the JAX CLI's C full-model
reruns take minutes on the CPU.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import mmvqa_tpu.explain as jax_explain
from mmvqa_tpu.cli import common as jax_common
from mmvqa_tpu.cli import grad_cam as jax_cli
from mmvqa_tpu.data import build_answer_vocab as jax_build_answer_vocab
from mmvqa_tpu.data import load_vqa_data as jax_load_vqa_data
from mmvqa_tpu.train import checkpoint as jax_checkpoint

import mmvqa_tpu_torch.explain as port_explain
from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.cli import common
from mmvqa_tpu_torch.cli import grad_cam
from mmvqa_tpu_torch.data.datasets import Table
from mmvqa_tpu_torch.data.fixtures import make_vqa_fixture
from mmvqa_tpu_torch.models import MMBert

from test_torch_bridge import jax_variables
from test_torch_cam_zoo import eigen_candidates

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# an image whose Grad-CAM heatmap is not all zero at these weights (the
# channel mean of acts x weights is negative everywhere at most others)
IMG = "synpic_train_plane_0.jpg"
FLAGS = ["--tiny_cnn", "--hidden_size", "32", "--n_layers", "1",
         "--vqa_img", IMG, "--category", "plane"]
HEAT_TOL = 1e-4


def _actions(parser):
    return [(a.option_strings, a.dest, a.default, a.choices, a.type,
             a.required, a.nargs, a.const, a.help)
            for a in parser._actions]


def test_parser_equals_the_jax_parser():
    assert _actions(grad_cam.build_parser()) == _actions(
        jax_cli.build_parser())
    args = grad_cam.build_parser().parse_args(["--model_dir", "m"])
    assert (args.cnn_encoder, args.transformer_model, args.hidden_size,
            args.n_layers, args.max_position_embeddings) == (
        "tf_efficientnetv2_m", "realformer", 768, 4, 28)
    assert not hasattr(args, "mixed_precision")


def test_row_selection_raises_as_pandas():
    t = Table(["img_id", "question", "answer", "category"],
              [["a/x.jpg", "q1", 1, "organ"], ["a/x.jpg", "q2", 2, "plane"],
               ["a/y.jpg", "q3", 3, "organ"], ["a/y.jpg", "q4", 4, "organ"]])
    assert grad_cam.select_row(t, "a/x.jpg", "plane") == ("q2", 2)
    with pytest.raises(ValueError, match="Image does not exist in data "
                                         "split."):
        grad_cam.select_row(t, "a/z.jpg", "organ")
    with pytest.raises(ValueError, match="Image does not exist"):
        grad_cam.select_row(t, "a/x.jpg", "modality")
    with pytest.raises(ValueError) as pandas_error:
        pd.Series(["q3", "q4"]).item()
    with pytest.raises(ValueError) as port_error:
        grad_cam.select_row(t, "a/y.jpg", "organ")
    assert str(port_error.value) == str(pandas_error.value)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A port-written VQA-Med fixture, the JAX variables of the CLI's model
    (seeded, as tests/test_torch_bridge.py fills them) saved for the JAX
    CLI, and the same weights in the port's file through the bridge."""
    base = tmp_path_factory.mktemp("gradcam")
    data = make_vqa_fixture(str(base / "vqa"), n_per_cat=2,
                            image_size=(80, 64))
    flags = ["--data_dir", data, *FLAGS]
    jcfg = jax_common.config_from_args(jax_cli.build_parser().parse_args(
        flags + ["--model_dir", "m"])).replace(category=None)
    jcfg = jax_common.load_tokenizer(jcfg)[1]
    n_classes = jax_build_answer_vocab(*jax_load_vqa_data(jcfg))[4]
    jcfg = jcfg.replace(num_classes=n_classes)
    tree = jax_variables(jcfg)
    jdir = str(base / "jax_w")
    jax_checkpoint.save_pytree(jdir, tree)
    cfg = common.config_from_args(grad_cam.build_parser().parse_args(
        flags + ["--model_dir", "m"])).replace(
        category=None, num_classes=n_classes, vocab_size=jcfg.vocab_size)
    pfile = str(base / "port_w.pt")
    torch.save(bridge.to_state_dict(tree, MMBert(cfg, device="cpu")), pfile)
    return dict(base=base, flags=flags, jdir=jdir, pfile=pfile, data=data)


@contextlib.contextmanager
def _recording(module, into):
    """Records each ``overlay_heatmap(image, heat)`` call of a CLI (and its
    result) in ``into``."""
    original = module.overlay_heatmap

    def wrapped(image, heat, *a, **k):
        out = original(image, heat, *a, **k)
        into.append((np.array(image), np.array(heat), out))
        return out

    module.overlay_heatmap = wrapped
    try:
        yield
    finally:
        module.overlay_heatmap = original


def _run(fn, argv, module, **kw):
    out, calls = io.StringIO(), []
    with _recording(module, calls), contextlib.redirect_stdout(out):
        fn(argv, **kw)
    (call,) = calls
    return out.getvalue(), call


def _port(setup, method, extra=()):
    save = str(setup["base"] / f"port_{method}{'_'.join(extra)}")
    return save, _run(grad_cam.main, setup["flags"] + [
        "--model_dir", setup["pfile"], "--save_dir", save, "--method",
        method, *extra], port_explain, device="cpu")


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("method,extra", [
    ("gradcam", ()), ("gradcam++", ()), ("eigencam", ()),
    ("gradcam", ("--cnn_only",))],
    ids=["gradcam", "gradcam++", "eigencam", "cnn_only-gradcam"])
def test_port_cli_equals_the_jax_cli(setup, method, extra, monkeypatch):
    acts = []
    eigen = port_explain.CAM_METHODS["eigencam"]
    monkeypatch.setitem(port_explain.CAM_METHODS, "eigencam",
                        lambda a: acts.append(a.numpy()) or eigen(a))
    psave, (printed, (image, heat, overlay)) = _port(setup, method, extra)
    jsave = str(setup["base"] / f"jax_{method}{'_'.join(extra)}")
    jprinted, (jimage, jheat, joverlay) = _run(jax_cli.main, setup["flags"] + [
        "--model_dir", setup["jdir"], "--save_dir", jsave, "--method",
        method, *extra], jax_explain)
    assert printed.replace(psave, "SAVE") == jprinted.replace(jsave, "SAVE")
    lines = printed.splitlines()
    assert [x.split(":")[0] for x in lines[-4:]] == [
        "question", "answer",
        "target feature channel" if extra else "preds", "saved"]
    np.testing.assert_array_equal(image, jimage)
    assert heat.shape == jheat.shape == (7, 7)
    if method == "eigencam":
        cands = eigen_candidates(acts[0])
        for h in (heat, jheat):
            assert min(np.abs(h - c[0]).max() for c in cands) <= HEAT_TOL
    else:
        np.testing.assert_allclose(heat, jheat, rtol=0, atol=HEAT_TOL)
        assert heat.max() == pytest.approx(1.0)
    name = f"plane_{IMG}"
    port_file = np.asarray(Image.open(os.path.join(psave, name)).convert(
        "RGB"))
    jax_file = np.asarray(Image.open(os.path.join(jsave, name)).convert(
        "RGB"))
    assert port_file.shape == jax_file.shape == (224, 224, 3)
    assert _psnr(port_file, overlay) >= _psnr(jax_file, joverlay) - 1.0


@pytest.mark.parametrize("method,extra", [
    ("scorecam", ()), ("ablationcam", ()), ("ablationcam", ("--cnn_only",))],
    ids=["scorecam", "ablationcam", "cnn_only-ablationcam"])
def test_port_cli_runs_the_perturbation_methods(setup, method, extra):
    save, (printed, (image, heat, overlay)) = _port(setup, method, extra)
    _, (gprinted, _) = _port(setup, "gradcam", extra)
    assert printed.splitlines()[:-1] == gprinted.splitlines()[:-1]
    assert heat.shape == (7, 7) and np.isfinite(heat).all()
    assert heat.min() >= 0 and heat.max() == pytest.approx(1.0)
    decoded = np.asarray(Image.open(os.path.join(save, f"plane_{IMG}")))
    assert decoded.shape == overlay.shape == (224, 224, 3)
    assert _psnr(decoded, overlay) > 25


def test_main_raises_where_the_image_has_no_row(setup):
    with pytest.raises(ValueError, match="Image does not exist"):
        grad_cam.main(setup["flags"] + [
            "--model_dir", setup["pfile"], "--vqa_img", "nope.jpg"],
            device="cpu")


BLOCKER = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "pandas", "PIL",
                                  "matplotlib", "mmvqa_tpu", "optax",
                                  "orbax"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)
import mmvqa_tpu_torch.explain
from mmvqa_tpu_torch.cli import grad_cam
grad_cam.main(sys.argv[3:] + ["--model_dir", sys.argv[1], "--save_dir",
              sys.argv[2]], device="cpu")
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "pandas", "PIL", "matplotlib", "mmvqa_tpu")]
assert not bad, bad
print("clean")
"""


def test_cli_runs_without_jax_pandas_pil_or_matplotlib(setup):
    save = str(setup["base"] / "blocked")
    out = subprocess.run(
        [sys.executable, "-c", BLOCKER, setup["pfile"], save,
         *setup["flags"]], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("clean")
    assert os.path.exists(os.path.join(save, f"plane_{IMG}"))
