"""Distillation pretraining (``--task distillation``) in the port against the
JAX package on the CPU: ``mse_distillation``, ``MMBert``'s distillation
output (the encoder's ``h``) and its head-less tree through the bridge,
10-step ``make_distill_steps`` trajectories with histograms on the default
model (ResNet one block a stage at full widths and the pre-norm BERT
encoder, at tests/test_torch_default_train.py's pins, its statistics held
against the JAX step in float64 as tests/test_torch_default_drift.py holds
the VQA step's) and on the flagship (the tiny EfficientNetV2 trunk and
RealFormer, at tests/test_torch_finetune.py's pins). The default model's
trajectory runs these tests in tests/test_torch_distill_default.py; the
distillation batch and the CLIs are in tests/test_torch_distill_cli.py."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvqa_tpu.data.images import AugmentSpec as JaxAugmentSpec
from mmvqa_tpu.models.mmbert import MMBert as JaxMMBert
from mmvqa_tpu.ops import losses as jax_losses
from mmvqa_tpu.train import steps as jax_steps
from mmvqa_tpu.train.state import TrainState as JaxTrainState

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.data.images import AugmentSpec
from mmvqa_tpu_torch.models import MMBert
from mmvqa_tpu_torch.ops.losses import mse_distillation
from mmvqa_tpu_torch.train.state import create_train_state
from mmvqa_tpu_torch.train.steps import make_distill_steps

from test_torch_bridge import configs, jax_variables
from test_torch_default_model import default_configs
from test_torch_default_train import STATS_DRIFT as DEFAULT_DRIFT
from test_torch_finetune import (
    LR,
    N_STEPS,
    NOOP,
    _flat,
    _jax_histograms,
    _recording_tx,
)
from test_torch_finetune import STATS_DRIFT as FLAGSHIP_DRIFT

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

B, T = 4, 12
TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_model.py's
CASES = {
    # (config maker, overrides, image size, the pin of its statistics)
    "default": (default_configs, dict(hidden_size=48, n_layers=2), 64,
                DEFAULT_DRIFT),
    "flagship": (configs, dict(hidden_size=32, n_layers=1), 64,
                 FLAGSHIP_DRIFT),
}


def _configs(case, **over):
    make, kw, S, _ = CASES[case]
    kw = dict(kw, task="distillation", max_position_embeddings=T,
              image_size=S, vocab_size=300, lr=LR, dropout_override=0.0)
    kw.update(over)
    return make("mlm", **kw)


def _batch(cfg, rng):
    """Padded captions, a padding sample, the teacher's (B, T, H) states
    off the padding and zero on it."""
    S = cfg.image_size
    lengths = rng.integers(cfg.num_vis + 3, T + 1, size=B)
    lengths[0] = T
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    labels = rng.normal(size=(B, T, cfg.hidden_size)) * mask[..., None]
    return {
        "image": rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8),
        "tokens": (rng.integers(1, cfg.vocab_size, (B, T)) * mask
                   ).astype(np.int32),
        "segment_ids": rng.integers(0, 2, (B, T)).astype(np.int32),
        "input_mask": mask,
        "labels": labels.astype(np.float32),
        "weights": np.array([1.0] * (B - 1) + [0.0], np.float32),
    }


# ----------------------------------------------------------- loss ----

@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_mse_distillation_and_its_gradient_match_jax(rng, masked):
    pred = rng.normal(size=(3, 7, 16)).astype(np.float32)
    target = rng.normal(size=(3, 7, 16)).astype(np.float32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    want, jgrad = jax.value_and_grad(
        lambda p: jax_losses.mse_distillation(p, jnp.asarray(target), jm))(
            jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = mse_distillation(p, torch.from_numpy(target),
                           None if mask is None else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-9)


def test_masked_mse_distillation_of_an_empty_mask_is_zero():
    """max(sum(m) H, 1) keeps an all-padding batch finite."""
    got = mse_distillation(torch.ones(2, 3, 4), torch.zeros(2, 3, 4),
                           torch.zeros(2, 3))
    assert got.item() == 0.0


# ---------------------------------------------------------- model ----

@pytest.fixture(scope="module")
def trees():
    out = {}
    for case in CASES:
        cfg, jcfg = _configs(case, image_size=32)
        out[case] = (cfg, jcfg, jax_variables(jcfg))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_distillation_forward_returns_the_encoders_h_as_jax(trees, case):
    cfg, jcfg, variables = trees[case]
    model = MMBert(cfg, device="cpu")
    model.load_state_dict(bridge.to_state_dict(variables, model), strict=True)
    b = _batch(cfg, np.random.default_rng(5))
    from mmvqa_tpu.data.images import process_batch as jax_process_batch
    from mmvqa_tpu_torch.data.images import process_batch

    args = (b["tokens"], b["segment_ids"], b["input_mask"])
    want = jax.jit(lambda v, img, *a: JaxMMBert(jcfg).apply(
        v, jax_process_batch(img, None, None, False), *a))(
            variables, b["image"], *args)
    with torch.no_grad():
        got = model(process_batch(torch.from_numpy(b["image"])),
                    *(torch.from_numpy(a) for a in args))
    assert got.shape == (B, T, cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_distillation_tree_has_no_heads_and_round_trips(trees, case):
    """Flax makes parameters only where a call reaches: the distillation
    tree has no fc1, classifier or SupCon head, and neither has the port's
    model, even with ``supcon`` set; every leaf goes across and back."""
    cfg, _, variables = trees[case]
    assert sorted(variables["params"]) == ["bert_embedding", "encoder",
                                           "trans"]
    model = MMBert(cfg, device="cpu")
    model.load_state_dict(bridge.to_state_dict(variables, model), strict=True)
    back = bridge._flatten(bridge.to_flax(model.state_dict(), model))
    want = bridge._flatten(variables)
    assert back.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_array_equal(back[path], np.asarray(w),
                                      err_msg="/".join(path))
    both = MMBert(cfg.replace(supcon=True), device="cpu")
    assert not any(k.startswith(("fc1", "classifier", "head_"))
                   for k in both.state_dict())


# ----------------------------------------------------- trajectory ----

def _jax_run(jcfg, variables, batches, x64: bool):
    """N_STEPS jitted JAX distillation steps; float64 parameters,
    statistics, optimizer state and compute under x64 (the JAX package's
    own float32 casts inside stay). Returns the losses, the step-0
    gradients, the variables after the first and the last step and the
    eval loss at the end."""
    dtype = np.float64 if x64 else np.float32
    jax.config.update("jax_enable_x64", x64)
    try:
        cast = lambda a: jnp.asarray(np.asarray(a, dtype))  # noqa: E731
        params = jax.tree.map(cast, variables["params"])
        tx = _recording_tx(LR)
        state = JaxTrainState(
            step=jnp.asarray(0, jnp.int32), params=params,
            batch_stats=jax.tree.map(cast, variables["batch_stats"]),
            opt_state=jax.jit(tx.init)(params), tx=tx)
        step, eval_step = jax_steps.make_distill_steps(
            JaxMMBert(jcfg, dtype=jnp.dtype(dtype)), jcfg,
            aug=JaxAugmentSpec(**NOOP))

        def put(b):
            return {k: jnp.asarray(v.astype(dtype) if v.dtype == np.float32
                                   else v) for k, v in b.items()}

        out = {"loss": [], "vars": {}}
        key = jax.random.PRNGKey(3)
        for i in range(N_STEPS):
            key, sub = jax.random.split(key)
            state, m = step(state, put(batches[i % 3]), sub)
            out["loss"].append(float(m["loss"]))
            if i == 0:
                out["grads"] = jax.device_get(
                    state.opt_state.inner_state[0]["g"])
            if i in (0, N_STEPS - 1):
                out["vars"][i] = {k: v.astype(np.float64) for k, v in _flat(
                    jax.device_get({"params": state.params,
                                    "batch_stats": state.batch_stats})
                ).items()}
        out["eval"] = float(eval_step(state, put(batches[1]))["loss"])
        return out
    finally:
        jax.config.update("jax_enable_x64", False)


def trajectory(case):
    """N_STEPS distillation train steps of both packages (the port's with
    histograms) from the same bridged weights on three batches in turn,
    dropout off, the identity augmentation; on the default model also the
    JAX step in float64. Keeps the losses, the step-0 gradients and the
    port's step-0 histograms, the variables after the first and the last
    step, and each run's eval loss at the end."""
    cfg, jcfg = _configs(case)
    rng = np.random.default_rng(47)
    batches = [_batch(cfg, rng) for _ in range(3)]
    variables = jax_variables(jcfg)
    out = {"case": case, "variables": variables,
           "jax": _jax_run(jcfg, variables, batches, False)}
    if case == "default":
        out["x64"] = _jax_run(jcfg, variables, batches, True)
    model = MMBert(cfg, device="cpu")
    model.load_state_dict(bridge.to_state_dict(variables, model), strict=True)
    state = create_train_state(model, LR)
    step, eval_step = make_distill_steps(model, cfg, aug=AugmentSpec(**NOOP),
                                         histograms=True)
    port = out["port"] = {"loss": [], "vars": {}}
    original = state.apply_gradients

    def keep_grads():
        port["grads"] = bridge.grads_to_flax(model)
        original()

    for i in range(N_STEPS):
        state.apply_gradients = keep_grads if i == 0 else original
        state, m = step(state, batches[i % 3])
        port["loss"].append(float(m["loss"]))
        if i == 0:
            port["hist"] = {k: tuple(x.numpy() for x in v)
                            for k, v in m.items() if "hist/" in k}
        if i in (0, N_STEPS - 1):
            port["vars"][i] = {k: v.astype(np.float64) for k, v in _flat(
                bridge.to_flax(model.state_dict(), model)).items()}
    del state.apply_gradients
    port["eval"] = float(eval_step(state, batches[1])["loss"])
    out["steps"] = state.step
    return out


@pytest.fixture(scope="module")
def run():
    """The flagship's trajectory; the default model's, which also runs the
    JAX step in float64, is tests/test_torch_distill_default.py's."""
    return trajectory("flagship")


def test_distill_loss_trajectory_matches_jax(run):
    jl = np.asarray(run["jax"]["loss"])
    pl = np.asarray(run["port"]["loss"])
    assert pl[-1] < pl[0]
    np.testing.assert_allclose(pl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(pl, jl, rtol=2e-3, atol=2e-3,
                               err_msg=f"\njax  {jl}\nport {pl}")
    np.testing.assert_allclose(run["port"]["eval"], run["jax"]["eval"],
                               rtol=2e-3)
    assert run["steps"] == N_STEPS


# The default trunk's leaves below layer2: their gradients pass the ReLUs of
# the stem and of layer1, whose derivative jumps at 0, and in this batch some
# ReLU inputs there lie within the packages' rounding of 0 and take opposite
# sides: up to 0.7% of a leaf's largest entry moves by a whole term (one of
# layer1_block0/bn3's 256 channels, 2295 of the stem kernel's 9408 entries
# beyond 1e-4 of its largest). Their distance in norm is 0.8-1.1e-3 of the
# leaf's; they are held normwise at the card check's GRAD_NORMWISE
# (chip_smoke.py), every other leaf at 1e-4 of its largest entry.
RELU_CROSSED = ("trans/trunk/conv1/", "trans/trunk/bn1/",
                "trans/trunk/layer1_")
GRAD_NORMWISE = 2e-3


def test_distill_step_0_gradients_match_jax(run):
    want = _flat(run["jax"]["grads"])
    got = _flat(run["port"]["grads"])
    assert got.keys() == want.keys()
    normwise = 0
    for path, w in want.items():
        if run["case"] == "default" and path.startswith(RELU_CROSSED):
            normwise += 1
            err = np.linalg.norm(got[path] - w) / np.linalg.norm(w)
            assert err <= GRAD_NORMWISE, (path, err)
            continue
        np.testing.assert_allclose(got[path], w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max() + 1e-7,
                                   err_msg=path)
    # the stem's conv1 and bn1, layer1_block0's four convs and four norms
    assert normwise == (15 if run["case"] == "default" else 0)
    for leaf in ("trans/token_conv_0/kernel", "trans/token_conv_4/kernel",
                 "bert_embedding/word_embeddings/embedding"):
        assert np.abs(want[leaf]).max() > 0, leaf


def test_distill_histograms_are_the_jax_binning_at_the_pre_update_weights(
        run):
    """The step's histograms have the JAX step's keys, and each equals
    what the JAX package's binning gives for the step's own gradients and
    for the weights they were taken at, count for count."""
    want = _jax_histograms(run["port"]["grads"],
                           run["variables"]["params"])
    got = run["port"]["hist"]
    assert got.keys() == want.keys()
    assert any(k.startswith("ghist/encoder/") for k in want)
    for key, (counts, lo, hi) in want.items():
        g_counts, g_lo, g_hi = got[key]
        np.testing.assert_array_equal(g_counts, counts, err_msg=key)
        assert float(g_lo) == float(lo) and float(g_hi) == float(hi), key


@pytest.mark.parametrize("after", [0, N_STEPS - 1])
def test_distill_parameters_and_statistics_match_jax(run, after):
    """Parameters within a little over 2 lr a step of the JAX run's; the
    statistics tightly after the first step, and after the last within
    the case's drift pin. On the default model that pin holds the port
    against the float64 run, and the port's distances from it add up to
    no more than the JAX package's fp32 run's (by a quarter's margin): in
    the run that set this test the two fp32 runs lay 1.28e-2 apart at
    layer4_block0/bn2/mean, the JAX package's 1.31e-2 from the float64 run
    and the port's 2.6e-3 (as in tests/test_torch_default_drift.py)."""
    drift = CASES[run["case"]][3]
    want = run["jax"]["vars"][after]
    got = run["port"]["vars"][after]
    assert got.keys() == want.keys()
    steps = after + 1
    d_port, d_jax = [], []
    for path, w in want.items():
        diff = np.abs(got[path] - w)
        if path.startswith("batch_stats/") and after == 0:
            np.testing.assert_allclose(got[path], w, err_msg=path, rtol=2e-5,
                                       atol=1e-6)
        elif path.startswith("batch_stats/") and run["case"] == "default":
            ref = run["x64"]["vars"][after][path]
            d_port.append(np.abs(got[path] - ref).max())
            d_jax.append(np.abs(w - ref).max())
            assert d_port[-1] <= drift, (path, d_port[-1])
        elif path.startswith("batch_stats/"):
            assert diff.max() <= drift, (path, diff.max())
        else:
            assert diff.max() <= 2.1 * LR * steps, (path, diff.max())
    assert sum(d_port) <= 1.25 * sum(d_jax), (sum(d_port), sum(d_jax))
