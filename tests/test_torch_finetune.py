"""VQA-Med fine-tuning in mmvqa_tpu_torch against the JAX package, on the CPU
in fp32 at tiny sizes: the VQA losses, the category-smoothing table, the
fine-tune train and eval steps under their three criteria (a 10-step
trajectory from bridged weights each), gradient accumulation, the
checkpoints (the port's own, and a JAX recorder carried across by the
bridge), the transfer of pretrained weights, the histograms, ``vqa_epoch``
and the copies of the plateau scheduler. The same numpy inputs go through
both packages.
"""

import dataclasses
import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mmvqa_tpu.core.mesh import make_mesh
from mmvqa_tpu.data.images import AugmentSpec as JaxAugmentSpec
from mmvqa_tpu.models.mmbert import MMBert as JaxMMBert
from mmvqa_tpu.ops import losses as jax_losses
from mmvqa_tpu.parallel.sharding import place_batch
from mmvqa_tpu.train import checkpoint as jax_checkpoint
from mmvqa_tpu.train import plateau as jax_plateau
from mmvqa_tpu.train import steps as jax_steps
from mmvqa_tpu.train import trainer as jax_trainer
from mmvqa_tpu.train.category_smoothing import (
    build_category_smoothing_table as jax_smoothing_table,
)
from mmvqa_tpu.train.state import TrainState as JaxTrainState
from mmvqa_tpu.train.state import create_train_state as jax_create_train_state

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.data.images import AugmentSpec
from mmvqa_tpu_torch.data.synthetic import (
    CATEGORIES,
    CATS2ANS,
    smoothing_columns,
    vqa_batches,
)
from mmvqa_tpu_torch.models import MMBert
from mmvqa_tpu_torch.ops import losses
from mmvqa_tpu_torch.train import checkpoint, plateau
from mmvqa_tpu_torch.train.category_smoothing import (
    build_category_smoothing_table,
)
from mmvqa_tpu_torch.train.state import create_train_state
from mmvqa_tpu_torch.train.steps import (
    grad_weight_histograms,
    make_vqa_eval_step,
    make_vqa_steps,
)
from mmvqa_tpu_torch.train.trainer import vqa_epoch

from test_torch_bridge import configs, jax_variables

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

NOOP = dict(crop_scale=(1.0, 1.0), crop_ratio=(1.0, 1.0), rotation_deg=0.0,
            brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0)
LR = 1e-4
N_STEPS = 10
NUM_CLASSES = 10
B, T = 4, 12
SMOOTHING = 0.1
# the largest distance of a BatchNorm statistic from the JAX one after
# N_STEPS steps: the largest reading, 2.4e-4 (CE), with twice the room
STATS_DRIFT = 5e-4


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a)).requires_grad_(grad)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


_VARIABLES = {}


def _variables(jcfg, seed=0):
    """jax_variables of a config, built once: the criterion and the
    accumulation do not change the tree, and tracing the JAX model's init
    takes a second or two."""
    key = (repr(dataclasses.replace(jcfg, loss="", smoothing=None,
                                    grad_accum=1)), seed)
    if key not in _VARIABLES:
        _VARIABLES[key] = jax_variables(jcfg, seed)
    return _VARIABLES[key]


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ------------------------------------------------------------- losses ----

def _logits_and_targets(rng, n=6, c=NUM_CLASSES):
    logits = (rng.normal(size=(n, c)) * 3).astype(np.float32)
    targets = rng.integers(0, c, n).astype(np.int32)
    return logits, targets


@pytest.mark.parametrize("name", [
    "cross_entropy", "asl_single_label", "asl_gamma_pos",
    "label_smoothing_loss", "smoothed_soft_target_ce"])
def test_loss_value_and_gradient_match_jax(rng, name):
    """fp32, 1e-5. ASL's weight carries a gradient: its gradient is held
    against jax.grad, not only its value."""
    logits, targets = _logits_and_targets(rng)
    soft = rng.random((6, NUM_CLASSES)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    one_hot = np.eye(NUM_CLASSES, dtype=np.float32)[targets]
    pairs = {
        "cross_entropy": (lambda x: jax_losses.cross_entropy(x, targets),
                          lambda x: losses.cross_entropy(x, _t(targets))),
        "asl_single_label": (
            lambda x: jax_losses.asl_single_label(x, targets),
            lambda x: losses.asl_single_label(x, _t(targets))),
        "asl_gamma_pos": (
            lambda x: jax_losses.asl_single_label(x, targets, gamma_pos=1.0,
                                                  eps=0.0),
            lambda x: losses.asl_single_label(x, _t(targets), gamma_pos=1.0,
                                              eps=0.0)),
        "label_smoothing_loss": (
            lambda x: jax_losses.label_smoothing_loss(x, one_hot, 0.2),
            lambda x: losses.label_smoothing_loss(x, _t(one_hot), 0.2)),
        "smoothed_soft_target_ce": (
            lambda x: jax_losses.smoothed_soft_target_ce(x, soft),
            lambda x: losses.smoothed_soft_target_ce(x, _t(soft))),
    }
    jax_fn, port_fn = pairs[name]
    want, want_g = jax.value_and_grad(jax_fn)(jnp.asarray(logits))
    x = _t(logits.copy(), True)
    got = port_fn(x)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-7)


def test_asl_weight_carries_a_gradient(rng):
    """Holding the weight constant moves the gradient by far more than the
    1e-5 that the match above allows (three classes, where a wrong answer's
    p^4 weight is not small): a detached weight would fail it."""
    C = 3
    logits, targets = _logits_and_targets(rng, c=C)
    x = _t(logits.copy(), True)
    losses.asl_single_label(x, _t(targets)).backward()
    y = _t(logits.copy(), True)
    logp = torch.log_softmax(y, -1)
    one_hot = torch.nn.functional.one_hot(_t(targets).long(), C)
    anti = 1.0 - one_hot.float()
    p = logp.exp().detach()
    wgt = torch.pow(1 - p * one_hot - (1 - p) * anti, 4.0 * anti)
    soft = one_hot * 0.9 + 0.1 / C
    torch.sum(-soft * logp * wgt, -1).mean().backward()
    assert (x.grad - y.grad).abs().max() > 1e-3 * x.grad.abs().max()


def test_mlm_accuracy_matches_jax(rng):
    logits = rng.normal(size=(3, 7, 20)).astype(np.float32)
    targets = (rng.integers(1, 20, (3, 7)) * (rng.random((3, 7)) < 0.5)
               ).astype(np.int32)
    targets[0, :3] = np.argmax(logits[0, :3], -1)  # some hits
    wc, wt = jax_losses.mlm_accuracy(jnp.asarray(logits), jnp.asarray(targets))
    gc, gt = losses.mlm_accuracy(_t(logits), _t(targets))
    assert (int(gc), int(gt)) == (int(wc), int(wt)) and int(wc) >= 1


def test_category_smoothing_writes_into_a_copy_not_the_table(rng):
    logits, answers = _logits_and_targets(rng)
    cats = rng.integers(0, 3, 6)
    table = torch.rand(3, NUM_CLASSES) * 0.01
    before = table.clone()
    per = losses.category_smoothing_per_sample(
        _t(logits), _t(answers), _t(cats), table, SMOOTHING)
    torch.testing.assert_close(table, before, rtol=0, atol=0)
    soft = before[cats].numpy().copy()
    soft[np.arange(6), answers] = 1 - SMOOTHING
    logp = torch.log_softmax(_t(logits), -1).numpy()
    np.testing.assert_allclose(per.numpy(), (-soft * logp).sum(-1),
                               rtol=1e-6)


# ------------------------------------------------- smoothing table ----

def test_smoothing_table_equals_the_jax_one(rng):
    """The port takes the columns as arrays, the JAX function a DataFrame;
    'abnormality' has no answer in this split and keeps a zero row."""
    cats = rng.choice(list(CATEGORIES[:4]), size=40)
    answers = rng.integers(0, 30, 40)
    want = jax_smoothing_table(pd.DataFrame({"category": cats,
                                             "answer": answers}),
                               30, CATS2ANS, 0.2)
    got = build_category_smoothing_table(cats, answers, 30, CATS2ANS, 0.2)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not got[CATS2ANS["abnormality"]].any()


def test_synthetic_batches_carry_the_answers_category():
    cfg, _ = configs("vqa5", batch_size=6, max_position_embeddings=T)
    batches = vqa_batches(cfg, 2, NUM_CLASSES, seed=3, pad_last=2)
    for b in batches:
        np.testing.assert_array_equal(b["category"], b["answer"] % 5)
    cats, answers = smoothing_columns(batches)
    assert len(answers) == 10 and set(cats) <= set(CATEGORIES)
    np.testing.assert_array_equal(
        [CATS2ANS[c] for c in cats], answers % 5)


# ------------------------------------------------------ the plateau ----

def test_plateau_copies_have_the_jax_fields_and_answers():
    for name in ("ReduceLROnPlateau", "EarlyStopping"):
        port, ref = getattr(plateau, name), getattr(jax_plateau, name)
        assert ([(f.name, f.type, f.default) for f in dataclasses.fields(port)]
                == [(f.name, f.type, f.default)
                    for f in dataclasses.fields(ref)]), name
    seq = [1.0, 0.9, 0.95, 0.9, 0.89995, 0.91, 0.92, 0.5, 0.6, 0.7, 0.8]
    p = plateau.ReduceLROnPlateau(lr=1e-3, patience=2, factor=0.5)
    r = jax_plateau.ReduceLROnPlateau(lr=1e-3, patience=2, factor=0.5)
    assert [p.step(m) for m in seq] == [r.step(m) for m in seq]
    assert p.state_dict() == r.state_dict() and p.lr < 1e-3
    q = plateau.ReduceLROnPlateau(lr=0.0)
    q.load_state_dict(p.state_dict())
    assert q == p
    accs = [10, 20, 15, 20, 19, 25, 24, 23, 22]
    e, f = plateau.EarlyStopping(patience=2), jax_plateau.EarlyStopping(2)
    assert [e.update(a) for a in accs] == [f.update(a) for a in accs]
    assert e.update(0) and (e.best, e.counter) == (f.best, f.counter + 1)


# -------------------------------------------------- the trajectories ----

def _vqa_batch(cfg, rng, pad=1):
    S = cfg.image_size
    lengths = rng.integers(cfg.num_vis + 3, T + 1, size=B)
    lengths[0] = T
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    answers = rng.integers(0, NUM_CLASSES, B).astype(np.int32)
    return {
        "image": rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8),
        "tokens": (rng.integers(1, cfg.vocab_size, (B, T)) * mask
                   ).astype(np.int32),
        "segment_ids": rng.integers(0, 2, (B, T)).astype(np.int32),
        "input_mask": mask,
        "answer": answers,
        "category": (answers % 5).astype(np.int32),
        "weights": np.array([1.0] * (B - pad) + [0.0] * pad, np.float32),
    }


def _tiny(**over):
    """hidden 32, one layer (RealFormer's 8 heads divide it), a vocabulary
    of 300, 64 px, as
    tests/test_torch_train.py's trajectories: at 32 px the deepest maps are
    1 x 1 and their batch statistics rest on 3 values."""
    kw = dict(hidden_size=32, n_layers=1, image_size=64, vocab_size=300,
              max_position_embeddings=T, lr=LR, dropout_override=0.0,
              num_classes=NUM_CLASSES)
    kw.update(over)
    return configs("vqa5", **kw)


def _recording_tx(lr):
    """Adam as make_optimizer builds it, behind a transform that keeps each
    step's gradients in the optimizer state, where the test can read the
    JAX train step's own gradients."""
    record = optax.GradientTransformation(
        lambda params: {"g": jax.tree.map(jnp.zeros_like, params)},
        lambda g, s, params=None: (g, {"g": g}))

    @optax.inject_hyperparams
    def tx(learning_rate):
        return optax.chain(record, optax.adam(learning_rate, b1=0.9,
                                              b2=0.999, eps=1e-8))

    return tx(learning_rate=lr)


CRITERIA = {
    # train criterion, eval criterion
    "ce": dict(loss="CrossEntropyLoss", smoothing=None),       # CE, CE
    "asl": dict(loss="ASLSingleLabel", smoothing=None),        # ASL, ASL
    "asl_smooth": dict(loss="ASLSingleLabel", smoothing=SMOOTHING),
    # category smoothing, CE (the table switches ASL off in eval)
}


@pytest.fixture(scope="module", params=sorted(CRITERIA))
def run(request):
    """N_STEPS VQA train steps of both packages from the same bridged
    weights on three batches in turn (padded queries, a padding sample),
    dropout off, the identity augmentation. Keeps each package's losses and
    step-0 predictions, its step-0 gradients, its variables after the first
    and the last step, both eval steps and both eval epochs (``vqa_epoch``
    over the three batches and a fourth with three padding samples) on the
    untrained weights, and the port's train epoch after the last step."""
    cfg, jcfg = _tiny(**CRITERIA[request.param])
    rng = np.random.default_rng(31)
    batches = [_vqa_batch(cfg, rng) for _ in range(3)]
    epoch_batches = batches + [_vqa_batch(cfg, rng, pad=3)]
    table = None
    if cfg.smoothing:
        table = build_category_smoothing_table(
            *smoothing_columns(batches), NUM_CLASSES, CATS2ANS, SMOOTHING)
        assert table.any()
    variables = _variables(jcfg)

    jmodel = JaxMMBert(jcfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = _recording_tx(LR)
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                           batch_stats=jax.tree.map(
                               jnp.asarray, variables["batch_stats"]),
                           opt_state=jax.jit(tx.init)(params), tx=tx)
    jstep, jeval = jax_steps.make_vqa_steps(
        jmodel, jcfg, aug=JaxAugmentSpec(**NOOP),
        category_smoothing_table=table)
    model = MMBert(cfg, device="cpu")
    model.load_state_dict(bridge.to_state_dict(variables, model), strict=True)
    state = create_train_state(model, LR)
    step, evaluate = make_vqa_steps(model, cfg, aug=AugmentSpec(**NOOP),
                                    category_smoothing_table=table)

    out = {"cfg": cfg, "table": table, "batches": batches,
           "jax": {"loss": [], "vars": {}}, "port": {"loss": [], "vars": {}}}
    # placed as vqa_epoch places a batch, so that the epoch reuses the
    # compiled eval step
    mesh = make_mesh(dp_size=1, devices=jax.devices()[:1])
    out["jax"]["eval"] = jeval(jstate, place_batch(batches[1], mesh))
    out["port"]["eval"] = evaluate(state, batches[1])
    _, out["jax"]["epoch"] = jax_trainer.vqa_epoch(
        jeval, jstate, epoch_batches, mesh, None, False, collect_logits=True)
    _, out["port"]["epoch"] = vqa_epoch(evaluate, state, epoch_batches, False,
                                        collect_logits=True)

    original = state.apply_gradients

    def keep_grads():  # the port's step-0 gradients, before the update
        out["port"]["grads"] = bridge.grads_to_flax(model)
        original()

    key = jax.random.PRNGKey(3)
    for i in range(N_STEPS):
        b = batches[i % 3]
        key, sub = jax.random.split(key)
        jstate, jm = jstep(jstate, _jnp(b), sub)
        state.apply_gradients = keep_grads if i == 0 else original
        state, m = step(state, b)
        out["jax"]["loss"].append(float(jm["loss"]))
        out["port"]["loss"].append(float(m["loss"]))
        if i == 0:
            out["jax"]["grads"] = jax.device_get(
                jstate.opt_state.inner_state[0]["g"])
            out["jax"]["preds"] = np.asarray(jm["preds"])
            out["port"]["preds"] = m["preds"].numpy()
        if i in (0, N_STEPS - 1):
            out["jax"]["vars"][i] = jax.device_get(
                {"params": jstate.params, "batch_stats": jstate.batch_stats})
            out["port"]["vars"][i] = bridge.to_flax(model.state_dict(), model)
    del state.apply_gradients
    out["steps"] = state.step
    state, out["port"]["train_epoch"] = vqa_epoch(step, state, epoch_batches,
                                                  True)
    out["state"] = state
    return out


def test_loss_trajectory_matches_the_jax_train_step(run):
    jl = np.asarray(run["jax"]["loss"])
    pl = np.asarray(run["port"]["loss"])
    assert pl[-1] < pl[0]  # training moves
    np.testing.assert_allclose(pl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(pl, jl, rtol=2e-3, atol=2e-3,
                               err_msg=f"\njax  {jl}\nport {pl}")
    np.testing.assert_array_equal(run["port"]["preds"], run["jax"]["preds"])
    assert run["steps"] == N_STEPS


def test_step_0_gradients_match_jax_leaf_by_leaf(run):
    want = _flat(run["jax"]["grads"])
    got = _flat(run["port"]["grads"])
    assert got.keys() == want.keys()
    for path, w in want.items():
        # tests/test_torch_train.py's tolerance: within 1e-4 of the leaf's
        # largest entry, 1e-7 for the leaves that are zero but for rounding
        np.testing.assert_allclose(got[path], w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max() + 1e-7,
                                   err_msg=path)
    assert np.abs(want["classifier_2/kernel"]).max() > 0
    assert np.abs(want["trans/token_conv_0/kernel"]).max() > 0


@pytest.mark.parametrize("after", [0, N_STEPS - 1])
def test_post_step_parameters_and_batch_stats_match_jax(run, after):
    """tests/test_torch_train.py's rule: every entry within a little over
    2 lr a step taken (Adam's first step is lr sign(g), so a gradient entry
    near 0 whose sign differs between the packages moves its weight 2 lr
    apart), 99.5% of a large leaf within a hundredth of that; the statistics
    tightly after the first step. After the last, the weights below a
    statistic have drifted by that rule: 99% of its entries within the
    trajectory's tolerance (rtol 2e-3, atol 2e-4) and each within
    STATS_DRIFT (the MLM pin holds all of them to the trajectory's
    tolerance; here a few entries of stage 4's first statistics read up
    to 2.4e-4)."""
    want = _flat(run["jax"]["vars"][after])
    got = _flat(run["port"]["vars"][after])
    assert got.keys() == want.keys()
    steps = after + 1
    for path, w in want.items():
        if path.startswith("batch_stats/") and after == 0:
            np.testing.assert_allclose(got[path], w, err_msg=path, rtol=2e-5,
                                       atol=1e-6)
            continue
        if path.startswith("batch_stats/"):
            # the trajectory's tolerance for 99% of the entries; every entry
            # within the largest move the parameter rule allows one
            diff = np.abs(got[path] - w)
            assert np.mean(diff > 2e-4 + 2e-3 * np.abs(w)) < 0.01, path
            assert diff.max() <= STATS_DRIFT, (path, diff.max())
            continue
        diff = np.abs(got[path] - w)
        assert diff.max() <= 2.1 * LR * steps, (path, diff.max())
        if w.size >= 1000:
            assert np.mean(diff > 0.02 * LR * steps) < 0.005, path


def test_eval_step_loss_matches_jax_under_each_criterion(run):
    """On the untrained weights: the eval criterion is ASL under
    ASLSingleLabel, and CE once the category-smoothing table is in use
    (the reference's eval_criterion). The rule that picked ASL from the
    configured loss alone misses it by far."""
    je, pe = run["jax"]["eval"], run["port"]["eval"]
    np.testing.assert_allclose(pe["logits"].numpy(), np.asarray(je["logits"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(pe["loss"]), float(je["loss"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(pe["preds"].numpy(), np.asarray(je["preds"]))
    b, logits = run["batches"][1], pe["logits"]
    w = _t(b["weights"])
    asl = float(losses.weighted_mean(
        losses.asl_per_sample(logits, _t(b["answer"])), w))
    ce = float(losses.weighted_mean(
        losses.cross_entropy_per_sample(logits, _t(b["answer"])), w))
    cfg = run["cfg"]
    if cfg.loss == "ASLSingleLabel" and run["table"] is None:
        assert float(pe["loss"]) == pytest.approx(asl, rel=1e-6)
    else:
        assert float(pe["loss"]) == pytest.approx(ce, rel=1e-6)
    # the parent's rule: ASL whenever cfg.loss says so
    parent = asl if cfg.loss == "ASLSingleLabel" else ce
    if run["table"] is not None:
        assert abs(parent - float(je["loss"])) > 1e3 * 1e-5 * abs(
            float(je["loss"]))
    # the serving wrapper, which takes no table, keeps the configured loss
    again = make_vqa_eval_step(run["state"].model, cfg)(b)
    per = (losses.asl_per_sample if cfg.loss == "ASLSingleLabel"
           else losses.cross_entropy_per_sample)
    assert float(again["loss"]) == pytest.approx(float(losses.weighted_mean(
        per(again["logits"], _t(b["answer"])), w)), rel=1e-6)


def test_vqa_epoch_matches_the_jax_loop(run):
    """Eval epochs of both packages over the same batches, the last one
    with three padding samples of four, from the same bridged weights under
    each criterion; then a train epoch of the port."""
    got, want = run["port"]["epoch"], run["jax"]["epoch"]
    assert len(got["preds"]) == len(got["targets"]) == 10 == len(want["preds"])
    np.testing.assert_array_equal(got["targets"], want["targets"])
    np.testing.assert_array_equal(got["preds"], want["preds"])
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["items_per_sec"] > 0
    tm = run["port"]["train_epoch"]
    assert run["state"].step == N_STEPS + 4 and np.isfinite(tm["loss"])
    assert "logits" not in tm and len(tm["preds"]) == 10


# ------------------------------------------------------- histograms ----

def _jax_histograms(grads, params):
    """jax_steps.grad_weight_histograms on the CPU: its keys, each with the
    value of its per-leaf function, vmapped over the leaves of one shape
    (59 histograms to compile instead of 196, 2.5 s instead of 5.5)."""
    named = {}
    for prefix, tree in (("ghist", grads), ("whist", params)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join([prefix] + [k.key for k in path])
            named[key] = np.asarray(leaf)
    assert named.keys() == jax.eval_shape(jax_steps.grad_weight_histograms,
                                          grads, params).keys()
    shapes = sorted({v.shape for v in named.values()})
    groups = [[k for k, v in named.items() if v.shape == s] for s in shapes]

    def one(x):
        return jax_steps._param_histograms({"x": x}, "h")["h/x"]

    stacked = jax.device_get(jax.jit(
        lambda xs: [jax.vmap(one)(x) for x in xs])(
            [np.stack([named[k] for k in g]) for g in groups]))
    return {k: tuple(part[i] for part in hist)
            for g, hist in zip(groups, stacked) for i, k in enumerate(g)}


def test_histograms_equal_the_jax_ones_key_by_key():
    """The same gradients and parameters binned by both packages (the
    gradients a seeded numpy tree of the parameters' shapes, bridged): 64
    counts, lo and hi equal, key by key."""
    cfg, jcfg = _tiny()
    variables = _variables(jcfg)
    rng = np.random.default_rng(2)
    grads = jax.tree.map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32),
        variables["params"])
    want = _jax_histograms(grads, variables["params"])
    model = MMBert(cfg, device="cpu")
    model.load_state_dict(bridge.to_state_dict(variables, model), strict=True)
    moved = bridge._params_to_torch(grads, model)
    for name, p in model.named_parameters():
        p.grad = moved[name]
    got = grad_weight_histograms(model)
    assert got.keys() == want.keys()
    assert len(got) == 2 * len(moved)
    for key, (counts, lo, hi) in want.items():
        g_counts, g_lo, g_hi = got[key]
        np.testing.assert_array_equal(g_counts.numpy(), counts, err_msg=key)
        assert float(g_lo) == float(lo) and float(g_hi) == float(hi), key
        assert int(g_counts.sum()) == np.asarray(counts).sum() > 0


def test_train_step_returns_histograms_at_the_pre_update_weights():
    cfg, jcfg = _tiny()
    variables = _variables(jcfg)
    model = MMBert(cfg, device="cpu")
    model.load_state_dict(bridge.to_state_dict(variables, model), strict=True)
    before = grad_weight_histograms(model)
    step, _ = make_vqa_steps(model, cfg, aug=AugmentSpec(**NOOP),
                             histograms=True)
    batch = _vqa_batch(cfg, np.random.default_rng(2))
    _, m = step(create_train_state(model, LR), batch)
    assert {"loss", "preds"} | set(before) == set(m)
    for key in before:
        if key.startswith("whist/"):
            for a, b in zip(m[key], before[key]):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(m["ghist/classifier_2/kernel"][0].sum()) == 32 * NUM_CLASSES


# ------------------------------------------------ gradient accumulation ----

class _TwoLeaves(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(_t(w).clone())
        self.b = torch.nn.Parameter(_t(b).clone())


@pytest.mark.parametrize("clip", [False, True])
def test_accumulation_equals_adam_on_the_mean_gradient(clip):
    """tests/test_grad_accum.py:20, against the JAX state: micro-step 1
    leaves the parameters; micro-step 2 is Adam (after the clip) on the
    mean of the two gradients; the rate changes mid-accumulation; Adam's
    count moves on real updates only; ``step`` counts micro-steps."""
    w0, b0 = np.ones(3, np.float32), np.zeros(2, np.float32)
    gs = [(np.array([1.0, 2.0, 3.0], np.float32),
           np.array([0.5, -0.5], np.float32)),
          (np.array([3.0, 2.0, 1.0], np.float32),
           np.array([-0.5, 0.5], np.float32)),
          (np.array([0.1, -0.2, 0.3], np.float32),
           np.array([0.05, 0.0], np.float32)),
          (np.array([-0.3, 0.1, 0.2], np.float32),
           np.array([0.02, 0.01], np.float32))]
    js = jax_create_train_state({"params": {"w": jnp.asarray(w0),
                                            "b": jnp.asarray(b0)}}, 1e-2,
                                clip, grad_accum=2)
    state = create_train_state(_TwoLeaves(w0, b0), 1e-2, clip, grad_accum=2)
    for i, (gw, gb) in enumerate(gs):
        if i == 2:  # between the two micro-steps of the second update
            js = js.with_lr(5e-3)
            state.with_lr(5e-3)
        if i == 3:
            assert state.lr == pytest.approx(js.lr) == 5e-3
        js = js.apply_gradients({"w": jnp.asarray(gw), "b": jnp.asarray(gb)})
        state.model.w.grad, state.model.b.grad = _t(gw).clone(), _t(gb).clone()
        state.apply_gradients()
        assert state.step == int(js.step) == i + 1
        assert state.mini_step == (i + 1) % 2
        adam = state.optimizer.state.get(state.model.w, {})
        assert float(adam.get("step", 0)) == (i + 1) // 2
        np.testing.assert_allclose(state.model.w.detach().numpy(),
                                   np.asarray(js.params["w"]), atol=1e-7)
        np.testing.assert_allclose(state.model.b.detach().numpy(),
                                   np.asarray(js.params["b"]), atol=1e-7)
        if i == 0:
            np.testing.assert_array_equal(state.model.w.detach().numpy(), w0)
    mean = create_train_state(_TwoLeaves(w0, b0), 1e-2, clip)
    mean.model.w.grad = _t((gs[0][0] + gs[1][0]) / 2)
    mean.model.b.grad = _t((gs[0][1] + gs[1][1]) / 2)
    mean.apply_gradients()
    two = create_train_state(_TwoLeaves(w0, b0), 1e-2, clip, grad_accum=2)
    for gw, gb in gs[:2]:
        two.model.w.grad, two.model.b.grad = _t(gw).clone(), _t(gb).clone()
        two.apply_gradients()
    torch.testing.assert_close(two.model.w, mean.model.w, rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="grad_accum"):
        create_train_state(_TwoLeaves(w0, b0), 1e-2, grad_accum=0)


def _adam_and_accumulator(opt_state):
    """Adam's (mu, nu, count) and MultiSteps' (acc_grads, mini_step) out of
    a JAX optimizer state, as plain nested dicts of numpy arrays."""
    def find(tree, kind):
        hits = [x for x in jax.tree.leaves(
            tree, is_leaf=lambda x: isinstance(x, kind)) if isinstance(x, kind)]
        assert len(hits) == 1, (kind, len(hits))
        return hits[0]

    multi = find(opt_state, optax.MultiStepsState)
    adam = find(multi.inner_opt_state, optax.ScaleByAdamState)
    as_np = lambda t: jax.tree.map(np.asarray, jax.device_get(t))  # noqa: E731
    return dict(mu=as_np(adam.mu), nu=as_np(adam.nu), count=int(adam.count),
                acc_grads=as_np(multi.acc_grads),
                mini_step=int(multi.mini_step))


@pytest.fixture(scope="module")
def accum(tmp_path_factory):
    """Two micro-steps of grad_accum=2 in both packages from the same
    bridged weights (CE, dropout off, the identity augmentation), with each
    package's recorder taken between them and restored into a fresh state;
    the JAX recorder also comes across through the bridge."""
    cfg, jcfg = _tiny(grad_accum=2)
    rng = np.random.default_rng(41)
    b1, b2 = _vqa_batch(cfg, rng), _vqa_batch(cfg, rng)
    variables = _variables(jcfg)
    jmodel = JaxMMBert(jcfg)
    jstep, _ = jax_steps.make_vqa_steps(jmodel, jcfg,
                                        aug=JaxAugmentSpec(**NOOP))

    def jfresh():
        return jax_create_train_state(jax.tree.map(jnp.asarray, variables),
                                      LR, grad_accum=2)

    def fresh():
        model = MMBert(cfg, device="cpu")
        model.load_state_dict(bridge.to_state_dict(variables, model),
                              strict=True)
        state = create_train_state(model, LR, grad_accum=2)
        step, _ = make_vqa_steps(model, cfg, aug=AugmentSpec(**NOOP))
        return state, step

    def snap(state):
        return bridge.to_flax(state.model.state_dict(), state.model)

    out = {"jax": {}, "port": {}}
    js, _ = jstep(jfresh(), _jnp(b1), jax.random.PRNGKey(1))
    out["jax"][1] = jax.device_get({"params": js.params,
                                    "batch_stats": js.batch_stats})
    jdir = str(tmp_path_factory.mktemp("jax_recorder"))
    sched = plateau.ReduceLROnPlateau(lr=LR, patience=1)
    sched.step(0.5)
    jax_checkpoint.save_recorder(jdir, 4, js, sched.state_dict())
    restored, jsched, jepoch = jax_checkpoint.restore_recorder(jdir, jfresh())
    out["flax_recorder"] = dict(
        params=jax.tree.map(np.asarray, restored.params),
        batch_stats=jax.tree.map(np.asarray, restored.batch_stats),
        step=int(restored.step), epoch=jepoch, scheduler=jsched,
        lr=restored.lr, **_adam_and_accumulator(restored.opt_state))
    js, _ = jstep(js, _jnp(b2), jax.random.PRNGKey(2))
    out["jax"][2] = jax.device_get({"params": js.params,
                                    "batch_stats": js.batch_stats})

    state, step = fresh()
    out["port"][0] = snap(state)
    state, _ = step(state, b1)
    out["port"][1] = snap(state)
    out["mid"] = state
    out["mid_counts"] = (state.mini_step, state.step)
    pdir = str(tmp_path_factory.mktemp("port_recorder"))
    checkpoint.save_recorder(pdir, 4, state, sched.state_dict())
    out["pdir"] = pdir
    state, _ = step(state, b2)
    out["port"][2] = snap(state)

    resumed, rstep = fresh()
    resumed, out["sched"], out["epoch"] = checkpoint.restore_recorder(
        pdir, resumed)
    resumed, _ = rstep(resumed, b2)
    out["resumed"] = snap(resumed)

    bridged, bstep = fresh()
    tree = bridge.from_flax_recorder(bridged, **out["flax_recorder"])
    bridged, out["bridged_sched"], out["bridged_epoch"] = (
        checkpoint.load_recorder_tree(tree, bridged))
    out["bridged_mini_step"] = bridged.mini_step
    bridged, _ = bstep(bridged, b2)
    out["bridged"] = snap(bridged)
    out["bridged_step"] = bridged.step
    out["sched_dict"] = sched.state_dict()
    return out


def _close_to_jax(got, want, steps=1):
    """The post-step rule of the trajectories, for one update."""
    want, got = _flat(want), _flat(got)
    assert got.keys() == want.keys()
    for path, w in want.items():
        if path.startswith("batch_stats/"):
            np.testing.assert_allclose(got[path], w, rtol=2e-5, atol=1e-6,
                                       err_msg=path)
            continue
        diff = np.abs(got[path] - w)
        assert diff.max() <= 2.1 * LR * steps, (path, diff.max())


def test_a_train_step_updates_every_k_micro_steps(accum):
    """tests/test_grad_accum.py:68, against the JAX state: micro-step 1
    leaves the parameters as they were and moves the BatchNorm statistics;
    micro-step 2 updates; both packages agree after each."""
    p0, p1, p2 = (_flat(accum["port"][i]) for i in range(3))
    for path in p0:
        if path.startswith("params/"):
            np.testing.assert_array_equal(p1[path], p0[path], err_msg=path)
    stem = "batch_stats/trans/trunk/stem_bn/var"
    assert not np.array_equal(p1[stem], p0[stem])
    assert not np.array_equal(p2[stem], p1[stem])
    assert not np.array_equal(p2["params/fc1/kernel"], p1["params/fc1/kernel"])
    _close_to_jax(accum["port"][1], accum["jax"][1], steps=0)
    _close_to_jax(accum["port"][2], accum["jax"][2])
    assert accum["mid_counts"] == (1, 1)


def test_recorder_round_trip_mid_accumulation(accum):
    """tests/test_grad_accum.py:110: a run stopped between micro-steps and
    resumed from its recorder lands on the parameters of the run that never
    stopped, and on the JAX run's."""
    want, got = _flat(accum["port"][2]), _flat(accum["resumed"])
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-6, atol=1e-7,
                                   err_msg=path)
    assert not np.array_equal(got["params/fc1/kernel"],
                              _flat(accum["port"][1])["params/fc1/kernel"])
    assert accum["epoch"] == 4 and accum["sched"] == accum["sched_dict"]
    _close_to_jax(accum["resumed"], accum["jax"][2])


def test_a_jax_recorder_carried_across_lands_on_the_jax_step(accum):
    """The JAX package's save_recorder / restore_recorder, taken
    mid-accumulation, through bridge.from_flax_recorder: the port's next
    micro-step lands on the JAX step's parameters."""
    rec = accum["flax_recorder"]
    assert rec["mini_step"] == 1 and rec["count"] == 0 and rec["step"] == 1
    assert accum["bridged_mini_step"] == 1 and accum["bridged_step"] == 2
    assert accum["bridged_epoch"] == 4
    assert accum["bridged_sched"] == accum["sched_dict"]
    _close_to_jax(accum["bridged"], accum["jax"][2])


def test_bridged_recorder_after_an_update_carries_adams_moments(accum):
    """A recorder one real update in: the moments take their parameter's
    transform and Adam's count becomes torch's step."""
    state = accum["mid"]
    model = state.model
    names = dict(model.named_parameters())
    rng = np.random.default_rng(0)
    flax = bridge.to_flax(model.state_dict(), model)
    mu = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                      flax["params"])
    nu = jax.tree.map(lambda a: np.abs(a), mu)
    tree = bridge.from_flax_recorder(
        state, params=flax["params"], batch_stats=flax["batch_stats"],
        mu=mu, nu=nu, count=3, step=7, epoch=1, scheduler={}, lr=2e-5)
    opt = tree["optimizer"]
    assert opt["param_groups"][0]["lr"] == 2e-5
    idx = list(names).index("fc1.weight")
    np.testing.assert_array_equal(opt["state"][idx]["exp_avg"].numpy(),
                                  mu["fc1"]["kernel"].T)
    assert float(opt["state"][idx]["step"]) == 3.0
    assert tree["acc_grads"] is None and tree["step"] == 7


# ------------------------------------------------------- checkpoints ----

def test_weights_round_trip_and_transfer_as_the_jax_filter_does(tmp_path):
    """An MLM model's weights saved, loaded and filtered into a VQA model
    keep the leaves that the JAX filtered_restore keeps (named through the
    bridge): all but classifier_2, whose width is the answer vocabulary. The
    position table keeps BERT's 512 rows in both, so it transfers."""
    cfg, jcfg = _tiny()
    mcfg, mjcfg = configs("mlm", hidden_size=32, n_layers=1, image_size=64,
                          max_position_embeddings=16,
                          vocab_size=cfg.vocab_size)
    vqa_vars, mlm_vars = _variables(jcfg), _variables(mjcfg, 1)
    merged, n_ok, n_all = jax_checkpoint.filtered_restore(vqa_vars, mlm_vars)
    jm, mv = _flat(merged), _flat(mlm_vars)
    jax_kept = {p for p, v in jm.items()
                if p in mv and np.array_equal(v, mv[p])}
    assert len(jax_kept) == n_ok

    mlm = MMBert(mcfg, device="cpu")
    mlm.load_state_dict(bridge.to_state_dict(mlm_vars, mlm), strict=True)
    checkpoint.save_weights(str(tmp_path / "roco" / "best"),
                            create_train_state(mlm, LR))
    loaded = checkpoint.load_weights(str(tmp_path / "roco" / "best"))
    for k, v in mlm.state_dict().items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)
    vqa = MMBert(cfg, device="cpu")
    vqa.load_state_dict(bridge.to_state_dict(vqa_vars, vqa), strict=True)
    target = vqa.state_dict()
    got, p_ok, p_all = checkpoint.filtered_restore(target, loaded)
    assert (p_ok, p_all) == (n_ok, n_all) == (len(target) - 2, len(target))
    paths = {e.key: "/".join(e.path) for e in bridge.mapping(vqa)}
    port_kept = {paths[k] for k, v in got.items()
                 if k in loaded and torch.equal(v, loaded[k])
                 and v is not target[k]}
    assert port_kept == jax_kept
    assert {paths[k] for k in target} - port_kept == {
        "params/classifier_2/kernel", "params/classifier_2/bias"}
    vqa.load_state_dict(got, strict=True)
    torch.testing.assert_close(vqa.bert_embedding.position_embeddings,
                               mlm.bert_embedding.position_embeddings)


def test_check_compatible_reports_mismatches():
    """tests/test_misc.py:340's expectations, on the port's own layout."""
    model = {"emb": torch.zeros(106, 8), "w": torch.zeros(4)}
    checkpoint.check_compatible(model, {"emb": torch.zeros(106, 8),
                                        "w": torch.zeros(4)})
    bad = {"emb": torch.zeros(98, 8), "extra": torch.zeros(1)}
    with pytest.raises(ValueError) as ei:
        checkpoint.check_compatible(model, bad, what="/tmp/ckpt")
    msg = str(ei.value)
    assert "incompatible" in msg and "/tmp/ckpt" in msg
    assert "(106, 8)" in msg and "(98, 8)" in msg
    assert "missing from checkpoint" in msg and "extra in checkpoint" in msg


def test_recorder_refuses_another_model_or_accumulation(accum):
    cfg, _ = _tiny(num_classes=NUM_CLASSES + 1)
    other = create_train_state(MMBert(cfg, device="cpu"), LR, grad_accum=2)
    with pytest.raises(ValueError, match="classifier_2"):
        checkpoint.restore_recorder(accum["pdir"], other)
    plain = create_train_state(accum["mid"].model, LR)
    with pytest.raises(ValueError, match="grad_accum"):
        checkpoint.restore_recorder(accum["pdir"], plain)
    assert os.path.exists(os.path.join(accum["pdir"], checkpoint.RECORDER))
