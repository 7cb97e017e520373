"""The auxiliary image models in the port against the JAX package on the CPU:
``ImageOnlyClassifier`` (the image-only baseline, with and without its
keyword pathway) and ``SupConEncoder`` (the standalone contrastive encoder,
``linear`` and ``mlp`` heads), each on both trunks: ResNet one block a
stage at full widths and the tiny EfficientNetV2. Forwards in eval and in
train mode (the BatchNorm statistics they fold in), the bridge both ways,
the refusals, and three steps of ``make_img_only_steps`` against the JAX
steps. Tolerances: tests/test_torch_model.py's 1e-4 for outputs, the
unit norm of the SupCon feature at tests/test_aux_paths.py's 1e-5, and the
trajectories' bounds of tests/test_torch_finetune.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmvqa_tpu.core.config import vqa_config as jax_vqa_config
from mmvqa_tpu.data.images import AugmentSpec as JaxAugmentSpec
from mmvqa_tpu.data.images import process_batch as jax_process_batch
from mmvqa_tpu.models.img_only import ImageOnlyClassifier as JaxImageOnly
from mmvqa_tpu.models.supcon_encoder import SupConEncoder as JaxSupCon
from mmvqa_tpu.train import steps as jax_steps
from mmvqa_tpu.train.state import TrainState as JaxTrainState

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.core.config import vqa_config
from mmvqa_tpu_torch.data.images import AugmentSpec, process_batch
from mmvqa_tpu_torch.models import ImageOnlyClassifier, SupConEncoder
from mmvqa_tpu_torch.train.state import create_train_state
from mmvqa_tpu_torch.train.steps import make_img_only_steps

from test_torch_finetune import NOOP, _flat

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

B, S = 4, 32
TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_model.py's
TRUNKS = ["resnet152", "tf_efficientnetv2_m"]
NUM_CLASSES, NUM_KEYWORDS = 6, 5
LR = 1e-4
N_STEPS = 3


def _fill(shapes, seed=0):
    """tests/test_torch_bridge.py's fill: statistics and norms away from 0
    and 1, kernels fan-in scaled, tables N(0, 0.02) (here N(0, 1): the
    keyword embedding meets features of unit scale)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "mean":
            a = rng.normal(size=shape) * 0.1
        elif name == "scale":
            a = 1.0 + rng.normal(size=shape) * 0.1
        elif name == "bias":
            a = rng.normal(size=shape) * 0.1
        elif name == "kernel":
            a = rng.normal(size=shape) * np.prod(shape[:-1]) ** -0.5
        else:
            a = rng.normal(size=shape)
        return a.astype(np.float32)

    return jax.device_get(jax.tree_util.tree_map_with_path(fill, shapes))


def _image(rng, n=B):
    return rng.normal(size=(n, S, S, 3)).astype(np.float32)


def _img_only(trunk, keywords):
    """The JAX model, its filled variables and the port's model carrying
    them."""
    nk = NUM_KEYWORDS if keywords else 0
    jmodel = JaxImageOnly(num_classes=NUM_CLASSES, cnn_encoder=trunk,
                          num_keywords=nk, tiny=True)
    kw = jnp.zeros((1,), jnp.int32) if keywords else None
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, S, S, 3)), kw)
    variables = _fill(shapes)
    model = ImageOnlyClassifier(NUM_CLASSES, trunk, nk, tiny=True,
                                device="cpu")
    model.load_state_dict(bridge.to_state_dict(variables, model), strict=True)
    return jmodel, variables, model


def _supcon(trunk, head):
    jmodel = JaxSupCon(cnn_encoder=trunk, head=head, feat_dim=16, tiny=True)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, S, S, 3)))
    variables = _fill(shapes)
    model = SupConEncoder(trunk, head, feat_dim=16, tiny=True, device="cpu")
    model.load_state_dict(bridge.to_state_dict(variables, model), strict=True)
    return jmodel, variables, model


def _round_trip(variables, model):
    back = bridge._flatten(bridge.to_flax(model.state_dict(), model))
    want = bridge._flatten(variables)
    assert back.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_array_equal(back[path], np.asarray(w),
                                      err_msg="/".join(path))


# ------------------------------------------------- image-only model ----

@pytest.mark.parametrize("keywords", [True, False], ids=["keywords", "plain"])
@pytest.mark.parametrize("trunk", TRUNKS)
def test_image_only_eval_forward_matches_jax(trunk, keywords):
    jmodel, variables, model = _img_only(trunk, keywords)
    rng = np.random.default_rng(3)
    img = _image(rng)
    kw = (rng.integers(0, NUM_KEYWORDS, B).astype(np.int32) if keywords
          else None)
    want = jax.jit(lambda v, x, k: jmodel.apply(v, x, k))(variables, img, kw)
    with torch.no_grad():
        got = model(torch.from_numpy(img),
                    None if kw is None else torch.from_numpy(kw))
    assert got.shape == (B, NUM_CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _round_trip(variables, model)
    assert ("keyword_embed" in dict(model.named_children())) == keywords


@pytest.mark.parametrize("trunk", TRUNKS)
def test_image_only_train_forward_and_statistics_match_jax(trunk):
    """Train mode: batch statistics in the forward, folded into the
    running ones as the JAX package's ``mutable=["batch_stats"]``."""
    jmodel, variables, model = _img_only(trunk, True)
    rng = np.random.default_rng(4)
    img, kw = _image(rng), rng.integers(0, NUM_KEYWORDS, B).astype(np.int32)
    want, mut = jax.jit(lambda v, x, k: jmodel.apply(
        v, x, k, train=True, mutable=["batch_stats"]))(variables, img, kw)
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    stats = _flat(bridge.to_flax(model.state_dict(), model)["batch_stats"])
    for path, w in _flat(jax.device_get(mut["batch_stats"])).items():
        np.testing.assert_allclose(stats[path], w, rtol=2e-5, atol=1e-6,
                                   err_msg=path)


def test_image_only_refuses_a_missing_keyword():
    for trunk in TRUNKS:
        _, _, model = _img_only(trunk, True)
        with pytest.raises(ValueError, match="keyword ids required"):
            model(torch.zeros(1, S, S, 3))


def test_image_only_runs_no_token_head():
    """The image-only model holds no TokenHead: K1 has no site in it."""
    from mmvqa_tpu_torch.models.visual_tokens import TokenHead

    _, _, model = _img_only("resnet152", False)
    assert not any(isinstance(m, TokenHead) for m in model.modules())


# --------------------------------------------------------- the steps ----

def _batch(rng, keywords=True):
    b = {"image": rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8),
         "answer": rng.integers(0, NUM_CLASSES, B).astype(np.int32),
         "weights": np.array([1.0] * (B - 1) + [0.0], np.float32)}
    if keywords:
        b["keyword"] = rng.integers(0, NUM_KEYWORDS, B).astype(np.int32)
    return b


@pytest.fixture(scope="module", params=TRUNKS)
def steps_run(request):
    """Each package's eval step on the first batch, then N_STEPS image-only
    train steps of both from the same weights on three batches, the
    identity augmentation."""
    trunk = request.param
    jmodel, variables, model = _img_only(trunk, True)
    kw = dict(cnn_encoder=trunk, tiny_cnn=True, image_size=S, num_vis=5,
              num_classes=NUM_CLASSES, lr=LR)
    cfg, jcfg = vqa_config(**kw), jax_vqa_config(**kw)
    rng = np.random.default_rng(9)
    batches = [_batch(rng) for _ in range(N_STEPS)]
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray,
                                                    variables["batch_stats"]),
                           opt_state=tx.init(params), tx=tx)
    jstep, jeval = jax_steps.make_img_only_steps(jmodel, jcfg,
                                                 aug=JaxAugmentSpec(**NOOP))
    state = create_train_state(model, LR)
    step, eval_step = make_img_only_steps(model, cfg, aug=AugmentSpec(**NOOP))
    # each eval step first, at the shared weights
    out = {"jax": [], "port": [], "jax_eval": jax.device_get(jeval(jstate, {
        k: jnp.asarray(v) for k, v in batches[0].items()})),
        "port_eval": {k: v.numpy()
                      for k, v in eval_step(state, batches[0]).items()}}
    key = jax.random.PRNGKey(1)
    for b in batches:
        key, sub = jax.random.split(key)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                           sub)
        state, m = step(state, b)
        out["jax"].append(jax.device_get(jm))
        out["port"].append({k: v.numpy() for k, v in m.items()})
    out["jax_vars"] = _flat(jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    out["port_vars"] = _flat(bridge.to_flax(model.state_dict(), model))
    return out


def test_image_only_steps_match_jax(steps_run):
    """Losses (the first to 1e-5) and predictions of every train step."""
    jl = [float(m["loss"]) for m in steps_run["jax"]]
    pl = [float(m["loss"]) for m in steps_run["port"]]
    np.testing.assert_allclose(pl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(pl, jl, rtol=2e-3, atol=2e-3)
    for a, b in zip(steps_run["port"], steps_run["jax"]):
        np.testing.assert_array_equal(a["preds"], b["preds"])


def test_image_only_parameters_and_statistics_after_the_steps(steps_run):
    """Parameters within a little over 2 lr a step (Adam's first steps are
    lr sign(g)), the statistics within tests/test_torch_finetune.py's
    STATS_DRIFT."""
    from test_torch_finetune import STATS_DRIFT

    want, got = steps_run["jax_vars"], steps_run["port_vars"]
    assert got.keys() == want.keys()
    assert "params/keyword_embed/embedding" in want
    for path, w in want.items():
        diff = np.abs(got[path] - w).max()
        bound = (STATS_DRIFT if path.startswith("batch_stats/")
                 else 2.1 * LR * N_STEPS)
        assert diff <= bound, (path, diff)


def test_image_only_eval_step_matches_jax(steps_run):
    want, got = steps_run["jax_eval"], steps_run["port_eval"]
    assert got.keys() == want.keys() == {"loss", "preds", "logits"}
    np.testing.assert_allclose(got["logits"], want["logits"], **TOL)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_array_equal(got["preds"], want["preds"])


def test_image_only_steps_without_keywords():
    """A model without the pathway takes a batch without ``keyword``: one
    step moves the head, and eval returns finite logits."""
    _, _, model = _img_only("tf_efficientnetv2_m", False)
    cfg = vqa_config(num_classes=NUM_CLASSES, image_size=S)
    step, eval_step = make_img_only_steps(model, cfg, aug=AugmentSpec(**NOOP))
    before = model.head.weight.detach().clone()
    batch = _batch(np.random.default_rng(2), keywords=False)
    step(create_train_state(model, LR), batch)
    assert not torch.equal(before, model.head.weight)
    assert torch.isfinite(eval_step(None, batch)["logits"]).all()


# ------------------------------------------------- SupCon encoder ----

@pytest.mark.parametrize("head", ["linear", "mlp"])
@pytest.mark.parametrize("trunk", TRUNKS)
def test_supcon_encoder_matches_jax(trunk, head):
    """Eval and train mode, unit features, the bridge both ways."""
    jmodel, variables, model = _supcon(trunk, head)
    img = _image(np.random.default_rng(5))
    want = jax.jit(lambda v, x: jmodel.apply(v, x))(variables, img)
    with torch.no_grad():
        got = model(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-5)
    _round_trip(variables, model)
    want_t, mut = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, img)
    model.train()
    with torch.no_grad():
        got_t = model(torch.from_numpy(img))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **TOL)
    stats = _flat(bridge.to_flax(model.state_dict(), model)["batch_stats"])
    for path, w in _flat(jax.device_get(mut["batch_stats"])).items():
        np.testing.assert_allclose(stats[path], w, rtol=2e-5, atol=1e-6,
                                   err_msg=path)
    assert ("proj_hidden" in dict(model.named_children())) == (head == "mlp")


def test_supcon_encoder_refuses_other_heads():
    with pytest.raises(NotImplementedError, match="head not supported"):
        SupConEncoder("resnet152", "conv", tiny=True, device="cpu")
    jmodel = JaxSupCon(head="conv", tiny=True)
    with pytest.raises(NotImplementedError, match="head not supported"):
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, S, S, 3)))


def test_models_take_an_explicit_generator():
    """The same generator seed gives the same weights, another seed other
    weights; process_batch's normalised image goes through both."""
    def weights(cls, seed, *a):
        return cls(*a, tiny=True, device="cpu",
                   generator=torch.Generator().manual_seed(seed)).state_dict()

    for cls, args in ((ImageOnlyClassifier, (3, "resnet152", 2)),
                      (SupConEncoder, ("tf_efficientnetv2_m", "mlp"))):
        a, b, c = (weights(cls, s, *args) for s in (1, 1, 2))
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not all(torch.equal(a[k], c[k]) for k in a)
    img = process_batch(torch.zeros(2, S, S, 3, dtype=torch.uint8))
    ref = jax_process_batch(np.zeros((2, S, S, 3), np.uint8), None, None,
                            False)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), atol=1e-6)
