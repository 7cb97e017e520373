"""The Feedback Transformer encoder (``--transformer_model
feedback-transformer``) in the port against the JAX package on the CPU:
the T5 bucket with exact equality, ``FeedbackEncoder`` against the Flax
module and against tests/test_feedback_parity.py's numpy oracle (the
reference's window loop restated) at T=8 and 7 and, with ``mem_len=8``, at
T=24 and 23 (the FIFO shifts; an odd T leaves a one-token window), its
gradients, and ``MMBert`` with it on the default trunk (ResNet one block a
stage at full widths): the VQA and MLM forwards and the bridge both ways.
The 10-step VQA trajectory runs on the tiny EfficientNetV2 trunk at the
pins of tests/test_torch_finetune.py: on the ResNet trunk at 64 px three
step-0 gradients of the stem's BatchNorm bias miss by 2% where a ReLU input
lies within rounding of 0 and the two packages take opposite sides (the
whole-term difference tests/test_torch_default_train.py describes), which
says nothing of the encoder. Tolerances: the encoder at
tests/test_feedback_parity.py's rtol 2e-4 / atol 2e-5, the whole model at
tests/test_torch_model.py's 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvqa_tpu.data.images import AugmentSpec as JaxAugmentSpec
from mmvqa_tpu.models import FeedbackEncoder as JaxFeedbackEncoder
from mmvqa_tpu.models.feedback import (
    relative_position_bucket as jax_relative_position_bucket,
)
from mmvqa_tpu.models.mmbert import MMBert as JaxMMBert
from mmvqa_tpu.train import steps as jax_steps
from mmvqa_tpu.train.state import TrainState as JaxTrainState

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.data.images import AugmentSpec
from mmvqa_tpu_torch.models import FeedbackEncoder, MMBert
from mmvqa_tpu_torch.models.feedback import relative_position_bucket
from mmvqa_tpu_torch.train.state import create_train_state
from mmvqa_tpu_torch.train.steps import make_vqa_steps

from test_feedback_parity import DHEAD, HEADS, H_DIM, LAYERS, _oracle
from test_torch_bridge import _leaves, jax_variables
from test_torch_default_model import default_configs
from test_torch_finetune import (
    LR,
    N_STEPS,
    NOOP,
    STATS_DRIFT,
    _flat,
    _recording_tx,
    _tiny,
    _vqa_batch,
)

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

ENC_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_feedback_parity.py:131
TOL = dict(rtol=1e-4, atol=1e-4)      # tests/test_torch_model.py's
B, T, S = 3, 12, 32
FEEDBACK = dict(transformer_model="feedback-transformer", image_size=S,
                max_position_embeddings=T, dropout_override=0.0)


@pytest.mark.parametrize("mem_len,n", [(256, 2), (8, 2), (38, 2)])
def test_bucket_equals_jax_at_every_relative_position(mem_len, n):
    """Every key-minus-query position a window can see, -(M + n) to n,
    and the distances at which the log buckets begin and end."""
    rel = np.arange(-(mem_len + n), n + 1, dtype=np.int32)
    want = np.asarray(jax_relative_position_bucket(jnp.asarray(rel)))
    got = relative_position_bucket(torch.from_numpy(rel)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() == min(31, want.max())


def test_bucket_equals_jax_over_a_wide_range():
    rel = np.arange(-5000, 5, dtype=np.int32)
    want = np.asarray(jax_relative_position_bucket(jnp.asarray(rel), 32, 128))
    np.testing.assert_array_equal(
        relative_position_bucket(torch.from_numpy(rel), 32, 128).numpy(),
        want)
    assert set(np.unique(want)) == set(range(32))


def _encoders(T_, mem_len, seed=0):
    """A Flax encoder's params and the port's encoder carrying them."""
    x = np.random.default_rng(seed).normal(size=(2, T_, H_DIM)).astype(
        np.float32)
    enc = JaxFeedbackEncoder(hidden_size=H_DIM, n_layers=LAYERS, heads=HEADS,
                             dim_head=DHEAD, mem_len=mem_len)
    params = jax.device_get(enc.init(jax.random.PRNGKey(seed),
                                     jnp.asarray(x)))
    port = FeedbackEncoder(H_DIM, LAYERS, heads=HEADS, dim_head=DHEAD,
                           mem_len=mem_len)
    port.load_state_dict(bridge.to_state_dict(params, port), strict=True)
    return x, enc, params, port.eval()


CASES = [pytest.param(8, 10**9, id="T8"), pytest.param(7, 10**9, id="T7"),
         pytest.param(24, 8, id="T24-fifo"),
         pytest.param(23, 8, id="T23-fifo")]


@pytest.mark.parametrize("T_,mem_len", CASES)
def test_encoder_matches_jax_and_the_oracle(T_, mem_len):
    x, enc, params, port = _encoders(T_, mem_len)
    got = port(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jax.jit(enc.apply)(params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **ENC_TOL)
    oracle = _oracle(params, x, mem_len=min(mem_len, T_ + T_ % 2))
    np.testing.assert_allclose(got, oracle, **ENC_TOL)


@pytest.mark.parametrize("T_,mem_len", [CASES[1], CASES[3]])
def test_encoder_gradients_match_jax(T_, mem_len):
    """d sum(out * r) / d (x, every parameter), the shared projection's
    summed over layers and windows, within 1e-4 of each leaf's largest."""
    x, enc, params, port = _encoders(T_, mem_len)
    r = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(enc.apply(p, xx) * r)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (port(xt) * torch.from_numpy(r)).sum().backward()
    want = _leaves(jax.device_get(gp["params"]))
    got = _leaves(bridge.grads_to_flax(port))
    assert got.keys() == want.keys()
    assert ("segment", "shared_kv", "kernel") in want
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max() + 1e-7,
                                   err_msg="/".join(path))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-3,
                               atol=1e-4 * np.abs(gx).max())


def test_dropout_draws_in_train_mode_only():
    """0.1 / 0.1 dropout: train mode moves the output and draws the same
    masks from the same seed; eval mode is the deterministic forward."""
    from mmvqa_tpu_torch.models.layers import DropoutRng

    x = torch.randn(2, 9, H_DIM, generator=torch.Generator().manual_seed(0))

    def build():
        torch.manual_seed(0)
        return FeedbackEncoder(H_DIM, LAYERS, heads=HEADS, dim_head=DHEAD,
                               rng=DropoutRng(5))

    a, b = build(), build()
    b.load_state_dict(a.state_dict())
    with torch.no_grad():
        ref = a.eval()(x)
        a.train(), b.train()
        da, db = a(x), b(x)
    assert torch.equal(da, db)
    assert not torch.allclose(da, ref)
    assert torch.isfinite(da).all()


def test_one_token_sequence_masks_every_self_key():
    """T=1: one window of one valid token, no memory yet; every score is
    masked and the softmax is uniform, as in the JAX package."""
    x, enc, params, port = _encoders(1, 256)
    got = port(torch.from_numpy(x)).detach().numpy()
    want = jax.jit(enc.apply)(params, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), **ENC_TOL)


# ------------------------------------------------------- MMBert ----

def _inputs(cfg, rng):
    lengths = rng.integers(cfg.num_vis + 2, T + 1, size=B)
    lengths[0] = T
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    img = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    ids = (rng.integers(1, cfg.vocab_size, (B, T)) * mask).astype(np.int32)
    seg = rng.integers(0, 2, (B, T)).astype(np.int32)
    return img, ids, seg, mask


@pytest.fixture(scope="module")
def models():
    out = {}
    for case in ("vqa5", "mlm"):
        cfg, jcfg = default_configs(case, **FEEDBACK)
        variables = jax_variables(jcfg)
        model = MMBert(cfg, device="cpu")
        model.load_state_dict(bridge.to_state_dict(variables, model),
                              strict=True)
        out[case] = (cfg, jcfg, variables, model)
    return out


@pytest.mark.parametrize("case", ["vqa5", "mlm"])
def test_mmbert_with_the_feedback_encoder_matches_jax(models, case):
    """The CLIs' default trunk with ``--transformer_model
    feedback-transformer``: VQA logits and MLM logits in eval mode."""
    cfg, jcfg, variables, model = models[case]
    img, ids, seg, mask = _inputs(cfg, np.random.default_rng(7))
    want = jax.jit(lambda v, *a: JaxMMBert(jcfg).apply(v, *a))(
        variables, img, ids, seg, mask)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (img, ids, seg, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mmbert_builds_the_reference_wiring(models):
    """8 heads of 64 and a memory of 256 whatever ``cfg.heads`` says, the
    reference's dropout 0.1 unless overridden, and no other encoder."""
    cfg, _, _, model = models["vqa5"]
    enc = model.encoder
    assert isinstance(enc, FeedbackEncoder) and cfg.heads == 12
    assert enc.segment.heads == 8 and enc.segment.dim_head == 64
    assert enc.mem_len == 256 and enc.seq_len == 2
    full = MMBert(cfg.replace(dropout_override=None), device="cpu")
    assert full.encoder.segment.attn_drop_0.p == 0.1
    assert full.encoder.segment.ff_1.drop.p == 0.1


@pytest.mark.parametrize("case", ["vqa5", "mlm"])
def test_bridge_round_trip_with_the_feedback_encoder(models, case):
    """Every leaf of the Flax tree, the scan's broadcast parameters under
    ``encoder/segment``, taken once and given back unchanged."""
    _, _, variables, model = models[case]
    back = bridge._flatten(bridge.to_flax(model.state_dict(), model))
    want = bridge._flatten(variables)
    assert back.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_array_equal(back[path], np.asarray(w),
                                      err_msg="/".join(path))
    assert ("params", "encoder", "segment", "layer_weight") in back


# ---------------------------------------------------- trajectory ----

@pytest.fixture(scope="module")
def run():
    """N_STEPS VQA train steps (CE) of both packages with the feedback
    encoder (two layers, hidden 32) on the tiny EfficientNetV2 trunk at 64
    px, tests/test_torch_finetune.py's setting: three batches in turn (a
    padding sample each), dropout off, the identity augmentation. Keeps the
    losses, the step-0 gradients and the variables after the first and the
    last step."""
    cfg, jcfg = _tiny(transformer_model="feedback-transformer", heads=8,
                      n_layers=2, loss="CrossEntropyLoss")
    rng = np.random.default_rng(43)
    batches = [_vqa_batch(cfg, rng) for _ in range(3)]
    variables = jax_variables(jcfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = _recording_tx(LR)
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                           batch_stats=jax.tree.map(
                               jnp.asarray, variables["batch_stats"]),
                           opt_state=jax.jit(tx.init)(params), tx=tx)
    jstep, _ = jax_steps.make_vqa_steps(JaxMMBert(jcfg), jcfg,
                                        aug=JaxAugmentSpec(**NOOP))
    model = MMBert(cfg, device="cpu")
    model.load_state_dict(bridge.to_state_dict(variables, model), strict=True)
    state = create_train_state(model, LR)
    step, _ = make_vqa_steps(model, cfg, aug=AugmentSpec(**NOOP))
    out = {"jax": {"loss": [], "vars": {}}, "port": {"loss": [], "vars": {}}}
    original = state.apply_gradients

    def keep_grads():
        out["port"]["grads"] = bridge.grads_to_flax(model)
        original()

    key = jax.random.PRNGKey(3)
    for i in range(N_STEPS):
        b = batches[i % 3]
        key, sub = jax.random.split(key)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                           sub)
        state.apply_gradients = keep_grads if i == 0 else original
        state, m = step(state, b)
        out["jax"]["loss"].append(float(jm["loss"]))
        out["port"]["loss"].append(float(m["loss"]))
        if i == 0:
            out["jax"]["grads"] = jax.device_get(
                jstate.opt_state.inner_state[0]["g"])
        if i in (0, N_STEPS - 1):
            out["jax"]["vars"][i] = jax.device_get(
                {"params": jstate.params, "batch_stats": jstate.batch_stats})
            out["port"]["vars"][i] = bridge.to_flax(model.state_dict(), model)
    del state.apply_gradients
    return out


def test_trajectory_losses_match_jax(run):
    jl = np.asarray(run["jax"]["loss"])
    pl = np.asarray(run["port"]["loss"])
    assert pl[-1] < pl[0]
    np.testing.assert_allclose(pl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(pl, jl, rtol=2e-3, atol=2e-3,
                               err_msg=f"\njax  {jl}\nport {pl}")


def test_trajectory_step_0_gradients_match_jax(run):
    want = _flat(run["jax"]["grads"])
    got = _flat(run["port"]["grads"])
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max() + 1e-7,
                                   err_msg=path)
    for leaf in ("encoder/segment/shared_kv/kernel",
                 "encoder/segment/rel_bias/embedding",
                 "encoder/segment/layer_weight",
                 "encoder/segment/ff_1/w_out/kernel",
                 "trans/token_conv_0/kernel",
                 "trans/trunk/stem_conv/kernel"):
        assert np.abs(want[leaf]).max() > 0, leaf


@pytest.mark.parametrize("after", [0, N_STEPS - 1])
def test_trajectory_parameters_and_statistics_match_jax(run, after):
    """tests/test_torch_finetune.py's bounds: parameters within a little
    over 2 lr a step, the statistics tightly after the first step and
    within STATS_DRIFT after the last."""
    want = _flat(run["jax"]["vars"][after])
    got = _flat(run["port"]["vars"][after])
    assert got.keys() == want.keys()
    steps = after + 1
    for path, w in want.items():
        diff = np.abs(got[path] - w)
        if path.startswith("batch_stats/") and after == 0:
            np.testing.assert_allclose(got[path], w, err_msg=path, rtol=2e-5,
                                       atol=1e-6)
        elif path.startswith("batch_stats/"):
            assert diff.max() <= STATS_DRIFT, (path, diff.max())
        else:
            assert diff.max() <= 2.1 * LR * steps, (path, diff.max())
