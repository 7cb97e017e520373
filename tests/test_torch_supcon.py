"""Joint MLM + SupCon/SimCLR pretraining in mmvqa_tpu_torch against the JAX
package, on the CPU in fp32 at tiny sizes: ``supcon_loss`` (SimCLR, a
float mask, labels, ``contrast_mode='one'``) with its gradient, the SupCon
head of ``MMBert`` through the bridge, one ``make_supcon_steps`` step and a
10-step trajectory from bridged weights with and without the similarity
mask (dropout off, both views augmented with the JAX step's own draws), and
``supcon_epoch``'s aggregation against the JAX loop's. The same numpy
inputs go through both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvqa_tpu.core.mesh import make_mesh
from mmvqa_tpu.data import images as jax_images
from mmvqa_tpu.models.mmbert import MMBert as JaxMMBert
from mmvqa_tpu.ops import supcon as jax_supcon
from mmvqa_tpu.similarity import SimilarityCalculator as JaxCalculator
from mmvqa_tpu.train import steps as jax_steps
from mmvqa_tpu.train import trainer as jax_trainer
from mmvqa_tpu.train.state import TrainState as JaxTrainState

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.data import images
from mmvqa_tpu_torch.models import MMBert
from mmvqa_tpu_torch.ops.supcon import split_two_views, supcon_loss
from mmvqa_tpu_torch.similarity import SimilarityCalculator, build_mask
from mmvqa_tpu_torch.train.state import create_train_state
from mmvqa_tpu_torch.train.steps import make_supcon_steps
from mmvqa_tpu_torch.train.trainer import supcon_epoch

from test_torch_bridge import configs, jax_variables
from test_torch_finetune import _flat, _recording_tx
from test_torch_images import _jax_draws

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

LR = 1e-4
N_STEPS = 10
B, T, S = 4, 12, 64


# ------------------------------------------------------------ the loss ----

def _features(rng, bsz=6, views=2, d=16):
    f = rng.normal(size=(bsz, views, d)).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


def _mask(rng, bsz=6):
    m = rng.random((bsz, bsz)).astype(np.float32)
    np.fill_diagonal(m, 1.0)
    return m


CASES = {
    "simclr": lambda rng: {},
    "float_mask": lambda rng: {"mask": _mask(rng)},
    "labels": lambda rng: {"labels": rng.integers(0, 3, 6).astype(np.int32)},
    "one": lambda rng: {"contrast_mode": "one", "mask": _mask(rng)},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_supcon_loss_and_its_gradient_match_jax(rng, case):
    feats = _features(rng)
    kw = CASES[case](rng)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    pkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want, want_g = jax.value_and_grad(
        lambda f: jax_supcon.supcon_loss(f, **jkw))(jnp.asarray(feats))
    x = torch.from_numpy(feats.copy()).requires_grad_(True)
    got = supcon_loss(x, **pkw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(want_g)).max())
    assert np.abs(np.asarray(want_g)).max() > 0


def test_supcon_loss_takes_bf16_features_and_refuses_what_jax_refuses(rng):
    """bf16 features (the model's compute dtype) give the loss of their
    fp32 values: the loss casts first. Over a mesh axis of one rank the
    gathered loss is the local one (tests/test_torch_layouts.py gathers
    over two)."""
    feats = torch.from_numpy(_features(rng)).bfloat16()
    got = supcon_loss(feats)
    assert got.dtype == torch.float32
    assert float(got) == float(supcon_loss(feats.float()))
    with pytest.raises(ValueError, match="both labels and mask"):
        supcon_loss(feats, labels=torch.zeros(6), mask=torch.eye(6))
    with pytest.raises(ValueError, match=r"\[bsz, n_views"):
        supcon_loss(feats[:, 0])
    assert float(supcon_loss(feats, axis_name="data")) == float(got)
    mask = torch.eye(6)
    mask[0, 1] = mask[1, 0] = 0.5
    assert float(supcon_loss(feats, mask=mask, axis_name="data")) == float(
        supcon_loss(feats, mask=mask))


def test_split_two_views_matches_jax(rng):
    f = rng.normal(size=(8, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        split_two_views(torch.from_numpy(f)).numpy(),
        np.asarray(jax_supcon.split_two_views(jnp.asarray(f))))


# -------------------------------------------------------- the SupCon head ----

def _tiny(**over):
    kw = dict(supcon=True, hidden_size=32, n_layers=1, image_size=S,
              vocab_size=300, max_position_embeddings=T, lr=LR,
              dropout_override=0.0)
    kw.update(over)
    return configs("mlm", **kw)


def _supcon_batch(cfg, rng, pad=1):
    lengths = rng.integers(cfg.num_vis + 3, T + 1, size=B)
    lengths[0] = T
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)

    def tokens():
        return (rng.integers(1, cfg.vocab_size, (B, T)) * mask).astype(np.int32)

    def labels():
        keep = (rng.random((B, T)) < 0.3) & (mask > 0)
        keep[:, 0] = True
        return (rng.integers(1, cfg.vocab_size, (B, T)) * keep).astype(np.int32)

    return {
        "image": rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8),
        "tokens": tokens(), "aug_tokens": tokens(),
        "segment_ids": rng.integers(0, 2, (B, T)).astype(np.int32),
        "input_mask": mask, "labels": labels(), "aug_labels": labels(),
        "weights": np.array([1.0] * (B - pad) + [0.0] * pad, np.float32),
    }


def test_supcon_head_through_the_bridge_matches_flax(rng):
    """Logits and the L2-normalised feature of the same bridged weights;
    the tree comes back whole through ``to_flax``."""
    cfg, jcfg = configs("mlm", supcon=True, max_position_embeddings=T,
                        hidden_size=32, n_layers=1)
    variables = jax_variables(jcfg, seed=4)
    assert {"head_0", "head_2"} <= set(variables["params"])
    model = MMBert(cfg, device="cpu")
    model.load_state_dict(bridge.to_state_dict(variables, model), strict=True)
    b = _supcon_batch(cfg, rng)
    img = images.process_batch(torch.from_numpy(b["image"][:, :32, :32]))
    want_logits, want_feat = jax.jit(JaxMMBert(jcfg).apply)(
        variables, jnp.asarray(img.numpy()), b["tokens"], b["segment_ids"],
        b["input_mask"])
    with torch.no_grad():
        logits, feat = model(img, torch.from_numpy(b["tokens"]),
                             torch.from_numpy(b["segment_ids"]),
                             torch.from_numpy(b["input_mask"]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat), rtol=1e-4,
                               atol=1e-4)
    assert feat.shape == (B, cfg.feat_dim)
    np.testing.assert_allclose(np.linalg.norm(feat.numpy(), axis=-1), 1.0,
                               rtol=1e-5)
    back = _flat(bridge.to_flax(model.state_dict(), model))
    want = _flat(variables)
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_a_vqa_model_is_unchanged_by_the_flag():
    """The head exists only where the reference calls it: the ROCO MLM
    model. A VQA model built with ``supcon`` has the tree and the output of
    one built without."""
    plain, _ = configs("vqa5")
    flagged, jflagged = configs("vqa5", supcon=True)
    a = MMBert(plain, device="cpu").state_dict()
    b = MMBert(flagged, device="cpu").state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert "head_0" not in jax_variables(jflagged)["params"]


# ------------------------------------------------------ the trajectories ----

@pytest.fixture(scope="module", params=["simclr", "jaccard"])
def run(request):
    """N_STEPS SupCon train steps of both packages from the same bridged
    weights on three batches in turn (padded queries, a padding sample),
    dropout off, both views augmented by PRETRAIN_AUG with the JAX step's
    draws (its key split into a1, a2 and the dropout key); the mask of
    Jaccard similarities of random captions or none. Keeps each package's
    losses, the step-0 gradients and the variables after the last step."""
    cfg, jcfg = _tiny()
    rng = np.random.default_rng(17)
    batches = [_supcon_batch(cfg, rng) for _ in range(3)]
    sim = None
    if request.param == "jaccard":
        words = "chest ct mass lung brain axial left right".split()
        caps = [" ".join(rng.choice(words, 5)) for _ in range(B)]
        augs = [" ".join(rng.choice(words, 5)) for _ in range(B)]
        sim = SimilarityCalculator("jaccard")(caps, augs)
        assert 0 < sim[0, 1] < 1 or 0 < sim[1, 0] < 1
    variables = jax_variables(jcfg)

    jmodel = JaxMMBert(jcfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = _recording_tx(LR)
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                           batch_stats=jax.tree.map(
                               jnp.asarray, variables["batch_stats"]),
                           opt_state=jax.jit(tx.init)(params), tx=tx)
    jspec = jax_images.PRETRAIN_AUG
    jstep, _ = jax_steps.make_supcon_steps(jmodel, jcfg, aug=jspec)
    model = MMBert(cfg, device="cpu")
    model.load_state_dict(bridge.to_state_dict(variables, model), strict=True)
    state = create_train_state(model, LR)
    step, _ = make_supcon_steps(model, cfg, aug=images.PRETRAIN_AUG)

    out = {"jax": {"loss": [], "parts": []}, "port": {"loss": [], "parts": []},
           "cfg": cfg}
    original = state.apply_gradients

    def keep_grads():  # the port's step-0 gradients, before the update
        out["port"]["grads"] = bridge.grads_to_flax(model)
        original()

    key = jax.random.PRNGKey(5)
    for i in range(N_STEPS):
        b = batches[i % 3]
        key, sub = jax.random.split(key)
        a1, a2, _ = jax.random.split(sub, 3)
        draws = (_jax_draws(a1, B, S, jspec), _jax_draws(a2, B, S, jspec))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                           sub, None if sim is None else jnp.asarray(sim))
        state.apply_gradients = keep_grads if i == 0 else original
        state, m = step(state, b, draws, sim_mask=sim)
        for who, mm in (("jax", jm), ("port", m)):
            out[who]["loss"].append(float(mm["loss"]))
            out[who]["parts"].append((float(mm["mlm_loss"]),
                                      float(mm["supcon_loss"]),
                                      int(mm["correct"]), int(mm["total"])))
        if i == 0:
            out["jax"]["grads"] = jax.device_get(
                jstate.opt_state.inner_state[0]["g"])
    del state.apply_gradients
    out["jax"]["vars"] = jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats})
    out["port"]["vars"] = bridge.to_flax(model.state_dict(), model)
    return out


def test_step_0_loss_and_its_parts_match_the_jax_step(run):
    (jm, jc, jcor, jtot), (pm, pc, pcor, ptot) = (
        run["jax"]["parts"][0], run["port"]["parts"][0])
    np.testing.assert_allclose(run["port"]["loss"][0], run["jax"]["loss"][0],
                               rtol=1e-5)
    np.testing.assert_allclose([pm, pc], [jm, jc], rtol=1e-5)
    assert (pcor, ptot) == (jcor, jtot) and ptot > 0
    assert pc > 0.1  # the contrastive term is there


def test_loss_trajectory_matches_the_jax_train_step(run):
    jl = np.asarray(run["jax"]["loss"])
    pl = np.asarray(run["port"]["loss"])
    assert pl[-1] < pl[0]  # training moves
    np.testing.assert_allclose(pl, jl, rtol=2e-3, atol=2e-3,
                               err_msg=f"\njax  {jl}\nport {pl}")
    for (jm, jc, *_), (pm, pc, *_) in zip(run["jax"]["parts"],
                                          run["port"]["parts"]):
        np.testing.assert_allclose([pm, pc], [jm, jc], rtol=2e-3, atol=2e-3)


def test_step_0_gradients_match_jax_leaf_by_leaf(run):
    """tests/test_torch_train.py's tolerance: within 1e-4 of the leaf's
    largest entry; the SupCon head's leaves among them."""
    want = _flat(run["jax"]["grads"])
    got = _flat(run["port"]["grads"])
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max() + 1e-7,
                                   err_msg=path)
    for leaf in ("head_0/kernel", "head_2/kernel", "trans/token_conv_0/kernel"):
        assert np.abs(want[leaf]).max() > 0, leaf


def test_parameters_after_the_last_step_stay_near_jax(run):
    """Every parameter entry within a little over 2 lr a step taken (Adam's
    first step is lr sign(g), tests/test_torch_train.py's rule)."""
    want = _flat(run["jax"]["vars"])
    got = _flat(run["port"]["vars"])
    assert got.keys() == want.keys()
    for path, w in want.items():
        if path.startswith("params/"):
            diff = np.abs(got[path] - w).max()
            assert diff <= 2.1 * LR * N_STEPS, (path, diff)


# ------------------------------------------------------ the epoch loop ----

def test_supcon_epoch_aggregates_as_the_jax_loop(rng):
    """A step that returns fixed metrics, through both loops: the means,
    the accuracy over all masked tokens, the captions taken out of the
    batch and handed to the mask function, the items counted twice."""
    metrics = [dict(loss=2.0 + i, mlm_loss=1.5 + i, supcon_loss=0.5,
                    correct=3 * i, total=10 + i) for i in range(3)]
    batches = []
    for i in range(3):
        w = np.array([1.0, 1.0, 1.0 if i < 2 else 0.0], np.float32)
        batches.append({"tokens": np.zeros((3, 4), np.int32), "weights": w,
                        "caption": [f"a b {i}", "c d", "e f"],
                        "aug_caption": ["a b", f"c {i}", "e"]})
    calc = SimilarityCalculator("jaccard")

    def run_loop(loop, wrap, **kw):
        seen, masks = [], []

        def step(state, batch, *args, sim_mask=None):
            if len(args) == 2:  # the JAX loop's (rng, sim_mask)
                sim_mask = args[1]
            seen.append(sorted(batch))
            masks.append(sim_mask)
            return state, wrap(metrics[len(seen) - 1])

        def mask_fn(c, a):
            return calc(c, a)

        _, m = loop(step, None, batches, sim_mask_fn=mask_fn, **kw)
        return m, seen, masks

    got, seen, masks = run_loop(supcon_epoch,
                                lambda d: {k: torch.tensor(v)
                                           for k, v in d.items()})
    mesh = make_mesh(dp_size=1, devices=jax.devices()[:1])
    want, jseen, jmasks = run_loop(
        lambda step, state, loader, **kw: jax_trainer.supcon_epoch(
            step, state, loader, mesh, jax.random.PRNGKey(0), **kw),
        lambda d: {k: np.asarray(v) for k, v in d.items()})
    assert seen == jseen == [["tokens", "weights"]] * 3
    for a, b in zip(masks, jmasks):
        np.testing.assert_array_equal(a, b)
    assert got.keys() == want.keys()
    for k in ("loss", "mlm_loss", "supcon_loss", "acc"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert got["acc"] == pytest.approx(100.0 * 9 / 33)
    assert got["items_per_sec"] > 0
    _, empty = supcon_epoch(None, None, [])
    assert np.isnan(empty["loss"]) and empty["items_per_sec"] == 0.0


def test_similarity_masks_and_build_mask_match_jax():
    caps = ["chest x ray", "brain mri scan", "left hand", ""]
    augs = ["the chest x ray", "mri scan of brain", "right foot", ""]
    got = SimilarityCalculator("jaccard")(caps, augs)
    want = JaxCalculator("jaccard")(caps, augs)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert build_mask("simclr", caps, augs, SimilarityCalculator("jaccard")) \
        is None
    assert build_mask("supcon", caps, augs, None) is None
    with pytest.raises(ValueError, match="unknown similarity"):
        SimilarityCalculator("edit_distance")
