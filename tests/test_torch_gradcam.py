"""The port's Grad-CAM (``mmvqa_tpu_torch.explain.gradcam`` and the
perturbation tap of ``models/visual_tokens.py`` and ``models/mmbert.py``)
against the JAX package's on the CPU, with the JAX weights carried across by
the bridge: ``features_and_logits`` with a perturbation, the Grad-CAM
activations, gradients and logits, ``cnn_only_activations`` and the heatmap,
for the tiny flagship at ``num_vis`` 5 and 7 and the tiny default model
(ResNet + the pre-norm encoder); which token heads run backward; and the
overlay bit for bit: PIL's BILINEAR upscale of the uint8 heatmap, matplotlib's
``jet`` table and the JAX ``overlay_heatmap``.

Tolerances are the JAX package's own (tests/test_token_head.py): forward
values to 2e-5, gradients to 1e-4 relative with an absolute term of 1e-4 of
their largest entry (sums in another order on each side).
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
import matplotlib.cm as cm

from mmvqa_tpu.explain import gradcam as jax_gradcam
from mmvqa_tpu.models.mmbert import MMBert as JaxMMBert

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.data.images import resize_bilinear
from mmvqa_tpu_torch.explain import gradcam
from mmvqa_tpu_torch.models import MMBert
from mmvqa_tpu_torch.ops import token_head

from test_torch_bridge import configs, jax_variables

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

FWD = dict(rtol=2e-5, atol=2e-5)
S = 64  # a 2x2 deepest map in both tiny trunks
ANSWER = 3
DEFAULT = dict(cnn_encoder="resnet152", transformer_model="transformer",
               hidden_size=48)
CASES = {
    # name: (bridge case, config overrides)
    "flagship5": ("vqa5", {}),
    "flagship7": ("vqa7", {}),
    "default": ("vqa5", DEFAULT),
}


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def built():
    """A case's port model (bridged), JAX model, variables and inputs."""
    cache = {}

    def get(name):
        if name not in cache:
            case, over = CASES[name]
            cfg, jcfg = configs(case, image_size=S, **over)
            variables = jax_variables(jcfg)
            model = MMBert(cfg, device="cpu")
            model.load_state_dict(bridge.to_state_dict(variables, model),
                                  strict=True)
            rng = np.random.default_rng(0)
            T = cfg.max_position_embeddings
            img = rng.normal(size=(1, S, S, 3)).astype(np.float32)
            ids = rng.integers(1, cfg.vocab_size, (1, T)).astype(np.int32)
            seg = (np.arange(T) >= 7).astype(np.int32)[None]
            mask = (np.arange(T) < T - 2).astype(np.float32)[None]
            cache[name] = (model, JaxMMBert(jcfg), variables,
                           (img, ids, seg, mask))
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_features_and_logits_with_a_perturbation_match_jax(built, name):
    """The perturbation lands on the deepest map (ResNet's first feature,
    EfficientNetV2's last) before its token head; every tapped map comes
    back NHWC in the JAX order."""
    model, jmodel, variables, args = built(name)
    deepest = 0 if name == "default" else -1
    with torch.no_grad():
        lg0, feats0 = model.features_and_logits(*map(torch.from_numpy, args))
    shape = tuple(feats0[deepest].shape)
    eps = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want_lg, want_ft = jax.jit(lambda v, e, *a: jmodel.apply(
        v, *a, method=type(jmodel).features_and_logits, perturb=e))(
        variables, jnp.asarray(eps), *map(jnp.asarray, args))
    with torch.no_grad():
        lg, feats = model.features_and_logits(*map(torch.from_numpy, args),
                                              perturb=torch.from_numpy(eps))
    np.testing.assert_allclose(lg.numpy(), np.asarray(want_lg), **FWD)
    assert len(feats) == len(want_ft) == model.cfg.num_vis
    for got, want in zip(feats, want_ft):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(feats[deepest].numpy(),
                               feats0[deepest].numpy() + eps, **FWD)
    # the plain forward is the features path without a perturbation
    with torch.no_grad():
        plain = model(*map(torch.from_numpy, args))
        tokens = model.trans(torch.from_numpy(args[0]))
        tokens_f, _ = model.trans.features(torch.from_numpy(args[0]))
    assert torch.equal(plain, lg0)
    for a, b in zip(tokens, tokens_f):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_grad_cam_activations_and_heatmap_match_jax(built, name):
    model, jmodel, variables, args = built(name)
    targs = list(map(torch.from_numpy, args))
    want_a, want_g, want_lg = jax_gradcam.grad_cam_activations(
        jmodel, variables, *map(jnp.asarray, args), ANSWER)
    acts, grads, logits = gradcam.grad_cam_activations(model, *targs, ANSWER)
    assert acts.shape == grads.shape == want_a.shape
    np.testing.assert_allclose(acts.numpy(), np.asarray(want_a), **FWD)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_lg), **FWD)
    _grad_close(grads.numpy(), want_g)
    assert np.abs(np.asarray(want_g)).max() > 0
    heat, lg = gradcam.grad_cam_heatmap(model, *targs, ANSWER)
    want_heat, _ = jax_gradcam.grad_cam_heatmap(
        jmodel, variables, *map(jnp.asarray, args), ANSWER)
    assert heat.shape == acts.shape[1:3]
    np.testing.assert_allclose(heat, want_heat, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(lg, logits.numpy())


@pytest.mark.parametrize("name", ["flagship5", "default"])
def test_cnn_only_activations_match_jax(built, name):
    model, jmodel, variables, args = built(name)
    want = jax_gradcam.cnn_only_activations(jmodel, variables,
                                            jnp.asarray(args[0]))
    got = gradcam.cnn_only_activations(model, torch.from_numpy(args[0]))
    assert got[3] == want[3]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **FWD)
    _grad_close(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **FWD)


def test_only_the_deepest_head_runs_backward(built, monkeypatch):
    """The parameters are frozen for the call and the trunk runs without a
    graph: one token head backward (the deepest tap's), no gradient left on
    any parameter, and every parameter asks for gradients again after."""
    model, _, _, args = built("flagship5")
    calls = []
    original = token_head.token_head_backward

    def counted(x, *a, **k):
        calls.append(tuple(x.shape))
        return original(x, *a, **k)

    monkeypatch.setattr(token_head, "token_head_backward", counted)
    before = [p.requires_grad for p in model.parameters()]
    acts, _, _ = gradcam.grad_cam_activations(
        model, *map(torch.from_numpy, args), ANSWER)
    assert calls == [(1, acts.shape[1] * acts.shape[2], acts.shape[3])]
    assert [p.requires_grad for p in model.parameters()] == before
    assert all(p.grad is None for p in model.parameters())


# ------------------------------------------------------------ the overlay --

@pytest.mark.parametrize("src,dst", [((7, 7), (224, 224)),
                                     ((14, 14), (224, 224)),
                                     ((3, 5), (60, 100)),
                                     ((7, 7), (224, 161)),
                                     ((5, 2), (37, 53))],
                         ids=["7-224", "14-224", "3x5-60x100", "7-224x161",
                              "5x2-37x53"])
def test_heatmap_upscale_equals_pil(rng, src, dst):
    """``resize_bilinear`` on an (h, w, 1) array is PIL's BILINEAR resize
    of the ``L`` image."""
    hm = rng.integers(0, 256, src, dtype=np.uint8)
    want = np.asarray(Image.fromarray(hm).resize((dst[1], dst[0]),
                                                 Image.BILINEAR))
    got = resize_bilinear(hm[..., None], dst[1], dst[0])[..., 0]
    np.testing.assert_array_equal(got, want)


def test_jet_table_equals_matplotlib():
    np.testing.assert_array_equal(gradcam.jet_lut(),
                                  cm.jet(np.arange(256))[:, :3])
    levels = np.arange(256, dtype=np.uint8).astype(np.float32) / 255.0
    extra = np.array([0.0, 1.0, 0.5, 1 / 256, 255 / 256, 0.99999994],
                     np.float32)
    for x in (levels, extra, levels.reshape(16, 16)):
        np.testing.assert_array_equal(gradcam.jet(x), cm.jet(x)[..., :3])


@pytest.mark.parametrize("shape,heat", [((224, 224), (7, 7)),
                                        ((60, 100), (3, 5)),
                                        ((64, 64), (2, 2))])
def test_overlay_heatmap_equals_jax(rng, shape, heat):
    image = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    hm = rng.uniform(size=heat).astype(np.float32)
    hm[0, 0], hm[-1, -1] = 1.0, 0.0
    want = jax_gradcam.overlay_heatmap(image, hm)
    got = gradcam.overlay_heatmap(image, hm)
    assert got.dtype == np.uint8 and got.shape == image.shape
    np.testing.assert_array_equal(got, want)
