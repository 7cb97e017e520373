"""The port's CAM zoo (``mmvqa_tpu_torch.explain.cam_zoo``) against the JAX
package's (``mmvqa_tpu.explain.cam_zoo``) on the CPU: the six methods on
seeded numpy activations and gradients, ``_upsample_mask`` (the JAX
package's ``jax.image.resize`` bilinear, here as explicit interpolation
matrices), ScoreCAM and AblationCAM with cheap score and rerun functions,
and the Grad-CAM CLI's AblationCAM rerun from the tap against the JAX CLI's
whole-model rerun on a tiny flagship model carried across by the bridge.

Tolerances: the heatmaps are in [0, 1]; both sides compute in float32 with
sums in another order, so 2e-5 absolute (the JAX package's forward
tolerance, tests/test_token_head.py). EigenCAM is held up to the sign of
its projection, which the JAX function leaves to rounding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvqa_tpu.explain import cam_zoo as jax_zoo
from mmvqa_tpu.models.mmbert import MMBert as JaxMMBert

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.explain import cam_zoo, gradcam
from mmvqa_tpu_torch.models import MMBert

from test_torch_bridge import configs, jax_variables

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

TOL = dict(rtol=0, atol=2e-5)
B, H, W, C = 2, 7, 5, 24


def _acts_grads(seed=0):
    rng = np.random.default_rng(seed)
    acts = np.maximum(rng.normal(size=(B, H, W, C)), 0).astype(np.float32)
    grads = (rng.normal(size=(B, H, W, C)) * 0.1).astype(np.float32)
    return acts, grads


@pytest.mark.parametrize("name", ["gradcam", "gradcam++", "xgradcam"])
def test_gradient_methods_match_jax(name):
    acts, grads = _acts_grads()
    want = jax.jit(jax_zoo.CAM_METHODS[name])(jnp.asarray(acts),
                                             jnp.asarray(grads))
    got = cam_zoo.CAM_METHODS[name](torch.from_numpy(acts),
                                    torch.from_numpy(grads))
    assert got.shape == (B, H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got.max() == pytest.approx(1.0)


def test_gradcam_pp_where_the_denominator_is_zero():
    """Where a gradient is 0 the JAX function divides by 1, not by 0.
    Positive gradients elsewhere keep the denominator ``2 g^2 + sum A g^3``
    away from cancellation, where float32 sums in another order part."""
    acts, grads = _acts_grads(1)
    grads = np.abs(grads)
    grads[0, :3] = 0.0
    want = jax.jit(jax_zoo.grad_cam_pp)(jnp.asarray(acts), jnp.asarray(grads))
    got = cam_zoo.grad_cam_pp(torch.from_numpy(acts), torch.from_numpy(grads))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def eigen_candidates(acts):
    """The three heatmaps EigenCAM can give, (3, B, H, W): the projection on
    the first principal direction (float64) made positive one way or the
    other, normalized, and zeros (a sign of 0)."""
    b, h, w, c = acts.shape
    flat = acts.reshape(b, h * w, c).astype(np.float64)
    flat = flat - flat.mean(axis=1, keepdims=True)
    _, _, vt = np.linalg.svd(flat, full_matrices=False)
    proj = np.einsum("bpc,bc->bp", flat, vt[:, 0]).reshape(b, h, w)
    out = []
    for sign in (1.0, -1.0):
        heat = np.maximum(sign * proj, 0)
        out.append(heat / np.maximum(heat.max(axis=(1, 2), keepdims=True),
                                     1e-12))
    return np.stack(out + [np.zeros_like(proj)])


def assert_one_of(got, candidates, atol):
    """Each sample's heatmap equals one of its candidates."""
    for i in range(got.shape[0]):
        errs = [np.abs(got[i] - cand[i]).max() for cand in candidates]
        assert min(errs) <= atol, (i, errs)


@pytest.mark.parametrize("flip", [False, True], ids=["as-is", "negated"])
def test_eigencam_matches_jax_up_to_the_sign(flip):
    """A rank-one pattern over noise (singular values about 10 to 1 apart),
    so that the principal direction is well determined. The JAX function's
    sign fix, ``sign(sum relu(p) - sum relu(-p))``, reads the sum of the
    projection of centred data, which is 0 up to rounding (here 1e-7
    against a sum of magnitudes of 700): the sign it picks is rounding
    noise on either side, 0 included, which zeroes the heatmap (ROADMAP.md
    Queue 3, F11). Each side's heatmap is held to one of the three
    outcomes, computed in float64."""
    rng = np.random.default_rng(2)
    u = rng.normal(size=(B, H * W, 1))
    v = rng.normal(size=(B, 1, C))
    acts = (6.0 * u * v + 0.1 * rng.normal(size=(B, H * W, C)))
    acts = acts.reshape(B, H, W, C).astype(np.float32)
    if flip:
        acts = -acts
    s = np.linalg.svd(acts.reshape(B, H * W, C)
                      - acts.reshape(B, H * W, C).mean(1, keepdims=True),
                      compute_uv=False)
    assert (s[:, 0] > 5 * s[:, 1]).all()
    cands = eigen_candidates(acts)
    want = np.asarray(jax.jit(jax_zoo.eigen_cam)(jnp.asarray(acts)))
    got = cam_zoo.eigen_cam(torch.from_numpy(acts)).numpy()
    assert_one_of(want, cands, 1e-5)
    assert_one_of(got, cands, 1e-5)


@pytest.mark.parametrize("h,w,size", [(7, 7, 224), (14, 14, 224), (3, 3, 16),
                                      (7, 5, 32), (9, 9, 4)],
                         ids=["7-224", "14-224", "3-16", "7x5-32",
                              "9-4-down"])
def test_upsample_mask_matches_jax_resize(h, w, size):
    """Half-pixel centres, edge weights renormalized, the kernel widened
    only when shrinking: the border rows and columns too."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, h, w)).astype(np.float32)
    want = np.asarray(jax.jit(jax_zoo._upsample_mask, static_argnums=1)(
        jnp.asarray(x), size))
    got = cam_zoo._upsample_mask(torch.from_numpy(x), size).numpy()
    assert got.shape == (3, size, size)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got[:, [0, -1]], want[:, [0, -1]], rtol=0,
                               atol=2e-6)


def test_score_cam_matches_jax():
    """C = 40 channels in chunks of 32 (one partial chunk); a cheap score of
    the masked image."""
    rng = np.random.default_rng(4)
    acts = np.maximum(rng.normal(size=(B, H, H, 40)), 0).astype(np.float32)
    image = rng.normal(size=(B, 16, 16, 3)).astype(np.float32)
    wts = rng.normal(size=(3,)).astype(np.float32)

    def jax_score(m):
        return jnp.tanh(jnp.mean(m * jnp.asarray(wts), axis=(1, 2, 3)))

    def port_score(m):
        return torch.tanh((m * torch.from_numpy(wts)).mean(dim=(1, 2, 3)))

    want = jax.jit(lambda a, im: jax_zoo.score_cam(a, im, jax_score))(
        jnp.asarray(acts), jnp.asarray(image))
    got = cam_zoo.score_cam(torch.from_numpy(acts), torch.from_numpy(image),
                            port_score)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ablation_cam_matches_jax():
    """C = 40 in chunks of 32; the rerun scores each ablated sample."""
    rng = np.random.default_rng(5)
    acts = np.maximum(rng.normal(size=(B, H, W, 40)), 0).astype(np.float32)
    wts = rng.normal(size=(40,)).astype(np.float32)

    def jax_rerun(a):
        return 1.0 + jnp.tanh(jnp.mean(a * jnp.asarray(wts), axis=(1, 2, 3)))

    def port_rerun(a):
        return 1.0 + torch.tanh((a * torch.from_numpy(wts)).mean(
            dim=(1, 2, 3)))

    base = np.array([1.3, 0.7], np.float32)
    want = jax.jit(lambda a, b: jax_zoo.ablation_cam(a, jax_rerun, b))(
        jnp.asarray(acts), jnp.asarray(base))
    got = cam_zoo.ablation_cam(torch.from_numpy(acts), port_rerun,
                               torch.from_numpy(base))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_method_table_names_the_jax_methods():
    assert list(cam_zoo.CAM_METHODS) == list(jax_zoo.CAM_METHODS)


# -------------------------------------------- the CLI's rerun from the tap --

S = 64  # a 2x2 deepest map in the tiny flagship


def test_ablation_rerun_from_the_tap_matches_the_jax_clis_rerun():
    """The JAX CLI's ``rerun_jit``: the whole model with ``perturb =
    ablated - acts``; the port's: the ablated map through the deepest head
    and the encoder, the other tokens kept. Four channels ablated, one
    rerun call (channel-major stacking); logits to the JAX package's
    forward tolerance."""
    cfg, jcfg = configs("vqa5", image_size=S)
    variables = jax_variables(jcfg)
    model = MMBert(cfg, device="cpu")
    model.load_state_dict(bridge.to_state_dict(variables, model), strict=True)
    rng = np.random.default_rng(6)
    T = cfg.max_position_embeddings
    img = rng.normal(size=(1, S, S, 3)).astype(np.float32)
    ids = rng.integers(1, cfg.vocab_size, (1, T)).astype(np.int32)
    seg = np.zeros((1, T), np.int32)
    mask = (np.arange(T) < T - 3).astype(np.float32)[None]
    answer = 3

    maps, _ = gradcam.deepest_map(model, torch.from_numpy(img))
    targs = [torch.from_numpy(a) for a in (ids, seg, mask)]
    acts, _, logits, kept = gradcam.grad_cam_from_maps(model, maps, *targs,
                                                       answer)
    channels = [0, 5, 17, acts.shape[-1] - 1]
    keep = torch.ones(len(channels), acts.shape[-1])
    keep[torch.arange(len(channels)), torch.tensor(channels)] = 0
    ablated = acts * keep[:, None, None, :]  # (4, h, w, C), B = 1
    rerun = gradcam.ablation_rerun(model, kept, *targs, answer)
    with torch.no_grad():
        got = rerun(ablated).numpy()

    jmodel = JaxMMBert(jcfg)
    jacts = jnp.asarray(acts.numpy())

    @jax.jit
    def rerun_jit(vs, ab):
        lg, _ = jmodel.apply(vs, jnp.asarray(img), jnp.asarray(ids),
                             jnp.asarray(seg), jnp.asarray(mask),
                             method=type(jmodel).features_and_logits,
                             perturb=ab - jacts)
        return lg[:, answer]

    want = np.stack([np.asarray(rerun_jit(variables, jnp.asarray(a[None])))[0]
                     for a in ablated.numpy()])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # an ablation moves the logit; the unablated rerun gives it back
    assert np.abs(got - logits[0, answer].item()).max() > 1e-4
    with torch.no_grad():
        again = rerun(acts).numpy()
    np.testing.assert_allclose(again, logits[:, answer].numpy(), rtol=1e-6,
                               atol=1e-6)
