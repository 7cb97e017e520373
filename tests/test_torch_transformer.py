"""The port's BERT encoder (``models/transformer.py``), its attention core
(``ops/attention.py::vanilla_attention``) and ``ops/activations.py::
gelu_erf`` against the JAX package on the CPU: the same numpy inputs and
weights (carried across by ``mmvqa_tpu_torch.bridge``) through both, in fp32
unless a test says otherwise. Tolerances: rtol = atol = 1e-4 for outputs and
gradients (tests/test_token_head.py's gradient tolerance; 2e-6 where one
elementwise function is compared)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvqa_tpu.models import transformer as jax_transformer
from mmvqa_tpu.ops.activations import gelu_erf as jax_gelu_erf
from mmvqa_tpu.ops.attention import vanilla_attention as jax_vanilla_attention

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.models import transformer
from mmvqa_tpu_torch.models.layers import Dropout, DropoutRng
from mmvqa_tpu_torch.ops.activations import gelu_erf
from mmvqa_tpu_torch.ops.attention import vanilla_attention

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
B, T, H, HEADS, LAYERS = 3, 11, 48, 12, 2


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _key_mask(rng, b=B, t=T):
    lengths = rng.integers(2, t + 1, size=b)
    lengths[0] = t  # one row without padding
    return (np.arange(t)[None] < lengths[:, None]).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_erf_matches_jax(rng, dtype):
    x = (rng.normal(size=(4096,)) * 3).astype(np.float32)
    x[:4] = [0.0, -30.0, 30.0, 1e-6]
    want = np.asarray(jax_gelu_erf(jnp.asarray(x, dtype)), np.float32)
    got = gelu_erf(_t(x, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        # the absolute term: at x = -30 XLA's erf stops 6e-8 short of -1,
        # which leaves -2.7e-6 where torch's erf gives 0 (the true value is
        # -30 * Phi(-30), about -1e-196)
        np.testing.assert_allclose(_np(got), want, rtol=2e-6, atol=5e-6)
    else:  # the same bf16 op order: equal but where an erf rounds apart
        np.testing.assert_allclose(_np(got), want, rtol=8e-3, atol=1e-6)
        assert np.mean(_np(got) != want) < 0.01


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [True, False])
def test_vanilla_attention_matches_jax(rng, dtype, masked):
    """Padded KEYS take no weight (the mask is over keys, not queries)."""
    D = H // HEADS
    q, k, v = (rng.normal(size=(B, HEADS, T, D)).astype(np.float32)
               for _ in range(3))
    mask = _key_mask(rng) if masked else None
    jd = getattr(jnp, dtype)
    want = np.asarray(jax_vanilla_attention(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        None if mask is None else jnp.asarray(mask)), np.float32)
    td = getattr(torch, dtype)
    got = vanilla_attention(_t(q, td), _t(k, td), _t(v, td),
                            None if mask is None else _t(mask))
    assert got.dtype == td and got.shape == (B, HEADS, T, D)
    tol = TOL if dtype == "float32" else dict(rtol=8e-3, atol=2e-3)
    np.testing.assert_allclose(_np(got), want, **tol)
    if masked:  # a padded key's value does not reach any output
        v2 = v.copy()
        v2.transpose(0, 2, 1, 3)[mask == 0] += 100.0
        moved = vanilla_attention(_t(q), _t(k), _t(v2), _t(mask))
        np.testing.assert_allclose(
            _np(moved), _np(vanilla_attention(_t(q), _t(k), _t(v), _t(mask))),
            rtol=1e-5, atol=1e-5)


def test_vanilla_attention_gradients_match_jax(rng):
    D = H // HEADS
    q, k, v, g = (rng.normal(size=(B, HEADS, T, D)).astype(np.float32)
                  for _ in range(4))
    mask = _key_mask(rng)
    want = jax.grad(lambda a, b, c: jnp.sum(jax_vanilla_attention(
        a, b, c, jnp.asarray(mask)) * g), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    (vanilla_attention(*ts, _t(mask)) * _t(g)).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), **TOL)


def test_vanilla_attention_dropout_draws_from_the_models_generator(rng):
    """Dropout on the probabilities: inverted at its rate, the identity in
    eval mode, and the same masks from two generators seeded alike."""
    D = H // HEADS
    q, k, v = (_t(rng.normal(size=(B, HEADS, T, D))) for _ in range(3))
    mask = _t(_key_mask(rng))
    outs = []
    for seed in (5, 5, 6):
        drop = Dropout(0.3, DropoutRng(seed)).train()
        outs.append(vanilla_attention(q, k, v, mask, dropout=drop))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    plain = vanilla_attention(q, k, v, mask)
    assert torch.equal(
        vanilla_attention(q, k, v, mask,
                          dropout=Dropout(0.3, DropoutRng(5)).eval()), plain)
    assert not torch.allclose(outs[0], plain)


def test_vanilla_attention_ring_waits_for_the_multi_gpu_item():
    """``impl='ring'`` without a context group of more than one rank (one
    process) is the ring over the whole sequence: this path's values; an
    impl the JAX package does not name raises."""
    rng = np.random.default_rng(3)
    q, k, v = (_t(rng.normal(size=(2, 3, 8, 4)).astype(np.float32))
               for _ in range(3))
    mask = _t(_key_mask(rng)[:2, :8])
    assert torch.equal(vanilla_attention(q, k, v, mask, impl="ring"),
                       vanilla_attention(q, k, v, mask))
    with pytest.raises(ValueError, match="unknown impl"):
        vanilla_attention(q, k, v, None, impl="flash")


# ------------------------------------------------------ the encoder ----

CASES = [(share, norm_pos) for share in transformer.SHARE_MODES
         for norm_pos in transformer.NORM_POSITIONS]


def _layers(share):
    """The JAX package's shared modes run one layer only: a second creates
    the shared submodule's name again, which Flax refuses (NameInUseError,
    a fault of the reference). The port's sharing across layers is held to
    'none' with the weights repeated (``test_shared_modes_...``)."""
    return LAYERS if share == "none" else 1


def _encoder_case(rng, share, norm_pos):
    """The Flax encoder, its variables filled from ``rng`` (norms away from
    1 and 0), the port's encoder with them loaded, and inputs."""
    n = _layers(share)
    jenc = jax_transformer.BertEncoder(H, n, HEADS, 0.1, share=share,
                                       norm_pos=norm_pos)
    h = rng.normal(size=(B, T, H)).astype(np.float32)
    mask = _key_mask(rng)
    shapes = jax.eval_shape(jenc.init, jax.random.PRNGKey(0), jnp.asarray(h),
                            jnp.asarray(mask))

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "scale":
            a = 1.0 + rng.normal(size=shape) * 0.1
        elif name == "bias":
            a = rng.normal(size=shape) * 0.1
        else:
            a = rng.normal(size=shape) * shape[0] ** -0.5
        return a.astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    enc = transformer.BertEncoder(H, n, HEADS, 0.1, share=share,
                                  norm_pos=norm_pos)
    enc.load_state_dict(bridge.to_state_dict(variables, enc), strict=True)
    return jenc, variables, enc, h, mask


@pytest.mark.parametrize("share,norm_pos", CASES)
def test_bert_encoder_matches_flax(rng, share, norm_pos):
    """Output, the parameter tree leaf for leaf (no ``norm2`` under 'pre',
    the shared names under the share modes), every parameter's gradient and
    the input's."""
    jenc, variables, enc, h, mask = _encoder_case(rng, share, norm_pos)
    g = rng.normal(size=(B, T, H)).astype(np.float32)

    def f(params, x, m, gy):
        y = jenc.apply({"params": params}, x, m)
        return jnp.sum(y * gy), y

    # one compiled program, as the JAX package's steps run it
    (_, want), (want_gp, want_gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(variables["params"], jnp.asarray(h),
                                          jnp.asarray(mask), g)

    enc.eval()
    x = _t(h).requires_grad_()
    y = enc(x, _t(mask))
    (y * _t(g)).sum().backward()
    np.testing.assert_allclose(_np(y), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(x.grad), np.asarray(want_gx), **TOL)

    flat_want = bridge._flatten(want_gp)
    flat_got = bridge._flatten(bridge.grads_to_flax(enc))
    assert flat_got.keys() == flat_want.keys()
    assert flat_got.keys() == bridge._flatten(variables["params"]).keys()
    for path, w in flat_want.items():
        np.testing.assert_allclose(flat_got[path], np.asarray(w), **TOL,
                                   err_msg="/".join(path))
    names = {p[0] for p in flat_want}
    assert ("norm2" in names) == (norm_pos == "post")
    shared = share in ("all", "att")
    assert ("attention" in names) == shared
    assert ("attention_0" in names) == (not shared)
    assert ("feedforward" in names) == (share in ("all", "ffn"))
    # the trip back gives the tree
    back = bridge._flatten(bridge.to_flax(enc.state_dict(), enc)["params"])
    for path, w in bridge._flatten(variables["params"]).items():
        np.testing.assert_array_equal(back[path], w)


@pytest.mark.parametrize("norm_pos", transformer.NORM_POSITIONS)
def test_bert_encoder_bf16_within_the_jax_packages_bf16_error(rng, norm_pos):
    """The port cast to bf16 is at most twice as far from the fp32 output
    as the JAX package's bf16 encoder (``dtype=bfloat16``) is."""
    jenc, variables, enc, h, mask = _encoder_case(rng, "none", norm_pos)
    want32 = np.asarray(jenc.apply(variables, jnp.asarray(h),
                                   jnp.asarray(mask)))
    j16 = jax_transformer.BertEncoder(H, LAYERS, HEADS, 0.1,
                                      norm_pos=norm_pos, dtype=jnp.bfloat16)
    jax16 = np.asarray(j16.apply(variables, jnp.asarray(h, jnp.bfloat16),
                                 jnp.asarray(mask)), np.float32)
    with torch.no_grad():
        got = enc.eval().to(torch.bfloat16)(_t(h, torch.bfloat16), _t(mask))
    assert got.dtype == torch.bfloat16
    port_err = np.abs(_np(got) - want32).max()
    jax_err = np.abs(jax16 - want32).max()
    assert 0 < port_err <= 2 * jax_err, (port_err, jax_err)


def test_flax_refuses_a_second_layer_of_a_shared_mode():
    """The reason the shared modes meet Flax at one layer: the JAX
    package's encoder cannot be built with two."""
    import flax

    jenc = jax_transformer.BertEncoder(H, 2, HEADS, 0.1, share="all")
    with pytest.raises(flax.errors.NameInUseError):
        jax.eval_shape(jenc.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, T, H)), None)


@pytest.mark.parametrize("share", ["all", "att", "ffn"])
@pytest.mark.parametrize("norm_pos", transformer.NORM_POSITIONS)
def test_shared_modes_reuse_one_module_across_layers(rng, share, norm_pos):
    """A shared mode over three layers is 'none' with the shared module's
    weights in every layer: output and gradients (summed over the layers
    for the shared weights)."""
    n = 3
    shared = transformer.BertEncoder(H, n, HEADS, 0.1, share=share,
                                     norm_pos=norm_pos).eval()
    with torch.no_grad():
        for p in shared.parameters():
            p.copy_(_t(rng.normal(size=tuple(p.shape)) * 0.2))
    plain = transformer.BertEncoder(H, n, HEADS, 0.1,
                                    norm_pos=norm_pos).eval()
    sd = shared.state_dict()
    mapped = {}
    for key in plain.state_dict():
        head, rest = key.split(".", 1) if "." in key else (key, "")
        base = head.rsplit("_", 1)[0]
        src = f"{base}.{rest}" if f"{base}.{rest}" in sd else key
        mapped[key] = sd[src]
    plain.load_state_dict(mapped, strict=True)
    h, mask = _t(rng.normal(size=(B, T, H))), _t(_key_mask(rng))
    g = _t(rng.normal(size=(B, T, H)))
    (shared(h, mask) * g).sum().backward()
    (plain(h, mask) * g).sum().backward()
    torch.testing.assert_close(shared(h, mask), plain(h, mask), **TOL)
    grads = dict(plain.named_parameters())
    for name, p in shared.named_parameters():
        head, rest = name.split(".", 1)
        if head in ("attention", "proj", "feedforward"):
            want = sum(grads[f"{head}_{i}.{rest}"].grad for i in range(n))
        else:
            want = grads[name].grad
        torch.testing.assert_close(p.grad, want, **TOL, msg=name)
    assert len(list(shared.parameters())) < len(list(plain.parameters()))


def test_encoder_dropout_is_seeded_and_off_in_eval(rng):
    _, _, enc, h, mask = _encoder_case(rng, "none", "pre")
    x, m = _t(h), _t(mask)
    with torch.no_grad():
        plain = enc.eval()(x, m)
        enc.train()
        a = enc(x, m)
        enc.drop.rng.manual_seed(0)
        b = enc(x, m)
        c = enc(x, m)
    assert torch.equal(a, b) and not torch.equal(b, c)
    assert not torch.allclose(a, plain)


def test_encoder_refuses_unknown_modes():
    with pytest.raises(ValueError, match="share"):
        transformer.BertEncoder(H, 1, HEADS, 0.1, share="some")
    with pytest.raises(ValueError, match="norm_pos"):
        transformer.BertEncoder(H, 1, HEADS, 0.1, norm_pos="middle")
