"""The CLIs' default model, ResNet-152 visual tokens and the pre-norm BERT
encoder (``--cnn_encoder resnet152 --transformer_model transformer``, the
reference's MMBERT), in the port against the JAX package on the CPU: the
one-block-a-stage ResNet at full widths, hidden 48 (12 heads of 4), two
layers, weights carried across by ``mmvqa_tpu_torch.bridge``. The MLM, VQA
and SupCon forwards in fp32, the VQA forward in bf16, the MLM -> VQA
transfer, and the five-tap rule. The train steps are in
tests/test_torch_default_train.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvqa_tpu.models.mmbert import MMBert as JaxMMBert
from mmvqa_tpu.train import checkpoint as jax_checkpoint

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.core.config import Config
from mmvqa_tpu_torch.models import MMBert
from mmvqa_tpu_torch.models.resnet import ResNetFeatures
from mmvqa_tpu_torch.models.transformer import BertEncoder
from mmvqa_tpu_torch.train import checkpoint
from mmvqa_tpu_torch.train.state import create_train_state

from test_torch_bridge import configs, jax_variables

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

B, S = 3, 48
# tests/test_torch_model.py's tolerance for the whole model
TOL = dict(rtol=1e-4, atol=1e-4)
DEFAULT = dict(cnn_encoder="resnet152", transformer_model="transformer",
               hidden_size=48, n_layers=2, image_size=S)


def default_configs(case, **over):
    """The port's and the JAX package's config of a tiny default model."""
    kw = dict(DEFAULT)
    kw.update(over)
    return configs(case, **kw)


def _inputs(cfg, rng):
    T = cfg.max_position_embeddings
    lengths = rng.integers(cfg.num_vis + 2, T + 1, size=B)
    lengths[0] = T
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    img = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    ids = (rng.integers(1, cfg.vocab_size, (B, T)) * mask).astype(np.int32)
    seg = rng.integers(0, 2, (B, T)).astype(np.int32)
    return img, ids, seg, mask


def _bridged(cfg, variables, dtype=torch.float32):
    model = MMBert(cfg, device="cpu")
    model.load_state_dict(bridge.to_state_dict(variables, model), strict=True)
    return model.to(dtype)


def test_default_config_builds_the_reference_mmbert():
    """``MMBert(Config())``: ResNet-152 (3, 8, 36, 3) and a 4-layer pre-norm
    encoder of 12 heads at hidden 768, no ``norm2``."""
    model = MMBert(Config(), device="cpu")
    assert isinstance(model.trans.trunk, ResNetFeatures)
    assert [len(s) for s in model.trans.trunk.stages] == [3, 8, 36, 3]
    enc = model.encoder
    assert isinstance(enc, BertEncoder) and enc.n_layers == 4
    assert enc.attention_0.n_heads == 12 and enc.norm_pos == "pre"
    assert not hasattr(enc, "norm2")
    assert model.trans.token_conv_0.weight.shape == (2048, 768)
    assert model.trans.token_conv_4.weight.shape == (64, 768)
    # dropout hidden_dropout_prob (0.3) in the encoder, the reference's 0.1
    # in the embeddings
    assert enc.drop.p == 0.3 and model.bert_embedding.dropout.p == 0.1


@pytest.mark.parametrize("case,over", [
    ("vqa5", {}), ("mlm", {}), ("mlm", {"supcon": True}),
    ("vqa5", {"use_relu": True}),
], ids=["vqa", "mlm", "mlm_supcon", "vqa_relu"])
def test_logits_match_jax(rng, case, over):
    cfg, jcfg = default_configs(case, **over)
    variables = jax_variables(jcfg)
    args = _inputs(cfg, rng)
    want = jax.jit(lambda v, *a: JaxMMBert(jcfg).apply(
        v, *a, deterministic=True))(variables, *map(jnp.asarray, args))
    model = _bridged(cfg, variables)
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, args))
    if cfg.supcon:
        (got, feat), (want, want_feat) = got, want
        np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat), **TOL)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_logits_within_the_jax_packages_bf16_error(rng):
    """tests/test_torch_model.py's rule: the port cast to bf16 is at most
    twice as far from the fp32 logits as the JAX package's bf16 model."""
    cfg, jcfg = default_configs("vqa5")
    variables = jax_variables(jcfg)
    args = _inputs(cfg, rng)
    fn = jax.jit(lambda v, *a, dt: JaxMMBert(jcfg, dtype=dt).apply(
        v, *a, deterministic=True), static_argnames="dt")
    want32 = np.asarray(fn(variables, *map(jnp.asarray, args),
                           dt=jnp.float32))
    jax16 = np.asarray(fn(variables, *map(jnp.asarray, args),
                          dt=jnp.bfloat16).astype(jnp.float32))
    with torch.inference_mode():
        got = _bridged(cfg, variables, torch.bfloat16)(
            *map(torch.from_numpy, args))
    assert got.dtype == torch.bfloat16
    port_err = np.abs(got.float().numpy() - want32).max()
    jax_err = np.abs(jax16 - want32).max()
    assert 0 < port_err <= 2 * jax_err, (port_err, jax_err)


def test_mlm_weights_transfer_to_vqa_as_the_jax_filter_does(tmp_path):
    """The default MLM model's weights saved, loaded and filtered into the
    default VQA model keep what the JAX ``filtered_restore`` keeps: every
    tensor but ``classifier_2``, the trunk's running statistics among
    them."""
    cfg, jcfg = default_configs("vqa5", max_position_embeddings=12)
    mcfg, mjcfg = default_configs("mlm", max_position_embeddings=16,
                                  vocab_size=cfg.vocab_size)
    vqa_vars, mlm_vars = jax_variables(jcfg), jax_variables(mjcfg, 1)
    merged, n_ok, n_all = jax_checkpoint.filtered_restore(vqa_vars, mlm_vars)

    mlm = _bridged(mcfg, mlm_vars)
    checkpoint.save_weights(str(tmp_path / "roco" / "best"),
                            create_train_state(mlm, 1e-4))
    loaded = checkpoint.load_weights(str(tmp_path / "roco" / "best"))
    vqa = _bridged(cfg, vqa_vars)
    target = vqa.state_dict()
    got, p_ok, p_all = checkpoint.filtered_restore(target, loaded)
    assert (p_ok, p_all) == (n_ok, n_all) == (len(target) - 2, len(target))
    fresh = sorted(k for k, v in got.items() if v is target[k])
    assert fresh == ["classifier_2.bias", "classifier_2.weight"]
    vqa.load_state_dict(got, strict=True)
    back = bridge._flatten(bridge.to_flax(vqa.state_dict(), vqa))
    for path, w in bridge._flatten(merged).items():
        np.testing.assert_array_equal(back[path], np.asarray(w),
                                      err_msg="/".join(path))
    assert any("layer1_block0" in "/".join(p) and p[0] == "batch_stats"
               for p in back)


def test_resnet_takes_five_taps_only():
    cfg, _ = default_configs("vqa7")
    with pytest.raises(ValueError, match="num_vis=5"):
        MMBert(cfg, device="cpu")
