"""The Flax -> torch weight bridge (mmvqa_tpu_torch.bridge) on tiny MMBert
trees of the JAX package: every leaf is taken exactly once, the layouts are
the ones each module type needs, and the trip back gives the tree again."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvqa_tpu.core.config import pretrain_config as jax_pretrain_config
from mmvqa_tpu.core.config import vqa_config as jax_vqa_config
from mmvqa_tpu.models.mmbert import MMBert as JaxMMBert

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.core.config import pretrain_config, vqa_config
from mmvqa_tpu_torch.models import MMBert

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

S = 32

CASES = {
    "vqa5": (vqa_config, jax_vqa_config, dict(num_vis=5, num_classes=10)),
    "vqa7": (vqa_config, jax_vqa_config, dict(num_vis=7, num_classes=10)),
    "mlm": (pretrain_config, jax_pretrain_config, dict(vocab_size=300)),
}


def configs(case, **over):
    """The port's and the JAX package's config of one tiny case."""
    port_factory, jax_factory, extra = CASES[case]
    kw = dict(cnn_encoder="tf_efficientnetv2_m",
              transformer_model="realformer", hidden_size=64, n_layers=2,
              tiny_cnn=True, image_size=S, **extra)
    kw.update(over)
    return port_factory(**kw), jax_factory(**kw)


def jax_variables(jcfg, seed=0):
    """The JAX model's variable tree (paths and shapes from ``MMBert.init``
    under ``jax.eval_shape``), filled with seeded numpy values: statistics
    and norms away from their initial 0 and 1, kernels fan-in scaled."""
    T = jcfg.max_position_embeddings
    ids = jnp.zeros((1, T), jnp.int32)
    shapes = jax.eval_shape(JaxMMBert(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, S, S, 3)), ids, ids, jnp.ones((1, T)))
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
        else:  # embedding tables
            a = rng.normal(size=shape) * 0.02
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def trees():
    out = {}
    for case in CASES:
        cfg, jcfg = configs(case)
        out[case] = (cfg, jax_variables(jcfg))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_leaf_mapped_once_and_round_trips(trees, case):
    cfg, variables = trees[case]
    model = MMBert(cfg, device="cpu")
    sd = bridge.to_state_dict(variables, model)
    leaves = _leaves(variables)
    assert len(sd) == len(leaves) == len(model.state_dict())
    assert len({e.path for e in bridge.mapping(model)}) == len(leaves)
    model.load_state_dict(sd, strict=True)
    back = _leaves(bridge.to_flax(model.state_dict(), model))
    assert back.keys() == leaves.keys()
    for path, arr in leaves.items():
        assert back[path].shape == arr.shape, path
        np.testing.assert_array_equal(back[path], arr.astype(np.float32),
                                      err_msg="/".join(path))


def test_layouts_of_each_module_type(trees):
    cfg, variables = trees["vqa5"]
    sd = bridge.to_state_dict(variables, MMBert(cfg, device="cpu"))
    p, bs = variables["params"], variables["batch_stats"]
    trunk = p["trans"]["trunk"]

    def eq(key, want):
        np.testing.assert_array_equal(sd[key].numpy(), want, err_msg=key)

    # conv HWIO -> OIHW
    eq("trans.trunk.stem_conv.weight",
       trunk["stem_conv"]["kernel"].transpose(3, 2, 0, 1))
    # depthwise (3, 3, 1, C) -> (C, 1, 3, 3)
    dw = trunk["stage3_block0"]["dw"]["kernel"]
    assert dw.shape[2] == 1
    eq("trans.trunk.stage3_block0.dw.weight", dw.transpose(3, 2, 0, 1))
    # squeeze-excite convs carry a bias
    eq("trans.trunk.stage3_block0.se.reduce.bias",
       trunk["stage3_block0"]["se"]["reduce"]["bias"])
    # BatchNorm: scale/bias from params, statistics from batch_stats
    eq("trans.trunk.stem_bn.weight", trunk["stem_bn"]["scale"])
    eq("trans.trunk.stem_bn.running_var",
       bs["trans"]["trunk"]["stem_bn"]["var"])
    # token head (1, 1, K, C) -> the K1 weight (K, C)
    eq("trans.token_conv_0.weight", p["trans"]["token_conv_0"]["kernel"][0, 0])
    # Dense kernels transposed; the shared kqv is (emb_s, 3 emb_s) in Flax
    eq("fc1.weight", p["fc1"]["kernel"].T)
    kqv = p["encoder"]["block_0"]["kqv"]["kernel"]
    assert kqv.shape == (64 // 8, 3 * 64 // 8)
    eq("encoder.block_0.kqv.weight", kqv.T)
    # embeddings; the position table keeps BERT's 512 rows
    eq("bert_embedding.word_embeddings.weight",
       p["bert_embedding"]["word_embeddings"]["embedding"])
    assert p["bert_embedding"]["position_embeddings"].shape == (512, 64)


def test_refuses_unmapped_missing_misshaped_and_twice_mapped(trees,
                                                             monkeypatch):
    cfg, variables = trees["vqa5"]
    model = MMBert(cfg, device="cpu")

    extra = jax.tree.map(lambda a: a, variables)
    extra["params"]["fc1"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unmapped.*fc1/stray"):
        bridge.to_state_dict(extra, model)

    missing = jax.tree.map(lambda a: a, variables)
    del missing["params"]["classifier_ln"]["scale"]
    with pytest.raises(KeyError, match="classifier_ln/scale"):
        bridge.to_state_dict(missing, model)

    wrong = jax.tree.map(lambda a: a, variables)
    wrong["params"]["fc1"]["kernel"] = np.zeros((64, 65), np.float32)
    with pytest.raises(ValueError, match="fc1/kernel"):
        bridge.to_state_dict(wrong, model)

    entries = bridge.mapping(model)
    monkeypatch.setattr(bridge, "mapping", lambda m: entries + entries[:1])
    with pytest.raises(ValueError, match="mapped twice"):
        bridge.to_state_dict(variables, model)


def test_bridged_tensors_keep_the_model_dtype(trees):
    cfg, variables = trees["vqa5"]
    model = MMBert(cfg, device="cpu", dtype=torch.bfloat16)
    sd = bridge.to_state_dict(variables, model)
    assert {t.dtype for t in sd.values()} == {torch.bfloat16}
