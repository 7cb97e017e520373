"""The port's mesh and placement rule (mmvqa_tpu_torch/core/mesh.py,
mmvqa_tpu_torch/parallel/sharding.py) against the JAX package's, without
processes: ``make_mesh``'s sizes, rank order and errors against the JAX
function on the 8-device virtual mesh; the tensor-parallel and FSDP rule of
every leaf of the tiny flagship and default model against
``infer_param_shardings`` through the bridge's names, down to the elements
each rank holds; ``shard_state`` / ``gather_state`` round trips; the
kernels' refusal of a DTensor."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvqa_tpu.core.config import pretrain_config as jax_pretrain_config
from mmvqa_tpu.core.mesh import make_mesh as jax_make_mesh
from mmvqa_tpu.models.mmbert import MMBert as JaxMMBert
from mmvqa_tpu.parallel import sharding as jax_sharding

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.core.config import pretrain_config
from mmvqa_tpu_torch.core.mesh import make_mesh
from mmvqa_tpu_torch.models import MMBert
from mmvqa_tpu_torch.parallel import sharding

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

S, T = 32, 16

MODELS = {
    "flagship": dict(cnn_encoder="tf_efficientnetv2_m",
                     transformer_model="realformer", hidden_size=64),
    "default": dict(cnn_encoder="resnet152", transformer_model="transformer",
                    hidden_size=48),
}


@pytest.mark.parametrize("n,dp,tp,cp,pp", [
    (8, -1, 1, 1, 1), (8, -1, 2, 1, 1), (8, 4, 2, 1, 1), (8, 2, 4, 1, 1),
    (8, -1, 8, 1, 1), (8, 2, 2, 1, 1), (8, -1, 3, 1, 1), (4, 2, 2, 1, 1),
    (2, -1, 1, 1, 1), (1, -1, 1, 1, 1), (8, 0, 1, 1, 1),
])
def test_make_mesh_matches_jax(n, dp, tp, cp, pp):
    """Sizes, errors and the rank order of ``reshape(dp, tp, cp, pp)``."""
    try:
        want = jax_make_mesh(dp, tp, cp, pp, devices=jax.devices()[:n])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            make_mesh(dp, tp, cp, pp, world_size=n)
        assert str(got.value) == str(e)
        return
    devices = np.asarray(want.mesh.devices)
    for rank in range(n):
        spec = make_mesh(dp, tp, cp, pp, world_size=n, rank=rank)
        assert (spec.data_size, spec.model_size) == (want.data_size,
                                                     want.model_size)
        d, m = spec.data_rank, spec.model_rank
        assert devices[d, m, 0, 0] == jax.devices()[rank]
        assert spec.data_ranks() == [devices[i, m, 0, 0].id
                                     for i in range(spec.data_size)]
        assert spec.model_ranks() == [devices[d, i, 0, 0].id
                                      for i in range(spec.model_size)]


@pytest.mark.parametrize("cp,pp", [(2, 1), (1, 2)])
def test_context_and_pipeline_meshes_wait_for_item_10(cp, pp):
    """The context and pipe axes (ported with Queue 1, item 10): every
    rank's coordinates and each axis's ranks are the JAX mesh's device
    layout, ``reshape(dp, tp, cp, pp)``."""
    want = jax_make_mesh(-1, 1, cp, pp, devices=jax.devices()[:4])
    devices = np.asarray(want.mesh.devices)
    for rank in range(4):
        spec = make_mesh(-1, 1, cp, pp, world_size=4, rank=rank)
        assert spec.sizes == (want.data_size, want.model_size,
                              want.context_size, want.pipe_size)
        assert devices[spec.coords] == jax.devices()[rank]
        for i, axis in enumerate(("data", "model", "context", "pipe")):
            index = list(spec.coords)
            index[i] = slice(None)
            assert spec.axis_ranks(axis) == [
                d.id for d in devices[tuple(index)].reshape(-1)]


def _models(name):
    kw = dict(MODELS[name], n_layers=2, tiny_cnn=True, image_size=S,
              vocab_size=64, max_position_embeddings=T, batch_size=8)
    return MMBert(pretrain_config(**kw), device="cpu"), jax_pretrain_config(**kw)


def _jax_params(jcfg):
    ids = jnp.zeros((1, T), jnp.int32)
    shapes = jax.eval_shape(JaxMMBert(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, S, S, 3)), ids, ids,
                            jnp.ones((1, T)))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name in MODELS:
        model, jcfg = _models(name)
        variables = _jax_params(jcfg)
        out[name] = (model, variables,
                     bridge.to_state_dict(variables, model))
    return out


def _flat(tree, prefix=()):
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flat(v, prefix + (k,)))
        else:
            flat["/".join(prefix + (k,))] = v
    return flat


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("dp,tp,fsdp", [
    (8, 1, True), (4, 2, False), (4, 2, True), (2, 4, True), (1, 8, False),
])
def test_rule_picks_the_jax_dimension_and_elements(trees, monkeypatch, name,
                                                   dp, tp, fsdp):
    """Every leaf's spec is ``infer_param_shardings``'s on the 8-device
    mesh, and every rank's block (``shard_state``) holds the elements the
    JAX sharding gives that device, through the bridge's transform."""
    monkeypatch.setattr(jax_sharding, "FSDP_MIN_SIZE", 0)
    monkeypatch.setattr(sharding, "FSDP_MIN_SIZE", 0)
    model, variables, full = trees[name]
    mesh = jax_make_mesh(dp, tp, 1, 1)
    want = _flat(jax_sharding.infer_param_shardings(
        variables["params"], mesh, fsdp=fsdp))
    got = sharding.param_placements(model, dp, tp, fsdp)
    assert sorted(p.flax_path for p in got.values()) == sorted(want)
    n_split = 0
    for pl in got.values():
        assert pl.spec == tuple(want[pl.flax_path].spec), pl.flax_path
        n_split += bool(pl.spec)
    assert n_split >= 10
    entries = {e.key: e for e in bridge.mapping(model)}
    flax = _flat(variables["params"])
    devices = np.asarray(mesh.mesh.devices).reshape(-1)
    for rank in (0, len(devices) - 1):
        shards = sharding.shard_state(full, got, dp, tp, rank)
        for key, pl in got.items():
            leaf = flax[pl.flax_path]
            index = want[pl.flax_path].addressable_devices_indices_map(
                leaf.shape)[devices[rank]]
            expect = entries[key].to_torch(leaf[index])
            np.testing.assert_array_equal(shards[key].numpy(), expect,
                                          err_msg=key)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2), (4, 2)])
def test_shard_and_gather_state_round_trip(trees, monkeypatch, name, dp, tp):
    """JAX params -> the port's full state -> every rank's shards -> the
    full state again, bit for bit (running statistics stay whole)."""
    monkeypatch.setattr(sharding, "FSDP_MIN_SIZE", 0)
    model, _, full = trees[name]
    placements = sharding.param_placements(model, dp, tp, fsdp=True)
    shards = [sharding.shard_state(full, placements, dp, tp, r)
              for r in range(dp * tp)]
    back = sharding.gather_state(shards, placements, dp, tp)
    assert back.keys() == full.keys()
    for k in full:
        assert torch.equal(back[k], full[k]), k
    # every split leaf is really split: a rank holds 1 / (split ranks)
    for k, pl in placements.items():
        ways = ((tp if pl.tp_dim is not None else 1)
                * (dp if pl.fsdp_dim is not None else 1))
        assert shards[0][k].numel() * ways == full[k].numel(), k


def test_place_batch_gives_contiguous_rows():
    batch = {"x": np.arange(8), "c": ["a", "b", "c", "d", "e", "f", "g", "h"]}
    got = [sharding.place_batch(batch, make_mesh(-1, 2, world_size=4,
                                                 rank=r)) for r in range(4)]
    assert [list(g["x"]) for g in got] == [[0, 1, 2, 3], [0, 1, 2, 3],
                                           [4, 5, 6, 7], [4, 5, 6, 7]]
    assert got[2]["c"] == ["e", "f", "g", "h"]
    with pytest.raises(ValueError, match="not divisible"):
        sharding.place_batch({"x": np.arange(6)},
                             make_mesh(4, 1, world_size=4, rank=0))


class DTensor(torch.Tensor):
    """Stands in for torch.distributed.tensor.DTensor, which needs a
    process group to build: the kernels refuse by the class's name."""


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5"])
def test_kernel_wrappers_refuse_a_dtensor(kernel):
    from mmvqa_tpu_torch.ops.attention import realformer_attention_packed
    from mmvqa_tpu_torch.ops.bn_sums import bn_backward_sums
    from mmvqa_tpu_torch.ops.conv_bn import conv1x1_stats
    from mmvqa_tpu_torch.ops.depthwise import depthwise3x3
    from mmvqa_tpu_torch.ops.token_head import fused_token_head

    def d(t):
        return torch.Tensor._make_subclass(DTensor, t)

    calls = {
        "K1": lambda: fused_token_head(d(torch.zeros(2, 4, 8)),
                                       torch.zeros(8, 16)),
        "K2": lambda: realformer_attention_packed(
            d(torch.zeros(1, 4, 2, 24)), None, None),
        "K3": lambda: depthwise3x3(d(torch.zeros(1, 4, 4, 8)),
                                   torch.zeros(3, 3, 8)),
        "K4": lambda: conv1x1_stats(torch.zeros(16, 8),
                                    d(torch.zeros(8, 4))),
        "K5": lambda: bn_backward_sums(torch.zeros(1, 2, 2, 4),
                                       d(torch.zeros(1, 2, 2, 4)),
                                       torch.zeros(4), torch.ones(4)),
    }
    with pytest.raises(TypeError, match="DTensor"):
        calls[kernel]()


@pytest.mark.parametrize("encoder,ok", [("realformer", True),
                                        ("transformer", True),
                                        ("feedback-transformer", True)])
def test_tensor_parallelism_marks_what_it_splits(encoder, ok):
    """A tp=2 layout tells every split module how it is split (the feedback
    encoder's to_q, shared_kv and w_in column-parallel, to_out and w_out
    row-parallel, its memory this rank's heads)."""
    kw = dict(MODELS["flagship"], transformer_model=encoder, n_layers=1,
              tiny_cnn=True, image_size=S, vocab_size=64,
              max_position_embeddings=T)
    if encoder != "realformer":  # Config checks 12 heads divide it
        kw["hidden_size"] = 48
    model = MMBert(pretrain_config(**kw), device="cpu")
    spec = make_mesh(1, 2, world_size=2, rank=1)
    if not ok:
        with pytest.raises(NotImplementedError, match="--tp_size 1"):
            sharding.Layout(model, spec)
        return
    layout = sharding.Layout(model, spec)
    modes = {name: getattr(mod, "tp_mode", None)
             for name, mod in model.named_modules()}
    assert modes["bert_embedding.word_embeddings"] == "vocab"
    assert modes["fc1"] == modes["classifier_2"] == "col"
    split = [k for k, pl in layout.placements.items() if pl.tp_dim is not None]
    assert split and all(modes[k.rpartition(".")[0]] in ("col", "row",
                                                         "vocab")
                         for k in split)
    full = layout.full_shapes["classifier_2.weight"].shape
    assert model.classifier_2.weight.shape == (full[0] // 2, full[1])
    if encoder == "feedback-transformer":
        seg = model.encoder.segment
        assert (seg.shared_kv.tp_mode == seg.to_q_0.tp_mode
                == seg.ff_0.w_in.tp_mode == "col")
        assert seg.to_out_0.tp_mode == seg.ff_0.w_out.tp_mode == "row"
        assert seg.tp == 2 and seg.local_inner == 8 * 64 // 2
        assert seg.shared_kv.weight.shape == (8 * 64, 48)
