"""GPipe pipeline parallelism in mmvqa_tpu_torch (``parallel/pipeline.py``)
on the CPU, against the JAX package's ``mmvqa_tpu/parallel/pipeline.py``
(the counterparts of tests/test_pipeline_parallel.py).

Ranks spawned under gloo (``parallel/world.py``, a ``file://`` rendezvous
in a temporary folder): a world of two for pp=2 and a world of four for
dp=2 x pp=2, started together once for the module while this process
computes the single-process and JAX references. Held here:

* the pipelined encoders (BERT and RealFormer) on dp=2 x pp=2 and on
  dp=1 x pp=4 (stages with both a stage before and one after), forward
  and gradients, against the port's sequential encoders and against the
  JAX package's pipelined encoders through the bridge, at the JAX tests'
  tolerances (forward 1e-5; the RealFormer's padded rows 1e-3, where the
  carried -10000 rounds at 1e-3);
* ``pick_microbatches`` case for case against the JAX function, and the
  stacked <-> sequential converters bit for bit;
* the pp=2 and dp=2 x pp=2 MLM steps of both models against the port's
  single process (loss 2e-5 relative, gradients 1e-4, the global norm 1e-5
  relative, each parameter's change by ``world.update_problems``, every
  rank's replicated state equal) and against the JAX pipelined step on the
  virtual mesh (identity augmentation, the JAX step's loss at 2e-5);
* the ``pp_layers`` placement leaf by leaf and element by element against
  ``infer_param_shardings``;
* dropout under pp, which differs across data shards;
* ``adapt_encoder_layout`` both ways, outputs exactly equal, and a JAX
  pipelined model's weights through the bridge;
* the point-to-point exchange's staging rule (the CPU stages nothing).
"""

import dataclasses
import functools
import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvqa_tpu.core import mesh as jax_mesh_module
from mmvqa_tpu.core.config import pretrain_config as jax_pretrain_config
from mmvqa_tpu.core.mesh import make_mesh as jax_make_mesh
from mmvqa_tpu.data.images import AugmentSpec as JaxAugmentSpec
from mmvqa_tpu.models.mmbert import MMBert as JaxMMBert
from mmvqa_tpu.models.realformer import RealFormerEncoder as JaxRealFormer
from mmvqa_tpu.models.transformer import BertEncoder as JaxBertEncoder
from mmvqa_tpu.parallel import pipeline as jax_pipeline
from mmvqa_tpu.parallel import sharding as jax_sharding
from mmvqa_tpu.train import steps as jax_steps
from mmvqa_tpu.train.state import create_train_state as jax_create_train_state

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.core import distributed
from mmvqa_tpu_torch.core.config import pretrain_config
from mmvqa_tpu_torch.data.images import AugmentSpec
from mmvqa_tpu_torch.models import MMBert
from mmvqa_tpu_torch.models.layers import DropoutRng
from mmvqa_tpu_torch.models.realformer import RealFormerEncoder
from mmvqa_tpu_torch.models.transformer import BertEncoder
from mmvqa_tpu_torch.parallel import pipeline, sharding
from mmvqa_tpu_torch.parallel.world import (
    single_step,
    start_world,
    update_problems,
)
from mmvqa_tpu_torch.train import checkpoint

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

H, L, HEADS, B, T, S, VOCAB = 32, 4, 4, 8, 24, 32, 64
NOOP = dict(crop_scale=(1.0, 1.0), crop_ratio=(1.0, 1.0), rotation_deg=0.0,
            brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0)
MODELS = {
    "realformer": dict(cnn_encoder="tf_efficientnetv2_m",
                       transformer_model="realformer"),
    "bert": dict(cnn_encoder="tf_efficientnetv2_m",
                 transformer_model="transformer", heads=HEADS),
}
TIMEOUT = 240


def _kw(name, **over):
    return dict(MODELS[name], hidden_size=H, n_layers=2, tiny_cnn=True,
                image_size=S, vocab_size=VOCAB, max_position_embeddings=T,
                batch_size=B, dropout_override=0.0, **over)


def _batch(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(12, T + 1, size=B)
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    return {
        "image": rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8),
        "tokens": (rng.integers(1, VOCAB, (B, T)) * mask).astype(np.int32),
        "segment_ids": rng.integers(0, 2, (B, T)).astype(np.int32),
        "input_mask": mask,
        "labels": (rng.integers(1, VOCAB, (B, T)) * (rng.random((B, T)) < 0.3)
                   * mask).astype(np.int32),
        "weights": np.array([1.0] * 5 + [0.0] * 3, np.float32),
    }


def _job(name, dp, seed, **kw):
    # --watch: the per-module gradient norms
    return dict(cfg=pretrain_config(**_kw(name, pp_size=2), watch=True),
                kind="mlm", dp=dp, tp=1, pp=2, fsdp=False, batch=_batch(seed),
                aug=AugmentSpec(**NOOP), **kw)


# ``hist``: the --watch_histograms pass in the world (``world._hist_pass``)
WORLD2 = {"realformer-pp2": _job("realformer", 1, 1, hist=True),
          "bert-pp2": _job("bert", 1, 2)}
WORLD4 = {"realformer-dp2-pp2": _job("realformer", 2, 1),
          "bert-dp2-pp2": _job("bert", 2, 2)}
STEPS = list(WORLD2) + list(WORLD4)


def _job_of(name):
    return WORLD2.get(name) or WORLD4[name]


# ------------------------------------------------------ the encoders ----

def _encoder_inputs(seed=1):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, T, H)).astype(np.float32)
    mask = (rng.random((B, T)) > 0.2).astype(np.float32)
    cot = rng.normal(size=(B, T, H)).astype(np.float32)
    return h, mask, cot


@functools.lru_cache(maxsize=None)
def _jax_encoder(kind):
    """The JAX sequential encoder, its pipelined twin and the pipelined
    variables of the sequential one's seeded parameters (made once)."""
    h, mask, _ = _encoder_inputs()
    if kind == "bert":
        seq = JaxBertEncoder(hidden_size=H, n_layers=L, n_heads=HEADS,
                             dropout_rate=0.0, share="none", norm_pos="pre")
        pipe = jax_pipeline.PipelinedBertEncoder(
            hidden_size=H, n_layers=L, n_heads=HEADS, dropout_rate=0.0,
            norm_pos="pre")
    else:
        seq = JaxRealFormer(hidden_size=H, n_layers=L, head_cnt=8, dp1=0.0,
                            dp2=0.0)
        pipe = jax_pipeline.PipelinedRealFormerEncoder(
            hidden_size=H, n_layers=L, head_cnt=8, dp1=0.0, dp2=0.0)
    p = jax.device_get(jax.jit(seq.init)(
        jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(mask))["params"])
    if kind == "bert":
        stacked, n1, _ = jax_pipeline.stack_bert_encoder_params(p, L)
        pv = {"params": {"pp_layers": stacked, "norm1": n1}}
    else:
        pv = {"params": {"pp_layers": jax_pipeline.stack_realformer_params(
            p, L)}}
    return seq, pipe, p, pv


def _port_encoders(kind, dropout=0.0, rng=None):
    if kind == "bert":
        kw = dict(hidden_size=H, n_layers=L, n_heads=HEADS,
                  dropout_rate=dropout)
        return (BertEncoder(share="none", norm_pos="pre", **kw),
                pipeline.PipelinedBertEncoder(rng=rng, **kw), kw)
    kw = dict(hidden_size=H, n_layers=L, head_cnt=8, dp1=dropout, dp2=dropout)
    return (RealFormerEncoder(**kw), pipeline.PipelinedRealFormerEncoder(
        rng=rng, **kw), kw)


def _encoder_case(kind, dp, pp):
    _, pipe, _, pv = _jax_encoder(kind)
    _, port, kw = _port_encoders(kind)
    state = bridge.to_state_dict(jax.device_get(pv), port)
    h, mask, cot = _encoder_inputs()
    return dict(kind=kind, kw=kw, dp=dp, pp=pp, h=h, mask=mask, cot=cot,
                state={k: v.numpy() for k, v in state.items()})


def _dropout_case():
    """The BERT stack at dropout 0.5 with every sample the same: each data
    shard must draw its own masks."""
    rng = np.random.default_rng(9)
    row = rng.normal(size=(1, T, H)).astype(np.float32)
    _, port, kw = _port_encoders("bert", dropout=0.5)
    return dict(kind="bert", kw=dict(kw, dropout_rate=0.5), dp=2, pp=2,
                seed=3, h=np.repeat(row, B, axis=0),
                mask=np.ones((B, T), np.float32),
                cot=np.ones((B, T, H), np.float32),
                state={k: v.numpy() for k, v in port.state_dict().items()})


CASES = ["bert", "realformer"]
# (kind, dp, pp) of the encoder probes in the world of four: at pp=4 stages
# 1 and 2 both receive from the stage before and send to the one after
ENCODERS = ([(kind, 2, 2) for kind in CASES]
            + [(kind, 1, 4) for kind in CASES])


@pytest.fixture(scope="module", autouse=True)
def started():
    """Both worlds, started before the module's first test: they run while
    this process computes the references."""
    from test_torch_rank_probe import pipeline_ranks

    folder = tempfile.mkdtemp(prefix="pipeline_worlds_")
    w2 = start_world(pipeline_ranks, 2, (list(WORLD2.values()), []),
                     os.path.join(folder, "w2"))
    cases = [_encoder_case(*e) for e in ENCODERS] + [_dropout_case()]
    w4 = start_world(pipeline_ranks, 4, (list(WORLD4.values()), cases),
                     os.path.join(folder, "w4"))
    return w2, w4, len(cases)


@pytest.fixture(scope="module")
def worlds(started):
    """Both worlds' results: {step name: ranks} and the world of four's
    encoder probes (ENCODERS, then dropout), each a list of ranks."""
    w2, w4, n_cases = started
    out2, out4 = w2.results(TIMEOUT), w4.results(TIMEOUT)
    steps = {}
    for jobs, outs in ((WORLD2, out2), (WORLD4, out4)):
        for i, name in enumerate(jobs):
            steps[name] = [o[0][i] for o in outs]
    probes = [[o[1][i] for o in out4] for i in range(n_cases)]
    return steps, probes


def test_pick_microbatches_is_the_jax_rule():
    """Every (requested, per-shard batch, pp) of a grid: the same M or the
    same error."""
    for requested in range(0, 6):
        for batch in range(1, 13):
            for pp in range(1, 5):
                try:
                    want = jax_pipeline._pick_microbatches(requested, batch,
                                                           pp)
                except ValueError as e:
                    with pytest.raises(ValueError) as got:
                        pipeline.pick_microbatches(requested, batch, pp)
                    assert str(got.value) == str(e)
                    continue
                assert pipeline.pick_microbatches(requested, batch,
                                                  pp) == want


@pytest.mark.parametrize("kind", CASES)
def test_stack_and_unstack_are_the_jax_converters(kind):
    """The port's stacked state of the JAX sequential encoder is the bridge
    of the JAX stacked tree, and unstacking gives the sequential state back,
    bit for bit."""
    _, _, p, pv = _jax_encoder(kind)
    seq, pipe, _ = _port_encoders(kind)
    seq_state = bridge.to_state_dict({"params": jax.device_get(p)}, seq)
    want = bridge.to_state_dict(jax.device_get(pv), pipe)
    if kind == "bert":
        st, n1, n2 = pipeline.stack_bert_encoder_params(seq_state, L)
        assert n2 is None
        got = {**st, **n1}
        back = pipeline.unstack_bert_encoder_params(st, n1, n2)
    else:
        got = pipeline.stack_realformer_params(seq_state, L)
        back = pipeline.unstack_realformer_params(got)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert back.keys() == seq_state.keys()
    for k in seq_state:
        assert torch.equal(back[k], seq_state[k]), k


def _jax_encoder_grads(kind, dp, pp):
    """The JAX sequential and pipelined (dp x pp of the virtual mesh)
    forward and parameter gradients, each one jitted program."""
    seq, pipe, p, pv = _jax_encoder(kind)
    h, mask, cot = (jnp.asarray(a) for a in _encoder_inputs())

    def seq_loss(q):
        y = seq.apply({"params": q}, h, mask, True)
        return jnp.sum(y * cot), y

    old = jax_mesh_module.CURRENT
    try:
        jax_mesh_module.set_current(jax_make_mesh(
            dp, 1, 1, pp, devices=jax.devices()[:dp * pp]))

        def pipe_loss(v):
            y = pipe.apply(v, h, mask, True)
            return jnp.sum(y * cot), y

        (g_pipe, y_pipe) = jax.jit(jax.grad(pipe_loss, has_aux=True))(pv)
    finally:
        jax_mesh_module.set_current(old)
    g_seq, y_seq = jax.jit(jax.grad(seq_loss, has_aux=True))(p)
    return (jax.device_get(y_seq), jax.device_get(g_seq),
            jax.device_get(y_pipe), jax.device_get(g_pipe))


# ------------------------------------------- placement, checkpoints ----

@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("fsdp", [False, True])
def test_pp_layers_rule_is_the_jax_rule(monkeypatch, model, fsdp):
    """On a dp=2 x pp=2 mesh every leaf's spec is
    ``infer_param_shardings``'s ('pipe' on the stacked layers' leading axis,
    before FSDP, which takes the rest), and every rank's block holds the
    elements JAX gives that device."""
    monkeypatch.setattr(jax_sharding, "FSDP_MIN_SIZE", 0)
    monkeypatch.setattr(sharding, "FSDP_MIN_SIZE", 0)
    port = MMBert(pretrain_config(**_kw(model, pp_size=2)), device="cpu")
    full = port.state_dict()
    variables = bridge.to_flax(full, port)
    spec = jax_make_mesh(2, 1, 1, 2, devices=jax.devices()[:4])
    want = {}

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, prefix + (k,))
            else:
                want["/".join(prefix + (k,))] = v

    flat(jax_sharding.infer_param_shardings(variables["params"], spec,
                                            fsdp=fsdp))
    got = sharding.param_placements(port, 2, 1, fsdp, pp=2)
    assert sorted(p.flax_path for p in got.values()) == sorted(want)
    stacked = [p for p in got.values() if "pp_layers" in p.flax_path]
    assert stacked and all(p.spec == ("pipe",) and p.pipe_dim == 0
                           for p in stacked)
    for pl in got.values():
        assert pl.spec == tuple(want[pl.flax_path].spec), pl.flax_path
    entries = {e.key: e for e in bridge.mapping(port)}
    leaves = {}

    def flat_leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat_leaves(v, prefix + (k,))
            else:
                leaves["/".join(prefix + (k,))] = v

    flat_leaves(variables["params"])
    devices = np.asarray(spec.mesh.devices).reshape(-1)
    for rank in range(4):
        shards = sharding.shard_state(full, got, 2, 1, rank, cp=1, pp=2)
        for key, pl in got.items():
            leaf = leaves[pl.flax_path]
            index = want[pl.flax_path].addressable_devices_indices_map(
                leaf.shape)[devices[rank]]
            np.testing.assert_array_equal(
                shards[key].numpy(), entries[key].to_torch(leaf[index]),
                err_msg=key)
    shards = [sharding.shard_state(full, got, 2, 1, r, 1, 2)
              for r in range(4)]
    back = sharding.gather_state(shards, got, 2, 1, 1, 2)
    assert all(torch.equal(back[k], full[k]) for k in full)


def _inputs(seed=11):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.normal(size=(B, S, S, 3)).astype(np.float32)),
            torch.as_tensor(rng.integers(0, VOCAB, (B, T))),
            torch.zeros(B, T, dtype=torch.long), torch.ones(B, T))


@pytest.mark.parametrize("model", list(MODELS))
def test_adapt_encoder_layout_both_ways(tmp_path, model):
    """A sequential checkpoint loads into the pipelined model and back
    through the savers and ``adapt_encoder_layout``, and each model computes
    the same logits, bit for bit (tests/test_pipeline_parallel.py:412-470);
    a checkpoint whose layout agrees comes back as it is."""
    from mmvqa_tpu_torch.train.state import create_train_state

    seq = MMBert(pretrain_config(**_kw(model)), device="cpu")
    pp = MMBert(pretrain_config(**_kw(model, pp_size=2)), device="cpu",
                generator=torch.Generator().manual_seed(5))
    x = _inputs()
    want = seq(*x)
    checkpoint.save_weights(str(tmp_path / "seq"),
                            create_train_state(seq, 1e-3))
    loaded = checkpoint.load_weights(str(tmp_path / "seq"))
    assert checkpoint.adapt_encoder_layout(seq.state_dict(), loaded) is loaded
    adapted = checkpoint.adapt_encoder_layout(pp.state_dict(), loaded)
    checkpoint.check_compatible(pp.state_dict(), adapted)
    pp.load_state_dict(adapted, strict=True)
    assert torch.equal(pp(*x), want)
    checkpoint.save_weights(str(tmp_path / "pp"), create_train_state(pp, 1e-3))
    back = checkpoint.adapt_encoder_layout(
        seq.state_dict(), checkpoint.load_weights(str(tmp_path / "pp")))
    assert back.keys() == seq.state_dict().keys()
    assert all(torch.equal(back[k], v) for k, v in seq.state_dict().items())


@pytest.mark.parametrize("model", list(MODELS))
def test_jax_pipelined_model_crosses_the_bridge(model):
    """The JAX package's MMBert with pp_size=2 (the ``pp_layers`` tree) ->
    the port's pipelined model: the same logits (one process, the
    sequential path of both), and back to the same tree."""
    from test_torch_bridge import jax_variables

    jcfg = jax_pretrain_config(**_kw(model, pp_size=2))
    img, ids, seg, mask = _inputs()
    args = [jnp.asarray(t.numpy()) for t in (img, ids, seg, mask)]
    old = jax_mesh_module.CURRENT
    try:
        jax_mesh_module.set_current(None)
        variables = jax_variables(jcfg, seed=3)
        want = jax.jit(JaxMMBert(jcfg).apply)(variables, *args)
    finally:
        jax_mesh_module.set_current(old)
    assert "pp_layers" in variables["params"]["encoder"]
    port = MMBert(dataclasses.replace(pretrain_config(**_kw(model)),
                                      pp_size=2), device="cpu")
    port.load_state_dict(bridge.to_state_dict(variables, port), strict=True)
    np.testing.assert_allclose(port(img, ids, seg, mask).detach().numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)
    back = bridge.to_flax(port.state_dict(), port)
    enc = variables["params"]["encoder"]["pp_layers"]
    leaf = "kqv" if model == "realformer" else "attention_0"
    np.testing.assert_array_equal(
        jax.tree.leaves(back["params"]["encoder"]["pp_layers"][leaf])[0],
        jax.tree.leaves(enc[leaf])[0])


def test_exchange_stages_only_cuda_tensors_under_gloo(monkeypatch):
    """The point-to-point exchange's staging is chosen from the backend and
    the device: a CUDA buffer under gloo goes through pinned host memory
    (and counts in STAGED), a CPU one or any under NCCL does not."""

    class Cuda:
        is_cuda = True

    class Cpu:
        is_cuda = False

    for backend, tensor, staged in (("gloo", Cuda, True), ("gloo", Cpu, False),
                                    ("nccl", Cuda, False)):
        monkeypatch.setattr(distributed.dist, "get_backend",
                            lambda group=None, b=backend: b)
        assert distributed._staged("exchange", tensor(), None) is staged
    # gloo all-reduces CUDA tensors itself
    monkeypatch.setattr(distributed.dist, "get_backend",
                        lambda group=None: "gloo")
    assert not distributed._staged("all_reduce", Cuda(), None)
    before = dict(distributed.STAGED)
    distributed.exchange([], [], None)  # nothing to move: no call
    assert distributed.STAGED == before


# ------------------------------------------- the worlds' results ----

@pytest.fixture(scope="module")
def jax_encoders():
    return {e: _jax_encoder_grads(*e) for e in ENCODERS}


@pytest.mark.parametrize("i", range(len(ENCODERS)), ids=[
    f"{i}-{kind}" + ("" if pp == 2 else f"-pp{pp}")
    for i, (kind, _, pp) in enumerate(ENCODERS)])
def test_pipelined_encoder_matches_sequential_and_jax(jax_encoders, worlds,
                                                      i):
    """dp=2 x pp=2 and dp=1 x pp=4 (two middle stages): the output and the
    gradients against the port's sequential encoder (the unstacked weights,
    one process) and the JAX pipelined encoder's on the same mesh through
    the bridge; the input's gradient against the sequential one's."""
    ranks = worlds[1][i]
    got = ranks[0]
    kind = ENCODERS[i][0]
    h, mask, cot = _encoder_inputs()
    seq, pipe, _ = _port_encoders(kind)
    case = _encoder_case(*ENCODERS[i])
    stacked = {k: torch.as_tensor(v) for k, v in case["state"].items()}
    seq.load_state_dict(pipeline.unstack_encoder_state(stacked, prefix=""))
    x = torch.as_tensor(h).requires_grad_()
    y = seq(x, torch.as_tensor(mask))
    (y * torch.as_tensor(cot)).sum().backward()
    seq_grads = pipeline.stack_encoder_state(
        {k: t.grad for k, t in seq.named_parameters()}, prefix="")
    real = mask > 0
    fwd = dict(rtol=1e-5, atol=1e-5)
    pad = fwd if kind == "bert" else dict(rtol=1e-3, atol=5e-4)
    grad = (dict(rtol=5e-4, atol=1e-4) if kind == "bert"
            else dict(rtol=1e-3, atol=5e-3))
    _, _, y_jax, g_jax = jax_encoders[ENCODERS[i]]
    jax_grads = bridge.to_state_dict({"params": g_jax["params"]}, pipe)
    for want_y in (y.detach().numpy(), np.asarray(y_jax)):
        np.testing.assert_allclose(got["out"][real], want_y[real], **fwd)
        np.testing.assert_allclose(got["out"][~real], want_y[~real], **pad)
    np.testing.assert_allclose(got["dh"], x.grad.numpy(), **grad)
    assert got["grads"].keys() == seq_grads.keys() == jax_grads.keys()
    for k in seq_grads:
        np.testing.assert_allclose(got["grads"][k], seq_grads[k].numpy(),
                                   err_msg=k, **grad)
        np.testing.assert_allclose(got["grads"][k], jax_grads[k].numpy(),
                                   err_msg=k, **grad)
    for r in ranks:  # every rank holds the whole output; nothing staged
        np.testing.assert_array_equal(r["out"], got["out"])
        assert r["staged"] == 0


def test_dropout_under_pp_differs_across_data_shards(worlds):
    """Every sample the same and dropout at 0.5: the data shards' outputs
    differ (each folds its coordinate into its stream), the JAX package's
    documented deviation from the sequential stream."""
    out = worlds[1][len(ENCODERS)][0]["out"]
    assert not np.allclose(out[0], out[B // 2])


# ---------------------------------------------------------- the steps ----

@pytest.fixture(scope="module")
def singles():
    return {name: single_step(_job_of(name), "cpu") for name in STEPS}


@pytest.mark.parametrize("name", STEPS)
def test_pipelined_step_equals_the_single_process_step(singles, worlds,
                                                       name):
    """Loss, the reduced gradients (the stacked layers gathered over
    'pipe'), their global norm, the statistics and each parameter's change,
    and every rank's replicated state and the no-JAX rule."""
    ranks, ref = worlds[0][name], singles[name]
    r0 = ranks[0]
    assert abs(r0["loss"] - ref["loss"]) <= 2e-5 * max(1.0, abs(ref["loss"]))
    assert r0["grads"].keys() == ref["grads"].keys()
    assert any("pp_layers" in k for k in ref["grads"])
    for k, want in ref["grads"].items():
        np.testing.assert_allclose(np.asarray(r0["grads"][k]),
                                   np.asarray(want), rtol=0, atol=1e-4,
                                   err_msg=k)
    for r in ranks:
        assert r["loss"] == r0["loss"]
        assert r["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-5)
        assert r["digest"] == r0["digest"] and not r["jax_modules"]
    stats = [k for k in ref["state"] if k.endswith("running_var")]
    assert stats
    for k in stats:
        np.testing.assert_allclose(r0["state"][k], ref["state"][k], rtol=0,
                                   atol=1e-4, err_msg=k)
    problems, held, dropped = update_problems(
        ref["before"], r0["state"], ref["state"], ref["grads"], 2e-5)
    assert problems == [] and held > 20 * dropped, (problems[:3], held)


@pytest.mark.parametrize("name", STEPS)
def test_pipelined_module_norms_are_the_single_process_ones(singles, worlds,
                                                            name):
    """--watch under a pipeline: every rank's ``gnorm/<module>`` is the
    single process's (1e-5 relative), the stages' stacked layers counted in
    ``encoder``."""
    want = {k: float(v) for k, v in singles[name]["metrics"].items()
            if k.startswith("gnorm/")}
    assert "gnorm/encoder" in want and len(want) >= 7
    for r in worlds[0][name]:
        got = {k: float(v) for k, v in r["metrics"].items()
               if k.startswith("gnorm/")}
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5), (r["rank"], k)


def test_pipelined_histograms_are_the_sequential_ones(worlds):
    """--watch_histograms at pp=2: the stacked leaves are gathered over
    'pipe' and binned layer by layer under the sequential encoder's names,
    so the histograms are those of a single process with the sequential
    encoder (the same seeded weights): rank 0's gathered gradient and the
    weights bit for bit, the single process's as
    ``test_torch_layouts.hist_problems`` states; and the pass leaves every
    rank's state as it was."""
    from test_torch_layouts import binned, hist_problems

    name = "realformer-pp2"
    job = _job_of(name)
    seq = job["cfg"].replace(pp_size=1)
    ref = single_step(dict(job, cfg=seq), "cpu")
    torch_name = {v: k for k, v in bridge.flax_names(
        MMBert(seq, device="cpu")).items()}
    assert any("block_1" in k for k in torch_name)
    assert ref["hist_kept_state"] and len(ref["hist"]) == 2 * len(torch_name)
    ranks = worlds[0][name]
    grads = pipeline.unstack_encoder_state(ranks[0]["grads"])
    for r in ranks:
        assert r["hist_kept_state"], r["rank"]
        assert r["hist"].keys() == ref["hist"].keys()
        for key, want in ref["hist"].items():
            kind, _, path = key.partition("/")
            k = torch_name[path]
            mine = grads[k] if kind == "ghist" else ref["before"][k]
            for a, b in zip(r["hist"][key], binned(mine)):
                np.testing.assert_array_equal(a, b, err_msg=key)
            theirs = np.asarray(ref["grads" if kind == "ghist" else
                                    "before"][k], np.float64)
            diff = float(np.abs(np.asarray(mine, np.float64) - theirs).max())
            problems = hist_problems(r["hist"][key], want, theirs, diff)
            assert problems == [], (r["rank"], key, problems)


@pytest.fixture(scope="module")
def jax_pipelined(singles):
    """The JAX package's MLM step of each model with pp_size=2 on a
    dp=2 x pp=2 mesh of the virtual devices, from the port's initial
    weights, identity augmentation: (loss, the state after it in the port's
    names)."""
    out = {}
    for model in MODELS:
        job = WORLD4[f"{model}-dp2-pp2"]
        jcfg = jax_pretrain_config(**_kw(model, pp_size=2))
        port = MMBert(job["cfg"], device="cpu")
        variables = bridge.to_flax(port.state_dict(), port)
        spec = jax_make_mesh(2, 1, 1, 2, devices=jax.devices()[:4])
        old = jax_mesh_module.CURRENT
        try:
            jax_mesh_module.set_current(spec)
            state = jax_sharding.place_state(jax_create_train_state(
                jax.tree.map(jnp.asarray, variables), jcfg.lr), spec)
            step, _ = jax_steps.make_mlm_steps(JaxMMBert(jcfg), jcfg,
                                               aug=JaxAugmentSpec(**NOOP))
            state, m = step(state, jax_sharding.place_batch(job["batch"],
                                                            spec),
                            jax.random.PRNGKey(0))
            after = jax.device_get({"params": state.params,
                                    "batch_stats": state.batch_stats})
        finally:
            jax_mesh_module.set_current(old)
        out[model] = float(m["loss"]), bridge.to_state_dict(after, port)
    return out


@pytest.mark.parametrize("model", list(MODELS))
def test_pipelined_step_equals_the_jax_pipelined_step(jax_pipelined, singles,
                                                      worlds, model):
    """The loss at the JAX tests' 2e-5 and each parameter's change in the
    step against the JAX package's (entries held by the port's single
    process's gradient)."""
    name = f"{model}-dp2-pp2"
    loss, state = jax_pipelined[model]
    got = worlds[0][name][0]
    assert abs(got["loss"] - loss) <= 2e-5 * max(1.0, abs(loss))
    ref = dict(singles[name], state={k: v.numpy() for k, v in state.items()})
    problems, held, dropped = update_problems(
        ref["before"], got["state"], ref["state"], ref["grads"], 2e-5)
    assert problems == [] and held > 20 * dropped, (problems[:3], held)
