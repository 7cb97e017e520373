"""The port's ResNet trunk (``models/resnet.py``) against the Flax modules of
the JAX package on the CPU, weights and statistics carried across by
``mmvqa_tpu_torch.bridge``: ``Bottleneck`` with and without its downsample,
stride 1 and 2, and ``ResNetFeatures`` with one block a stage at full
widths, in training mode (batch statistics, the running statistics updated)
and in eval mode. Tolerance: rtol = atol = 1e-4 of the largest entry of each
compared array, gradients too (tests/test_token_head.py's 1e-4); the
convolutions and batch statistics are summed in another order by XLA and by
torch. Then the full ResNet-152 trunk's kernel sites, counted on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvqa_tpu.models import resnet as jax_resnet

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.models import effnetv2, resnet

from test_torch_trunk_kernels import _fill

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

REL = 1e-4


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=REL,
                               atol=REL * np.abs(want).max(), err_msg=what)


def _nhwc(t):
    return _np(t.permute(0, 2, 3, 1))


def _run_both(jmod, mod, x, train, rng):
    """One call of the Flax module (``train`` as its argument) and of the
    port's (in that mode) on the NHWC input ``x``, with random variables;
    the gradient of sum(out * g) over every output. Returns both sides'
    outputs (NHWC), input gradients, parameter gradients and statistics
    (as Flax trees)."""
    shapes = jax.eval_shape(lambda key, a: jmod.init(key, a, train),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    variables = _fill(shapes, rng)
    mod.load_state_dict(bridge.to_state_dict(variables, mod), strict=True)
    mod.train(train)

    jouts = jax.eval_shape(lambda v, a: jmod.apply(v, a, train,
                                                   mutable=["batch_stats"]),
                           variables, jnp.asarray(x))[0]
    gs = [rng.normal(size=o.shape).astype(np.float32)
          for o in jax.tree_util.tree_leaves(jouts)]

    def f(params, xin, stats, gs):
        outs, mut = jmod.apply({"params": params, "batch_stats": stats}, xin,
                               train, mutable=["batch_stats"])
        outs = jax.tree_util.tree_leaves(outs)
        return sum(jnp.sum(o * g) for o, g in zip(outs, gs)), (
            outs, mut["batch_stats"])

    # one compiled program, as the JAX package's steps run (op by op, the
    # trunk's few hundred primitives each compile on their own)
    (_, (want, want_stats)), (want_gp, want_gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(variables["params"], jnp.asarray(x),
                                          variables["batch_stats"], gs)

    xt = _t(x).permute(0, 3, 1, 2).requires_grad_()
    got = mod(xt)
    got = list(got) if isinstance(got, tuple) else [got]
    sum((o * _t(g).permute(0, 3, 1, 2)).sum()
        for o, g in zip(got, gs)).backward()
    got_stats = bridge.to_flax(mod.state_dict(), mod)["batch_stats"]
    return dict(variables=variables,
        want=[np.asarray(o) for o in want], got=[_nhwc(o) for o in got],
        want_gx=np.asarray(want_gx), got_gx=_nhwc(xt.grad),
        want_gp=bridge._flatten(want_gp),
        got_gp=bridge._flatten(bridge.grads_to_flax(mod)),
        want_stats=bridge._flatten(want_stats),
        got_stats=bridge._flatten(got_stats))


def _check(r, n_outputs):
    assert len(r["got"]) == len(r["want"]) == n_outputs
    for i, (g, w) in enumerate(zip(r["got"], r["want"])):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        close(g, w, f"output {i}")
    close(r["got_gx"], r["want_gx"], "input gradient")
    assert r["got_gp"].keys() == r["want_gp"].keys()
    for path, w in r["want_gp"].items():
        close(r["got_gp"][path], w, "/".join(path))
    assert r["got_stats"].keys() == r["want_stats"].keys()
    for path, w in r["want_stats"].items():
        close(r["got_stats"][path], w, "/".join(path))


BLOCKS = {
    # name: (in_ch, width, stride, has_downsample, map side)
    "identity": (32, 8, 1, False, 6),
    "downsample_stride1": (16, 8, 1, True, 6),
    "downsample_stride2": (16, 8, 2, True, 7),
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_bottleneck_matches_flax(rng, name, train):
    """Output, input and parameter gradients, and in training the running
    statistics of every BatchNorm after one call."""
    in_ch, width, stride, ds, side = BLOCKS[name]
    jblock = jax_resnet.Bottleneck(width=width, stride=stride,
                                   has_downsample=ds)
    block = resnet.Bottleneck(in_ch, width, stride, has_downsample=ds)
    x = rng.normal(size=(3, side, side, in_ch)).astype(np.float32)
    r = _run_both(jblock, block, x, train, rng)
    _check(r, 1)
    assert r["got"][0].shape[1] == -(-side // stride)
    n_bn = 4 if ds else 3
    assert len(r["want_stats"]) == 2 * n_bn


def _relu_inputs(jtrunk, variables, trunk, x, train):
    """Every ReLU input of both trunks, JAX first: the stem's BatchNorm, each
    block's bn1 and bn2, and its residual sum (bn3 + the downsample's
    BatchNorm: every block of a one-block-a-stage trunk has one)."""
    _, st = jax.jit(lambda v, a: jtrunk.apply(
        v, a, train, mutable=["batch_stats", "intermediates"],
        capture_intermediates=True))(variables, jnp.asarray(x))
    jax_out = st["intermediates"]
    got = {}
    hooks = [mod.register_forward_hook(
        lambda _m, _a, o, name=name: got.__setitem__(name, _nhwc(o)))
        for name, mod in trunk.named_modules()
        if isinstance(mod, effnetv2.BatchNorm2d)]
    with torch.no_grad():
        trunk.train(train)(_t(x).permute(0, 3, 1, 2))
    for h in hooks:
        h.remove()

    def jax_of(name):
        node = jax_out
        for part in name.split("."):
            node = node[part]
        return np.asarray(node["__call__"][0])

    pairs = []
    for name in got:
        if name.endswith(("bn3", "downsample_bn")):
            continue
        pairs.append((jax_of(name), got[name]))
    for block in (n for n in got if n.endswith(".bn3")):
        base = block[:-len("bn3")]
        pairs.append((jax_of(block) + jax_of(base + "downsample_bn"),
                      got[block] + got[base + "downsample_bn"]))
    return pairs


@pytest.mark.parametrize("train,size", [(True, 40), (False, 32)],
                         ids=["train", "eval"])
def test_resnet_features_match_flax(rng, train, size):
    """One block a stage at full widths (64 ... 2048 channels) on a 40 or
    32 px image: all five taps (stem before the max-pool, then each stage),
    input and weight gradients through all of them, and the running
    statistics.

    ReLU's derivative jumps at 0: a ReLU input that lies within the two
    packages' rounding of 0 may take the other side in one of them, and
    that position's gradient term then reaches one package's gradients and
    not the other's. With this seed that happens once in training at 48, 56
    and 64 px and once in eval at 40 px (one input of some 10^5, 6e-7 to
    5e-6 from 0; at 64 px it moves the input gradient by 0.5% of its
    largest entry, and a float64 run of the JAX module sides with the JAX
    package's fp32 run). Such a point tests no arithmetic, so each mode runs
    at a size where none occurs, and the test checks that: every ReLU input
    has the same sign in both packages."""
    jtrunk = jax_resnet.ResNetFeatures(stage_sizes=(1, 1, 1, 1))
    trunk = resnet.ResNetFeatures((1, 1, 1, 1))
    x = rng.normal(size=(4, size, size, 3)).astype(np.float32)
    r = _run_both(jtrunk, trunk, x, train, rng)
    pairs = _relu_inputs(jtrunk, r["variables"], trunk, x, train)
    assert len(pairs) == 1 + 3 * 4
    for want, got in pairs:
        assert np.array_equal(want > 0, got > 0)
    _check(r, 5)
    assert [o.shape[-1] for o in r["got"]] == list(resnet.TAP_CHANNELS)
    side = size // 2
    assert [o.shape[1] for o in r["got"]] == [
        side, side // 2, -(-side // 4), -(-side // 8), -(-side // 16)]


def test_trunk_tree_round_trips_through_the_bridge(rng):
    """Every leaf of the Flax trunk, params and batch_stats, is taken once
    and comes back equal; the names are the Flax tree's."""
    jtrunk = jax_resnet.ResNetFeatures(stage_sizes=(2, 1, 1, 1))
    shapes = jax.eval_shape(lambda key, a: jtrunk.init(key, a, False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    variables = _fill(shapes, rng)
    trunk = resnet.ResNetFeatures((2, 1, 1, 1))
    trunk.load_state_dict(bridge.to_state_dict(variables, trunk), strict=True)
    back = bridge._flatten(bridge.to_flax(trunk.state_dict(), trunk))
    want = bridge._flatten(variables)
    assert back.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_array_equal(back[path], w)
    names = {"/".join(p[1:]) for p in want}
    assert {"conv1/kernel", "bn1/scale", "bn1/mean",
            "layer1_block1/conv3/kernel", "layer1_block0/downsample_bn/var",
            "layer4_block0/downsample_conv/kernel"} <= names
    assert not any("layer1_block1/downsample" in n for n in names)


def test_resnet152_takes_k4_at_101_sites_and_k5_at_155(monkeypatch):
    """In training the full ResNet-152 trunk sends ``conv1`` and ``conv3``
    of all 50 blocks and layer1's stride-1 downsample through
    ``conv1x1_stats`` (K4), and the backward of every BatchNorm, the stem's,
    three a block and the four downsamples', through ``bn_backward_sums``
    (K5); the three stride-2 downsamples take the library's convolution.
    Counted through the wrappers' module-level names on a 32 px image."""
    calls = {"k4": [], "k5": 0}
    k4, k5 = effnetv2.conv1x1_stats, effnetv2.bn_backward_sums

    def count_k4(x, w):
        calls["k4"].append((x.shape[1], w.shape[1]))
        return k4(x, w)

    def count_k5(*a):
        calls["k5"] += 1
        return k5(*a)

    monkeypatch.setattr(effnetv2, "conv1x1_stats", count_k4)
    monkeypatch.setattr(effnetv2, "bn_backward_sums", count_k5)
    trunk = resnet.ResNetFeatures().train()
    assert len(trunk.stages[2]) == 36
    x = torch.randn(2, 3, 32, 32, requires_grad=True)
    taps = trunk(x)
    sum(t.float().sum() for t in taps).backward()
    assert len(calls["k4"]) == 101 and calls["k5"] == 155
    assert calls["k4"].count((64, 256)) == 4  # 3 conv3 + layer1's downsample
    assert all(t.is_contiguous(memory_format=torch.channels_last)
               for t in taps)
    trunk.eval()
    calls["k4"].clear()
    with torch.no_grad():
        trunk(x)
    assert calls["k4"] == []  # eval: the library's convolutions


def test_eval_trunk_keeps_channels_last_maps():
    trunk = resnet.ResNetFeatures((1, 1, 1, 1)).eval()
    img = torch.randn(2, 40, 40, 3).permute(0, 3, 1, 2)
    with torch.no_grad():
        taps = trunk(img)
    assert [tuple(t.shape[1:]) for t in taps] == [
        (64, 20, 20), (256, 10, 10), (512, 5, 5), (1024, 3, 3),
        (2048, 2, 2)]
    assert all(t.is_contiguous(memory_format=torch.channels_last)
               for t in taps)
