"""The trunk's three kernel modules of the port (K3 depthwise 3x3, K4
conv1x1 + BN statistics, K5 BN-backward sums) against the JAX package on the
CPU: the same numpy inputs go through the JAX function (its Pallas kernel in
interpret mode, as the JAX package's own tests run it) and through the port's
wrapper, which takes its plain version for a CPU tensor. Then one MBConv and
one FusedMBConv block in training mode against the Flax blocks, weights
carried over by the bridge. Tolerances are those of
tests/test_pallas_depthwise.py and tests/test_conv_bn.py unless a line says
otherwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as nn

from mmvqa_tpu.models import effnetv2 as jax_effnet
from mmvqa_tpu.ops.pallas_conv_bn import conv1x1_stats as jax_conv1x1_stats
from mmvqa_tpu.ops.pallas_depthwise import depthwise3x3 as jax_depthwise3x3

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.models import effnetv2
from mmvqa_tpu_torch.ops import tiling
from mmvqa_tpu_torch.ops.bn_sums import (
    bn_backward_sums,
    bn_backward_sums_reference,
)
from mmvqa_tpu_torch.ops.conv_bn import (
    conv1x1_stats,
    conv1x1_stats_reference,
    launch_plan,
)
from mmvqa_tpu_torch.ops.depthwise import (
    depthwise3x3,
    depthwise3x3_backward_reference,
    depthwise3x3_reference,
)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------------- K3 ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,W,C", [(2, 14, 14, 128), (2, 5, 5, 128)])
def test_depthwise_forward_matches_jax(rng, dtype, B, H, W, C):
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(3, 3, C)) * 0.2).astype(np.float32)
    want = jax_depthwise3x3(jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    tdtype = getattr(torch, dtype)
    got = depthwise3x3(_t(x, tdtype), _t(w, tdtype))
    assert got.dtype == tdtype and got.shape == (B, H, W, C)
    bf16 = dtype == "bfloat16"
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=2e-2 if bf16 else 2e-5,
                               atol=2e-2 if bf16 else 1e-5)
    # the fp32 master weight under a bf16 map is rounded on the way in
    if bf16:
        assert torch.equal(depthwise3x3(_t(x, tdtype), _t(w).to(tdtype).float()),
                           got)


@pytest.mark.parametrize("B,H,W,C", [(2, 14, 14, 128), (2, 5, 5, 128)])
def test_depthwise_gradients_match_jax(rng, B, H, W, C):
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(3, 3, C)) * 0.2).astype(np.float32)
    g = rng.normal(size=(B, H, W, C)).astype(np.float32)
    gx, gw = jax.grad(lambda a, b: jnp.sum(jax_depthwise3x3(a, b) * g),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    (depthwise3x3(xt, wt) * _t(g)).sum().backward()
    np.testing.assert_allclose(_np(xt.grad), np.asarray(gx),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(wt.grad), np.asarray(gw),
                               rtol=1e-4, atol=1e-3)
    # the tap-by-tap backward is the gradient of the library's convolution
    x2, w2 = _t(x).requires_grad_(), _t(w).requires_grad_()
    (depthwise3x3_reference(x2, w2) * _t(g)).sum().backward()
    dx, dw = depthwise3x3_backward_reference(_t(x), _t(w), _t(g))
    torch.testing.assert_close(dx, x2.grad, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dw, w2.grad, rtol=1e-4, atol=1e-4)


def test_depthwise_corner_impulse_stays_in_its_corner():
    B, H, W, C = 1, 7, 7, 128
    x = np.zeros((B, H, W, C), np.float32)
    x[0, 0, 0, :] = 1.0
    w = np.ones((3, 3, C), np.float32)
    want = np.asarray(jax_depthwise3x3(jnp.asarray(x), jnp.asarray(w)))
    got = _np(depthwise3x3(_t(x), _t(w)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got[0, :2, :2, 0].sum() == pytest.approx(4.0)
    assert np.abs(got[0, 2:, :, 0]).max() == 0.0
    assert np.abs(got[0, :, 2:, 0]).max() == 0.0
    # and the backward: a gradient at the corner reaches x's corner only
    dx, dw = depthwise3x3_backward_reference(_t(x), _t(w), _t(x))
    assert dx[0, :2, :2, 0].sum().item() == pytest.approx(4.0)
    assert dx[0, 2:].abs().max() == 0.0 and dx[0, :, 2:].abs().max() == 0.0
    assert dw[1, 1, 0].item() == 1.0 and dw.sum().item() == C


def test_depthwise_takes_the_conv_weight_as_a_view(rng):
    """The trunk hands K3 the (C, 1, 3, 3) convolution weight permuted, not
    copied: the (9, C) rows the kernel reads are a view of it."""
    from mmvqa_tpu_torch.ops.depthwise import _weight_rows

    conv = effnetv2.DepthwiseConv2d(8, 3, 1)
    w = conv.weight[:, 0].permute(1, 2, 0)
    rows = _weight_rows(w)
    assert rows.shape == (9, 8) and rows.stride() == (1, 9)
    assert rows.data_ptr() == conv.weight.data_ptr()
    with pytest.raises(ValueError, match=r"not \(B, H, W, C\)"):
        depthwise3x3(torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 4))


# ------------------------------------------------------------- K4 ----

@pytest.mark.parametrize("N", [512, 700])
def test_conv1x1_stats_forward_matches_jax(rng, N):
    K, C = 24, 64
    x = rng.normal(size=(N, K)).astype(np.float32)
    w = (rng.normal(size=(K, C)) * 0.1).astype(np.float32)
    y, s = jax_conv1x1_stats(jnp.asarray(x), jnp.asarray(w))
    # w as the trunk passes it: the (C, K) weight's transposed view
    got_y, got_s = conv1x1_stats(_t(x), _t(w.T.copy()).t())
    np.testing.assert_allclose(_np(got_y), np.asarray(y), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(_np(got_s), np.asarray(s), rtol=1e-4, atol=1e-4)


def test_conv1x1_stats_gradients_match_jax(rng):
    """With a non-zero cotangent on the sums, which the trunk never sends."""
    N, K, C = 700, 24, 64
    x = rng.normal(size=(N, K)).astype(np.float32)
    w = (rng.normal(size=(K, C)) * 0.1).astype(np.float32)
    gy = rng.normal(size=(N, C)).astype(np.float32)
    gs = (rng.normal(size=(2, C)) * 0.1).astype(np.float32)

    def loss(a, b):
        y, s = jax_conv1x1_stats(a, b)
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    for with_gs in (True, False):
        xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
        y, s = conv1x1_stats(xt, wt)
        ((y * _t(gy)).sum() + ((s * _t(gs)).sum() if with_gs else 0)).backward()
        if with_gs:
            np.testing.assert_allclose(_np(xt.grad), np.asarray(gx),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(_np(wt.grad), np.asarray(gw),
                                       rtol=1e-4, atol=1e-3)
        else:  # the trunk's case: the sums' cotangent is None
            torch.testing.assert_close(xt.grad, _t(gy) @ _t(w).t())
            torch.testing.assert_close(wt.grad, _t(x).t() @ _t(gy),
                                       rtol=1e-4, atol=1e-4)


def test_conv1x1_stats_bf16_sums_come_from_the_unrounded_product(rng):
    N, K, C = 512, 48, 96
    x = jnp.asarray(rng.normal(size=(N, K)), jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(K, C)) * 0.1, jnp.bfloat16)
    y, s = jax_conv1x1_stats(x, w)
    xt = _t(np.asarray(x, np.float32), torch.bfloat16)
    wt = _t(np.asarray(w, np.float32), torch.bfloat16)
    got_y, got_s = conv1x1_stats(xt, wt)
    assert got_y.dtype == torch.bfloat16 and got_s.dtype == torch.float32
    # y: one bf16 rounding of one fp32 product on each side; the sums: both
    # from the fp32 accumulator (the JAX kernel's, not its reference's)
    np.testing.assert_allclose(_np(got_y), np.asarray(y, np.float32),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got_s), np.asarray(s), rtol=1e-4, atol=1e-3)
    # the rounded map's sums are measurably elsewhere
    rounded = got_y.float()
    assert (got_s[1] - (rounded * rounded).sum(0)).abs().max() > 1e-3
    ref_y, ref_s = conv1x1_stats_reference(xt, wt)
    assert torch.equal(ref_y, got_y) and torch.equal(ref_s, got_s)


@pytest.mark.parametrize("N,K,C,dtype", [
    (401408, 96, 48, torch.bfloat16), (25088, 1056, 176, torch.bfloat16),
    (6272, 3072, 512, torch.bfloat16), (6272, 3072, 512, torch.float32),
    (1, 1, 1, torch.float32), (129, 7, 65, torch.bfloat16),
])
def test_conv1x1_stats_launch_plan(N, K, C, dtype):
    nrb = launch_plan(N, K, C, dtype, 132)
    tile_m = 128 if dtype == torch.bfloat16 else 64
    assert 1 <= nrb <= -(-N // tile_m)
    with pytest.raises(ValueError, match="empty"):
        launch_plan(0, K, C, dtype, 132)


# ------------------------------------------------------------- K5 ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_backward_sums_match_flax_and_the_probe(rng, dtype):
    """sum dy is the gradient of a Flax BatchNorm's bias, sum dy * xhat that
    of its scale; to 1e-4 of the largest entry. And the probe's four-line
    XLA version (tools/bn_probe.py::xla_sums), restated here."""
    B, H, W, C = 4, 6, 5, 24
    x = (rng.normal(size=(B, H, W, C)) * 2 + 0.5).astype(np.float32)
    dy = rng.normal(size=(B, H, W, C)).astype(np.float32)
    jx, jdy = jnp.asarray(x, dtype), jnp.asarray(dy, dtype)
    params = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
              "bias": rng.normal(size=C).astype(np.float32)}
    stats = {"mean": np.zeros(C, np.float32), "var": np.ones(C, np.float32)}
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-3)

    def f(p):
        y, _ = bn.apply({"params": p, "batch_stats": stats},
                        jx.astype(jnp.float32), mutable=["batch_stats"])
        return jnp.sum(y * jdy.astype(jnp.float32))

    want = jax.grad(f)(params)
    xf = np.asarray(jx, np.float32).reshape(-1, C)
    mean = xf.mean(0)
    inv_std = 1.0 / np.sqrt(np.maximum((xf * xf).mean(0) - mean * mean, 0)
                            + 1e-3)

    def xla_sums(x, dy, mean, inv):
        xhat = (x.astype(jnp.float32) - mean) * inv
        d = dy.astype(jnp.float32)
        return jnp.sum(d, axis=(0, 1, 2)), jnp.sum(d * xhat, axis=(0, 1, 2))

    p1, p2 = xla_sums(jx, jdy, jnp.asarray(mean), jnp.asarray(inv_std))
    tdtype = getattr(torch, dtype)
    xt = _t(np.asarray(jx, np.float32), tdtype)
    dyt = _t(np.asarray(jdy, np.float32), tdtype)
    s1, s2 = bn_backward_sums(xt, dyt, _t(mean), _t(inv_std))
    assert s1.dtype == s2.dtype == torch.float32 and s1.shape == (C,)
    for got, flax_grad, probe in ((s1, want["bias"], p1),
                                  (s2, want["scale"], p2)):
        scale = np.abs(np.asarray(flax_grad)).max()
        assert np.abs(_np(got) - np.asarray(flax_grad)).max() <= 1e-4 * scale
        assert np.abs(_np(got) - np.asarray(probe)).max() <= 1e-5 * scale
    # the trunk's map is (B, C, H, W) lying channels-last: its view goes in
    nchw = xt.permute(0, 3, 1, 2)
    again = bn_backward_sums(effnetv2.channels_last(nchw),
                             dyt.reshape(B, H, W, C), _t(mean), _t(inv_std))
    assert torch.equal(again[0], s1) and torch.equal(again[1], s2)
    ref = bn_backward_sums_reference(xt, dyt, _t(mean), _t(inv_std))
    assert torch.equal(ref[1], s2)
    with pytest.raises(ValueError, match="bn_backward_sums"):
        bn_backward_sums(xt, dyt[:1], _t(mean), _t(inv_std))


# ------------------------------------------------- the launch plans ----

@pytest.mark.parametrize("rows,C,vec", [
    (128 * 14 * 14, 640, 4), (128 * 14 * 14, 1056, 4), (128 * 49, 1824, 4),
    (128 * 49, 3072, 4), (128 * 112 * 112, 24, 8), (128 * 56 * 56, 48, 8),
    (128 * 49, 304, 8), (25088, 176, 4), (1, 1, 1), (37, 33, 1), (5, 1000, 1),
    (3, 12, 4),
])
def test_channel_plan_covers_the_map_once(rows, C, vec):
    p = tiling.channel_plan(rows, C, vec, 8 * 132)
    assert p.lanes * p.row_groups <= tiling.MAX_THREADS
    assert p.lanes <= tiling.MAX_LANES
    assert p.ctiles * p.lanes * p.vec >= C            # every channel owned
    assert (p.ctiles - 1) * p.lanes * p.vec < C       # no empty channel tile
    assert p.nrb * p.rows_per_block >= rows           # every row owned
    assert (p.nrb - 1) * p.rows_per_block < rows      # no empty row block
    assert p.rows_per_block % p.row_groups == 0
    if rows * C > 1 << 20:  # a real map fills the card
        assert p.ctiles * p.nrb >= 132


def test_vector_width_needs_divisible_channels_and_aligned_rows():
    x = torch.zeros(4, 64)
    assert tiling.vector_width(64, 4, x) == 4
    assert tiling.vector_width(66, 4, x) == 1
    assert tiling.vector_width(64, 4, x, x.view(-1)[1:]) == 1
    with pytest.raises(ValueError, match="dense"):
        tiling.require_dense("k", x.t())
    with pytest.raises(ValueError, match="empty"):
        tiling.channel_plan(0, 4, 1, 8)


def test_laid_out_as_compares_strides_of_the_axes_that_count():
    x = torch.zeros(2, 5, 5, 8).permute(0, 3, 1, 2)   # channels last
    assert tiling.laid_out_as(torch.zeros_like(x), x)
    assert not tiling.laid_out_as(x.contiguous(), x)  # the same map, NCHW
    assert not tiling.laid_out_as(x.expand(2, 8, 5, 5)[:, :4], x)
    assert not tiling.laid_out_as(torch.zeros(()).expand(2, 8, 5, 5), x)
    # an axis of length 1 has no stride to speak of
    one = torch.zeros(1, 5, 5, 8).permute(0, 3, 1, 2)
    assert tiling.laid_out_as(
        torch.zeros(5, 5, 8).permute(2, 0, 1).unsqueeze(0), one)


# ------------------------------------------------- BatchNorm and K4 ----

def test_batchnorm_from_k4_sums_is_batchnorm_of_the_map(rng):
    """In fp32 the statistics that K4 hands over are those the BatchNorm
    would reduce itself: output, gradients and running statistics agree."""
    B, K, C, H, W = 3, 8, 12, 5, 4
    x = _t(rng.normal(size=(B, K, H, W)) + 0.3)
    x = x.contiguous(memory_format=torch.channels_last)
    g = _t(rng.normal(size=(B, C, H, W)))
    outs = []
    for fused in (True, False):
        torch.manual_seed(0)
        conv = effnetv2.Conv2d(K, C, 1, bias=False)
        bn = effnetv2.BatchNorm2d(C).train()
        xin = x.clone().requires_grad_()
        y = (effnetv2.pointwise_bn(conv, bn, xin) if fused
             else bn(conv(xin)))
        (y * g).sum().backward()
        outs.append((y.detach(), xin.grad, conv.weight.grad, bn.weight.grad,
                     bn.bias.grad, bn.running_mean, bn.running_var))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    bn.eval()
    assert torch.equal(effnetv2.pointwise_bn(conv, bn, x), bn(conv(x)))


# ------------------------------------------------ blocks against Flax ----

def _fill(tree, rng):
    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            a = 1.0 + rng.normal(size=shape) * 0.1
        elif name in ("mean", "bias"):
            a = rng.normal(size=shape) * 0.1
        else:
            a = rng.normal(size=shape) * np.prod(shape[:-1]) ** -0.5
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.mark.parametrize("kind", ["mb", "mb_stride2", "fused", "fused_e1"])
def test_training_block_matches_flax(rng, kind):
    """Output, every parameter's gradient, the input's gradient and both
    running statistics of every BatchNorm after one training-mode call."""
    B, S, in_ch = 3, 6, 8
    if kind.startswith("mb"):
        stride = 2 if kind == "mb_stride2" else 1
        jblock = jax_effnet.MBConv(8, 3, stride, 4, 0.25)
        block = effnetv2.MBConv(in_ch, 8, 3, stride, 4, 0.25)
    else:
        expand = 1 if kind == "fused_e1" else 4
        jblock = jax_effnet.FusedMBConv(8, 3, 1, expand)
        block = effnetv2.FusedMBConv(in_ch, 8, 3, 1, expand)
    x = rng.normal(size=(B, S, S, in_ch)).astype(np.float32)
    shapes = jax.eval_shape(lambda key, a: jblock.init(key, a, True),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    variables = _fill(shapes, rng)
    out_s = -(-S // (2 if kind == "mb_stride2" else 1))
    g = rng.normal(size=(B, out_s, out_s, 8)).astype(np.float32)

    def f(params, xin):
        y, mut = jblock.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, xin,
            True, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mut["batch_stats"])

    (_, (want_y, want_stats)), (want_gp, want_gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))

    block.load_state_dict(bridge.to_state_dict(variables, block), strict=True)
    block.train()
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_()
    y = block(xt)
    (y * _t(g).permute(0, 3, 1, 2)).sum().backward()

    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(), err_msg=what)

    close(_np(y.permute(0, 2, 3, 1)), want_y, "output")
    close(_np(xt.grad.permute(0, 2, 3, 1)), want_gx, "input gradient")
    got_gp = bridge.grads_to_flax(block)
    flat_want = bridge._flatten(want_gp)
    flat_got = bridge._flatten(got_gp)
    assert flat_got.keys() == flat_want.keys()
    for path, want in flat_want.items():
        close(flat_got[path], want, "/".join(path))
    got_stats = bridge._flatten(
        bridge.to_flax(block.state_dict(), block)["batch_stats"])
    flat_stats = bridge._flatten(want_stats)
    assert got_stats.keys() == flat_stats.keys() and len(flat_stats) >= 2
    for path, want in flat_stats.items():
        close(got_stats[path], want, "/".join(path))
