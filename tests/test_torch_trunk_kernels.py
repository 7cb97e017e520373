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

import functools

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
    SMEM_LIMIT,
    TMA_TILE_M,
    conv1x1_stats,
    conv1x1_stats_reference,
    launch_plan,
    takes_tma,
    tf32_plan,
    tma_plan,
)
from mmvqa_tpu_torch.ops.depthwise import (
    depthwise3x3,
    depthwise3x3_backward_reference,
    depthwise3x3_reference,
)

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)


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
    """Blocks along the rows of the bf16 mma.sync kernel and of the fp32
    kernel: at least one, no more than the row tiles."""
    if dtype == torch.bfloat16:
        nrb, tile_m = launch_plan(N, K, C, 132), 128
    else:
        plan = tf32_plan(N, K, C, 132)
        nrb, tile_m = plan.nrb, plan.bm
    assert 1 <= nrb <= -(-N // tile_m)
    with pytest.raises(ValueError, match="empty"):
        (launch_plan(0, K, C, 132) if dtype == torch.bfloat16
         else tf32_plan(0, K, C, 132))


# (N / B, K, C) of the flagship trunk's 18 K4 site shapes (chip_smoke.py::
# trunk_sites)
K4_SITES = [(49, 304, 1824), (49, 512, 3072), (49, 1056, 304),
            (49, 1824, 304), (49, 1824, 512), (49, 3072, 512),
            (196, 160, 640), (196, 160, 960), (196, 176, 1056),
            (196, 320, 160), (196, 640, 160), (196, 960, 176),
            (196, 1056, 176), (784, 80, 320), (784, 192, 80),
            (784, 320, 80), (3136, 96, 48), (3136, 192, 48)]


@pytest.mark.parametrize("rows,K,C", K4_SITES)
def test_conv1x1_stats_tma_plan_at_the_trunk_shapes(rows, K, C):
    """Every trunk site takes the TMA path (x and w as the trunk hands them
    over, ``models/effnetv2.py::pointwise_bn``), at the train batch and at
    the fp32 check's; the plan, walked block by block for cards of 114 and
    132 SMs, puts every (row, column) in exactly one tile: the column tiles
    cover C, the blocks of a column tile take the row tiles in turn, none
    twice, none empty; the column tile is a width wgmma takes (a multiple
    of 8 up to 256), at the train batch one tile wherever C <= 192 (every
    trunk C up to 176); the ring has 4 to 6 stages and fits a block's shared
    memory."""
    x = torch.empty(8, K, dtype=torch.bfloat16)
    w = torch.empty(C, K, dtype=torch.bfloat16).t()
    assert takes_tma(x, w)
    for B in (128, 8):
        N = B * rows
        for sms in (114, 132):
            plan = tma_plan(N, K, C, sms)
            assert plan.bn % 8 == 0 and 8 <= plan.bn <= 256
            if B == 128:
                assert (plan.bn >= C) == (C <= 192)
            assert 4 <= plan.stages <= 6 and plan.smem <= SMEM_LIMIT
            ctiles = -(-C // plan.bn)
            assert ctiles * plan.bn - C < plan.bn  # no empty column tile
            mtiles = -(-N // TMA_TILE_M)
            assert 1 <= plan.nrb <= mtiles
            assert ctiles * plan.nrb <= max(sms, ctiles)
            seen = []
            for r in range(plan.nrb):
                mine = list(range(r, mtiles, plan.nrb))
                assert mine  # not empty
                seen += mine
            assert sorted(seen) == list(range(mtiles))


def test_conv1x1_stats_other_bf16_shapes_take_the_mma_sync_path():
    """The TMA path is chosen by shape and alignment alone: K or C no
    multiple of 8, a dense (K, C) w (not K-major), a w whose columns are
    no multiple of 8 apart, x or w off a 16-byte boundary, and fp32 all take
    the other kernels."""
    def wt(C, K, dtype=torch.bfloat16):
        return torch.empty(C, K, dtype=dtype).t()

    x = torch.empty(64, 176, dtype=torch.bfloat16)
    assert takes_tma(x, wt(304, 176))
    assert not takes_tma(torch.empty(64, 35, dtype=torch.bfloat16),
                         wt(304, 35))
    assert not takes_tma(x, wt(77, 176))
    assert not takes_tma(x, torch.empty(176, 304, dtype=torch.bfloat16))
    # the (296, 176) weight inside rows of 180: columns 180 apart
    assert not takes_tma(x, torch.empty(296, 180, dtype=torch.bfloat16)
                         [:, :176].t())
    flat = torch.empty(64 * 176 + 1, dtype=torch.bfloat16)
    assert not takes_tma(flat[1:].view(64, 176), wt(304, 176))
    wflat = torch.empty(304 * 176 + 8, dtype=torch.bfloat16)
    assert not takes_tma(x, wflat[1:304 * 176 + 1].view(304, 176).t())
    assert not takes_tma(x.float(), wt(304, 176, torch.float32))


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


# K5's sites in a train step, (N / B, C) -> count (chip_smoke.py::trunk_sites)
K5_SITES = {(49, 304): 18, (49, 512): 5, (49, 1056): 1, (49, 1824): 36,
            (49, 3072): 8, (196, 160): 7, (196, 176): 14, (196, 320): 1,
            (196, 640): 12, (196, 960): 2, (196, 1056): 27, (784, 80): 5,
            (784, 192): 1, (784, 320): 5, (3136, 48): 5, (3136, 96): 1,
            (3136, 192): 4, (12544, 24): 4}
SMS = 132


def _last_blocks(plan, rng):
    """The blocks of each channel tile arrive at its counter in a random
    order; atomicInc(counter, nrb - 1) returns the count before it and wraps
    to 0 after the nrb-th. Returns, per tile, the blocks that saw nrb - 1,
    and the counters afterwards."""
    counters = np.zeros(plan.ctiles, np.int64)
    last = [[] for _ in range(plan.ctiles)]
    arrivals = [(x, y) for x in range(plan.ctiles) for y in range(plan.nrb)]
    for i in rng.permutation(len(arrivals)):
        x, y = arrivals[i]
        old = counters[x]
        counters[x] = 0 if old >= plan.nrb - 1 else old + 1
        if old == plan.nrb - 1:
            last[x].append(y)
    return last, counters


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("rows,C", sorted(K5_SITES))
def test_bn_sums_plan_at_every_trunk_site(rng, rows, C, itemsize):
    """At B=128 and 1-16 blocks an SM: every row and channel owned once, one
    wave of blocks that fills the card, a narrow map's block filled with
    row groups, and one last block a channel tile, after which its counter
    is back at 0."""
    N = 128 * rows
    vec = 16 // itemsize if C % (16 // itemsize) == 0 else 1
    draft = tiling.channel_plan(N, C, vec, 1)
    for slots in range(1, 17):
        p = tiling.channel_plan(N, C, vec, slots * SMS)
        # the block's shape is the draft's: asked of the card before planning
        assert (p.lanes, p.row_groups) == (draft.lanes, draft.row_groups)
        assert p.lanes * p.row_groups <= tiling.MAX_THREADS
        assert p.lanes * p.row_groups > tiling.MAX_THREADS // 2
        assert (p.ctiles * p.lanes * p.vec >= C
                > (p.ctiles - 1) * p.lanes * p.vec)
        assert p.nrb * p.rows_per_block >= N > (p.nrb - 1) * p.rows_per_block
        assert p.rows_per_block % p.row_groups == 0
        assert p.ctiles * p.nrb <= slots * SMS          # one wave
        # that fills the card, or a row a thread
        assert (p.ctiles * p.nrb > slots * SMS // 2
                or p.rows_per_block == p.row_groups)
        last, counters = _last_blocks(p, rng)
        assert all(len(blocks) == 1 for blocks in last)
        assert not counters.any()


def _emulated_k5(x, dy, mean, inv_std, plan):
    """csrc/bn_backward_sums.cu's order of fp32 sums under ``plan``: thread
    (lane, group) of row block b walks rows b * rows_per_block + group,
    + row_groups, ... in order; the block adds its row groups in order into
    its partial; the last block's thread of row group g adds partials g,
    g + row_groups, ... in order, then the row groups in order."""
    C = x.shape[-1]
    xf, d = x.reshape(-1, C).float(), dy.reshape(-1, C).float()
    terms = torch.stack([d, d * ((xf - mean) * inv_std)])     # (2, N, C)
    groups, rpb, nrb = plan.row_groups, plan.rows_per_block, plan.nrb
    padded = torch.zeros(2, nrb * rpb, C)
    padded[:, :terms.shape[1]] = terms
    steps = padded.view(2, nrb, rpb // groups, groups, C)
    per_thread = torch.zeros(2, nrb, groups, C)
    for k in range(rpb // groups):
        per_thread += steps[:, :, k]
    partial = torch.zeros(2, nrb, C)
    for g in range(groups):
        partial += per_thread[:, :, g]
    per_group = torch.zeros(2, groups, C)
    for j in range(nrb):
        per_group[:, j % groups] += partial[:, j]
    out = torch.zeros(2, C)
    for g in range(groups):
        out += per_group[:, g]
    return out[0], out[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slots", [1, 3, 16])
def test_bn_sums_block_order_matches_flax_and_the_plain_version(rng, dtype,
                                                                slots):
    """The kernel's block-order sums, on the data of
    test_bn_backward_sums_match_flax_and_the_probe and on a map of many row
    blocks, against the plain version (1e-5 of the largest entry) and the
    Flax BatchNorm's gradients (1e-4, that test's bound)."""
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
    tdtype = getattr(torch, dtype)
    xt = _t(np.asarray(jx, np.float32), tdtype)
    dyt = _t(np.asarray(jdy, np.float32), tdtype)
    vec = 16 // xt.element_size()
    plan = tiling.channel_plan(B * H * W, C, vec, slots * SMS)
    s1, s2 = _emulated_k5(xt, dyt, _t(mean), _t(inv_std), plan)
    p1, p2 = bn_backward_sums_reference(xt, dyt, _t(mean), _t(inv_std))
    for got, flax_grad, plain in ((s1, want["bias"], p1),
                                  (s2, want["scale"], p2)):
        scale = np.abs(np.asarray(flax_grad)).max()
        assert np.abs(_np(got) - np.asarray(flax_grad)).max() <= 1e-4 * scale
        assert np.abs(_np(got) - _np(plain)).max() <= 1e-5 * scale
    # a map of many row blocks and a ragged last block
    N, C = 9001, 40
    x = torch.from_numpy(rng.normal(size=(N, C)).astype(np.float32) * 2 + 1)
    dy = torch.from_numpy(rng.normal(size=(N, C)).astype(np.float32))
    x, dy = x.to(tdtype), dy.to(tdtype)
    m = torch.from_numpy(rng.normal(size=C).astype(np.float32))
    inv = torch.from_numpy(rng.uniform(1, 2, size=C).astype(np.float32))
    plan = tiling.channel_plan(N, C, vec, slots * SMS)
    assert plan.nrb > 1
    for got, want_ in zip(_emulated_k5(x, dy, m, inv, plan),
                          bn_backward_sums_reference(x, dy, m, inv)):
        assert (got - want_).abs().max() <= 1e-5 * want_.abs().max()


# K3's halo-tile plan: the five stride-1 site shapes of the flagship trunk at
# the train, eval and fp32-check batches, and ragged shapes (channel counts
# whose rows are not 16 bytes, planes that are cut into strips or are
# narrower than the stencil)
K3_SITES = [(14, 14, 640), (14, 14, 960), (14, 14, 1056), (7, 7, 1824),
            (7, 7, 3072)]
K3_PLAN_CASES = ([(B, *site) for B in (128, 16, 8) for site in K3_SITES]
                 + [(2, H, W, C) for H, W in ((112, 112), (56, 56), (5, 3))
                    for C in (24, 36, 100)])
SMS = 132


SLOTS = [1, 2, 4, 8, 16]  # blocks an SM holds, as the card's occupancy query says


def _k3_stages(plan, B, H, W, C):
    """Every stage of every block as the kernels take them, as arrays in
    launch order: channel tile, partial index, c0, h0, w0, first image,
    rows."""
    ctiles, gy, gz = tiling.depthwise_grid(plan, C)
    x, z, y, st = (a.ravel() for a in np.meshgrid(
        np.arange(ctiles), np.arange(gz), np.arange(gy),
        np.arange(plan.steps), indexing="ij"))
    h0 = (y // plan.ncol) * plan.s
    w0 = (y % plan.ncol) * plan.tw
    return (x, z * gy + y, x * plan.ct, h0, w0,
            (z * plan.steps + st) * plan.p, np.minimum(plan.s, H - h0))


def _k3_blocks(plan, B, H, W, C):
    """The stages of _k3_stages one at a time, as Python ints."""
    return zip(*(a.tolist() for a in _k3_stages(plan, B, H, W, C)))


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("B,H,W,C", K3_PLAN_CASES)
def test_depthwise_plan_covers_every_output_once(B, H, W, C, itemsize,
                                                 backward, slots):
    aligned = (C * itemsize) % 16 == 0
    plan = tiling.depthwise_plan(B, H, W, C, itemsize, SMS, backward, aligned,
                                 slots=slots)
    ctiles, gy, gz = tiling.depthwise_grid(plan, C)
    lanes = plan.ct // plan.vec
    # a block's threads: lanes x columns x images of a stage
    assert plan.threads == lanes * plan.tw * plan.p <= tiling.DW_MAX_THREADS
    assert plan.ct % (16 // itemsize) == 0 and lanes * plan.vec == plan.ct
    # 16-byte copies and vectors only where C allows them
    assert plan.copy == (tiling.COPY_TMA if aligned else tiling.COPY_ELEMENTS)
    assert plan.vec * itemsize <= 16
    # threads and shared memory do not depend on slots: the wrapper plans,
    # asks the card how many such blocks an SM holds, and plans again
    draft = tiling.depthwise_plan(B, H, W, C, itemsize, SMS, backward, aligned)
    assert (plan.threads, plan.smem) == (draft.threads, draft.smem)
    x, part, c0, h0, w0, b0, rows = _k3_stages(plan, B, H, W, C)
    assert (c0 < C).all() and (h0 < H).all() and (w0 < W).all()
    assert (rows >= 1).all() and (rows <= plan.s).all()
    # the halo box, rows [h0 - 1, h0 + s + 1) and columns
    # [w0 - 1, w0 + tw + 1), holds the 3 x 3 neighbourhood of every output
    # of the stage and fits the tensor map's box limits; what of it lies
    # outside the plane is zero-filled (_stage below models it)
    assert max(plan.tw + 2, plan.s + 2, plan.p, plan.ct) <= tiling.MAX_BOX
    # every (b, h, w) of every channel tile written once (images beyond B
    # and columns beyond W are not stored: a block's last stages may hold
    # none); no block without a position
    b = b0[:, None, None, None] + np.arange(plan.p)[:, None, None]
    i = np.arange(plan.s)[:, None]
    h = h0[:, None, None, None] + i
    w = w0[:, None, None, None] + np.arange(plan.tw)
    keep = (b < B) & (i < rows[:, None, None, None]) & (w < W)
    flat = ((b * H + h) * W + w) * ctiles + x[:, None, None, None]
    seen = np.bincount(np.broadcast_to(flat, keep.shape)[keep],
                       minlength=B * H * W * ctiles)
    assert (seen == 1).all()
    stored = np.zeros((ctiles, tiling.depthwise_partials(plan)), bool)
    np.logical_or.at(stored, (x, part), keep.reshape(len(b0), -1).any(1))
    assert stored.all()
    # the backward's (9, C) partials: one a block of each channel tile
    nparts = tiling.depthwise_partials(plan)
    assert part.min() == 0 and part.max() == nparts - 1
    assert len(np.unique(x * nparts + part)) == ctiles * nparts
    # shared memory: what the kernels lay out, within the card's limit
    pos = plan.ct * itemsize
    halo = -(-plan.p * (plan.s + 2) * (plan.tw + 2) * pos // 128) * 128
    centre = -(-plan.p * plan.s * plan.tw * pos // 128) * 128
    stage = halo + (centre if backward else 0)
    red = -(-plan.threads * plan.vec * 4 // 128) * 128 if backward else 0
    assert plan.smem == max(2 * stage, red) + 9 * plan.ct * 4 + 32
    assert plan.smem <= tiling.SMEM_LIMIT
    # the flagship shapes give the card at least two blocks a multiprocessor
    if (H, W, C) in K3_SITES:
        assert ctiles * gy * gz >= 2 * SMS


def _stage(a, b0, h0, w0, c0, p, rows, cols, ct):
    """The (p, rows, cols, ct) box of ``a`` that starts at (b0, h0, w0, c0),
    zeros where it leaves the map: what TMA's out-of-bounds fill and the
    other copies' zero-fill give."""
    B, H, W, C = a.shape
    out = np.zeros((p, rows, cols, ct), a.dtype)
    lo = [max(0, -v) for v in (b0, h0, w0, c0)]
    hi = [min(n, dim - v) for n, dim, v in zip((p, rows, cols, ct),
                                                 (B, H, W, C),
                                                 (b0, h0, w0, c0))]
    if all(h > l for l, h in zip(lo, hi)):
        out[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2], lo[3]:hi[3]] = a[
            b0 + lo[0]:b0 + hi[0], h0 + lo[1]:h0 + hi[1],
            w0 + lo[2]:w0 + hi[2], c0 + lo[3]:c0 + hi[3]]
    return out


def _emulate_k3(plan, x, k, dy=None):
    """The kernels' arithmetic in float64, block by block and stage by stage
    through the plan: a column's window d_a[j] = map[h - 1 + a, w - 1 + j]
    pairs with tap (a, j) forward and (2 - a, 2 - j) backward; dW as one
    partial a block, added in partial order."""
    B, H, W, C = x.shape
    k9 = np.zeros((9, -(-C // plan.ct) * plan.ct))
    k9[:, :C] = k.reshape(9, C)
    out = np.zeros_like(x)
    parts = np.zeros((tiling.depthwise_partials(plan), 9, k9.shape[1]))
    for _, part, c0, h0, w0, b0, rows in _k3_blocks(plan, B, H, W, C):
        tile = _stage(x if dy is None else dy, b0, h0 - 1, w0 - 1, c0, plan.p,
                      plan.s + 2, plan.tw + 2, plan.ct)
        kt = k9[:, c0:c0 + plan.ct]
        res = np.zeros((plan.p, rows, plan.tw, plan.ct))
        if dy is not None:
            xc = _stage(x, b0, h0, w0, c0, plan.p, plan.s, plan.tw,
                        plan.ct)[:, :rows]
        for a in range(3):
            for j in range(3):
                win = tile[:, a:a + rows, j:j + plan.tw]
                t = a * 3 + j if dy is None else (2 - a) * 3 + (2 - j)
                res += win * kt[t]
                if dy is not None:
                    parts[part, t, c0:c0 + plan.ct] += (xc * win).sum((0, 1, 2))
        nb = min(plan.p, B - b0)
        nw = min(plan.tw, W - w0)
        nc = min(plan.ct, C - c0)
        if nb > 0:
            out[b0:b0 + nb, h0:h0 + rows, w0:w0 + nw, c0:c0 + nc] = \
                res[:nb, :, :nw, :nc]
    if dy is None:
        return out
    return out, parts.sum(0)[:, :C].reshape(3, 3, C)


@pytest.mark.parametrize("B,H,W,C", [
    (3, 14, 14, 72), (5, 7, 7, 40), (2, 5, 3, 24), (2, 5, 3, 36),
    (1, 56, 56, 100), (1, 112, 112, 24),
])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("slots", SLOTS)
def test_depthwise_plan_emulated_matches_the_plain_versions(B, H, W, C,
                                                            itemsize, slots):
    """The plan's halo tiles, with their zero fill, give the plain
    convolution and its gradients (any misplaced tap or position would be
    off by O(1)); a card of 4 multiprocessors makes the plan cut strips,
    images and stages at these small shapes, and ``slots`` changes the
    stages a block walks and so the partials and their order."""
    x, k, dy, y_p, dx_p, dw_p = _k3_case(B, H, W, C)
    aligned = (C * itemsize) % 16 == 0
    fwd = tiling.depthwise_plan(B, H, W, C, itemsize, 4, False, aligned,
                                slots=slots)
    bwd = tiling.depthwise_plan(B, H, W, C, itemsize, 4, True, aligned,
                                slots=slots)
    np.testing.assert_allclose(_emulate_k3(fwd, x, k), y_p,
                               rtol=1e-12, atol=1e-12)
    # the plain backward sums in fp32: dW over up to 12544 positions, to
    # 1e-5 of its largest entry
    dx, dw = _emulate_k3(bwd, x, k, dy)
    np.testing.assert_allclose(dx, dx_p, rtol=1e-5, atol=1e-5)
    assert np.abs(dw - dw_p).max() <= 1e-5 * np.abs(dw_p).max()


@functools.lru_cache(maxsize=None)
def _k3_case(B, H, W, C):
    """Inputs from seed 0 and the plain versions' outputs, in float64: one
    shape's cases share them."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, H, W, C))
    k = rng.normal(size=(3, 3, C))
    dy = rng.normal(size=(B, H, W, C))
    xt, kt, dyt = (torch.from_numpy(a) for a in (x, k, dy))
    dx_p, dw_p = (a.double().numpy()
                  for a in depthwise3x3_backward_reference(xt, kt, dyt))
    return x, k, dy, depthwise3x3_reference(xt, kt).numpy(), dx_p, dw_p


def test_depthwise_plan_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="empty"):
        tiling.depthwise_plan(0, 14, 14, 64, 2, SMS)
    with pytest.raises(ValueError, match="cannot tile"):
        tiling.depthwise_plan(1, 3000, 100000, 64, 2, SMS)  # > 65535 tiles
    # a position that no 16-byte copy can start: C = 36 bf16 is 72 bytes,
    # so its stages arrive by element copies
    x = torch.zeros(2, 5, 5, 36, dtype=torch.bfloat16)
    assert not tiling.sixteen_byte_rows(36, x)
    assert tiling.sixteen_byte_rows(64, x.new_zeros(2, 5, 5, 64))
    assert not tiling.sixteen_byte_rows(64, x.new_zeros(2 * 5 * 5 * 64 + 1)[1:])
    assert tiling.depthwise_plan(2, 5, 5, 36, 2, SMS, aligned=False).copy == \
        tiling.COPY_ELEMENTS


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

    def f(params, xin, stats, gy):
        y, mut = jblock.apply({"params": params, "batch_stats": stats}, xin,
                              True, mutable=["batch_stats"])
        return jnp.sum(y * gy), (y, mut["batch_stats"])

    # one compiled program, as the JAX package's steps run it
    (_, (want_y, want_stats)), (want_gp, want_gx) = jax.jit(
        jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
            variables["params"], jnp.asarray(x), variables["batch_stats"], g)

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
