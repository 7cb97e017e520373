"""The training half of mmvqa_tpu_torch against the JAX package, on the CPU in
fp32 at tiny sizes: the backward of the two kernels' wrappers (the plain
versions, which is what a CPU tensor takes), the MLM loss, training-mode
BatchNorm, dropout, Adam, and the MLM train step as a whole from bridged
weights. The same numpy inputs go through both packages; the JAX token head
runs its Pallas kernels in interpret mode, as tests/test_token_head.py runs
them, and the JAX attention takes its XLA path.
"""

import copy
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as nn

from mmvqa_tpu.data.images import AugmentSpec as JaxAugmentSpec
from mmvqa_tpu.models.mmbert import MMBert as JaxMMBert
from mmvqa_tpu.ops import losses as jax_losses
from mmvqa_tpu.ops.attention import realformer_attention as jax_attention
from mmvqa_tpu.ops.pallas_token_head import (
    _bwd_call as jax_token_head_bwd_kernel,
    fused_token_head as jax_fused_token_head,
)
from mmvqa_tpu.train import steps as jax_steps
from mmvqa_tpu.train.state import create_train_state as jax_create_train_state

from mmvqa_tpu_torch import bridge
from mmvqa_tpu_torch.data.images import AugmentSpec
from mmvqa_tpu_torch.data.synthetic import mlm_batches
from mmvqa_tpu_torch.models import MMBert
from mmvqa_tpu_torch.models.effnetv2 import BatchNorm2d
from mmvqa_tpu_torch.models.layers import Dropout, DropoutRng
from mmvqa_tpu_torch.models.mmbert import compute_dtype_of
from mmvqa_tpu_torch.ops import losses
from mmvqa_tpu_torch.ops.attention import (
    realformer_attention,
    realformer_attention_backward_reference,
    realformer_attention_packed,
    realformer_attention_reference,
)
from mmvqa_tpu_torch.ops.token_head import (
    SMEM_LIMIT,
    _act_grad,
    FP32_ROWS,
    FP32_TILES,
    backward_plan,
    backward_scratch,
    backward_tile,
    fp32_tiles_items,
    fused_token_head,
    token_head_backward_reference,
    token_head_reference,
)
from mmvqa_tpu_torch.train.state import create_train_state
from mmvqa_tpu_torch.train.steps import make_mlm_steps
from mmvqa_tpu_torch.train.trainer import mlm_epoch

from test_torch_bridge import configs, jax_variables
from test_torch_cuda import _backward_keeping_gact_fp32

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a)).requires_grad_(grad)


# ---------------------------------------------------------------- K1 ----

@pytest.mark.parametrize("act", ["serf", "serf_fast", "relu"])
def test_token_head_grads_match_jax(rng, act):
    B, P, K, C = 2, 700, 24, 64  # a padded position tail
    x = rng.normal(size=(B, P, K)).astype(np.float32)
    w = (rng.normal(size=(K, C)) * 0.1).astype(np.float32)
    g = rng.normal(size=(B, C)).astype(np.float32)
    want_dx, want_dw = jax.grad(
        lambda x, w: jnp.sum(jax_fused_token_head(x, w, act) * g),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))

    xt, wt = _t(x, True), _t(w, True)
    before = fused_token_head.backward_launches
    (fused_token_head(xt, wt, act) * _t(g)).sum().backward()
    assert fused_token_head.backward_launches == before  # CPU: plain version
    # tests/test_token_head.py's gradient tolerances
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("act", ["serf", "serf_fast", "relu"])
def test_token_head_backward_reference_is_the_gradient_of_the_reference(
        rng, act):
    """The written-out backward (what the CUDA kernel is held against)
    equals autograd through the plain forward, strided input included."""
    B, P, K, C = 3, 37, 5, 11
    x = _t(rng.normal(size=(B, K, P)).astype(np.float32)).transpose(1, 2)
    x.requires_grad_()
    w = _t((rng.normal(size=(K, C)) * 0.5).astype(np.float32), True)
    g = _t(rng.normal(size=(B, C)).astype(np.float32))
    (token_head_reference(x, w, act) * g).sum().backward()
    dx, dw = token_head_backward_reference(x.detach(), w.detach(), g, act)
    torch.testing.assert_close(dx, x.grad, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(dw, w.grad, rtol=1e-5, atol=1e-6)


def test_token_head_hands_the_fp32_master_an_fp32_gradient(rng):
    """bf16 x with the fp32 master weight: the forward takes the weight's
    bf16 cast, dW reaches the master in fp32 without a round trip through
    bf16, and dx is bf16."""
    B, P, K, C = 2, 50, 8, 16
    x = _t(rng.normal(size=(B, P, K)).astype(np.float32)).bfloat16()
    x.requires_grad_()
    w = _t((rng.normal(size=(K, C)) * 0.3).astype(np.float32), True)
    g = _t(rng.normal(size=(B, C)).astype(np.float32))
    out = fused_token_head(x, w, "serf_fast")
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(
        out, token_head_reference(x.detach(), w.detach().bfloat16(),
                                  "serf_fast"), rtol=0, atol=0)
    (out.float() * g).sum().backward()
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    _, dw = token_head_backward_reference(
        x.detach(), w.detach().bfloat16(), g.bfloat16().float(), "serf_fast")
    torch.testing.assert_close(w.grad, dw, rtol=0, atol=0)
    assert not torch.equal(w.grad, w.grad.bfloat16().float())


@pytest.mark.parametrize("act", ["serf", "serf_fast", "relu"])
def test_token_head_bf16_backward_matches_the_reference_kernel(rng, act):
    """bf16 inputs: the port's plain backward (what a CPU tensor takes and
    what the card's kernel is held against) against the TPU kernel's
    backward in interpret mode. Both take gact in fp32, round it to bf16 and
    sum the two products in fp32, so dx agrees to the bf16 rounding of one
    fp32 value (two ulps, 8e-3 relative; the absolute term 1e-3 of the
    largest entry, for entries near 0 summed in another order) and dW, a sum
    of 1400 products of the same bf16 operands, to 5e-5 of its largest entry:
    gact's bf16 rounding lands on the other side where the two act'(s)
    differ in their last fp32 bits, most under SERF, whose erf the reference
    takes from a rational approximation (pallas_token_head.py:_erf_approx;
    measured 1.4e-5, and 2.5e-7 for serf_fast and relu). A plain version
    that kept gact in fp32 misses both: dW by 6e-4 to 1.9e-3 of its largest
    entry, dx beyond two ulps at 0.02-0.2% of its entries."""
    B, P, K, C = 2, 700, 24, 64  # a padded position tail, as above
    x = rng.normal(size=(B, P, K)).astype(np.float32)
    w = (rng.normal(size=(K, C)) * 0.1).astype(np.float32)
    g = rng.normal(size=(B, C)).astype(np.float32)
    want_dx, want_dw = jax_token_head_bwd_kernel(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(g), act)
    want_dx = np.asarray(want_dx.astype(jnp.float32))
    want_dw = np.asarray(want_dw)
    dx, dw = token_head_backward_reference(
        _t(x).bfloat16(), _t(w).bfloat16(), _t(g), act)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    np.testing.assert_allclose(dx.float().numpy(), want_dx, rtol=8e-3,
                               atol=1e-3 * np.abs(want_dx).max())
    np.testing.assert_allclose(dw.numpy(), want_dw, rtol=0,
                               atol=5e-5 * np.abs(want_dw).max())
    _, dw_f = _backward_keeping_gact_fp32(
        _t(x).bfloat16(), _t(w).bfloat16(), _t(g), act)
    assert np.abs(dw_f.numpy() - want_dw).max() > 5e-5 * np.abs(want_dw).max()


@pytest.mark.parametrize("P,K", [(14 * 14, 176), (7 * 7, 512), (14 * 14, 1024),
                                 (7 * 7, 2048)])
def test_token_head_bf16_dw_moves_with_the_order_of_s(rng, P, K):
    """Why bf16 dW is held on the card at long sums to 1e-3 of its largest
    entry (tests/test_torch_cuda.py, chip_smoke.py's ATOL_K1_BWD_DW_BF16):
    kernel and plain version sum s in other orders, and a last-bit
    difference of s can move gact's bf16 rounding by an ulp. The plain
    version with s summed in fp64 instead of fp32 moves dW by up to half
    that limit (read 5.1e-5 to 1.7e-4 of its largest entry). Keeping gact
    in fp32 moves it further (read 1.0e-3 to 1.9e-3), but not always beyond
    the limit: that the kernel rounds gact is held at a short sum instead
    (tests/test_torch_cuda.py::
    test_token_head_bf16_backward_rounds_gact_as_the_plain_version). B=16
    and the widths of the wide taps, SERF's bf16 polynomial."""
    B, C = 16, 768
    x = _t(rng.normal(size=(B, P, K)).astype(np.float32)).bfloat16()
    w = _t((rng.normal(size=(K, C)) * K ** -0.5).astype(np.float32)).bfloat16()
    g = _t(rng.normal(size=(B, C)).astype(np.float32))
    _, dw = token_head_backward_reference(x, w, g, "serf_fast")
    s = torch.einsum("bpk,kc->bpc", x.double(), w.double()).float()
    gact = (_act_grad(s, "serf_fast") * (g / P)[:, None, :]).bfloat16()
    dw_s64 = torch.einsum("bpk,bpc->kc", x.float(), gact.float())
    _, dw_f = _backward_keeping_gact_fp32(x, w, g, "serf_fast")
    scale = dw.abs().max().item()
    order = (dw_s64 - dw).abs().max().item()
    assert order <= 5e-4 * scale
    assert (dw_f - dw).abs().max().item() > 2 * order


@pytest.mark.parametrize("P,K", [(49, 2048), (196, 2048), (49, 1024),
                                 (196, 1024)])
def test_token_head_grads_match_jax_at_resnet_widths(rng, P, K):
    """K = 2048 and 1024, the ResNet-152 taps' channels
    (mmvqa_tpu/models/visual_tokens.py:10), which the backward kernel takes
    like any other K; fp32, tests/test_token_head.py's tolerances."""
    B, C = 1, 64
    x = rng.normal(size=(B, P, K)).astype(np.float32)
    w = (rng.normal(size=(K, C)) * K ** -0.5).astype(np.float32)
    g = rng.normal(size=(B, C)).astype(np.float32)
    want_dx, want_dw = jax.grad(
        lambda x, w: jnp.sum(jax_fused_token_head(x, w, "serf") * g),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x, True), _t(w, True)
    (fused_token_head(xt, wt, "serf") * _t(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw),
                               rtol=1e-4, atol=1e-4)


SM_COUNTS = (1, 114, 132)
TAP_SHAPES = ((112 * 112, 24), (56 * 56, 48), (28 * 28, 80), (14 * 14, 176),
              (7 * 7, 512))


@pytest.mark.parametrize("B,P,K", [
    *((B, P, K) for B in (128, 16) for P, K in TAP_SHAPES),
    (128, 14 * 14, 1024), (128, 7 * 7, 2048), (16, 14 * 14, 1024),
    (16, 7 * 7, 2048), (2, 700, 24), (1, 1, 1),
])
def test_token_head_backward_plan_covers_every_item(B, P, K):
    """The backward launch's share-out, walked block by block where the CPU
    can reach it, for both dtypes, the hidden sizes 768, 1024 and 2048,
    cards of 1, 114 and 132 SMs and 1, 2 or 3 blocks an SM (the wrapper asks
    the card how many): the row tiles of the B * P positions (each (batch
    row, position) once) go to the blocks in order, none twice and none left
    out; no block is empty; the blocks fit the card at once (the launch is
    cooperative); a block's shared memory fits an H100's 227 KB; and the
    partials, one (K, C) a block, are as many as the blocks. bf16 hands a
    block ``per_block`` consecutive tiles, fp32's rows mode deals them out
    evenly; fp32's tiles mode (K > 96) has no partial a block: its scratch
    is gact, (B * P, C), and the dW of each segment of the rows where there
    are several, and its blocks are no more than the larger phase's tiles."""
    N = B * P
    for itemsize in (2, 4):
        for C in (768, 1024, 2048):
            tp, mode, smem = backward_tile(K, C, itemsize)
            assert smem <= SMEM_LIMIT == 227 * 1024
            assert tp in ((32, 64) if itemsize == 4 else (64, 32, 16))
            for sms, slots in itertools.product(SM_COUNTS, (1, 2, 3)):
                plan = backward_plan(B, P, K, C, itemsize, sms, slots)
                assert (plan.tp, plan.mode, plan.smem) == (tp, mode, smem)
                assert plan.nblocks <= slots * sms
                tiles = -(-N // plan.tp)
                scratch = backward_scratch(plan, itemsize, B, P, K, C)
                if itemsize == 4 and mode == FP32_TILES:
                    r = plan.rsplit
                    assert 1 <= r <= -(-N // 1024)
                    assert scratch == (N * C + (r * K * C if r > 1 else 0),)
                    assert plan.nblocks == min(
                        max(fp32_tiles_items(N, K, C, r)), slots * sms)
                    continue
                assert plan.rsplit == 1
                assert scratch == (plan.nblocks, K, C)
                if itemsize == 4:
                    assert plan.nblocks == min(tiles, slots * sms)
                    ranges = [(j * tiles // plan.nblocks,
                               (j + 1) * tiles // plan.nblocks)
                              for j in range(plan.nblocks)]
                else:
                    assert plan.nblocks == -(-tiles // plan.per_block)
                    ranges = [(j * plan.per_block,
                               min(tiles, (j + 1) * plan.per_block))
                              for j in range(plan.nblocks)]
                covered = 0
                for lo, hi in ranges:
                    assert lo < hi  # not empty
                    first, last = lo * plan.tp, min(N, hi * plan.tp)
                    assert first == covered  # in order, no gap or overlap
                    covered = last
                assert covered == N
    with pytest.raises(ValueError, match="blocks an SM"):
        backward_plan(B, P, K, 768, 2, 132, 0)


def test_token_head_backward_plan_takes_any_k_and_refuses_only_too_wide_a_c():
    """bf16 parks 64 rows of gact for C up to 1024 (the reference's hidden
    768 and 1024), 32 rows up to 2176 (2048), 16 rows up to 4224; K never
    limits it, and W is resident beside gact for the narrow taps. fp32 takes
    the rows mode up to K = 96 (row tiles of 64 up to K = 32, of 32 above)
    and the tiles mode beyond, at any C."""
    for C, tp in ((768, 64), (1024, 64), (1025, 32), (2048, 32), (2176, 32),
                  (2177, 16), (4224, 16)):
        assert backward_tile(100000, C, 2)[:2] == (tp, 0)
    with pytest.raises(ValueError, match="16 rows of gact"):
        backward_tile(24, 4225, 2)
    for K, tp, mode in ((24, 64, 1), (48, 64, 1), (80, 32, 1), (176, 64, 0),
                        (512, 64, 0)):
        assert backward_tile(K, 768, 2)[:2] == (tp, mode)
    assert backward_tile(32, 768, 4)[:2] == (64, FP32_ROWS)
    assert backward_tile(33, 768, 4)[:2] == (32, FP32_ROWS)
    assert backward_tile(96, 768, 4)[:2] == (32, FP32_ROWS)
    assert backward_tile(97, 768, 4)[:2] == (64, FP32_TILES)
    for K, C in ((2048, 8192), (96, 8192), (24, 100000)):
        assert backward_tile(K, C, 4)[2] <= SMEM_LIMIT


# ---------------------------------------------------------------- K2 ----

@pytest.mark.parametrize("first_prev", [False, True])
def test_attention_grads_match_jax_over_a_two_layer_chain(rng, first_prev):
    """dq, dk, dv of both layers and dprev of the first, through a chain in
    which layer 2 takes layer 1's carry, with padded queries."""
    B, T, H, E = 2, 9, 3, 8
    kqv = [rng.normal(size=(B, T, H, 3 * E)).astype(np.float32)
           for _ in range(2)]
    prev0 = rng.normal(size=(B, H, T, T)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 6:] = 0.0
    g = [rng.normal(size=(B, T, H, E)).astype(np.float32) for _ in range(2)]
    g_carry = (rng.normal(size=(B, H, T, T)) * 0.1).astype(np.float32)

    def jax_loss(kqv0, kqv1, prev):
        # the XLA path's carry is (B, T, T, H)
        prev = jnp.transpose(prev, (0, 2, 3, 1)) if first_prev else None
        k, q, v = jnp.split(kqv0, 3, axis=-1)
        c1, p1 = jax_attention(q, k, v, prev, jnp.asarray(mask), impl="xla")
        k, q, v = jnp.split(kqv1, 3, axis=-1)
        c2, p2 = jax_attention(q, k, v, p1, jnp.asarray(mask), impl="xla")
        return (jnp.sum(c1 * g[0]) + jnp.sum(c2 * g[1])
                + jnp.sum(jnp.transpose(p2, (0, 3, 1, 2)) * g_carry))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(kqv[0]), jnp.asarray(kqv[1]), jnp.asarray(prev0))

    a, b, p0 = _t(kqv[0], True), _t(kqv[1], True), _t(prev0, True)
    c1, p1 = realformer_attention_packed(a, p0 if first_prev else None,
                                         _t(mask))
    c2, p2 = realformer_attention_packed(b, p1, _t(mask))
    ((c1 * _t(g[0])).sum() + (c2 * _t(g[1])).sum()
     + (p2 * _t(g_carry)).sum()).backward()
    # tests/test_pallas_attention.py:92
    tol = dict(rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want[0]), **tol)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(want[1]), **tol)
    if first_prev:
        np.testing.assert_allclose(p0.grad.numpy(), np.asarray(want[2]), **tol)
    else:
        assert p0.grad is None


def test_attention_backward_reference_is_the_gradient_of_the_reference(rng):
    """The written-out backward equals autograd through the plain forward;
    separate q, k, v go through the packed function and give the same; an
    output without a consumer costs no zeros."""
    B, T, H, E = 2, 7, 2, 4
    q, k, v = (_t(rng.normal(size=(B, T, H, E)).astype(np.float32), True)
               for _ in range(3))
    prev = _t(rng.normal(size=(B, H, T, T)).astype(np.float32), True)
    mask = torch.ones(B, T)
    mask[0, 5:] = 0.0
    dctx = _t(rng.normal(size=(B, T, H, E)).astype(np.float32))
    dcarry = _t(rng.normal(size=(B, H, T, T)).astype(np.float32))

    ctx, carry = realformer_attention_reference(q, k, v, prev, mask)
    ((ctx * dctx).sum() + (carry * dcarry).sum()).backward()
    want = [t.grad.clone() for t in (q, k, v, prev)]
    got = realformer_attention_backward_reference(
        q.detach(), k.detach(), v.detach(), carry.detach(), dctx, dcarry)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)

    for t in (q, k, v, prev):
        t.grad = None
    ctx, carry = realformer_attention(q, k, v, prev, mask)
    ((ctx * dctx).sum() + (carry * dcarry).sum()).backward()
    for t, b in zip((q, k, v, prev), want):
        torch.testing.assert_close(t.grad, b, rtol=1e-5, atol=1e-6)

    # only ctx consumed: the carry's gradient arrives as None
    for t in (q, k, v, prev):
        t.grad = None
    ctx, _ = realformer_attention(q, k, v, prev, mask)
    (ctx * dctx).sum().backward()
    only_ctx = realformer_attention_backward_reference(
        q.detach(), k.detach(), v.detach(), carry.detach(), dctx, None)
    for t, b in zip((q, k, v, prev), only_ctx):
        torch.testing.assert_close(t.grad, b, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ losses ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_mlm_nll_value_and_gradient_match_jax(rng, dtype):
    B, T, V = 3, 7, 50
    logits = (rng.normal(size=(B, T, V)) * 3).astype(np.float32)
    labels = (rng.integers(1, V, (B, T)) * (rng.random((B, T)) < 0.3)
              ).astype(np.int32)
    assert (labels == 0).any() and (labels > 0).any()
    w = np.array([1.0, 0.0, 1.0], np.float32)
    jl = jnp.asarray(logits).astype(dtype)
    tl = _t(logits).to(getattr(torch, dtype)).requires_grad_()

    want, want_g = jax.value_and_grad(jax_losses.masked_mlm_nll)(
        jl, jnp.asarray(labels))
    got = losses.masked_mlm_nll(tl, _t(labels))
    got.backward()
    assert got.dtype == torch.float32 and tl.grad.dtype == tl.dtype
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(
        rtol=2.0**-7, atol=1e-6)  # one bf16 rounding of the same softmax
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(tl.grad.float().numpy(),
                               np.asarray(want_g.astype(jnp.float32)), **tol)

    want_w = jax_steps._weighted_token_nll(jl, jnp.asarray(labels),
                                           jnp.asarray(w))
    np.testing.assert_allclose(
        float(losses.weighted_token_nll(tl.detach(), _t(labels), _t(w))),
        float(want_w), rtol=1e-6)
    correct, total = jax_steps._mlm_metrics(jl, jnp.asarray(labels),
                                            jnp.asarray(w))
    got_c, got_t = losses.mlm_metrics(tl, _t(labels), _t(w))
    assert (int(got_c), int(got_t)) == (int(correct), int(total))
    assert int(total) > 0


def test_unmasked_cells_count_toward_label_0():
    """No ignore_index: a cell with label 0 contributes -log p(token 0)."""
    logits = torch.zeros(1, 2, 4)
    logits[0, 0, 0] = 5.0
    labels = torch.tensor([[0, 0]])
    want = -torch.log_softmax(logits, -1)[0, :, 0].mean()
    torch.testing.assert_close(losses.masked_mlm_nll(logits, labels), want)


def test_streaming_lse_saves_no_fp32_tensor_of_the_logits_shape(rng):
    B, T, V = 2, 5, 40
    logits = _t(rng.normal(size=(B, T, V)).astype(np.float32)).bfloat16()
    logits.requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        loss = losses.masked_mlm_nll(logits, torch.zeros(B, T, dtype=torch.long))
    big = [t for t in saved if t.numel() >= B * T * V]
    assert big and all(t.dtype == torch.bfloat16 for t in big)
    assert all(t.shape == (B, T, V) or t.numel() <= B * T for t in saved)
    loss.backward()
    want = torch.softmax(logits.detach().float(), -1)
    want[..., 0] -= 1.0
    torch.testing.assert_close(logits.grad.float(), want / (B * T),
                               rtol=2.0**-7, atol=1e-6)


# --------------------------------------------------------- BatchNorm ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_batchnorm_matches_flax(rng, dtype):
    """Output, gradients and BOTH running statistics after one update. The
    running variance takes the biased batch variance (Flax), which stock
    nn.BatchNorm2d would not."""
    N, C, H, W = 4, 6, 5, 3
    x = (rng.normal(size=(N, H, W, C)) * 2 + 1).astype(np.float32)
    g = rng.normal(size=(N, H, W, C)).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
              "bias": rng.normal(size=C).astype(np.float32)}
    stats = {"mean": rng.normal(size=C).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}
    jbn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-3,
                       dtype=getattr(jnp, dtype),
                       force_float32_reductions=True)
    jx = jnp.asarray(x).astype(dtype)

    def f(params, xin):
        y, mut = jbn.apply({"params": params, "batch_stats": stats}, xin,
                           mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * g), (y, mut["batch_stats"])

    (_, (want_y, want_stats)), (want_gp, want_gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jx)

    bn = BatchNorm2d(C)
    bn.load_state_dict({"weight": _t(params["scale"]),
                        "bias": _t(params["bias"]),
                        "running_mean": _t(stats["mean"]),
                        "running_var": _t(stats["var"])})
    bn.train()
    xt = _t(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2).requires_grad_()
    y = bn(xt)
    assert y.dtype == xt.dtype
    (y.float() * _t(g).permute(0, 3, 1, 2)).sum().backward()

    f32 = dtype == "float32"
    tol = dict(rtol=1e-5, atol=1e-5) if f32 else dict(rtol=2.0**-6, atol=2e-2)
    np.testing.assert_allclose(
        y.detach().float().permute(0, 2, 3, 1).numpy(),
        np.asarray(want_y.astype(jnp.float32)), **tol)
    # statistics are reduced in fp32 from the same (rounded) input
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(want_stats["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(want_stats["var"]),
                               rtol=1e-5, atol=1e-6)
    n = N * H * W
    biased = x.reshape(-1, C).var(axis=0)
    if f32:
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   0.9 * stats["var"] + 0.1 * biased,
                                   rtol=1e-5)
        assert np.abs(bn.running_var.numpy() - (
            0.9 * stats["var"] + 0.1 * biased * n / (n - 1))).max() > 1e-3
        gtol = dict(rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_gx), **gtol)
        np.testing.assert_allclose(bn.weight.grad.numpy(),
                                   np.asarray(want_gp["scale"]), **gtol)
        np.testing.assert_allclose(bn.bias.grad.numpy(),
                                   np.asarray(want_gp["bias"]), **gtol)
    assert bn.weight.grad.dtype == torch.float32

    bn.eval()
    before = bn.running_var.clone()
    y_eval = bn(xt.detach())
    assert torch.equal(bn.running_var, before)
    jeval = nn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-3,
                         dtype=getattr(jnp, dtype))
    want_eval = jeval.apply({"params": params, "batch_stats": want_stats}, jx)
    np.testing.assert_allclose(
        y_eval.detach().float().permute(0, 2, 3, 1).numpy(),
        np.asarray(want_eval.astype(jnp.float32)), **tol)


# ----------------------------------------------------------- dropout ----

def test_dropout_rate_scaling_and_seeding():
    x = torch.ones(200, 500)
    a = Dropout(0.1, DropoutRng(7)).train()
    y = a(x)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 0.005
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    # one seed, one mask; the generator moves on between calls
    b = Dropout(0.1, DropoutRng(7)).train()
    assert torch.equal(b(x), y)
    assert not torch.equal(a(x), y)
    assert not torch.equal(Dropout(0.1, DropoutRng(8)).train()(x), y)
    assert a.eval()(x) is x
    assert Dropout(0.0, DropoutRng(7)).train()(x) is x
    with pytest.raises(ValueError, match="dropout rate"):
        Dropout(1.0, DropoutRng(0))


def test_dropout_override_switches_every_dropout_off(rng):
    cfg, _ = configs("mlm")
    batch = _mlm_batch(cfg, rng)
    args = (_t(batch["image"]).float() / 127.5 - 1.0, _t(batch["tokens"]),
            _t(batch["segment_ids"]), _t(batch["input_mask"]))
    gen = torch.Generator().manual_seed(0)
    noisy = MMBert(cfg, device="cpu", generator=gen)
    rates = sorted(m.p for m in noisy.modules() if isinstance(m, Dropout))
    assert rates == [0.1] * (1 + 2 * cfg.n_layers)
    quiet = MMBert(cfg.replace(dropout_override=0.0), device="cpu")
    quiet.load_state_dict(noisy.state_dict())
    assert {m.p for m in quiet.modules() if isinstance(m, Dropout)} == {0.0}
    with torch.no_grad():
        # dropout on, trunk on running statistics: only the masks differ
        noisy.set_mode(deterministic=False, train_cnn=False)
        quiet.set_mode(deterministic=False, train_cnn=False)
        a, b = noisy(*args), noisy(*args)
        c, d = quiet(*args), quiet(*args)
        assert not torch.equal(a, b)
        assert torch.equal(c, d)
        torch.testing.assert_close(c, noisy.set_mode(True)(*args))
        # one seed, one sequence of masks
        noisy.set_mode(deterministic=False, train_cnn=False)
        noisy.dropout_rng.manual_seed(3)
        e = noisy(*args)
        noisy.dropout_rng.manual_seed(3)
        assert torch.equal(noisy(*args), e)


def test_set_mode_maps_deterministic_and_train_cnn():
    cfg, _ = configs("mlm")
    model = MMBert(cfg, device="cpu")
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    assert not any(m.training for m in bns + drops)  # built deterministic
    model.set_mode(deterministic=False)
    assert all(m.training for m in bns + drops)
    model.set_mode(deterministic=False, train_cnn=False)
    assert all(m.training for m in drops) and not any(m.training for m in bns)
    model.set_mode(deterministic=True, train_cnn=True)
    assert all(m.training for m in bns) and not any(m.training for m in drops)


def test_a_model_without_a_device_needs_a_card():
    cfg, _ = configs("mlm")
    if torch.cuda.is_available():
        assert MMBert(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            MMBert(cfg)
    assert compute_dtype_of(cfg) == torch.float32
    assert compute_dtype_of(cfg.replace(mixed_precision=True)) == torch.bfloat16


# -------------------------------------------------------------- Adam ----

class _TwoLeaves(torch.nn.Module):
    def __init__(self, a, b):
        super().__init__()
        self.a = torch.nn.Parameter(_t(a).clone())
        self.b = torch.nn.Parameter(_t(b).clone())


@pytest.mark.parametrize("clip", [False, True])
def test_adam_steps_match_optax(rng, clip):
    """Three updates from given gradients, the first above the clip limit
    and the last below it."""
    a = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=5).astype(np.float32)
    grads = [(rng.normal(size=(4, 3)).astype(np.float32) * s,
              rng.normal(size=5).astype(np.float32) * s)
             for s in (3.0, 1.0, 0.05)]
    lr = 1e-2
    jstate = jax_create_train_state(
        {"params": {"a": jnp.asarray(a), "b": jnp.asarray(b)}}, lr, clip)
    state = create_train_state(_TwoLeaves(a, b), lr, clip)
    for i, (ga, gb) in enumerate(grads):
        if i == 2:  # with_lr changes the rate in place
            jstate = jstate.with_lr(lr / 10)
            assert state.with_lr(lr / 10) is state
            assert state.lr == pytest.approx(lr / 10)
        jstate = jstate.apply_gradients(
            {"a": jnp.asarray(ga), "b": jnp.asarray(gb)})
        state.model.a.grad, state.model.b.grad = _t(ga).clone(), _t(gb).clone()
        state.apply_gradients()
        assert state.step == int(jstate.step) == i + 1
        assert state.model.a.grad is None
        np.testing.assert_allclose(state.model.a.detach().numpy(),
                                   np.asarray(jstate.params["a"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(state.model.b.detach().numpy(),
                                   np.asarray(jstate.params["b"]),
                                   rtol=1e-6, atol=1e-7)


# --------------------------------------------------- the whole slice ----

NOOP = dict(crop_scale=(1.0, 1.0), crop_ratio=(1.0, 1.0), rotation_deg=0.0,
            brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0)
LR = 1e-4
N_STEPS = 10


def _mlm_batch(cfg, rng, B=3):
    T, S = cfg.max_position_embeddings, cfg.image_size
    lengths = rng.integers(cfg.num_vis + 3, T + 1, size=B)
    lengths[0] = T
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    labels = (rng.integers(1, cfg.vocab_size, (B, T))
              * (rng.random((B, T)) < 0.3) * mask).astype(np.int32)
    return {
        "image": rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8),
        "tokens": (rng.integers(1, cfg.vocab_size, (B, T)) * mask
                   ).astype(np.int32),
        "segment_ids": rng.integers(0, 2, (B, T)).astype(np.int32),
        "input_mask": mask,
        "labels": labels,
        "weights": np.array([1.0] * (B - 1) + [0.0], np.float32),
    }


@pytest.fixture(scope="module")
def trajectories():
    """N_STEPS MLM train steps of both packages from the same bridged
    weights, on three batches in turn (padded queries, a padding sample),
    without dropout and with the identity augmentation (whose draws are
    fixed: the whole image, no jitter). Keeps each package's losses, its
    gradients at step 0 and its variables after step 1 and after the last."""
    # 64 px and 4 samples, as tests/test_trajectory_parity.py: at 32 px the
    # deepest maps are 1 x 1 and their batch statistics rest on 3 values
    over = dict(max_position_embeddings=12, lr=LR, dropout_override=0.0,
                watch=True, image_size=64)
    cfg, jcfg = configs("mlm", **over)
    rng = np.random.default_rng(21)
    batches = [_mlm_batch(cfg, rng, B=4) for _ in range(3)]
    variables = jax_variables(jcfg)

    jmodel = JaxMMBert(jcfg)
    jstate = jax_create_train_state(
        jax.tree.map(jnp.asarray, variables), LR)
    jstep, jeval = jax_steps.make_mlm_steps(jmodel, jcfg,
                                            aug=JaxAugmentSpec(**NOOP))
    model = MMBert(cfg, device="cpu")
    model.load_state_dict(bridge.to_state_dict(variables, model), strict=True)
    state = create_train_state(model, LR)
    step, evaluate = make_mlm_steps(model, cfg, aug=AugmentSpec(**NOOP))

    out = {"cfg": cfg, "jax": {"loss": [], "vars": {}},
           "port": {"loss": [], "vars": {}}}

    # gradients at step 0, outside the steps: the same loss, differentiated
    b0 = batches[0]
    img0 = (b0["image"].astype(np.float32) / 255.0 - 0.5) / 0.5

    def jloss(params):
        logits, _ = jax_steps._apply(
            jmodel, params, jstate.batch_stats, jnp.asarray(img0),
            b0["tokens"], b0["segment_ids"], b0["input_mask"],
            jax.random.PRNGKey(0), True)
        return jax_steps._weighted_token_nll(logits, b0["labels"],
                                             b0["weights"])

    out["jax"]["grads"] = jax.device_get(jax.jit(jax.grad(jloss))(
        jstate.params))
    probe = copy.deepcopy(model).set_mode(deterministic=False)
    losses.weighted_token_nll(
        probe(_t(img0), _t(b0["tokens"]), _t(b0["segment_ids"]),
              _t(b0["input_mask"])), _t(b0["labels"]),
        _t(b0["weights"])).backward()
    out["port"]["grads"] = bridge.grads_to_flax(probe)

    key = jax.random.PRNGKey(3)
    for i in range(N_STEPS):
        b = batches[i % 3]
        key, sub = jax.random.split(key)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                           sub)
        state, m = step(state, b)
        out["jax"]["loss"].append(float(jm["loss"]))
        out["port"]["loss"].append(float(m["loss"]))
        if i == 0:
            out["jax"]["metrics"] = {k: float(v) for k, v in jm.items()}
            out["port"]["metrics"] = {k: float(v) for k, v in m.items()}
        if i in (0, N_STEPS - 1):
            out["jax"]["vars"][i] = jax.device_get(
                {"params": jstate.params, "batch_stats": jstate.batch_stats})
            out["port"]["vars"][i] = bridge.to_flax(model.state_dict(), model)
    out["jax"]["eval"] = {k: float(v) for k, v in jeval(
        jstate, {k: jnp.asarray(v) for k, v in batches[0].items()}).items()}
    _, out["port"]["eval"] = mlm_epoch(evaluate, state, batches[:1], False)
    out["state"] = state
    return out


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def test_mlm_loss_trajectory_matches_the_jax_train_step(trajectories):
    jl = np.asarray(trajectories["jax"]["loss"])
    pl = np.asarray(trajectories["port"]["loss"])
    assert pl[-1] < pl[0]  # training moves
    # tests/test_trajectory_parity.py's tolerances
    np.testing.assert_allclose(pl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(pl, jl, rtol=2e-3, atol=2e-3,
                               err_msg=f"\njax  {jl}\nport {pl}")
    assert trajectories["state"].step == N_STEPS


def test_first_step_metrics_and_grad_norms_match_jax(trajectories):
    jm, pm = trajectories["jax"]["metrics"], trajectories["port"]["metrics"]
    assert set(pm) == set(jm)
    assert {"loss", "correct", "total", "gnorm/trans", "gnorm/encoder",
            "gnorm/bert_embedding", "gnorm/classifier_2"} <= set(pm)
    assert pm["total"] == jm["total"] > 0 and pm["correct"] == jm["correct"]
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=k)


def test_step_0_gradients_match_jax_leaf_by_leaf(trajectories):
    want = _flat(trajectories["jax"]["grads"])
    got = _flat(trajectories["port"]["grads"])
    assert got.keys() == want.keys()
    for path, w in want.items():
        # within 1e-4 of the leaf's largest entry: sums over the batch and
        # the map in another order, through every layer above the leaf. The
        # 1e-7 is for the leaves whose gradient is zero but for rounding (a
        # BatchNorm bias that the next BatchNorm takes out again: 1e-9).
        np.testing.assert_allclose(got[path], w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max() + 1e-7,
                                   err_msg=path)
    assert np.abs(want["trans/token_conv_0/kernel"]).max() > 0
    assert np.abs(want["encoder/block_0/kqv/kernel"]).max() > 0


@pytest.mark.parametrize("after", [0, N_STEPS - 1])
def test_post_step_parameters_and_batch_stats_match_jax(trajectories, after):
    """Leaf by leaf through the bridge. Adam's first update of an entry is
    lr * sign(g) unless |g| is near 1e-8, so an entry whose tiny gradient
    differs in sign between the packages lies 2 lr apart: every entry is
    held to a little over that per step taken and 99.5% of each large leaf
    to a hundredth of it. The running statistics, which no optimizer
    touches, are held tightly after the first step and to the trajectory's
    tolerance after the last, when the weights below them have drifted."""
    want = _flat(trajectories["jax"]["vars"][after])
    got = _flat(trajectories["port"]["vars"][after])
    assert got.keys() == want.keys()
    steps = after + 1
    for path, w in want.items():
        if path.startswith("batch_stats/"):
            tol = (dict(rtol=2e-5, atol=1e-6) if after == 0
                   else dict(rtol=2e-3, atol=2e-4))
            np.testing.assert_allclose(got[path], w, err_msg=path, **tol)
            continue
        diff = np.abs(got[path] - w)
        assert diff.max() <= 2.1 * LR * steps, (path, diff.max())
        if w.size >= 1000:
            assert np.mean(diff > 0.02 * LR * steps) < 0.005, path
    stem = "batch_stats/trans/trunk/stem_bn/var"
    first = _flat(trajectories["jax"]["vars"][0])
    assert np.abs(first[stem] - 1.0).max() > 1e-3  # the statistics moved


def test_eval_step_after_training_matches_jax(trajectories):
    je, pe = trajectories["jax"]["eval"], trajectories["port"]["eval"]
    np.testing.assert_allclose(pe["loss"], je["loss"], rtol=2e-3)
    acc = 100.0 * je["correct"] / max(je["total"], 1.0)
    assert pe["acc"] == pytest.approx(acc)
    assert pe["items_per_sec"] > 0


def test_mlm_epoch_over_synthetic_batches_in_bf16_compute():
    """The main path's own setting at a tiny size: bf16 compute, fp32
    parameters and Adam state, dropout on, a padded last batch."""
    cfg, _ = configs("mlm", max_position_embeddings=16, lr=1e-3,
                     mixed_precision=True, batch_size=4, clip=True)
    model = MMBert(cfg, device="cpu", compute_dtype=compute_dtype_of(cfg))
    state = create_train_state(model, cfg.lr, clip=cfg.clip)
    step, evaluate = make_mlm_steps(model, cfg)
    batches = mlm_batches(cfg, 3, seed=1, pad_last=2)
    assert batches[-1]["weights"].tolist() == [1, 1, 0, 0]
    assert all(b["labels"][b["labels"] > 0].size > 0 for b in batches)
    assert all((b["tokens"][b["labels"] > 0] == 103).all() for b in batches)
    _, before = mlm_epoch(evaluate, state, batches, False)
    for _ in range(4):
        state, m = mlm_epoch(step, state, batches, True)
    _, after = mlm_epoch(evaluate, state, batches, False)
    assert state.step == 12 and np.isfinite(m["loss"])
    assert after["loss"] < before["loss"]
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert all(v.dtype == torch.float32
               for s in state.optimizer.state.values()
               for v in s.values() if torch.is_tensor(v))
    with torch.no_grad():
        b = batches[0]
        logits = model.set_mode(True)(
            torch.zeros(4, 32, 32, 3), _t(b["tokens"]), _t(b["segment_ids"]),
            _t(b["input_mask"]))
    assert logits.dtype == torch.bfloat16
    with pytest.raises(KeyError, match="labels"):
        step(state, {k: v for k, v in b.items() if k != "labels"})
