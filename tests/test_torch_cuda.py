"""The hand-written CUDA kernels, forward and backward, against their plain
versions on the card, at the ragged shapes the flagship path does not reach (K not a multiple of 4,
P not a multiple of the register group, C not a multiple of the channel
tile, T up to the 128 cap; odd planes, channel counts that are no multiple
of a vector or a warp, row counts that are no multiple of a tile). Skips without a card. On the GPU machine, which
has no JAX, run it without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from mmvqa_tpu_torch.ops.attention import (
    realformer_attention,
    realformer_attention_backward,
    realformer_attention_packed,
    realformer_attention_reference,
)
from mmvqa_tpu_torch.models import effnetv2
from mmvqa_tpu_torch.ops.bn_sums import (
    bn_backward_sums,
    bn_backward_sums_reference,
)
from mmvqa_tpu_torch.ops.conv_bn import (
    conv1x1_stats,
    conv1x1_stats_reference,
)
from mmvqa_tpu_torch.ops.depthwise import (
    depthwise3x3,
    depthwise3x3_backward,
    depthwise3x3_backward_reference,
    depthwise3x3_reference,
)
from mmvqa_tpu_torch.ops.token_head import (
    fused_token_head,
    token_head_backward,
    token_head_backward_reference,
    token_head_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev):
    return torch.Generator(device=dev).manual_seed(0)


# fp32: sums in another order (1e-4 relative over up to 4096 positions);
# bf16: both round one fp32 value to bf16, up to two ulps apart
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
       torch.bfloat16: dict(rtol=8e-3, atol=2e-3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["serf", "serf_fast", "relu"])
@pytest.mark.parametrize("B,P,K,C,strided", [
    (1, 1, 1, 1, False),
    (3, 37, 3, 100, False),
    (2, 4099, 13, 257, True),
    (5, 49, 700, 768, True),
    (2, 1000, 24, 768, True),
])
def test_token_head_kernel_matches_plain(dev, dtype, act, B, P, K, C,
                                         strided):
    g = _gen(dev)
    if strided:  # the trunk's NCHW map as a (B, P, K) view
        x = torch.randn(B, K, P, device=dev, generator=g).to(dtype)
        x = x.transpose(1, 2)
    else:
        x = torch.randn(B, P, K, device=dev, generator=g).to(dtype)
    w = (torch.randn(K, C, device=dev, generator=g) * K ** -0.5).to(dtype)
    before = fused_token_head.launches
    got = fused_token_head(x, w, act)
    torch.cuda.synchronize()
    assert fused_token_head.launches == before + 1
    assert got.shape == (B, C) and got.dtype == dtype
    torch.testing.assert_close(got.float(),
                               token_head_reference(x, w, act).float(),
                               **TOL[dtype])


def test_token_head_kernel_is_deterministic(dev):
    g = _gen(dev)
    x = torch.randn(4, 3136, 48, device=dev, generator=g)
    w = torch.randn(48, 768, device=dev, generator=g)
    a = fused_token_head(x, w, "serf")
    b = fused_token_head(x, w, "serf")
    assert torch.equal(a, b)


def test_token_head_refuses_what_it_does_not_take(dev):
    x = torch.zeros(2, 8, 4, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        fused_token_head(x.half(), torch.zeros(4, 8, device=dev).half(), "relu")
    with pytest.raises(ValueError, match="x is"):
        fused_token_head(x, torch.zeros(4, 8, device=dev).bfloat16(), "relu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,H,E", [(1, 1, 8), (33, 3, 40), (128, 8, 96)])
@pytest.mark.parametrize("with_prev,with_mask", [(False, False), (True, True)])
def test_attention_kernel_matches_plain(dev, dtype, T, H, E, with_prev,
                                        with_mask):
    g = _gen(dev)
    B = 3
    kqv = torch.randn(B, T, H, 3 * E, device=dev, generator=g).to(dtype)
    k, q, v = kqv.split(E, dim=-1)
    prev = (torch.randn(B, H, T, T, device=dev, generator=g)
            if with_prev else None)
    mask = None
    if with_mask:
        mask = torch.ones(B, T, device=dev)
        mask[1, T // 2:] = 0.0
    before = realformer_attention.launches
    ctx, carry = realformer_attention(q, k, v, prev, mask)
    torch.cuda.synchronize()
    assert realformer_attention.launches == before + 1
    ctx_p, carry_p = realformer_attention_reference(q, k, v, prev, mask)
    # carry: fp32 sums of E products in another order, plus the -10000 term
    torch.testing.assert_close(carry, carry_p, rtol=2e-5, atol=2e-4)
    # ctx: on padded rows the -10000 term's fp32 ulp (1e-3) moves softmax
    # weights by up to 1e-3 relative (tests/test_pallas_attention.py:60)
    tol = (dict(rtol=5e-3, atol=2e-3) if dtype == torch.float32
           else TOL[torch.bfloat16])
    torch.testing.assert_close(ctx.float(), ctx_p.float(), **tol)


def test_attention_refuses_long_sequences(dev):
    q = torch.zeros(1, 129, 1, 96, device=dev)
    with pytest.raises(ValueError, match="ring attention"):
        realformer_attention(q, q, q, None, None)


def test_attention_shared_memory_refusal_raises_and_clears(dev):
    """A head too wide for one block's shared memory (T=128, E=256: 460 KB)
    fails the launch with the card's own error; the next launch runs."""
    q = torch.zeros(1, 128, 1, 256, device=dev)
    before = realformer_attention.launches
    with pytest.raises(RuntimeError, match="realformer_attn_fwd: CUDA error"):
        realformer_attention(q, q, q, None, None)
    assert realformer_attention.launches == before
    q = torch.ones(1, 28, 1, 96, device=dev)
    ctx, _ = realformer_attention(q, q, q, None, None)
    torch.testing.assert_close(ctx, q)


# ------------------------------------------------------- backward ----

def _normwise(got, want, rel):
    """max |got - want| <= rel * max |want|: gradient sums of both signs,
    taken in another order."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["serf", "serf_fast", "relu"])
@pytest.mark.parametrize("B,P,K,C,strided", [
    (1, 1, 1, 1, False),
    (3, 37, 3, 100, False),
    (2, 4099, 13, 257, True),
    (5, 49, 675, 768, True),  # the widest K whose dx tile fits a block
    (2, 1000, 24, 768, True),
])
def test_token_head_backward_kernel_matches_plain(dev, dtype, act, B, P, K, C,
                                                  strided):
    g = _gen(dev)
    if strided:
        x = torch.randn(B, K, P, device=dev, generator=g).to(dtype)
        x = x.transpose(1, 2)
    else:
        x = torch.randn(B, P, K, device=dev, generator=g).to(dtype)
    w = (torch.randn(K, C, device=dev, generator=g) * K ** -0.5).to(dtype)
    gout = torch.randn(B, C, device=dev, generator=g)
    before = fused_token_head.backward_launches
    dx, dw = token_head_backward(x, w, gout, act)
    torch.cuda.synchronize()
    assert fused_token_head.backward_launches == before + 1
    assert dx.shape == x.shape and dx.dtype == dtype
    assert dx.stride() == x.stride()
    assert dw.shape == (K, C) and dw.dtype == torch.float32
    dx_p, dw_p = token_head_backward_reference(x, w, gout, act)
    # fp32: 1e-4 of the largest entry; bf16 dx is one more rounding, and a
    # bf16 ulp is up to 2^-7 of its value
    _normwise(dw, dw_p, 1e-4)
    _normwise(dx, dx_p, 1e-4 if dtype == torch.float32 else 8e-3)


def test_token_head_backward_kernel_is_deterministic(dev):
    g = _gen(dev)
    x = torch.randn(4, 3136, 48, device=dev, generator=g)
    w = torch.randn(48, 768, device=dev, generator=g)
    gout = torch.randn(4, 768, device=dev, generator=g)
    a = token_head_backward(x, w, gout, "serf")
    b = token_head_backward(x, w, gout, "serf")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("master", [False, True])
def test_token_head_autograd_goes_through_the_kernels(dev, master):
    """loss.backward() on CUDA tensors launches both kernels and gives the
    gradients autograd takes through the plain version; with the fp32
    master weight under a bf16 x, dW arrives in fp32."""
    g = _gen(dev)
    dtype = torch.bfloat16 if master else torch.float32
    act = "serf_fast" if master else "serf"
    x = torch.randn(3, 200, 24, device=dev, generator=g).to(dtype)
    w = torch.randn(24, 96, device=dev, generator=g) * 0.2
    gout = torch.randn(3, 96, device=dev, generator=g)
    x1, w1 = x.clone().requires_grad_(), w.clone().requires_grad_()
    counts = (fused_token_head.launches, fused_token_head.backward_launches)
    (fused_token_head(x1, w1, act).float() * gout).sum().backward()
    torch.cuda.synchronize()
    assert (fused_token_head.launches,
            fused_token_head.backward_launches) == (counts[0] + 1,
                                                    counts[1] + 1)
    x2, w2 = x.clone().requires_grad_(), w.clone().requires_grad_()
    (token_head_reference(x2, w2.to(dtype), act).float() * gout).sum().backward()
    assert w1.grad.dtype == torch.float32 and x1.grad.dtype == dtype
    _normwise(x1.grad, x2.grad, 8e-3 if master else 1e-4)
    # the plain path's dW went through a bf16 cast on its way to the master
    _normwise(w1.grad, w2.grad, 8e-3 if master else 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,H,E", [(1, 1, 8), (33, 3, 40), (96, 8, 96)])
@pytest.mark.parametrize("with_prev,with_mask", [(False, False), (True, True)])
def test_attention_autograd_goes_through_the_kernels(dev, dtype, T, H, E,
                                                     with_prev, with_mask):
    """A two-layer chain on the card (layer 2 takes layer 1's carry, whose
    last carry has no consumer) against autograd through the plain version
    on the same inputs."""
    g = _gen(dev)
    B = 3
    kqv = [torch.randn(B, T, H, 3 * E, device=dev, generator=g).to(dtype)
           for _ in range(2)]
    prev = (torch.randn(B, H, T, T, device=dev, generator=g)
            if with_prev else None)
    mask = None
    if with_mask:
        mask = torch.ones(B, T, device=dev)
        mask[1, T // 2:] = 0.0
    gout = [torch.randn(B, T, H, E, device=dev, generator=g) for _ in range(2)]

    def run(fn_packed):
        leaves = [t.clone().requires_grad_() for t in kqv]
        p0 = None if prev is None else prev.clone().requires_grad_()
        c1, p1 = fn_packed(leaves[0], p0, mask)
        c2, _ = fn_packed(leaves[1], p1, mask)
        ((c1.float() * gout[0]).sum() + (c2.float() * gout[1]).sum()).backward()
        return [t.grad for t in leaves] + ([] if p0 is None else [p0.grad])

    def plain(t, p, m):
        k, q, v = t.split(E, dim=-1)
        return realformer_attention_reference(q, k, v, p, m)

    counts = (realformer_attention.launches,
              realformer_attention.backward_launches)
    got = run(realformer_attention_packed)
    torch.cuda.synchronize()
    assert (realformer_attention.launches,
            realformer_attention.backward_launches) == (counts[0] + 2,
                                                        counts[1] + 2)
    want = run(plain)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        # tests/test_pallas_attention.py:92 for fp32, relative to the largest
        # entry; bf16: the two paths round dq, dk, dv at other places
        _normwise(a, b, 5e-4 if dtype == torch.float32 else 1.6e-2)


def test_token_head_backward_refuses_a_k_beyond_its_dx_tile(dev):
    x = torch.zeros(1, 8, 676, device=dev)
    w = torch.zeros(676, 8, device=dev)
    before = fused_token_head.backward_launches
    with pytest.raises(ValueError, match="shared memory for its dx tile"):
        token_head_backward(x, w, torch.zeros(1, 8, device=dev), "relu")
    assert fused_token_head.backward_launches == before


def test_attention_backward_shared_memory_refusal_raises_and_clears(dev):
    """The backward holds four (T, E) tiles and two (T, T) tiles: T=128 at
    E=96 (328 KB) is refused by the card; the next launch runs."""
    kqv = torch.zeros(1, 128, 1, 288, device=dev)
    carry = torch.zeros(1, 1, 128, 128, device=dev)
    before = realformer_attention.backward_launches
    with pytest.raises(RuntimeError, match="realformer_attn_bwd: CUDA error"):
        realformer_attention_backward(kqv, carry, None, None, False)
    assert realformer_attention.backward_launches == before
    kqv = torch.randn(1, 28, 1, 288, device=dev)
    dkqv, dprev = realformer_attention_backward(
        kqv, torch.zeros(1, 1, 28, 28, device=dev), None, None, False)
    assert dprev is None and not dkqv.any()


# ------------------------------------------- the trunk's kernels ----

DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("B,H,W,C", [
    (1, 1, 1, 1), (2, 5, 7, 33), (3, 7, 7, 100), (2, 14, 14, 1056),
    (5, 3, 9, 130), (2, 1, 6, 64),
])
def test_depthwise_kernels_match_plain(dev, dtype, master, B, H, W, C):
    """Forward and backward; ``master``: the fp32 weight of a convolution,
    (C, 1, 3, 3), handed over as its (3, 3, C) view."""
    g = _gen(dev)
    x = torch.randn(B, H, W, C, device=dev, generator=g).to(dtype)
    dy = torch.randn(B, H, W, C, device=dev, generator=g).to(dtype)
    if master:
        w = (torch.randn(C, 1, 3, 3, device=dev, generator=g)
             * 0.3)[:, 0].permute(1, 2, 0)
    else:
        w = (torch.randn(3, 3, C, device=dev, generator=g) * 0.3).to(dtype)
    counts = (depthwise3x3.launches, depthwise3x3.backward_launches)
    y = depthwise3x3(x, w)
    dx, dw = depthwise3x3_backward(x, w, dy)
    torch.cuda.synchronize()
    assert (depthwise3x3.launches, depthwise3x3.backward_launches) == (
        counts[0] + 1, counts[1] + 1)
    assert y.dtype == dx.dtype == dtype and dw.dtype == torch.float32
    # the plain versions in fp32 from the same (rounded) inputs; cuDNN's own
    # bf16 convolution would add its roundings
    xf, wf = x.float(), w.to(dtype).float()
    y_p = depthwise3x3_reference(xf, wf)
    dx_p, dw_p = depthwise3x3_backward_reference(xf, wf, dy.float())
    # tests/test_pallas_depthwise.py: 2e-5 / 1e-5 forward; bf16 two ulps
    tol = (dict(rtol=2e-5, atol=1e-5) if dtype == torch.float32
           else TOL[torch.bfloat16])
    torch.testing.assert_close(y.float(), y_p, **tol)
    _normwise(dx, dx_p, 1e-4 if dtype == torch.float32 else 8e-3)
    _normwise(dw, dw_p, 1e-4)
    again = depthwise3x3_backward(x, w, dy)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)


def test_depthwise_corner_impulse_on_the_card(dev):
    x = torch.zeros(1, 7, 7, 128, device=dev)
    x[0, 0, 0] = 1.0
    y = depthwise3x3(x, torch.ones(3, 3, 128, device=dev))
    assert y[0, :2, :2, 0].sum().item() == 4.0
    assert not y[0, 2:].any() and not y[0, :, 2:].any()
    dx, dw = depthwise3x3_backward(x, torch.ones(3, 3, 128, device=dev), x)
    assert dx[0, :2, :2, 0].sum().item() == 4.0
    assert not dx[0, 2:].any() and not dx[0, :, 2:].any()
    assert dw[1, 1, 0].item() == 1.0 and dw.sum().item() == 128.0


def test_trunk_kernels_refuse_strided_maps(dev):
    """A map that is not dense channels-last is refused, not copied."""
    nchw = torch.zeros(2, 8, 4, 4, device=dev)  # dense NCHW
    w = torch.zeros(3, 3, 8, device=dev)
    before = (depthwise3x3.launches, conv1x1_stats.launches,
              bn_backward_sums.launches)
    with pytest.raises(ValueError, match="dense"):
        depthwise3x3(nchw.permute(0, 2, 3, 1), w)
    with pytest.raises(ValueError, match="dense"):
        conv1x1_stats(torch.zeros(8, 16, device=dev).t(),
                      torch.zeros(8, 4, device=dev))
    m = torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="dense"):
        bn_backward_sums(nchw.permute(0, 2, 3, 1), nchw.permute(0, 2, 3, 1),
                         m, m)
    with pytest.raises(ValueError, match="dense"):
        effnetv2.channels_last(nchw)
    with pytest.raises(ValueError, match="dtype"):
        depthwise3x3(torch.zeros(1, 2, 2, 8, device=dev).half(), w.half())
    with pytest.raises(ValueError, match="x is"):
        conv1x1_stats(torch.zeros(4, 8, device=dev),
                      torch.zeros(8, 4, device=dev).bfloat16())
    assert before == (depthwise3x3.launches, conv1x1_stats.launches,
                      bn_backward_sums.launches)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N,K,C,wt", [
    (1, 1, 1, False), (700, 24, 64, False), (700, 24, 64, True),
    (513, 176, 1056, True), (300, 35, 77, True), (300, 35, 77, False),
    (129, 304, 65, True), (4099, 96, 48, True), (64, 1000, 130, True),
])
def test_conv1x1_stats_kernel_matches_plain(dev, dtype, N, K, C, wt):
    """``wt``: w as the trunk passes it, the (C, K) weight's (K, C) view."""
    g = _gen(dev)
    x = torch.randn(N, K, device=dev, generator=g).to(dtype)
    if wt:
        w = (torch.randn(C, K, device=dev, generator=g) * K ** -0.5).to(dtype).t()
    else:
        w = (torch.randn(K, C, device=dev, generator=g) * K ** -0.5).to(dtype)
    before = conv1x1_stats.launches
    y, stats = conv1x1_stats(x, w)
    torch.cuda.synchronize()
    assert conv1x1_stats.launches == before + 1
    assert y.dtype == dtype and stats.dtype == torch.float32
    assert y.shape == (N, C) and stats.shape == (2, C)
    y_p, stats_p = conv1x1_stats_reference(x, w)
    # tests/test_conv_bn.py: y 2e-5, sums 1e-4 in fp32 (sums of up to 4099
    # terms: relative to the largest); bf16 y two ulps, the sums are fp32
    # sums of the same unrounded products
    tol = (dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32
           else TOL[torch.bfloat16])
    torch.testing.assert_close(y.float(), y_p.float(), **tol)
    _normwise(stats[0], stats_p[0], 1e-4)
    _normwise(stats[1], stats_p[1], 1e-4)
    y2, stats2 = conv1x1_stats(x, w)
    assert torch.equal(y2, y) and torch.equal(stats2, stats)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    (1, 1), (37, 33), (2, 5, 7, 24), (4, 28, 28, 80), (3, 7, 7, 1000),
    (100000, 3), (2, 3, 3, 304),
])
def test_bn_backward_sums_kernel_matches_plain(dev, dtype, shape):
    g = _gen(dev)
    C = shape[-1]
    x = (torch.randn(shape, device=dev, generator=g) * 2 + 1).to(dtype)
    dy = torch.randn(shape, device=dev, generator=g).to(dtype)
    mean = torch.randn(C, device=dev, generator=g)
    inv_std = 1 + torch.rand(C, device=dev, generator=g)
    before = bn_backward_sums.launches
    s1, s2 = bn_backward_sums(x, dy, mean, inv_std)
    torch.cuda.synchronize()
    assert bn_backward_sums.launches == before + 1
    p1, p2 = bn_backward_sums_reference(x, dy, mean, inv_std)
    # fp32 sums of the same fp32 terms in another order, over up to 1e5 rows
    _normwise(s1, p1, 1e-4)
    _normwise(s2, p2, 1e-4)
    again = bn_backward_sums(x, dy, mean, inv_std)
    assert torch.equal(again[0], s1) and torch.equal(again[1], s2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["mb", "fused"])
def test_training_block_autograd_goes_through_the_kernels(dev, dtype, kind):
    """One training-mode block on the card, fp32 masters under a ``dtype``
    map, against the same block on the CPU (plain paths): K3 1/1, K4 2 (or
    1), K5 3 (or 2) launches; output, gradients and running statistics."""
    torch.manual_seed(0)
    if kind == "mb":
        block = effnetv2.MBConv(24, 24, 3, 1, 4, 0.25)
        want_counts = (1, 1, 2, 3)
    else:
        block = effnetv2.FusedMBConv(24, 24, 3, 1, 4)
        want_counts = (0, 0, 1, 2)
    block.train()
    import copy
    card = copy.deepcopy(block).to(dev)
    x = torch.randn(4, 9, 9, 24).to(dtype).permute(0, 3, 1, 2)
    gout = torch.randn(4, 9, 9, 24).permute(0, 3, 1, 2)

    def run(b, device):
        xin = x.to(device).requires_grad_()
        y = b(xin)
        (y.float() * gout.to(device)).sum().backward()
        return y, xin.grad

    def counts():
        return (depthwise3x3.launches, depthwise3x3.backward_launches,
                conv1x1_stats.launches, bn_backward_sums.launches)

    before = counts()
    copies = (effnetv2.BatchNorm2d.gradient_copies,
              depthwise3x3.gradient_copies)
    y, dx = run(card, dev)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == want_counts
    assert copies == (effnetv2.BatchNorm2d.gradient_copies,
                      depthwise3x3.gradient_copies)
    y_p, dx_p = run(block, "cpu")
    rel = 2e-3 if dtype == torch.float32 else 4e-2
    _normwise(y.cpu(), y_p, rel)
    _normwise(dx.cpu(), dx_p, rel)
    for (name, p), q in zip(card.named_parameters(), block.parameters()):
        assert p.grad.dtype == torch.float32, name
        _normwise(p.grad.cpu(), q.grad, rel)
    for (name, b), c in zip(card.named_buffers(), block.buffers()):
        _normwise(b.cpu(), c, rel)


def test_a_gradient_in_another_layout_is_copied_and_counted(dev):
    """autograd promises no layout for a gradient: one that arrives as NCHW
    (or broadcast) at a site whose map lies channels last is copied into the
    map's layout, counted, and gives the result of the dense one."""
    torch.manual_seed(0)
    bn = effnetv2.BatchNorm2d(24).to(dev).train()
    x = torch.randn(4, 9, 9, 24, device=dev).permute(0, 3, 1, 2)
    g = torch.randn(4, 9, 9, 24, device=dev).permute(0, 3, 1, 2)
    w = torch.randn(3, 3, 24, device=dev)

    def grads(gout):
        xin = x.clone(memory_format=torch.preserve_format).requires_grad_()
        y = depthwise3x3(effnetv2.channels_last(bn(xin)), w)
        y.permute(0, 3, 1, 2).backward(gout)
        return xin.grad

    def copies():
        return (effnetv2.BatchNorm2d.gradient_copies,
                depthwise3x3.gradient_copies)

    before = copies()
    want = grads(g)
    assert copies() == before
    got = grads(g.contiguous())  # NCHW
    assert copies() == (before[0], before[1] + 1)
    assert torch.equal(got, want)

    def bn_grad(gout):
        xin = x.clone(memory_format=torch.preserve_format).requires_grad_()
        bn(xin).backward(gout)
        return xin.grad

    want = bn_grad(g)
    assert copies() == (before[0], before[1] + 1)
    got = bn_grad(g.contiguous())
    assert copies() == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, want)
