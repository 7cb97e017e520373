"""The hand-written CUDA kernels, forward and backward, against their plain
versions on the card, at the ragged shapes the flagship path does not reach (K not a multiple of 4,
P not a multiple of the register group, C not a multiple of the channel
tile, T up to the 128 cap). Skips without a card. On the GPU machine, which
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
