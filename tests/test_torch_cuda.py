"""The hand-written CUDA kernels, forward and backward, against their plain
versions on the card, at the ragged shapes the flagship path does not reach (K not a multiple of 4,
P not a multiple of the register group, C not a multiple of the channel
tile, T beyond one block's tiles; odd planes, channel counts that are no multiple
of a vector or a warp, row counts that are no multiple of a tile). Skips without a card. On the GPU machine, which
has no JAX, run it without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from mmvqa_tpu_torch.ops.attention import (
    backward_path,
    forward_path,
    realformer_attention,
    realformer_attention_backward,
    realformer_attention_backward_reference,
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

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

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


def _device_kernels(run, reps=10, counter=None):
    """[(kernel name, launches a run)] of ``reps`` runs of ``run``, traced
    by chip_smoke.py::traced (host and device activity; where the profiler
    saw no device time, one trace more). On some machines the profiler
    drops device records (F6, PERF.md §7: traces of one call came back
    empty), which can only lower a count: a count read here is at most the
    launches, so ``counter`` (a wrapper and the name of its launch counter)
    must move by exactly ``reps`` in the trace that is read, one launch a
    run as the wrapper counts them."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    def runs():
        before = getattr(*counter) if counter else 0
        for _ in range(reps):
            run()
        return (getattr(*counter) if counter else 0) - before

    got = chip_smoke.traced(torch, runs, "card test")
    assert got is not None, "the profiler saw no device time in two traces"
    moved, _, prof = got
    if counter:
        assert moved == reps, (counter[1], moved, reps)
    from torch.profiler import DeviceType

    return [(e.key, e.count / reps) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


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


FWD_CASES = [
    # tiles that straddle two images (P = 196, 37) and three (P = 49 under
    # 64-row tiles); W resident (K <= 96) and streamed (K = 97, 176, 512);
    # the trunk's channels-last view, its NCHW view, a view whose rows are
    # not 16-byte aligned (element copies); C ragged against 256 and 8
    (5, 49, 24, 768, "nhwc"),
    (3, 196, 80, 768, "nhwc"),
    (7, 37, 96, 300, "dense"),
    (4, 49, 97, 768, "nchw"),
    (6, 196, 176, 768, "nhwc"),
    (9, 49, 512, 520, "nhwc"),
    (2, 1000, 24, 257, "unaligned"),
    (2, 1, 8, 8, "dense"),
]


def _forward_inputs(dev, B, P, K, C, layout):
    if layout == "unaligned":  # every row starts one element past 16 bytes
        g = _gen(dev)
        flat = torch.randn(B * P * (K + 1) + 1, device=dev, generator=g)
        x = flat.bfloat16()[1:].view(B, P, K + 1)[..., :K]
        w = (torch.randn(K, C, device=dev, generator=g) * K ** -0.5).bfloat16()
        return x, w
    x, w, _ = _token_head_inputs(dev, torch.bfloat16, B, P, K, C, layout)
    return x, w


@pytest.mark.parametrize("act", ["serf", "serf_fast", "relu"])
@pytest.mark.parametrize("B,P,K,C,layout", FWD_CASES)
def test_token_head_bf16_forward_straddles_images(dev, act, B, P, K, C,
                                                  layout):
    """The bf16 forward on the tensor cores: rows of one axis of B * P,
    tiles across image boundaries, against the plain version; two runs give
    the same bits (the sums across blocks are added in block order) and
    every last-block counter ends at 0."""
    from mmvqa_tpu_torch.ops import token_head

    x, w = _forward_inputs(dev, B, P, K, C, layout)
    before = fused_token_head.launches
    got = fused_token_head(x, w, act)
    again = fused_token_head(x, w, act)
    torch.cuda.synchronize()
    assert fused_token_head.launches == before + 2
    assert got.shape == (B, C) and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(),
                               token_head_reference(x, w, act).float(),
                               **TOL[torch.bfloat16])
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert not token_head._FWD_COUNTERS[(x.device, stream)].any()


def test_token_head_bf16_forward_is_one_kernel(dev):
    """The sums across blocks are added inside the kernel: a profiled
    forward shows one kernel and no token_head_finalize."""
    x, w, _ = _token_head_inputs(dev, torch.bfloat16, 8, 56 * 56, 48, 768,
                                 "nhwc")
    fused_token_head(x, w, "serf_fast")
    names = [key for key, _ in _device_kernels(
        lambda: fused_token_head(x, w, "serf_fast"),
        counter=(fused_token_head, "launches"))]
    ours = [n for n in names if "token_head" in n]
    assert len(ours) == 1 and "token_head_fwd_mma" in ours[0], names


def test_token_head_bf16_forward_on_two_streams_at_once(dev):
    """Forward calls queued on two streams at once count into their own
    stream's counters: every output is the one the default stream gives,
    bit for bit, and every counter ends at 0."""
    from mmvqa_tpu_torch.ops import token_head

    cases = [_forward_inputs(dev, 16, P, K, 768, "nhwc")
             for P, K in ((112 * 112, 24), (7 * 7, 512), (28 * 28, 80))]
    want = [fused_token_head(x, w, "serf_fast") for x, w in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in cases]
    got = [[] for _ in cases]
    for _ in range(3):
        for i, (stream, (x, w)) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(stream):
                torch.cuda._sleep(1000)
                got[i].append(fused_token_head(x, w, "serf_fast"))
    torch.cuda.synchronize()
    for out, runs in zip(want, got):
        for r in runs:
            assert torch.equal(r, out)
    device = cases[0][0].device
    for s in streams:
        assert not token_head._FWD_COUNTERS[(device, s.cuda_stream)].any()


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


def test_attention_shared_memory_refusal_raises_and_clears(dev):
    """A head too wide for one block's shared memory (T=128, E=256: 460 KB)
    goes to the tiled kernel; one too wide for the tiled kernel's 32-row
    tiles (E=1024) is refused before the launch; the next launch runs."""
    q = torch.ones(1, 128, 1, 256, device=dev)
    ctx, _ = realformer_attention(q, q, q, None, None)
    torch.testing.assert_close(ctx, q)
    q = torch.zeros(1, 40, 1, 1024, device=dev)
    before = realformer_attention.launches
    with pytest.raises(ValueError, match="shared memory"):
        realformer_attention(q, q, q, None, None)
    assert realformer_attention.launches == before
    q = torch.ones(1, 28, 1, 96, device=dev)
    ctx, _ = realformer_attention(q, q, q, None, None)
    torch.testing.assert_close(ctx, q)


def _k2_fwd_case(dev, B, T, H, E, layout, with_prev, with_mask):
    """bf16 q, k, v as the slices of a kqv laid out as the train step gives
    it ("packed": the projection's (B, T, H, 3E) output), as a (B, H, T, 3E)
    buffer's permuted view ("strided"), or one element past a 16-byte
    boundary ("unaligned": the kernel's element copies; prev then one float
    off the carry's offset within 16 bytes, so it comes in by plain loads
    too); ragged masks."""
    g = _gen(dev)
    if layout == "strided":
        kqv = torch.randn(B, H, T, 3 * E, device=dev, generator=g)
        kqv = kqv.bfloat16().permute(0, 2, 1, 3)
    elif layout == "unaligned":
        flat = torch.randn(B * T * H * 3 * E + 1, device=dev, generator=g)
        kqv = flat.bfloat16()[1:].view(B, T, H, 3 * E)
    else:
        kqv = torch.randn(B, T, H, 3 * E, device=dev, generator=g).bfloat16()
    k, q, v = kqv.split(E, dim=-1)
    prev = None
    if with_prev:
        prev = torch.randn(B * H * T * T + 1, device=dev, generator=g)
        prev = (prev[1:] if layout == "unaligned" else prev[:-1]).view(
            B, H, T, T)
    mask = None
    if with_mask:
        lengths = torch.randint(1, T + 1, (B,), device=dev, generator=g)
        mask = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()
    return q, k, v, prev, mask


@pytest.mark.parametrize("T", [16, 17, 28, 75, 125, 128])
@pytest.mark.parametrize("E", [16, 96, 128])
@pytest.mark.parametrize("layout", ["packed", "strided", "unaligned"])
@pytest.mark.parametrize("with_prev,with_mask", [
    (False, False), (False, True), (True, False), (True, True)])
def test_attention_bf16_forward_tensor_core_kernel_matches_plain(
        dev, T, E, layout, with_prev, with_mask):
    """The tensor-core forward against the plain version: the carry within
    chip_smoke.py's TOL_K2_CARRY, ctx within its TOL_BF16; two runs give
    the same bits; its own launch counter moves."""
    assert forward_path(torch.bfloat16, T, E) == "mma"
    q, k, v, prev, mask = _k2_fwd_case(dev, 3, T, 4, E, layout, with_prev,
                                       with_mask)
    counts = (realformer_attention.launches,
              realformer_attention.mma_launches)
    ctx, carry = realformer_attention(q, k, v, prev, mask)
    again = realformer_attention(q, k, v, prev, mask)
    torch.cuda.synchronize()
    assert (realformer_attention.launches,
            realformer_attention.mma_launches) == (counts[0] + 2,
                                                   counts[1] + 2)
    assert torch.equal(again[0], ctx) and torch.equal(again[1], carry)
    ctx_p, carry_p = realformer_attention_reference(q, k, v, prev, mask)
    torch.testing.assert_close(carry, carry_p, rtol=2e-5, atol=2e-4)
    torch.testing.assert_close(ctx.float(), ctx_p.float(),
                               **TOL[torch.bfloat16])


def test_attention_bf16_forward_is_one_tensor_core_kernel(dev):
    """At the train shape the forward launches realformer_attn_fwd_mma
    alone, once a call; fp32 its split-TF32 kernel,
    realformer_attn_fwd_tf32x3."""
    q, k, v, prev, mask = _k2_fwd_case(dev, 8, 75, 8, 96, "packed", True,
                                       True)
    for dtype, want in ((torch.bfloat16, "realformer_attn_fwd_mma"),
                        (torch.float32, "realformer_attn_fwd_tf32x3")):
        args = [t.to(dtype) for t in (q, k, v)]
        realformer_attention(*args, prev, mask)
        ours = [(key, n) for key, n in _device_kernels(
            lambda: realformer_attention(*args, prev, mask),
            counter=(realformer_attention, "mma_launches"
                     if dtype == torch.bfloat16 else "tf32x3_launches"))
            if "realformer_attn_fwd" in key]
        assert (len(ours) == 1 and want in ours[0][0]
                and 0 < ours[0][1] <= 1), ours


# ------------------------------------------------------- backward ----

def _normwise(got, want, rel):
    """max |got - want| <= rel * max |want|: gradient sums of both signs,
    taken in another order."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), err


def _token_head_inputs(dev, dtype, B, P, K, C, layout):
    """x as the trunk gives it ("nhwc": a channels-last map's (B, P, K)
    view), as an NCHW map's transposed view ("nchw"), or dense."""
    g = _gen(dev)
    if layout == "nchw":
        x = torch.randn(B, K, P, device=dev, generator=g).to(dtype)
        x = x.transpose(1, 2)
    else:
        x = torch.randn(B, P, K, device=dev, generator=g).to(dtype)
    w = (torch.randn(K, C, device=dev, generator=g) * K ** -0.5).to(dtype)
    gout = torch.randn(B, C, device=dev, generator=g)
    return x, w, gout


TOKEN_HEAD_BWD_SHAPES = [
    # ragged: K no multiple of 8 or 16, P no multiple of a tile, C no
    # multiple of a channel tile or of 8
    (1, 1, 1, 1, "dense"),
    (3, 37, 3, 100, "dense"),
    (2, 4099, 13, 257, "nchw"),
    (2, 1000, 24, 768, "nchw"),
    (3, 130, 40, 776, "dense"),
    # the five flagship taps at a small batch, as the trunk gives them
    (2, 112 * 112, 24, 768, "nhwc"),
    (2, 56 * 56, 48, 768, "nhwc"),
    (4, 28 * 28, 80, 768, "nhwc"),
    (8, 14 * 14, 176, 768, "nhwc"),
    (16, 7 * 7, 512, 768, "nhwc"),
    (2, 14 * 14, 176, 2048, "nchw"),
]
# wide K, the ResNet-152 taps' K among them
# (mmvqa_tpu/models/visual_tokens.py:10), and the widest hidden size
WIDE_K_SHAPES = [
    (5, 49, 675, 768, "nchw"),
    (8, 14 * 14, 1024, 768, "nhwc"),
    (16, 7 * 7, 1024, 768, "nchw"),
    (4, 14 * 14, 2048, 768, "nhwc"),
    (16, 7 * 7, 2048, 768, "nhwc"),
    (4, 7 * 7, 2048, 2048, "nhwc"),
]
BWD_CASES = [(act, *shape) for act in ("serf", "serf_fast", "relu")
             for shape in TOKEN_HEAD_BWD_SHAPES + WIDE_K_SHAPES]
# an s whose |s| the plain version puts within FLIP_TAU * sum_k |x_k w_kc|
# of 0 may fall on the other side of relu's step in the kernel: the two sum
# the K products in another order, each within about sqrt(K) fp32 ulps of
# that sum of magnitudes (far below 2^-16 of it at K = 2048)
FLIP_TAU = 2.0 ** -16


def _relu_flip_allowance(x, w, gout):
    """Per entry of dx and dW, the most that relu' flipping at the s the
    plain version puts within FLIP_TAU of 0 can move it: each flip adds or
    drops one whole g / P term (gact rounded up by a bf16 ulp at most).
    Returns the share of such s and the two allowances."""
    xd, wd = x.double(), w.double()
    s = torch.einsum("bpk,kc->bpc", xd, wd)
    near = s.abs() <= FLIP_TAU * torch.einsum("bpk,kc->bpc", xd.abs(),
                                              wd.abs())
    term = near * (gout.double().abs() / x.shape[1])[:, None, :]
    term = term * (1.0 + 2.0 ** -7)
    return (near.double().mean().item(),
            torch.einsum("bpc,kc->bpk", term, wd.abs()),
            torch.einsum("bpk,bpc->kc", xd.abs(), term))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,B,P,K,C,layout", BWD_CASES)
def test_token_head_backward_kernel_matches_plain(dev, dtype, act, B, P, K, C,
                                                  layout):
    x, w, gout = _token_head_inputs(dev, dtype, B, P, K, C, layout)
    before = fused_token_head.backward_launches
    dx, dw = token_head_backward(x, w, gout, act)
    torch.cuda.synchronize()
    assert fused_token_head.backward_launches == before + 1
    assert dx.shape == x.shape and dx.dtype == dtype
    assert dx.stride() == x.stride()
    assert dw.shape == (K, C) and dw.dtype == torch.float32
    dx_p, dw_p = token_head_backward_reference(x, w, gout, act)
    # fp32: 1e-4 of the largest entry. bf16: both round gact to bf16 before
    # the products; where the two fp32 s differ in their last bits a gact
    # lands one ulp apart, which moves dW by up to half of 1e-3 of its
    # largest entry (tests/test_torch_train.py::
    # test_token_head_bf16_dw_moves_with_the_order_of_s) and dx by up to
    # 6.2e-4 (tests/test_torch_train.py::
    # test_token_head_bf16_backward_matches_the_reference_kernel); dx itself
    # is one more rounding, a bf16 ulp up to 2^-7 of its value. That the
    # kernel rounds gact at all is held tighter below
    # (test_token_head_bf16_backward_rounds_gact_as_the_plain_version).
    bf16 = dtype == torch.bfloat16
    rel_dw, rel_dx = (1e-3, 8e-3) if bf16 else (1e-4, 1e-4)
    err_dw = (dw - dw_p).abs()
    err_dx = (dx.float() - dx_p.float()).abs()
    lim_dw = rel_dw * dw_p.abs().max().item()
    lim_dx = rel_dx * dx_p.float().abs().max().item()
    if act == "relu" and K >= 675:
        # relu' is a step: where hundreds of products are summed in another
        # order, an s within an ulp of 0 may take the other side, which moves
        # a whole x g / P term of dx and dW (either order is right). Such
        # entries may move by their terms; the rest is held as above.
        share, allow_dx, allow_dw = _relu_flip_allowance(x, w, gout)
        assert share < 1e-3, share
        assert (err_dw <= lim_dw + allow_dw.float()).all(), err_dw.max()
        assert (err_dx <= lim_dx + allow_dx.float()).all(), err_dx.max()
    else:
        assert err_dw.max().item() <= lim_dw, err_dw.max()
        assert err_dx.max().item() <= lim_dx, err_dx.max()


def _backward_keeping_gact_fp32(x, w, g, act):
    """The plain backward as it was before gact was rounded to x's dtype:
    the control that the next test must tell apart."""
    from mmvqa_tpu_torch.ops.token_head import _act_grad

    xf, wf = x.float(), w.float()
    s = torch.einsum("bpk,kc->bpc", xf, wf)
    gact = _act_grad(s, act) * (g.float() / x.shape[1])[:, None, :]
    return (torch.einsum("bpc,kc->bpk", gact, wf).to(x.dtype),
            torch.einsum("bpk,bpc->kc", xf, gact))


@pytest.mark.parametrize("act", ["serf", "serf_fast", "relu"])
def test_token_head_bf16_backward_rounds_gact_as_the_plain_version(dev, act):
    """At the CPU test's shape and widths
    (tests/test_torch_train.py::
    test_token_head_bf16_backward_matches_the_reference_kernel: dW within
    5e-5 of its largest entry of the reference's kernel, read 1.4e-5) the
    kernel's bf16 dW is held to the plain version within that 5e-5; a plain
    version that keeps gact in fp32 misses it."""
    g = torch.Generator().manual_seed(0)
    B, P, K, C = 2, 700, 24, 64
    x = torch.randn(B, P, K, generator=g).bfloat16().to(dev)
    w = (torch.randn(K, C, generator=g) * 0.1).bfloat16().to(dev)
    gout = torch.randn(B, C, generator=g).to(dev)
    dx, dw = token_head_backward(x, w, gout, act)
    dx_p, dw_p = token_head_backward_reference(x, w, gout, act)
    _, dw_f = _backward_keeping_gact_fp32(x, w, gout, act)
    lim = 5e-5 * dw_p.abs().max().item()
    assert (dw - dw_p).abs().max().item() <= lim
    assert (dw_f - dw_p).abs().max().item() > lim
    torch.testing.assert_close(
        dx.float(), dx_p.float(), rtol=8e-3,
        atol=1e-3 * dx_p.float().abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_token_head_backward_kernel_is_deterministic(dev, dtype):
    """Two runs give the same bits, dW summed across blocks included, at a
    tap whose dW stays in registers (K=24) and one whose passes go through
    the block's partial (K=48); the barrier's counters end at 0."""
    from mmvqa_tpu_torch.ops import token_head

    for P, K in ((112 * 112, 24), (56 * 56, 48)):
        x, w, gout = _token_head_inputs(dev, dtype, 4, P, K, 768, "nhwc")
        a = token_head_backward(x, w, gout, "serf")
        b = token_head_backward(x, w, gout, "serf")
        torch.cuda.synchronize()
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    assert not token_head._BARRIERS[(x.device, stream)].any()


def test_token_head_backward_is_one_kernel(dev):
    """dW's partials are summed inside the backward kernel: a profiled
    backward shows the one kernel and no token_head_dw_reduce."""
    x, w, gout = _token_head_inputs(dev, torch.bfloat16, 8, 56 * 56, 48, 768,
                                    "nhwc")
    token_head_backward(x, w, gout, "serf_fast")
    names = [key for key, _ in _device_kernels(
        lambda: token_head_backward(x, w, gout, "serf_fast"),
        counter=(fused_token_head, "backward_launches"))]
    ours = [n for n in names if "token_head" in n]
    assert len(ours) == 1 and "token_head_bwd" in ours[0], names
    assert not any("dw_reduce" in n for n in names), names


def test_token_head_backward_on_two_streams_at_once(dev):
    """Backward calls queued on two streams at once each meet at their own
    stream's barrier: every dx and dW is the one a call on the default
    stream gives, bit for bit, and every counter ends at 0."""
    from mmvqa_tpu_torch.ops import token_head

    cases = [_token_head_inputs(dev, dtype, 16, P, K, 768, "nhwc")
             for dtype, P, K in ((torch.bfloat16, 112 * 112, 24),
                                 (torch.bfloat16, 7 * 7, 512),
                                 (torch.float32, 28 * 28, 80))]
    want = [token_head_backward(*case, "serf") for case in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in cases]
    got = [[] for _ in cases]
    for _ in range(3):
        for i, (stream, case) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(stream):
                torch.cuda._sleep(1000)
                got[i].append(token_head_backward(*case, "serf"))
    torch.cuda.synchronize()
    for (dx, dw), runs in zip(want, got):
        for rdx, rdw in runs:
            assert torch.equal(rdx, dx) and torch.equal(rdw, dw)
    device = cases[0][0].device
    for s in streams:
        assert not token_head._BARRIERS[(device, s.cuda_stream)].any()


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
    counts = (fused_token_head.launches, fused_token_head.backward_launches,
              fused_token_head.tf32x3_launches)
    (fused_token_head(x1, w1, act).float() * gout).sum().backward()
    torch.cuda.synchronize()
    # fp32's forward on its split-TF32 kernel
    assert (fused_token_head.launches, fused_token_head.backward_launches,
            fused_token_head.tf32x3_launches) == (
        counts[0] + 1, counts[1] + 1, counts[2] + (0 if master else 1))
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [97, 99, 100, 128, 130, 200, 512])
@pytest.mark.parametrize("with_prev,with_mask", [(False, False), (True, True)])
def test_attention_long_sequences_match_plain(dev, dtype, T, with_prev,
                                              with_mask):
    """Around and beyond what one block's shared memory holds (the fp32
    backward at T=97 and 99 in one block, T=100 tiled; the forward at T=128
    on the tensor cores, at T=130 in one block, T=200 tiled): forward and
    backward against the plain versions, at the flagship's 8 heads of
    96."""
    g = _gen(dev)
    B, H, E = 2, 8, 96
    kqv = torch.randn(B, T, H, 3 * E, device=dev, generator=g).to(dtype)
    k, q, v = kqv.split(E, dim=-1)
    prev = (torch.randn(B, H, T, T, device=dev, generator=g)
            if with_prev else None)
    mask = None
    if with_mask:
        mask = torch.ones(B, T, device=dev)
        mask[1, T // 3:] = 0.0
    counts = (realformer_attention.launches,
              realformer_attention.backward_launches)
    ctx, carry = realformer_attention(q, k, v, prev, mask)
    dctx = torch.randn(B, T, H, E, device=dev, generator=g).to(dtype)
    dcarry = (0.1 * torch.randn(B, H, T, T, device=dev, generator=g)
              if with_prev else None)
    dkqv, dprev = realformer_attention_backward(kqv, carry, dctx, dcarry,
                                                with_prev)
    torch.cuda.synchronize()
    assert (realformer_attention.launches,
            realformer_attention.backward_launches) == (counts[0] + 1,
                                                        counts[1] + 1)
    ctx_p, carry_p = realformer_attention_reference(q, k, v, prev, mask)
    torch.testing.assert_close(carry, carry_p, rtol=2e-5, atol=2e-4)
    tol = (dict(rtol=5e-3, atol=2e-3) if dtype == torch.float32
           else TOL[torch.bfloat16])
    torch.testing.assert_close(ctx.float(), ctx_p.float(), **tol)
    dq, dk, dv, ds = realformer_attention_backward_reference(
        q, k, v, carry, dctx, dcarry)
    # tests/test_pallas_attention.py:92 for fp32, relative to the largest
    # entry; bf16 outputs are one rounding of the same fp32 values
    rel = 5e-4 if dtype == torch.float32 else 8e-3
    for got, want in zip(dkqv.split(E, dim=-1), (dk, dq, dv)):
        _normwise(got, want, rel)
    if with_prev:
        _normwise(dprev, ds, 5e-4)
    else:
        assert dprev is None


def _k2_bwd_case(dev, B, T, layout, with_prev, with_mask):
    """bf16 kqv at 8 heads of 96 laid out as the train step gives it
    ("packed": the projection's (B, T, H, 3E) output), as a (B, H, T, 3E)
    buffer's permuted view ("strided"), or one element past a 16-byte
    boundary ("unaligned": the kernel's element copies); the forward's carry
    from the kernel."""
    g = _gen(dev)
    H, E = 8, 96
    if layout == "strided":
        kqv = torch.randn(B, H, T, 3 * E, device=dev, generator=g)
        kqv = kqv.bfloat16().permute(0, 2, 1, 3)
    elif layout == "unaligned":
        flat = torch.randn(B * T * H * 3 * E + 1, device=dev, generator=g)
        kqv = flat.bfloat16()[1:].view(B, T, H, 3 * E)
    else:
        kqv = torch.randn(B, T, H, 3 * E, device=dev, generator=g).bfloat16()
    k, q, v = kqv.split(E, dim=-1)
    prev = (torch.randn(B, H, T, T, device=dev, generator=g)
            if with_prev else None)
    mask = None
    if with_mask:
        mask = torch.ones(B, T, device=dev)
        mask[1, T // 3:] = 0.0
    _, carry = realformer_attention(q, k, v, prev, mask)
    return kqv, q, k, v, carry, g


@pytest.mark.parametrize("T", [17, 28, 75, 125])
@pytest.mark.parametrize("layout", ["packed", "strided", "unaligned"])
@pytest.mark.parametrize("with_prev,with_mask,with_dctx,with_dcarry", [
    (False, False, True, False), (False, True, True, True),
    (True, True, True, True), (True, True, True, False),
    (True, False, False, True)])
def test_attention_bf16_backward_tensor_core_kernel_matches_plain(
        dev, T, layout, with_prev, with_mask, with_dctx, with_dcarry):
    """The tensor-core backward against the plain version at the flagship's
    two lengths, a ragged one and the longest it takes at E=96 (125), within
    chip_smoke.py's TOL_K2_BWD_BF16 (dq, dk, dv) and TOL_K2_BWD (dprev);
    dctx a strided view; two runs give the same bits; its own launch
    counter moves, no other kernel runs."""
    assert backward_path(torch.bfloat16, T, 96) == "mma"
    B, E = 4, 96
    kqv, q, k, v, carry, g = _k2_bwd_case(dev, B, T, layout, with_prev,
                                          with_mask)
    dctx = None
    if with_dctx:  # the output projection's gradient as a strided view
        dctx = torch.randn(B, T, 8, 2 * E, device=dev, generator=g)
        dctx = dctx.bfloat16()[..., E // 2:E // 2 + E]
    dcarry = (0.1 * torch.randn(B, 8, T, T, device=dev, generator=g)
              if with_dcarry else None)
    counts = (realformer_attention.backward_launches,
              realformer_attention.backward_mma_launches)
    dkqv, dprev = realformer_attention_backward(kqv, carry, dctx, dcarry,
                                                with_prev)
    again = realformer_attention_backward(kqv, carry, dctx, dcarry,
                                          with_prev)
    torch.cuda.synchronize()
    assert (realformer_attention.backward_launches,
            realformer_attention.backward_mma_launches) == (counts[0] + 2,
                                                           counts[1] + 2)
    assert torch.equal(again[0], dkqv)
    dq, dk, dv, ds = realformer_attention_backward_reference(
        q, k, v, carry, dctx, dcarry)
    torch.testing.assert_close(dkqv.float(),
                               torch.cat([dk, dq, dv], dim=-1).float(),
                               rtol=8e-3, atol=5e-5)
    if with_prev:
        assert torch.equal(again[1], dprev)
        torch.testing.assert_close(dprev, ds, rtol=5e-4, atol=5e-5)
    else:
        assert dprev is None


def test_attention_bf16_backward_is_one_tensor_core_kernel(dev):
    """At the train shape the backward launches realformer_attn_bwd_mma
    alone, once a call; fp32 its split-TF32 kernel,
    realformer_attn_bwd_tf32x3."""
    kqv, q, k, v, carry, g = _k2_bwd_case(dev, 8, 75, "packed", True, True)
    dctx = torch.randn(8, 75, 8, 96, device=dev, generator=g).bfloat16()
    for dtype, want in ((torch.bfloat16, "realformer_attn_bwd_mma"),
                        (torch.float32, "realformer_attn_bwd_tf32x3")):
        args = (kqv.to(dtype), carry, dctx.to(dtype), carry, True)
        realformer_attention_backward(*args)
        ours = [(key, n) for key, n in _device_kernels(
            lambda: realformer_attention_backward(*args),
            counter=(realformer_attention, "backward_mma_launches"
                     if dtype == torch.bfloat16
                     else "backward_tf32x3_launches"))
            if "realformer_attn_bwd" in key]
        assert (len(ours) == 1 and want in ours[0][0]
                and 0 < ours[0][1] <= 1), ours


# ------------------------------------ fp32 on the tensor cores ----

# chip_smoke.py's fp32 tolerances: TOL_K2_CARRY, TOL_K2_VALID (ctx on the
# valid query rows), TOL_K2_PADDED (every row: the -10000 term's fp32 ulp)
# and TOL_K2_BWD (dq, dk, dv, dprev)
K2_CARRY = dict(rtol=2e-5, atol=2e-4)
K2_VALID = dict(rtol=2e-5, atol=2e-5)
K2_PADDED = dict(rtol=5e-3, atol=2e-3)
K2_BWD = dict(rtol=5e-4, atol=5e-5)


def _k2_fp32_case(dev, B, T, layout, with_prev, with_mask, E=96):
    """fp32 kqv (B, T, 8, 3E) laid out as the train step gives it
    ("packed"), as a (B, H, T, 3E) buffer's permuted view ("strided"), or
    one element past a 16-byte boundary ("unaligned": the kernels' element
    copies; prev then one float off the carry's offset within 16 bytes, so
    it comes in by plain loads too); prev or None; a ragged mask or None,
    and the valid query rows."""
    g = _gen(dev)
    H = 8
    if layout == "strided":
        kqv = torch.randn(B, H, T, 3 * E, device=dev, generator=g)
        kqv = kqv.permute(0, 2, 1, 3)
    elif layout == "unaligned":
        flat = torch.randn(B * T * H * 3 * E + 1, device=dev, generator=g)
        kqv = flat[1:].view(B, T, H, 3 * E)
    else:
        kqv = torch.randn(B, T, H, 3 * E, device=dev, generator=g)
    prev = None
    if with_prev:
        prev = torch.randn(B * H * T * T + 1, device=dev, generator=g)
        prev = (prev[1:] if layout == "unaligned" else prev[:-1]).view(
            B, H, T, T)
    mask = None
    valid = torch.ones(B, T, dtype=torch.bool, device=dev)
    if with_mask:
        lengths = torch.randint(1, T + 1, (B,), device=dev, generator=g)
        valid = torch.arange(T, device=dev)[None] < lengths[:, None]
        mask = valid.float()
    return kqv, prev, mask, valid, g


def _counts(*attrs):
    return tuple(getattr(realformer_attention, a) for a in attrs)


@pytest.mark.parametrize("T", [1, 17, 28, 33, 75, 96, 128])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("layout", ["packed", "strided", "unaligned"])
@pytest.mark.parametrize("with_prev,with_mask", [
    (False, False), (False, True), (True, True)])
def test_attention_fp32_forward_tensor_core_kernel_matches_plain(
        dev, T, B, layout, with_prev, with_mask):
    """The split-TF32 forward against the plain version at ragged T up to
    the longest it takes at E=96 (128), at one image too: the carry within
    K2_CARRY, ctx within K2_VALID on the valid rows and K2_PADDED on all;
    two runs give the same bits; one launch a call, on its own counter."""
    assert forward_path(torch.float32, T, 96) == "mma"
    kqv, prev, mask, valid, _ = _k2_fp32_case(dev, B, T, layout, with_prev,
                                              with_mask)
    k, q, v = kqv.split(96, dim=-1)
    attrs = ("launches", "mma_launches", "tf32x3_launches")
    before = _counts(*attrs)
    ctx, carry = realformer_attention(q, k, v, prev, mask)
    again = realformer_attention(q, k, v, prev, mask)
    torch.cuda.synchronize()
    assert _counts(*attrs) == (before[0] + 2, before[1], before[2] + 2)
    assert torch.equal(again[0], ctx) and torch.equal(again[1], carry)
    ctx_p, carry_p = realformer_attention_reference(q, k, v, prev, mask)
    torch.testing.assert_close(carry, carry_p, **K2_CARRY)
    torch.testing.assert_close(ctx[valid], ctx_p[valid], **K2_VALID)
    torch.testing.assert_close(ctx, ctx_p, **K2_PADDED)


@pytest.mark.parametrize("T", [1, 17, 28, 33, 75, 96])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("layout", ["packed", "strided", "unaligned"])
@pytest.mark.parametrize("with_prev,with_mask,with_dctx,with_dcarry", [
    (False, False, True, False), (False, True, True, True),
    (True, True, True, True), (True, True, True, False),
    (True, False, False, True)])
def test_attention_fp32_backward_tensor_core_kernel_matches_plain(
        dev, T, B, layout, with_prev, with_mask, with_dctx, with_dcarry):
    """The split-TF32 backward against the plain version at ragged T up to
    the longest it takes at E=96 (96), at one image too, from the kernel's
    own carry: dq, dk, dv and dprev within K2_BWD; dctx a strided view or
    None; two runs give the same bits; one launch a call, on its own
    counter."""
    assert backward_path(torch.float32, T, 96) == "mma"
    E = 96
    kqv, prev, mask, _, g = _k2_fp32_case(dev, B, T, layout, with_prev,
                                          with_mask)
    k, q, v = kqv.split(E, dim=-1)
    _, carry = realformer_attention(q, k, v, prev, mask)
    dctx = None
    if with_dctx:  # the output projection's gradient as a strided view
        dctx = torch.randn(B, T, 8, 2 * E, device=dev, generator=g)
        dctx = dctx[..., E // 2:E // 2 + E]
    dcarry = (0.1 * torch.randn(B, 8, T, T, device=dev, generator=g)
              if with_dcarry else None)
    attrs = ("backward_launches", "backward_mma_launches",
             "backward_tf32x3_launches")
    before = _counts(*attrs)
    dkqv, dprev = realformer_attention_backward(kqv, carry, dctx, dcarry,
                                                with_prev)
    again = realformer_attention_backward(kqv, carry, dctx, dcarry,
                                          with_prev)
    torch.cuda.synchronize()
    assert _counts(*attrs) == (before[0] + 2, before[1], before[2] + 2)
    assert torch.equal(again[0], dkqv)
    dq, dk, dv, ds = realformer_attention_backward_reference(
        q, k, v, carry, dctx, dcarry)
    torch.testing.assert_close(dkqv, torch.cat([dk, dq, dv], dim=-1),
                               **K2_BWD)
    if with_prev:
        assert torch.equal(again[1], dprev)
        torch.testing.assert_close(dprev, ds, **K2_BWD)
    else:
        assert dprev is None


@pytest.mark.parametrize("E,T", [(16, 17), (16, 128), (48, 75), (64, 96),
                                 (128, 33), (128, 80), (128, 112)])
def test_attention_fp32_tensor_core_kernels_at_other_widths(dev, E, T):
    """Head widths other than the flagship's, rows of E rounded up to 32
    (E=16 and 48 read padded columns), the backward at T=128 where E=16,
    up to the longest head each direction takes at E=128 (forward T=112,
    backward T=80), with prev and a ragged mask: one launch each way on the
    split-TF32 kernels where backward_path sends it there, within the fp32
    tolerances."""
    assert forward_path(torch.float32, T, E) == "mma"
    kqv, prev, mask, valid, g = _k2_fp32_case(dev, 3, T, "packed", True,
                                              True, E)
    k, q, v = kqv.split(E, dim=-1)
    before = _counts("tf32x3_launches", "backward_tf32x3_launches")
    ctx, carry = realformer_attention(q, k, v, prev, mask)
    ctx_p, carry_p = realformer_attention_reference(q, k, v, prev, mask)
    torch.testing.assert_close(carry, carry_p, **K2_CARRY)
    torch.testing.assert_close(ctx[valid], ctx_p[valid], **K2_VALID)
    torch.testing.assert_close(ctx, ctx_p, **K2_PADDED)
    backward = backward_path(torch.float32, T, E) == "mma"
    if backward:
        dctx = torch.randn(3, T, 8, E, device=dev, generator=g)
        dcarry = 0.1 * torch.randn(3, 8, T, T, device=dev, generator=g)
        dkqv, dprev = realformer_attention_backward(kqv, carry, dctx, dcarry,
                                                    True)
        dq, dk, dv, ds = realformer_attention_backward_reference(
            q, k, v, carry, dctx, dcarry)
        torch.testing.assert_close(dkqv, torch.cat([dk, dq, dv], dim=-1),
                                   **K2_BWD)
        torch.testing.assert_close(dprev, ds, **K2_BWD)
    torch.cuda.synchronize()
    assert _counts("tf32x3_launches", "backward_tf32x3_launches") == (
        before[0] + 1, before[1] + int(backward))


def test_attention_fp32_occupancy_follows_the_shared_memory_formulas(dev):
    """The card's answer for the split-TF32 kernels at E=96 against
    ops/attention.py's shared-memory formulas: at the train shape (T=75)
    the forward holds what its shared memory allows of an SM's 228 KB, a
    block's 1 KB reserve included (two), the backward one; the longest
    heads each direction takes (T=128 and T=96) get a block; the backward
    at T=97 is refused."""
    from mmvqa_tpu_torch.ops.attention import (
        forward_tf32x3_smem_bytes,
        mma_occupancy,
        tf32x3_smem_bytes,
    )

    f32 = torch.float32
    assert mma_occupancy(75, 96, False, f32) == 233472 // (
        forward_tf32x3_smem_bytes(75, 96) + 1024) == 2
    assert mma_occupancy(75, 96, True, f32) == 233472 // (
        tf32x3_smem_bytes(75, 96) + 1024) == 1
    assert mma_occupancy(128, 96, False, f32) >= 1
    assert mma_occupancy(96, 96, True, f32) >= 1
    with pytest.raises(RuntimeError):
        mma_occupancy(97, 96, True, f32)


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


def _depthwise_inputs(dev, dtype, weight, B, H, W, C):
    g = _gen(dev)
    x = torch.randn(B, H, W, C, device=dev, generator=g).to(dtype)
    dy = torch.randn(B, H, W, C, device=dev, generator=g).to(dtype)
    if weight == "master":  # the convolution's fp32 (C, 1, 3, 3), as a view
        w = (torch.randn(C, 1, 3, 3, device=dev, generator=g)
             * 0.3)[:, 0].permute(1, 2, 0)
    else:                   # a dense bf16 (3, 3, C)
        w = (torch.randn(3, 3, C, device=dev, generator=g)
             * 0.3).bfloat16()
    return x, w, dy


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("weight", ["master", "bf16"])
@pytest.mark.parametrize("B,H,W,C", [
    (2, 5, 3, 24), (3, 5, 3, 36), (2, 5, 3, 100), (2, 56, 56, 36),
    (2, 56, 56, 100), (2, 112, 112, 24),
])
def test_depthwise_halo_tiles_match_plain(dev, dtype, weight, B, H, W, C):
    """Ragged channel counts (16-byte rows or not), a plane narrower than
    the stencil, and a plane that the plan cuts into strips; two backward
    runs give the same bits."""
    from mmvqa_tpu_torch.ops import tiling

    x, w, dy = _depthwise_inputs(dev, dtype, weight, B, H, W, C)
    if (H, W) == (112, 112):
        plan = tiling.depthwise_plan(B, H, W, C, x.element_size(),
                                     tiling.sm_count(x), True)
        assert plan.nstrip > 1
    y = depthwise3x3(x, w)
    dx, dw = depthwise3x3_backward(x, w, dy)
    again = depthwise3x3_backward(x, w, dy)
    torch.cuda.synchronize()
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)
    xf, wf = x.float(), w.to(dtype).float()
    tol = (dict(rtol=2e-5, atol=1e-5) if dtype == torch.float32
           else TOL[torch.bfloat16])
    torch.testing.assert_close(y.float(), depthwise3x3_reference(xf, wf),
                               **tol)
    dx_p, dw_p = depthwise3x3_backward_reference(xf, wf, dy.float())
    _normwise(dx, dx_p, 1e-4 if dtype == torch.float32 else 8e-3)
    _normwise(dw, dw_p, 1e-4)


def _unaligned(t):
    """t's values in a dense map whose base lies one element past a 16-byte
    boundary: no 16-byte copy can start its rows."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,W,C", [
    (4, 14, 14, 1056), (5, 7, 7, 1824), (2, 112, 112, 24), (3, 9, 20, 64),
])
def test_depthwise_copy_paths_give_the_same_bits(dev, dtype, B, H, W, C):
    """TMA (aligned maps) and element copies (a map whose base is not
    16-byte aligned) stage the same halo tiles: the same outputs, bit for
    bit, forward and backward."""
    from mmvqa_tpu_torch.ops import depthwise, tiling

    x, w, dy = _depthwise_inputs(dev, dtype, "master", B, H, W, C)
    xu, dyu = _unaligned(x), _unaligned(dy)
    assert depthwise._plan(x, x).copy == tiling.COPY_TMA
    assert depthwise._plan(xu, x).copy == tiling.COPY_ELEMENTS
    y, yu = depthwise3x3(x, w), depthwise3x3(xu, w)
    dx, dw = depthwise3x3_backward(x, w, dy)
    dxu, dwu = depthwise3x3_backward(xu, w, dyu)
    torch.cuda.synchronize()
    assert torch.equal(y, yu)
    assert torch.equal(dx, dxu) and torch.equal(dw, dwu)


def test_depthwise_backward_is_one_kernel(dev):
    """dW's partials are added inside the backward kernel: no second kernel
    runs, and the tile counters are back at zero after the call."""
    from mmvqa_tpu_torch.ops import depthwise

    x, w, dy = _depthwise_inputs(dev, torch.bfloat16, "master", 16, 14, 14,
                                 1056)
    depthwise3x3_backward(x, w, dy)
    names = [key for key, _ in _device_kernels(
        lambda: depthwise3x3_backward(x, w, dy),
        counter=(depthwise3x3, "backward_launches"))]
    assert any("depthwise3x3_bwd" in n for n in names), names
    assert not any("dw_reduce" in n for n in names), names
    stream = torch.cuda.current_stream(x.device).cuda_stream
    assert not depthwise._COUNTERS[(x.device, stream)].any()


def test_depthwise_backward_on_two_streams_at_once(dev):
    """Backward calls queued on two streams at once each count their
    blocks in their own stream's counters: every dW is the one a call on
    the default stream gives, bit for bit, and every counter ends at 0."""
    from mmvqa_tpu_torch.ops import depthwise

    shapes = [(64, 14, 14, 1056), (128, 7, 7, 1824)]
    cases = [_depthwise_inputs(dev, torch.bfloat16, "master", *shape)
             for shape in shapes]
    want = [depthwise3x3_backward(*case) for case in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    got = [[], []]
    for _ in range(4):
        for i, (stream, case) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(stream):
                torch.cuda._sleep(1000)
                got[i].append(depthwise3x3_backward(*case))
    torch.cuda.synchronize()
    for (dx, dw), runs in zip(want, got):
        for rdx, rdw in runs:
            assert torch.equal(rdx, dx) and torch.equal(rdw, dw)
    device = cases[0][0].device
    for s in streams:
        assert not depthwise._COUNTERS[(device, s.cuda_stream)].any()


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
    before = (conv1x1_stats.launches, conv1x1_stats.tma_launches)
    y, stats = conv1x1_stats(x, w)
    torch.cuda.synchronize()
    tma = dtype == torch.bfloat16 and wt and K % 8 == 0 and C % 8 == 0
    assert (conv1x1_stats.launches,
            conv1x1_stats.tma_launches) == (before[0] + 1, before[1] + tma)
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


# the trunk's ragged K and C (176, 304, 1056, 1824: K past its last full
# 64-deep box, C past its last column tile) at small N, and N ragged
# against the 192-row tiles; each column tile (64, 128, 192)
TMA_SHAPES = [
    (700, 176, 1056), (300, 1824, 304), (129, 304, 1824), (1000, 1056, 176),
    (4099, 192, 48), (513, 320, 80), (257, 3072, 512), (130, 8, 8),
]


@pytest.mark.parametrize("N,K,C", TMA_SHAPES)
def test_conv1x1_stats_tma_path_matches_plain(dev, N, K, C):
    """The TMA + wgmma path against the plain version and against the
    mma.sync path on the same inputs (which it must take for a dense (K, C)
    w); two runs give the same bits; its counters end at 0."""
    from mmvqa_tpu_torch.ops import conv_bn

    g = _gen(dev)
    x = torch.randn(N, K, device=dev, generator=g).bfloat16()
    wt = (torch.randn(C, K, device=dev, generator=g) * K ** -0.5).bfloat16()
    before = conv1x1_stats.tma_launches
    y, stats = conv1x1_stats(x, wt.t())
    y2, stats2 = conv1x1_stats(x, wt.t())
    y_m, stats_m = conv1x1_stats(x, wt.t().contiguous())  # mma.sync
    torch.cuda.synchronize()
    assert conv1x1_stats.tma_launches == before + 2
    assert torch.equal(y2, y) and torch.equal(stats2, stats)
    y_p, stats_p = conv1x1_stats_reference(x, wt.t())
    for got, sums in ((y, stats), (y_m, stats_m)):
        torch.testing.assert_close(got.float(), y_p.float(),
                                   **TOL[torch.bfloat16])
        _normwise(sums[0], stats_p[0], 1e-4)
        _normwise(sums[1], stats_p[1], 1e-4)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    assert not conv_bn._COUNTERS[(x.device, stream)].any()


def test_conv1x1_stats_tma_path_is_one_kernel_on_two_streams(dev):
    """No reduce kernel on the TMA path; calls queued on two streams at once
    count into their own stream's counters and give the default stream's
    bits."""
    from mmvqa_tpu_torch.ops import conv_bn

    g = _gen(dev)
    cases = []
    for N, K, C in ((25088, 176, 1056), (100352, 320, 80), (6272, 3072, 512)):
        x = torch.randn(N, K, device=dev, generator=g).bfloat16()
        w = (torch.randn(C, K, device=dev, generator=g)
             * K ** -0.5).bfloat16().t()
        cases.append((x, w))
    want = [conv1x1_stats(x, w) for x, w in cases]
    names = [key for key, _ in _device_kernels(
        lambda: conv1x1_stats(*cases[0]),
        counter=(conv1x1_stats, "tma_launches"))]
    assert [n for n in names if "conv1x1" in n] == [
        n for n in names if "conv1x1_stats_tma" in n] != [], names
    streams = [torch.cuda.Stream(dev) for _ in cases]
    got = [[] for _ in cases]
    for _ in range(3):
        for i, (stream, (x, w)) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(stream):
                torch.cuda._sleep(1000)
                got[i].append(conv1x1_stats(x, w))
    torch.cuda.synchronize()
    for (y, st), runs in zip(want, got):
        for ry, rst in runs:
            assert torch.equal(ry, y) and torch.equal(rst, st)
    device = cases[0][0].device
    for s in streams:
        assert not conv_bn._COUNTERS[(device, s.cuda_stream)].any()


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
@pytest.mark.parametrize("C", [24, 1824, 3072, 301])
@pytest.mark.parametrize("aligned", [True, False])
def test_bn_backward_sums_is_one_launch(dev, dtype, C, aligned):
    """The stem's, the widest and an odd channel count (one channel a
    thread), on a map one element past a 16-byte boundary too: one kernel
    and no reduce kernel, the plain version's sums, two runs bit for bit,
    the counters back at 0."""
    from mmvqa_tpu_torch.ops import bn_sums

    g = _gen(dev)
    N = 6272 if C > 1000 else 25088
    flat = (torch.randn(N * C + 1, device=dev, generator=g) * 2 + 1)
    x = flat.to(dtype)[(0 if aligned else 1):][:N * C].view(N, C)
    dy = torch.randn(N, C, device=dev, generator=g).to(dtype)
    mean = torch.randn(C, device=dev, generator=g)
    inv_std = 1 + torch.rand(C, device=dev, generator=g)
    s1, s2 = bn_backward_sums(x, dy, mean, inv_std)
    runs = []
    ours = [(key, n) for key, n in _device_kernels(
        lambda: runs.append(bn_backward_sums(x, dy, mean, inv_std)),
        counter=(bn_backward_sums, "launches"))
        if "bn_backward" in key]
    assert (len(ours) == 1 and "bn_backward_sums_kernel" in ours[0][0]
            and 0 < ours[0][1] <= 1), ours
    for again in runs:
        assert torch.equal(again[0], s1) and torch.equal(again[1], s2)
    p1, p2 = bn_backward_sums_reference(x, dy, mean, inv_std)
    _normwise(s1, p1, 1e-4)
    _normwise(s2, p2, 1e-4)
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert not bn_sums._COUNTERS[(x.device, stream)].any()


def test_bn_backward_sums_on_three_streams_at_once(dev):
    """Calls queued on three streams at once count into their own stream's
    counters and give the default stream's bits."""
    from mmvqa_tpu_torch.ops import bn_sums

    g = _gen(dev)
    cases = []
    for N, C in ((401408, 48), (25088, 1056), (6272, 3072)):
        x = torch.randn(N, C, device=dev, generator=g).bfloat16()
        dy = torch.randn(N, C, device=dev, generator=g).bfloat16()
        mean = torch.randn(C, device=dev, generator=g)
        inv_std = 1 + torch.rand(C, device=dev, generator=g)
        cases.append((x, dy, mean, inv_std))
    want = [bn_backward_sums(*c) for c in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in cases]
    got = [[] for _ in cases]
    for _ in range(3):
        for i, (stream, c) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(stream):
                torch.cuda._sleep(1000)
                got[i].append(bn_backward_sums(*c))
    torch.cuda.synchronize()
    for (s1, s2), runs in zip(want, got):
        for r1, r2 in runs:
            assert torch.equal(r1, s1) and torch.equal(r2, s2)
    device = cases[0][0].device
    for s in streams:
        assert not bn_sums._COUNTERS[(device, s.cuda_stream)].any()


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



def test_token_head_forward_keeps_a_shared_memory_grant(dev):
    """The bf16 forward asks the card how many blocks an SM holds once for
    each new shape; that query must not lower the shared memory that a
    shape of the same kernel variant planned before was granted: K=80
    (104016 bytes), then a new shape at K=48 (70736, the same variant),
    then K=80 again. The shapes are ones no other test plans."""
    g = _gen(dev)

    def run(B, P, K):
        x = torch.randn(B, P, K, device=dev, generator=g).bfloat16()
        w = (torch.randn(K, 256, device=dev, generator=g)
             * K ** -0.5).bfloat16()
        torch.testing.assert_close(
            fused_token_head(x, w, "serf_fast").float(),
            token_head_reference(x, w, "serf_fast").float(),
            **TOL[torch.bfloat16])

    run(2, 1231, 80)
    run(3, 1237, 48)
    run(2, 1231, 80)


# ------------------------------------------------------ fine-tuning ----

def _recorder_state(device):
    from mmvqa_tpu_torch.core.config import vqa_config
    from mmvqa_tpu_torch.models import MMBert
    from mmvqa_tpu_torch.train.state import create_train_state

    cfg = vqa_config(cnn_encoder="tf_efficientnetv2_m",
                     transformer_model="realformer", hidden_size=64,
                     n_layers=1, tiny_cnn=True, image_size=32,
                     max_position_embeddings=12, num_classes=7,
                     vocab_size=1300, dropout_override=0.0, grad_accum=2)
    model = MMBert(cfg, device=device,
                   generator=torch.Generator().manual_seed(0))
    return cfg, create_train_state(model, 1e-3, grad_accum=2)


def _recorder_values(state):
    """Everything a recorder holds, on the CPU, in a comparable form."""
    opt = state.optimizer.state_dict()
    return ({k: v.cpu() for k, v in state.model.state_dict().items()},
            {i: {k: v.cpu() for k, v in s.items()}
             for i, s in opt["state"].items()},
            opt["param_groups"], state.step, state.mini_step,
            {k: v.cpu() for k, v in (state.acc_grads or {}).items()})


def _same_recorder(a, b):
    sd_a, opt_a, groups_a, *rest_a, acc_a = a
    sd_b, opt_b, groups_b, *rest_b, acc_b = b
    assert sd_a.keys() == sd_b.keys() and acc_a.keys() == acc_b.keys()
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
    assert all(torch.equal(acc_a[k], acc_b[k]) for k in acc_a)
    assert opt_a.keys() == opt_b.keys() and groups_a == groups_b
    assert all(torch.equal(opt_a[i][k], opt_b[i][k])
               for i in opt_a for k in opt_a[i])
    assert rest_a == rest_b


def test_recorder_moves_between_the_card_and_the_cpu_bit_for_bit(
        dev, tmp_path):
    """A recorder written from a model on the card, mid-accumulation after a
    real update, restores into a model on the CPU, and one written from
    there into a model on the card, with every tensor's bits."""
    from mmvqa_tpu_torch.data.synthetic import vqa_batches
    from mmvqa_tpu_torch.train import checkpoint
    from mmvqa_tpu_torch.train.steps import make_vqa_steps

    cfg, state = _recorder_state(dev)
    step, _ = make_vqa_steps(state.model, cfg)
    for b in vqa_batches(cfg.replace(batch_size=4), 3, 7, seed=1):
        state, _ = step(state, b)
    assert state.mini_step == 1 and state.optimizer.state
    checkpoint.save_recorder(str(tmp_path / "card"), 2, state, {"best": 1.5})
    want = _recorder_values(state)

    _, cpu = _recorder_state("cpu")
    cpu, sched, epoch = checkpoint.restore_recorder(str(tmp_path / "card"),
                                                    cpu)
    assert (sched, epoch) == ({"best": 1.5}, 2)
    assert next(cpu.model.parameters()).device.type == "cpu"
    assert all(v.device.type == "cpu" for v in cpu.acc_grads.values())
    _same_recorder(_recorder_values(cpu), want)

    checkpoint.save_recorder(str(tmp_path / "cpu"), 2, cpu, sched)
    _, back = _recorder_state(dev)
    back, _, _ = checkpoint.restore_recorder(str(tmp_path / "cpu"), back)
    assert all(v.device.type == dev.type for v in back.acc_grads.values())
    assert all(s["exp_avg"].device.type == dev.type
               for s in back.optimizer.state.values())
    _same_recorder(_recorder_values(back), want)
    back, _ = make_vqa_steps(back.model, cfg)[0](back, b)  # it trains on
    assert back.mini_step == 0


@pytest.fixture(scope="module")
def finetune_launches():
    """Launch counts of one bf16 fine-tune step of the flagship VQA model at
    B=16 (224 px, T=28), after one that warms up."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mmvqa_tpu_torch.core.config import vqa_config
    from mmvqa_tpu_torch.data.synthetic import vqa_batches
    from mmvqa_tpu_torch.models import MMBert
    from mmvqa_tpu_torch.models.mmbert import compute_dtype_of
    from mmvqa_tpu_torch.ops.conv_bn import conv1x1_stats
    from mmvqa_tpu_torch.train.state import create_train_state
    from mmvqa_tpu_torch.train.steps import make_vqa_steps

    cfg = vqa_config(cnn_encoder="tf_efficientnetv2_m",
                     transformer_model="realformer", mixed_precision=True,
                     num_classes=64)
    model = MMBert(cfg, compute_dtype=compute_dtype_of(cfg),
                   generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg.lr)
    step, _ = make_vqa_steps(model, cfg)
    batch = vqa_batches(cfg, 1, 64, seed=0)[0]
    state, _ = step(state, batch)
    counters = ((realformer_attention, "launches"),
                (realformer_attention, "mma_launches"),
                (realformer_attention, "backward_launches"),
                (realformer_attention, "backward_mma_launches"),
                (conv1x1_stats, "launches"), (conv1x1_stats, "tma_launches"))
    before = [getattr(fn, attr) for fn, attr in counters]
    state, m = step(state, batch)
    torch.cuda.synchronize()
    assert torch.isfinite(m["loss"])
    return {attr if fn is realformer_attention else "conv1x1_" + attr:
            getattr(fn, attr) - b0 for (fn, attr), b0 in zip(counters, before)}


def test_finetune_step_attention_takes_the_tensor_core_kernels(
        finetune_launches):
    n = finetune_launches
    assert n["launches"] == n["mma_launches"] == 4
    assert n["backward_launches"] == n["backward_mma_launches"] == 4


def test_finetune_step_conv1x1_takes_tma_at_every_site(finetune_launches):
    n = finetune_launches
    assert n["conv1x1_launches"] == n["conv1x1_tma_launches"] == 98


def test_host_decoder_and_load_image_on_the_card_machine(dev, tmp_path):
    """The host build (``native/jpeg_decode.cpp``, the numpy resize) on the
    card's machine: a fixture the port writes there decodes, and resizes
    through ``load_image``, to the pixels the smoke's pinned digest holds
    (tests/test_torch_jpeg.py holds the same files to PIL on the CPU)."""
    import os
    import sys

    from mmvqa_tpu_torch.data.fixtures import make_roco_fixture
    from mmvqa_tpu_torch.data.images import load_image

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    root = make_roco_fixture(str(tmp_path), 3, 0, chip_smoke.SEED,
                             chip_smoke.CLI_IMAGE_SIZE)
    assert chip_smoke.decode_digest(root) == chip_smoke.DECODE_DIGEST
    img = load_image(os.path.join(
        root, "train/radiology/images/ROCO_train_0002.jpg"), 224)
    assert img.shape == (224, 224, 3) and img.dtype.name == "uint8"
    x = torch.from_numpy(img).to(dev)
    assert int(x.sum()) == int(img.astype("int64").sum())


# ----------------------------------------------------- SupCon pretraining ----

def test_supcon_step_on_the_card_matches_the_cpu_plain_path(dev):
    """One fp32 SupCon train step (two views of 4 images, the Jaccard mask)
    on the card and on the CPU plain path from the same weights, batch and
    draws: the loss and its two parts to 1e-4 relative, the gradients of the
    projection head and of the token head's first tap within 2e-3 of their
    largest entry; the step went through the kernels."""
    import copy

    import numpy as np

    from mmvqa_tpu_torch.core.config import supcon_config
    from mmvqa_tpu_torch.data.images import sample_draws
    from mmvqa_tpu_torch.data.synthetic import mlm_batches
    from mmvqa_tpu_torch.models import MMBert
    from mmvqa_tpu_torch.similarity import SimilarityCalculator
    from mmvqa_tpu_torch.train.state import create_train_state
    from mmvqa_tpu_torch.train.steps import make_supcon_steps

    cfg = supcon_config(cnn_encoder="tf_efficientnetv2_m",
                        transformer_model="realformer", hidden_size=64,
                        n_layers=1, tiny_cnn=True, image_size=32,
                        vocab_size=1300, batch_size=4, dropout_override=0.0)
    b0, b1 = mlm_batches(cfg, 2, seed=3)
    batch = dict(b0, aug_tokens=(b1["tokens"] * b0["input_mask"]).astype(
        np.int32), aug_labels=(b1["labels"] * b0["input_mask"]).astype(
        np.int32))
    sim = SimilarityCalculator("jaccard")(
        ["a b c", "a d", "e f g", "b c"], ["a b", "d e", "f g", "c a b"])
    gen = torch.Generator().manual_seed(0)
    draws = (sample_draws(4, 32, gen), sample_draws(4, 32, gen))
    cpu = MMBert(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(dev)
    leaves = ("head_0.weight", "head_2.weight", "trans.token_conv_0.weight")

    def run(model):
        grads = {}
        state = create_train_state(model, cfg.lr)
        apply = state.apply_gradients

        def keep():
            grads.update({n: p.grad.detach().cpu().clone() for n, p in
                          model.named_parameters() if n in leaves})
            apply()

        state.apply_gradients = keep
        step, _ = make_supcon_steps(model, cfg)
        _, m = step(state, batch, draws, sim_mask=sim)
        return {k: float(m[k]) for k in ("loss", "mlm_loss",
                                         "supcon_loss")}, grads

    want, want_g = run(cpu)
    before = fused_token_head.backward_launches
    got, got_g = run(card)
    torch.cuda.synchronize()
    assert fused_token_head.backward_launches > before
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    for n in leaves:
        scale = want_g[n].abs().max()
        assert scale > 0 and (got_g[n] - want_g[n]).abs().max() <= 2e-3 * scale


# ------------------------------------------ fp32 on the tensor cores ----
# K4 and K1-bwd in fp32 take split-TF32 kernels (csrc/tf32x3.cuh) at every
# shape; chip_smoke.py's tolerances: K4's y TOL_K4_F32 (rtol and atol 2e-5)
# and its sums 1e-4 of their largest entry, K1-bwd's dx and dW RTOL_K1_BWD
# (1e-4) of their largest entry.

# ragged N, K and C (K no multiple of 4 or 32, C no multiple of a column
# tile), W as the trunk passes it (the (C, K) weight's view), dense (K, C)
# and by strides (element copies), the deep K at B=16's 7x7 sites
TF32X3_K4_SHAPES = [
    (1, 1, 1, "t"), (37, 3, 5, "dense"), (700, 24, 64, "dense"),
    (513, 176, 1056, "t"), (300, 35, 77, "strided"), (129, 304, 65, "t"),
    (4099, 96, 48, "t"), (999, 1824, 304, "t"), (257, 3072, 512, "t"),
    (784, 1824, 304, "t"), (3136, 1056, 176, "strided"),
]


def _k4_fp32_inputs(dev, N, K, C, layout):
    g = _gen(dev)
    x = torch.randn(N, K, device=dev, generator=g)
    if layout == "t":
        w = (torch.randn(C, K, device=dev, generator=g) * K ** -0.5).t()
    elif layout == "strided":
        w = (torch.randn(C, 2 * K, device=dev, generator=g)
             * K ** -0.5)[:, ::2].t()
    else:
        w = torch.randn(K, C, device=dev, generator=g) * K ** -0.5
    return x, w


@pytest.mark.parametrize("N,K,C,layout", TF32X3_K4_SHAPES)
def test_conv1x1_stats_fp32_split_tf32_matches_plain(dev, N, K, C, layout):
    """One launch, counted on both counters; y and the sums within the
    smoke's fp32 tolerances of the plain version; two runs give the same
    bits; the stream's last-block counters end at 0."""
    from mmvqa_tpu_torch.ops import conv_bn

    x, w = _k4_fp32_inputs(dev, N, K, C, layout)
    before = (conv1x1_stats.launches, conv1x1_stats.tf32x3_launches)
    y, stats = conv1x1_stats(x, w)
    y2, stats2 = conv1x1_stats(x, w)
    torch.cuda.synchronize()
    assert (conv1x1_stats.launches, conv1x1_stats.tf32x3_launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(y2, y) and torch.equal(stats2, stats)
    y_p, stats_p = conv1x1_stats_reference(x, w)
    torch.testing.assert_close(y, y_p, rtol=2e-5, atol=2e-5)
    _normwise(stats[0], stats_p[0], 1e-4)
    _normwise(stats[1], stats_p[1], 1e-4)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    assert not conv_bn._COUNTERS[(x.device, stream)].any()


def test_conv1x1_stats_fp32_is_one_kernel_on_two_streams(dev):
    """No reduce kernel in fp32 either: the last block of a column tile adds
    the partials. Calls queued on two streams at once count into their own
    stream's counters and give the default stream's bits."""
    from mmvqa_tpu_torch.ops import conv_bn

    cases = [_k4_fp32_inputs(dev, *shape, "t")
             for shape in ((25088, 176, 1056), (784, 1824, 304),
                           (100352, 320, 80))]
    want = [conv1x1_stats(x, w) for x, w in cases]
    names = [key for key, _ in _device_kernels(
        lambda: [conv1x1_stats(x, w) for x, w in cases])]
    assert [n for n in names if "conv1x1" in n] == [
        n for n in names if "conv1x1_stats_tf32x3" in n] != [], names
    streams = [torch.cuda.Stream(dev) for _ in cases]
    got = [[] for _ in cases]
    for _ in range(3):
        for i, (stream, (x, w)) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(stream):
                torch.cuda._sleep(1000)
                got[i].append(conv1x1_stats(x, w))
    torch.cuda.synchronize()
    for (y, st), runs in zip(want, got):
        for ry, rst in runs:
            assert torch.equal(ry, y) and torch.equal(rst, st)
    device = cases[0][0].device
    for s in streams:
        assert not conv_bn._COUNTERS[(device, s.cuda_stream)].any()


# both modes: rows (K <= 96: K in 32s of 32, 64 and 96, row tiles of 64 and
# 32) and tiles (dW's rows in one segment, and in several: the second
# barrier), ragged K, P and C, x as the trunk gives it and transposed
TF32X3_K1_CASES = [
    ("serf", 2, 112 * 112, 24, 768, "nhwc"),
    ("relu", 3, 130, 40, 776, "dense"),
    ("serf_fast", 2, 1000, 96, 200, "nchw"),
    ("serf", 3, 37, 3, 100, "dense"),
    ("serf", 16, 14 * 14, 176, 768, "nhwc"),
    ("serf", 16, 7 * 7, 512, 768, "nhwc"),
    ("serf_fast", 5, 9, 600, 100, "nchw"),
    ("relu", 4, 700, 97, 64, "dense"),
]


@pytest.mark.parametrize("act,B,P,K,C,layout", TF32X3_K1_CASES)
def test_token_head_fp32_backward_split_tf32_matches_plain(dev, act, B, P, K,
                                                           C, layout):
    """One launch, counted on both counters, in the mode the plan names;
    dx (in x's layout) and dW within RTOL_K1_BWD of their largest entry of
    the plain version; two runs give the same bits; the barriers' counters
    end at 0."""
    from mmvqa_tpu_torch.ops import token_head

    x, w, gout = _token_head_inputs(dev, torch.float32, B, P, K, C, layout)
    before = (fused_token_head.backward_launches,
              fused_token_head.backward_tf32x3_launches)
    dx, dw = token_head_backward(x, w, gout, act)
    dx2, dw2 = token_head_backward(x, w, gout, act)
    torch.cuda.synchronize()
    assert (fused_token_head.backward_launches,
            fused_token_head.backward_tf32x3_launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert dx.stride() == x.stride()
    dx_p, dw_p = token_head_backward_reference(x, w, gout, act)
    _normwise(dx, dx_p, 1e-4)
    _normwise(dw, dw_p, 1e-4)
    plan = token_head._backward_plan(x, K, C, act)
    assert plan.mode == (token_head.FP32_ROWS if K <= 96
                         else token_head.FP32_TILES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    assert not token_head._BARRIERS[(x.device, stream)].any()


def test_token_head_fp32_backward_cuts_dw_rows_at_stage_4():
    """The stage-4 case above (B=16, 196 positions, K=176) is the one whose
    dW rows the tiles mode cuts into segments on an H100, so that the
    second barrier runs there."""
    from mmvqa_tpu_torch.ops.token_head import backward_plan

    assert backward_plan(16, 196, 176, 768, 4, 132, 2).rsplit > 1
    assert backward_plan(16, 49, 512, 768, 4, 132, 2).rsplit == 1


def test_token_head_fp32_backward_on_three_streams_at_once(dev):
    """Both modes queued on three streams at once, each meeting at its own
    stream's barriers: every dx and dW is the default stream's, bit for bit,
    and every counter ends at 0."""
    from mmvqa_tpu_torch.ops import token_head

    cases = [_token_head_inputs(dev, torch.float32, 16, P, K, 768, "nhwc")
             for P, K in ((112 * 112, 24), (14 * 14, 176), (7 * 7, 512))]
    want = [token_head_backward(*case, "serf") for case in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in cases]
    got = [[] for _ in cases]
    for _ in range(3):
        for i, (stream, case) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(stream):
                torch.cuda._sleep(1000)
                got[i].append(token_head_backward(*case, "serf"))
    torch.cuda.synchronize()
    for (dx, dw), runs in zip(want, got):
        for rdx, rdw in runs:
            assert torch.equal(rdx, dx) and torch.equal(rdw, dw)
    device = cases[0][0].device
    for s in streams:
        assert not token_head._BARRIERS[(device, s.cuda_stream)].any()


def test_fp32_train_step_takes_the_split_tf32_kernels(dev):
    """The CLIs' default step, fp32 at B=16, the flagship MLM model: through
    autograd every one of its 98 conv1x1 + statistics launches, 5
    token-head backward launches and 4 attention launches each way takes
    its split-TF32 kernel, and the loss is finite."""
    from mmvqa_tpu_torch.core.config import pretrain_config
    from mmvqa_tpu_torch.data.synthetic import mlm_batches
    from mmvqa_tpu_torch.models import MMBert
    from mmvqa_tpu_torch.train.state import create_train_state
    from mmvqa_tpu_torch.train.steps import make_mlm_steps

    cfg = pretrain_config(cnn_encoder="tf_efficientnetv2_m",
                          transformer_model="realformer", batch_size=16)
    model = MMBert(cfg, generator=torch.Generator().manual_seed(0))
    assert model.dtype == torch.float32
    state = create_train_state(model, cfg.lr)
    step, _ = make_mlm_steps(model, cfg)
    batch = mlm_batches(cfg, 1, 0)[0]
    counters = ((conv1x1_stats, "launches"), (conv1x1_stats, "tf32x3_launches"),
                (fused_token_head, "backward_launches"),
                (fused_token_head, "backward_tf32x3_launches"),
                (realformer_attention, "launches"),
                (realformer_attention, "tf32x3_launches"),
                (realformer_attention, "backward_launches"),
                (realformer_attention, "backward_tf32x3_launches"))
    before = [getattr(fn, attr) for fn, attr in counters]
    state, m = step(state, batch)
    torch.cuda.synchronize()
    assert [getattr(fn, attr) - b for (fn, attr), b in zip(counters, before)
            ] == [98, 98, 5, 5, 4, 4, 4, 4]
    assert torch.isfinite(torch.as_tensor(m["loss"]))


# ------------------------------------------ K1's fp32 forward ----

# ragged: one position, K of 1, 13, 700 and 2049 (no multiple of a chunk or
# of four: element copies), C no multiple of a channel tile, B * P no
# multiple of any tile; x as the trunk gives it (K-major), as an NCHW map's
# view (P-major) and dense; W resident (K <= 96, 16-row tiles) and streamed
# (64-row tiles, and 16 where the plan cuts the deep taps' tiles)
TF32X3_K1_FWD_CASES = [
    (1, 1, 1, 1, "dense"),
    (3, 1, 8, 8, "dense"),
    (3, 37, 13, 257, "nchw"),
    (2, 4099, 24, 257, "nhwc"),
    (5, 49, 700, 768, "nchw"),
    (9, 49, 2049, 257, "dense"),
    (7, 37, 96, 300, "nhwc"),
    (4, 49, 97, 768, "nchw"),
    (16, 49, 512, 768, "nhwc"),
    (8, 49, 2048, 768, "nhwc"),
    (6, 196, 176, 520, "nhwc"),
]


@pytest.mark.parametrize("act", ["serf", "serf_fast", "relu"])
@pytest.mark.parametrize("B,P,K,C,layout", TF32X3_K1_FWD_CASES)
def test_token_head_fp32_forward_split_tf32_matches_plain(dev, act, B, P, K,
                                                          C, layout):
    """One launch of the split-TF32 kernel a call (both counters), against
    the plain version within TOL; two runs give the same bits (the sums
    across blocks are added in block order) and every last-block counter
    ends at 0."""
    from mmvqa_tpu_torch.ops import token_head

    x, w, _ = _token_head_inputs(dev, torch.float32, B, P, K, C, layout)
    before = (fused_token_head.launches, fused_token_head.tf32x3_launches)
    got = fused_token_head(x, w, act)
    again = fused_token_head(x, w, act)
    torch.cuda.synchronize()
    assert (fused_token_head.launches, fused_token_head.tf32x3_launches) == (
        before[0] + 2, before[1] + 2)
    assert got.shape == (B, C) and got.dtype == torch.float32
    assert torch.equal(got, again)
    torch.testing.assert_close(got, token_head_reference(x, w, act),
                               **TOL[torch.float32])
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert not token_head._FWD_COUNTERS[(x.device, stream)].any()


# the taps of the CLIs' default model (ResNet-152) and of the flagship
# (EfficientNetV2-M) at 224 px, (P, K)
BOTH_MODELS_TAPS = [(49, 2048), (196, 1024), (784, 512), (3136, 256),
                    (12544, 64), (12544, 24), (3136, 48), (784, 80),
                    (196, 176), (49, 512)]


@pytest.mark.parametrize("act", ["serf", "serf_fast", "relu"])
@pytest.mark.parametrize("P,K", BOTH_MODELS_TAPS)
def test_token_head_fp32_forward_at_both_models_taps(dev, act, P, K):
    """At B=8 (the fp32 checks' batch), x as the trunk gives it, C = 768:
    one split-TF32 launch, within TOL of the plain version."""
    x, w, _ = _token_head_inputs(dev, torch.float32, 8, P, K, 768, "nhwc")
    before = fused_token_head.tf32x3_launches
    got = fused_token_head(x, w, act)
    torch.cuda.synchronize()
    assert fused_token_head.tf32x3_launches == before + 1
    torch.testing.assert_close(got, token_head_reference(x, w, act),
                               **TOL[torch.float32])


def test_token_head_fp32_forward_is_one_kernel(dev):
    """The sums across blocks and across K's slices are added inside the
    kernel: a profiled fp32 forward, at a resident tap and at a deep tap
    whose K the plan cuts, shows one launch of token_head_fwd_tf32x3 and no
    partial or finalize kernel (traced as _device_kernels traces)."""
    from mmvqa_tpu_torch.ops import token_head

    for P, K in ((56 * 56, 48), (7 * 7, 2048)):
        x, w, _ = _token_head_inputs(dev, torch.float32, 16, P, K, 768,
                                     "nhwc")
        plan = token_head._fp32_forward_plan(x, K, 768, "serf")
        assert (plan.ks > 1) == (K == 2048)
        fused_token_head(x, w, "serf")
        events = _device_kernels(lambda: fused_token_head(x, w, "serf"),
                                 counter=(fused_token_head,
                                          "tf32x3_launches"))
        ours = [(key, n) for key, n in events if "token_head" in key]
        assert (len(ours) == 1 and "token_head_fwd_tf32x3" in ours[0][0]
                and 0 < ours[0][1] <= 1), events


def test_token_head_fp32_forward_keeps_a_shared_memory_grant(dev):
    """As test_token_head_forward_keeps_a_shared_memory_grant, for the fp32
    forward's resident variant: K=96 (the most shared memory it asks for),
    then a new shape at K=40 (less, the same variant), then K=96 again."""
    g = _gen(dev)

    def run(B, P, K):
        x = torch.randn(B, P, K, device=dev, generator=g)
        w = torch.randn(K, 256, device=dev, generator=g) * K ** -0.5
        torch.testing.assert_close(fused_token_head(x, w, "serf"),
                                   token_head_reference(x, w, "serf"),
                                   **TOL[torch.float32])

    run(2, 1231, 96)
    run(3, 1237, 40)
    run(2, 1231, 96)


def test_token_head_fp32_forward_on_two_streams_at_once(dev):
    """fp32 forward calls queued on two streams at once count into their
    own stream's counters: every output is the one the default stream
    gives, bit for bit, and every counter ends at 0."""
    from mmvqa_tpu_torch.ops import token_head

    cases = [_token_head_inputs(dev, torch.float32, 16, P, K, 768, "nhwc")[:2]
             for P, K in ((112 * 112, 64), (7 * 7, 2048), (14 * 14, 1024))]
    want = [fused_token_head(x, w, "serf") for x, w in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in cases]
    got = [[] for _ in cases]
    for _ in range(3):
        for i, (stream, (x, w)) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(stream):
                torch.cuda._sleep(1000)
                got[i].append(fused_token_head(x, w, "serf"))
    torch.cuda.synchronize()
    for out, runs in zip(want, got):
        for r in runs:
            assert torch.equal(r, out)
    device = cases[0][0].device
    for s in streams:
        assert not token_head._FWD_COUNTERS[(device, s.cuda_stream)].any()


# ------------------------------------------- the CLIs' default model ----

# ResNet-152's K4 sites, (N / B, K, C): conv1 and conv3 of its blocks and
# layer1's downsample (models/resnet.py), and its K5 sites, (N / B, C)
RESNET_K4_SITES = [(3136, 64, 64), (3136, 256, 64), (3136, 64, 256),
                   (3136, 256, 128), (784, 128, 512), (784, 512, 128),
                   (784, 512, 256), (196, 256, 1024), (196, 1024, 256),
                   (196, 1024, 512), (49, 512, 2048), (49, 2048, 512)]
RESNET_K5_SITES = [(12544, 64), (3136, 64), (3136, 256), (3136, 128),
                   (784, 128), (784, 512), (784, 256), (196, 256),
                   (196, 1024), (196, 512), (49, 512), (49, 2048)]
# the five taps deepest first, (P, K)
RESNET_TAPS = [(49, 2048), (196, 1024), (784, 512), (3136, 256),
               (12544, 64)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,K,C", RESNET_K4_SITES)
def test_conv1x1_stats_at_the_resnet_sites(dev, dtype, rows, K, C):
    """At B=4, w as the trunk passes it: bf16 on the TMA path, fp32 on the
    split-TF32 kernel, both against the plain version with
    test_conv1x1_stats_kernel_matches_plain's tolerances, two runs bit for
    bit."""
    g = _gen(dev)
    N = 4 * rows
    x = torch.randn(N, K, device=dev, generator=g).to(dtype)
    w = (torch.randn(C, K, device=dev, generator=g) * K ** -0.5).to(dtype).t()
    before = (conv1x1_stats.tma_launches, conv1x1_stats.tf32x3_launches)
    y, stats = conv1x1_stats(x, w)
    y2, stats2 = conv1x1_stats(x, w)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (conv1x1_stats.tma_launches - before[0],
            conv1x1_stats.tf32x3_launches - before[1]) == (
        (2, 0) if bf16 else (0, 2))
    assert torch.equal(y2, y) and torch.equal(stats2, stats)
    y_p, stats_p = conv1x1_stats_reference(x, w)
    tol = TOL[torch.bfloat16] if bf16 else dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(y.float(), y_p.float(), **tol)
    _normwise(stats[0], stats_p[0], 1e-4)
    _normwise(stats[1], stats_p[1], 1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,C", RESNET_K5_SITES)
def test_bn_backward_sums_at_the_resnet_sites(dev, dtype, rows, C):
    g = _gen(dev)
    shape = (4, rows, 1, C)
    x = (torch.randn(shape, device=dev, generator=g) * 2 + 1).to(dtype)
    dy = torch.randn(shape, device=dev, generator=g).to(dtype)
    mean = torch.randn(C, device=dev, generator=g)
    inv_std = 1 + torch.rand(C, device=dev, generator=g)
    before = bn_backward_sums.launches
    s1, s2 = bn_backward_sums(x, dy, mean, inv_std)
    again = bn_backward_sums(x, dy, mean, inv_std)
    torch.cuda.synchronize()
    assert bn_backward_sums.launches == before + 2
    assert torch.equal(again[0], s1) and torch.equal(again[1], s2)
    p1, p2 = bn_backward_sums_reference(x, dy, mean, inv_std)
    _normwise(s1, p1, 1e-4)
    _normwise(s2, p2, 1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P,K", RESNET_TAPS)
def test_token_head_at_the_resnet_taps(dev, dtype, P, K):
    """Forward and backward at B=4, x as the trunk gives it (a channels-last
    map's (B, P, K) view), C = 768, SERF (bf16: its fast form): the forward
    with the module's tolerances, the backward with
    test_token_head_backward_kernel_matches_plain's."""
    act = "serf_fast" if dtype == torch.bfloat16 else "serf"
    x, w, gout = _token_head_inputs(dev, dtype, 4, P, K, 768, "nhwc")
    before = (fused_token_head.launches, fused_token_head.backward_launches)
    out = fused_token_head(x, w, act)
    dx, dw = token_head_backward(x, w, gout, act)
    torch.cuda.synchronize()
    assert (fused_token_head.launches - before[0],
            fused_token_head.backward_launches - before[1]) == (1, 1)
    torch.testing.assert_close(out.float(),
                               token_head_reference(x, w, act).float(),
                               **TOL[dtype])
    dx_p, dw_p = token_head_backward_reference(x, w, gout, act)
    bf16 = dtype == torch.bfloat16
    rel_dw, rel_dx = (1e-3, 8e-3) if bf16 else (1e-4, 1e-4)
    _normwise(dw, dw_p, rel_dw)
    _normwise(dx, dx_p, rel_dx)


def test_default_model_eval_on_the_card_matches_the_cpu(dev):
    """The CLIs' default VQA model (ResNet-152, the pre-norm BERT encoder,
    hidden 768, 12 heads, 4 layers) in fp32 at 224 px, B=2: the card's
    logits within the smoke's 1e-3 of the CPU plain path's, and five K1
    launches a forward, no other kernel."""
    import copy

    from mmvqa_tpu_torch.core.config import vqa_config
    from mmvqa_tpu_torch.data.synthetic import vqa_batches
    from mmvqa_tpu_torch.models import MMBert
    from mmvqa_tpu_torch.train.steps import make_vqa_eval_step

    cfg = vqa_config(num_classes=40, batch_size=2)
    assert (cfg.cnn_encoder, cfg.transformer_model) == ("resnet152",
                                                       "transformer")
    batch = vqa_batches(cfg, 1, 40, 0, 0)[0]
    cpu = MMBert(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(dev)
    want = make_vqa_eval_step(cpu, cfg)(batch)["logits"]
    counters = [(fused_token_head, "launches"), (conv1x1_stats, "launches"),
                (bn_backward_sums, "launches"),
                (realformer_attention, "launches"), (depthwise3x3, "launches")]
    before = [getattr(fn, attr) for fn, attr in counters]
    got = make_vqa_eval_step(card, cfg)(batch)["logits"]
    torch.cuda.synchronize()
    assert [getattr(fn, attr) - b for (fn, attr), b in zip(counters, before)
            ] == [5, 0, 0, 0, 0]
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


# ---- the Grad-CAM CLI's shapes: fp32 at B=1 (one image), the deepest taps
# of both trunks (flagship 7x7x512, default 7x7x2048), the RealFormer at T=28

@pytest.mark.parametrize("P,K", [(49, 512), (49, 2048), (12544, 24),
                                 (12544, 64), (196, 176), (3136, 256)])
def test_token_head_fp32_at_one_image_matches_plain(dev, P, K):
    """K1's fp32 forward at B=1, its row tiles crossing no image boundary,
    on the trunk's channels-last map: one split-TF32 launch, two runs bit
    for bit."""
    g = _gen(dev)
    x = torch.randn(1, K, P, device=dev, generator=g).transpose(1, 2)
    w = torch.randn(K, 768, device=dev, generator=g) * K ** -0.5
    before = fused_token_head.tf32x3_launches
    got = fused_token_head(x, w, "serf")
    again = fused_token_head(x, w, "serf")
    torch.cuda.synchronize()
    assert fused_token_head.tf32x3_launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, token_head_reference(x, w, "serf"),
                               **TOL[torch.float32])


@pytest.mark.parametrize("K", [512, 2048])
def test_token_head_fp32_backward_at_one_image_matches_plain(dev, K):
    """K1's fp32 backward at B=1, P=49 (the grid barrier over few blocks):
    dx in x's layout and dW to 1e-4 of their largest entries, two runs bit
    for bit."""
    g = _gen(dev)
    x = torch.randn(1, K, 49, device=dev, generator=g).transpose(1, 2)
    w = torch.randn(K, 768, device=dev, generator=g) * K ** -0.5
    gout = torch.randn(1, 768, device=dev, generator=g)
    before = fused_token_head.backward_tf32x3_launches
    dx, dw = token_head_backward(x, w, gout, "serf")
    dx2, dw2 = token_head_backward(x, w, gout, "serf")
    torch.cuda.synchronize()
    assert fused_token_head.backward_tf32x3_launches == before + 2
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert dx.stride() == x.stride()
    dx_p, dw_p = token_head_backward_reference(x, w, gout, "serf")
    assert (dw - dw_p).abs().max() <= 1e-4 * dw_p.abs().max()
    assert (dx - dx_p).abs().max() <= 1e-4 * dx_p.abs().max()


@pytest.mark.parametrize("with_prev", [False, True])
def test_attention_fp32_at_one_image_matches_plain(dev, with_prev):
    """K2 in fp32 at B=1, T=28, 8 heads of 96 (the flagship's encoder in the
    Grad-CAM CLI), a padded question: forward and backward, each one launch
    of its split-TF32 kernel, dprev where the layer has a prev, at the
    smoke's fp32 tolerances."""
    g = _gen(dev)
    B, T, H, E = 1, 28, 8, 96
    kqv = torch.randn(B, T, H, 3 * E, device=dev, generator=g)
    k, q, v = kqv.split(E, dim=-1)
    prev = (torch.randn(B, H, T, T, device=dev, generator=g)
            if with_prev else None)
    mask = (torch.arange(T, device=dev) < 19).float()[None]
    valid = mask.bool()
    before = _counts("launches", "tf32x3_launches")
    ctx, carry = realformer_attention(q, k, v, prev, mask)
    torch.cuda.synchronize()
    assert _counts("launches", "tf32x3_launches") == (before[0] + 1,
                                                      before[1] + 1)
    ctx_p, carry_p = realformer_attention_reference(q, k, v, prev, mask)
    torch.testing.assert_close(carry, carry_p, rtol=2e-5, atol=2e-4)
    torch.testing.assert_close(ctx[valid], ctx_p[valid], rtol=2e-5,
                               atol=2e-5)
    torch.testing.assert_close(ctx, ctx_p, rtol=5e-3, atol=2e-3)
    dctx = torch.randn(B, T, H, E, device=dev, generator=g)
    dcarry = (0.1 * torch.randn(B, H, T, T, device=dev, generator=g)
              if with_prev else None)
    attrs = ("backward_launches", "backward_tf32x3_launches")
    before = _counts(*attrs)
    dkqv, dprev = realformer_attention_backward(kqv, carry, dctx, dcarry,
                                                with_prev)
    torch.cuda.synchronize()
    assert _counts(*attrs) == (before[0] + 1, before[1] + 1)
    dq_p, dk_p, dv_p, ds_p = realformer_attention_backward_reference(
        q, k, v, carry, dctx, dcarry)
    torch.testing.assert_close(dkqv, torch.cat([dk_p, dq_p, dv_p], -1),
                               rtol=5e-4, atol=5e-5)
    if with_prev:
        torch.testing.assert_close(dprev, ds_p, rtol=5e-4, atol=5e-5)
    else:
        assert dprev is None
