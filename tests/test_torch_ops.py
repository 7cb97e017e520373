"""mmvqa_tpu_torch.ops against the JAX package, on the CPU in fp32.

The same numpy inputs go through the JAX function and its port. On the CPU
the port's kernel wrappers take their plain PyTorch versions; the JAX token
head runs its Pallas kernel in interpret mode, as tests/test_token_head.py
runs it. The attention's bf16 tensor-core arithmetic, forward and backward,
is written out here and held against the JAX package's Pallas kernels in
interpret mode on bf16 inputs.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as nn

from mmvqa_tpu.core.config import vqa_config as jax_vqa_config
from mmvqa_tpu.ops import activations as jax_act
from mmvqa_tpu.ops.attention import realformer_attention as jax_attention
from mmvqa_tpu.ops.pallas_attention import (
    _bwd_call as jax_attention_bwd_kernel,
    _fwd_call as jax_attention_fwd_kernel,
)
from mmvqa_tpu.ops.pallas_token_head import (
    fused_token_head as jax_fused_token_head,
    token_head_reference as jax_token_head_reference,
)
from mmvqa_tpu.train.state import create_train_state
from mmvqa_tpu.train.steps import make_vqa_steps

from mmvqa_tpu_torch.core.config import vqa_config
from mmvqa_tpu_torch.data.images import process_batch
from mmvqa_tpu_torch.ops import activations, losses
from mmvqa_tpu_torch.ops.attention import (
    backward_path,
    fits_one_block,
    forward_mma_smem_bytes,
    forward_path,
    forward_tf32x3_smem_bytes,
    mma_smem_bytes,
    realformer_attention,
    realformer_attention_backward_reference,
    realformer_attention_reference,
    tf32x3_smem_bytes,
)
from mmvqa_tpu_torch.ops.token_head import (
    FP32_FWD_RESIDENT,
    FP32_FWD_STREAMED,
    FP32_FWD_TILE_C,
    FWD_STREAMED,
    FWD_TILE_C,
    FWD_W_REGISTERS,
    SMEM_LIMIT,
    SMEM_PER_SM,
    forward_plan,
    forward_tile,
    fp32_forward_plan,
    fp32_forward_tile,
    fused_token_head,
    token_head_reference,
)
from mmvqa_tpu_torch.train.steps import make_vqa_eval_step

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)


def _serf_inputs(rng):
    x = rng.normal(size=4096) * 4.0
    tails = [-80.0, -30.0, -10.0, 0.0, 10.0, 30.0, 49.9, 50.0, 60.0, 200.0]
    return np.concatenate([x, tails]).astype(np.float32)


def test_serf_f32_matches_jax(rng):
    x = _serf_inputs(rng)
    want = np.asarray(jax_act.serf(jnp.asarray(x)))
    got = activations.serf(torch.from_numpy(x)).numpy()
    # erf and log1p of two libraries: a few fp32 ulps
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_serf_bf16_takes_the_fast_polynomial(rng):
    assert jax_act.FAST_SERF_BF16
    assert activations.SERF_P5 == jax_act._SERF_P5
    x = _serf_inputs(rng)
    want = np.asarray(
        jax_act.serf(jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    got = activations.serf(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    # both round one fp32 value to bf16: at most one bf16 ulp apart
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0**-7,
                               atol=1e-6)


# ---------------------------------------------------------------- K1 ----

@pytest.mark.parametrize("act", ["serf", "serf_fast", "relu"])
@pytest.mark.parametrize("P", [512, 700])  # aligned + padded tail
def test_token_head_matches_jax(rng, act, P):
    B, K, C = 2, 24, 64
    x = rng.normal(size=(B, P, K)).astype(np.float32)
    w = (rng.normal(size=(K, C)) * 0.1).astype(np.float32)
    got = fused_token_head(torch.from_numpy(x), torch.from_numpy(w), act)
    assert got.shape == (B, C) and got.dtype == torch.float32
    want_kernel = jax_fused_token_head(jnp.asarray(x), jnp.asarray(w), act)
    want_ref = jax_token_head_reference(jnp.asarray(x), jnp.asarray(w), act)
    # tests/test_token_head.py's forward tolerance
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-6)


def test_token_head_takes_the_trunk_map_as_a_strided_view(rng):
    """An NCHW map (B, K, H*W) goes in as its (B, P, K) transpose."""
    B, K, P, C = 2, 24, 49, 32
    feat = torch.from_numpy(rng.normal(size=(B, K, P)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(K, C)) * 0.1).astype(np.float32))
    view = feat.transpose(1, 2)
    assert not view.is_contiguous()
    torch.testing.assert_close(fused_token_head(view, w, "serf"),
                               fused_token_head(view.contiguous(), w, "serf"),
                               rtol=0, atol=0)


def test_token_head_cpu_call_counts_no_launch(rng):
    x = torch.zeros(1, 8, 4)
    w = torch.zeros(4, 8)
    before = fused_token_head.launches, fused_token_head.tf32x3_launches
    fused_token_head(x, w, "relu")
    assert (fused_token_head.launches,
            fused_token_head.tf32x3_launches) == before


SM_COUNTS = (1, 114, 132)


def _walk_forward_block(plan, B, P, j):
    """The bf16 forward kernel's walk over block j's rows, 16 at a time, as
    csrc/token_head.cu takes it: the running sums of image b_cur take every
    row of a 16-row step where the next image starts past the step, else
    the rows below its start, and the image is flushed to the block's
    partial when a row of the next one comes (the last one at the end).
    Returns [(image, first row, end row)] in the order of the flushes; rows
    past B * P (zeros) go to the last image."""
    INF = float("inf")
    N, tp = B * P, plan.tp
    n_items = -(-N // tp)
    first = j * plan.per_block
    last = min(n_items, first + plan.per_block)
    assert first < last  # no block is empty
    b_first = first * tp // P
    b_cur = b_first
    next_b = INF if b_cur == B - 1 else (b_cur + 1) * P
    flushes, seg = [], None

    def take(lo, hi):  # rows [lo, hi) into image b_cur's sums
        nonlocal seg
        if lo >= hi:
            return
        if seg is None:
            seg = [lo, hi]
        else:
            assert seg[1] == lo  # the image's rows come in order, no gap
            seg[1] = hi

    for n0 in range(first * tp, last * tp, 16):
        if n0 + 16 <= next_b:
            take(n0, n0 + 16)
            continue
        lo = 0
        while True:
            lim = next_b - n0
            take(n0 + lo, n0 + min(16, lim))
            if lim >= 16:
                break
            flushes.append((b_cur, *(seg or (n0, n0))))
            seg = None
            b_cur += 1
            next_b = INF if b_cur == B - 1 else next_b + P
            lo = max(lim, 0)
    flushes.append((b_cur, *seg))
    return flushes


@pytest.mark.parametrize("B,P,K", [
    *((B, P, K) for B in (128, 16) for P, K in (
        (112 * 112, 24), (56 * 56, 48), (28 * 28, 80), (14 * 14, 176),
        (7 * 7, 512))),
    (3, 37, 96), (7, 1, 8), (2, 700, 24), (5, 49, 97), (1, 1, 1),
])
def test_token_head_forward_plan_splits_rows_by_image(B, P, K):
    """The bf16 forward's share-out and its per-image sums, walked block
    by block on the CPU for cards of 1 and 132 SMs holding 1 or 3 blocks
    each: the tiles go to the blocks in order, none twice and none left out,
    no block empty; a block flushes the images its rows span, each once,
    in order, each with exactly its own rows (P = 49, 196 and 784 put
    boundaries inside tiles, 12544 inside 16-row steps only at an image's
    end), into a slot of its partial below ``slots``; and the blocks that
    flush an image are the ones the kernel's last block adds, in order."""
    N = B * P
    tp, mode, smem = forward_tile(K)
    resident = mode != FWD_STREAMED
    assert smem <= SMEM_LIMIT and tp == (64 if resident else 32)
    assert resident == (K <= 96) and (mode == FWD_W_REGISTERS) == (K <= 32)
    for sms, slots in ((1, 1), (1, 3), (132, 1), (132, 3)):
        plan = forward_plan(B, P, K, 768, sms, slots)
        assert (plan.tp, plan.mode, plan.smem) == (tp, mode, smem)
        ctiles = -(-768 // FWD_TILE_C)
        assert plan.nblocks * ctiles <= max(slots * sms, ctiles)
        rows_pb = plan.per_block * tp
        assert (plan.nblocks - 1) * rows_pb < N <= plan.nblocks * rows_pb
        flushed = {}
        for j in range(plan.nblocks):
            fl = _walk_forward_block(plan, B, P, j)
            b_first = fl[0][0]
            assert b_first == j * rows_pb // P
            assert [b for b, _, _ in fl] == list(range(b_first,
                                                       b_first + len(fl)))
            assert len(fl) <= plan.slots
            for b, lo, hi in fl:
                want_lo = max(b * P, j * rows_pb)
                want_hi = min((b + 1) * P, (j + 1) * rows_pb)
                if b == B - 1:  # the zero rows past B * P come along
                    want_hi = min(-(-N // tp) * tp, (j + 1) * rows_pb)
                assert (lo, hi) == (want_lo, want_hi), (j, b)
                flushed.setdefault(b, []).append(j)
        assert sorted(flushed) == list(range(B))
        for b, blocks in flushed.items():
            j_lo = b * P // rows_pb
            j_hi = min(plan.nblocks - 1, ((b + 1) * P - 1) // rows_pb)
            assert blocks == list(range(j_lo, j_hi + 1))


def test_token_head_forward_plan_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="empty"):
        forward_plan(2, 0, 24, 768, 132, 3)
    with pytest.raises(ValueError, match="blocks an SM"):
        forward_plan(2, 64, 24, 768, 132, 0)
    with pytest.raises(ValueError, match="grid too large"):
        forward_plan(2**16, 2**15, 24, 768, 132, 3)


# the two models' taps at 224 px, (P, K): the CLIs' default (ResNet-152)
# and the flagship (EfficientNetV2-M)
MODEL_TAPS = {
    "default": [(side * side, K) for _, side, K in chip_smoke.DEF_TAPS],
    "flagship": [(side * side, K) for _, side, K in chip_smoke.TAPS],
}
# (SMs, blocks an SM holds): the plan asks the card for the second
FP32_CARDS = [(sms, slots) for sms in SM_COUNTS for slots in (1, 2, 3)]


def _last_arrival_adds(arrivals):
    """An atomicInc counter with limit len(arrivals) - 1, taken once by each
    arrival in either order: only the last one sees the limit (and adds),
    and the counter ends at 0."""
    n = len(arrivals) - 1
    for order in (arrivals, arrivals[::-1]):
        counter, adds = 0, []
        for j in order:
            old = counter
            counter = 0 if old >= n else old + 1
            if old == n:
                adds.append(j)
        assert adds == [order[-1]] and counter == 0


def _check_fp32_forward_plan(B, P, K, C, sms, slots, walk):
    """The fp32 forward's plan on a card of ``sms`` SMs holding ``slots``
    blocks each: the tile is fp32_forward_tile's; the row tiles go to the
    blocks in order, each once, none left empty, in one wave or a tile a
    block, and at least a block an SM where there are as many tiles; K is
    cut only where W streams, with a tile a block, into slices of whole
    32-k chunks, none empty, each taken once; each block's rows span no
    more images than its partial holds; each (image, 32 channels) sum is
    taken once, by the last of the blocks that share the image to arrive at
    its atomicInc counter (which ends at 0), and those blocks are the
    kernel's j_lo .. j_hi (a tile's K slices likewise, by the last of its
    ks); a block fits an SM's shared memory beside another (two more where
    W is resident). With ``walk``, the kernel's walk over every block's
    rows (_walk_forward_block) flushes each image's rows exactly once.
    Returns the plan."""
    plan = fp32_forward_plan(B, P, K, C, sms, slots)
    tp, mode, smem = fp32_forward_tile(K)
    assert (plan.tp, plan.mode, plan.smem) == (tp, mode, smem)
    assert (mode == FP32_FWD_RESIDENT) == (-(-K // 32) * 32 <= 96)
    assert tp == (16 if mode == FP32_FWD_RESIDENT else 64)
    # blocks an SM's shared memory holds: three resident (four up to K =
    # 64), two streamed
    fits = SMEM_PER_SM // (smem + 1024)
    assert smem <= SMEM_LIMIT and fits >= (
        2 if mode == FP32_FWD_STREAMED else 4 if K <= 64 else 3)
    N, ctiles = B * P, -(-C // FP32_FWD_TILE_C)
    items = -(-N // tp)
    rows_pb = plan.per_block * tp
    assert (plan.nblocks - 1) * plan.per_block < items
    assert items <= plan.nblocks * plan.per_block
    assert (plan.nblocks * ctiles <= max(slots * sms, ctiles)
            or plan.per_block == 1)
    assert plan.nblocks * ctiles >= min(sms, items * ctiles)
    n_kc = -(-K // 32)
    assert 1 <= plan.ks <= n_kc
    assert (plan.ks > 1) == (K >= 512 and items * ctiles < 3 * sms and (
        n_kc > 1))
    if plan.ks > 1:
        assert mode == FP32_FWD_STREAMED and plan.per_block == 1
        assert items * ctiles * plan.ks >= 3 * sms or plan.ks == n_kc
        cuts = [z * n_kc // plan.ks for z in range(plan.ks + 1)]
        assert all(lo < hi for lo, hi in zip(cuts, cuts[1:]))
        assert (cuts[0], cuts[-1]) == (0, n_kc)
        _last_arrival_adds(list(range(plan.ks)))
    for j in range(plan.nblocks):
        first_img = j * rows_pb // P
        last_img = (min(N, (j + 1) * rows_pb) - 1) // P
        assert last_img - first_img + 1 <= plan.slots
    for b in range(B):
        blocks = [j for j in range(plan.nblocks)
                  if max(b * P, j * rows_pb) < min((b + 1) * P,
                                                   (j + 1) * rows_pb)]
        j_lo = b * P // rows_pb
        j_hi = min(plan.nblocks - 1, ((b + 1) * P - 1) // rows_pb)
        assert blocks == list(range(j_lo, j_hi + 1))
        _last_arrival_adds(blocks)
    if walk:
        flushed = {}
        for j in range(plan.nblocks):
            for b, lo, hi in _walk_forward_block(plan, B, P, j):
                want_hi = min((b + 1) * P, (j + 1) * rows_pb)
                if b == B - 1:  # the zero rows past B * P come along
                    want_hi = min(items * tp, (j + 1) * rows_pb)
                assert (lo, hi) == (max(b * P, j * rows_pb), want_hi)
                flushed.setdefault(b, []).append(j)
        assert sorted(flushed) == list(range(B))
    return plan


@pytest.mark.parametrize("model", sorted(MODEL_TAPS))
@pytest.mark.parametrize("B", [chip_smoke.CHECK_B, chip_smoke.CLI_B,
                               chip_smoke.TRAIN_B])
def test_token_head_fp32_forward_plan_at_the_taps(model, B):
    """Every tap of both models at the fp32 check's, the CLIs' and the train
    batch, C = 768, on cards of 1, 114 and 132 SMs: the plan's invariants
    (_check_fp32_forward_plan; every row walked where B * P is at most the
    CLIs' stem), and at the deep taps (K >= 176: few rows, wide K) at least
    a block an SM: their K is cut so that there are as many."""
    for P, K in MODEL_TAPS[model]:
        for sms, slots in FP32_CARDS:
            plan = _check_fp32_forward_plan(B, P, K, 768, sms, slots,
                                            walk=B * P <= 16 * 12544)
            if K >= 176:
                assert plan.nblocks * 6 * plan.ks >= sms, (P, K, sms, plan)


@pytest.mark.parametrize("B,P,K,C", [
    (3, 37, 96, 300), (7, 1, 8, 8), (2, 700, 24, 257), (5, 49, 97, 768),
    (1, 1, 1, 1), (9, 49, 2049, 257), (2, 4099, 13, 100),
])
def test_token_head_fp32_forward_plan_at_ragged_shapes(B, P, K, C):
    """Images shorter than a 16-row step (P = 1), tiles across images, K
    and C no multiple of a chunk or a channel tile: every row walked."""
    for sms, slots in FP32_CARDS:
        _check_fp32_forward_plan(B, P, K, C, sms, slots, walk=True)


def test_token_head_fp32_forward_plan_cuts_k_at_the_deep_taps():
    """On a 132-SM card: W resident with 16-row tiles where K <= 96, never
    a cut of K; where it streams, 64-row tiles, and K (from 512) cut where
    those give the SMs fewer than three blocks each: ResNet's layer4 (784
    rows at B=16: 13 tiles x 6 channel tiles, 6 slices; 392 at B=8: 10),
    layer3 at B=16 (49 tiles, 2 slices), the flagship's stage 6 alike; none
    at its stage 4 (K = 176), at B=128 or at layer2."""
    sms = 132
    for B, P, K in ((16, 12544, 64), (8, 12544, 24), (16, 784, 80)):
        plan = fp32_forward_plan(B, P, K, 768, sms, 3)
        assert (plan.tp, plan.mode, plan.ks) == (16, FP32_FWD_RESIDENT, 1)
    for B, P, K, ks in ((16, 49, 2048, 6), (8, 49, 2048, 10),
                        (16, 196, 1024, 2), (16, 49, 512, 6),
                        (16, 196, 176, 1), (128, 49, 2048, 1),
                        (16, 784, 512, 1)):
        plan = fp32_forward_plan(B, P, K, 768, sms, 2)
        assert (plan.tp, plan.mode, plan.ks) == (64, FP32_FWD_STREAMED, ks)
        assert plan.nblocks * 6 * ks >= sms


def test_token_head_fp32_forward_plan_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="empty"):
        fp32_forward_plan(2, 0, 24, 768, 132, 2)
    with pytest.raises(ValueError, match="blocks an SM"):
        fp32_forward_plan(2, 64, 24, 768, 132, 0)
    with pytest.raises(ValueError, match="grid too large"):
        fp32_forward_plan(2**16, 2**15, 24, 768, 132, 2)


def test_token_head_rejects_bad_arguments():
    with pytest.raises(ValueError, match="unknown act"):
        fused_token_head(torch.zeros(1, 4, 2), torch.zeros(2, 3), "gelu")
    with pytest.raises(ValueError, match=r"\(B, P, K\)"):
        fused_token_head(torch.zeros(1, 4, 2), torch.zeros(3, 3), "relu")


# ---------------------------------------------------------------- K2 ----

B2, T2, H2, E2 = 2, 12, 4, 16


def _attention_inputs(rng, with_prev, with_mask):
    q, k, v = (rng.normal(size=(B2, T2, H2, E2)).astype(np.float32)
               for _ in range(3))
    prev = (rng.normal(size=(B2, H2, T2, T2)).astype(np.float32)
            if with_prev else None)
    mask = None
    if with_mask:
        mask = np.ones((B2, T2), np.float32)
        mask[0, -3:] = 0.0
        mask[1, -5:] = 0.0
    return q, k, v, prev, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_realformer_attention_matches_jax_xla_path(rng, with_prev, with_mask):
    q, k, v, prev, mask = _attention_inputs(rng, with_prev, with_mask)
    ctx, carry = realformer_attention(_t(q), _t(k), _t(v), _t(prev), _t(mask))
    assert ctx.shape == (B2, T2, H2, E2)
    assert carry.shape == (B2, H2, T2, T2) and carry.dtype == torch.float32
    # the XLA path carries (B, T, T, H)
    prev_x = None if prev is None else jnp.asarray(prev.transpose(0, 2, 3, 1))
    ctx_x, carry_x = jax_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), prev_x,
        None if mask is None else jnp.asarray(mask), impl="xla")
    # tests/test_pallas_attention.py:57,64 -- here on every row, padded
    # ones included: the port subtracts the mask into the softmax input as
    # the XLA path does
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ctx_x),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(carry.permute(0, 2, 3, 1).numpy(),
                               np.asarray(carry_x), rtol=2e-5, atol=2e-4)


def test_realformer_attention_takes_kqv_split_views(rng):
    """k, q, v as the strided slices of the shared kqv projection."""
    kqv = torch.from_numpy(rng.normal(size=(B2, T2, H2, 3 * E2))
                           .astype(np.float32))
    k, q, v = kqv.split(E2, dim=-1)
    assert not q.is_contiguous()
    got = realformer_attention(q, k, v, None, None)
    want = realformer_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), None, None)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("with_prev,with_mask", [(False, False), (True, True)])
def test_realformer_attention_at_t200_matches_jax_xla_path(rng, with_prev,
                                                          with_mask):
    """T=200, beyond what one block of the card holds (the tiled kernels'
    length): the port's forward and its written-out backward against the
    XLA path and its autograd, at the widths of tests/test_pallas_attention.py."""
    Bl, T, H, E = 1, 200, 2, 8
    q, k, v = (rng.normal(size=(Bl, T, H, E)).astype(np.float32)
               for _ in range(3))
    prev = (rng.normal(size=(Bl, H, T, T)).astype(np.float32)
            if with_prev else None)
    mask = None
    if with_mask:
        mask = np.ones((Bl, T), np.float32)
        mask[0, 150:] = 0.0
    dctx = rng.normal(size=(Bl, T, H, E)).astype(np.float32)
    dcarry = (rng.normal(size=(Bl, H, T, T)).astype(np.float32) * 0.1
              if with_prev else None)
    ctx, carry = realformer_attention(_t(q), _t(k), _t(v), _t(prev), _t(mask))
    dq, dk, dv, ds = realformer_attention_backward_reference(
        _t(q), _t(k), _t(v), carry, _t(dctx), _t(dcarry))

    def xla(q, k, v, prev):
        prev_x = None if prev is None else jnp.transpose(prev, (0, 2, 3, 1))
        c, s = jax_attention(q, k, v, prev_x,
                             None if mask is None else jnp.asarray(mask),
                             impl="xla")
        return c, jnp.transpose(s, (0, 3, 1, 2))

    args = [jnp.asarray(a) for a in (q, k, v)]
    args.append(None if prev is None else jnp.asarray(prev))
    (ctx_x, carry_x), vjp = jax.vjp(xla, *args)
    grads = vjp((jnp.asarray(dctx),
                 jnp.zeros_like(carry_x) if dcarry is None
                 else jnp.asarray(dcarry)))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ctx_x),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(carry.numpy(), np.asarray(carry_x),
                               rtol=2e-5, atol=2e-4)
    # tests/test_pallas_attention.py:92, the gradients' tolerance
    for got, want in zip((dq, dk, dv), grads[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=5e-4, atol=5e-5)
    if with_prev:
        np.testing.assert_allclose(ds.numpy(), np.asarray(grads[3]),
                                   rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("T,E,forward,backward", [
    (28, 96, True, True), (75, 96, True, True), (99, 96, True, True),
    (100, 96, True, False), (128, 96, True, False), (200, 96, False, False),
    (512, 96, False, False), (128, 256, False, False),
])
def test_realformer_attention_path_follows_t_and_e(T, E, forward, backward):
    """The one-block kernels where a head's tiles fit 227 KB of shared
    memory (the flagship T=75 and T=28 keep theirs), the tiled kernels
    beyond."""
    assert fits_one_block(T, E, backward=False) == forward
    assert fits_one_block(T, E, backward=True) == backward


def test_realformer_attention_refuses_a_head_too_wide_for_its_tiles():
    assert not fits_one_block(4096, 384, backward=False)
    with pytest.raises(ValueError, match="shared memory"):
        fits_one_block(4096, 512, backward=True)


# K2-bwd's tensor-core kernel (csrc/realformer_attention_bwd.cu, bf16): the
# products take bf16 operands, so p and ds (fp32) go in as two bf16 terms,
# hi = bf16(x) and lo = bf16(x - hi); k, q and dctx are bf16 already.


def _bf16_terms(x):
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _kernel_softmax(s, ex2_err):
    """The tensor-core kernels' softmax (csrc/attention_tile.cuh,
    softmax_rows) written out: e = 2^((s - max) log2 e) in fp32, each e off
    by ``ex2_err`` relative with a random sign, as ex2.approx may be, then e
    times one reciprocal of its row's sum."""
    e = torch.exp2((s - s.amax(dim=-1, keepdim=True)) * 1.4426950408889634)
    signs = np.random.default_rng(1).choice([-1.0, 1.0], size=tuple(e.shape))
    e = e * (1.0 + ex2_err * torch.from_numpy(signs.astype(np.float32)))
    return e * (1.0 / e.sum(dim=-1, keepdim=True))


def _k2_bwd_split(q, k, v, carry, dctx, dcarry, split=True, ex2_err=None):
    """The tensor-core kernel's arithmetic written out: p, dp and ds in
    fp32 as the plain version takes them (p as the kernel takes it where
    ``ex2_err`` is given, _kernel_softmax), then dq = ds k, dk = ds^T q and
    dv = p^T dctx with ds and p as their hi + lo bf16 terms (``split``) or
    as hi alone (the control), fp32 sums. Returns fp32 dq, dk, dv
    (B, T, H, E), unrounded, and ds (B, H, T, T)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    dch = dctx.float().permute(0, 2, 1, 3)
    p = (torch.softmax(carry, dim=-1) if ex2_err is None
         else _kernel_softmax(carry, ex2_err))
    dp = dch @ vh.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    if dcarry is not None:
        ds = ds + dcarry

    def product(a, b):
        hi, lo = _bf16_terms(a)
        return hi @ b + lo @ b if split else hi @ b

    dq = product(ds, kh) * scale
    dk = product(ds.transpose(-1, -2), qh) * scale
    dv = product(p.transpose(-1, -2), dch)
    return [t.permute(0, 2, 1, 3) for t in (dq, dk, dv)], ds


def _k2_bwd_bf16_inputs(rng, T, with_prev, with_mask, with_dcarry):
    """bf16 q, k, v, dctx at 2 heads of 32 and the fp32 carry of the
    forward's plain version (the kernel's input), dcarry fp32 or None."""
    Bk, Hk, Ek = 2, 2, 32
    q, k, v, dctx = (torch.from_numpy(rng.normal(size=(Bk, T, Hk, Ek))
                                      .astype(np.float32)).bfloat16()
                     for _ in range(4))
    prev = (torch.from_numpy(rng.normal(size=(Bk, Hk, T, T))
                             .astype(np.float32)) if with_prev else None)
    mask = None
    if with_mask:
        mask = torch.ones(Bk, T)
        mask[1, T // 2:] = 0.0
    _, carry = realformer_attention_reference(q, k, v, prev, mask)
    dcarry = (torch.from_numpy(0.1 * rng.normal(size=(Bk, Hk, T, T))
                               .astype(np.float32)) if with_dcarry else None)
    return q, k, v, carry, dctx, dcarry


# chip_smoke.py's TOL_K2_BWD_BF16 (dq, dk, dv: two bf16 ulps of one fp32
# value) and TOL_K2_BWD (dprev, fp32; tests/test_pallas_attention.py:92)
TOL_K2_BWD_BF16 = dict(rtol=8e-3, atol=5e-5)
TOL_K2_BWD = dict(rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("T", [17, 28, 75])
@pytest.mark.parametrize("with_prev,with_mask,with_dcarry", [
    (False, False, False), (False, True, True), (True, True, True),
    (True, True, False)])
def test_attention_bf16_backward_split_matches_the_reference_kernel(
        rng, T, with_prev, with_mask, with_dcarry):
    """The tensor-core kernel's arithmetic against the JAX package's Pallas
    backward (interpret mode, as tests/test_pallas_attention.py runs it) on
    the same bf16 inputs and fp32 carry, and against the port's fp32 plain
    version, both within chip_smoke.py's tolerances: T of the flagship's
    two lengths and a ragged one, the train step's four kinds of layer."""
    q, k, v, carry, dctx, dcarry = _k2_bwd_bf16_inputs(
        rng, T, with_prev, with_mask, with_dcarry)
    (dq, dk, dv), ds = _k2_bwd_split(q, k, v, carry, dctx, dcarry)

    def jx(t):  # (B, T, H, E) bf16 -> the kernel's (B, H, T, E)
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) \
            .transpose(0, 2, 1, 3)

    zeros = torch.zeros_like(carry) if dcarry is None else dcarry
    want = jax_attention_bwd_kernel(jx(q), jx(k), jx(v),
                                    jnp.asarray(carry.numpy()), jx(dctx),
                                    jnp.asarray(zeros.numpy()))
    plain = realformer_attention_backward_reference(q, k, v, carry, dctx,
                                                    dcarry)
    for got, ref, pl in zip((dq, dk, dv), want[:3], plain[:3]):
        got = got.bfloat16().float().numpy()
        ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(got, ref, **TOL_K2_BWD_BF16)
        np.testing.assert_allclose(got, pl.float().numpy(), **TOL_K2_BWD_BF16)
    np.testing.assert_allclose(ds.numpy(), np.asarray(want[3]), **TOL_K2_BWD)
    np.testing.assert_allclose(ds.numpy(), plain[3].numpy(), **TOL_K2_BWD)


# the split's products against the fp32 ones, relative to the largest
# entry: hi + lo leaves about 2^-16 of each term (read: 2e-6 to 5e-6 at
# T = 17, 28, 75), one bf16 term about 2^-9 (1e-3 to 3e-3)
SPLIT_BOUND = 1e-4


@pytest.mark.parametrize("T", [17, 28, 75])
def test_attention_bf16_backward_needs_both_terms(rng, T):
    """Before the final rounding, the split products meet the fp32 products
    of the same bf16 inputs within SPLIT_BOUND of the largest entry; the
    control with one bf16 term for p and ds misses it, and misses the
    card's bf16 tolerance after the rounding too."""
    q, k, v, carry, dctx, dcarry = _k2_bwd_bf16_inputs(rng, T, True, True,
                                                       True)
    dq, dk, dv, _ = realformer_attention_backward_reference(
        *(t.float() for t in (q, k, v)), carry, dctx.float(), dcarry)
    split, _ = _k2_bwd_split(q, k, v, carry, dctx, dcarry)
    one, _ = _k2_bwd_split(q, k, v, carry, dctx, dcarry, split=False)
    for want, got, ctl in zip((dq, dk, dv), split, one):
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= SPLIT_BOUND * scale
        assert (ctl - want).abs().max().item() > SPLIT_BOUND * scale
        wb = want.bfloat16().float()
        miss = (ctl.bfloat16().float() - wb).abs() > (
            TOL_K2_BWD_BF16["atol"] + TOL_K2_BWD_BF16["rtol"] * wb.abs())
        assert miss.any()


@pytest.mark.parametrize("dtype,T,E,path", [
    (torch.bfloat16, 75, 96, "mma"),       # the train path
    (torch.bfloat16, 28, 96, "mma"),       # the eval path's length
    (torch.bfloat16, 17, 16, "mma"),
    (torch.bfloat16, 125, 96, "mma"),      # the longest it takes at E=96
    (torch.bfloat16, 75, 128, "mma"),
    (torch.bfloat16, 126, 96, "tiled"),    # 233 KB: beyond one block
    (torch.bfloat16, 128, 96, "tiled"),
    (torch.bfloat16, 129, 96, "tiled"),
    (torch.bfloat16, 512, 96, "tiled"),
    (torch.bfloat16, 33, 40, "one_block"),  # E no multiple of 16
    (torch.bfloat16, 75, 144, "one_block"),  # E beyond 128
    (torch.float32, 75, 96, "mma"),        # the CLIs' fp32 train path
    (torch.float32, 28, 96, "mma"),        # and its eval length
    (torch.float32, 96, 96, "mma"),        # the longest it takes at E=96
    (torch.float32, 97, 96, "one_block"),  # 242 KB: beyond one block
    (torch.float32, 80, 128, "mma"),       # the longest it takes at E=128
    (torch.float32, 81, 128, "one_block"),
    (torch.float32, 200, 96, "tiled"),
])
def test_attention_backward_path_follows_dtype_t_and_e(dtype, T, E, path):
    assert backward_path(dtype, T, E) == path


def test_attention_bf16_backward_shares_an_sm_at_the_train_shape():
    """Two blocks of the train shape's (T=75, E=96) share an SM: each at
    most half of 228 KB less the 1 KB a block reserves."""
    assert mma_smem_bytes(75, 96) <= (233472 // 2 - 1024)
    assert mma_smem_bytes(28, 96) < mma_smem_bytes(75, 96)


# K2-fwd's tensor-core kernel (csrc/realformer_attention.cu, tc::, bf16): s
# from bf16 q and k with fp32 sums, then p v with p, fp32, as its hi + lo
# bf16 terms (v is bf16 already).

# chip_smoke.py's TOL_BF16 (ctx: two bf16 ulps of one fp32 value) and
# TOL_K2_CARRY (the fp32 carry)
TOL_BF16 = dict(rtol=8e-3, atol=2e-3)
TOL_K2_CARRY = dict(rtol=2e-5, atol=2e-4)


def _k2_fwd_mma(q, k, v, prev, mask, split=True, ex2_err=None):
    """The tensor-core forward's arithmetic written out: s = q k^T from the
    bf16 operands with fp32 sums, times 1 / sqrt(E), plus prev, minus the
    mask term, as the plain version orders them; the softmax in fp32 (as
    the kernel takes it where ``ex2_err`` is given, _kernel_softmax); ctx =
    p v with p as its hi + lo bf16 terms (``split``) or as hi alone, fp32
    sums. Returns ctx (B, T, H, E) fp32, unrounded, and s (B, H, T, T)."""
    qh, kh, vh = (t.bfloat16().float().permute(0, 2, 1, 3) for t in (q, k, v))
    s = (qh @ kh.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if prev is not None:
        s = s + prev
    if mask is not None:
        s = s - 10000.0 * (1.0 - mask.float())[:, None, :, None]
    hi, lo = _bf16_terms(torch.softmax(s, dim=-1) if ex2_err is None
                         else _kernel_softmax(s, ex2_err))
    ctx = hi @ vh + lo @ vh if split else hi @ vh
    return ctx.permute(0, 2, 1, 3), s


def _k2_fwd_bf16_inputs(rng, B, T, H, E, with_prev, with_mask):
    """bf16 q, k, v (B, T, H, E) as slices of one kqv, fp32 prev or None,
    and a mask whose lengths are drawn as chip_smoke.py draws them."""
    kqv = torch.from_numpy(rng.standard_normal((B, T, H, 3 * E),
                                               dtype=np.float32)).bfloat16()
    k, q, v = kqv.split(E, dim=-1)
    prev = (torch.from_numpy(rng.standard_normal((B, H, T, T),
                                                 dtype=np.float32))
            if with_prev else None)
    mask = None
    if with_mask:
        lengths = rng.integers(T // 2, T + 1, B)
        mask = torch.from_numpy(
            (np.arange(T)[None] < lengths[:, None]).astype(np.float32))
    return q, k, v, prev, mask


@pytest.mark.parametrize("T", [17, 28, 75])
@pytest.mark.parametrize("with_prev,with_mask", [
    (False, False), (False, True), (True, False), (True, True)])
def test_attention_bf16_forward_mma_matches_the_reference(rng, T, with_prev,
                                                          with_mask):
    """The tensor-core forward's arithmetic against the JAX package's Pallas
    forward (interpret mode, as tests/test_pallas_attention.py runs it) on
    the same bf16 inputs, against its XLA path on those inputs widened to
    fp32, and against the port's plain version: ctx within TOL_BF16 after
    the kernel's rounding to bf16, the carry within TOL_K2_CARRY. T of the
    flagship's two lengths and a ragged one."""
    q, k, v, prev, mask = _k2_fwd_bf16_inputs(rng, 2, T, 2, 32, with_prev,
                                              with_mask)
    ctx, s = _k2_fwd_mma(q, k, v, prev, mask)
    ctx = ctx.bfloat16().float().numpy()

    def jx(t):  # (B, T, H, E) bf16 -> the kernel's (B, H, T, E)
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) \
            .transpose(0, 2, 1, 3)

    ctx_k, s_k = jax_attention_fwd_kernel(
        jx(q), jx(k), jx(v), None if prev is None else jnp.asarray(
            prev.numpy()), None if mask is None else jnp.asarray(mask.numpy()))
    ctx_x, s_x = jax_attention(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
        None if prev is None else jnp.asarray(prev.numpy()
                                              .transpose(0, 2, 3, 1)),
        None if mask is None else jnp.asarray(mask.numpy()), impl="xla")
    ctx_p, s_p = realformer_attention_reference(q, k, v, prev, mask)
    for ref in (np.asarray(ctx_k.astype(jnp.float32)).transpose(0, 2, 1, 3),
                np.asarray(ctx_x), ctx_p.float().numpy()):
        np.testing.assert_allclose(ctx, ref, **TOL_BF16)
    for ref in (np.asarray(s_k), np.asarray(s_x).transpose(0, 3, 1, 2),
                s_p.numpy()):
        np.testing.assert_allclose(s.numpy(), ref, **TOL_K2_CARRY)


# The decision between one bf16 term for p and hi + lo, at chip_smoke.py's
# own shapes (8 heads of 96; B=128 at T=75, B=16 at T=28) and draws: the
# largest |ctx - plain| / (atol + rtol |plain|) of TOL_BF16 over every
# entry, before the final rounding to bf16 (after it, a value one side of a
# rounding boundary reads one ulp, up to 0.78 of the tolerance, whichever
# way p went in). One term may ship only where it uses at most half of the
# tolerance in every case. Read: one term 0.97-0.99 without prev, 1.39-1.70
# with it, so one term misses the tolerance itself; hi + lo 0.002-0.003.
FWD_MARGIN = 0.5


@pytest.mark.parametrize("B,T", [(128, 75), (16, 28)])
@pytest.mark.parametrize("with_prev,with_mask", [
    (False, False), (False, True), (True, False), (True, True)])
def test_attention_bf16_forward_needs_both_terms(rng, B, T, with_prev,
                                                 with_mask):
    q, k, v, prev, mask = _k2_fwd_bf16_inputs(rng, B, T, 8, 96, with_prev,
                                              with_mask)
    want, _ = realformer_attention_reference(
        *(t.float() for t in (q, k, v)), prev, mask)

    def share(got):
        return ((got - want).abs() / (TOL_BF16["atol"] + TOL_BF16["rtol"]
                                      * want.abs())).max().item()

    split, _ = _k2_fwd_mma(q, k, v, prev, mask)
    one, _ = _k2_fwd_mma(q, k, v, prev, mask, split=False)
    assert share(split) <= FWD_MARGIN < share(one)


# Both tensor-core kernels take the softmax by ex2.approx, whose relative
# error the PTX ISA gives as about 2^-22, and one reciprocal a row. Twice
# that error on every exponent, signs at random, keeps each kernel's
# arithmetic within the bounds its exact-softmax tests hold it to.
EX2_ERR = 2.0 ** -21


@pytest.mark.parametrize("T", [17, 28, 75])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_attention_bf16_kernels_hold_with_the_approximate_exponent(
        rng, T, direction):
    """With prev and a ragged mask (and dcarry): the forward's ctx within
    FWD_MARGIN of TOL_BF16 before its rounding and within TOL_BF16 of the
    JAX package's Pallas forward after it; the backward's products within
    SPLIT_BOUND of the fp32 products, dq, dk, dv within TOL_K2_BWD_BF16 and
    ds within TOL_K2_BWD of the Pallas backward (interpret mode)."""
    if direction == "forward":
        q, k, v, prev, mask = _k2_fwd_bf16_inputs(rng, 2, T, 2, 32, True,
                                                  True)
        want, _ = realformer_attention_reference(
            *(t.float() for t in (q, k, v)), prev, mask)
        got, _ = _k2_fwd_mma(q, k, v, prev, mask, ex2_err=EX2_ERR)
        share = ((got - want).abs() / (TOL_BF16["atol"] + TOL_BF16["rtol"]
                                       * want.abs())).max().item()
        assert share <= FWD_MARGIN
        ref, _ = jax_attention_fwd_kernel(
            *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
              .transpose(0, 2, 1, 3) for t in (q, k, v)),
            jnp.asarray(prev.numpy()), jnp.asarray(mask.numpy()))
        np.testing.assert_allclose(
            got.bfloat16().float().numpy(),
            np.asarray(ref.astype(jnp.float32)).transpose(0, 2, 1, 3),
            **TOL_BF16)
        return
    q, k, v, carry, dctx, dcarry = _k2_bwd_bf16_inputs(rng, T, True, True,
                                                       True)
    fp32 = realformer_attention_backward_reference(
        *(t.float() for t in (q, k, v)), carry, dctx.float(), dcarry)
    got, ds = _k2_bwd_split(q, k, v, carry, dctx, dcarry, ex2_err=EX2_ERR)
    jx = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          .transpose(0, 2, 1, 3) for t in (q, k, v, dctx)]
    ref = jax_attention_bwd_kernel(*jx[:3], jnp.asarray(carry.numpy()),
                                   jx[3], jnp.asarray(dcarry.numpy()))
    for g, want, r in zip(got, fp32[:3], ref[:3]):
        scale = want.abs().max().item()
        assert (g - want).abs().max().item() <= SPLIT_BOUND * scale
        np.testing.assert_allclose(
            g.bfloat16().float().numpy(),
            np.asarray(r.astype(jnp.float32)).transpose(0, 2, 1, 3),
            **TOL_K2_BWD_BF16)
    np.testing.assert_allclose(ds.numpy(), np.asarray(ref[3]), **TOL_K2_BWD)


@pytest.mark.parametrize("dtype,T,E,path", [
    (torch.bfloat16, 75, 96, "mma"),       # the train path
    (torch.bfloat16, 28, 96, "mma"),       # the eval path
    (torch.bfloat16, 128, 96, "mma"),      # the smoke's one-block length
    (torch.bfloat16, 128, 128, "mma"),     # the largest head it takes
    (torch.bfloat16, 1, 16, "mma"),
    (torch.bfloat16, 17, 16, "mma"),
    (torch.bfloat16, 129, 96, "one_block"),  # beyond 8 tiles of 16 rows
    (torch.bfloat16, 200, 96, "tiled"),
    (torch.bfloat16, 512, 96, "tiled"),
    (torch.bfloat16, 33, 40, "one_block"),   # E no multiple of 16
    (torch.bfloat16, 75, 8, "one_block"),
    (torch.bfloat16, 75, 144, "one_block"),  # E beyond 128
    (torch.float32, 75, 96, "mma"),          # the CLIs' fp32 train path
    (torch.float32, 28, 96, "mma"),          # and its eval path
    (torch.float32, 128, 96, "mma"),         # the longest it takes at E=96
    (torch.float32, 112, 128, "mma"),        # ... and at E=128
    (torch.float32, 113, 128, "one_block"),  # 242 KB: beyond one block
    (torch.float32, 33, 40, "one_block"),    # E no multiple of 16
    (torch.float32, 512, 96, "tiled"),
])
def test_attention_forward_path_follows_dtype_t_and_e(dtype, T, E, path):
    assert forward_path(dtype, T, E) == path


def test_attention_bf16_forward_shares_an_sm_three_ways_at_the_train_shape():
    """Three blocks of the train shape's (T=75, E=96) share an SM, as the
    design says, and a fourth does not fit: each takes its shared memory and
    the 1 KB a block reserves, of 228 KB. The largest head forward_path
    sends to the kernel fits one block."""
    need = forward_mma_smem_bytes(75, 96) + 1024
    assert 3 * need <= 233472 < 4 * need
    assert forward_path(torch.bfloat16, 128, 128) == "mma"
    assert forward_mma_smem_bytes(128, 128) <= SMEM_LIMIT


# K2's fp32 tensor-core kernels (tc32::, split TF32): q, k, v (and dctx) as
# fp32 rows of E rounded up to 32, no padding


def test_attention_fp32_forward_shares_an_sm_two_ways_at_the_train_shape():
    """Two blocks of the fp32 forward at (T=75, E=96), 112 KB each, share
    an SM and a third does not fit; the longest head it takes at E=96
    (T=128, 208 KB) fits one block."""
    need = forward_tf32x3_smem_bytes(75, 96) + 1024
    assert 2 * need <= 233472 < 3 * need
    assert forward_tf32x3_smem_bytes(128, 96) <= SMEM_LIMIT


def test_attention_fp32_backward_takes_an_sm_at_the_train_shape():
    """The fp32 backward at (T=75, E=96), 164 KB, takes an SM alone; its
    longest head at E=96 is T=96 (216 KB), and T=97 (the next 16 rows,
    242 KB) does not fit one block."""
    assert 233472 // 2 - 1024 < tf32x3_smem_bytes(75, 96) <= SMEM_LIMIT
    assert tf32x3_smem_bytes(96, 96) <= SMEM_LIMIT < tf32x3_smem_bytes(97, 96)


# ------------------------------------------------------ eval criterion ----

NUM_CLASSES, BC, S = 11, 8, 16


class _JaxLogits(nn.Module):
    """MMBert's apply signature; logits are a linear map of the normalized
    image's channel means, so the port can produce the same logits."""

    num_classes: int

    @nn.compact
    def __call__(self, img, ids, seg, mask, deterministic=True,
                 train_cnn=False):
        w = self.param("w", nn.initializers.normal(1.0), (3, self.num_classes))
        return jnp.mean(img, axis=(1, 2)) @ w


class _TorchLogits(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(w))

    @property
    def device(self):
        return self.w.device

    def forward(self, img, ids, seg, mask):
        return img.mean(dim=(1, 2)) @ self.w


@pytest.mark.parametrize("loss", ["CrossEntropyLoss", "ASLSingleLabel"])
def test_eval_criterion_matches_jax(rng, loss):
    T = 6
    batch = {
        "image": rng.integers(0, 256, size=(BC, S, S, 3), dtype=np.uint8),
        "tokens": np.zeros((BC, T), np.int32),
        "segment_ids": np.zeros((BC, T), np.int32),
        "input_mask": np.ones((BC, T), np.float32),
        "answer": rng.integers(0, NUM_CLASSES, size=BC).astype(np.int32),
        "weights": np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32),
    }
    kw = dict(transformer_model="realformer", hidden_size=16,
              num_classes=NUM_CLASSES, loss=loss)
    jcfg, tcfg = jax_vqa_config(**kw), vqa_config(**kw)
    model = _JaxLogits(NUM_CLASSES)
    variables = model.init(jax.random.PRNGKey(1), jnp.zeros((BC, S, S, 3)),
                           None, None, None)
    _, _, _, jax_eval = make_vqa_steps(model, jcfg, raw=True)
    want = jax_eval(create_train_state(variables, 1e-3),
                    {k: jnp.asarray(v) for k, v in batch.items()})
    w = np.asarray(variables["params"]["w"])
    got = make_vqa_eval_step(_TorchLogits(w), tcfg)(batch)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(got["preds"].numpy(),
                                  np.asarray(want["preds"]))


def test_asl_differs_from_ce_and_weights_drop_padding(rng):
    logits = torch.from_numpy(rng.normal(size=(6, NUM_CLASSES))
                              .astype(np.float32) * 3)
    answers = torch.from_numpy(rng.integers(0, NUM_CLASSES, 6))
    ce = losses.cross_entropy_per_sample(logits, answers)
    asl = losses.asl_per_sample(logits, answers)
    assert (ce - asl).abs().max() > 1e-3
    w = torch.tensor([1.0, 1, 1, 0, 0, 0])
    torch.testing.assert_close(losses.weighted_mean(ce, w), ce[:3].mean())
    torch.testing.assert_close(losses.weighted_mean(ce, torch.zeros(6)),
                               torch.tensor(0.0))


def test_process_batch_eval_normalisation():
    u8 = torch.tensor([[[[0, 128, 255]]]], dtype=torch.uint8)
    torch.testing.assert_close(
        process_batch(u8), torch.tensor([[[[-1.0, 128 / 127.5 - 1, 1.0]]]]))
