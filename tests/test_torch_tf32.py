"""The fp32 path on Hopper's tensor cores, on the CPU: the TF32 flags the
CLIs set, a numpy model of the split-TF32 arithmetic of ``csrc/tf32x3.cuh``
held to the card's fp32 tolerances, a numpy model of the token head's fp32
forward (``csrc/token_head.cu``, k1::fwd32) held to the JAX package's
reference, and the launch plans of the fp32 kernels that use it (K4,
``ops/conv_bn.py::tf32_plan``; K1-bwd, ``ops/token_head.py::backward_plan``)
at the flagship's shapes (K1-fwd's, ``fp32_forward_plan``, are walked in
``tests/test_torch_ops.py``). The kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import os
import sys

import numpy as np
import pytest
import torch

from mmvqa_tpu_torch.cli.common import setup_runtime
from mmvqa_tpu_torch.core.config import pretrain_config, vqa_config
from mmvqa_tpu_torch.ops import tiling
from mmvqa_tpu_torch.ops.conv_bn import (
    SMEM_LIMIT,
    TF32_BLOCKS_PER_SM,
    TF32_TILES,
    tf32_plan,
)
from mmvqa_tpu_torch.ops.activations import serf_exact
from mmvqa_tpu_torch.ops.token_head import (
    FP32_ROWS,
    FP32_TILES,
    SMEM_PER_SM,
    backward_plan,
    backward_scratch,
    fp32_forward_plan,
    fp32_tiles_items,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

SMS = 132  # an H100 SXM's multiprocessors
HIDDEN = chip_smoke.HIDDEN


# ------------------------------------------------------------ TF32 flags ----

@pytest.mark.parametrize("cfg", [
    pretrain_config(steps_per_call=1),
    pretrain_config(steps_per_call=1, mixed_precision=True),
    vqa_config(steps_per_call=1),
    vqa_config(steps_per_call=1, mixed_precision=True),
], ids=["pretrain-fp32", "pretrain-bf16", "vqa-fp32", "vqa-bf16"])
def test_setup_runtime_turns_tf32_off(cfg):
    """Every CLI's set-up turns PyTorch's TF32 flags off itself, whatever
    the process had: cuDNN's fp32 convolutions (the trunk's 3x3 and stride-2
    ones) and fp32 matrix products stay fp32, as in the JAX package."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    try:
        matmul.allow_tf32 = cudnn.allow_tf32 = True
        dev, _ = setup_runtime(cfg, device="cpu")
        assert dev.type == "cpu"
        assert matmul.allow_tf32 is False and cudnn.allow_tf32 is False
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


# ------------------------------------------- split-TF32 arithmetic ----

def _rna_tf32(v: np.ndarray) -> np.ndarray:
    """TF32 to nearest, ties away from zero, as cvt.rna.tf32.f32 rounds and
    as tf32x3.cuh::split computes hi (the sign is its own bit, so adding
    half a step to the magnitude's bits and cutting the low 13 does it)."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _cut_tf32(v: np.ndarray) -> np.ndarray:
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _split(v: np.ndarray):
    """tf32x3.cuh::split: hi to nearest, lo the exact rest cut to TF32."""
    hi = _rna_tf32(v)
    return hi, _cut_tf32((v - hi).astype(np.float32))


def _toward_zero(r: np.ndarray) -> np.ndarray:
    """float64 sums to fp32, cutting what does not fit (the tensor cores'
    sums: read on the card, see test_split_tf32_product_keeps_fp32_accuracy)."""
    f = r.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(r)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _product(a: np.ndarray, b: np.ndarray, how: str) -> np.ndarray:
    """a (M, K) @ b (K, N) as the card would take it.

    ``kernel``: tf32x3.cuh::mma3. Each k8 step's three products (a_lo b_hi,
    a_hi b_lo, a_hi b_hi: each product exact, 11 x 11 significant bits) are
    summed from zero, eight at a time, toward zero, and the step's sum is
    added to the running fp32 sum, to nearest. ``into_sum``: the same
    products summed straight into the running sum, toward zero (the
    kernels' first form). ``tf32``: one pass of the rounded operands, fp32
    sums. ``fp32``: the plain fp32 product, k by k."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    if how in ("tf32", "fp32"):
        x, y = (a, b) if how == "fp32" else (_rna_tf32(a), _rna_tf32(b))
        for k in range(a.shape[1]):
            acc = (acc + (x[:, k:k + 1] * y[k:k + 1, :]).astype(np.float32)
                   ).astype(np.float32)
        return acc
    (ah, al), (bh, bl) = _split(a), _split(b)
    ah, al, bh, bl = (t.astype(np.float64) for t in (ah, al, bh, bl))
    for k0 in range(0, a.shape[1], 8):
        k8 = slice(k0, k0 + 8)
        terms = (al[:, k8] @ bh[k8], ah[:, k8] @ bl[k8], ah[:, k8] @ bh[k8])
        if how == "kernel":
            t = np.zeros_like(acc)
            for p in terms:
                t = _toward_zero(t.astype(np.float64) + p)
            acc = (acc + t).astype(np.float32)
        else:
            for p in terms:
                acc = _toward_zero(acc.astype(np.float64) + p)
    return acc


def test_split_rounds_hi_to_ten_bits_ties_away_and_cuts_lo():
    one = np.float32(1.0)
    step = np.float32(2.0 ** -10)
    v = np.array([1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, -(1 + 2.0 ** -11),
                  1 + 2.0 ** -12, 3.0], np.float32)
    np.testing.assert_array_equal(
        _rna_tf32(v), np.array([one + step, one + 2 * step, -(one + step),
                                one, 3.0], np.float32))
    hi, lo = _split(np.float32([np.pi]))
    assert (hi.view(np.uint32) & 0x1FFF).item() == 0
    assert (lo.view(np.uint32) & 0x1FFF).item() == 0
    assert abs(float(hi[0]) + float(lo[0]) - np.float32(np.pi)) < 2.0 ** -20


# the contraction lengths of K4 (K of the trunk's 1x1 convolutions, 80 to
# 3072) and of K1-bwd (K of the taps, 24 to 512; C = 768 for dx)
@pytest.mark.parametrize("K", [24, 48, 80, 176, 304, 512, 768, 1824, 3072])
def test_split_tf32_product_keeps_fp32_accuracy(K):
    """Against the float64 product of the same fp32 inputs (made as the
    smoke makes them: x ~ N(0, 1), W ~ N(0, 1/K)), the kernels' split
    product stays within the smoke's fp32 tolerances for K4 (TOL_K4_F32) and
    K1-bwd (RTOL_K1_BWD with its absolute term of the largest entry) and
    within the plain fp32 product's own error (measured 0.3 to 1.0 times
    it); one TF32 pass misses TOL_K4_F32 by more than ten times. Summed
    straight into the running sum, the same products drift with K and miss
    TOL_K4_F32 from K = 1824, as the first form of the kernels did on the
    card (K4's y, 3.4e-5 to 6.7e-5 beyond its limit at K = 1824 and 3072,
    NVIDIA H100 80GB HBM3, 700 W)."""
    rng = np.random.default_rng(K)
    a = rng.standard_normal((32, K)).astype(np.float32)
    b = (rng.standard_normal((K, 24)) * K ** -0.5).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    err = {how: np.abs(_product(a, b, how) - ref)
           for how in ("kernel", "into_sum", "tf32", "fp32")}
    tol = chip_smoke.TOL_K4_F32
    k4 = tol["atol"] + tol["rtol"] * np.abs(ref)
    assert (err["kernel"] <= k4).all()
    r = chip_smoke.RTOL_K1_BWD
    assert (err["kernel"] <= r * np.abs(ref) + r * np.abs(ref).max()).all()
    assert err["kernel"].max() <= 1.5 * err["fp32"].max()
    assert (err["tf32"] / k4).max() > 10
    assert (err["into_sum"] <= k4).all() == (K < 1824)


# --------------------------------------- the token head's fp32 forward ----

def _token_head_forward_model(x: np.ndarray, w: np.ndarray,
                              plan) -> np.ndarray:
    """mean_p serf(x @ w) as k1::fwd32 in csrc/token_head.cu takes it: s by
    the split-TF32 products (_product "kernel": each k8 step's three
    products summed from zero, its sum added to the running fp32 sum), and
    where the plan cuts K into slices of 32-k chunks, each slice's sum from
    zero, the slices added in order; exact SERF in fp32; the rows of the
    B * P axis cut into blocks of
    plan.per_block * plan.tp rows; in a block, a warp's row lane g (of 8)
    adds SERF of the rows n = g mod 8 of an image in order, in fp32; at the
    image's end the 8 lanes are added by shuffles (g ^ 1, then g ^ 2, then
    g ^ 4); the blocks' partials of an image are added in block order and
    the sum divided by P."""
    B, P, K = x.shape
    rows = x.reshape(B * P, K)
    n_kc = -(-K // 32)
    s = np.zeros((B * P, w.shape[1]), np.float32)
    for z in range(plan.ks):
        k = slice(z * n_kc // plan.ks * 32, (z + 1) * n_kc // plan.ks * 32)
        s = s + _product(rows[:, k], w[k], "kernel")
    a = serf_exact(torch.from_numpy(s)).numpy()
    rows_pb = plan.per_block * plan.tp
    out = np.zeros((B, w.shape[1]), np.float32)
    for b in range(B):
        total = np.zeros(w.shape[1], np.float32)
        for j in range(b * P // rows_pb, ((b + 1) * P - 1) // rows_pb + 1):
            lo, hi = max(b * P, j * rows_pb), min((b + 1) * P,
                                                  (j + 1) * rows_pb)
            lanes = np.zeros((8, w.shape[1]), np.float32)
            for n0 in range(lo - lo % 8, hi, 8):
                g = slice(max(lo - n0, 0), min(hi - n0, 8))
                lanes[g] = lanes[g] + a[n0 + g.start:n0 + g.stop]
            for off in (1, 2, 4):  # lane g takes lane g ^ off's sum
                lanes = lanes + lanes[np.arange(8) ^ off]
            total = total + lanes[0]
        out[b] = total / np.float32(P)
    return out


@pytest.mark.parametrize("B,P,K", [(3, 49, 24), (3, 49, 2048),
                                   (2, 12544, 24)])
def test_token_head_fp32_forward_arithmetic_meets_the_reference(B, P, K):
    """The fp32 forward's arithmetic (_token_head_forward_model) at the
    flagship's stage 0 (P = 12544, K = 24: the longest sums over rows) and
    ResNet's layer4 (P = 49, K = 2048: the longest over K, which the plan
    cuts into slices; its 64-row tiles cross images), and P = 49 at K = 24
    (16-row tiles), with the
    plan the kernel takes for C = 768 on a 132-SM card of two blocks an SM,
    against the JAX package's token_head_reference in fp32 within the
    smoke's TOL_K1_F32, inputs as the smoke makes them (x ~ N(0, 1), W ~
    N(0, 1/K)); 16 channels."""
    import jax.numpy as jnp

    from mmvqa_tpu.ops.pallas_token_head import token_head_reference

    rng = np.random.default_rng(K + P)
    x = rng.standard_normal((B, P, K)).astype(np.float32)
    w = (rng.standard_normal((K, 16)) * K ** -0.5).astype(np.float32)
    plan = fp32_forward_plan(B, P, K, HIDDEN, SMS, 2)
    if P == 49:
        assert plan.tp * plan.per_block % P
    assert (plan.ks > 1) == (K == 2048)
    got = _token_head_forward_model(x, w, plan)
    want = np.asarray(token_head_reference(jnp.asarray(x), jnp.asarray(w),
                                           "serf"))
    tol = chip_smoke.TOL_K1_F32
    np.testing.assert_allclose(got, want, rtol=tol["rtol"], atol=tol["atol"])


# -------------------------------------------------------- launch plans ----

def _k4_sites(B):
    _, k4, _ = chip_smoke.trunk_sites(B)
    return sorted(k4)


@pytest.mark.parametrize("B", [chip_smoke.CHECK_B, chip_smoke.CLI_B,
                               chip_smoke.TRAIN_B])
def test_conv1x1_stats_tf32_plan_fills_the_card(B):
    """At every K4 site shape of the flagship trunk at the fp32 check's,
    the CLI's and the train batch, on a 132-SM card: the grid has at least
    a block an SM wherever the shape has that many 64 x 64 tiles (else all
    of them); unsliced, no more blocks than the card's slots (one wave); K
    is sliced only where it is deep and every row tile has its own block,
    and at the 7x7 sites of B=16 (the CLI's batch), whose 64 x 64 tiles are
    fewer than the SMs, it is; two blocks fit an SM's shared memory; the
    blocks of a column tile take its row tiles in turn, each once."""
    assert {(bm, bn) for bm, bn, _ in TF32_TILES} == {
        (128, 128), (128, 64), (64, 128), (64, 64)}
    for N, K, C in _k4_sites(B):
        plan = tf32_plan(N, K, C, SMS)
        mtiles, ctiles = tiling.cdiv(N, plan.bm), tiling.cdiv(C, plan.bn)
        most = tiling.cdiv(N, 64) * tiling.cdiv(C, 64)
        grid = ctiles * plan.nrb * plan.ks
        assert grid >= min(SMS, most), (N, K, C, plan)
        assert 1 <= plan.nrb <= mtiles
        if plan.ks > 1:  # every row tile a block, in full waves
            assert K >= 1024 and plan.nrb == mtiles
        else:            # one wave, each block walking row tiles
            assert grid <= TF32_BLOCKS_PER_SM * SMS
        if most < SMS and K >= 1024:
            assert plan.ks > 1, (N, K, C, plan)
        assert plan.smem <= SMEM_LIMIT
        assert TF32_BLOCKS_PER_SM * (plan.smem + 1024) <= SMEM_PER_SM
        walked = sorted(m for r in range(plan.nrb)
                        for m in range(r, mtiles, plan.nrb))
        assert walked == list(range(mtiles))


@pytest.mark.parametrize("B", [chip_smoke.CHECK_B, chip_smoke.CLI_B,
                               chip_smoke.TRAIN_B])
@pytest.mark.parametrize("slots", [1, 2])
def test_token_head_fp32_backward_plan_fills_the_card(B, slots):
    """At the five taps at the fp32 check's, the CLI's and the train batch:
    the rows mode (K <= 96) gives min(row tiles, blocks the card holds)
    blocks (``slots`` an SM: the wrapper asks the card), the tiles mode the
    same of its larger phase; a block fits an SM's shared memory."""
    for _, side, K in chip_smoke.TAPS:
        P = side * side
        N = B * P
        plan = backward_plan(B, P, K, HIDDEN, 4, SMS, slots)
        if K <= 96:
            assert plan.mode == FP32_ROWS
            items = tiling.cdiv(N, plan.tp)
        else:
            assert plan.mode == FP32_TILES
            items = max(fp32_tiles_items(N, K, HIDDEN, plan.rsplit))
        assert plan.nblocks == min(items, slots * SMS)
        assert plan.smem <= SMEM_LIMIT


def test_token_head_fp32_backward_stage6_has_no_partial():
    """Stage 6 at the CLI's B=16 (784 positions, K = 512): 13 row tiles of
    64 could not fill the card, and a (K, C) fp32 partial a block (1.5 MB)
    would cost more than the products. The plan takes the tiles mode: its
    scratch is gact, 784 x 768, with no partial of dW at all (one segment
    of the rows), and its blocks are at least the SMs."""
    B, P, K = chip_smoke.CLI_B, 7 * 7, 512
    for slots in (1, 2, 3):
        plan = backward_plan(B, P, K, HIDDEN, 4, SMS, slots)
        assert plan.mode == FP32_TILES and plan.rsplit == 1
        scratch = backward_scratch(plan, 4, B, P, K, HIDDEN)
        assert scratch == (B * P * HIDDEN,)
        assert plan.nblocks >= SMS
    # the rows mode where K is small: a partial a block, as before
    plan = backward_plan(B, 112 * 112, 24, HIDDEN, 4, SMS, 1)
    assert backward_scratch(plan, 4, B, 112 * 112, 24, HIDDEN) == (
        plan.nblocks, 24, HIDDEN)
