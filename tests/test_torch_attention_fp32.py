"""K2's fp32 tensor-core kernels (csrc/realformer_attention.cu, tc32::, and
csrc/realformer_attention_bwd.cu, k2bwd::tc32::) on the CPU: their split-TF32
arithmetic written out in numpy and held against the JAX package, its XLA
forward and its Pallas backward in interpret mode, at chip_smoke.py's fp32
tolerances; a control with one TF32 product a product misses them. The
kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py); their routing and shared memory are in
tests/test_torch_ops.py.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvqa_tpu.ops.attention import realformer_attention as jax_attention
from mmvqa_tpu.ops.pallas_attention import _bwd_call as jax_attention_bwd

from mmvqa_tpu_torch.ops.attention import (
    realformer_attention_backward_reference,
    realformer_attention_reference,
)
from test_torch_tf32 import _rna_tf32, _split, _toward_zero

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)

B, H, E = 2, 2, 96  # the flagship's head width: the contraction of s and dp

_jax_forward = jax.jit(functools.partial(jax_attention, impl="xla"))
_jax_backward = jax.jit(jax_attention_bwd)


def _products(a, b, terms=3):
    """a (..., M, K) @ b (..., K, N) as the kernels take it (tf32x3.cuh::
    mma3_into): each k8 step's TF32 products, each the exact sum of eight
    exact products, summed straight into the fp32 accumulator and cut
    toward zero, as the tensor cores sum. ``terms`` 3: a_lo b_hi, a_hi b_lo,
    a_hi b_hi, in that order (hi = rna_tf32(x), lo = the rest cut to TF32);
    1: the control, one product of the operands rounded to TF32."""
    if terms == 3:
        (ah, al), (bh, bl) = _split(a), _split(b)
        pairs = ((al, bh), (ah, bl), (ah, bh))
    else:
        pairs = ((_rna_tf32(a), _rna_tf32(b)),)
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for k0 in range(0, a.shape[-1], 8):
        k8 = slice(k0, k0 + 8)
        for x, y in pairs:
            acc = _toward_zero(acc.astype(np.float64)
                               + x[..., k8].astype(np.float64)
                               @ y[..., k8, :].astype(np.float64))
    return acc


def _heads(t):
    """(B, T, H, E) -> (B, H, T, E), contiguous fp32."""
    return np.ascontiguousarray(t.transpose(0, 2, 1, 3), np.float32)


def _softmax(s):
    """The kernels' softmax in fp32: expf(s - max) times one reciprocal of
    its row's sum."""
    e = np.exp(s - s.max(axis=-1, keepdims=True))
    return e * (np.float32(1.0) / e.sum(axis=-1, keepdims=True))


def _scale(e):
    return np.float32(1.0) / np.sqrt(np.float32(e))  # 1.0f / sqrtf(E)


def _k2_fwd_tf32x3(q, k, v, prev, mask, terms=3):
    """The fp32 forward kernel's arithmetic: s = q k^T by split-TF32
    products, times 1 / sqrt(E), plus prev, minus the mask term, as the
    plain version orders them; the softmax; ctx = p v by split-TF32
    products. q, k, v (B, T, H, E) fp32; returns ctx (B, T, H, E) and s
    (B, H, T, T)."""
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    s = _products(qh, kh.transpose(0, 1, 3, 2), terms) * _scale(q.shape[-1])
    if prev is not None:
        s = s + prev
    if mask is not None:
        s = s - np.float32(10000.0) * (np.float32(1.0) - mask)[:, None, :,
                                                                None]
    ctx = _products(_softmax(s), vh, terms)
    return ctx.transpose(0, 2, 1, 3), s


def _k2_bwd_tf32x3(q, k, v, carry, dctx, dcarry, terms=3):
    """The fp32 backward kernel's arithmetic: p from the carry, dp = dctx
    v^T, ds = p (dp - sum_keys(dp p)) + dcarry in fp32, then dq = ds k, dk =
    ds^T q (each times 1 / sqrt(E)) and dv = p^T dctx, every product split
    TF32. Returns dq, dk, dv (B, T, H, E) and ds (B, H, T, T)."""
    qh, kh, vh, dch = _heads(q), _heads(k), _heads(v), _heads(dctx)
    p = _softmax(carry)
    dp = _products(dch, vh.transpose(0, 1, 3, 2), terms)
    ds = p * (dp - (dp * p).sum(axis=-1, keepdims=True))
    if dcarry is not None:
        ds = ds + dcarry
    scale = _scale(q.shape[-1])
    dq = _products(ds, kh, terms) * scale
    dk = _products(ds.transpose(0, 1, 3, 2), qh, terms) * scale
    dv = _products(p.transpose(0, 1, 3, 2), dch, terms)
    return [t.transpose(0, 2, 1, 3) for t in (dq, dk, dv)], ds


def _inputs(rng, T, with_prev, with_mask):
    """q, k, v as slices of one kqv (B, T, H, 3E), prev (B, H, T, T) or
    None, a mask with padded queries in every image (lengths drawn as
    chip_smoke.py draws them, below T) or None."""
    kqv = rng.standard_normal((B, T, H, 3 * E), dtype=np.float32)
    k, q, v = (kqv[..., i * E:(i + 1) * E] for i in range(3))
    prev = (rng.standard_normal((B, H, T, T), dtype=np.float32)
            if with_prev else None)
    mask = None
    if with_mask:
        lengths = rng.integers(T // 2, T, B)
        mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    return q, k, v, prev, mask


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol["rtol"], atol=tol["atol"])


LAYERS_FWD = [(False, False), (False, True), (True, False), (True, True)]


@pytest.mark.parametrize("T", [17, 28, 75])
@pytest.mark.parametrize("with_prev,with_mask", LAYERS_FWD)
def test_attention_fp32_forward_split_tf32_matches_jax(rng, T, with_prev,
                                                       with_mask):
    """The fp32 forward's arithmetic against the JAX package's XLA path and
    the port's plain version on the same fp32 inputs: ctx within
    TOL_K2_VALID on the valid query rows and TOL_K2_PADDED on all of them,
    the carry within TOL_K2_CARRY. T of the flagship's two lengths and a
    ragged one, the four kinds of layer."""
    q, k, v, prev, mask = _inputs(rng, T, with_prev, with_mask)
    ctx, s = _k2_fwd_tf32x3(q, k, v, prev, mask)
    ctx_x, s_x = _jax_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if prev is None else jnp.asarray(prev.transpose(0, 2, 3, 1)),
        None if mask is None else jnp.asarray(mask))
    ctx_p, s_p = realformer_attention_reference(
        *(torch.from_numpy(np.ascontiguousarray(t)) for t in (q, k, v)),
        None if prev is None else torch.from_numpy(prev),
        None if mask is None else torch.from_numpy(mask))
    valid = (np.ones((B, T), bool) if mask is None else mask.astype(bool))
    for want_ctx, want_s in ((np.asarray(ctx_x),
                              np.asarray(s_x).transpose(0, 3, 1, 2)),
                             (ctx_p.numpy(), s_p.numpy())):
        _close(ctx[valid], want_ctx[valid], chip_smoke.TOL_K2_VALID)
        _close(ctx, want_ctx, chip_smoke.TOL_K2_PADDED)
        _close(s, want_s, chip_smoke.TOL_K2_CARRY)


LAYERS_BWD = [(False, False, False), (False, True, True), (True, True, True),
              (True, True, False)]


@pytest.mark.parametrize("T", [17, 28, 75])
@pytest.mark.parametrize("with_prev,with_mask,with_dcarry", LAYERS_BWD)
def test_attention_fp32_backward_split_tf32_matches_the_reference_kernel(
        rng, T, with_prev, with_mask, with_dcarry):
    """The fp32 backward's arithmetic against the JAX package's Pallas
    backward (interpret mode, as tests/test_pallas_attention.py runs it) and
    the port's plain version, on the same fp32 inputs and carry (the plain
    forward's): dq, dk, dv and ds within TOL_K2_BWD."""
    q, k, v, prev, mask = _inputs(rng, T, with_prev, with_mask)
    _, carry = realformer_attention_reference(
        *(torch.from_numpy(np.ascontiguousarray(t)) for t in (q, k, v)),
        None if prev is None else torch.from_numpy(prev),
        None if mask is None else torch.from_numpy(mask))
    carry = carry.numpy()
    dctx = rng.standard_normal((B, T, H, E), dtype=np.float32)
    dcarry = (0.1 * rng.standard_normal((B, H, T, T), dtype=np.float32)
              if with_dcarry else None)
    (dq, dk, dv), ds = _k2_bwd_tf32x3(q, k, v, carry, dctx, dcarry)
    want = _jax_backward(
        *(jnp.asarray(_heads(t)) for t in (q, k, v)), jnp.asarray(carry),
        jnp.asarray(_heads(dctx)),
        jnp.asarray(np.zeros_like(carry) if dcarry is None else dcarry))
    plain = realformer_attention_backward_reference(
        *(torch.from_numpy(np.ascontiguousarray(t)) for t in (q, k, v)),
        torch.from_numpy(carry), torch.from_numpy(dctx),
        None if dcarry is None else torch.from_numpy(dcarry))
    for got, ref, pl in zip((dq, dk, dv), want[:3], plain[:3]):
        _close(got, np.asarray(ref).transpose(0, 2, 1, 3),
               chip_smoke.TOL_K2_BWD)
        _close(got, pl.numpy(), chip_smoke.TOL_K2_BWD)
    _close(ds, np.asarray(want[3]), chip_smoke.TOL_K2_BWD)
    _close(ds, plain[3].numpy(), chip_smoke.TOL_K2_BWD)


@pytest.mark.parametrize("T", [17, 28, 75])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_attention_fp32_needs_the_split(rng, T, direction):
    """With prev, padded queries and dcarry: one TF32 product a product (the
    operands rounded to TF32, fp32 sums) misses TOL_K2_VALID on the valid
    rows of ctx against the JAX package's XLA path, and TOL_K2_BWD on dq,
    dk and dv against its Pallas backward, where the split products meet
    them (the two tests above; read on these inputs: the split uses at most
    7% of either tolerance, one product 24 to 28 times TOL_K2_VALID and 5
    to 12 times TOL_K2_BWD)."""
    q, k, v, prev, mask = _inputs(rng, T, True, True)

    def misses(got, want, tol):
        return (np.abs(got - want) > tol["atol"] + tol["rtol"]
                * np.abs(want)).any()

    if direction == "forward":
        ctx, _ = _k2_fwd_tf32x3(q, k, v, prev, mask, terms=1)
        want, _ = _jax_forward(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v),
                               jnp.asarray(prev.transpose(0, 2, 3, 1)),
                               jnp.asarray(mask))
        valid = mask.astype(bool)
        assert misses(ctx[valid], np.asarray(want)[valid],
                      chip_smoke.TOL_K2_VALID)
        return
    _, carry = realformer_attention_reference(
        *(torch.from_numpy(np.ascontiguousarray(t)) for t in (q, k, v)),
        torch.from_numpy(prev), torch.from_numpy(mask))
    carry = carry.numpy()
    dctx = rng.standard_normal((B, T, H, E), dtype=np.float32)
    dcarry = 0.1 * rng.standard_normal((B, H, T, T), dtype=np.float32)
    got, _ = _k2_bwd_tf32x3(q, k, v, carry, dctx, dcarry, terms=1)
    want = _jax_backward(*(jnp.asarray(_heads(t)) for t in (q, k, v)),
                         jnp.asarray(carry), jnp.asarray(_heads(dctx)),
                         jnp.asarray(dcarry))
    for g, w in zip(got, want[:3]):
        assert misses(g, np.asarray(w).transpose(0, 2, 1, 3),
                      chip_smoke.TOL_K2_BWD)
