"""Ring attention over the 'context' axis of the mesh (counterpart of
mmvqa_tpu/ops/ring_attention.py).

Each rank of a context group holds one block of the token axis: its query
block stays, and the key and value blocks travel round the ring
(``parallel.comm.ring_shift``, one ``core.distributed.exchange`` a step)
while the rank folds each visiting block into an online softmax, so a rank
holds (T / cp) x T scores at most. The JAX package computes these bodies
with einsums outside any Pallas kernel, so they are plain tensor operations
here too (``torch.matmul``); K2 is not on this path.

* ``ring_vanilla_attention``: the BERT encoder's core
  (``ops.attention.vanilla_attention``) on (b, h, t, d) blocks, with that
  function's dtype chain: the products, the scale and the finite -10000 key
  mask in q's dtype, the softmax in fp32, the probabilities cast back for
  ``p v``. The default ``vjp='flash'`` is a ``torch.autograd.Function``
  that saves only the rows' softmax statistics (m, l) and recomputes each
  block's probabilities in a second ring pass, whose dk and dv accumulators
  travel with their blocks and arrive home after cp shifts;
  ``vjp='autodiff'`` differentiates the loop through the shifts. Dropout hits
  the probabilities that multiply v only, so the normaliser keeps the raw
  exponentials (the reference drops normalised probabilities). Its masks
  come from a seed drawn once a call from ``dropout_rng`` with this rank's
  (data, model, context) coordinates and the block's step folded in
  (``core.distributed.fold_seed``), so the flash backward draws them again;
  a rate above 0 without a generator raises, as in the JAX package.
* ``ring_realformer_attention``: the RealFormer's core on (b, t, h, e)
  blocks with the port's carry, fp32 and head-major (b, h, t_q, T): each
  rank holds the carried scores of its query rows for every key, and each
  ring step writes the visiting key block's columns at that block's offset.
  The arithmetic is ``ops.attention.realformer_attention_reference``'s
  (fp32 throughout, ctx cast to q's dtype); the query mask subtracts its
  -10000 from the rows' scores before the softmax, as the XLA path does.
  Its backward is autodiff through the shifts.

Each rank passes its own block; the token axis was split into cp equal
blocks where the batch was placed (``parallel.sharding.place_batch``, which
refuses T % cp != 0; ``cli.common.setup_runtime`` refuses a ring whose
sequence length does not divide, with the JAX package's message). With one
context rank (no mesh, or cp = 1) the body runs with no shift.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from mmvqa_tpu_torch.core import distributed
from mmvqa_tpu_torch.core.mesh import CONTEXT_AXIS
from mmvqa_tpu_torch.parallel.comm import axis_info, ring_shift, shift_over

NEG_BIG = 10000.0


def _cp() -> Tuple[int, int]:
    """(context size, this rank's context coordinate)."""
    _, cp, c = axis_info(CONTEXT_AXIS)
    return cp, c


def _coords() -> Tuple[int, int, int]:
    from mmvqa_tpu_torch.core import mesh

    spec = mesh.CURRENT
    if spec is None:
        return 0, 0, 0
    return spec.data_rank, spec.model_rank, spec.context_rank


def _keep(shape, rate: float, seed: int, device) -> torch.Tensor:
    """The block's keep mask (True: kept) at ``rate``, from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, device=device, generator=g) >= rate


def _block_seed(seed: int, r: int) -> int:
    d, m, c = _coords()
    return distributed.fold_seed(seed, d + 1, m + 1, c + 1, r + 1)


def _scale(q: torch.Tensor) -> float:
    """sqrt(D) rounded to q's dtype, as the plain path takes it."""
    return float(torch.tensor(float(q.shape[-1])).sqrt().to(q.dtype))


def _vanilla_scores(q, k, mask, scale):
    s = torch.matmul(q, k.to(q.dtype).transpose(-1, -2)) / scale
    s = s - (NEG_BIG * (1.0 - mask.to(s.dtype)))[:, None, None, :]
    return s.float()


def _vanilla_forward(q, k, v, mask, seed, rate, shift):
    """The online softmax over the cp key blocks: (out, m, l)."""
    cp, _ = _cp()
    scale = _scale(q)
    m = l = o = None
    k_cur, v_cur, mask_cur = k, v, mask
    for r in range(cp):
        s = _vanilla_scores(q, k_cur, mask_cur, scale)
        blk_max = s.amax(dim=-1, keepdim=True)
        m_new = blk_max if m is None else torch.maximum(m, blk_max)
        p = torch.exp(s - m_new)
        p_v = p
        if seed is not None:
            keep = _keep(p.shape, rate, _block_seed(seed, r), p.device)
            p_v = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
        pv = torch.matmul(p_v.to(q.dtype), v_cur).float()
        if m is None:
            l = p.sum(dim=-1, keepdim=True)
            o = pv
        else:
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            o = o * corr + pv
        m = m_new
        if r + 1 < cp:
            k_cur, v_cur = shift(k_cur, v_cur)
            (mask_cur,) = shift_over(mask_cur, axis=CONTEXT_AXIS)
    return (o / l).to(q.dtype), m, l


class _FlashVanilla(torch.autograd.Function):
    """Saves q, k, v, the mask, the output and (m, l); the backward
    recomputes each block's probabilities (the JAX ``_vanilla_bwd_body``)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seed, rate):
        out, m, l = _vanilla_forward(
            q, k, v, mask, seed, rate,
            lambda *t: shift_over(*t, axis=CONTEXT_AXIS))
        ctx.save_for_backward(q, k, v, mask, out, m, l)
        ctx.seed, ctx.rate = seed, rate
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, m, l = ctx.saved_tensors
        seed, rate = ctx.seed, ctx.rate
        cp, _ = _cp()
        scale = _scale(q)
        g32 = g.float()
        delta = (g32 * out.float()).sum(dim=-1, keepdim=True)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_cur = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur, mask_cur = k, v, mask
        q32 = q.float()
        for r in range(cp):
            p = torch.exp(_vanilla_scores(q, k_cur, mask_cur, scale) - m) / l
            dp = torch.matmul(g32, v_cur.float().transpose(-1, -2))
            p_v = p
            if seed is not None:
                keep = _keep(p.shape, rate, _block_seed(seed, r), p.device)
                zero = torch.zeros_like(p)
                p_v = torch.where(keep, p / (1.0 - rate), zero)
                dp = torch.where(keep, dp / (1.0 - rate), zero)
            dv_cur = dv_cur + torch.matmul(p_v.transpose(-1, -2), g32)
            ds = p * (dp - delta)
            dq = dq + torch.matmul(ds, k_cur.float()) / scale
            dk_cur = dk_cur + torch.matmul(ds.transpose(-1, -2), q32) / scale
            # every step shifts (cp in all): the accumulators arrive home
            # with their blocks
            k_cur, v_cur, mask_cur, dk_cur, dv_cur = shift_over(
                k_cur, v_cur, mask_cur, dk_cur, dv_cur, axis=CONTEXT_AXIS)
        return (dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype),
                None, None, None)


def ring_vanilla_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    key_mask: Optional[torch.Tensor], *,
    dropout_rng: Optional[torch.Generator] = None,
    dropout_rate: float = 0.0, deterministic: bool = True,
    vjp: str = "flash",
) -> torch.Tensor:
    """Sequence-parallel ``vanilla_attention``: q, k, v (b, h, t, d) this
    rank's token block, key_mask (b, t) (1 real, 0 pad) or None -> this
    block's output (b, h, t, d)."""
    if vjp not in ("flash", "autodiff"):
        raise ValueError(f"ring_vanilla_attention: unknown vjp {vjp!r}")
    if key_mask is None:
        key_mask = torch.ones(q.shape[0], q.shape[2], device=q.device)
    seed = None
    if not deterministic and dropout_rate > 0.0:
        if dropout_rng is None:
            raise ValueError(
                "ring attention: dropout_rng is required when "
                "deterministic=False and dropout_rate > 0")
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=dropout_rng,
                                 device=dropout_rng.device).item())
    if vjp == "flash" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _FlashVanilla.apply(q, k, v, key_mask, seed, dropout_rate)
    out, _, _ = _vanilla_forward(
        q, k, v, key_mask, seed, dropout_rate,
        lambda *t: ring_shift(*t, axis=CONTEXT_AXIS))
    return out


def ring_realformer_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    prev: Optional[torch.Tensor], query_mask: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence-parallel ``realformer_attention``: q, k, v (b, t, h, e) this
    rank's token block; prev (b, h, t, T) fp32, its query rows of the
    carried scores, or None; query_mask (b, t) or None. Returns (ctx
    (b, t, h, e) in q's dtype, the carry (b, h, t, T) fp32)."""
    cp, me = _cp()
    B, Tq, H, E = q.shape
    qh = q.float().permute(0, 2, 1, 3)
    scale = math.sqrt(E)
    neg = (None if query_mask is None else
           (NEG_BIG * (1.0 - query_mask.float()))[:, None, :, None])
    blocks = [None] * cp
    m = l = o = None
    k_cur, v_cur = k, v
    for r in range(cp):
        src = (me - r) % cp  # where the visiting key block comes from
        kh = k_cur.float().permute(0, 2, 1, 3)
        s = torch.matmul(qh, kh.transpose(-1, -2)) / scale
        if prev is not None:
            s = s + prev[..., src * Tq:(src + 1) * Tq]
        if neg is not None:
            s = s - neg
        blocks[src] = s
        blk_max = s.amax(dim=-1, keepdim=True)
        m_new = blk_max if m is None else torch.maximum(m, blk_max)
        p = torch.exp(s - m_new)
        pv = torch.matmul(p, v_cur.float().permute(0, 2, 1, 3))
        if m is None:
            l = p.sum(dim=-1, keepdim=True)
            o = pv
        else:
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            o = o * corr + pv
        m = m_new
        if r + 1 < cp:
            k_cur, v_cur = ring_shift(k_cur, v_cur, axis=CONTEXT_AXIS)
    ctx = (o / l).permute(0, 2, 1, 3).to(q.dtype)
    return ctx, torch.cat(blocks, dim=-1)
