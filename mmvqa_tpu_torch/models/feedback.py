"""Feedback Transformer encoder (counterpart of mmvqa_tpu/models/feedback.py),
``--transformer_model feedback-transformer``.

The fused input sequence is cut into ``seq_len=2`` windows, run one after
the other by a Python loop. Each window's layers attend to a memory of
earlier windows plus the window's own tokens, causally, with a T5-style
relative position bias. After a window, the softmax(``layer_weight``)
aggregate of its input and every layer's output goes through ``shared_kv``,
the one key/value projection that every layer also uses for its own keys
and values, and is appended to the memory.

The memory is the JAX package's fixed buffer: ``M = min(mem_len, T_pad)``
slots, valid ones ``[0, count)`` oldest first, so that a slot's index is its
key position and the window's own keys sit at ``count + t``. A window whose
append overflows the buffer first shifts it left by the overflow (the
reference's ``memory[:, -mem_len:]``). An odd T leaves a last window of one
valid token, padded to two: that window masks every self column, not only
the padded one (the reference gives a one-token window no self keys).
Masked scores take ``NEG_MAX`` in the compute dtype; the softmax runs in
fp32 and is cast back. The padding mask is ignored, as in the reference.

Dropout: on the attention probabilities after the softmax, and between the
GEGLU and the feed-forward's down projection; both draw from the model's
``DropoutRng``.

Module names follow the Flax tree of the ``nn.scan`` over windows, whose
parameters are broadcast (one set for every window):
``segment/{shared_kv, rel_bias, layer_weight, attn_norm_<i>, to_q_<i>,
to_out_<i>, ff_norm_<i>, ff_<i>/{w_in, w_out}}``, so ``bridge.py`` maps one
onto the other. The JAX package computes all of it with XLA einsums, outside
any Pallas kernel, and so does the port with torch's matmuls.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mmvqa_tpu_torch.models.layers import Dropout, DropoutRng, LayerNorm, Linear
from mmvqa_tpu_torch.ops.activations import gelu_erf

NEG_MAX = -3.0e38  # the reference's masked_fill_(-finfo(f32).max)
LN_EPS = 1e-6      # Flax LayerNorm's default


def relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Causal T5 bucket of a relative position (key minus query): the
    distance into the past itself below ``num_buckets // 2``, beyond it a
    log-spaced bucket, taken in float32 and truncated, as the JAX function
    computes it."""
    n = torch.clamp(-rel_pos, min=0)
    max_exact = num_buckets // 2
    log_ratio = torch.log(torch.clamp(n, min=1).to(torch.float32) / max_exact)
    val_large = max_exact + (
        log_ratio / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return torch.where(n < max_exact, n.to(torch.int32), val_large)


class GEGLUFeedForward(nn.Module):
    """``w_in`` (d -> 2 mult d), ``gelu(gate) * val`` where ``val, gate``
    are the two halves in that order, dropout, ``w_out`` (mult d -> d)."""

    def __init__(self, dim: int, rng: DropoutRng, mult: int = 4,
                 dropout: float = 0.0):
        super().__init__()
        self.w_in = Linear(dim, dim * mult * 2)
        self.drop = Dropout(dropout, rng)
        self.w_out = Linear(dim * mult, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        val, gate = self.w_in(x).chunk(2, dim=-1)
        return self.w_out(self.drop(gelu_erf(gate) * val))


class FeedbackSegment(nn.Module):
    """One window against the memory: ``forward(mem_k, mem_v, count, xseg,
    n_valid) -> (mem_k, mem_v, count, out)``."""

    def __init__(self, hidden_size: int, n_layers: int, rng: DropoutRng,
                 heads: int = 8, dim_head: int = 64, num_buckets: int = 32,
                 max_distance: int = 128, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0):
        super().__init__()
        self.n_layers, self.heads, self.dim_head = n_layers, heads, dim_head
        self.num_buckets, self.max_distance = num_buckets, max_distance
        inner = heads * dim_head
        self.shared_kv = Linear(hidden_size, inner * 2, bias=False)
        self.rel_bias = nn.Embedding(num_buckets, heads)
        self.layer_weight = nn.Parameter(torch.ones(n_layers + 1))
        for li in range(n_layers):
            self.add_module(f"attn_norm_{li}", LayerNorm(hidden_size,
                                                         eps=LN_EPS))
            self.add_module(f"to_q_{li}", Linear(hidden_size, inner,
                                                 bias=False))
            self.add_module(f"attn_drop_{li}", Dropout(attn_dropout, rng))
            self.add_module(f"to_out_{li}", Linear(inner, hidden_size))
            self.add_module(f"ff_norm_{li}", LayerNorm(hidden_size,
                                                       eps=LN_EPS))
            self.add_module(f"ff_{li}", GEGLUFeedForward(
                hidden_size, rng, dropout=ff_dropout))

    def _bias_and_mask(self, n: int, M: int, count: int, n_valid: int,
                       dtype: torch.dtype, device: torch.device
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (1, heads, n, M + n) position bias and the (n, M + n) mask
        of keys a query must not see."""
        q_pos = torch.arange(n, device=device)[:, None]
        k_pos = torch.cat([torch.arange(M, device=device),
                           count + torch.arange(n, device=device)])
        bucket = relative_position_bucket(k_pos[None, :] - q_pos,
                                          self.num_buckets, self.max_distance)
        bias = F.embedding(bucket.long(), self.rel_bias.weight).to(dtype)
        bias = bias.permute(2, 0, 1)[None]
        invalid_mem = (torch.arange(M, device=device) >= count).expand(n, M)
        if n_valid > 1:
            self_invalid = torch.ones(n, n, dtype=torch.bool,
                                      device=device).triu(1)
        else:  # a one-token window has no self keys at all
            self_invalid = torch.ones(n, n, dtype=torch.bool, device=device)
        return bias, torch.cat([invalid_mem, self_invalid], dim=1)

    def forward(self, mem_k: torch.Tensor, mem_v: torch.Tensor, count: int,
                xseg: torch.Tensor, n_valid: int
                ) -> Tuple[torch.Tensor, torch.Tensor, int, torch.Tensor]:
        B, n, d = xseg.shape
        M = mem_k.shape[1]
        h, dh = self.heads, self.dim_head
        inner = h * dh
        scale = dh ** -0.5
        bias, key_invalid = self._bias_and_mask(n, M, count, n_valid,
                                                xseg.dtype, xseg.device)

        def heads_first(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(B, -1, h, dh).transpose(1, 2)

        x = xseg
        hiddens: List[torch.Tensor] = [x]
        for li in range(self.n_layers):
            y = getattr(self, f"attn_norm_{li}")(x)
            q = getattr(self, f"to_q_{li}")(y) * scale
            skv, svv = self.shared_kv(y).chunk(2, dim=-1)
            k = torch.cat([mem_k, skv], dim=1)               # (B, M+n, inner)
            v = torch.cat([mem_v, svv], dim=1)
            sim = torch.matmul(heads_first(q),
                               heads_first(k).transpose(-1, -2)) + bias
            sim = sim.masked_fill(key_invalid, NEG_MAX)
            att = torch.softmax(sim.float(), dim=-1).to(x.dtype)
            att = getattr(self, f"attn_drop_{li}")(att)
            ctx = torch.matmul(att, heads_first(v))
            ctx = ctx.transpose(1, 2).reshape(B, n, inner)
            x = x + getattr(self, f"to_out_{li}")(ctx)
            y = getattr(self, f"ff_norm_{li}")(x)
            x = x + getattr(self, f"ff_{li}")(y)
            hiddens.append(x)

        # layer-weighted aggregate (in fp32, as jnp.einsum promotes it) ->
        # the shared projection -> appended to the memory
        w = torch.softmax(self.layer_weight.float(), dim=0)
        agg = torch.einsum("l,lbnd->bnd", w, torch.stack(hiddens).float())
        new_k, new_v = self.shared_kv(agg.to(x.dtype)).chunk(2, dim=-1)
        shift = max(count + n - M, 0)  # FIFO: the oldest entries leave
        if shift:
            mem_k = torch.roll(mem_k, -shift, dims=1)
            mem_v = torch.roll(mem_v, -shift, dims=1)
        at = count - shift
        mem_k = torch.cat([mem_k[:, :at], new_k, mem_k[:, at + n:]], dim=1)
        mem_v = torch.cat([mem_v[:, :at], new_v, mem_v[:, at + n:]], dim=1)
        return mem_k, mem_v, count - shift + n_valid, x


class FeedbackEncoder(nn.Module):
    """The reference's wiring (mmbert.py:110-127): dim ``hidden_size``,
    depth ``n_layers``, ``seq_len=2``, ``mem_len=256``, 8 heads of 64,
    dropout 0.1 on the attention and in the feed-forward, its masks from
    ``rng`` (a ``DropoutRng`` seeded with 0 where None)."""

    def __init__(self, hidden_size: int, n_layers: int, seq_len: int = 2,
                 mem_len: int = 256, heads: int = 8, dim_head: int = 64,
                 attn_dropout: float = 0.1, ff_dropout: float = 0.1,
                 rng: Optional[DropoutRng] = None):
        super().__init__()
        if mem_len < seq_len:
            raise ValueError("mem_len must be >= seq_len")
        self.seq_len, self.mem_len = seq_len, mem_len
        self.inner = heads * dim_head
        rng = DropoutRng(0) if rng is None else rng
        self.segment = FeedbackSegment(
            hidden_size, n_layers, rng, heads=heads, dim_head=dim_head,
            attn_dropout=attn_dropout, ff_dropout=ff_dropout)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        del mask  # the reference never applies the padding mask
        B, T, _ = x.shape
        L = self.seq_len
        n_seg = -(-T // L)
        T_pad = n_seg * L
        if T_pad != T:
            x = F.pad(x, (0, 0, 0, T_pad - T))
        M = min(self.mem_len, T_pad)
        mem_k = x.new_zeros(B, M, self.inner)
        mem_v = torch.zeros_like(mem_k)
        count, outs = 0, []
        for s in range(n_seg):
            mem_k, mem_v, count, out = self.segment(
                mem_k, mem_v, count, x[:, s * L:(s + 1) * L],
                min(T - s * L, L))
            outs.append(out)
        return torch.cat(outs, dim=1)[:, :T]
