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

Tensor parallelism (the JAX rule's split, ``parallel/sharding.py``): a rank
attends over its heads and runs its block of the feed-forward's mult d
features. ``to_q_<i>`` is column-parallel and ``to_out_<i>`` row-parallel
over the heads, ``w_out`` row-parallel over the features. ``shared_kv``
and ``w_in`` are split by the rule in contiguous blocks of their output
columns, which at tp = 2 hold all of k (all of ``val``) on one rank and all
of v (all of ``gate``) on the other: the encoder gathers both weights over
'model' once a forward (``comm.gather_weight``, whose backward
reduce-scatters) and keeps this rank's heads of k and of v and this rank's
features of ``val`` and of ``gate`` (``FeedbackSegment.prepared``). The
memory holds this rank's heads (B, M, inner / tp); ``rel_bias``, the
LayerNorms, ``layer_weight`` and the aggregate are replicated, the replicated
inputs of the split products entering through ``comm.copy_to``. Dropout
masks are drawn at the local shapes from the model's stream, which the
'model' ranks share.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mmvqa_tpu_torch.core.mesh import MODEL_AXIS
from mmvqa_tpu_torch.models.layers import Dropout, DropoutRng, LayerNorm, Linear
from mmvqa_tpu_torch.ops.activations import gelu_erf
from mmvqa_tpu_torch.parallel.comm import axis_info, copy_to, gather_weight

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


def _halves_block(t: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Block ``i`` of ``n`` of each half of ``t``'s rows, the two side by
    side (this rank's k and v heads, or its ``val`` and ``gate``
    features)."""
    half = t.shape[0] // 2
    c = half // n
    return torch.cat([t[i * c:(i + 1) * c], t[half + i * c:half + (i + 1) * c]])


def _gathered_halves(lin: Linear) -> Tuple[torch.Tensor,
                                           Optional[torch.Tensor]]:
    """A column-split Linear's weight (and its replicated bias) cut to this
    rank's blocks of both halves of its output (see the module docstring);
    the weight and bias themselves without a split."""
    if lin.tp_mode is None:
        return lin.weight, lin.bias
    _, tp, m = axis_info(MODEL_AXIS)
    w = _halves_block(gather_weight(lin.weight, MODEL_AXIS, 0), m, tp)
    b = (None if lin.bias is None
         else _halves_block(copy_to(lin.bias, MODEL_AXIS), m, tp))
    return w, b


def _linear(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


class GEGLUFeedForward(nn.Module):
    """``w_in`` (d -> 2 mult d), ``gelu(gate) * val`` where ``val, gate``
    are the two halves in that order, dropout, ``w_out`` (mult d -> d).
    ``forward`` takes ``w_in``'s weight and bias as ``prepared`` gives them
    (this rank's features of both halves under tensor parallelism)."""

    def __init__(self, dim: int, rng: DropoutRng, mult: int = 4,
                 dropout: float = 0.0):
        super().__init__()
        self.w_in = Linear(dim, dim * mult * 2)
        self.drop = Dropout(dropout, rng)
        self.w_out = Linear(dim * mult, dim)
        self.w_in.tp_capable = self.w_out.tp_capable = True

    def prepare_tp(self, tp: int) -> None:
        split = (self.w_in.tp_mode is not None, self.w_out.tp_mode is not None)
        if split[0] != split[1]:
            raise ValueError("tensor parallelism: the feed-forward's w_in and "
                             "w_out must split together")
        if split[0] and self.w_out.in_features % tp:
            raise ValueError(f"tensor parallelism: the feed-forward's "
                             f"{self.w_out.in_features} features do not "
                             f"split over tp_size {tp}")

    def prepared(self):
        return _gathered_halves(self.w_in)

    def forward(self, x: torch.Tensor, prepared=None) -> torch.Tensor:
        w, b = self.prepared() if prepared is None else prepared
        if self.w_in.tp_mode is not None:
            x = copy_to(x, MODEL_AXIS)
        val, gate = _linear(x, w, b).chunk(2, dim=-1)
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
        self.shared_kv.tp_capable = True
        for li in range(n_layers):
            for name in ("to_q", "to_out"):
                getattr(self, f"{name}_{li}").tp_capable = True
        self.tp = 1  # the 'model' ranks the heads are split over

    def prepare_tp(self, tp: int) -> None:
        split = {self.shared_kv.tp_mode is not None} | {
            getattr(self, f"{name}_{li}").tp_mode is not None
            for li in range(self.n_layers) for name in ("to_q", "to_out")}
        if len(split) > 1:
            raise ValueError("tensor parallelism: the feedback attention's "
                             "to_q, shared_kv and to_out must split together")
        if split == {True}:
            if self.heads % tp:
                raise ValueError(f"tensor parallelism: {self.heads} heads do "
                                 f"not split over tp_size {tp}")
            self.tp = tp

    @property
    def local_inner(self) -> int:
        """The memory's width on this rank: its heads' keys (values)."""
        return self.heads // self.tp * self.dim_head

    def prepared(self):
        """The weights each window uses, once a forward: ``shared_kv``'s
        and each ``w_in``'s (with its bias) at this rank's blocks of both
        halves, and ``rel_bias``'s columns of this rank's heads."""
        bias = self.rel_bias.weight
        if self.tp > 1:
            _, tp, m = axis_info(MODEL_AXIS)
            h = self.heads // tp
            bias = copy_to(bias, MODEL_AXIS)[:, m * h:(m + 1) * h]
        return {"kv": _gathered_halves(self.shared_kv)[0], "bias": bias,
                "ff": [getattr(self, f"ff_{li}").prepared()
                       for li in range(self.n_layers)]}

    def _bias_and_mask(self, n: int, M: int, count: int, n_valid: int,
                       dtype: torch.dtype, device: torch.device,
                       weight: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (1, heads, n, M + n) position bias (this rank's heads of it,
        from ``weight``) and the (n, M + n) mask of keys a query must not
        see."""
        q_pos = torch.arange(n, device=device)[:, None]
        k_pos = torch.cat([torch.arange(M, device=device),
                           count + torch.arange(n, device=device)])
        bucket = relative_position_bucket(k_pos[None, :] - q_pos,
                                          self.num_buckets, self.max_distance)
        bias = F.embedding(bucket.long(), weight).to(dtype)
        bias = bias.permute(2, 0, 1)[None]
        invalid_mem = (torch.arange(M, device=device) >= count).expand(n, M)
        if n_valid > 1:
            self_invalid = torch.ones(n, n, dtype=torch.bool,
                                      device=device).triu(1)
        else:  # a one-token window has no self keys at all
            self_invalid = torch.ones(n, n, dtype=torch.bool, device=device)
        return bias, torch.cat([invalid_mem, self_invalid], dim=1)

    def forward(self, mem_k: torch.Tensor, mem_v: torch.Tensor, count: int,
                xseg: torch.Tensor, n_valid: int, prepared=None
                ) -> Tuple[torch.Tensor, torch.Tensor, int, torch.Tensor]:
        """One window; ``prepared`` is ``self.prepared()``, which the
        encoder takes once for all its windows."""
        w = self.prepared() if prepared is None else prepared
        B, n, d = xseg.shape
        M = mem_k.shape[1]
        h, dh = self.heads // self.tp, self.dim_head
        inner = h * dh
        scale = dh ** -0.5
        bias, key_invalid = self._bias_and_mask(n, M, count, n_valid,
                                                xseg.dtype, xseg.device,
                                                w["bias"])

        def heads_first(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(B, -1, h, dh).transpose(1, 2)

        def kv_of(y: torch.Tensor):
            return _linear(y, w["kv"]).chunk(2, dim=-1)

        x = xseg
        hiddens: List[torch.Tensor] = [x]
        for li in range(self.n_layers):
            y = getattr(self, f"attn_norm_{li}")(x)
            if self.tp > 1:  # its gradient: every rank's heads' part
                y = copy_to(y, MODEL_AXIS)
            q = _linear(y, getattr(self, f"to_q_{li}").weight) * scale
            skv, svv = kv_of(y)
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
            x = x + getattr(self, f"ff_{li}")(y, w["ff"][li])
            hiddens.append(x)

        # layer-weighted aggregate (in fp32, as jnp.einsum promotes it) ->
        # the shared projection -> appended to the memory
        lw = torch.softmax(self.layer_weight.float(), dim=0)
        agg = torch.einsum("l,lbnd->bnd", lw,
                           torch.stack(hiddens).float()).to(x.dtype)
        if self.tp > 1:
            agg = copy_to(agg, MODEL_AXIS)
        new_k, new_v = kv_of(agg)
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
        mem_k = x.new_zeros(B, M, self.segment.local_inner)
        mem_v = torch.zeros_like(mem_k)
        count, outs = 0, []
        prepared = self.segment.prepared()  # once for every window
        for s in range(n_seg):
            mem_k, mem_v, count, out = self.segment(
                mem_k, mem_v, count, x[:, s * L:(s + 1) * L],
                min(T - s * L, L), prepared)
            outs.append(out)
        return torch.cat(outs, dim=1)[:, :T]
