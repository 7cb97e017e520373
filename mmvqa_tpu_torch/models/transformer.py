"""Pre/post-norm BERT encoder with weight-sharing modes (counterpart of
mmvqa_tpu/models/transformer.py): the encoder of the reference's default
model, ``--transformer_model transformer``.

Quirks kept from the reference, whose ``BertLayer`` is built once and indexed
per layer:

* with ``share='none'`` the attention, projection and FFN stacks are per
  layer, but the two LayerNorms (eps 1e-12) are single modules shared by
  EVERY layer;
* the pre-norm path applies ``norm1`` before BOTH the attention and the FFN;
  ``norm2`` is never called there, so, as Flax makes no parameters for a
  module it never calls, the pre-norm encoder has no ``norm2``;
* the q, k and v projections carry biases; the FFN is ``fc2(gelu(fc1(x)))``
  with the exact erf GELU and a 4x expansion;
* one dropout module serves both residual branches, and the attention
  probabilities get their own.

Module names follow the Flax tree (``attention_<i>/proj_{q,k,v}``,
``proj_<i>``, ``feedforward_<i>/fc{1,2}``, or ``attention``, ``proj``,
``feedforward`` where ``share`` shares them), so ``bridge.py`` maps one onto
the other. Dropout draws from the model's ``DropoutRng``. Under tensor
parallelism the q, k, v projections and ``fc1`` are column-parallel (a rank
attends over its heads), ``proj_<i>`` and ``fc2`` row-parallel. With
``impl='ring'`` and a context group of more than one rank, the attention
core is the ring over the rank's token block (``ops/ring_attention.py``).
``bert_layer`` is one layer's arithmetic, which the pipelined encoder
(``parallel/pipeline.py``) applies to its stacked layers.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmvqa_tpu_torch.models.layers import Dropout, DropoutRng, LayerNorm, Linear
from mmvqa_tpu_torch.ops.activations import gelu_erf
from mmvqa_tpu_torch.ops.attention import vanilla_attention

SHARE_MODES = ("none", "all", "att", "ffn")
NORM_POSITIONS = ("pre", "post")


class MultiHeadedSelfAttention(nn.Module):
    """q, k, v projections with biases, then ``vanilla_attention`` over
    ``n_heads`` heads with dropout on the probabilities."""

    def __init__(self, hidden_size: int, n_heads: int, dropout_rate: float,
                 rng: DropoutRng, impl: str = "auto"):
        super().__init__()
        self.impl = impl
        self.n_heads = n_heads
        self.head_dim = hidden_size // n_heads
        self.proj_q = Linear(hidden_size, hidden_size)
        self.proj_k = Linear(hidden_size, hidden_size)
        self.proj_v = Linear(hidden_size, hidden_size)
        for lin in (self.proj_q, self.proj_k, self.proj_v):
            lin.tp_capable = True  # column-parallel: this rank's heads
        self.drop = Dropout(dropout_rate, rng)

    def prepare_tp(self, tp: int) -> None:
        if self.proj_q.tp_mode is not None and self.n_heads % tp:
            raise ValueError(f"tensor parallelism: {self.n_heads} heads do "
                             f"not split over tp_size {tp}")

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        B, T, _ = x.shape

        def split(t):  # (B, T, h * D) -> (B, h, T, D), h this rank's heads
            return t.view(B, T, -1, self.head_dim).transpose(1, 2)

        ctx = vanilla_attention(split(self.proj_q(x)), split(self.proj_k(x)),
                                split(self.proj_v(x)), mask,
                                dropout=self.drop, impl=self.impl)
        return ctx.transpose(1, 2).reshape(B, T, -1)


class PositionWiseFeedForward(nn.Module):
    def __init__(self, hidden_size: int):
        super().__init__()
        self.fc1 = Linear(hidden_size, 4 * hidden_size)
        self.fc2 = Linear(4 * hidden_size, hidden_size)
        self.fc1.tp_capable = self.fc2.tp_capable = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_erf(self.fc1(x)))


def bert_layer(h: torch.Tensor, mask: Optional[torch.Tensor], att, proj, ffn,
               norm1, norm2, drop, norm_pos: str) -> torch.Tensor:
    """One layer: attention -> proj -> residual, FFN -> residual, with the
    reference's norm placement (the pre-norm path applies ``norm1`` twice
    and never ``norm2``)."""
    if norm_pos == "pre":
        h = h + drop(proj(att(norm1(h), mask)))
        return h + drop(ffn(norm1(h)))  # norm1 again: quirk
    out = norm1(h + drop(proj(att(h, mask))))
    return norm2(out + drop(ffn(out)))


class BertEncoder(nn.Module):
    """``n_layers`` of (attention -> proj -> residual, FFN -> residual) with
    the reference's share modes and norm placement."""

    fsdp_split = True

    def fsdp_groups(self):
        """Under FSDP each layer's attention, projection and feed-forward
        gather their leaves together (a shared module once)."""
        groups = [list(dict.fromkeys(g))
                  for g in zip(self._att, self._proj, self._ffn)]
        return [g for i, g in enumerate(groups) if g not in groups[:i]]

    def __init__(self, hidden_size: int, n_layers: int, n_heads: int,
                 dropout_rate: float, share: str = "none",
                 norm_pos: str = "pre", rng: Optional[DropoutRng] = None,
                 impl: str = "auto"):
        super().__init__()
        if share not in SHARE_MODES:
            raise ValueError(f"unknown share {share!r}")
        if norm_pos not in NORM_POSITIONS:
            raise ValueError(f"unknown norm_pos {norm_pos!r}")
        rng = rng or DropoutRng(0)
        self.n_layers = n_layers
        self.norm_pos = norm_pos
        self.norm1 = LayerNorm(hidden_size, eps=1e-12)
        if norm_pos == "post":
            self.norm2 = LayerNorm(hidden_size, eps=1e-12)
        share_att = share in ("all", "att")
        share_ffn = share in ("all", "ffn")
        self._att = ["attention" if share_att else f"attention_{i}"
                     for i in range(n_layers)]
        self._proj = ["proj" if share_att else f"proj_{i}"
                      for i in range(n_layers)]
        self._ffn = ["feedforward" if share_ffn else f"feedforward_{i}"
                     for i in range(n_layers)]
        for name in dict.fromkeys(self._att):
            self.add_module(name, MultiHeadedSelfAttention(
                hidden_size, n_heads, dropout_rate, rng, impl))
        for name in dict.fromkeys(self._proj):
            self.add_module(name, Linear(hidden_size, hidden_size))
            getattr(self, name).tp_capable = True  # row-parallel
        for name in dict.fromkeys(self._ffn):
            self.add_module(name, PositionWiseFeedForward(hidden_size))
        self.drop = Dropout(dropout_rate, rng)

    def forward(self, h: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        for i in range(self.n_layers):
            h = bert_layer(h, mask, getattr(self, self._att[i]),
                           getattr(self, self._proj[i]),
                           getattr(self, self._ffn[i]), self.norm1,
                           getattr(self, "norm2", None), self.drop,
                           self.norm_pos)
        return h
