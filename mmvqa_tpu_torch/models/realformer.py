"""RealFormer: residual-attention encoder (counterpart of
mmvqa_tpu/models/realformer.py).

Each block hands its fp32 score carry, head-major (B, H, T, T), to the next.
Quirks kept from the reference:

* the k/q/v projection is ONE bias-free Linear(emb_s, 3 * emb_s) applied to
  every head with shared weights, split in (k, q, v) order;
* the output projection is bias-free; dropout dp1 follows it, dropout dp2
  follows the FFN, and the attention probabilities get none;
* post-norm with LayerNorm eps 1e-5: ``x = ln1(x + mha); x = ln2(x + ff)``;
* the FFN is ``ff1 -> serf -> ff2``;
* the padding mask hits the QUERY axis of the scores (ops/attention.py).

Under tensor parallelism a block runs K2 on its rank's H/tp heads and
carries their (B, H/tp, T, T) scores; the output projection and the FFN are
Megatron's row and column splits (``models/layers.py::Linear``). With
``impl='ring'`` and a context group of more than one rank the block's core
is the ring over the rank's query block (``ops/ring_attention.py``), which
carries that block's rows of the scores, (B, H, T/cp, T); K2 does not run
there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mmvqa_tpu_torch.models.layers import (
    Dropout,
    DropoutRng,
    LayerNorm,
    Linear,
)
from mmvqa_tpu_torch.core.mesh import MODEL_AXIS
from mmvqa_tpu_torch.ops.activations import serf
from mmvqa_tpu_torch.parallel.comm import scatter_to
from mmvqa_tpu_torch.ops.attention import (
    realformer_attention_packed,
    ring_size,
)


class ResEncoderBlock(nn.Module):
    def __init__(self, hidden_size: int, head_cnt: int = 8, dp1: float = 0.1,
                 dp2: float = 0.1, rng: Optional[DropoutRng] = None,
                 impl: str = "auto"):
        super().__init__()
        rng = rng or DropoutRng(0)
        self.impl = impl
        self.head_cnt = head_cnt
        self.emb_s = hidden_size // head_cnt
        self.kqv = Linear(self.emb_s, 3 * self.emb_s, bias=False)
        self.proj = Linear(hidden_size, hidden_size, bias=False)
        self.drop1 = Dropout(dp1, rng)
        self.ln1 = LayerNorm(hidden_size, eps=1e-5)
        self.ff1 = Linear(hidden_size, 4 * hidden_size)
        self.ff2 = Linear(4 * hidden_size, hidden_size)
        self.drop2 = Dropout(dp2, rng)
        self.ln2 = LayerNorm(hidden_size, eps=1e-5)
        # tensor parallelism: this rank's heads (the shared k/q/v weight,
        # column-split by the rule, is gathered for use), proj row-parallel,
        # ff1 -> ff2 a column/row pair
        for lin in (self.kqv, self.proj, self.ff1, self.ff2):
            lin.tp_capable = True
        self.kqv.gather_weight = True
        self.heads_split = 1

    def prepare_tp(self, tp: int) -> None:
        if self.proj.tp_mode is None:
            return
        if self.head_cnt % tp:
            raise ValueError(f"tensor parallelism: {self.head_cnt} heads do "
                             f"not split over tp_size {tp}")
        self.heads_split = tp

    def forward(self, x: torch.Tensor, prev: Optional[torch.Tensor],
                mask: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, T, emb = x.shape
        heads = x.reshape(B, T, self.head_cnt, self.emb_s)
        if self.heads_split > 1:  # K2 runs on this rank's heads
            heads = scatter_to(heads, MODEL_AXIS, 2)
        # (k, q, v) side by side; the kernels read the slices by strides
        kqv = self.kqv(heads)
        if self.impl == "ring" and ring_size() > 1:
            from mmvqa_tpu_torch.ops.ring_attention import (
                ring_realformer_attention,
            )

            k, q, v = kqv.split(self.emb_s, dim=-1)
            ctx, new_prev = ring_realformer_attention(q, k, v, prev, mask)
        else:
            ctx, new_prev = realformer_attention_packed(kqv, prev, mask)
        x = self.ln1(x + self.drop1(self.proj(ctx.reshape(B, T, -1))))
        x = self.ln2(x + self.drop2(self.ff2(serf(self.ff1(x)))))
        return x, new_prev


class RealFormerEncoder(nn.Module):
    """Stack of ResEncoderBlocks threading (h, prev). 8 heads regardless of
    the --heads flag (Config.head_count)."""

    fsdp_split = True  # under FSDP each block gathers its leaves

    def __init__(self, hidden_size: int, n_layers: int, head_cnt: int = 8,
                 dp1: float = 0.1, dp2: float = 0.1,
                 rng: Optional[DropoutRng] = None, impl: str = "auto"):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"block_{i}", ResEncoderBlock(
                hidden_size, head_cnt, dp1, dp2, rng, impl))

    def forward(self, h: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        prev = None
        for i in range(self.n_layers):
            h, prev = getattr(self, f"block_{i}")(h, prev, mask)
        return h
