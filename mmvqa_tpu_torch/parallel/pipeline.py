"""GPipe pipeline parallelism for the BERT encoder and the RealFormer
(counterpart of mmvqa_tpu/parallel/pipeline.py).

The layer stack's parameters are stacked along a leading layer axis under
``pp_layers``, the JAX package's tree: ``pp_layers.<leaf>`` holds every
layer's ``<leaf>``, and under a layout each pipe rank (stage) holds its
L / pp rows (``parallel.sharding``). The BERT encoder keeps the two
LayerNorms that every layer shares (``norm1``, and ``norm2`` in the post-norm
mode) outside the stack; the RealFormer's blocks own theirs. One layer is
the sequential encoder's own arithmetic (``models.transformer.bert_layer``,
``models.realformer.ResEncoderBlock``) applied to that layer's rows of the
stack, so K2 runs in each stage's layers as it does in the sequential
encoder, on microbatches.

Without a pipe axis of more than one rank (no mesh, or pp = 1) the forward
applies the layers in order: the sequential encoder's path, the RealFormer's
first layer with no carry.

Under pp > 1 the rank's batch (its data shard) is cut into M microbatches
(``pick_microbatches``: 2 pp if that divides the shard, else pp) and the
GPipe schedule runs M + pp - 1 ticks: at tick t stage s applies its layers
to microbatch t - s, then sends the result to stage s + 1 and receives stage
s - 1's for the next tick (``core.distributed.exchange``, paired and waited
on). The RealFormer's carried scores ride the same hop as the activations,
and the first layer gets an explicit zero score tensor, as the JAX package's
``:465`` does (scores + 0 is the no-add path's value). The last stage's
output reaches every pipe rank by a sum over 'pipe' (the other stages give
zeros), so every rank computes the heads and the loss alike.

The backward is an explicit schedule, not autograd through point-to-point
operations (which would hang rather than fail where two ranks' backward
orders disagreed): each stage keeps, a microbatch, its stage input and
output graphs; the last stage starts from its own gradient of the output
(every pipe rank holds the same loss, counted once), the stages run the
microbatches' backward in reverse order, and each sends its input's
gradient (and the carry's) to the stage before. Stage 0's input gradients
are the encoder input's; the other stages give the input no gradient, so
the embeddings and the trunk run their backward on stage 0 alone. The
stacked layers' gradients stay on their stage; everything else is summed
over 'pipe' by the layout (``parallel.sharding.Layout``).

Dropout under pp is the JAX package's documented deviation: the masks come
from the model's stream, which the layout folds with the data coordinate,
so they differ from the sequential path's and across data shards. Parity
tests run with dropout off.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from mmvqa_tpu_torch.core import distributed
from mmvqa_tpu_torch.core.mesh import PIPE_AXIS
from mmvqa_tpu_torch.models.layers import (
    Dropout,
    DropoutRng,
    LayerNorm,
    Linear,
)
from mmvqa_tpu_torch.models.realformer import ResEncoderBlock
from mmvqa_tpu_torch.models.transformer import (
    MultiHeadedSelfAttention,
    PositionWiseFeedForward,
    bert_layer,
)
from mmvqa_tpu_torch.parallel.comm import axis_info

STACKED_KEY = "pp_layers"


def pick_microbatches(requested: int, batch_local: int, pp: int) -> int:
    """The microbatch count M: ``requested`` where above 0, else the first
    of (2 pp, pp) that divides the data shard's batch (the JAX function,
    with its errors)."""
    if requested > 0:
        if batch_local % requested != 0:
            raise ValueError(
                f"pp_microbatches={requested} does not divide the "
                f"per-data-shard batch {batch_local}"
            )
        return requested
    for m in (2 * pp, pp):
        if batch_local % m == 0 and batch_local >= m:
            return m
    raise ValueError(
        f"per-data-shard batch {batch_local} not divisible into >= pp="
        f"{pp} microbatches; pick batch_size/pp_microbatches accordingly"
    )


def _stack_params(module: nn.Module, layers: List[nn.Module]) -> None:
    """Make every parameter of ``module`` the stack of ``layers``' (each a
    module of ``module``'s structure), along a new leading axis."""
    per = [dict(layer.named_parameters()) for layer in layers]
    for name, _ in list(module.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        stacked = torch.stack([p[name].detach() for p in per])
        setattr(owner, leaf, nn.Parameter(stacked))


def layer_rows(stack: nn.Module, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s parameters: row i of every stacked parameter."""
    return {name: p[i] for name, p in stack.named_parameters()}


class BertLayerStack(nn.Module):
    """One BERT layer's modules (``attention_0``, ``proj_0``,
    ``feedforward_0``, the JAX package's one-layer tree), whose parameters
    carry the leading layer axis."""

    def __init__(self, hidden_size: int, n_heads: int, dropout_rate: float,
                 rng: DropoutRng, impl: str = "auto"):
        super().__init__()
        self.attention_0 = MultiHeadedSelfAttention(
            hidden_size, n_heads, dropout_rate, rng, impl)
        self.proj_0 = Linear(hidden_size, hidden_size)
        self.feedforward_0 = PositionWiseFeedForward(hidden_size)

    def forward(self, h, mask, norm1, norm2, drop, norm_pos):
        return bert_layer(h, mask, self.attention_0, self.proj_0,
                          self.feedforward_0, norm1, norm2, drop, norm_pos)


class _PipelinedEncoder(nn.Module):
    """The schedule both encoders share; a subclass gives ``_layer`` and
    whether a carry rides with the activations (``carry_heads``)."""

    carry_heads = 0  # the carried scores' heads (0: no carry)
    n_microbatches = 0

    @property
    def local_layers(self) -> int:
        return next(self.pp_layers.parameters()).shape[0]

    def _layer(self, i, x, prev, mask):
        raise NotImplementedError

    def stage(self, x, prev, mask):
        """This rank's layers in order; (output, carry)."""
        for i in range(self.local_layers):
            x, prev = self._layer(i, x, prev, mask)
        return x, prev

    def forward(self, h: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        _, pp, _ = axis_info(PIPE_AXIS)
        if pp == 1:
            return self.stage(h, None, mask)[0]
        if self.local_layers * pp != self.n_layers:
            raise ValueError(f"n_layers {self.n_layers} not divisible by "
                             f"pp={pp}")
        if mask is None:
            mask = torch.ones(h.shape[:2], device=h.device)
        if axis_info(PIPE_AXIS)[2] != 0:
            # only stage 0 takes the input: elsewhere the embeddings and the
            # trunk get no gradient, and their backward does not run
            h = h.detach()
        schedule = _Schedule(self, h, mask, pp)
        params = [p for p in self.parameters() if p.requires_grad]
        if not (torch.is_grad_enabled() and params):
            return schedule.forward(h, keep=False)
        if not h.requires_grad:  # the schedule's backward must run
            h = h.detach().requires_grad_()
        return _GPipe.apply(h, schedule)


class _Schedule:
    """One call's GPipe schedule on this stage."""

    def __init__(self, encoder: _PipelinedEncoder, h: torch.Tensor,
                 mask: torch.Tensor, pp: int):
        from mmvqa_tpu_torch.core import mesh

        spec = mesh.CURRENT
        self.encoder = encoder
        self.group, self.pp, self.s = axis_info(PIPE_AXIS)
        ranks = spec.axis_ranks(PIPE_AXIS)
        self.next = ranks[self.s + 1] if self.s + 1 < pp else None
        self.prev = ranks[self.s - 1] if self.s > 0 else None
        B = h.shape[0]
        self.M = pick_microbatches(encoder.n_microbatches, B, pp)
        self.mb = B // self.M
        self.masks = mask.split(self.mb)
        self.shape = (self.mb,) + tuple(h.shape[1:])
        self.dtype, self.device = h.dtype, h.device
        T = h.shape[1]
        self.carry_shape = ((self.mb, encoder.carry_heads, T, T)
                            if encoder.carry_heads else None)
        self.saved: List[Optional[Tuple]] = []

    def _buffers(self) -> List[torch.Tensor]:
        out = [torch.empty(self.shape, dtype=self.dtype, device=self.device)]
        if self.carry_shape is not None:
            out.append(torch.empty(self.carry_shape, dtype=torch.float32,
                                   device=self.device))
        return out

    def forward(self, h: torch.Tensor, keep: bool) -> torch.Tensor:
        """The forward ticks; the output (B, T, H) on every pipe rank. With
        ``keep`` each microbatch's stage input and output stay for the
        backward."""
        M, pp, s = self.M, self.pp, self.s
        xs = h.detach().split(self.mb)
        outs: List[Optional[torch.Tensor]] = [None] * M
        self.saved = [None] * M
        got: List[torch.Tensor] = []
        for t in range(M + pp - 1):
            i = t - s
            sent: List[torch.Tensor] = []
            if 0 <= i < M:
                if s == 0:
                    x = xs[i].detach()
                    carry = (torch.zeros(self.carry_shape,
                                         dtype=torch.float32,
                                         device=self.device)
                             if self.carry_shape is not None else None)
                else:
                    x = got[0]
                    carry = got[1] if self.carry_shape is not None else None
                if keep:
                    x = x.requires_grad_()
                    if carry is not None and s > 0:
                        carry = carry.requires_grad_()
                    with torch.enable_grad():
                        y, new = self.encoder.stage(x, carry, self.masks[i])
                    self.saved[i] = (x, carry, y, new)
                else:
                    y, new = self.encoder.stage(x, carry, self.masks[i])
                if s == pp - 1:
                    outs[i] = y.detach()
                else:
                    sent = [y.detach()] + (
                        [new.detach()] if self.carry_shape is not None
                        else [])
            j = t + 1 - s  # the microbatch stage s - 1 finished at tick t
            got = self._buffers() if s > 0 and 0 <= j < M else []
            distributed.exchange([(x, self.next) for x in sent],
                                 [(b, self.prev) for b in got], self.group)
        out = (torch.cat(outs) if s == pp - 1 else
               torch.zeros((self.M * self.mb,) + self.shape[1:],
                           dtype=self.dtype, device=self.device))
        return distributed.all_reduce(out.contiguous(), self.group)

    def backward(self, g: torch.Tensor) -> Optional[torch.Tensor]:
        """The backward ticks, microbatches in reverse order; the encoder
        input's gradient on stage 0, None elsewhere."""
        M, pp, s = self.M, self.pp, self.s
        gs = g.split(self.mb)
        dxs: List[Optional[torch.Tensor]] = [None] * M
        got: List[torch.Tensor] = []
        for t in range(M + pp - 1):
            j = t - (pp - 1 - s)
            sent: List[torch.Tensor] = []
            if 0 <= j < M:
                i = M - 1 - j
                x, carry, y, new = self.saved[i]
                self.saved[i] = None
                if s == pp - 1:
                    outs, grads = [y], [gs[i]]
                else:
                    outs, grads = [y], [got[0]]
                    if self.carry_shape is not None:
                        outs.append(new)
                        grads.append(got[1])
                torch.autograd.backward(outs, grads)
                if s == 0:
                    dxs[i] = x.grad
                else:
                    sent = [x.grad] + ([carry.grad]
                                       if self.carry_shape is not None
                                       else [])
            k = j + 1  # the microbatch stage s + 1 finished at tick t
            got = (self._buffers() if s < pp - 1 and 0 <= k < M else [])
            distributed.exchange([(x, self.prev) for x in sent],
                                 [(b, self.next) for b in got], self.group)
        return torch.cat(dxs) if s == 0 else None


class _GPipe(torch.autograd.Function):
    """The schedule as one node of the step's graph: its forward runs the
    forward ticks keeping each microbatch's graph, its backward the backward
    ticks (the stage's parameters take their gradients there)."""

    @staticmethod
    def forward(ctx, h, schedule):
        ctx.schedule = schedule
        return schedule.forward(h, keep=True)

    @staticmethod
    def backward(ctx, g):
        return ctx.schedule.backward(g.contiguous()), None


class PipelinedBertEncoder(_PipelinedEncoder):
    """``models.transformer.BertEncoder(share='none')`` with its layers
    stacked (``pp_layers.attention_0...``, ``pp_layers.proj_0``,
    ``pp_layers.feedforward_0...``) and the shared ``norm1`` (and
    ``norm2`` in the post-norm mode) outside the stack."""

    def __init__(self, hidden_size: int, n_layers: int, n_heads: int,
                 dropout_rate: float, norm_pos: str = "pre",
                 n_microbatches: int = 0, rng: Optional[DropoutRng] = None,
                 impl: str = "auto"):
        super().__init__()
        rng = rng or DropoutRng(0)
        self.n_layers = n_layers
        self.norm_pos = norm_pos
        self.n_microbatches = n_microbatches
        self.norm1 = LayerNorm(hidden_size, eps=1e-12)
        if norm_pos == "post":
            self.norm2 = LayerNorm(hidden_size, eps=1e-12)
        self.pp_layers = BertLayerStack(hidden_size, n_heads, dropout_rate,
                                        rng, impl)
        _stack_params(self.pp_layers, [self.pp_layers] * n_layers)
        self.drop = Dropout(dropout_rate, rng)

    def _layer(self, i, x, prev, mask):
        y = functional_call(self.pp_layers, layer_rows(self.pp_layers, i),
                            (x, mask, self.norm1, getattr(self, "norm2", None),
                             self.drop, self.norm_pos))
        return y, None


class PipelinedRealFormerEncoder(_PipelinedEncoder):
    """``models.realformer.RealFormerEncoder`` with its blocks stacked
    (``pp_layers.kqv``, ``proj``, ``ln1``, ``ff1``, ``ff2``, ``ln2``); the
    carried scores (mb, 8, T, T) hop the stages with the activations."""

    def __init__(self, hidden_size: int, n_layers: int, head_cnt: int = 8,
                 dp1: float = 0.1, dp2: float = 0.1, n_microbatches: int = 0,
                 rng: Optional[DropoutRng] = None, impl: str = "auto"):
        super().__init__()
        self.n_layers = n_layers
        self.carry_heads = head_cnt
        self.n_microbatches = n_microbatches
        self.pp_layers = ResEncoderBlock(hidden_size, head_cnt, dp1, dp2,
                                         rng, impl)
        _stack_params(self.pp_layers, [self.pp_layers] * n_layers)

    def _layer(self, i, x, prev, mask):
        return functional_call(self.pp_layers, layer_rows(self.pp_layers, i),
                               (x, prev, mask))


# the stacked <-> sequential state dicts (the JAX converters) ---------------

_BERT_PER_LAYER = ("attention", "proj", "feedforward")


def _layer_index(key: str, prefix: str) -> Optional[Tuple[int, str]]:
    """(i, rest) where ``key`` is ``<prefix><name>_<i>.<rest>`` with one of
    the per-layer names."""
    if not key.startswith(prefix):
        return None
    head, _, rest = key[len(prefix):].partition(".")
    name, _, i = head.rpartition("_")
    if name in _BERT_PER_LAYER + ("block",) and i.isdigit():
        return int(i), (f"{name}_0.{rest}" if name != "block" else rest)
    return None


def stacked_key(key: str, prefix: str = "encoder.") -> str:
    """The stacked layout's name of a sequential state dict's ``key`` (a
    layer's entry -> ``<prefix>pp_layers.<rest>``), other keys as they
    are."""
    hit = _layer_index(key, prefix)
    return key if hit is None else f"{prefix}{STACKED_KEY}.{hit[1]}"


def stack_encoder_state(state: Mapping[str, torch.Tensor],
                        prefix: str = "encoder.") -> Dict[str, torch.Tensor]:
    """A state dict with the sequential encoder under ``prefix``
    (``block_<i>.*`` or ``attention_<i>``/``proj_<i>``/``feedforward_<i>``)
    -> the same with those tensors stacked under ``prefix + 'pp_layers.'``
    (``stack_realformer_params`` / ``stack_bert_encoder_params``); the
    shared norms and every other entry unchanged."""
    rows: Dict[str, Dict[int, torch.Tensor]] = {}
    out = {}
    for k, v in state.items():
        hit = _layer_index(k, prefix)
        if hit is None:
            out[k] = v
        else:
            rows.setdefault(hit[1], {})[hit[0]] = v
    for rest, by_layer in rows.items():
        out[f"{prefix}{STACKED_KEY}.{rest}"] = torch.stack(
            [by_layer[i] for i in range(len(by_layer))])
    return out


def unstack_encoder_state(state: Mapping[str, torch.Tensor],
                          prefix: str = "encoder.") -> Dict[str, torch.Tensor]:
    """The inverse of ``stack_encoder_state``."""
    stacked = f"{prefix}{STACKED_KEY}."
    out = {}
    for k, v in state.items():
        if not k.startswith(stacked):
            out[k] = v
            continue
        rest = k[len(stacked):]
        head, _, leaf = rest.partition(".")
        for i in range(v.shape[0]):
            if head.endswith("_0") and head[:-2] in _BERT_PER_LAYER:
                out[f"{prefix}{head[:-2]}_{i}.{leaf}"] = v[i]
            else:
                out[f"{prefix}block_{i}.{rest}"] = v[i]
    return out


def stack_realformer_params(params: Mapping[str, torch.Tensor],
                            n_layers: int) -> Dict[str, torch.Tensor]:
    """A ``RealFormerEncoder``'s state dict (``block_<i>.*``) -> the stacked
    one (``pp_layers.*``), as the JAX function."""
    out = stack_encoder_state(params, prefix="")
    _check_layers(out, n_layers)
    return out


def unstack_realformer_params(stacked: Mapping[str, torch.Tensor]
                              ) -> Dict[str, torch.Tensor]:
    return unstack_encoder_state(stacked, prefix="")


def stack_bert_encoder_params(params: Mapping[str, torch.Tensor],
                              n_layers: int):
    """A ``BertEncoder(share='none')`` state dict -> (stacked ``pp_layers``
    tensors, norm1's, norm2's or None), as the JAX function returns them."""
    out = stack_encoder_state(params, prefix="")
    _check_layers(out, n_layers)
    pick = lambda p: {k: v for k, v in out.items()  # noqa: E731
                      if k.startswith(p)}
    norm2 = pick("norm2.")
    return pick(f"{STACKED_KEY}."), pick("norm1."), norm2 or None


def unstack_bert_encoder_params(stacked, norm1, norm2
                                ) -> Dict[str, torch.Tensor]:
    return unstack_encoder_state({**stacked, **norm1, **(norm2 or {})},
                                 prefix="")


def _check_layers(stacked: Mapping[str, torch.Tensor], n_layers: int):
    for k, v in stacked.items():
        if k.startswith(f"{STACKED_KEY}.") and v.shape[0] != n_layers:
            raise ValueError(f"{k}: {v.shape[0]} layers, expected {n_layers}")
