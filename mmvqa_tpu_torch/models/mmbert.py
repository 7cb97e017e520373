"""Top-level multimodal model (counterpart of mmvqa_tpu/models/mmbert.py):
visual tokens from the ResNet-152 or the EfficientNetV2 trunk, BERT
embeddings, and the encoder the config names, as ``MMBert.setup`` of the JAX
package selects it: ``transformer`` (the default, the reference's MMBERT) is
the pre-norm ``BertEncoder`` with ``cfg.heads`` heads and dropout
``hidden_dropout_prob``; ``realformer`` the RealFormer with 8 heads;
``feedback-transformer`` the ``FeedbackEncoder`` (8 heads of 64 whatever
``cfg.heads`` says, a memory of 256, dropout 0.1 on its attention and in its
feed-forward). With ``cfg.pp_size`` above 1 the encoder is the pipelined one
(``parallel/pipeline.py``: the layers stacked under ``encoder.pp_layers``),
drawn as the sequential encoder is and then stacked, so a seed gives the
same weights in either layout; ``cfg.attention_impl == 'ring'`` makes the
RealFormer's and the BERT encoder's attention core the ring over a context
group (``ops/ring_attention.py``).

Context parallelism (a mesh with a 'context' axis of cp > 1 ranks): each
rank holds one block of T / cp tokens (``parallel.sharding.place_batch``).
Its embeddings take their global positions, and the visual tokens overwrite
positions 0..num_vis-1, which lie in context rank 0's block (T / cp >=
num_vis, else it raises); on the other ranks the trunk's output reaches no
loss, and the trunk runs there without a graph (as on a pipeline stage
other than 0, whose encoder drops its input). With the ring the encoder
runs on the block; without it the token axis is gathered at the encoder's
entry (its backward a reduce-scatter), the encoder runs at full length as
one process runs it (K2 unchanged) and each rank keeps its block of the
output. ``mean_pooling`` sums its
numerator and its mask over 'context' before it divides, so the pooled
heads see the whole sequence on every rank (``replicated_heads``).

Text tokens are embedded BERT-style; the visual tokens then OVERWRITE
embedded positions 0..num_vis-1, [CLS] included (the reference's fusion
quirk). The fused sequence runs through the encoder, then either the
per-token MLM head (ROCO) or the mean-pooled VQA head:
``classifier(serf(fc1(.)))`` with classifier = Dense, LayerNorm(1e-12),
Dense. ROCO's ``task="distillation"`` returns the encoder's output ``h``
(B, T, H), which ``make_distill_steps`` holds to the teacher's hidden
states; as Flax makes parameters only for the modules a call reaches, that
model has no ``fc1``, ``classifier_*`` or SupCon head. VQA-Med ignores
``task``, as the JAX package does. With ``cfg.supcon`` the MLM model also
has the SupCon projection head
(``head_0`` Dense(H), ``head_2`` Dense(feat_dim), mmbert.py:138-140), and
the ROCO MLM forward returns ``(logits, feat)``: ``feat`` is
``head_2(serf(head_0(mean_pooling(h))))`` L2-normalised in the compute
dtype.

Weights are drawn from an explicit ``torch.Generator`` (on the CPU, so a
seed gives the same model on every device) or carried over from a Flax tree
by ``mmvqa_tpu_torch.bridge``. The model is built on the CUDA card unless
the caller names another device.

Modes. The JAX package's ``deterministic`` and ``train_cnn`` arguments are
module modes here: ``set_mode(deterministic, train_cnn)`` puts the dropouts
in eval or train mode and the trunk's BatchNorms in running-statistics or
batch-statistics mode (``train_cnn`` defaults to ``not deterministic``, as
in the JAX package). A new model is deterministic.

Mixed precision is by explicit casts, not ``torch.autocast``
(``models/layers.py``): parameters, BatchNorm statistics and Adam state stay
in ``dtype`` (fp32), and with ``compute_dtype=torch.bfloat16`` (the
counterpart of ``cfg.mixed_precision``, see ``compute_dtype_of``) the image
and the embedding output are cast to bf16 and every layer computes in its
input's dtype. Dropout rates are the reference's 0.1 unless
``cfg.dropout_override`` pins them all; the masks come from the model's
``dropout_rng``, seeded with ``cfg.seed``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from mmvqa_tpu_torch.core.config import Config
from mmvqa_tpu_torch.core.mesh import CONTEXT_AXIS, PIPE_AXIS
from mmvqa_tpu_torch.models.effnetv2 import BatchNorm2d
from mmvqa_tpu_torch.models.embeddings import BertEmbeddings
from mmvqa_tpu_torch.models.feedback import FeedbackEncoder, FeedbackSegment
from mmvqa_tpu_torch.models.layers import DropoutRng, LayerNorm, Linear
from mmvqa_tpu_torch.models.realformer import RealFormerEncoder
from mmvqa_tpu_torch.models.transformer import BertEncoder
from mmvqa_tpu_torch.models.visual_tokens import TokenHead, VisualTokenizer
from mmvqa_tpu_torch.ops.activations import serf
from mmvqa_tpu_torch.parallel.comm import (
    axis_info,
    gather_over,
    gather_weight,
    keep_block,
    reduce_from,
    sum_over,
)

# the modules that compute on the encoder's output (or its pooled mean)
HEADS = ("fc1", "classifier_0", "classifier_ln", "classifier_2", "head_0",
         "head_2")


def mean_pooling(h: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the sequence axis (under context parallelism over
    the whole sequence: the numerator and the mask are summed over
    'context', the numerator's gradient reaching each rank's block)."""
    m = attention_mask[..., None].to(h.dtype)
    num, den = (h * m).sum(dim=1), m.sum(dim=1)
    if axis_info(CONTEXT_AXIS)[1] > 1:
        num = reduce_from(num, CONTEXT_AXIS)
        den = sum_over(den, CONTEXT_AXIS)
    return num / torch.clamp(den, min=1e-9)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Fan-in-scaled normal weights (the scale of Flax's lecun_normal), zero
    biases, N(0, 0.02) embeddings, identity norms."""

    def normal(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            normal(mod.weight, mod.weight[0].numel() ** -0.5)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, TokenHead):
            normal(mod.weight, mod.weight.shape[0] ** -0.5)
        elif isinstance(mod, nn.Embedding):
            normal(mod.weight, 0.02)
        elif isinstance(mod, BertEmbeddings):
            normal(mod.position_embeddings, 0.02)
        elif isinstance(mod, (nn.LayerNorm, BatchNorm2d)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for mod in model.modules():
        if isinstance(mod, FeedbackSegment):  # Flax's N(0, 1) and ones
            normal(mod.rel_bias.weight, 1.0)
            mod.layer_weight.fill_(1.0)


def compute_dtype_of(cfg: Config) -> torch.dtype:
    """bf16 compute under ``cfg.mixed_precision``, else fp32 (the choice of
    mmvqa_tpu/cli/common.py:262)."""
    return torch.bfloat16 if cfg.mixed_precision else torch.float32


def default_device() -> torch.device:
    """The CUDA card; raises where there is none. The port's entry points
    run there unless the caller asks for another device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mmvqa_tpu_torch runs on a CUDA device and found none; pass "
            "device='cpu' to run the plain paths on the host"
        )
    return torch.device("cuda", torch.cuda.current_device())


class MMBert(nn.Module):
    def __init__(self, cfg: Config, *,
                 device: Union[str, torch.device, None] = None,
                 dtype: torch.dtype = torch.float32,
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not any(k in cfg.transformer_model
                   for k in ("realformer", "transformer")):
            raise NotImplementedError(cfg.transformer_model)
        if cfg.dataset == "roco" and cfg.task not in ("MLM", "distillation"):
            raise NotImplementedError(cfg.task)
        if cfg.dataset not in ("roco", "VQA-Med"):
            raise NotImplementedError(cfg.dataset)
        if cfg.pp_size > 1:
            cfg.validate()  # the pipeline's compositions, with their messages
        device = default_device() if device is None else torch.device(device)
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.dropout_rng = DropoutRng(cfg.seed)

        def dp(rate: float) -> float:
            return (rate if cfg.dropout_override is None
                    else cfg.dropout_override)

        H = cfg.hidden_size
        self.bert_embedding = BertEmbeddings(
            vocab_size=cfg.vocab_size, hidden_size=H,
            type_vocab_size=cfg.type_vocab_size, dropout_rate=dp(0.1),
            rng=self.dropout_rng,
        )
        self.trans = VisualTokenizer(
            cnn_encoder=cfg.cnn_encoder, num_vis=cfg.num_vis, hidden_size=H,
            use_relu=cfg.use_relu, tiny=cfg.tiny_cnn,
        )
        feedback = "feedback-transformer" in cfg.transformer_model
        # the ring replaces the attention core; the feedback encoder has none
        self.ring = cfg.attention_impl == "ring" and not feedback
        impl = cfg.attention_impl
        if feedback:
            self.encoder = FeedbackEncoder(
                H, cfg.n_layers, attn_dropout=dp(0.1), ff_dropout=dp(0.1),
                rng=self.dropout_rng)
        elif "realformer" in cfg.transformer_model:
            self.encoder = RealFormerEncoder(
                H, cfg.n_layers, head_cnt=cfg.head_count, dp1=dp(0.1),
                dp2=dp(0.1), rng=self.dropout_rng, impl=impl)
        else:
            self.encoder = BertEncoder(
                H, cfg.n_layers, cfg.heads, dp(cfg.hidden_dropout_prob),
                share="none", norm_pos="pre", rng=self.dropout_rng,
                impl=impl)
        # Flax makes a module's parameters where a call reaches it: the
        # distillation model returns h and has no heads
        self.distill = cfg.dataset == "roco" and cfg.task == "distillation"
        if not self.distill:
            self.fc1 = Linear(H, H)
            self.classifier_0 = Linear(H, H)
            self.classifier_ln = LayerNorm(H, eps=1e-12)
            out_dim = (cfg.num_classes
                       if cfg.dataset == "VQA-Med" and cfg.num_classes > 0
                       else cfg.vocab_size)
            self.classifier_2 = Linear(H, out_dim)
        if cfg.supcon and cfg.dataset == "roco" and not self.distill:
            self.head_0 = Linear(H, H)
            self.head_2 = Linear(H, cfg.feat_dim)
        # tensor parallelism: the column-parallel heads gather their output
        for name in ("fc1", "classifier_2", "head_2"):
            if hasattr(self, name):
                getattr(self, name).tp_capable = True
                getattr(self, name).gather_output = True
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        init_weights(self, generator)
        if cfg.pp_size > 1:
            self._pipeline(cfg, dp(0.1), dp(cfg.hidden_dropout_prob), impl)
        self.to(device=device, dtype=dtype)
        self.eval()

    def _pipeline(self, cfg: Config, rf_rate: float, bert_rate: float,
                  impl: str) -> None:
        """The sequential encoder as drawn, stacked into the pipelined
        one."""
        from mmvqa_tpu_torch.parallel import pipeline

        drawn = self.encoder.state_dict()
        if "realformer" in cfg.transformer_model:
            self.encoder = pipeline.PipelinedRealFormerEncoder(
                cfg.hidden_size, cfg.n_layers, head_cnt=cfg.head_count,
                dp1=rf_rate, dp2=rf_rate, n_microbatches=cfg.pp_microbatches,
                rng=self.dropout_rng, impl=impl)
        else:
            self.encoder = pipeline.PipelinedBertEncoder(
                cfg.hidden_size, cfg.n_layers, cfg.heads, bert_rate,
                norm_pos="pre", n_microbatches=cfg.pp_microbatches,
                rng=self.dropout_rng, impl=impl)
        self.encoder.load_state_dict(
            pipeline.stack_encoder_state(drawn, prefix=""), strict=True)

    def fsdp_groups(self):
        """Under FSDP the units of the embeddings, the trunk and the
        encoder, then the classifier's modules together, then the SupCon
        head's (``parallel.sharding.fsdp_units``; each in call order)."""
        return [["bert_embedding"], ["trans"], ["encoder"],
                ["fc1", "classifier_0", "classifier_ln", "classifier_2"],
                ["head_0", "head_2"]]

    def replicated_heads(self, axis: str) -> tuple:
        """The modules whose gradient every rank of ``axis`` computes whole,
        from values the axis replicates (the others' gradients are each
        rank's part of the sum): under 'pipe' every head, which each stage
        computes on the broadcast encoder output; under 'context' the heads
        on the pooled mean (the VQA heads, the SupCon head)."""
        have = tuple(n for n in HEADS if hasattr(self, n))
        if axis == PIPE_AXIS:
            return have
        if axis == CONTEXT_AXIS:
            pooled = (("fc1", "classifier_") if self.cfg.dataset == "VQA-Med"
                      else ("head_",))
            return tuple(n for n in have if n.startswith(pooled))
        return ()

    @property
    def dtype(self) -> torch.dtype:
        """The dtype activations are computed in."""
        return (self.compute_dtype
                or self.bert_embedding.word_embeddings.weight.dtype)

    def set_mode(self, deterministic: bool,
                 train_cnn: Optional[bool] = None) -> "MMBert":
        self.train(not deterministic)
        self.trans.trunk.train(
            (not deterministic) if train_cnn is None else train_cnn)
        return self

    @property
    def device(self) -> torch.device:
        return self.bert_embedding.word_embeddings.weight.device

    def _classifier(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier_2(self.classifier_ln(self.classifier_0(x)))

    def encode(self, img: torch.Tensor, input_ids: torch.Tensor,
               segment_ids: torch.Tensor, input_mask: torch.Tensor,
               perturb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The encoder's output (B, T, H); ``perturb`` (B, h, w, C) is added
        to the deepest tapped map (``VisualTokenizer.features``). On a pipe
        rank or a context rank other than 0 the trunk's output reaches no
        loss: its forward runs there without a graph, for the BatchNorm
        statistics and their sums over 'data' alone."""
        reaches = axis_info(CONTEXT_AXIS)[2] == 0 == axis_info(PIPE_AXIS)[2]
        with torch.set_grad_enabled(torch.is_grad_enabled() and reaches):
            tokens, _ = self.trans.features(img.to(self.dtype), perturb)
        return self.encode_tokens(tokens, input_ids, segment_ids, input_mask)

    def encode_tokens(self, tokens, input_ids: torch.Tensor,
                      segment_ids: torch.Tensor,
                      input_mask: torch.Tensor) -> torch.Tensor:
        """The encoder over the visual ``tokens`` (one (B, H) tensor a tap)
        written over the embedded text's first positions (under context
        parallelism the rank's token block; see the module docstring)."""
        _, cp, c = axis_info(CONTEXT_AXIS)
        t = input_ids.shape[-1]
        h = self.bert_embedding(input_ids, segment_ids, c * t).to(self.dtype)
        vis = torch.stack([v.to(h.dtype) for v in tokens], dim=1)
        if t < vis.shape[1]:
            raise ValueError(
                f"context parallelism: a rank's block of {t} tokens is "
                f"shorter than the {vis.shape[1]} visual tokens; lower "
                "--cp_size")
        if c == 0:
            h = torch.cat([vis, h[:, vis.shape[1]:]], dim=1)
        if cp > 1 and not self.ring:
            # each rank's gradient of the whole sequence is its own part:
            # the gather's backward sums them and keeps this rank's block
            full = self.encoder(gather_weight(h, CONTEXT_AXIS, 1),
                                gather_over(input_mask, CONTEXT_AXIS, 1))
            return keep_block(full, CONTEXT_AXIS, 1)
        return self.encoder(h, input_mask)

    def vqa_head(self, h: torch.Tensor, input_mask: torch.Tensor
                 ) -> torch.Tensor:
        """VQA logits ``classifier(serf(fc1(mean_pooling(h))))``."""
        return self._classifier(serf(self.fc1(mean_pooling(h, input_mask))))

    def features_and_logits(self, img: torch.Tensor, input_ids: torch.Tensor,
                            segment_ids: torch.Tensor,
                            input_mask: torch.Tensor,
                            perturb: Optional[torch.Tensor] = None):
        """(VQA logits, the tapped maps as NHWC views in token order), with
        ``perturb`` added to the deepest map: the gradient of a logit with
        respect to it is the gradient with respect to that map, the
        reference's backward hooks (grad_cam2.py:139-152) without hooks.
        Puts the model in its deterministic mode (dropout off, BatchNorm on
        running statistics), where the JAX method always runs."""
        self.set_mode(True)
        tokens, feats = self.trans.features(img.to(self.dtype), perturb)
        h = self.encode_tokens(tokens, input_ids, segment_ids, input_mask)
        return self.vqa_head(h, input_mask), feats

    def forward(self, img: torch.Tensor, input_ids: torch.Tensor,
                segment_ids: torch.Tensor,
                input_mask: torch.Tensor) -> torch.Tensor:
        """img (B, S, S, 3) normalized NHWC; ids, segments, mask (B, T).
        Returns VQA logits (B, num_classes), MLM logits (B, T, vocab), the
        latter with the SupCon feature (B, feat_dim) as ``(logits, feat)``
        under ``cfg.supcon``, or for distillation the encoder's output
        (B, T, H)."""
        h = self.encode(img, input_ids, segment_ids, input_mask)
        if self.distill:
            return h
        if self.cfg.dataset == "roco":
            logits = self._classifier(serf(self.fc1(h)))
            if self.cfg.supcon:
                pooled = mean_pooling(h, input_mask)
                feat = self.head_2(serf(self.head_0(pooled)))
                feat = feat / torch.linalg.vector_norm(feat, dim=-1,
                                                       keepdim=True)
                return logits, feat
            return logits
        return self.vqa_head(h, input_mask)
