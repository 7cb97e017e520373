"""Top-level multimodal model (counterpart of mmvqa_tpu/models/mmbert.py):
visual tokens from the ResNet-152 or the EfficientNetV2 trunk, BERT
embeddings, and the encoder the config names, as ``MMBert.setup`` of the JAX
package selects it: ``transformer`` (the default, the reference's MMBERT) is
the pre-norm ``BertEncoder`` with ``cfg.heads`` heads and dropout
``hidden_dropout_prob``; ``realformer`` the RealFormer with 8 heads;
``feedback-transformer`` the ``FeedbackEncoder`` (8 heads of 64 whatever
``cfg.heads`` says, a memory of 256, dropout 0.1 on its attention and in its
feed-forward). The pipeline-parallel encoders (ROADMAP.md Queue 1, item 10)
raise.

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
from mmvqa_tpu_torch.models.effnetv2 import BatchNorm2d
from mmvqa_tpu_torch.models.embeddings import BertEmbeddings
from mmvqa_tpu_torch.models.feedback import FeedbackEncoder, FeedbackSegment
from mmvqa_tpu_torch.models.layers import DropoutRng, LayerNorm, Linear
from mmvqa_tpu_torch.models.realformer import RealFormerEncoder
from mmvqa_tpu_torch.models.transformer import BertEncoder
from mmvqa_tpu_torch.models.visual_tokens import TokenHead, VisualTokenizer
from mmvqa_tpu_torch.ops.activations import serf


def mean_pooling(h: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the sequence axis."""
    m = attention_mask[..., None].to(h.dtype)
    return (h * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-9)


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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to mmvqa_tpu_torch yet (ROADMAP.md Queue 1, "
        f"item {item})"
    )


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
            raise _not_ported("pipeline parallelism", "10")
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
        if "feedback-transformer" in cfg.transformer_model:
            self.encoder = FeedbackEncoder(
                H, cfg.n_layers, attn_dropout=dp(0.1), ff_dropout=dp(0.1),
                rng=self.dropout_rng)
        elif "realformer" in cfg.transformer_model:
            self.encoder = RealFormerEncoder(
                H, cfg.n_layers, head_cnt=cfg.head_count, dp1=dp(0.1),
                dp2=dp(0.1), rng=self.dropout_rng)
        else:
            self.encoder = BertEncoder(
                H, cfg.n_layers, cfg.heads, dp(cfg.hidden_dropout_prob),
                share="none", norm_pos="pre", rng=self.dropout_rng)
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
        self.to(device=device, dtype=dtype)
        self.eval()

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
        to the deepest tapped map (``VisualTokenizer.features``)."""
        tokens, _ = self.trans.features(img.to(self.dtype), perturb)
        return self.encode_tokens(tokens, input_ids, segment_ids, input_mask)

    def encode_tokens(self, tokens, input_ids: torch.Tensor,
                      segment_ids: torch.Tensor,
                      input_mask: torch.Tensor) -> torch.Tensor:
        """The encoder over the visual ``tokens`` (one (B, H) tensor a tap)
        written over the embedded text's first positions."""
        h = self.bert_embedding(input_ids, segment_ids).to(self.dtype)
        vis = torch.stack([t.to(h.dtype) for t in tokens], dim=1)
        h = torch.cat([vis, h[:, vis.shape[1]:]], dim=1)
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
