"""Losses (counterpart of mmvqa_tpu/ops/losses.py and of the loss helpers of
mmvqa_tpu/train/steps.py): the MLM objective with its streaming logsumexp,
and the VQA eval criterion (the per-sample losses inside ``make_vqa_steps``,
:396-428, and ``_weighted_mean``, :48-49). Every loss is taken in fp32. Plain
PyTorch: the JAX package computes these outside any Pallas kernel."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy_per_sample(logits: torch.Tensor,
                             targets: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[:, None])[:, 0]


def asl_per_sample(logits: torch.Tensor, targets: torch.Tensor,
                   gamma_neg: float = 4.0, eps: float = 0.1) -> torch.Tensor:
    """Asymmetric single-label loss (gamma_pos 0), one value per sample:
    log-probabilities weighted by ``(1 - p_t)^0`` on the target and ``p^4``
    elsewhere, against one-hot targets smoothed by ``eps``."""
    num_classes = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    one_hot = F.one_hot(targets.long(), num_classes).to(logp.dtype)
    anti = 1.0 - one_hot
    p = torch.exp(logp)
    wgt = torch.pow(1.0 - p * one_hot - (1.0 - p) * anti, gamma_neg * anti)
    soft = one_hot * (1.0 - eps) + eps / num_classes
    return torch.sum(-soft * (logp * wgt), dim=-1)


def weighted_mean(per_sample: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Mean over the real samples of a batch (weight 1 real, 0 padding)."""
    w = w.to(per_sample.dtype)
    return torch.sum(per_sample * w) / torch.clamp(torch.sum(w), min=1.0)


class _StreamingLSE(torch.autograd.Function):
    """logsumexp over the last axis in fp32 that keeps no fp32 copy of the
    logits: it saves the logits as they came (bf16 under mixed precision),
    the row max and the row sum, and recomputes the softmax in the backward.
    At B=128, T=75, V=30522 an fp32 (B, T, V) tensor is 1.17 GB."""

    @staticmethod
    def forward(ctx, logits):
        m = logits.amax(dim=-1)
        mf = m.float()
        s = torch.exp(logits.float() - mf[..., None]).sum(dim=-1)
        ctx.save_for_backward(logits, m, s)
        return torch.log(s) + mf

    @staticmethod
    def backward(ctx, g):
        logits, m, s = ctx.saved_tensors
        soft = torch.exp(logits.float() - m.float()[..., None])
        soft *= (g / s)[..., None]
        return soft.to(logits.dtype)


def streaming_lse(logits: torch.Tensor) -> torch.Tensor:
    """fp32 logsumexp over the last axis (mmvqa_tpu/ops/losses.py:19-52)."""
    return _StreamingLSE.apply(logits)


def _token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(B, T) negative log-likelihood of ``targets`` in fp32."""
    picked = logits.gather(-1, targets.long()[..., None])[..., 0].float()
    return streaming_lse(logits) - picked


def masked_mlm_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The MLM objective: mean NLL over EVERY (batch, position) cell. There
    is no ignore_index: unmasked positions carry label 0 and contribute
    ``-log p(token 0)``, the reference's quirk.

    logits: (B, T, V) raw scores; targets: (B, T) int labels (0 = unmasked)."""
    return _token_nll(logits, targets).mean()


def weighted_token_nll(logits: torch.Tensor, targets: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """``masked_mlm_nll`` with per-sample weights, exact for a padded last
    batch (mmvqa_tpu/train/steps.py::_weighted_token_nll)."""
    return weighted_mean(_token_nll(logits, targets).mean(dim=-1), w)


def mlm_metrics(logits: torch.Tensor, labels: torch.Tensor, w: torch.Tensor):
    """(correct, total) over the masked tokens (label > 0) of real samples."""
    pred = torch.argmax(logits, dim=-1)
    masked = (labels > 0) & (w[:, None] > 0)
    return torch.sum(masked & (pred == labels)), torch.sum(masked)
