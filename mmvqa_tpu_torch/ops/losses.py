"""Losses (counterpart of mmvqa_tpu/ops/losses.py and of the loss helpers of
mmvqa_tpu/train/steps.py): the MLM objective with its streaming logsumexp,
the VQA-Med criteria (cross entropy, asymmetric single-label loss, label
smoothing, soft targets, the category-smoothed targets) in their mean forms
(``ops/losses.py:77-162``) and in the per-sample forms that
``make_vqa_steps`` reduces with the batch's weights (``steps.py:396-428``,
``_weighted_mean``, :48-49); the distillation objectives: the mean squared
distance to the teacher's hidden states (``mse_distillation``, :137-150)
and the per-sample form of ``make_distill_steps`` (``steps.py:245-252``).
Every loss is taken in fp32. Plain PyTorch: the
JAX package computes these outside any Pallas kernel. Batch means and
counts are the global batch's under data parallelism (``weighted_mean``,
``mlm_metrics``), as in the JAX package's one program over the mesh; under
context parallelism a mean over the token axis is the rank's block's sum,
summed over 'context' and divided by the global length (``token_mean``),
and the MLM counts are summed over 'context' too."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mmvqa_tpu_torch.core.mesh import CONTEXT_AXIS, DATA_AXIS
from mmvqa_tpu_torch.parallel.comm import axis_size, reduce_from, sum_over


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return F.log_softmax(logits.float(), dim=-1)


def cross_entropy_per_sample(logits: torch.Tensor,
                             targets: torch.Tensor) -> torch.Tensor:
    logp = _log_softmax(logits)
    return -logp.gather(-1, targets.long()[:, None])[:, 0]


def asl_per_sample(logits: torch.Tensor, targets: torch.Tensor,
                   gamma_pos: float = 0.0, gamma_neg: float = 4.0,
                   eps: float = 0.1) -> torch.Tensor:
    """Asymmetric single-label loss, one value per sample
    (models/asl_singlelabel.py:23-53): log-probabilities weighted by
    ``(1 - p t - (1 - p)(1 - t))^(gamma_pos t + gamma_neg (1 - t))``, a
    weight that carries a gradient, against one-hot targets smoothed by
    ``eps``."""
    num_classes = logits.shape[-1]
    logp = _log_softmax(logits)
    one_hot = F.one_hot(targets.long(), num_classes).to(logp.dtype)
    anti = 1.0 - one_hot
    p = torch.exp(logp)
    wgt = torch.pow(1.0 - p * one_hot - (1.0 - p) * anti,
                    gamma_pos * one_hot + gamma_neg * anti)
    soft = one_hot * (1.0 - eps) + eps / num_classes if eps > 0 else one_hot
    return torch.sum(-soft * (logp * wgt), dim=-1)


def soft_target_per_sample(logits: torch.Tensor,
                           soft_targets: torch.Tensor) -> torch.Tensor:
    """CE against soft targets, one value per sample."""
    return torch.sum(-soft_targets * _log_softmax(logits), dim=-1)


def category_smoothing_per_sample(logits: torch.Tensor, answers: torch.Tensor,
                                  categories: torch.Tensor,
                                  table: torch.Tensor,
                                  smoothing: float) -> torch.Tensor:
    """LabelSmoothByCategory's train branch, one value per sample: the soft
    target is the row of ``table`` for the sample's category with
    ``1 - smoothing`` written at its answer; the write goes into a gathered
    copy, never into the table."""
    soft = table[categories.long()]  # advanced indexing: a copy
    soft = soft.scatter(1, answers.long()[:, None], 1.0 - smoothing)
    return soft_target_per_sample(logits, soft)


def weighted_mean(per_sample: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Mean over the real samples of a batch (weight 1 real, 0 padding).
    Under data parallelism the batch is the global one: the denominator is
    the global sum of weights, and each rank's share of the numerator is
    summed over 'data' (``comm.reduce_from``: every rank gets the global
    mean and the gradient of it with respect to its own rows)."""
    w = w.to(per_sample.dtype)
    den = sum_over(torch.sum(w), DATA_AXIS)
    return reduce_from(torch.sum(per_sample * w) / torch.clamp(den, min=1.0),
                       DATA_AXIS)


def mse_distillation(pred: torch.Tensor, target: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared distance to the teacher's hidden states
    (roco_train.py:94-95): over every (B, T, H) element where ``mask`` is
    None, padded positions included (they regress to zero vectors, the
    reference's choice); else over the positions where ``mask`` (B, T) is
    set, divided by ``max(sum(mask) * H, 1)``."""
    se = torch.square(pred.float() - target.float())
    if mask is None:
        return se.mean()
    m = mask[..., None].to(se.dtype)
    return torch.sum(se * m) / torch.clamp(torch.sum(m) * se.shape[-1],
                                           min=1.0)


def token_mean(x: torch.Tensor, dims=(1,)) -> torch.Tensor:
    """The mean of ``x`` over ``dims``, the first of them the token axis:
    under context parallelism the rank's block's sum, summed over 'context'
    (each rank's gradient that of its block), over the global count."""
    cp = axis_size(CONTEXT_AXIS)
    if cp == 1:
        return x.mean(dim=dims)
    count = cp
    for d in dims:
        count *= x.shape[d]
    return reduce_from(x.sum(dim=dims), CONTEXT_AXIS) / count


def distill_per_sample(h: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B,) mean over (T, H) of ``(h - labels)^2`` in fp32, padded positions
    included: the loss ``make_distill_steps`` weights by the batch's
    ``weights``."""
    return token_mean(torch.square(h.float() - labels.float()), (1, 2))


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over int labels (vqamed2019/train.py:169-171)."""
    return cross_entropy_per_sample(logits, targets).mean()


def asl_single_label(logits: torch.Tensor, targets: torch.Tensor,
                     gamma_pos: float = 0.0, gamma_neg: float = 4.0,
                     eps: float = 0.1) -> torch.Tensor:
    """``asl_per_sample`` averaged over the batch."""
    return asl_per_sample(logits, targets, gamma_pos, gamma_neg, eps).mean()


def label_smoothing_loss(logits: torch.Tensor, one_hot_targets: torch.Tensor,
                         smoothing: float = 0.1) -> torch.Tensor:
    """Smoothed CE over soft or one-hot targets (vqamed2019/utils.py:178-198):
    ``(1 - s) sum(-logp t) + s mean(-logp)`` averaged over the batch."""
    logp = _log_softmax(logits)
    nll = torch.sum(-logp * one_hot_targets, dim=-1)
    smooth = torch.mean(-logp, dim=-1)
    return torch.mean((1.0 - smoothing) * nll + smoothing * smooth)


def smoothed_soft_target_ce(logits: torch.Tensor,
                            soft_targets: torch.Tensor) -> torch.Tensor:
    """CE against precomputed soft targets (vqamed2019/utils.py:1296-1300):
    ``mean(sum(-t log_softmax(x), -1))``."""
    return soft_target_per_sample(logits, soft_targets).mean()


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
    return weighted_mean(token_mean(_token_nll(logits, targets), (1,)), w)


def mlm_metrics(logits: torch.Tensor, labels: torch.Tensor, w: torch.Tensor):
    """(correct, total) over the masked tokens (label > 0) of real samples."""
    pred = torch.argmax(logits, dim=-1)
    masked = (labels > 0) & (w[:, None] > 0)
    counts = torch.stack([torch.sum(masked & (pred == labels)),
                          torch.sum(masked)])
    # the global batch's
    correct, total = sum_over(sum_over(counts, DATA_AXIS), CONTEXT_AXIS)
    return correct, total


def mlm_accuracy(logits: torch.Tensor,
                 targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked-token accuracy (roco_utils.py:256-265): (correct, masked) over
    the positions with a label > 0, for a host to add up over an epoch."""
    return mlm_metrics(logits, targets, targets.new_ones(targets.shape[0]))
