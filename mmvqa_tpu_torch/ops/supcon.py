"""Supervised-contrastive / SimCLR loss (counterpart of
mmvqa_tpu/ops/supcon.py; reference models/SupConLoss/loss.py:11-98).

Yonglong Tian's SupConLoss with temperature = base_temperature = 0.07: an
identity mask (SimCLR) when neither labels nor mask is given, an equality
mask from labels, or a float mask (similarity-weighted positives);
self-contrast excluded; logits stabilised by their row maximum, taken
without gradient. ``contrast_mode`` 'all' anchors every view, 'one' the
first.

The features may come in the model's compute dtype; the loss runs in fp32.
The product ``anchor @ contrast.T`` must be a true fp32 product: the 1/0.07
scale magnifies any reduced-precision pass, which is why the JAX package
computes it at ``Precision.HIGHEST``. PyTorch's fp32 matrix products are
TF32-free unless a caller turns ``torch.backends.cuda.matmul.allow_tf32`` on,
and the CLIs turn it off (``cli/common.py::setup_runtime``). It is a plain
product outside any Pallas kernel of the JAX package, so it stays a library
matmul here.

``axis_name`` ('data') gathers the features of a data-parallel mesh, with
their gradient (``parallel.comm.gather_from``), and the labels, so that the
denominator sees the global batch; a float mask of local pairs is embedded
block-diagonally into the global one, as the JAX function does
(mmvqa_tpu/ops/supcon.py:44-58). Every rank then holds the global loss.
"""

from __future__ import annotations

from typing import Optional

import torch

from mmvqa_tpu_torch.parallel.comm import (
    axis_info,
    gather_from,
    gather_over,
    sum_over,
)


def supcon_loss(
    features: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    temperature: float = 0.07,
    base_temperature: float = 0.07,
    contrast_mode: str = "all",
    axis_name: Optional[str] = None,
) -> torch.Tensor:
    """features: (bsz, n_views, d) L2-normalised projections.

    labels: optional (bsz,) int class ids -> equality mask.
    mask: optional (bsz, bsz) float positives mask (diagonal should be 1).
    """
    if features.dim() < 3:
        raise ValueError("features must be [bsz, n_views, ...]")
    if features.dim() > 3:
        features = features.reshape(features.shape[0], features.shape[1], -1)
    if labels is not None and mask is not None:
        raise ValueError("cannot define both labels and mask")
    if axis_name is not None:
        n = features.shape[0]
        features = gather_from(features, axis_name, 0)
        if labels is not None:
            labels = gather_over(labels.reshape(-1), axis_name, 0)
        if mask is not None:
            _, _, idx = axis_info(axis_name)
            big = mask.new_zeros((features.shape[0], features.shape[0]))
            big[idx * n:(idx + 1) * n, idx * n:(idx + 1) * n] = mask
            mask = sum_over(big, axis_name)

    bsz, n_views = features.shape[:2]
    dev, f32 = features.device, torch.float32
    if labels is None and mask is None:
        mask = torch.eye(bsz, dtype=f32, device=dev)
    elif labels is not None:
        labels = labels.reshape(-1, 1)
        mask = (labels == labels.T).to(f32)
    else:
        mask = mask.to(dev, f32)

    # (n_views * bsz, d): views stacked along the batch, view-major, as
    # torch.cat(torch.unbind(features, dim=1)) (loss.py:58)
    contrast = torch.cat(torch.unbind(features, dim=1), dim=0).to(f32)
    if contrast_mode == "one":
        anchor = features[:, 0].to(f32)
        anchor_count = 1
    elif contrast_mode == "all":
        anchor = contrast
        anchor_count = n_views
    else:
        raise ValueError(f"unknown contrast_mode {contrast_mode}")

    logits = torch.matmul(anchor, contrast.T) / temperature
    logits = logits - torch.amax(logits, dim=1, keepdim=True).detach()

    mask = mask.repeat(anchor_count, n_views)
    n_anchor = bsz * anchor_count
    logits_mask = 1.0 - torch.eye(n_anchor, mask.shape[1], dtype=f32,
                                  device=dev)
    mask = mask * logits_mask

    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(exp_logits.sum(dim=1, keepdim=True))
    mean_log_prob_pos = (mask * log_prob).sum(dim=1) / mask.sum(dim=1)

    loss = -(temperature / base_temperature) * mean_log_prob_pos
    return loss.reshape(anchor_count, bsz).mean()


def split_two_views(feat: torch.Tensor) -> torch.Tensor:
    """(2 * bsz, d) concatenated views -> (bsz, 2, d), the reference's
    split_feat (supcon_utils.py:259-261)."""
    bsz = feat.shape[0] // 2
    return torch.stack([feat[:bsz], feat[bsz:]], dim=1)
