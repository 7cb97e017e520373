"""CAM method zoo: GradCAM / GradCAM++ / XGradCAM / EigenCAM / ScoreCAM /
AblationCAM (counterpart of mmvqa_tpu/explain/cam_zoo.py).

Rebuild of vqamed2019/grad_cam.py:65-72, which dispatches to the
pytorch_grad_cam library over the fine-tuned EfficientNetV2's last block.
Each method is a function of the target activations A (B, H, W, C), their
gradients G with respect to the class logit (``explain/gradcam.py``) and,
for the perturbation methods, a batched ``score_fn`` or ``rerun_fn``; plain
tensor operations, as the JAX package computes them outside any kernel.

All methods return (B, H, W) heatmaps normalized to [0, 1].
"""

from __future__ import annotations

from typing import Callable

import torch


def _normalize(heat: torch.Tensor) -> torch.Tensor:
    heat = torch.clamp(heat, min=0.0)
    mx = heat.amax(dim=(1, 2), keepdim=True)
    return heat / torch.clamp(mx, min=1e-12)


def grad_cam(acts: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """weights = GAP(grads); heat = relu(sum_c w_c A_c)."""
    w = grads.mean(dim=(1, 2), keepdim=True)
    return _normalize((acts * w).sum(dim=-1))


def grad_cam_pp(acts: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """GradCAM++ (Chattopadhyay et al. 2018): alpha-weighted positive grads."""
    g2 = grads ** 2
    g3 = g2 * grads
    denom = 2.0 * g2 + (acts * g3).sum(dim=(1, 2), keepdim=True)
    alpha = g2 / torch.where(denom != 0, denom, torch.ones_like(denom))
    w = (alpha * torch.clamp(grads, min=0.0)).sum(dim=(1, 2), keepdim=True)
    return _normalize((acts * w).sum(dim=-1))


def xgrad_cam(acts: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """XGradCAM: weights = sum(A*G) / (sum(A) + eps), per channel."""
    num = (acts * grads).sum(dim=(1, 2), keepdim=True)
    den = acts.sum(dim=(1, 2), keepdim=True) + 1e-6
    return _normalize((acts * (num / den)).sum(dim=-1))


def eigen_cam(acts: torch.Tensor) -> torch.Tensor:
    """EigenCAM: projection onto the first principal component of A. The
    singular vector's sign is arbitrary; the dominant response is made
    positive."""
    B, H, W, C = acts.shape
    flat = acts.reshape(B, H * W, C)
    flat = flat - flat.mean(dim=1, keepdim=True)
    _, _, vt = torch.linalg.svd(flat, full_matrices=False)
    proj = torch.einsum("bpc,bc->bp", flat, vt[:, 0, :]).reshape(B, H, W)
    sign = torch.sign(torch.clamp(proj, min=0).sum(dim=(1, 2))
                      - torch.clamp(-proj, min=0).sum(dim=(1, 2)))
    return _normalize(proj * sign[:, None, None])


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) bilinear weights of ``jax.image.resize`` (its
    compute_weight_mat): half-pixel centres, the triangle kernel unscaled
    when upsampling and widened by the factor when downsampling (antialias),
    each output's weights renormalized to sum to 1, in float32."""
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale
              - 0.5)
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]
         ).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def _upsample_mask(acts_c: torch.Tensor, size: int) -> torch.Tensor:
    """(B, h, w) activation channel -> (B, size, size) in [0, 1]:
    ``jax.image.resize(..., "bilinear")`` as explicit interpolation
    matrices, then min-max scaled."""
    _, h, w = acts_c.shape
    up = acts_c.float()
    if h != size:
        up = torch.einsum("bhw,hy->byw", up, _resize_weights(h, size,
                                                              up.device))
    if w != size:
        up = torch.einsum("byw,wx->byx", up, _resize_weights(w, size,
                                                              up.device))
    lo = up.amin(dim=(1, 2), keepdim=True)
    hi = up.amax(dim=(1, 2), keepdim=True)
    return ((up - lo) / torch.clamp(hi - lo, min=1e-12)).to(acts_c.dtype)


def score_cam(acts: torch.Tensor, image: torch.Tensor,
              score_fn: Callable[[torch.Tensor], torch.Tensor],
              chunk: int = 32) -> torch.Tensor:
    """ScoreCAM: weight each channel by the class score of the input masked
    with that channel's upsampled activation; softmax over channels.

    score_fn: (N, S, S, 3) -> (N,) class scores. Runs ceil(C / chunk)
    batched calls of N = B * chunk images, without a graph."""
    B, h, w, C = acts.shape
    S = image.shape[1]
    scores = []
    with torch.no_grad():
        for c0 in range(0, C, chunk):
            cs = acts[..., c0:c0 + chunk]  # (B, h, w, k)
            k = cs.shape[-1]
            masks = _upsample_mask(cs.permute(0, 3, 1, 2).reshape(B * k, h, w),
                                   S).reshape(B, k, S, S)
            masked = image[:, None] * masks[..., None]  # (B, k, S, S, 3)
            s = score_fn(masked.reshape(B * k, S, S, 3)).reshape(B, k)
            scores.append(s.to(acts.dtype))
    weights = torch.softmax(torch.cat(scores, dim=1), dim=1)
    return _normalize(torch.einsum("bhwc,bc->bhw", acts, weights))


def ablation_cam(acts: torch.Tensor,
                 rerun_fn: Callable[[torch.Tensor], torch.Tensor],
                 base_score: torch.Tensor, chunk: int = 32) -> torch.Tensor:
    """AblationCAM: weight_c = (base - score with channel c zeroed) / base.

    rerun_fn: ablated activations (N, h, w, C) -> (N,) class scores, sample
    by sample (the model rerun from the target layer); a call takes the
    ablations of ``chunk`` channels stacked along the batch, N = chunk * B,
    channel-major, without a graph."""
    B, h, w, C = acts.shape
    out = []
    with torch.no_grad():
        for c0 in range(0, C, chunk):
            k = min(chunk, C - c0)
            keep = torch.ones(k, C, dtype=acts.dtype, device=acts.device)
            keep[torch.arange(k), torch.arange(c0, c0 + k)] = 0
            ablated = acts[None] * keep[:, None, None, None, :]
            s = rerun_fn(ablated.reshape(k * B, h, w, C)).reshape(k, B)
            out.append((base_score - s) / (base_score + 1e-8))
    weights = torch.cat(out, dim=0)  # (C, B)
    return _normalize(torch.einsum("bhwc,bc->bhw", acts, weights.T))


CAM_METHODS = {
    "gradcam": grad_cam,
    "gradcam++": grad_cam_pp,
    "xgradcam": xgrad_cam,
    "eigencam": eigen_cam,
    "scorecam": score_cam,
    "ablationcam": ablation_cam,
}
