"""Grad-CAM through the full multimodal model (counterpart of
mmvqa_tpu/explain/gradcam.py).

Rebuild of vqamed2019/grad_cam2.py: the reference hooks the deepest
EfficientNetV2 map (image_encoding.py:109-128) and calls
``logits[:, answer].backward()`` (grad_cam2.py:139-152). Here, as in the JAX
package, the same quantity is the gradient of the answer logit with respect
to a zero perturbation added to that map (``MMBert.features_and_logits``).

The trunk runs once, without a graph, and the parameters are frozen for the
call: the perturbation is the only tensor that asks for a gradient, so the
deepest tap's token head is the only one on the backward path (one K1
backward, the four others forward-only) and the encoder's layers run
backward once each. Activations and gradients are NHWC, (B, h, w, C), as the
JAX functions return them.

Heatmap recipe (grad_cam2.py:144-158): channel weights = gradient mean over
(batch, H, W); weighted channel mean; ReLU; normalized by the max.
``overlay_heatmap`` blends it onto the image without PIL or matplotlib: PIL's
BILINEAR upscale (``data/images.py::resize_bilinear``) and matplotlib's
``jet`` colormap as its 256-entry table.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch

from mmvqa_tpu_torch.data.images import resize_bilinear


@contextlib.contextmanager
def frozen(model: torch.nn.Module):
    """Within ``with``, no parameter of ``model`` requires a gradient."""
    flags = [(p, p.requires_grad) for p in model.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield model
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def deepest_map(model, img: torch.Tensor) -> Tuple[tuple, torch.Tensor]:
    """(the tapped maps, the deepest as an NHWC view): the trunk in eval
    mode, without a graph."""
    model.set_mode(True)
    with torch.no_grad():
        maps = model.trans.tapped_maps(img.to(model.dtype))
    return maps, maps[model.trans.deepest].permute(0, 2, 3, 1)


def grad_cam_from_maps(model, maps: tuple, input_ids: torch.Tensor,
                       segment_ids: torch.Tensor, input_mask: torch.Tensor,
                       answer: int):
    """``grad_cam_activations`` from the trunk's tapped maps
    (``deepest_map``); returns its three results and the visual tokens
    (detached), which a rerun from the tap keeps."""
    deepest = maps[model.trans.deepest].permute(0, 2, 3, 1)
    with frozen(model):
        eps = torch.zeros_like(deepest, requires_grad=True)
        with torch.enable_grad():
            tokens, _ = model.trans.tokens_of(maps, eps)
            h = model.encode_tokens(tokens, input_ids, segment_ids, input_mask)
            logits = model.vqa_head(h, input_mask)
            (grads,) = torch.autograd.grad(logits[0, answer], eps)
    return (deepest, grads, logits.detach(),
            tuple(t.detach() for t in tokens))


def grad_cam_activations(model, img: torch.Tensor, input_ids: torch.Tensor,
                         segment_ids: torch.Tensor, input_mask: torch.Tensor,
                         answer: int):
    """Returns (activations (B, h, w, C), gradients of ``logits[0, answer]``
    with respect to them (B, h, w, C), logits (B, classes)) at the deepest
    tapped map: the inputs of every CAM-zoo method."""
    maps, _ = deepest_map(model, img)
    return grad_cam_from_maps(model, maps, input_ids, segment_ids,
                              input_mask, answer)[:3]


def vqa_scores(model, input_ids: torch.Tensor, segment_ids: torch.Tensor,
               input_mask: torch.Tensor, answer: int):
    """``score_fn`` of ScoreCAM over the full model: masked images
    (B * k, S, S, 3), each sample's k masks together, -> the answer's logit
    with the sample's question."""
    def score(masked: torch.Tensor) -> torch.Tensor:
        k = masked.shape[0] // input_ids.shape[0]
        ids, seg, mask = (t.repeat_interleave(k, dim=0)
                          for t in (input_ids, segment_ids, input_mask))
        return model(masked, ids, seg, mask)[:, answer]

    return score


def ablation_rerun(model, tokens: tuple, input_ids: torch.Tensor,
                   segment_ids: torch.Tensor, input_mask: torch.Tensor,
                   answer: int):
    """``rerun_fn`` of AblationCAM from the tap: ablated deepest maps
    (k * B, h, w, C), channel-major, through the deepest token head and the
    encoder, the other taps' ``tokens`` (``grad_cam_from_maps``) as they
    were -> the answer's logit. The JAX CLI reruns the whole model with
    ``perturb = ablated - acts``; the trunk's output does not depend on it,
    so this differs by the rounding of ``acts + (ablated - acts)``."""
    d = model.trans.deepest
    head = getattr(model.trans, f"token_conv_{d}")

    def rerun(ablated: torch.Tensor) -> torch.Tensor:
        k = ablated.shape[0] // input_ids.shape[0]
        kept = [t.repeat(k, 1) for t in tokens]
        kept[d] = head(ablated.permute(0, 3, 1, 2))
        ids, seg, mask = (t.repeat(k, 1)
                          for t in (input_ids, segment_ids, input_mask))
        return model.vqa_head(model.encode_tokens(kept, ids, seg, mask),
                              mask)[:, answer]

    return rerun


def cnn_only_activations(model, img: torch.Tensor):
    """CNN-only CAM inputs, the reference's library-CAM path
    (grad_cam.py:112-133): the fine-tuned trunk alone, question-independent;
    the score it explains is the argmax channel of the globally pooled
    deepest map, picked on the host after the trunk's pass (the JAX
    package's documented deviation: the MMBert tree carries no timm
    classifier).

    Returns (activations, gradients, pooled (B, C), target channel)."""
    _, deepest = deepest_map(model, img)
    target = int(torch.argmax(deepest.mean(dim=(1, 2))[0]))
    eps = torch.zeros_like(deepest, requires_grad=True)
    with torch.enable_grad():
        pooled = (deepest + eps).mean(dim=(1, 2))
        (grads,) = torch.autograd.grad(pooled[0, target], eps)
    return deepest, grads, pooled.detach(), target


def grad_cam_heatmap(model, img: torch.Tensor, input_ids: torch.Tensor,
                     segment_ids: torch.Tensor, input_mask: torch.Tensor,
                     answer: int) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (heatmap (h, w) in [0, 1], logits (B, classes))."""
    deepest, grads, logits = grad_cam_activations(
        model, img, input_ids, segment_ids, input_mask, answer)
    pooled = grads.mean(dim=(0, 1, 2))  # channel weights (grad_cam2.py:144)
    heat = (deepest * pooled).mean(dim=-1)[0]  # channel mean (:152)
    heat = torch.clamp(heat, min=0.0)
    heat = heat / torch.clamp(heat.max(), min=1e-12)
    return heat.float().cpu().numpy(), logits.float().cpu().numpy()


# matplotlib's _jet_data (matplotlib/_cm.py): (x, y0, y1) breakpoints a
# channel
_JET_DATA = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
              (0.91, 0, 0), (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.0, 0, 0)),
}
JET_N = 256


def _segment_lut(data, n: int) -> np.ndarray:
    """matplotlib's ``_create_lookup_table(n, data)`` at gamma 1."""
    a = np.array(data, dtype=float)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]],
                          distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def jet_lut() -> np.ndarray:
    """``matplotlib.cm.jet``'s table, (256, 3) float64 RGB, as
    ``LinearSegmentedColormap`` builds it."""
    return np.stack([_segment_lut(_JET_DATA[c], JET_N)
                     for c in ("red", "green", "blue")], axis=-1)


def jet(values: np.ndarray) -> np.ndarray:
    """``matplotlib.cm.jet(values)[..., :3]`` for floats in [0, 1]: index
    ``floor(v * 256)``, 1.0 on the last entry (``Colormap.__call__``)."""
    xa = np.array(values, copy=True)
    xa *= JET_N
    xa[xa == JET_N] = JET_N - 1
    return jet_lut().take(xa.astype(int), axis=0, mode="clip")


def overlay_heatmap(image_u8: np.ndarray, heatmap: np.ndarray,
                    alpha: float = 0.4) -> np.ndarray:
    """Upscale the heatmap to the image (PIL's BILINEAR on its uint8 form),
    colour it with ``jet`` and add it to the image with weight ``alpha``
    (grad_cam2.py:183-188, cv2 there): the JAX function's arithmetic, bit
    for bit."""
    h, w = image_u8.shape[:2]
    hm = (heatmap * 255).astype(np.uint8)
    hm = resize_bilinear(hm[..., None], w, h)[..., 0]
    hm = np.asarray(hm, np.float32) / 255.0
    colored = (jet(hm) * 255).astype(np.float32)
    out = colored * alpha + image_u8.astype(np.float32)
    return np.clip(out, 0, 255).astype(np.uint8)
