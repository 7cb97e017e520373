"""Batch image preparation on the device (counterpart of the device side of
mmvqa_tpu/data/images.py, :243-385): uint8 NHWC -> augmented, normalized
float32 NHWC, ``(u8 / 255 - 0.5) / 0.5``.

Augmentation is RandomResizedCrop (a bilinear crop + resize done as two
interpolation-matrix products) and a colour jitter in the fixed order
brightness, contrast, saturation, hue. The random draws are split from the
arithmetic: ``sample_draws`` makes them from a ``torch.Generator`` and
``apply_augment`` applies them, so that a test can hand the same draws to
this package and to the JAX one (whose random bits cannot be reproduced).
Host-side rotation (``random_rotate_host``) is not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch


@dataclass(frozen=True)
class AugmentSpec:
    """Random-augmentation strengths: pretrain crop 0.95-1.05, rot 5, jitter
    0.05; fine-tune crop 0.75-1.25, rot 10, jitter 0.4."""

    crop_scale: Tuple[float, float] = (0.95, 1.05)
    crop_ratio: Tuple[float, float] = (0.95, 1.05)
    rotation_deg: float = 5.0
    brightness: float = 0.05
    contrast: float = 0.05
    saturation: float = 0.05
    hue: float = 0.05


PRETRAIN_AUG = AugmentSpec()
FINETUNE_AUG = AugmentSpec(
    crop_scale=(0.75, 1.25), crop_ratio=(0.75, 1.25), rotation_deg=10.0,
    brightness=0.4, contrast=0.4, saturation=0.4, hue=0.4,
)


class AugmentDraws(NamedTuple):
    """One row per image. ``crop``: (B, 4) the box ``y0, x0, h, w`` in source
    pixels; ``jitter``: (B, 4) the brightness, contrast and saturation
    factors and the hue shift (a fraction of a turn)."""

    crop: torch.Tensor
    jitter: torch.Tensor


def _uniform(gen: torch.Generator, n: int, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=gen.device)


def sample_draws(n: int, size: int, generator: torch.Generator,
                 spec: AugmentSpec = PRETRAIN_AUG) -> AugmentDraws:
    """Draw crop boxes and jitter factors for ``n`` images of ``size`` px,
    on the generator's device (``_sample_crop`` and the draws of
    ``_color_jitter`` in the JAX package)."""
    g = generator
    scale = _uniform(g, n, *spec.crop_scale)
    ratio = torch.exp(_uniform(g, n, math.log(spec.crop_ratio[0]),
                               math.log(spec.crop_ratio[1])))
    area = size * size * scale
    w = torch.clamp(torch.sqrt(area * ratio), max=size)
    h = torch.clamp(torch.sqrt(area / ratio), max=size)
    x0 = torch.rand(n, generator=g, device=g.device) * (size - w)
    y0 = torch.rand(n, generator=g, device=g.device) * (size - h)
    jitter = torch.stack([
        _uniform(g, n, 1 - spec.brightness, 1 + spec.brightness),
        _uniform(g, n, 1 - spec.contrast, 1 + spec.contrast),
        _uniform(g, n, 1 - spec.saturation, 1 + spec.saturation),
        _uniform(g, n, -spec.hue, spec.hue),
    ], dim=1)
    return AugmentDraws(torch.stack([y0, x0, h, w], dim=1), jitter)


def _interp_matrix(start: torch.Tensor, extent: torch.Tensor,
                   size: int) -> torch.Tensor:
    """(B, out, in) bilinear sampling matrices of a 1-D crop + resize: output
    u samples source coordinate ``start + (u + 0.5) * extent / size - 0.5``
    with hat-function weights; rows renormalised to sum to 1 at the edges."""
    u = torch.arange(size, dtype=torch.float32, device=start.device)
    src = start[:, None] + (u[None] + 0.5) * (extent[:, None] / size) - 0.5
    d = (src[:, :, None] - u[None, None, :]).abs()
    w = torch.clamp(1.0 - d, min=0.0)
    return w / torch.clamp(w.sum(dim=2, keepdim=True), min=1e-6)


def _gray(x: torch.Tensor) -> torch.Tensor:
    return (0.2989 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[..., None]


def _per_image(f: torch.Tensor) -> torch.Tensor:
    return f[:, None, None, None]


def apply_augment(x: torch.Tensor, draws: AugmentDraws,
                  spec: AugmentSpec = PRETRAIN_AUG) -> torch.Tensor:
    """x: (B, S, S, 3) float32 in [0, 1]. Crop + resize, then the jitter
    stages whose strength in ``spec`` is above 0."""
    size = x.shape[1]
    crop = draws.crop.to(x.device, torch.float32)
    jit = draws.jitter.to(x.device, torch.float32)
    wy = _interp_matrix(crop[:, 0], crop[:, 2], size)
    wx = _interp_matrix(crop[:, 1], crop[:, 3], size)
    x = torch.einsum("boy,byxc->boxc", wy, x)
    x = torch.einsum("box,byxc->byoc", wx, x)
    if spec.brightness > 0:
        x = torch.clamp(x * _per_image(jit[:, 0]), 0.0, 1.0)
    if spec.contrast > 0:
        mean = _gray(x).mean(dim=(1, 2, 3), keepdim=True)
        x = torch.clamp((x - mean) * _per_image(jit[:, 1]) + mean, 0.0, 1.0)
    if spec.saturation > 0:
        g = _gray(x)
        x = torch.clamp((x - g) * _per_image(jit[:, 2]) + g, 0.0, 1.0)
    if spec.hue > 0:
        # hue as a rotation of the chroma in YIQ space
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        y = _gray(x)[..., 0]
        i = 0.596 * r - 0.274 * g - 0.322 * b
        q = 0.211 * r - 0.523 * g + 0.312 * b
        ang = jit[:, 3, None, None] * (2.0 * math.pi)
        ci, cq = torch.cos(ang), torch.sin(ang)
        i2 = ci * i - cq * q
        q2 = cq * i + ci * q
        x = torch.clamp(torch.stack([
            y + 0.956 * i2 + 0.621 * q2,
            y - 0.272 * i2 - 0.647 * q2,
            y - 1.106 * i2 + 1.703 * q2,
        ], dim=-1), 0.0, 1.0)
    return x


def process_batch(images_u8: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  spec: AugmentSpec = PRETRAIN_AUG, augment: bool = False,
                  draws: Optional[AugmentDraws] = None) -> torch.Tensor:
    """(B, S, S, 3) uint8 -> normalized float32 (B, S, S, 3) in [-1, 1],
    augmented first where ``augment`` is set: with ``draws`` if they are
    given, else with draws from ``generator`` (which must lie on the images'
    device)."""
    x = images_u8.to(torch.float32) / 255.0
    if augment:
        if draws is None:
            if generator is None:
                raise ValueError("process_batch: augment needs a generator "
                                 "or draws")
            draws = sample_draws(x.shape[0], x.shape[1], generator, spec)
        x = apply_augment(x, draws, spec)
    return (x - 0.5) / 0.5
