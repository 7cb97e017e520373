"""Standalone contrastive encoder, trunk + projection head (counterpart of
mmvqa_tpu/models/supcon_encoder.py): the reference's older two-model
contrastive path (models/SupConLoss/supcon_utils.py:45-84), kept for
experiments; the live path projects inside ``MMBert`` (``cfg.supcon``).

The deepest map of the ResNet-152 or EfficientNetV2 trunk is
average-pooled and projected, by ``proj`` (head ``linear``) or by
``proj_hidden`` -> ReLU -> ``proj`` (head ``mlp``), then L2-normalised. Any
other head raises ``NotImplementedError``. Module names follow the Flax tree
(``trunk``, ``proj_hidden``, ``proj``); device, dtype, generator and modes
as in ``models/img_only.py``. On the card the trunk's kernels run, never K1
or K2.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from mmvqa_tpu_torch.models.img_only import image_trunk, pooled_features
from mmvqa_tpu_torch.models.layers import Linear
from mmvqa_tpu_torch.models.mmbert import default_device, init_weights

HEADS = ("linear", "mlp")


class SupConEncoder(nn.Module):
    def __init__(self, cnn_encoder: str = "resnet152", head: str = "mlp",
                 feat_dim: int = 128, tiny: bool = False, *,
                 device: Union[str, torch.device, None] = None,
                 dtype: torch.dtype = torch.float32,
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if head not in HEADS:
            raise NotImplementedError(f"head not supported: {head}")
        device = default_device() if device is None else torch.device(device)
        self.head_type = head
        self.compute_dtype = compute_dtype
        self.trunk, ch = image_trunk(cnn_encoder, tiny)
        if head == "mlp":
            self.proj_hidden = Linear(ch, ch)
        self.proj = Linear(ch, feat_dim)
        init_weights(self, torch.Generator().manual_seed(0)
                     if generator is None else generator)
        self.to(device=device, dtype=dtype)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.proj.weight.device

    @property
    def dtype(self) -> torch.dtype:
        """The dtype activations are computed in."""
        return self.compute_dtype or self.proj.weight.dtype

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """img (B, S, S, 3) normalized NHWC -> unit features (B, feat_dim)."""
        x = pooled_features(self.trunk, img.to(self.dtype))
        if self.head_type == "mlp":
            x = F.relu(self.proj_hidden(x))
        x = self.proj(x)
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
